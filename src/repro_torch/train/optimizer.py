"""AdamW + LR schedules over plain parameter trees (nested dicts of tensors).

Port of ``repro.train.optimizer``. Every update is elementwise and every
reduction runs in a fixed order, so a step is a pure function of its inputs
(bitwise run to run on one device). Leaves are visited in the reference's
tree order — keys sorted at every level, which is what ``jax.tree.leaves``
does for dicts — so the global-norm sum adds the leaves in the same order.
State dtype is configurable (fp32 default). Updates are functional: new
tensors, the inputs are not modified. Adafactor is not ported yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from repro_torch.models.module import tree_paths

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"            # adamw (adafactor: not ported yet)
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"       # cosine | linear | constant
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    state_dtype: str = "float32"   # float32 | bfloat16
    min_lr_frac: float = 0.1


def tree_leaves(tree) -> List:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over trees of one structure (dicts only)."""
    return {k: (tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
                else fn(v, *(r[k] for r in rest)))
            for k, v in tree.items()}


def _state_dtype(cfg: OptConfig) -> torch.dtype:
    return getattr(torch, cfg.state_dtype)


def lr_at(cfg: OptConfig, step) -> float:
    """Learning rate at ``step`` (a Python int), evaluated in float32 like
    the reference's traced schedule."""
    f = np.float32
    step = f(int(step))
    warm = min(f(1.0), (step + f(1)) / f(max(1, cfg.warmup_steps)))
    t = np.clip((step - f(cfg.warmup_steps))
                / f(max(1, cfg.total_steps - cfg.warmup_steps)),
                f(0.0), f(1.0))
    if cfg.schedule == "cosine":
        decay = f(cfg.min_lr_frac) + (f(1) - f(cfg.min_lr_frac)) * f(0.5) * (
            f(1) + np.cos(f(math.pi) * t))
    elif cfg.schedule == "linear":
        decay = f(1.0) - (f(1) - f(cfg.min_lr_frac)) * t
    else:
        decay = f(1.0)
    return float(f(cfg.lr) * warm * decay)


def clip_by_global_norm(grads, max_norm: float):
    """Scale every grad by ``min(1, max_norm / ‖g‖)``. The squared norms of
    the leaves are summed left to right in tree order. Returns (grads, the
    norm as a 0-dim fp32 tensor)."""
    total = None
    for g in tree_leaves(grads):
        sq = torch.sum(torch.square(g.to(F32)))
        total = sq if total is None else total + sq
    gnorm = torch.sqrt(total)
    scale = torch.clamp_max(max_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), gnorm


# --------------------------------------------------------------------- AdamW
def adamw_init(cfg: OptConfig, params):
    dt = _state_dtype(cfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def adamw_update(cfg: OptConfig, grads, state, params, step: int):
    dt = _state_dtype(cfg)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(step + 1))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(step + 1))

    def upd(g, m, v, p):
        gf = g.to(F32)
        m_new = b1 * m.to(F32) + (1 - b1) * gf
        v_new = b2 * v.to(F32) + (1 - b2) * torch.square(gf)
        mhat, vhat = m_new / bc1, v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.to(F32)
        return (p.to(F32) - lr * delta).to(p.dtype), m_new.to(dt), v_new.to(dt)

    out = tree_map(upd, grads, state["m"], state["v"], params)
    pick = lambda i: tree_map(lambda o: o[i], out)
    return pick(0), {"m": pick(1), "v": pick(2)}


# ------------------------------------------------------------------ dispatch
def _check_name(cfg: OptConfig):
    if cfg.name != "adamw":
        raise NotImplementedError(
            f"optimizer {cfg.name!r} is not ported yet (ROADMAP queue A, "
            f"dense train step); 'adamw' is")


def opt_init(cfg: OptConfig, params):
    _check_name(cfg)
    return adamw_init(cfg, params)


def opt_update(cfg: OptConfig, grads, state, params, step: int):
    """Clip, then update. Returns (new params, new state, grad norm)."""
    _check_name(cfg)
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    new_p, new_s = adamw_update(cfg, grads, state, params, step)
    return new_p, new_s, gnorm
