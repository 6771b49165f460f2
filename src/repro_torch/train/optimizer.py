"""AdamW, Adafactor + LR schedules over plain parameter trees (nested dicts
of tensors).

Port of ``repro.train.optimizer``. Every update is elementwise and every
reduction runs in a fixed order, so a step is a pure function of its inputs
(bitwise run to run on one device). Leaves are visited in the reference's
tree order — keys sorted at every level, which is what ``jax.tree.leaves``
does for dicts — so the global-norm sum adds the leaves in the same order.
State dtype is configurable (fp32 default). Updates are functional: new
tensors, the inputs are not modified.
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
    name: str = "adamw"            # adamw | adafactor
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


# ------------------------------------------------------------------ Adafactor
def adafactor_init(cfg: OptConfig, params):
    """Factored second moments: a leaf of rank >= 2 keeps its row means
    ``vr`` (shape[:-1]) and column means ``vc`` (shape[:-2] + shape[-1:]),
    a vector keeps ``v``; all in ``state_dtype``."""
    dt = _state_dtype(cfg)

    def st(p):
        if p.dim() >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=dt, device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=dt,
                                      device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=dt, device=p.device)}

    return {"f": tree_map(st, params)}


def adafactor_update(cfg: OptConfig, grads, state, params, step: int):
    """Decay ``1 - (step+1)^-0.8``, the factored (or full) second moment,
    RMS update clipping at 1, then weight decay — the reference's update."""
    dt = _state_dtype(cfg)
    lr = lr_at(cfg, step)
    f = np.float32
    decay32 = f(1.0) - (f(int(step)) + f(1.0)) ** f(-0.8)   # fp32, as traced
    decay, keep = float(decay32), float(f(1.0) - decay32)

    def upd(g, s, p):
        gf = torch.square(g.to(F32)) + 1e-30
        if p.dim() >= 2:
            vr = decay * s["vr"].to(F32) + keep * gf.mean(-1)
            vc = decay * s["vc"].to(F32) + keep * gf.mean(-2)
            denom = (vr[..., None] * vc[..., None, :]
                     / torch.clamp_min(vr.mean(-1, keepdim=True),
                                       1e-30)[..., None])
            new_s = {"vr": vr.to(dt), "vc": vc.to(dt)}
        else:
            v = decay * s["v"].to(F32) + keep * gf
            denom = v
            new_s = {"v": v.to(dt)}
        delta = g.to(F32) * torch.rsqrt(denom + 1e-30)
        # update clipping (Adafactor's RMS trick)
        rms = torch.sqrt(torch.mean(torch.square(delta)) + 1e-30)
        delta = delta / torch.clamp_min(rms, 1.0)
        delta = delta + cfg.weight_decay * p.to(F32)
        return (p.to(F32) - lr * delta).to(p.dtype), new_s

    # the state tree mirrors the params with a dict per leaf: tree_map walks
    # the grads' structure and hands each leaf its state dict
    out = tree_map(upd, grads, state["f"], params)
    pick = lambda i: tree_map(lambda o: o[i], out)
    return pick(0), {"f": pick(1)}


# ------------------------------------------------------------------ dispatch
_OPTIMIZERS = {"adamw": (adamw_init, adamw_update),
               "adafactor": (adafactor_init, adafactor_update)}


def _impl(cfg: OptConfig):
    if cfg.name not in _OPTIMIZERS:
        raise ValueError(f"unknown optimizer {cfg.name!r}; one of "
                         f"{sorted(_OPTIMIZERS)}")
    return _OPTIMIZERS[cfg.name]


def opt_init(cfg: OptConfig, params):
    return _impl(cfg)[0](cfg, params)


def opt_update(cfg: OptConfig, grads, state, params, step: int):
    """Clip, then update. Returns (new params, new state, grad norm)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    new_p, new_s = _impl(cfg)[1](cfg, grads, state, params, step)
    return new_p, new_s, gnorm
