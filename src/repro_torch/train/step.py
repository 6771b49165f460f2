"""Train step over plain parameter trees.

Port of the single-device part of ``repro.train.step``:
``init_state(cfg, tcfg, seed, device)`` builds ``{params, opt, ef?, step}``
and ``make_train_step(cfg, tcfg)`` returns ``step(state, batch) → (state,
metrics)``. Gradients come from ``torch.autograd.grad`` over detached copies
of the parameters, so the state holds plain tensors and a step is a function
of (state, batch): microbatch accumulation is a fixed-order fp32 sum then a
divide, remat and its policy come from ``tcfg``, int8 error-feedback
compression (``grad_compression="int8"``, residuals in ``state["ef"]``)
follows the microbatch sum, and clipping precedes the update. A packed batch
carries ``segment_ids`` and ``positions`` through ``loss_fn``. With
``digest_metrics`` a step's metrics carry ``state_fingerprint``, the uint32
:func:`repro_torch.verify.digest.tree_fingerprint` of the new state (on the
card one launch of the fingerprint kernel). Mesh
shardings (``state_pspecs``, ``batch_pspecs``) wait for the distributed
slice (ROADMAP A9).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.dist import compression
from repro_torch.models import transformer as T
from repro_torch.models.module import set_path, tree_paths
from repro_torch.train import optimizer as O
from repro_torch.verify import digest as V

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: O.OptConfig = O.OptConfig()
    microbatches: int = 1
    remat: bool = True
    remat_policy: str = "none"    # none (recompute all) | dots | names
    grad_compression: Optional[str] = None    # None | "int8"
    seed: int = 0
    digest_metrics: bool = False  # ship the uint32 state fingerprint in the
                                  # metrics (verify.digest.tree_fingerprint):
                                  # the live divergence alarm


def _check(tcfg: TrainConfig):
    if tcfg.grad_compression not in (None, "int8"):
        raise ValueError(f"grad_compression={tcfg.grad_compression!r}; "
                         f"None or 'int8'")


def init_state(cfg, tcfg: TrainConfig, seed: int = 0, device=None):
    """``{"params", "opt", "step"}`` (plus ``"ef"`` under int8 compression)
    with random parameters from ``seed`` (``T.init``) on ``device`` (the card
    by default); ``step`` is a 0-dim int32 tensor, as in the reference's
    state."""
    params = T.init(cfg, seed=seed, device=device)
    return state_from_params(params, tcfg)


def state_from_params(params, tcfg: TrainConfig):
    """A fresh train state around given parameters (e.g. bridged ones)."""
    _check(tcfg)
    device = O.tree_leaves(params)[0].device
    state = {"params": params, "opt": O.opt_init(tcfg.opt, params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if tcfg.grad_compression:
        state["ef"] = compression.ef_init(params)
    return state


def _tree(paths, leaves):
    tree: Dict[str, Any] = {}
    for path, leaf in zip(paths, leaves):
        set_path(tree, path, leaf)
    return tree


def make_train_step(cfg, tcfg: TrainConfig):
    """Returns step(state, batch) → (new state, metrics). The input state is
    not modified. ``metrics``: loss, ce, aux, grad_norm (0-dim tensors), lr
    (a float) and, with ``digest_metrics``, state_fingerprint (an int)."""
    _check(tcfg)

    def grads_of(params, batch):
        paths = [p for p, _ in tree_paths(params)]
        leaves = [x.detach().requires_grad_(True)
                  for x in O.tree_leaves(params)]
        loss, metrics = T.loss_fn(_tree(paths, leaves), batch, cfg,
                                  remat=tcfg.remat,
                                  remat_policy=tcfg.remat_policy)
        grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                _tree(paths, grads))

    def step(state, batch):
        params = state["params"]
        if tcfg.microbatches > 1:
            mb = tcfg.microbatches
            rows = next(iter(batch.values())).shape[0]
            if rows % mb:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"{mb} microbatches")
            size = rows // mb
            loss = torch.zeros((), dtype=F32, device=state["step"].device)
            grads = O.tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                     device=p.device), params)
            for i in range(mb):        # fixed order: microbatch 0, 1, ...
                part = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                l_i, _, g_i = grads_of(params, part)
                grads = O.tree_map(lambda a, g: a + g.to(F32), grads, g_i)
                loss = loss + l_i
            loss = loss / mb
            grads = O.tree_map(lambda g: g / mb, grads)
            metrics = {"ce": loss, "aux": torch.zeros_like(loss)}
        else:
            loss, metrics, grads = grads_of(params, batch)

        new_state = dict(state)
        if tcfg.grad_compression == "int8":
            grads, new_state["ef"] = compression.compress_grads(grads,
                                                                state["ef"])
        step_i = int(state["step"])
        new_p, new_opt, gnorm = O.opt_update(tcfg.opt, grads, state["opt"],
                                             params, step_i)
        new_state.update(params=new_p, opt=new_opt, step=state["step"] + 1)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm,
                       lr=O.lr_at(tcfg.opt, step_i))
        if tcfg.digest_metrics:
            metrics["state_fingerprint"] = V.tree_fingerprint(new_state)
        return new_state, metrics

    return step


def step_event(metrics: Dict[str, Any],
               keys: Tuple[str, ...] = ("loss", "grad_norm", "lr")
               ) -> Dict[str, float]:
    """One step's training metrics as plain floats (a tracker payload).
    ``float()`` of a device value is the one sync, made after the caller
    decided this step gets logged. The uint32 ``state_fingerprint`` is left
    out: it flows through :meth:`repro_torch.obs.DivergenceAlarm.observe`,
    which owns the ``fingerprint`` event and the divergence latch."""
    return {k: float(metrics[k]) for k in keys if k in metrics}
