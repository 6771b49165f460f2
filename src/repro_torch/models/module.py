"""Minimal functional parameter system.

Models are plain functions over nested dicts of tensors, in the JAX weight
layout (every matrix ``(d_in, d_out)``, used as ``x @ W``; layer stacks carry
a leading ``(n_repeats, ...)`` axis). Parameters are declared as
:class:`ParamDef` trees; :func:`init_tree` materializes them from an explicit
``torch.Generator`` with the reference's distributions. The logical sharding
axes of ``repro.models.module.ParamDef`` come with the distributed slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones | scaled(=normal/sqrt(fan_in))
    dtype: Optional[torch.dtype] = None   # overrides the model dtype (fp32 norms)


def _init_one(d: ParamDef, gen: torch.Generator, dtype, device,
              init_scale: float):
    dt = d.dtype or dtype
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    if d.init in ("normal", "scaled"):
        if d.init == "normal":
            s = init_scale
        else:
            fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
            s = 1.0 / math.sqrt(fan_in)
        x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                        device=device)
        return (x * s).to(dt)
    raise ValueError(d.init)


def iter_defs(defs, prefix: str = ""):
    """(path, ParamDef) pairs in sorted-key order, paths joined by ``/``."""
    for key in sorted(defs):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(defs[key], ParamDef):
            yield path, defs[key]
        else:
            yield from iter_defs(defs[key], path)


def set_path(tree: Dict[str, Any], path: str, value) -> None:
    *parents, leaf = path.split("/")
    for key in parents:
        tree = tree.setdefault(key, {})
    tree[leaf] = value


def init_tree(defs, gen: torch.Generator, dtype=torch.bfloat16, device="cpu",
              init_scale: float = 0.02):
    """Materialize a ParamDef tree into tensors, drawing leaf by leaf in
    sorted-path order from ``gen`` (which must live on ``device``)."""
    params: Dict[str, Any] = {}
    for path, d in iter_defs(defs):
        set_path(params, path, _init_one(d, gen, dtype, device, init_scale))
    return params


def stacked(defs, n_layers: int):
    """Prepend a ('layers') stacking axis to every ParamDef in the tree."""
    return {k: (ParamDef((n_layers,) + d.shape, d.init, d.dtype)
                if isinstance(d, ParamDef) else stacked(d, n_layers))
            for k, d in defs.items()}


def count_params(tree) -> int:
    return sum(x.numel() if isinstance(x, torch.Tensor) else count_params(x)
               for x in tree.values())
