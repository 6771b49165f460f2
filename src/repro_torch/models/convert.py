"""Weight bridge: the reference's parameter tree → the port's parameters.

``repro.models.transformer.init`` returns nested dicts of arrays
(``embed/tok``, ``ln_f/*``, ``blocks/b0_attn/{ln1,attn,ln2,mlp}/*`` stacked
``(n_rep, ...)``, ``lm_head/w``). The port keeps that tree and the
``(d_in, d_out)`` matrix layout, so the bridge maps leaf to leaf by path with
no transposes. Arrays are taken through numpy (``np.asarray`` of a jax array
works without importing jax); bfloat16 arrays are moved by their bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.module import iter_defs, set_path, tree_paths


def _to_torch(arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr, order="C")        # a writable copy
    if arr.dtype.name == "bfloat16":        # ml_dtypes: no torch counterpart
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def from_jax_params(tree, cfg, device=None):
    """Port parameters for ``cfg`` from the reference tree ``tree``.

    Every leaf must map onto one port parameter of the same shape; a leaf
    with no counterpart, a missing parameter or a shape mismatch raises.
    Values are cast to the port's parameter dtype (``cfg.dtype``, fp32 for
    norms) and placed on ``device`` (the card by default).
    """
    device = resolve_device(device)
    defs = dict(iter_defs(T.param_defs(cfg)))
    params, used = {}, set()
    for path, leaf in tree_paths(tree):
        if path not in defs:
            raise KeyError(f"reference leaf {path!r} has no counterpart in "
                           f"the port's parameters for {cfg.name}")
        arr = np.asarray(leaf)
        d = defs[path]
        if tuple(arr.shape) != d.shape:
            raise ValueError(f"{path}: reference shape {tuple(arr.shape)} != "
                             f"port shape {d.shape}")
        set_path(params, path,
                 _to_torch(arr).to(device=device, dtype=d.dtype or cfg.dtype))
        used.add(path)
    missing = sorted(set(defs) - used)
    if missing:
        raise KeyError(f"reference tree lacks port parameters {missing}")
    return params
