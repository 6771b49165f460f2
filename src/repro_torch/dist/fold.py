"""Canonical virtual-shard reductions (local form).

Counterpart of ``repro.dist.fold``. Serving needs a reduction's association
to be a function of a logical grid chosen once per model, never of how the
work was cut: every row-parallel contraction (attention ``wo``, MLP
``w_down``) is cut into fixed-width *virtual shards* (``head_dim`` and
``d_ff / n_heads`` wide), each shard's partial product is taken in fp32 from
0, and the partials are summed as ``((0 + p_0) + p_1) + …`` in ascending
shard order.

:func:`canonical_scope` is how the model code switches into this discipline:
``transformer.paged_step`` always enters it, and ``transformer.forward``
enters it when ``cfg.canonical_reductions`` is set (the train≡serve parity
mode). Inside it ``layers.dot`` and ``layers.apply_norm`` also take the
port's M-invariant kernels (``kernels/gemm.py``, ``kernels/rows.py``).

Only the local (single-device) form is ported: a mesh axis — the
reference's ``fixed_fold_psum`` ring over devices — raises (ROADMAP A9).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import torch

from repro_torch.kernels import gemm

_MESH = ("the canonical fold over a mesh axis (fixed_fold_psum's ring) waits "
         "for the distributed slice (ROADMAP A9)")


@dataclasses.dataclass(frozen=True)
class _Scope:
    axis_name: Optional[str]      # always None: the local fold
    page_size: int                # paged-walk granularity for train attention


_STATE = threading.local()


@contextlib.contextmanager
def canonical_scope(axis_name: Optional[str] = None, page_size: int = 0):
    """Enter canonical-reduction mode for the code run inside. Re-entrant
    with outer-wins semantics, as the reference's: an inner entry leaves an
    outer scope (and its page size) in place."""
    if axis_name is not None:
        raise NotImplementedError(_MESH)
    if getattr(_STATE, "scope", None) is not None:
        yield
        return
    _STATE.scope = _Scope(axis_name, page_size)
    try:
        yield
    finally:
        _STATE.scope = None


def active() -> bool:
    return getattr(_STATE, "scope", None) is not None


def scope_axis() -> Optional[str]:
    s = getattr(_STATE, "scope", None)
    return s.axis_name if s is not None else None


def scope_pages() -> int:
    s = getattr(_STATE, "scope", None)
    return s.page_size if s is not None else 0


def fixed_fold_psum(parts: torch.Tensor,
                    axis_name: Optional[str] = None) -> torch.Tensor:
    """``((0 + p_0) + p_1) + … + p_{V-1}`` over ``parts (V, …)`` in ascending
    order: the reference's fold with no mesh axis. A mesh axis raises."""
    if axis_name is not None:
        raise NotImplementedError(_MESH)
    acc = torch.zeros(parts.shape[1:], dtype=parts.dtype, device=parts.device)
    for p in parts:
        acc = acc + p
    return acc


def canonical_row_dot(x: torch.Tensor, w: torch.Tensor, shard_width: int,
                      out_dtype=None) -> torch.Tensor:
    """``x @ w`` in canonical fold form: the contraction cut into
    ``shard_width``-wide virtual shards, each an fp32 partial from 0, folded
    from 0 in ascending shard order; cast to ``out_dtype`` if given. One
    launch of the GEMM kernel in its canonical mode on the card
    (:func:`repro_torch.kernels.gemm.matmul`)."""
    return gemm.matmul(x, w, out_dtype=out_dtype, shard_width=shard_width)
