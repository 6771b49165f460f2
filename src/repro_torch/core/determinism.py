"""Deterministic reduction primitives (paper §1–§2, Table 1), on tensors.

Port of ``repro.core.determinism``. Floating-point addition is
non-associative; an accumulation whose order depends on execution timing
(GPU atomics) is not run-to-run reproducible, and ``torch.sum`` pins no
reduction tree either (its blocking follows the device, the dtype and the
shape). These reductions fix the association **explicitly**, so the result is
a pure function of (inputs, declared order):

  * the DASH backward's dQ accumulation order (the schedule defines it);
  * the Table-1 experiments (ordered vs permuted accumulation deviation).

Every sum here is a chain of elementwise IEEE adds in a pinned order, so its
fp32 bits equal the reference's (``tests/test_torch_determinism.py``).
``ring_ordered_psum``, the cross-device form, waits for the distributed
slice and raises.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def ordered_sum(parts: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Strict left-to-right fold along ``axis`` — association ((0+x0)+x1)+…

    A Python loop of elementwise adds from a zero accumulator, as the
    reference's ``lax.scan`` does; never ``torch.sum``, whose tree is not
    pinned.
    """
    parts = torch.movedim(parts, axis, 0)
    acc = torch.zeros(parts.shape[1:], dtype=parts.dtype, device=parts.device)
    for x in parts:
        acc = acc + x
    return acc


def tree_sum_fixed(parts: torch.Tensor, axis: int = 0,
                   arity: int = 2) -> torch.Tensor:
    """Fixed-shape balanced tree reduction (deterministic, log-depth).

    Pads with zeros to a power of ``arity`` so the tree shape — hence
    association — depends only on the padded length, not on execution order.
    """
    parts = torch.movedim(parts, axis, 0)
    n = parts.shape[0]
    size = 1
    while size < n:
        size *= arity
    if size != n:
        pad = torch.zeros((size - n,) + tuple(parts.shape[1:]),
                          dtype=parts.dtype, device=parts.device)
        parts = torch.cat([parts, pad], 0)
    while parts.shape[0] > 1:
        parts = parts.reshape((parts.shape[0] // arity, arity)
                              + tuple(parts.shape[1:]))
        acc = parts[:, 0]
        for k in range(1, arity):  # pinned order within each tree node
            acc = acc + parts[:, k]
        parts = acc
    return parts[0]


def permuted_sum(parts: torch.Tensor, perm: np.ndarray,
                 axis: int = 0) -> torch.Tensor:
    """Left-to-right fold in an arbitrary order — emulates the *non*-
    deterministic atomicAdd accumulation of the paper's baseline (Fig. 1
    middle) for Table-1 style deviation measurements."""
    parts = torch.movedim(parts, axis, 0)
    index = torch.as_tensor(np.asarray(perm), dtype=torch.long,
                            device=parts.device)
    return ordered_sum(parts[index], axis=0)


def schedule_ordered_dq(partials: torch.Tensor,
                        reduction_order: Sequence[int]) -> torch.Tensor:
    """Accumulate dQ partials (stacked along axis 0, one per KV tile) in the
    order prescribed by a DASH schedule column. Deterministic by
    construction; different schedules give (bitwise) different but
    individually reproducible results."""
    return permuted_sum(partials, np.asarray(reduction_order, np.int32))


def ring_ordered_psum(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """All-reduce with its association pinned to ascending device index
    (the reference's ``ppermute`` ring). Not ported: it needs the
    distributed slice."""
    raise NotImplementedError(
        "ring_ordered_psum: the cross-device ordered all-reduce waits for the "
        "distributed slice (ROADMAP A9)")


def max_deviation(fn, n_runs: int = 10) -> float:
    """Max elementwise deviation of ``fn(run_index)`` across runs vs. run 0 —
    the paper's Table-1 metric ``M_r = max |q_r - q_ref|``.

    The reference also takes a PRNG key that its body never reads; this
    port drops it (``fn`` owns whatever randomness it uses)."""
    ref = fn(0)
    dev = 0.0
    for i in range(1, n_runs):
        out = fn(i)
        dev = max(dev, float(torch.max(torch.abs(out - ref))))
    return dev
