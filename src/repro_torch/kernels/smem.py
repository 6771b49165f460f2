"""Shared-memory accounting for the port's DASH kernels on an H100 — the
counterpart of ``repro.kernels.vmem`` (TPU VMEM working sets).

A block of ``csrc/flash_fwd.cu`` or ``csrc/flash_bwd.cu`` claims a fixed
dynamic shared-memory layout per (head dim, dtype); this module writes that
layout out buffer by buffer, so the tuner chooses tiles against the budget
instead of guessing, and ``chip_smoke.py`` holds each total equal to what the
built library launches with (``flash_fwd.kernel_smem_bytes``,
``flash_bwd.smem_bytes``). The budget is the per-block opt-in of
:data:`~repro_torch.kernels.flash_fwd.SMEM_MAX` bytes.

The kernels are built for one square tile, :data:`BLOCK` = 128, so a
footprint of another tile raises rather than describe a layout no kernel has.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.kernels.flash_fwd import BLOCK, SMEM_MAX, fwd_stages

# csrc/flash_fwd.cu's fp32 body: K/V sub-blocks of this many rows
FWD_F32_ROWS = 64
# csrc/flash_bwd.cu: q rows of a bf16 unit (two units a task, each with its
# Q/dO/lse/delta double-buffered) and kv rows of an fp32 sub-block
BWD_UNIT_ROWS = 64
BWD_F32_ROWS = 32


@dataclasses.dataclass(frozen=True)
class KernelFootprint:
    buffers: Dict[str, int]

    @property
    def total(self) -> int:
        return sum(self.buffers.values())

    @property
    def fraction(self) -> float:
        return self.total / SMEM_MAX

    def fits(self, budget: float = 1.0) -> bool:
        return self.fraction <= budget


def _check(block_q: int, block_k: int, in_dtype_bytes: int):
    if (block_q, block_k) != (BLOCK, BLOCK):
        raise ValueError(f"the kernels are built for {BLOCK}x{BLOCK} tiles; "
                         f"got ({block_q}, {block_k})")
    if in_dtype_bytes not in (2, 4):
        raise ValueError(f"the kernels take bf16 (2 bytes) or fp32 (4); got "
                         f"{in_dtype_bytes} bytes")


def fwd_footprint(block_q: int, block_k: int, d: int,
                  in_dtype_bytes: int = 2) -> KernelFootprint:
    """``csrc/flash_fwd.cu``. bf16: 1024 bytes of alignment slack, two Q
    tiles, a ring of :func:`~repro_torch.kernels.flash_fwd.fwd_stages` K/V
    tile pairs, the staged output tile and a full/empty mbarrier pair per Q
    tile and stage (TMA fills them; the running (m, l, acc) live in
    registers) — :func:`~repro_torch.kernels.flash_fwd.fwd_smem_bytes` in
    parts. fp32: one 64-row K and one V sub-block."""
    _check(block_q, block_k, in_dtype_bytes)
    if in_dtype_bytes == 4:
        return KernelFootprint({"k": FWD_F32_ROWS * d * 4,
                                "v": FWD_F32_ROWS * d * 4})
    stages = fwd_stages(d)
    return KernelFootprint({
        "align": 1024,
        "q": 2 * block_q * d * 2,
        "k": stages * block_k * d * 2,
        "v": stages * block_k * d * 2,
        "o": block_q * d * 2,
        "mbarriers": 8 * (4 + 2 * stages),
    })


def bwd_footprint(block_q: int, block_k: int, d: int,
                  in_dtype_bytes: int = 2) -> KernelFootprint:
    """``csrc/flash_bwd.cu`` (both backward kernels). bf16 (``Tc<D>``): the
    K and V tiles of the CTA's KV row, two stages of a 64-row unit's Q and
    dO, dS^T as bf16 hi/lo halves, two stages of lse and delta; rows padded
    by 8 elements against bank conflicts; dK/dV accumulate in registers.
    fp32 (``Layout<D>``): Q and dO tiles, a 32-row K/V sub-block, P and dS,
    lse and delta, rows padded by one float."""
    _check(block_q, block_k, in_dtype_bytes)
    if in_dtype_bytes == 4:
        ld, lp, ks = d + 1, BWD_F32_ROWS + 1, BWD_F32_ROWS
        return KernelFootprint({
            "q": block_q * ld * 4, "do": block_q * ld * 4,
            "k": ks * ld * 4, "v": ks * ld * 4,
            "p": block_q * lp * 4, "ds": block_q * lp * 4,
            "lse": block_q * 4, "delta": block_q * 4,
        })
    ld, ls, qs = d + 8, BWD_UNIT_ROWS + 8, BWD_UNIT_ROWS
    return KernelFootprint({
        "k": block_k * ld * 2, "v": block_k * ld * 2,
        "q": 2 * qs * ld * 2, "do": 2 * qs * ld * 2,
        "ds_hi": block_k * ls * 2, "ds_lo": block_k * ls * 2,
        "lse": 2 * qs * 4, "delta": 2 * qs * 4,
    })


def best_block(d: int, causal: bool, budget: float = 1.0) -> int:
    """The square tile for head dim ``d``: :data:`BLOCK`, the only one the
    kernels are built for, provided both footprints fit the budget (raises
    otherwise). The reference picks the largest of 512/256/128 that fits
    TPU VMEM; ``causal`` does not change the tile either way."""
    if (bwd_footprint(BLOCK, BLOCK, d).fits(budget)
            and fwd_footprint(BLOCK, BLOCK, d).fits(budget)):
        return BLOCK
    raise ValueError(f"head_dim {d}: the {BLOCK}-tile kernels exceed "
                     f"{budget:.0%} of {SMEM_MAX} bytes of shared memory")
