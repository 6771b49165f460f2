"""Candidate enumeration: every *legal* DASH configuration for one attention
geometry.

A :class:`Candidate` fixes the four knobs call sites used to hand-pick:

  * ``schedule``        — registry family (``fa3`` / ``descending`` / ``shift``
                          / ``symmetric_shift``) for the paper masks, or the
                          block-sparse *placement* (``shift`` / ``fa3``) when a
                          :class:`repro_torch.masks.spec.MaskSpec` is given;
  * ``block_q/block_k`` — square tile sizes (the public ``dash_attention``
                          API takes one square ``block``); the port's kernels
                          are built for one, ``flash_fwd.BLOCK`` = 128;
  * ``worker_parallel`` — grid realization (a CTA per (bh, worker) plus the
                          ordered dQ fold, vs one CTA per bh playing every
                          chain serialized);
  * ``n_workers``       — implied by the tiling: surviving KV rows of the
                          schedule (paper §3.1 row ownership).

Legality filters, applied in order:

  1. the block must be one the kernels are built for (``BLOCK``), at a head
     dim they are instantiated for (``HEAD_DIMS``), and tile both sequence
     lengths exactly, which must be equal (the backward kernels' square
     rule);
  2. the backward (and forward) shared-memory footprint must fit the budget
     (:mod:`repro_torch.kernels.smem` — blocks are chosen, not guessed);
  3. family/mask compatibility (``shift`` is full-only, ``symmetric_shift``
     causal-only, block-sparse masks take placements only — the same rules
     :func:`repro_torch.core.schedules.make_schedule` enforces);
  4. ``worker_parallel=True`` only when the schedule's worker grid exists and
     is bitwise-equal to the serialized realization
     (``Schedule.worker_chains()['single_visit']`` and no empty chains) —
     the tuner never offers a candidate that would change numerics.

Enumeration order is deterministic (blocks descending, families in a fixed
tuple, parallel before serialized), and :meth:`Candidate.key` gives the stable
total order used for tie-breaks everywhere downstream.

Port of ``repro.tune.space``. The one intended difference in the candidate
set: the reference also offers 256-blocks, which the port's kernels would
refuse — the tuner never offers a candidate that changes numerics or fails.
For every geometry the kernels take, the port's enumeration is the
reference's minus its 256-block candidates, same keys in the same order
(``tests/test_torch_tune.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.schedules import cached_schedule
from repro_torch.kernels import smem
from repro_torch.kernels.flash_fwd import BLOCK, HEAD_DIMS

# fixed enumeration orders — part of the determinism contract
BLOCKS = (BLOCK,)
FULL_FAMILIES = ("shift", "descending", "fa3")
CAUSAL_FAMILIES = ("symmetric_shift", "descending", "fa3")
MASK_PLACEMENTS = ("shift", "fa3")

# Tie-break order when two families hit the same modeled makespan: the
# paper-proven optimum (shift family) first, then descending, then the fa3
# baseline.  At some sizes descending also reaches the causal lower bound —
# the model cannot separate them, so the analytic preference decides.  Still a
# pure function of the candidate set: no clock, no enumeration order.
FAMILY_PREFERENCE = ("shift", "symmetric_shift", "descending", "fa3")


def family_rank(schedule: str) -> int:
    """Index into :data:`FAMILY_PREFERENCE` (unknown families sort last)."""
    try:
        return FAMILY_PREFERENCE.index(schedule)
    except ValueError:
        return len(FAMILY_PREFERENCE)


@dataclasses.dataclass(frozen=True, order=True)
class Candidate:
    """One point of the tuning space. Frozen + ordered: ``sorted()`` over
    candidates is the deterministic key order the tie-breaks rely on."""

    schedule: str
    block_q: int
    block_k: int
    worker_parallel: bool
    n_workers: int

    def key(self) -> str:
        """Stable short identifier (sorts identically to the dataclass
        order within one enumeration; used in cache records and logs)."""
        real = "par" if self.worker_parallel else "ser"
        return (f"{self.schedule}|bq{self.block_q}|bk{self.block_k}|{real}"
                f"|w{self.n_workers}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "Candidate":
        return cls(schedule=str(d["schedule"]), block_q=int(d["block_q"]),
                   block_k=int(d["block_k"]),
                   worker_parallel=bool(d["worker_parallel"]),
                   n_workers=int(d["n_workers"]))


def legal_blocks(seq_q: int, seq_kv: int, head_dim: int,
                 dtype_bytes: int = 2, smem_budget: float = 1.0,
                 blocks: Tuple[int, ...] = BLOCKS) -> Tuple[int, ...]:
    """Square blocks the kernels are built for that tile both (equal)
    sequences and whose backward and forward footprints fit
    ``smem_budget`` (a fraction of the per-block shared memory; the
    reference's ``vmem_budget`` of TPU VMEM). Descending order: larger
    blocks amortize the per-task dQ reduction over more compute."""
    if head_dim not in HEAD_DIMS or seq_q != seq_kv:
        return ()
    out = []
    for b in blocks:
        if b != BLOCK or seq_q % b or seq_kv % b:
            continue
        if not smem.bwd_footprint(b, b, head_dim, dtype_bytes).fits(
                smem_budget):
            continue
        if not smem.fwd_footprint(b, b, head_dim, dtype_bytes).fits(
                smem_budget):
            continue
        out.append(b)
    return tuple(out)


def build_schedule(cand: Candidate, seq_q: int, seq_kv: int, causal: bool,
                   mask=None):
    """The (memoized) Schedule a candidate resolves to — n_heads=1, exactly
    what the kernel grids consume (the bh grid axis covers batch·heads)."""
    return cached_schedule(cand.schedule, seq_kv // cand.block_k, n_heads=1,
                           causal=causal, n_q=seq_q // cand.block_q, mask=mask,
                           block_q=cand.block_q, block_k=cand.block_k)


def _realizations(schedule) -> Tuple[bool, ...]:
    """Legal ``worker_parallel`` values for a schedule: parallel only when the
    worker grid exists and is bitwise-equal to the serialized fold."""
    try:
        if schedule.worker_chains()["single_visit"]:
            return (True, False)
    except ValueError:      # a worker owns no head-0 task → no grid row
        pass
    return (False,)


def enumerate_candidates(*, seq_q: int, seq_kv: Optional[int] = None,
                         head_dim: int, dtype_bytes: int = 2,
                         causal: bool = False, mask=None,
                         smem_budget: float = 1.0) -> Tuple[Candidate, ...]:
    """All legal candidates for one attention geometry, in deterministic
    enumeration order. ``mask`` (a MaskSpec) switches the family axis to the
    block-sparse placements; ``causal`` is the paper's triangular mask."""
    seq_kv = seq_q if seq_kv is None else seq_kv
    if mask is not None:
        if causal:
            raise ValueError("mask supersedes the causal flag")
        families = MASK_PLACEMENTS
    else:
        families = CAUSAL_FAMILIES if causal else FULL_FAMILIES
    out = []
    for block in legal_blocks(seq_q, seq_kv, head_dim, dtype_bytes,
                              smem_budget):
        for name in families:
            probe = Candidate(name, block, block, False, 0)
            try:
                sch = build_schedule(probe, seq_q, seq_kv, causal, mask)
            except (AssertionError, ValueError, KeyError):
                continue    # e.g. mask leaves a q tile with no visible KV tile
            for wp in _realizations(sch):
                out.append(Candidate(name, block, block, wp, sch.n_workers))
    if not out:
        raise ValueError(f"no legal candidate for seq_q={seq_q} "
                         f"seq_kv={seq_kv} head_dim={head_dim} (the kernels "
                         f"take head_dim in {HEAD_DIMS} and equal sequences "
                         f"that {BLOCKS} tiles)")
    return tuple(out)
