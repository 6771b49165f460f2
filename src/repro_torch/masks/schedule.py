"""Compile a block-sparse mask into a deterministic DASH schedule.

Port of ``repro.masks.schedule`` (numpy only, the reference's own code). The
cells are whatever the mask's block map keeps (non-EMPTY tiles); each
surviving KV row becomes one worker (the paper's §3.1 row-ownership
constraint: dK/dV stay with one worker); the per-(head, q) reduction order
follows the placement's execution slots.

``shift`` (default) rotates each worker's valid q list by the earliest
offset with the fewest (slot, column) collisions, workers in ascending KV-row
order; on a full mask it recovers the paper's shift schedule. ``fa3`` walks
each worker's q list ascending, reductions by ascending KV row. The arrays a
compiled schedule emits (``worker_chains()``, ``prefetch_arrays()``) and its
``partial_cells`` drive the masked backward kernels of
:mod:`repro_torch.kernels.flash_bwd`; ``tests/test_torch_masks.py`` holds
them equal to the reference's.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.schedules import SCHEDULE_CACHE_MAXSIZE, Schedule
from repro_torch.masks.spec import EMPTY, PARTIAL, MaskSpec

PLACEMENTS = ("shift", "fa3")


def ragged_columns(cells) -> Dict[int, List[int]]:
    """Per-q-column ragged KV lists (sorted)."""
    cols: Dict[int, List[int]] = {}
    for kv, q in cells:
        cols.setdefault(q, []).append(kv)
    return {q: sorted(kvs) for q, kvs in cols.items()}


def _shift_orders(rows: List[int], row_qs: Dict[int, List[int]],
                  n_q: int) -> Dict[int, List[int]]:
    """Greedy rotation per worker minimizing (slot, column) collisions.

    All L rotations of a worker are scored in one numpy lookup against the
    (slot, column) occupancy table; ``argmin`` picks the earliest
    minimal-collision offset."""
    max_slots = max((len(row_qs[kv]) for kv in rows), default=0)
    occupancy = np.zeros((max_slots, n_q), bool)
    orders: Dict[int, List[int]] = {}
    for kv in rows:
        qs = np.asarray(row_qs[kv], np.int64)
        L = len(qs)
        rot_idx = (np.arange(L)[:, None] + np.arange(L)[None, :]) % L
        rotations = qs[rot_idx]                     # (offset, slot) -> column
        colls = occupancy[np.arange(L)[None, :], rotations].sum(axis=1)
        rot = rotations[int(np.argmin(colls))]
        occupancy[np.arange(L), rot] = True
        orders[kv] = rot.tolist()
    return orders


def compile_block_schedule(mask: MaskSpec, n_kv: int, n_q: int,
                           block_q: int = 128, block_k: int = 128,
                           placement: str = "shift") -> Schedule:
    """Compile ``mask``'s block map into a single-head ragged Schedule.

    ``Schedule.cells`` records the ragged cell set, ``partial_cells`` the
    tiles the kernels must mask-multiply, and ``mask_key`` pins the schedule
    to its mask spec so the kernel entry points catch a mismatch.
    """
    if placement not in PLACEMENTS:
        raise KeyError(f"unknown placement {placement!r}; "
                       f"available: {PLACEMENTS}")
    bm = mask.block_map(n_kv, n_q, block_q, block_k)
    cells = tuple((kv, q) for kv in range(n_kv) for q in range(n_q)
                  if bm[kv, q] != EMPTY)
    partial = tuple((kv, q) for kv, q in cells if bm[kv, q] == PARTIAL)
    cols = ragged_columns(cells)
    missing = [q for q in range(n_q) if q not in cols]
    assert not missing, (
        f"q tiles {missing} have no visible KV tile — the mask leaves those "
        "query rows attending to nothing")
    rows = sorted({kv for kv, _ in cells})
    row_qs = {kv: sorted(q for r, q in cells if r == kv) for kv in rows}

    if placement == "shift":
        orders = _shift_orders(rows, row_qs, n_q)
    else:  # fa3-style ascending walk
        orders = {kv: row_qs[kv] for kv in rows}

    chains: List[Tuple] = []
    slot_of: Dict[Tuple[int, int], int] = {}
    worker_of: Dict[int, int] = {}
    for w, kv in enumerate(rows):
        worker_of[kv] = w
        chains.append(tuple((0, kv, q) for q in orders[kv]))
        for t, q in enumerate(orders[kv]):
            slot_of[(kv, q)] = t

    red: Dict[Tuple[int, int], Tuple[Tuple[int, int], ...]] = {}
    for q, kvs in cols.items():
        if placement == "shift":
            # by execution slot; ties broken by worker — provably acyclic
            order = sorted(kvs, key=lambda kv: (slot_of[(kv, q)],
                                                worker_of[kv]))
        else:
            order = kvs  # ascending KV row, the fa3 convention
        red[(0, q)] = tuple((kv, worker_of[kv]) for kv in order)

    sch = Schedule(f"block_{placement}", False, len(rows), n_kv, n_q, 1,
                   tuple(chains), red, cells=cells, partial_cells=partial,
                   mask_key=mask.key())
    sch.validate()
    return sch


@functools.lru_cache(maxsize=SCHEDULE_CACHE_MAXSIZE)
def _cached_block_schedule(mask, n_kv, n_q, block_q, block_k, placement):
    return compile_block_schedule(mask, n_kv, n_q, block_q, block_k, placement)


def cached_block_schedule(mask: MaskSpec, n_kv: int, n_q: int,
                          block_q: int = 128, block_k: int = 128,
                          placement: str = "shift",
                          tune: bool = False) -> Schedule:
    """Memoized :func:`compile_block_schedule`. The lru key includes the mask
    spec itself (hashable by construction), so two distinct masks with equal
    tile counts never collide. ``tune=True`` (the reference's placement
    tuner) is not ported and raises."""
    if tune:
        raise NotImplementedError(
            "cached_block_schedule(tune=True): the placement tuner is not "
            "ported yet (ROADMAP A7, observability and tuner)")
    return _cached_block_schedule(mask, n_kv, n_q, block_q, block_k, placement)


cached_block_schedule.cache_info = _cached_block_schedule.cache_info
cached_block_schedule.cache_clear = _cached_block_schedule.cache_clear
