"""DASH schedules (paper §3): task orders for the deterministic attention backward pass.

Port of ``repro.core.schedules``; numpy only, so the code is the reference's
own. The integer arrays it emits (``prefetch_arrays``, ``worker_chains``) are
held equal to the reference's by ``tests/test_torch_schedules.py``. Ragged
(block-sparse mask) schedules come from :mod:`repro_torch.masks.schedule`
through ``make_schedule(mask=)`` / ``cached_schedule(mask=)``, whose
``tune=True`` lets the tuner pick the placement.

The deterministic backward pass processes tasks ``(head, kv_tile, q_tile)``. Each task
has a compute phase (cost ``c``) producing local dK/dV contributions plus a partial
dQ, followed by a reduction phase (cost ``r``) that accumulates the partial dQ into
the global dQ buffer **in a prescribed order per (head, q) column** — that order is
what makes the pass deterministic.

A :class:`Schedule` fixes simultaneously
  * the per-worker task chains (paper §3.1 constraint: all tasks of one KV tile must
    run contiguously on one worker so dK/dV stay accumulator-resident), and
  * the per-(head, q) reduction order.

Four generators are provided, mirroring the paper:

``fa3``              the FlashAttention-3 deterministic baseline (ascending Q tiles,
                     reduction serialized by ascending KV index).  §3.2
``descending``       Descending Q-Tile Iteration (reverse Q traversal; on causal
                     masks, alternate heads reverse the KV→worker assignment so a
                     head-pair is load balanced).  §3.3
``shift``            Shift Scheduling for full masks — worker ``i`` visits Q tiles
                     ``(i, i+1, …, n-1, 0, …, i-1)``; provably optimal (Lemma 1). §3.4
``symmetric_shift``  Symmetric Shift Scheduling for causal masks — KV rows ``i`` and
                     ``n-1-i`` are paired across a head pair and the two triangles
                     fold into a dense n×(n+1) virtual rectangle traversed cyclically
                     with offsets on segment boundaries ("diagonal-initialized shift
                     on the conceptual square", §3.4 + Fig. 7).

A Schedule can also carry an explicit **ragged** cell set (``cells``, from a
block-sparse mask's block map); ``validate()``/``worker_chains()``/
``prefetch_arrays()`` operate on it as in the reference.

Schedules are plain data: here they drive the backward kernels of
:mod:`repro_torch.kernels.flash_bwd` (the serialized task list and the padded
per-worker chains).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np

Task = Tuple[int, int, int]  # (head, kv_tile, q_tile)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A deterministic attention-backward schedule.

    Attributes:
      name: generator name (``fa3`` / ``descending`` / ``shift`` / ``symmetric_shift``).
      causal: mask shape. Valid tasks are ``q >= kv`` when causal, all when full.
      n_workers: number of workers (GPU SMs in the paper; Pallas "virtual workers" /
        CP devices in this repo).
      n_kv / n_q: tile counts. The paper analyses ``n_kv == n_workers``.
      n_heads: number of attention heads scheduled as one pipeline.
      chains: per-worker task lists; contiguous execution order.
      reduction_order: per ``(head, q)`` the prescribed accumulation order given as a
        list of ``(kv, worker)`` in reduction sequence. Deterministic by construction.
      cells: optional explicit per-head (kv, q) cell list for **ragged**
        (block-sparse-mask) schedules; ``None`` means the rectangular /
        triangular set implied by ``causal``.
      partial_cells: (kv, q) tiles only partially inside the mask — the kernels
        mask-multiply these; FULL tiles run unmasked.
      mask_key: the key of the compiling mask spec (ragged schedules
        only); kernel entry points check it against the mask they are handed.
    """

    name: str
    causal: bool
    n_workers: int
    n_kv: int
    n_q: int
    n_heads: int
    chains: Tuple[Tuple[Task, ...], ...]
    reduction_order: Dict[Tuple[int, int], Tuple[Tuple[int, int], ...]]
    cells: Tuple[Tuple[int, int], ...] | None = None
    partial_cells: Tuple[Tuple[int, int], ...] = ()
    mask_key: str | None = None
    # per-instance memo for derived kernel arrays (worker_chains / serialization);
    # excluded from equality so two structurally equal schedules stay equal.
    _memo: Dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    # ---------------------------------------------------------------- helpers
    def valid_cells(self) -> set:
        if self.cells is not None:
            return {(h, kv, q) for h in range(self.n_heads)
                    for (kv, q) in self.cells}
        cells = set()
        for h in range(self.n_heads):
            for kv in range(self.n_kv):
                for q in range(self.n_q):
                    if (not self.causal) or q >= kv:
                        cells.add((h, kv, q))
        return cells

    def all_tasks(self) -> List[Task]:
        return [t for chain in self.chains for t in chain]

    def validate(self) -> None:
        """Check the paper's structural invariants. Raises AssertionError on violation."""
        tasks = self.all_tasks()
        # 1. exact cover of the valid (head, kv, q) cells
        assert len(tasks) == len(set(tasks)), "duplicate task"
        assert set(tasks) == self.valid_cells(), "schedule does not cover mask cells"
        # 2. contiguity: all tasks of one (head, kv) row form one unbroken run on one worker
        seen_rows = {}
        for w, chain in enumerate(self.chains):
            prev_row = None
            for (h, kv, q) in chain:
                row = (h, kv)
                if row != prev_row:
                    assert row not in seen_rows, (
                        f"KV row {row} split across workers/runs (paper §3.1 constraint)")
                    seen_rows[row] = w
                prev_row = row
        # 3. reduction orders cover each nonempty column exactly (ragged cell
        # sets may leave entire (h, q) columns EMPTY — those carry no order)
        cols: Dict[Tuple[int, int], List[int]] = {}
        for (h, kv, q) in self.valid_cells():
            cols.setdefault((h, q), []).append(kv)
        assert set(self.reduction_order) == set(cols), (
            "reduction orders do not match the nonempty columns: "
            f"extra={sorted(set(self.reduction_order) - set(cols))[:4]} "
            f"missing={sorted(set(cols) - set(self.reduction_order))[:4]}")
        for key, col in cols.items():
            order = self.reduction_order[key]
            assert sorted(kv for kv, _ in order) == sorted(col), (
                f"reduction order for column {key} incomplete")

    # -------------------------------------------------------- kernel emission
    def prefetch_arrays(self, head: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Per-head (kv_ids, q_ids) int32 arrays for the Pallas scalar-prefetch grid.

        On TPU the Pallas grid executes sequentially on one core, so the n worker
        chains are serialized worker-major; contiguity of KV rows is preserved, which
        is what keeps the dK/dV accumulator VMEM-resident between grid steps.
        Memoized on the instance (rebuilt kernels retrace per shape/dtype).
        """
        key = ("serialize", head)
        if key not in self._memo:
            kv_ids, q_ids = [], []
            for chain in self.chains:
                for (h, kv, q) in chain:
                    if h == head:
                        kv_ids.append(kv)
                        q_ids.append(q)
            self._memo[key] = (np.asarray(kv_ids, np.int32),
                               np.asarray(q_ids, np.int32))
        return self._memo[key]

    def worker_chains(self, head: int = 0) -> Dict[str, np.ndarray]:
        """Per-worker padded prefetch arrays for the worker-parallel backward.

        The serialized realization (:meth:`prefetch_arrays`) plays all chains on
        one sequential core; this emits the schedule's *parallel dimension*: a
        ``(n_workers, max_chain_len)`` grid where each row is one worker's chain
        for ``head``, padded at the tail with no-op **sentinel tasks**. A sentinel
        repeats the worker's last valid ``(kv, q)`` so every BlockSpec index map
        stays constant across the padding — no extra DMA is issued and the grid
        step is a pure no-op under the ``valid`` guard.

        Returns int32 arrays (all ``(W, T)`` unless noted):
          ``kv_ids`` / ``q_ids``  task tile indices (sentinels repeat the last task)
          ``valid``               1 for real tasks, 0 for sentinel padding
          ``q_first``             1 iff the task is this worker's first visit to
                                  its q column (fresh write vs read-modify-write
                                  of the worker-private dQ partial)
          ``visited``             ``(W, n_q)`` — 1 iff the worker contributes to
                                  the q column at all (drives the combine mask)
        plus ``single_visit`` (python bool): every worker touches each q column
        at most once for this head. True for every registry generator at
        ``n_heads=1``; it is the condition under which the parallel realization
        is **bitwise identical** to the serialized one (the per-column reduction
        degenerates to the same left fold in ascending worker order).
        """
        key = ("worker_chains", head)
        if key in self._memo:
            return self._memo[key]
        per_worker: List[List[Tuple[int, int]]] = []
        for chain in self.chains:
            per_worker.append([(kv, q) for (h, kv, q) in chain if h == head])
        if any(len(c) == 0 for c in per_worker):
            raise ValueError(
                f"schedule {self.name!r}: empty worker chain for head {head} — "
                "the worker-parallel grid needs every worker to own a KV row")
        W = self.n_workers
        T = max(len(c) for c in per_worker)
        kv_ids = np.zeros((W, T), np.int32)
        q_ids = np.zeros((W, T), np.int32)
        valid = np.zeros((W, T), np.int32)
        q_first = np.zeros((W, T), np.int32)
        visited = np.zeros((W, self.n_q), np.int32)
        single_visit = True
        for w, tasks in enumerate(per_worker):
            seen_q = set()
            for t in range(T):
                kv, q = tasks[min(t, len(tasks) - 1)]
                kv_ids[w, t], q_ids[w, t] = kv, q
                if t < len(tasks):
                    valid[w, t] = 1
                    if q not in seen_q:
                        q_first[w, t] = 1
                        seen_q.add(q)
                    else:
                        single_visit = False
                    visited[w, q] = 1
        out = dict(kv_ids=kv_ids, q_ids=q_ids, valid=valid, q_first=q_first,
                   visited=visited, single_visit=single_visit)
        self._memo[key] = out
        return out

    def worker_slots(self) -> Dict[Task, Tuple[int, int]]:
        """task -> (worker, position in chain)."""
        out = {}
        for w, chain in enumerate(self.chains):
            for pos, t in enumerate(chain):
                out[t] = (w, pos)
        return out


# =============================================================================
# generators
# =============================================================================
def _columns(n_kv: int, n_q: int, causal: bool, head: int):
    cols: Dict[Tuple[int, int], List[int]] = {}
    for q in range(n_q):
        cols[(head, q)] = [kv for kv in range(n_kv) if (not causal) or q >= kv]
    return cols


def fa3(n: int, n_heads: int = 1, causal: bool = False, n_q: int | None = None) -> Schedule:
    """FlashAttention-3 deterministic baseline (paper §3.2).

    Worker ``i`` owns KV tile ``i`` for every head and iterates Q tiles ascending.
    dQ columns reduce in ascending KV order. Closed forms (simulator-verified):
    full  ``T = m·n·(c+r) + (n-1)·r``;  causal ``T = m·n·(c+r) + (n-1)·r``
    (same as full despite ~half the work — the head-long bubble of Fig. 3b).
    """
    n_q = n if n_q is None else n_q
    chains = []
    for w in range(n):
        chain = []
        for h in range(n_heads):
            qs = [q for q in range(n_q) if (not causal) or q >= w]
            chain += [(h, w, q) for q in qs]
        chains.append(tuple(chain))
    red = {}
    for h in range(n_heads):
        for (hq, q), col in _columns(n, n_q, causal, h).items():
            red[(hq, q)] = tuple((kv, kv) for kv in sorted(col))  # worker == kv here
    return Schedule("fa3", causal, n, n, n_q, n_heads, tuple(chains), red)


def descending(n: int, n_heads: int = 1, causal: bool = True) -> Schedule:
    """Descending Q-Tile Iteration (paper §3.3).

    Q tiles are traversed in reverse. For causal masks the KV→worker assignment is
    mirrored on odd heads (worker ``i`` takes row ``n-1-i``) so a head pair carries
    ``n+1`` tasks per worker; short chains finish first and the next head back-fills.
    Closed form: ``T ≈ m(n+1)(c+r)/2 + (n-1)r`` for even m (causal).
    """
    chains = []
    owner = {}  # (head, kv) -> worker
    for w in range(n):
        chain = []
        for h in range(n_heads):
            kv = w if (h % 2 == 0 or not causal) else n - 1 - w
            owner[(h, kv)] = w
            qs = [q for q in range(n - 1, -1, -1) if (not causal) or q >= kv]
            chain += [(h, kv, q) for q in qs]
        chains.append(tuple(chain))
    red = {}
    for h in range(n_heads):
        for (hq, q), col in _columns(n, n, causal, h).items():
            red[(hq, q)] = tuple((kv, owner.get((h, kv), kv)) for kv in sorted(col))
    return Schedule("descending", causal, n, n, n, n_heads, tuple(chains), red)


def shift(n: int, n_heads: int = 1, n_q: int | None = None) -> Schedule:
    """Shift Scheduling for full masks (paper §3.4, Fig. 6) — optimal.

    Worker ``i`` visits Q tiles ``(i, i+1, …, n_q-1, 0, …, i-1)``: at any time slot
    all workers occupy distinct Q columns, so the serialized dQ reductions are
    conflict-free and depth-monotone (Lemma 1).  ``T = m·n·(c+r)`` exactly.
    """
    n_q = n if n_q is None else n_q
    chains = []
    for w in range(n):
        chain = []
        for h in range(n_heads):
            chain += [(h, w, (w + t) % n_q) for t in range(n_q)]
        chains.append(tuple(chain))
    red = {}
    for h in range(n_heads):
        for q in range(n_q):
            # worker i reduces column q at slot (q - i) mod n_q; order by slot.
            order = sorted(range(n), key=lambda i: (q - i) % n_q)
            red[(h, q)] = tuple((i, i) for i in order)
    return Schedule("shift", False, n, n, n_q, n_heads, tuple(chains), red)


def symmetric_shift(n: int, n_heads: int = 2) -> Schedule:
    """Symmetric Shift Scheduling for causal masks (paper §3.4, Fig. 7) — optimal.

    Construction (the "conceptual square" fold, realized over a head pair):
    for heads ``(A, B) = (2k, 2k+1)`` worker ``i`` owns KV row ``i`` of head A
    (``n-i`` tasks) and KV row ``n-1-i`` of head B (``i+1`` tasks) — the symmetric
    longest-with-shortest pairing; together ``n+1`` tasks.  Lay the pair out as a
    dense ``n × (n+1)`` virtual rectangle:

      virtual column ``v_A(q) = n-1-q``  (head A rows descend in q  → Descending!)
      virtual column ``v_B(q) = q+1``    (head B rows ascend in q)

    Every (head, q) column maps to exactly one virtual column, so the cyclic
    traversal ``v = (start_i + t) mod (n+1)`` with ``start_i = n - i`` (a segment
    boundary, keeping both KV rows contiguous) is conflict-free and depth-monotone.
    ``T = m(n+1)(c+r)/2`` exactly for even m — the paper's optimum.

    For odd ``n_heads`` the final head falls back to the descending heuristic.
    """
    chains: List[List[Task]] = [[] for _ in range(n)]
    red: Dict[Tuple[int, int], Tuple[Tuple[int, int], ...]] = {}
    n_pairs, odd = divmod(n_heads, 2)
    for k in range(n_pairs):
        hA, hB = 2 * k, 2 * k + 1
        slot_of: Dict[Task, int] = {}
        for w in range(n):
            # canonical list indexed by virtual column v in [0, n+1)
            canon: List[Task] = [None] * (n + 1)
            for q in range(w, n):          # head A row w, descending via v = n-1-q
                canon[n - 1 - q] = (hA, w, q)
            for q in range(n - 1 - w, n):  # head B row n-1-w, ascending via v = q+1
                canon[q + 1] = (hB, n - 1 - w, q)
            start = n - w
            order = [canon[(start + t) % (n + 1)] for t in range(n + 1)]
            assert all(t is not None for t in order)
            chains[w] += order
            for t_slot, task in enumerate(order):
                slot_of[task] = t_slot
        # reduction order per column: by execution slot (distinct by construction)
        for h, v_of_q in ((hA, lambda q: n - 1 - q), (hB, lambda q: q + 1)):
            for q in range(n):
                col = []
                for kv in range(q + 1):
                    w = kv if h == hA else n - 1 - kv
                    col.append((kv, w, slot_of[(h, kv, q)]))
                col.sort(key=lambda x: x[2])
                red[(h, q)] = tuple((kv, w) for kv, w, _ in col)
    if odd:
        # final unpaired head: descending heuristic, standalone
        h = n_heads - 1
        for w in range(n):
            chains[w] += [(h, w, q) for q in range(n - 1, w - 1, -1)]
        for q in range(n):
            red[(h, q)] = tuple((kv, kv) for kv in range(q + 1))
    return Schedule("symmetric_shift", True, n, n, n, n_heads,
                    tuple(tuple(c) for c in chains), red)


GENERATORS = {
    "fa3": fa3,
    "descending": descending,
    "shift": shift,
    "symmetric_shift": symmetric_shift,
}


def make_schedule(name: str, n: int, n_heads: int = 1, causal: bool = False,
                  n_q: int | None = None, mask=None, block_q: int = 128,
                  block_k: int = 128) -> Schedule:
    """Uniform entry point used by the kernels.

    ``n_q`` reaches the rectangular-grid generators (``fa3``, ``shift``);
    ``descending`` / ``symmetric_shift`` are square by construction (their
    KV-row folds pair rows with columns) and reject a differing ``n_q``.

    ``mask`` (a :class:`repro_torch.masks.spec.MaskSpec`) routes to the
    block-sparse compiler instead: ``name`` then selects the *placement*
    (``shift`` or ``fa3``), ``n``/``n_q`` are tile counts and
    ``block_q``/``block_k`` the tile sizes the block map is classified at.
    """
    if mask is not None:
        from repro_torch.masks.schedule import compile_block_schedule
        if name not in ("shift", "fa3"):
            raise ValueError(
                f"block-sparse masks support placements ('shift', 'fa3'); "
                f"got {name!r} (descending/symmetric_shift pair KV rows with "
                "columns and require square triangular masks)")
        return compile_block_schedule(mask, n_kv=n, n_q=n if n_q is None
                                      else n_q, block_q=block_q,
                                      block_k=block_k, placement=name)
    if name == "fa3":
        return fa3(n, n_heads, causal, n_q=n_q)
    if name in ("descending", "symmetric_shift") and n_q not in (None, n):
        raise ValueError(f"{name} schedules are square (n_kv == n_q == {n}); "
                         f"got n_q={n_q}")
    if name == "descending":
        return descending(n, n_heads, causal)
    if name == "shift":
        if causal:
            raise ValueError("shift scheduling is the full-mask optimum; "
                             "use symmetric_shift for causal masks (paper §3.4)")
        return shift(n, n_heads, n_q=n_q)
    if name == "symmetric_shift":
        if not causal:
            raise ValueError("symmetric_shift is the causal-mask optimum; "
                             "use shift for full masks (paper §3.4)")
        return symmetric_shift(n, n_heads)
    raise KeyError(f"unknown schedule {name!r}; available: {sorted(GENERATORS)}")


# Explicit bound on the shared schedule memo (the reference's
# SCHEDULE_CACHE_MAXSIZE): a pathological caller degrades to rebuilding
# schedules instead of unbounded growth.
SCHEDULE_CACHE_MAXSIZE = 256


@functools.lru_cache(maxsize=SCHEDULE_CACHE_MAXSIZE)
def _cached_schedule(name, n, n_heads, causal, n_q, mask, block_q, block_k):
    if mask is not None:
        if name not in ("shift", "fa3"):
            # same guard as make_schedule, before touching the mask cache
            return make_schedule(name, n, n_heads=n_heads, causal=causal,
                                 n_q=n_q, mask=mask, block_q=block_q,
                                 block_k=block_k)
        from repro_torch.masks.schedule import cached_block_schedule
        return cached_block_schedule(mask, n, n if n_q is None else n_q,
                                     block_q, block_k, name)
    return make_schedule(name, n, n_heads=n_heads, causal=causal, n_q=n_q,
                         mask=mask, block_q=block_q, block_k=block_k)


def cached_schedule(name: str, n: int, n_heads: int = 1, causal: bool = False,
                    n_q: int | None = None, mask=None, block_q: int = 128,
                    block_k: int = 128, tune: bool = False) -> Schedule:
    """Memoized :func:`make_schedule` keyed by
    ``(name, n_kv=n_workers=n, n_q, n_heads, causal, mask, block_q,
    block_k)``.

    The **mask spec is part of the key** (specs are frozen and hashable): two
    distinct block-sparse masks with equal tile counts are never handed the
    same schedule. Block-sparse schedules delegate to
    :func:`repro_torch.masks.schedule.cached_block_schedule`, so both entry
    points hand out the same instance per (mask, tiling, placement).
    Reusing one instance also shares the derived kernel arrays memoized on it
    (:meth:`Schedule.worker_chains`, :meth:`Schedule.prefetch_arrays`).

    ``tune=True`` (block-sparse only) lets
    :func:`repro_torch.tune.pick_placement` resolve the placement from the
    modeled makespan instead of ``name`` — a pure simulator comparison, so
    the choice is a function of the key, never of a clock.
    """
    if tune and mask is not None:
        from repro_torch.tune import pick_placement
        name = pick_placement(mask, n, n if n_q is None else n_q,
                              block_q, block_k)
    # normalize to positional: lru_cache keys kwargs separately
    return _cached_schedule(name, n, n_heads, causal, n_q, mask,
                            block_q, block_k)


cached_schedule.cache_info = _cached_schedule.cache_info
cached_schedule.cache_clear = _cached_schedule.cache_clear
