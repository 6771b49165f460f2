"""Optional hardware validation of the top-k modeled candidates.

Sim-mode ranking (:mod:`repro_torch.tune.model`) never touches a clock; measure mode
refines it by timing the top-k candidates for real — with a protocol built so
that *wall-clock jitter can never pick the winner between near-equal
candidates*:

  * fixed warmup count, fixed rep count (no adaptive early exit — the work
    performed is a pure function of the candidate list);
  * per candidate the **minimum** over reps is kept (min is the standard
    jitter-robust location estimate for a lower-bounded timing distribution);
  * every candidate whose time is within ``rel_tol`` of the fastest is a
    *tie*, and ties resolve deterministically by (modeled makespan, candidate
    key) — the same total order sim mode uses.

So two measure-mode runs on one machine can only disagree when two candidates
differ by more than ``rel_tol`` in real throughput — in which case either run
picks the genuinely faster one — and the persisted cache entry
(:mod:`repro_torch.tune.cache`) makes even that choice sticky afterwards.

Port of ``repro.tune.measure``, the same protocol; on the card a runner ends
in ``torch.cuda.synchronize()``, as the reference's ends in
``block_until_ready``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List

from repro_torch.tune.space import family_rank

DEFAULT_WARMUP = 2
DEFAULT_REPS = 5
DEFAULT_REL_TOL = 0.05


def time_candidate(runner: Callable, cand, warmup: int = DEFAULT_WARMUP,
                   reps: int = DEFAULT_REPS,
                   clock: Callable[[], float] = time.perf_counter) -> float:
    """Best-of-``reps`` seconds for one candidate. ``runner(candidate)`` must
    execute the workload once, synchronously: on the card it ends in
    ``torch.cuda.synchronize()``, so the clock reads finished work."""
    for _ in range(warmup):
        runner(cand)
    best = float("inf")
    for _ in range(reps):
        t0 = clock()
        runner(cand)
        best = min(best, clock() - t0)
    return best


def measure_topk(ranked: List[Dict], runner: Callable, k: int = 3,
                 warmup: int = DEFAULT_WARMUP, reps: int = DEFAULT_REPS,
                 rel_tol: float = DEFAULT_REL_TOL,
                 clock: Callable[[], float] = time.perf_counter) -> List[Dict]:
    """Time the first ``k`` rows of a
    :func:`repro_torch.tune.model.rank_candidates`
    ranking; return the timed rows re-sorted with the winner first.

    Sort key: (tie bucket, modeled makespan, family preference, candidate
    key), where the tie bucket is 0 for every candidate within ``rel_tol`` of
    the fastest measured time and the measured time itself otherwise — the
    deterministic tie-break the module docstring describes, identical to sim
    mode's within a bucket.
    """
    timed = []
    for row in ranked[:max(1, k)]:
        row = dict(row)
        row["measured_s"] = time_candidate(runner, row["candidate"],
                                           warmup, reps, clock)
        timed.append(row)
    fastest = min(row["measured_s"] for row in timed)
    threshold = fastest * (1.0 + rel_tol)

    def sort_key(row):
        tied = row["measured_s"] <= threshold
        return (0.0 if tied else row["measured_s"],
                row["modeled_makespan_s"],
                family_rank(row["candidate"].schedule),
                row["candidate"].key())

    timed.sort(key=sort_key)
    return timed
