"""Tuner front door: resolve one attention geometry to its best legal
candidate — cache first, then modeled ranking, then (optionally) hardware.

``tune_attention`` is what ``dash_attention(tune=…)`` and
``launch/train.py --tune`` call; ``pick_placement`` is the narrower seam
``cached_block_schedule(tune=True)`` uses when the tiling is already fixed and
only the shift-vs-fa3-order placement is free.

Determinism contract (``tests/test_torch_tune.py``):
  * sim mode is a pure function of (geometry, mask, dtype, backend) — two
    processes with the same key pick the same candidate with or without a
    shared cache;
  * measure mode persists its first pick, so later calls are cache hits —
    same machine, same choice — and its tie-break never lets wall-clock
    jitter choose between near-equal candidates
    (:mod:`repro_torch.tune.measure`);
  * the returned knobs feed exactly the code path a hand-configured call
    takes, so tuned and hand-picked runs are bitwise identical.

Port of ``repro.tune.api``. The backend string is ``"cuda-sm90"`` (the
port's hand-written kernels for Hopper), so no decision the reference made
for its TPU kernels is ever read here.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.tune import measure as measure_mod
from repro_torch.tune.cache import TuneCache, default_cache, make_key
from repro_torch.tune.model import (HBM_BYTES_PER_S, PEAK_FLOPS,
                                    modeled_costs, rank_candidates)
from repro_torch.tune.space import Candidate, enumerate_candidates, family_rank

MODES = ("sim", "measure")
# the port's kernels (csrc/*.cu, built for sm_90a); part of every cache key
DEFAULT_BACKEND = "cuda-sm90"


@dataclasses.dataclass(frozen=True)
class TuneResult:
    """A resolved tuning decision."""
    candidate: Candidate
    modeled_makespan_s: float
    modeled_utilization: float
    source: str                 # "cache" | "sim" | "measure"
    key: str
    measured_s: Optional[float] = None


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    try:
        return np.dtype(dtype).name
    except TypeError:           # a name numpy does not know ("bfloat16")
        return str(dtype)


def _dtype_bytes(dtype) -> int:
    name = _dtype_name(dtype)
    return {"float32": 4, "float64": 8, "bfloat16": 2, "float16": 2}.get(name, 2)


def _normalize_mask(causal: bool, mask):
    """Same Full/Causal normalization as ``dash_attention``: the paper masks
    route to the registry families so spec and flag forms share one key."""
    if mask is None:
        return causal, None
    from repro_torch.masks.spec import Causal, Full
    if isinstance(mask, Full):
        return False, None
    if isinstance(mask, Causal):
        return True, None
    if causal:
        raise ValueError("mask supersedes the causal flag")
    return False, mask


def tune_attention(*, seq: int, seq_kv: Optional[int] = None, head_dim: int,
                   dtype="bfloat16", causal: bool = False, mask=None,
                   n_heads: int = 1, n_kv_heads: Optional[int] = None,
                   backend: str = DEFAULT_BACKEND, mode: str = "sim",
                   cache: Optional[TuneCache] = None, tracker=None,
                   topk: int = 3, runner=None,
                   smem_budget: float = 1.0) -> TuneResult:
    """Resolve the best legal (schedule, block, realization) for one geometry.

    ``mode="sim"`` ranks by modeled makespan only (pure, no hardware);
    ``mode="measure"`` times the top-``topk`` with ``runner(candidate)``
    (required for real hardware timing; without one it ranks as sim does)
    and persists the winner. Either way the decision lands in ``cache``
    (default: the process-wide store), so the next call with the same key is
    a hit and tuning is idempotent. ``smem_budget``: the fraction of a
    block's shared memory a candidate's kernels may claim (the reference's
    ``vmem_budget``).
    """
    if mode not in MODES:
        raise ValueError(f"tune mode {mode!r}; available: {MODES}")
    causal, mask = _normalize_mask(causal, mask)
    seq_kv = seq if seq_kv is None else seq_kv
    n_kv_heads = n_heads if n_kv_heads is None else n_kv_heads
    cache = cache if cache is not None else default_cache()
    # the call's tracker hears this call's hit/miss events only: the
    # process-wide store outlives the run (and the file) it was handed with
    lend = cache.tracker is None and tracker is not None
    if lend:
        cache.tracker = tracker
    try:
        return _tune(seq, seq_kv, head_dim, dtype, causal, mask, n_heads,
                     n_kv_heads, backend, mode, cache, tracker, topk, runner,
                     smem_budget)
    finally:
        if lend:
            cache.tracker = None


def _tune(seq, seq_kv, head_dim, dtype, causal, mask, n_heads, n_kv_heads,
          backend, mode, cache, tracker, topk, runner, smem_budget):
    mask_key = mask.key() if mask is not None else (
        "causal" if causal else "full")
    key = make_key(mask_key=mask_key, seq_q=seq, seq_kv=seq_kv,
                   head_dim=head_dim, n_heads=n_heads, n_kv_heads=n_kv_heads,
                   dtype=_dtype_name(dtype), backend=backend)

    rec = cache.get(key)
    if rec is not None:
        result = TuneResult(TuneCache.candidate_of(rec),
                            rec.get("modeled_makespan_s", 0.0),
                            rec.get("modeled_utilization", 0.0),
                            "cache", key, rec.get("measured_s"))
        _emit_choice(tracker, result, mode, n_candidates=0)
        return result

    cands = enumerate_candidates(seq_q=seq, seq_kv=seq_kv, head_dim=head_dim,
                                 dtype_bytes=_dtype_bytes(dtype),
                                 causal=causal, mask=mask,
                                 smem_budget=smem_budget)
    ranked = rank_candidates(cands, seq_q=seq, seq_kv=seq_kv,
                             head_dim=head_dim, causal=causal, mask=mask)
    source, measured_s = "sim", None
    if mode == "measure" and runner is not None and len(ranked) > 1:
        ranked = measure_mod.measure_topk(ranked, runner, k=topk)
        source, measured_s = "measure", ranked[0]["measured_s"]
    win = ranked[0]
    extras = {
        "modeled_makespan_s": win["modeled_makespan_s"],
        "modeled_utilization": win["modeled_utilization"],
        "lower_bound_s": win["lower_bound_s"],
        "mode": source,
        "ranking": [{"key": row["candidate"].key(),
                     "modeled_makespan_s": row["modeled_makespan_s"]}
                    for row in ranked[:5]],
    }
    if measured_s is not None:
        extras["measured_s"] = measured_s
    cache.put(key, win["candidate"], extras)
    result = TuneResult(win["candidate"], win["modeled_makespan_s"],
                        win["modeled_utilization"], source, key, measured_s)
    _emit_choice(tracker, result, mode, n_candidates=len(cands))
    return result


def _emit_choice(tracker, result: TuneResult, mode: str, n_candidates: int):
    if tracker is None:
        return
    tracker.log("tune_choice", {
        "key": result.key, "mode": mode, "source": result.source,
        "candidate": result.candidate.key(),
        "modeled_makespan_s": result.modeled_makespan_s,
        "modeled_utilization": result.modeled_utilization,
        "n_candidates": n_candidates,
    })


@functools.lru_cache(maxsize=256)
def pick_placement(mask, n_kv: int, n_q: int, block_q: int = 128,
                   block_k: int = 128, head_dim: int = 128,
                   peak_flops: float = PEAK_FLOPS,
                   hbm_bytes_per_s: float = HBM_BYTES_PER_S) -> str:
    """Sim-only placement choice (``shift`` vs ``fa3``-order) at a *fixed*
    tiling — the ``tune=True`` seam of
    :func:`repro_torch.masks.schedule.cached_block_schedule`, where block
    sizes are already pinned by the caller's grid.  Pure + memoized: a
    deterministic function of (mask, tiling, roofline), no disk store
    needed."""
    cands = [Candidate(name, block_q, block_k, wp, 0)
             for name in ("shift", "fa3") for wp in (True, False)]
    rows = []
    for cand in cands:
        try:
            rows.append((modeled_costs(
                cand, seq_q=n_q * block_q, seq_kv=n_kv * block_k,
                head_dim=head_dim, mask=mask, peak_flops=peak_flops,
                hbm_bytes_per_s=hbm_bytes_per_s)["modeled_makespan_s"],
                family_rank(cand.schedule), cand.key(), cand.schedule))
        except (AssertionError, ValueError, KeyError):
            continue
    if not rows:
        raise ValueError(f"no legal placement for mask {mask!r} at "
                         f"{n_kv}x{n_q} tiles")
    rows.sort()
    return rows[0][3]
