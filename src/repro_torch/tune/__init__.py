"""repro_torch.tune — deterministic schedule autotuner (port of ``repro.tune``).

Picks the fastest *legal* DASH configuration — schedule family (or block-sparse
placement), square block size, worker count, and serialized vs worker-parallel
realization — instead of leaving those knobs to call sites.  The pipeline:

  ``space``    enumerate legal candidates (the tiles the kernels are built
               for, the mask block map, and the shared-memory budget via
               :mod:`repro_torch.kernels.smem`);
  ``model``    rank them by :mod:`repro_torch.core.simulator` modeled
               makespan at roofline task costs (H100 peaks) — pure python,
               no hardware, bit-stable;
  ``measure``  optionally time the top-k on the card with fixed warmup/rep
               counts and a deterministic tie-break (modeled makespan, then
               candidate key — wall-clock jitter can never pick between
               near-equal times);
  ``cache``    persist the winner in a content-addressed JSON store keyed
               like ``cached_schedule`` (mask hash, shape, dtype, worker
               budget, backend, tuner version) so the same machine always
               re-picks the same candidate.

Tuning is **bitwise-safe by construction**: the tuner only *resolves knobs* and
then calls exactly the code path a hand-configured call would take —
``dash_attention(tune=True)`` is bitwise identical to the equivalent
hand-configured ``dash_attention(schedule=…, block=…, worker_parallel=…)``
(``tests/test_torch_tune.py`` on the CPU, ``chip_smoke.py``'s ``[tune]``
phase on the card).  The tuner — not the call site — owns realization and,
via ``backend`` in the cache key, which kernels a decision was made for.
"""
from repro_torch.tune.api import TuneResult, pick_placement, tune_attention
from repro_torch.tune.cache import (TUNER_VERSION, TuneCache, default_cache,
                                    make_key)
from repro_torch.tune.measure import measure_topk
from repro_torch.tune.model import modeled_costs, rank_candidates, task_costs
from repro_torch.tune.space import (Candidate, enumerate_candidates,
                                    legal_blocks)

__all__ = [
    "Candidate", "enumerate_candidates", "legal_blocks",
    "task_costs", "modeled_costs", "rank_candidates",
    "measure_topk",
    "TUNER_VERSION", "TuneCache", "default_cache", "make_key",
    "TuneResult", "tune_attention", "pick_placement",
]
