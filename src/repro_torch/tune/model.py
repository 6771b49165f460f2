"""Pure modeled ranking: candidate → modeled makespan seconds via the DAG
simulator (:mod:`repro_torch.core.simulator`) at roofline task costs.

No hardware is touched and no clock is read — the ranking is a deterministic
pure function of (geometry, mask, candidate set, roofline), which is what
makes sim-mode tuning reproducible across processes and machines. The
roofline is a parameter of every function here, defaulting to an H100 SXM's
published peaks:

  compute phase  c(bq, bk, d) = 4 GEMM-equivalents of the fwd+bwd tile math
                              = 8·bq·bk·d / peak_flops   seconds
  reduction      r(bq, d)     = fp32 dQ read-modify-write
                              = 8·bq·d / hbm_bytes_per_s seconds

Makespans in *seconds* are comparable across block sizes: halving the block
quadruples the task count but quarters ``c`` per task, so the model charges
small blocks their extra serialized-reduction latency rather than their
(unchanged) total work.

Makespan per realization:
  worker_parallel — ``simulate(schedule, c, r).makespan`` (the quantity DASH
                    minimizes; reduction stalls included);
  serialized      — ``n_tasks · (c + r)`` (one CTA plays every chain;
                    utilization pinned at ``1/n_workers``).

Port of ``repro.tune.model`` with the same arithmetic in the same order, so
under the reference's constants the makespans and the ranking equal its own
(``tests/test_torch_tune.py``). The model is the paper's: it stalls each
column's reduction on its predecessor in ``reduction_order``, while the
port's worker kernel writes per-worker dQ partials and folds them afterwards
(ascending worker id) without such stalls; ``chip_smoke.py``'s ``[tune]``
phase prints the modeled and the measured time of every candidate side by
side.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core import simulator as sim
from repro_torch.tune.space import Candidate, build_schedule, family_rank

# NVIDIA H100 80GB HBM3 (SXM), data sheet, at its 700 W power limit: dense
# bf16 tensor-core peak and HBM3 bandwidth
PEAK_FLOPS = 989.4e12
HBM_BYTES_PER_S = 3.35e12


def task_costs(block_q: int, block_k: int, head_dim: int,
               peak_flops: float = PEAK_FLOPS,
               hbm_bytes_per_s: float = HBM_BYTES_PER_S
               ) -> Tuple[float, float]:
    """(c, r) seconds per task for one tile: 4 GEMMs of fwd+bwd-ish compute,
    fp32 dQ block read+write for the reduction."""
    c = (4 * 2 * block_q * block_k * head_dim) / peak_flops
    r = (2 * block_q * head_dim * 4) / hbm_bytes_per_s
    return c, r


def modeled_costs(cand: Candidate, *, seq_q: int, seq_kv: Optional[int] = None,
                  head_dim: int, causal: bool = False, mask=None,
                  peak_flops: float = PEAK_FLOPS,
                  hbm_bytes_per_s: float = HBM_BYTES_PER_S) -> Dict[str, float]:
    """Modeled makespan (seconds) + utilization for one candidate."""
    seq_kv = seq_q if seq_kv is None else seq_kv
    c, r = task_costs(cand.block_q, cand.block_k, head_dim, peak_flops,
                      hbm_bytes_per_s)
    schedule = build_schedule(cand, seq_q, seq_kv, causal, mask)
    n_tasks = len(schedule.all_tasks())
    if cand.worker_parallel:
        res = sim.simulate(schedule, c, r)
        makespan, util = res.makespan, res.utilization
    else:
        makespan = n_tasks * (c + r)
        util = 1.0 / max(1, cand.n_workers)
    return {"modeled_makespan_s": makespan, "modeled_utilization": util,
            "n_tasks": float(n_tasks),
            "lower_bound_s": sim.ragged_lower_bound(schedule, c, r)}


def rank_candidates(candidates, *, seq_q: int, seq_kv: Optional[int] = None,
                    head_dim: int, causal: bool = False, mask=None,
                    peak_flops: float = PEAK_FLOPS,
                    hbm_bytes_per_s: float = HBM_BYTES_PER_S) -> List[Dict]:
    """Rank by modeled makespan; ties break first on the paper's analytic
    family preference (:func:`repro_torch.tune.space.family_rank` — at some
    sizes descending also reaches the causal lower bound and the model cannot
    separate it from symmetric_shift), then on :meth:`Candidate.key` (a fixed
    total order). The ranking is a pure function of the candidate *set* —
    never of enumeration or dict order. Returns dicts
    ``{candidate, modeled_makespan_s, modeled_utilization, ...}`` ascending."""
    rows = []
    for cand in candidates:
        row = modeled_costs(cand, seq_q=seq_q, seq_kv=seq_kv,
                            head_dim=head_dim, causal=causal, mask=mask,
                            peak_flops=peak_flops,
                            hbm_bytes_per_s=hbm_bytes_per_s)
        row["candidate"] = cand
        rows.append(row)
    rows.sort(key=lambda row: (row["modeled_makespan_s"],
                               family_rank(row["candidate"].schedule),
                               row["candidate"].key()))
    return rows
