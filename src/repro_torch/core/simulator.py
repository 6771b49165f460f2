"""Event-driven Gantt simulator for DASH schedules (paper Figs. 3/4/6/7).

Operational semantics (matching the paper's Gantt charts):
  * each worker executes its chain in order;
  * a task's compute phase (cost ``c``) starts when the worker is free;
  * its reduction phase (cost ``r``) starts when BOTH the compute has finished AND
    the predecessor reduction in its (head, q) column's prescribed order has
    finished (+ an optional dependency latency ``link``, modelling the paper's
    §4.2 L2/ICI signal cost — zero in the idealized DAG model);
  * the worker is occupied through both phases (the dQ-writer blocks the pipeline).

``simulate`` returns the makespan plus utilization; ``closed_form`` returns the
paper's analytic formulas so tests can assert exact agreement.

This model is also the autotuner's ranking function:
:mod:`repro_torch.tune.model` scores every legal candidate with ``simulate``
at roofline-calibrated task costs, which is what makes sim-mode tuning a pure,
bit-stable function of the geometry (no clock ever read).

Port of ``repro.core.simulator``: pure Python on floats, so makespans,
``busy_time`` and every ``task_times`` entry equal the reference's exactly
(``tests/test_torch_simulator.py``). The model's stalls are those of a kernel
that reduces each column in ``reduction_order``; the port's worker backward
writes per-worker dQ partials and folds them afterwards in ascending worker
id, so it has none of them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.schedules import Schedule, Task


@dataclasses.dataclass
class SimResult:
    makespan: float
    busy_time: float           # sum over workers of (c+r) task occupancy
    total_span: float          # n_workers * makespan
    task_times: Dict[Task, Tuple[float, float, float]]  # (compute_start, red_start, red_end)

    @property
    def utilization(self) -> float:
        return self.busy_time / self.total_span if self.total_span else 0.0

    @property
    def bubble_fraction(self) -> float:
        return 1.0 - self.utilization


def simulate(schedule: Schedule, c: float = 1.0, r: float = 0.5,
             link: float = 0.0) -> SimResult:
    """Simulate a schedule; deterministic single pass (no randomness)."""
    # predecessor in the prescribed reduction order, per task
    pred: Dict[Task, Optional[Task]] = {}
    for (h, q), order in schedule.reduction_order.items():
        prev = None
        for (kv, _w) in order:
            t = (h, kv, q)
            pred[t] = prev
            prev = t

    task_times: Dict[Task, Tuple[float, float, float]] = {}
    # workers advance independently, but reductions couple them; iterate until fixed
    # point. Because chains are executed in order and pred reductions refer to tasks
    # that may live later on another worker's chain, we sweep in rounds.
    remaining = [list(chain) for chain in schedule.chains]
    worker_free = [0.0] * schedule.n_workers
    progressed = True
    while any(remaining) and progressed:
        progressed = False
        for w, chain in enumerate(remaining):
            while chain:
                task = chain[0]
                p = pred[task]
                if p is not None and p not in task_times:
                    break  # blocked on a reduction not yet scheduled
                cs = worker_free[w]
                ce = cs + c
                rs = ce
                if p is not None:
                    rs = max(rs, task_times[p][2] + link)
                re = rs + r
                task_times[task] = (cs, rs, re)
                worker_free[w] = re
                chain.pop(0)
                progressed = True
    if any(remaining):
        raise ValueError("schedule deadlocks: reduction order conflicts with chain order")
    makespan = max(worker_free)
    busy = len(task_times) * (c + r)
    return SimResult(makespan, busy, schedule.n_workers * makespan, task_times)


# ----------------------------------------------------------------- closed forms
def closed_form(name: str, n: int, m: int, c: float, r: float,
                causal: bool) -> float:
    """The paper's analytic makespans (§3.2–§3.4).

    fa3 full:            m·n·(c+r) + (n-1)·r
    fa3 causal:          m·n·(c+r) + (n-1)·r          (Fig. 3b bubble analysis)
    descending causal:   m(n+1)(c+r)/2 + (n-1)·r      (even m, §3.3)
    shift full:          m·n·(c+r)                    (optimal, §3.4)
    symmetric causal:    m(n+1)(c+r)/2                (optimal, even m, §3.4)
    """
    if name == "fa3":
        return m * n * (c + r) + (n - 1) * r
    if name == "descending":
        if not causal:
            return m * n * (c + r) + (n - 1) * r
        return m * (n + 1) * (c + r) / 2 + (n - 1) * r
    if name == "shift":
        return m * n * (c + r)
    if name == "symmetric_shift":
        return m * (n + 1) * (c + r) / 2
    raise KeyError(name)


def work_lower_bound(n: int, m: int, c: float, r: float, causal: bool) -> float:
    """Work / workers — no schedule can beat this."""
    tasks = m * n * (n + 1) / 2 if causal else m * n * n
    return tasks * (c + r) / n


def ragged_lower_bound(schedule: Schedule, c: float = 1.0,
                       r: float = 0.5) -> float:
    """Makespan lower bound for arbitrary (ragged / block-sparse) schedules.

    Three independent bounds, any schedule ≥ each:
      * chain bound — some worker must execute its longest row back to back:
        ``max_chain · (c + r)``;
      * column bound — a column's reductions are serialized in the prescribed
        order, and the first needs a compute first: ``c + h · r`` for the
        tallest column height ``h``;
      * work bound — total occupancy over ``n_workers`` workers.

    The generalized shift placement achieves the maximum of these whenever its
    rotation assignment is collision-free (see
    :mod:`repro_torch.masks.schedule`), which certifies optimality case by case.
    """
    chain_b = max((len(chain) for chain in schedule.chains), default=0) * (c + r)
    heights: Dict[Tuple[int, int], int] = {}
    n_tasks = 0
    for chain in schedule.chains:
        for (h, kv, q) in chain:
            heights[(h, q)] = heights.get((h, q), 0) + 1
            n_tasks += 1
    col_b = max((c + hh * r for hh in heights.values()), default=0.0)
    work_b = n_tasks * (c + r) / max(1, schedule.n_workers)
    return max(chain_b, col_b, work_b)


def speedup_table(n: int, m: int, c: float, r: float):
    """Modeled throughput speedups over the fa3 deterministic baseline."""
    out = {}
    for causal in (False, True):
        base = closed_form("fa3", n, m, c, r, causal)
        names = ["descending", "symmetric_shift"] if causal else ["descending", "shift"]
        out[("fa3", causal)] = 1.0
        for nm in names:
            out[(nm, causal)] = base / closed_form(nm, n, m, c, r, causal)
    return out
