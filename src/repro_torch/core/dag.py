"""DAG model of the deterministic attention backward pass (paper §3.1 + Lemma 1).

Nodes are phase boundaries of tile tasks; each task contributes a compute edge of
weight ``c`` followed by a reduction edge of weight ``r``.  Worker chains are
unbroken (the §3.1 constraint: dK/dV stay resident on chip).  The deterministic
accumulation order adds **zero-weight dependency edges** between reduction phases of
the same (head, q) column.  Lemma 1: the added edges preserve the critical path of
the chain-only graph iff every added edge ``(u, v)`` is depth-monotone,
``depth(u) <= depth(v)``.

This module is the formal layer: it builds the DAG for any
:class:`repro_torch.core.schedules.Schedule`, computes longest paths, and checks the
Lemma-1 condition.  The event-driven :mod:`repro_torch.core.simulator` is the operational
layer (it also models worker occupancy, which the DAG alone does not).

The construction is defined purely over ``schedule.chains`` and
``schedule.reduction_order``, so **ragged** block-sparse schedules
(:func:`repro_torch.masks.schedule.compile_block_schedule` — unequal chain lengths,
per-column ragged heights) build the same way: chain depth counts each
worker's own tasks, and the Lemma-1 monotonicity test applies verbatim.  For a
collision-free shift placement every dependency edge connects strictly
increasing execution slots, hence is depth-monotone, and the critical path
equals the chain bound ``max_chain·(c+r)`` — the optimality certificate the
mask tests assert (``critical_path == simulate().makespan ==
ragged_lower_bound``).

Port of ``repro.core.dag``: node numbering, edges and depths equal the
reference's for every schedule (``tests/test_torch_simulator.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core.schedules import Schedule, Task


@dataclasses.dataclass
class Dag:
    """Weighted DAG with explicit node depths (edge count from source in chain-graph)."""

    n_nodes: int
    edges: List[Tuple[int, int, float]]          # (u, v, weight)
    depth: List[int]                             # chain-graph depth per node
    # bookkeeping
    source: int = 0
    sink: int = 1
    dep_edges: List[Tuple[int, int]] = dataclasses.field(default_factory=list)

    def critical_path(self, include_dep_edges: bool = True) -> float:
        """Longest path source→sink via topological relaxation (Kahn)."""
        edges = list(self.edges)
        if include_dep_edges:
            edges += [(u, v, 0.0) for (u, v) in self.dep_edges]
        adj: Dict[int, List[Tuple[int, float]]] = {}
        indeg = [0] * self.n_nodes
        for u, v, w in edges:
            adj.setdefault(u, []).append((v, w))
            indeg[v] += 1
        dist = [float("-inf")] * self.n_nodes
        dist[self.source] = 0.0
        stack = [i for i in range(self.n_nodes) if indeg[i] == 0]
        seen = 0
        while stack:
            u = stack.pop()
            seen += 1
            for v, w in adj.get(u, ()):  # relax
                if dist[u] != float("-inf") and dist[u] + w > dist[v]:
                    dist[v] = dist[u] + w
                indeg[v] -= 1
                if indeg[v] == 0:
                    stack.append(v)
        if seen != self.n_nodes:
            raise ValueError("graph has a cycle")
        return dist[self.sink]

    def lemma1_monotone(self) -> bool:
        """True iff every zero-weight dependency edge is depth-monotone (Lemma 1)."""
        return all(self.depth[u] <= self.depth[v] for (u, v) in self.dep_edges)

    def lemma1_holds(self) -> bool:
        """Empirically verify Lemma 1's iff on this instance: CP unchanged ⇔ monotone."""
        unchanged = abs(self.critical_path(True) - self.critical_path(False)) < 1e-9
        return unchanged == self.lemma1_monotone()


def build_dag(schedule: Schedule, c: float = 1.0, r: float = 0.5) -> Dag:
    """Build the paper's DAG for a schedule.

    Per worker chain: ``s → [compute→reduce]* → t`` with weights ``c`` and ``r``.
    Dependency edges (zero weight) connect the reduction-*end* node of the
    predecessor in each (head, q) reduction order to the reduction-*start* node of
    the successor — exactly the paper's Fig. 2 construction.
    """
    node_id = 2  # 0 = source, 1 = sink
    start_of: Dict[Task, int] = {}   # node at which the task's compute begins
    red_start: Dict[Task, int] = {}  # node at which the reduction begins
    red_end: Dict[Task, int] = {}
    edges: List[Tuple[int, int, float]] = []
    depth: List[int] = [0, 0]  # sink depth patched below

    def new_node(d: int) -> int:
        nonlocal node_id
        depth.append(d)
        nid = node_id
        node_id += 1
        return nid

    max_depth = 0
    for chain in schedule.chains:
        prev = 0  # source
        d = 0
        for task in chain:
            n_cs = prev
            n_ce = new_node(d + 1)  # compute end == reduction start
            n_re = new_node(d + 2)
            edges.append((n_cs, n_ce, c))
            edges.append((n_ce, n_re, r))
            start_of[task] = n_cs
            red_start[task] = n_ce
            red_end[task] = n_re
            prev = n_re
            d += 2
        max_depth = max(max_depth, d)
        edges.append((prev, 1, 0.0))  # chain → sink (zero weight, standard)
    depth[1] = max_depth

    dep_edges: List[Tuple[int, int]] = []
    for (h, q), order in schedule.reduction_order.items():
        prev_task = None
        for (kv, _w) in order:
            task = (h, kv, q)
            if prev_task is not None:
                dep_edges.append((red_end[prev_task], red_start[task]))
            prev_task = task
    return Dag(n_nodes=node_id, edges=edges, depth=depth, dep_edges=dep_edges)
