"""Port parity for the paper's schedule model: the Gantt simulator, the DAG
(Lemma 1) and the ASCII Gantt charts. They are pure Python over the
schedules, so every output must be *equal* to the reference's — makespans,
busy times and each task's (compute start, reduction start, reduction end)
with ``==``, DAG nodes, edges and depths exactly, rendered strings character
for character — for every schedule family × n in 2..8 × m in {1, 2, 3} heads
× {full, causal}, and for the ragged block-sparse schedules of five mask
families under both placements."""
import pytest

from repro import masks as JM
from repro.core import dag as jdag
from repro.core import gantt as jgantt
from repro.core import schedules as jsched
from repro.core import simulator as jsim
from repro_torch import masks as TM
from repro_torch.core import dag as tdag
from repro_torch.core import gantt as tgantt
from repro_torch.core import schedules as tsched
from repro_torch.core import simulator as tsim

FAMILIES = [("fa3", False), ("descending", False), ("shift", False),
            ("fa3", True), ("descending", True), ("symmetric_shift", True)]
# (c, r, link): the model's default costs, a reduction-heavy ratio and a
# dependency latency (the paper's §4.2 signal cost)
COSTS = [(1.0, 0.5, 0.0), (0.3, 1.7, 0.0), (1.0, 0.5, 0.25)]


def _same_sim(ours, ref):
    assert ours.makespan == ref.makespan
    assert ours.busy_time == ref.busy_time
    assert ours.total_span == ref.total_span
    assert ours.utilization == ref.utilization
    assert ours.task_times == ref.task_times


def _same_dag(ours, ref):
    assert ours.n_nodes == ref.n_nodes
    assert ours.edges == ref.edges
    assert ours.depth == ref.depth
    assert ours.dep_edges == ref.dep_edges
    assert (ours.source, ours.sink) == (ref.source, ref.sink)
    for with_deps in (True, False):
        assert ours.critical_path(with_deps) == ref.critical_path(with_deps)
    assert ours.lemma1_monotone() == ref.lemma1_monotone()
    assert ours.lemma1_holds() == ref.lemma1_holds()


def _same_model(ours, ref, render=True):
    """Simulator, DAG, lower bound and (optionally) the Gantt chart of one
    schedule pair, at every cost point."""
    for c, r, link in COSTS:
        _same_sim(tsim.simulate(ours, c, r, link),
                  jsim.simulate(ref, c, r, link))
        _same_dag(tdag.build_dag(ours, c, r), jdag.build_dag(ref, c, r))
        assert (tsim.ragged_lower_bound(ours, c, r)
                == jsim.ragged_lower_bound(ref, c, r))
    if render:
        for width in (40, 100):
            assert (tgantt.render(ours, c=0.3, r=1.7, width=width)
                    == jgantt.render(ref, c=0.3, r=1.7, width=width))
        assert tgantt.render(ours) == jgantt.render(ref)


@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("n", range(2, 9))
@pytest.mark.parametrize("name,causal", FAMILIES)
def test_model_equals_reference(name, causal, n, m):
    ours = tsched.make_schedule(name, n, m, causal)
    ref = jsched.make_schedule(name, n, m, causal)
    _same_model(ours, ref)
    for c, r, _ in COSTS:
        assert (tsim.work_lower_bound(n, m, c, r, causal)
                == jsim.work_lower_bound(n, m, c, r, causal))
        if name != "symmetric_shift" or m % 2 == 0:
            assert (tsim.closed_form(name, n, m, c, r, causal)
                    == jsim.closed_form(name, n, m, c, r, causal))


def _masks(m, s):
    """The same five mask families built from one package's ``masks``."""
    return {
        "window": m.SlidingWindow(s // 4),
        "prefix": m.PrefixLM(s // 3),
        "document": m.Document.from_lengths((s // 4, s - s // 4)),
        "streaming": m.streaming_mask(s // 4, s // 16),
        "sink": m.Causal() & m.Sink(s // 16),
    }


@pytest.mark.parametrize("placement", ["shift", "fa3"])
@pytest.mark.parametrize("n,block", [(4, 64), (6, 64), (8, 128)])
@pytest.mark.parametrize("family", list(_masks(JM, 256)))
def test_ragged_model_equals_reference(family, n, block, placement):
    s = n * block
    tmask, jmask = _masks(TM, s)[family], _masks(JM, s)[family]
    ours = TM.compile_block_schedule(tmask, n, n, block, block, placement)
    ref = JM.compile_block_schedule(jmask, n, n, block, block, placement)
    assert ours.chains == ref.chains
    _same_model(ours, ref)
    assert (tgantt.render_block_map(tmask, n, n, block, block)
            == jgantt.render_block_map(jmask, n, n, block, block))


@pytest.mark.parametrize("family", list(_masks(JM, 256)))
def test_compare_masked_equals_reference(family):
    tmask, jmask = _masks(TM, 512)[family], _masks(JM, 512)[family]
    assert (tgantt.compare_masked(tmask, 8, 8, 64, 64)
            == jgantt.compare_masked(jmask, 8, 8, 64, 64))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n,m", [(4, 2), (8, 2), (5, 3)])
def test_compare_and_speedups_equal_reference(n, m, causal):
    assert (tgantt.compare(n, m, causal=causal)
            == jgantt.compare(n, m, causal=causal))
    assert (tsim.speedup_table(n, m, 1.0, 0.5)
            == jsim.speedup_table(n, m, 1.0, 0.5))


def test_model_properties_hold_on_the_port():
    """What the reference's own tests check of the model, on the port:
    shift and symmetric_shift reach their closed forms; a collision-free
    shift placement is certified optimal (critical path == makespan ==
    ragged lower bound); a deadlocking order raises."""
    for n in (4, 8):
        full = tsched.make_schedule("shift", n, 2, False)
        assert (tsim.simulate(full).makespan
                == tsim.closed_form("shift", n, 2, 1.0, 0.5, False))
        sym = tsched.make_schedule("symmetric_shift", n, 2, True)
        assert (tsim.simulate(sym).makespan
                == tsim.closed_form("symmetric_shift", n, 2, 1.0, 0.5, True))
        assert tdag.build_dag(sym).lemma1_monotone()
    window = TM.compile_block_schedule(TM.SlidingWindow(128), 8, 8, 64, 64,
                                       "shift")
    cp = tdag.build_dag(window).critical_path()
    assert cp == tsim.simulate(window).makespan == tsim.ragged_lower_bound(
        window)
    bad = tsched.Schedule("bad", False, 2, 2, 2, 1,
                          (((0, 0, 0), (0, 0, 1)), ((0, 1, 1), (0, 1, 0))),
                          {(0, 0): ((1, 1), (0, 0)), (0, 1): ((0, 0), (1, 1))})
    with pytest.raises(ValueError, match="deadlock"):
        tsim.simulate(bad)
