"""The port's observability layer (``repro_torch.obs``) and the live state
fingerprint against the reference's (``repro.obs``, ``repro.verify.digest``).

Byte-equal JSONL streams for the same ``log`` calls, torn-line tolerance,
equal quantiles, histograms, step meters, span ids and fake-clock span
streams, a disarmed tracer that never reads the clock, the divergence alarm
on a file the reference wrote, equal run reports and diffs, equal
schedule traces for every schedule family and equal trace verdicts; the
fingerprint's plain version equal to the reference's uint32 on every
covered dtype, on a tree whose keys order differently level by level than
as whole paths, and on a bridged train state; ``digest_metrics``."""
import json
import warnings

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import obs as J
from repro.configs import registry as jregistry
from repro.core import schedules as JSCH
from repro.obs import export as JEX
from repro.models import transformer as JT
from repro.train import step as JS
from repro.verify import digest as JD
from repro_torch import obs as P
from repro_torch.configs import registry as tregistry
from repro_torch.core import schedules as TSCH
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.kernels import fingerprint as FP
from repro_torch.models.module import set_path, tree_paths
from repro_torch.obs import export as PEX
from repro_torch.obs import metrics as PM
from repro_torch.train import optimizer as TO
from repro_torch.train import step as TS
from repro_torch.verify import digest as TD

EVENTS = [
    ("run_config", {"arch": "x", "steps": 3, "nested": {"b": 1, "a": [1, 2]}},
     None),
    ("step", {"loss": 1.25, "tokens_per_s": 3.5e4}, 1),
    ("fingerprint", {"fingerprint": 4294967295}, 1),
    ("serve_done", {"request_id": 7, "slot": 0, "n_tokens": 8}, None),
    ("span", {"phase": "decode", "scope": "step:3", "span_id": "ab" * 8,
              "parent_id": None, "begin_s": 0.5, "dur_s": 0.25,
              "committed": 2}, 3),
]


def _log_all(tracker):
    for event, data, step in EVENTS:
        tracker.log(event, data, step=step)
    tracker.close()


# ------------------------------------------------------------------ tracker
def test_jsonl_bytes_equal_the_reference(tmp_path):
    _log_all(J.JsonlTracker(str(tmp_path / "ref.jsonl"), timestamps=False))
    _log_all(P.JsonlTracker(str(tmp_path / "port.jsonl"), timestamps=False))
    ref = (tmp_path / "ref.jsonl").read_bytes()
    assert ref == (tmp_path / "port.jsonl").read_bytes()
    assert len(ref.splitlines()) == len(EVENTS)


def test_jsonl_flushes_every_event(tmp_path):
    path = tmp_path / "t.jsonl"
    tracker = P.JsonlTracker(str(path), timestamps=True)
    assert tracker.flush_every == 1
    tracker.log("a", {"x": 1})
    rec = json.loads(path.read_text())       # on disk before close
    assert rec["seq"] == 0 and rec["x"] == 1 and "t" in rec
    tracker.log("b")
    tracker.close()
    assert [r["seq"] for r in P.read_jsonl(str(path))] == [0, 1]


def test_read_jsonl_torn_final_line_and_corrupt_interior(tmp_path):
    good = tmp_path / "g.jsonl"
    _log_all(P.JsonlTracker(str(good), timestamps=False))
    torn = tmp_path / "torn.jsonl"
    torn.write_bytes(good.read_bytes() + b'{"seq": 5, "eve')
    with pytest.warns(RuntimeWarning, match="torn final line"):
        recs = P.read_jsonl(str(torn))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert recs == J.read_jsonl(str(torn))
    assert len(recs) == len(EVENTS)
    assert P.read_jsonl(str(torn), event="step") == [recs[1]]
    with pytest.raises(json.JSONDecodeError):
        P.read_jsonl(str(torn), strict=True)
    lines = good.read_bytes().splitlines(keepends=True)
    corrupt = tmp_path / "corrupt.jsonl"
    corrupt.write_bytes(lines[0] + b"{not json\n" + b"".join(lines[1:]))
    with pytest.raises(json.JSONDecodeError):
        P.read_jsonl(str(corrupt))


def test_memory_composite_and_noop_trackers():
    mem_p, mem_j = P.MemoryTracker(), J.MemoryTracker()
    comp = P.CompositeTracker([P.NoopTracker(), mem_p])
    for event, data, step in EVENTS:
        comp.log(event, data, step=step)
        mem_j.log(event, data, step=step)
    comp.close()
    assert mem_p.events == mem_j.events
    assert mem_p.of("step") == mem_j.of("step")
    assert isinstance(P.open_tracker(None), P.NoopTracker)


# ------------------------------------------------------------------ metrics
@settings(max_examples=40)
@given(st.integers(min_value=1, max_value=60),
       st.floats(min_value=0.0, max_value=1.0),
       st.integers(min_value=0, max_value=10_000))
def test_quantile_lower_matches_reference(n, q, seed):
    rng = np.random.RandomState(seed)
    values = rng.randint(0, 5, size=n).astype(float).tolist()  # many ties
    assert P.quantile_lower(values, q) == J.quantile_lower(values, q)
    assert P.quantile_lower(values, q) == float(
        np.quantile(values, q, method="lower"))


@pytest.mark.parametrize("bad", [([], 0.5), ([1.0], -0.1), ([1.0], 1.5)])
def test_quantile_lower_rejects(bad):
    with pytest.raises(ValueError):
        P.quantile_lower(*bad)


def test_histogram_counter_timer_match_reference():
    rng = np.random.RandomState(0)
    values = rng.exponential(0.01, size=200).tolist()
    hp = P.Histogram("lat", [0.001, 0.01, 0.1])
    hj = J.Histogram("lat", [0.001, 0.01, 0.1])
    for v in values:
        hp.observe(v)
        hj.observe(v)
    assert hp.snapshot() == hj.snapshot()
    for q in (0.0, 0.37, 0.5, 0.9, 0.99, 1.0):
        assert hp.percentile(q) == hj.percentile(q)
    ms = PM.MetricSet()
    c, t = ms.counter("n"), ms.timer("t")
    c.inc(3)
    t.add(0.5)
    t.add(1.5)
    mem = P.MemoryTracker()
    snap = ms.emit(mem, step=2)
    assert snap == {"n": 3.0, "t_total_s": 2.0, "t_mean_s": 1.0,
                    "t_count": 2.0}
    assert mem.events == [dict(snap, event="metrics", step=2)]


@pytest.mark.parametrize("modeled", [None, 0.02])
def test_step_meter_matches_reference(modeled):
    mp, mj = P.StepMeter(modeled_step_s=modeled), J.StepMeter(
        modeled_step_s=modeled)
    for tokens, dt in ((4096, 0.5), (4096, 0.25), (2048, 0.0), (4096, 0.4)):
        assert mp.update(tokens, dt) == mj.update(tokens, dt)
    assert P.utilization_vs_modeled(0.1, 0.4) == J.utilization_vs_modeled(
        0.1, 0.4) == 0.25
    assert P.utilization_vs_modeled(0.1, 0.0) == 0.0


# -------------------------------------------------------------------- spans
@pytest.mark.parametrize("args", [("serve", "req:3", "prefill"),
                                  ("train-x-s0", "step:17", "train_step"),
                                  ("", "", ""),
                                  ("r", "req:1/pos:32", "prefill_chunk")])
def test_span_id_matches_reference(args):
    assert P.span_id(*args) == J.span_id(*args)
    assert len(P.span_id(*args)) == 16


def _fake_clock():
    ticks = iter(range(1000))
    return lambda: 0.125 * next(ticks)


def _span_stream(mod):
    mem = mod.MemoryTracker()
    tracer = mod.SpanTracer(mem, run_id="run7", clock=_fake_clock())
    with tracer.span("request", "req:0", lane="req0", prompt_len=5) as root:
        s = tracer.begin("prefill", "req:0", parent=root, lane="slot0",
                         step=2)
        tracer.mark("serve_preempt", {"request_id": 0}, step=2)
        tracer.end(s, chunks=1, ttft_s=0.5)
    tracer.end(None)
    return mem.events


def test_fake_clock_span_stream_matches_reference():
    port = _span_stream(P)
    assert port == _span_stream(J)
    assert [e["event"] for e in port] == ["serve_preempt", "span", "span"]


def test_disarmed_tracer_never_reads_the_clock():
    def clock():
        raise AssertionError("a disarmed tracer read the clock")

    for tracer in (P.SpanTracer(None, clock=clock),
                   P.Profiler(P.NoopTracker(), run_id="r", clock=clock),
                   P.open_profiler(None, "r")):
        assert not tracer.armed and tracer.now() == 0.0
        assert tracer.begin("decode", "step:0") is None
        with tracer.span("decode", "step:1") as s:
            assert s is None
        tracer.mark("serve_shed")


def test_profiler_phases_match_reference():
    from repro.obs import prof as JP
    from repro_torch.obs import prof as PP
    assert PP.SERVE_PHASES == JP.SERVE_PHASES
    assert PP.TRAIN_PHASES == JP.TRAIN_PHASES
    assert P.__all__ == J.__all__


# -------------------------------------------------------------------- alarm
def test_divergence_alarm_reads_a_reference_file(tmp_path):
    path = str(tmp_path / "ref.jsonl")
    ref = J.JsonlTracker(path)
    alarm = J.DivergenceAlarm(tracker=ref)
    for step, fp in ((1, 11), (2, 22), (3, 33), (4, 44)):
        alarm.observe(step, np.uint32(fp))
    ref.close()
    mem = P.MemoryTracker()
    port = P.DivergenceAlarm.from_jsonl(path, tracker=mem)
    assert port.reference == {1: 11, 2: 22, 3: 33, 4: 44}
    assert not port.observe(1, 11)
    assert port.observe(2, 99)
    assert not port.observe(3, 98)       # latched: fires once
    assert not port.observe(4, 44)
    assert not port.ok and port.diverged_at == 2
    assert [e["event"] for e in mem.events] == [
        "fingerprint", "fingerprint", "fingerprint_divergence",
        "fingerprint", "fingerprint"]
    assert mem.of("fingerprint_divergence") == [{
        "event": "fingerprint_divergence", "fingerprint": 99,
        "reference_fingerprint": 22, "step": 2}]
    free = P.DivergenceAlarm()
    assert not free.observe(1, 5) and free.ok and free.seen == {1: 5}


# ------------------------------------------------------------------- report
def _run_events(fp3=33, leaf="aa"):
    ev = [{"event": "run_config", "run_id": "train-x"}]
    for step in (1, 2, 3):
        ev.append({"event": "span", "phase": "train_step", "dur_s": 0.1 * step,
                   "scope": f"step:{step}", "step": step})
        ev.append({"event": "fingerprint", "step": step,
                   "fingerprint": fp3 if step == 3 else 10 * step})
        ev.append({"event": "leaf_digests", "step": step,
                   "tree_digest": f"d{step}{leaf if step == 3 else ''}",
                   "leaves": {"params/w": leaf if step == 3 else "00",
                              "step": f"s{step}"}})
    ev += [{"event": "span", "phase": "prefill", "dur_s": 0.2, "ttft_s": 0.3},
           {"event": "span", "phase": "queue", "dur_s": 0.01,
            "queued_steps": 2},
           {"event": "span", "phase": "decode", "dur_s": 0.04,
            "committed": 4},
           {"event": "span", "phase": "spec_round", "dur_s": 0.08, "step": 9},
           {"event": "serve_spec_round", "step": 9, "committed": 8,
            "accepted": 5, "evaluated": 6},
           {"event": "serve_done", "n_tokens": 12},
           {"event": "run_summary", "final_loss": 1.5, "final_step": 3,
            "tokens_per_s_avg": 100.0}]
    return ev


def test_run_report_and_diff_match_reference(tmp_path):
    a, b, c = _run_events(), _run_events(), _run_events(fp3=34, leaf="bb")
    rp, rj = P.RunReport.from_events(a), J.RunReport.from_events(a)
    assert rp.to_dict() == rj.to_dict()
    assert rp.to_json() == rj.to_json()
    assert rp.latency["ttft_s"]["p50"] == 0.3
    assert rp.spec["accept_rate"] == 5 / 6
    for x, y in ((a, b), (a, c), (a[:1], c[:1])):
        dp = P.diff_runs(P.RunReport.from_events(x), P.RunReport.from_events(y))
        dj = J.diff_runs(J.RunReport.from_events(x), J.RunReport.from_events(y))
        assert (dp.clean, dp.first_step, dp.leaf_paths, dp.via, dp.detail,
                str(dp)) == (dj.clean, dj.first_step, dj.leaf_paths, dj.via,
                             dj.detail, str(dj))
    no_digests = [e for e in c if e["event"] != "leaf_digests"]
    dp = P.diff_runs(P.RunReport.from_events(a), P.RunReport.from_events(
        no_digests))
    assert (dp.clean, dp.via, dp.first_step) == (False, "fingerprint", 3)


def test_report_cli_exits_one_on_divergence(tmp_path, capsys):
    from repro_torch.obs import report as PR
    paths = []
    for name, events in (("a", _run_events()), ("b", _run_events()),
                         ("c", _run_events(fp3=34, leaf="bb"))):
        tr = P.JsonlTracker(str(tmp_path / f"{name}.jsonl"), timestamps=False)
        for e in events:
            tr.log(e["event"], {k: v for k, v in e.items() if k != "event"})
        tr.close()
        paths.append(str(tmp_path / f"{name}.jsonl"))
    out = str(tmp_path / "rep.json")
    assert PR.main([paths[0], "--out", out, "--diff", paths[1]]) == 0
    assert "clean (digest_chain)" in capsys.readouterr().out
    assert json.loads(open(out).read())["source"] == paths[0]
    assert PR.main([paths[0], "--diff", paths[2]]) == 1
    assert "DIVERGED at step 3" in capsys.readouterr().out


# ------------------------------------------------------------------- export
# every schedule family, full and causal where it is defined (shift is the
# full-mask family, symmetric_shift the causal one)
FAMILIES = [("fa3", False), ("descending", False), ("shift", False),
            ("fa3", True), ("descending", True), ("symmetric_shift", True)]


def _schedules(name, causal, n=4):
    kw = dict(n_heads=2, causal=causal)
    return (JSCH.make_schedule(name, n, **kw),
            TSCH.make_schedule(name, n, **kw))


@pytest.mark.parametrize("name,causal", FAMILIES)
@pytest.mark.parametrize("achieved", [None, 3.5e-4])
def test_schedule_to_trace_matches_reference(name, causal, achieved):
    js, ts = _schedules(name, causal)
    c, r = 1.25e-6, 4.0e-7
    jev = JEX.schedule_to_trace(js, c, r, achieved_s=achieved)
    tev = PEX.schedule_to_trace(ts, c, r, achieved_s=achieved)
    assert tev == jev
    require = (PEX.PROCESS_MODELED, PEX.PROCESS_ACHIEVED)
    assert PEX.validate_trace(PEX.make_trace(tev), require) == \
        JEX.validate_trace(JEX.make_trace(jev), require)


def test_attention_timeline_modeled_lanes_match_reference():
    """Equal inputs (block 64, c and r from the reference's model) give the
    reference's modeled lanes; the port's own default costs the tasks with
    the H100 constants at its kernels' 128-token tile."""
    from repro.tune.model import task_costs as jcosts
    c, r = jcosts(64, 64, 32)
    js = JSCH.cached_schedule("symmetric_shift", 4, causal=True, n_q=4,
                              block_q=64, block_k=64)
    ts = TSCH.cached_schedule("symmetric_shift", 4, causal=True, n_q=4,
                              block_q=64, block_k=64)
    assert PEX.schedule_to_trace(ts, c, r) == JEX.attention_timeline(
        256, 32, causal=True)
    ev = PEX.attention_timeline(512, 32, causal=False)
    assert PEX.validate_trace(PEX.make_trace(ev),
                              (PEX.PROCESS_MODELED,)) == []
    assert {e["args"]["worker"] for e in ev if e["ph"] == "X"} == {0, 1, 2, 3}


def test_attention_timeline_measures_the_plain_backward_on_the_cpu():
    ev = PEX.attention_timeline(256, 32, causal=True, measure=True,
                                device="cpu", reps=1)
    require = (PEX.PROCESS_MODELED, PEX.PROCESS_ACHIEVED)
    assert PEX.validate_trace(PEX.make_trace(ev), require) == []
    args = [e["args"] for e in ev if e["ph"] == "X"]
    assert all(a["achieved_s"] > 0 and a["stall_factor"] > 0 for a in args)


@pytest.mark.parametrize("obj", [
    [], {"traceEvents": []}, {"traceEvents": [{"ph": "Q"}]},
    {"traceEvents": [{"ph": "X", "name": "a", "pid": 1, "tid": 0, "ts": -1,
                      "dur": 1}]},
    {"traceEvents": [{"ph": "M", "name": "process_name", "args": {}}]},
    {"traceEvents": [{"ph": "i", "ts": "x"}, 3]},
    {"traceEvents": [{"ph": "M", "pid": 1, "name": "process_name",
                      "args": {"name": "run"}}]},
])
def test_validate_trace_verdicts_match_reference(obj):
    require = ("run", PEX.PROCESS_MODELED)
    assert PEX.validate_trace(obj, require) == JEX.validate_trace(obj, require)
    assert PEX.validate_trace(obj) == JEX.validate_trace(obj)


def test_spans_to_trace_and_export_cli(tmp_path):
    events = _span_stream(P)
    assert PEX.spans_to_trace(events) == JEX.spans_to_trace(events)
    path = tmp_path / "ev.jsonl"
    tr = P.JsonlTracker(str(path))
    for e in events:
        tr.log(e["event"], {k: v for k, v in e.items() if k != "event"},
               step=e.get("step"))
    tr.close()
    out = tmp_path / "trace.json"
    assert PEX.main(["--from-events", str(path), "--out", str(out)]) == 0
    assert PEX.main(["--validate", str(out)]) == 0
    assert PEX.main(["--validate", str(out), "--require-schedule-lanes"]) == 1
    with pytest.raises(ValueError, match="invalid trace"):
        PEX.write_trace(str(tmp_path / "bad.json"), [])


# -------------------------------------------------------------- fingerprint
COVERED = ["bfloat16", "float16", "float32", "int32", "int8", "uint8", "bool"]


def _np_leaf(dtype, shape, rng):
    if dtype == "bool":
        return rng.randint(0, 2, size=shape).astype(bool)
    if dtype in ("int8", "uint8", "int32"):
        info = np.iinfo(dtype)
        return rng.randint(info.min, int(info.max) + 1, size=shape,
                           dtype=np.int64).astype(dtype)
    return np.asarray(rng.randn(*shape) * 100).astype(
        ml_dtypes.bfloat16 if dtype == "bfloat16" else dtype)


def _to_torch(x):
    x = np.asarray(x)
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(np.array(x).view(np.int16)).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _tree(mapping):
    tree = {}
    for path, leaf in mapping.items():
        set_path(tree, path, leaf)
    return tree


@pytest.mark.parametrize("dtype", COVERED)
@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5, 2), (0, 4),
                                   (1000,)])
def test_leaf_fingerprint_matches_reference(dtype, shape):
    x = _np_leaf(dtype, shape, np.random.RandomState(len(shape) + 7))
    ref = int(JD.tree_fingerprint({"x": jnp.asarray(x)}))
    assert TD.tree_fingerprint({"x": _to_torch(x)}) == ref
    # a non-contiguous view fingerprints as its contiguous copy
    t = _to_torch(x)
    if t.ndim >= 2:
        assert TD.tree_fingerprint({"x": t.mT.contiguous().mT.contiguous()}) \
            == ref


def test_negative_int8_sign_extends_as_the_reference():
    x = np.array([-1, -128, 127, 0, -2], np.int8)
    ref = int(JD.tree_fingerprint({"x": jnp.asarray(x)}))
    assert TD.tree_fingerprint({"x": torch.from_numpy(x)}) == ref
    as_uint8 = TD.tree_fingerprint({"x": torch.from_numpy(x.view(np.uint8))})
    assert as_uint8 != ref


def test_tree_orders_by_whole_path_like_the_reference():
    rng = np.random.RandomState(3)
    leaves = {"a/x": _np_leaf("float32", (5,), rng),
              "a-b": _np_leaf("int8", (4,), rng),
              "a.c/d": _np_leaf("bfloat16", (3,), rng),
              "b/c/d": _np_leaf("bool", (), rng)}
    level = [p for p, _ in tree_paths(_tree(leaves))]
    assert level != sorted(level)       # the two orders differ here
    ref = int(JD.tree_fingerprint(jax.tree.map(jnp.asarray, _tree(leaves))))
    port = _tree({p: _to_torch(x) for p, x in leaves.items()})
    assert TD.tree_fingerprint(port) == ref


def test_every_covered_dtype_in_one_tree():
    rng = np.random.RandomState(5)
    leaves = {f"l/{d}/{i}": _np_leaf(d, s, rng) for d in COVERED
              for i, s in enumerate([(), (9,), (2, 33)])}
    ref = int(JD.tree_fingerprint(jax.tree.map(jnp.asarray, _tree(leaves))))
    port = TD.tree_fingerprint(_tree({p: _to_torch(x)
                                      for p, x in leaves.items()}))
    assert port == ref


def test_fingerprint_sees_one_bit_and_a_swap():
    x = torch.arange(1, 65, dtype=torch.float32)
    base = TD.tree_fingerprint({"x": x})
    flipped = x.clone()
    flipped.view(torch.int32)[17] ^= 1
    swapped = x.clone()
    swapped[[3, 40]] = swapped[[40, 3]]
    assert TD.tree_fingerprint({"x": flipped}) != base
    assert TD.tree_fingerprint({"x": swapped}) != base
    assert TD.tree_fingerprint({"y": x}) != base           # the path's salt


@pytest.mark.parametrize("dtype", [torch.int64, torch.float64,
                                   torch.int16, torch.complex64])
def test_fingerprint_refuses_uncovered_dtypes(dtype):
    with pytest.raises(TypeError, match="covers"):
        TD.tree_fingerprint({"x": torch.zeros(3, dtype=dtype)})


def test_plain_fingerprint_chunks_and_large_indices(monkeypatch):
    """The plain version in several chunks equals one chunk, and an index
    past 2**32 wraps as the uint32 weight does."""
    x = torch.arange(-500, 500, dtype=torch.int32)
    whole = FP.fingerprint_plain(x)
    monkeypatch.setattr(FP, "_PLAIN_CHUNK", 64)
    assert FP.fingerprint_plain(x) == whole
    i = (1 << 32) + 5                      # weight(i) == weight(5) mod 2**32
    w = (i * FP.GOLDEN + 1) & FP.MASK32
    assert w == (5 * FP.GOLDEN + 1) & FP.MASK32


def _bridged_states():
    jcfg = jregistry.get("stablelm-1.6b").reduced(n_layers=2,
                                                  dtype_name="bfloat16")
    jt = JS.TrainConfig()
    jstate = JS.init_state(jcfg, jt, jax.random.PRNGKey(0))
    toks = np.random.RandomState(0).randint(0, 512, (2, 65)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    jstate, _ = jax.jit(JS.make_train_step(jcfg, jt))(jstate, batch)
    host = jax.tree.map(np.asarray, jstate)
    pstate = _tree({p: _to_torch(x) for p, x in tree_paths(host)})
    return jstate, pstate


def test_bridged_train_state_fingerprint_matches_reference():
    jstate, pstate = _bridged_states()
    assert TD.tree_digest(pstate) == JD.tree_digest(jstate)
    assert TD.tree_fingerprint(pstate) == int(JD.tree_fingerprint(jstate))


def test_digest_metrics_ships_the_fingerprint():
    cfg = tregistry.get("stablelm-1.6b").reduced(n_layers=2,
                                                 attention_impl="torch")
    data = SyntheticLM(DataConfig(seed=0, batch=2, seq=64, vocab=cfg.vocab))
    runs = []
    for digest_metrics in (True, True, False):
        tcfg = TS.TrainConfig(opt=TO.OptConfig(warmup_steps=1),
                              digest_metrics=digest_metrics)
        state = TS.init_state(cfg, tcfg, seed=0, device="cpu")
        step = TS.make_train_step(cfg, tcfg)
        fps = []
        for i in range(2):
            state, metrics = step(state, data.batch(i))
            if digest_metrics:
                assert metrics["state_fingerprint"] == TD.tree_fingerprint(
                    state)
                fps.append(metrics["state_fingerprint"])
            else:
                assert "state_fingerprint" not in metrics
            assert "state_fingerprint" not in TS.step_event(metrics)
        runs.append(fps)
    assert runs[0] == runs[1] and len(set(runs[0])) == 2
    assert all(0 <= f < 2 ** 32 for f in runs[0])


def test_tuner_tracker_lives_for_its_call_only(tmp_path):
    """A launcher's tracker reaches the tuner's store for that call only:
    the process-wide store outlives the run (and its closed file), so a
    later call, tracked or not, never logs into an earlier call's tracker."""
    from repro_torch import tune as TUNE
    cache = TUNE.TuneCache(str(tmp_path))
    first, second = P.MemoryTracker(), P.MemoryTracker()
    kw = dict(seq=256, head_dim=64, causal=True, n_heads=4, cache=cache)
    TUNE.tune_attention(tracker=first, **kw)
    seen = len(first.events)
    assert [e["event"] for e in first.events] == ["tune_cache", "tune_choice"]
    TUNE.tune_attention(tracker=second, **kw)
    TUNE.tune_attention(**dict(kw, seq=512))
    assert len(first.events) == seen and cache.tracker is None
    assert [e["event"] for e in second.events] == ["tune_cache",
                                                   "tune_choice"]
    assert second.events[0]["result"] == "hit"
