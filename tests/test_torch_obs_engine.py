"""Observability through the continuous engine and both launchers.

Against the reference (``repro.serve.engine`` with ``repro.obs``): on the
same bridged weights and requests, the port's ``MemoryTracker`` stream
equals the reference engine's, event by event and span ids included, once
the wall-clock fields are taken out — on the plain path, the ``spec_k=4``
self-draft, a separate drafter, a fault plan (``fault_injected``,
``serve_preempt``, ``serve_restore``, stalls) with shedding and a deadline,
and a crash restored from a snapshot. An armed engine is bitwise the
unarmed one on each path. The launchers' ``--track``,
``--track-reference`` and ``--trace-out`` on the CPU: equal runs keep
``fingerprint_ok``, another seed fires ``fingerprint_divergence`` at step
1, the traces validate, and the report CLI exits 1 on a diff."""
import json

import jax
import numpy as np
import pytest

from repro.configs import registry as jregistry
from repro.faults import FaultPlan as JPlan
from repro.faults import Injector as JInjector
from repro.faults.plan import Fault as JFault
from repro.models import transformer as JT
from repro.obs import MemoryTracker as JMemory
from repro.serve import engine as JE
from repro_torch.configs import registry as tregistry
from repro_torch.faults import EngineCrash, Fault, FaultPlan, Injector
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models.convert import from_jax_params
from repro_torch.obs import MemoryTracker, NoopTracker, read_jsonl
from repro_torch.obs import export as EX
from repro_torch.obs import report as REP
from repro_torch.serve import engine as TE

WALL = ("t", "at_s", "begin_s", "dur_s", "ttft_s")
GEN = 6
PROMPT_LENS = [5, 13, 32, 7, 21, 9]
ENGINE_KW = dict(n_slots=3, max_seq=64, page_size=8, prefill_chunk=16)
CHAOS = ((2, "revoke_slot", 1, 1), (4, "pool_exhaust", 4, 2),
         (6, "decode_stall", 2, 1), (9, "revoke_slot", 2, 1))


@pytest.fixture(scope="module")
def models():
    """Reduced StableLM (fp32, 2 layers), the target's weights from
    PRNGKey(0) and a drafter's from PRNGKey(1), in both packages."""
    kw = dict(dtype_name="float32", n_layers=2)
    jcfg = jregistry.get("stablelm-1.6b").reduced(**kw)
    tcfg = tregistry.get("stablelm-1.6b").reduced(**kw)
    out = dict(jcfg=jcfg, tcfg=tcfg)
    for name, seed in (("", 0), ("draft_", 1)):
        jp = JT.init(jcfg, jax.random.PRNGKey(seed))
        out[f"j{name}params"] = jp
        out[f"t{name}params"] = from_jax_params(jax.tree.map(np.asarray, jp),
                                                tcfg, device="cpu")
    rng = np.random.RandomState(0)
    out["prompts"] = [rng.randint(1, 512, size=n).tolist()
                      for n in PROMPT_LENS]
    return out


def _chaos_plan(mod_plan, mod_fault):
    return mod_plan(name="obs-chaos",
                    faults=tuple(mod_fault(*f) for f in CHAOS))


PATHS = {
    "plain": {},
    "spec_self": dict(spec_k=4),
    "spec_drafter": dict(spec_k=4, draft=True),
    "chaos": dict(chaos=True),
    "shed_deadline": dict(max_queue_depth=4, deadline={1: 3}),
}


def _serve(m, port, path, tracker):
    """One engine of either package over the fixture's requests; returns
    the engine and its results."""
    kw = dict(PATHS[path])
    cfg = m["tcfg"] if port else m["jcfg"]
    params = m["tparams"] if port else m["jparams"]
    mod = TE if port else JE
    if kw.pop("draft", False):
        kw["draft_params"] = m["tdraft_params" if port else "jdraft_params"]
    if kw.pop("chaos", False):
        plan = (_chaos_plan(FaultPlan, Fault) if port
                else _chaos_plan(JPlan, JFault))
        kw["faults"] = (Injector if port else JInjector)(plan,
                                                         tracker=tracker)
    deadline = kw.pop("deadline", {})
    eng = mod.ContinuousEngine(cfg, params, tracker=tracker, run_id="obs",
                               **ENGINE_KW, **kw)
    for i, p in enumerate(m["prompts"]):
        try:
            eng.submit(p, req_id=i, max_new_tokens=GEN,
                       deadline_steps=deadline.get(i))
        except mod.QueueFull:
            pass
    eng.run()
    return eng


def _strip(events):
    return [{k: v for k, v in e.items() if k not in WALL} for e in events]


def _streams(eng):
    return ({i: list(map(int, t)) for i, t in eng.results.items()},
            {i: np.asarray(lp).tobytes()
             for i, lp in eng.result_logprobs.items()},
            {i: list(map(int, t)) for i, t in eng.cancelled.items()},
            dict(eng.rejected))


@pytest.fixture(scope="module", params=sorted(PATHS))
def served(request, models):
    path = request.param
    jmem, tmem = JMemory(), MemoryTracker()
    jeng = _serve(models, False, path, jmem)
    teng = _serve(models, True, path, tmem)
    return path, jeng, jmem, teng, tmem


def test_event_stream_equals_the_reference(served):
    path, jeng, jmem, teng, tmem = served
    ref, port = _strip(jmem.events), _strip(tmem.events)
    assert len(port) == len(ref)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert b == a, f"{path}: event {i}"
    kinds = {e["event"] for e in port}
    want = {"serve_submit", "serve_prefill", "serve_done", "span"}
    want |= {"plain": {"serve_decode"}, "spec_self": {"serve_spec_round"},
             "spec_drafter": {"serve_spec_round"},
             "chaos": {"fault_injected", "serve_preempt", "serve_restore"},
             "shed_deadline": {"serve_shed", "serve_cancel"}}[path]
    assert want <= kinds, f"{path}: {sorted(kinds)}"
    phases = {e["phase"] for e in port if e["event"] == "span"}
    assert {"request", "queue", "prefill", "prefill_chunk"} <= phases
    if path == "spec_drafter":
        assert {"spec_round", "spec_draft", "spec_verify"} <= phases


def test_streams_equal_the_reference(served):
    path, jeng, _, teng, _ = served
    assert {i: list(t) for i, t in jeng.results.items()} == _streams(teng)[0]
    assert sorted(jeng.cancelled) == sorted(teng.cancelled)
    assert jeng.rejected == teng.rejected
    assert (jeng.engine_steps, jeng.decode_steps, jeng.preemptions) == (
        teng.engine_steps, teng.decode_steps, teng.preemptions)


def test_armed_engine_is_bitwise_the_unarmed_one(served, models):
    path, _, _, teng, tmem = served
    unarmed = _serve(models, True, path, None)
    assert isinstance(unarmed.tracker, NoopTracker)
    assert not unarmed.prof.armed and unarmed._req_spans == {}
    assert _streams(unarmed) == _streams(teng)
    assert len(tmem.events) > 0


def test_span_counts_follow_the_engine_telemetry(served):
    """As chip_smoke.py predicts them: a request, a prefill and a queue
    span a request (a preempted one: a queue and a restore prefill more),
    a chunk span a chunk, a decode span a decode step and a round span a
    speculative round."""
    path, _, _, teng, tmem = served
    spans = {}
    for e in tmem.of("span"):
        spans[e["phase"]] = spans.get(e["phase"], 0) + 1
    admitted = len(PROMPT_LENS) - len(teng.rejected)
    restores = len(tmem.of("serve_restore"))
    assert spans["request"] == admitted
    assert spans["prefill"] == len(tmem.of("serve_prefill")) + restores
    assert spans["queue"] == admitted + teng.preemptions
    chunks = sum(-(-n // ENGINE_KW["prefill_chunk"])
                 for i, n in enumerate(PROMPT_LENS) if i not in teng.rejected)
    chunks += sum(-(-p // ENGINE_KW["prefill_chunk"])
                  for p in teng.restore_positions)
    assert spans["prefill_chunk"] == chunks
    key = "spec_round" if teng.spec is not None else "decode"
    assert spans.get(key, 0) == (teng.spec.rounds if teng.spec is not None
                                 else teng.decode_steps)
    assert len(tmem.of("serve_done")) == len(teng.results)


def test_snapshot_restore_events_equal_the_reference(models, tmp_path):
    """A crash at engine step 5 with a snapshot every 2 steps, restored
    with a fresh tracker: ``serve_snapshot``/``serve_snapshot_restore``
    and the restored engine's events equal the reference's (directories
    aside), and the restored streams equal an uncrashed run's."""
    streams = {}
    for port in (False, True):
        mem = MemoryTracker() if port else JMemory()
        mod, plan_mod, fault_mod, inj_mod = (
            (TE, FaultPlan, Fault, Injector) if port
            else (JE, JPlan, JFault, JInjector))
        cfg = models["tcfg" if port else "jcfg"]
        params = models["tparams" if port else "jparams"]
        inj = inj_mod(plan_mod(name="crash", faults=(fault_mod(5, "crash"),)))
        d = str(tmp_path / ("port" if port else "ref"))
        eng = mod.ContinuousEngine(cfg, params, tracker=mem, run_id="obs",
                                   faults=inj, snapshot_dir=d,
                                   snapshot_every=2, **ENGINE_KW)
        for i, p in enumerate(models["prompts"]):
            eng.submit(p, req_id=i, max_new_tokens=GEN)
        crash = EngineCrash if port else __import__(
            "repro.faults", fromlist=["EngineCrash"]).EngineCrash
        with pytest.raises(crash):
            eng.run()
        snaps = [e for e in mem.events if e["event"] == "serve_snapshot"]
        assert [e["directory"] for e in snaps] == [d, d]
        mem2 = MemoryTracker() if port else JMemory()
        eng2 = mod.ContinuousEngine.from_snapshot(d, cfg, params, faults=inj,
                                                  tracker=mem2)
        eng2.run()
        streams[port] = (_strip([{k: v for k, v in e.items()
                                  if k != "directory"} for e in mem.events]),
                         _strip([{k: v for k, v in e.items()
                                  if k != "directory"} for e in mem2.events]),
                         {i: list(map(int, t))
                          for i, t in eng2.results.items()})
        assert mem2.events[0]["event"] == "serve_snapshot_restore"
    assert streams[True] == streams[False]
    plain = _serve(models, True, "plain", None)
    assert streams[True][2] == {i: list(map(int, t))
                                for i, t in plain.results.items()}


def test_injector_tracker_gets_every_landed_fault():
    mem = MemoryTracker()
    inj = Injector(FaultPlan(), tracker=mem)
    inj.record(Fault(3, "revoke_slot"), engine_step=3, victims=[2])
    inj.record(Fault(7, "ckpt_io", arg=2), attempt=0)
    assert [e["event"] for e in mem.events] == ["fault_injected"] * 2
    assert [{k: v for k, v in e.items() if k != "event"}
            for e in mem.events] == inj.history
    assert [e["step"] for e in mem.events] == [3, 7]


# ---------------------------------------------------------------- launchers
TRAIN = ["--reduced", "--device", "cpu", "--steps", "3", "--batch", "2",
         "--seq", "128", "--verify", "--tune", "sim", "--log-every", "1"]


@pytest.fixture(scope="module")
def train_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("train")
    a, b, c = (str(d / f"{x}.jsonl") for x in "abc")
    trace = str(d / "a.json")
    runs = dict(
        a=ttrain.main(TRAIN + ["--track", a, "--trace-out", trace]),
        b=ttrain.main(TRAIN + ["--track", b, "--track-reference", a]),
        c=ttrain.main(TRAIN + ["--seed", "1", "--track", c,
                               "--track-reference", a]))
    return runs, dict(a=a, b=b, c=c, trace=trace)


def test_train_launcher_tracks_equal_runs(train_runs):
    runs, paths = train_runs
    assert runs["a"]["fingerprint_ok"] and runs["b"]["fingerprint_ok"]
    fa = read_jsonl(paths["a"], event="fingerprint")
    fb = read_jsonl(paths["b"], event="fingerprint")
    assert [e["step"] for e in fa] == [1, 2, 3]
    assert [e["fingerprint"] for e in fa] == [e["fingerprint"] for e in fb]
    assert not read_jsonl(paths["b"], event="fingerprint_divergence")
    events = read_jsonl(paths["a"])
    kinds = [e["event"] for e in events]
    for k in ("run_config", "tune_choice", "tune_cache", "leaf_digests",
              "cache_info", "run_summary"):
        assert k in kinds, k
    steps = [e for e in events if e["event"] == "step"]
    assert len(steps) == 3 and all(
        e["utilization_vs_modeled"] > 0 and e["modeled_step_s"] > 0
        for e in steps)
    spans = [e["phase"] for e in events if e["event"] == "span"]
    assert {p: spans.count(p) for p in set(spans)} == {
        "train_data": 3, "train_step": 3, "train_digest": 3}
    assert events[-1]["event"] == "run_summary"
    assert events[-1]["fingerprint_ok"] is True
    diff = REP.diff_runs(REP.RunReport.from_jsonl(paths["a"]),
                         REP.RunReport.from_jsonl(paths["b"]))
    assert diff.clean and diff.via == "digest_chain"


def test_train_launcher_trace_validates(train_runs):
    _, paths = train_runs
    obj = json.load(open(paths["trace"]))
    assert EX.validate_trace(obj, (EX.PROCESS_MODELED,
                                   EX.PROCESS_ACHIEVED)) == []
    assert EX.main(["--validate", paths["trace"],
                    "--require-schedule-lanes"]) == 0


def test_train_launcher_fires_on_another_seed(train_runs, capsys):
    runs, paths = train_runs
    assert runs["c"]["fingerprint_ok"] is False
    div = read_jsonl(paths["c"], event="fingerprint_divergence")
    assert [e["step"] for e in div] == [1]
    assert REP.main([paths["a"], "--diff", paths["c"]]) == 1
    assert "DIVERGED at step 1" in capsys.readouterr().out
    assert REP.main([paths["a"], "--diff", paths["b"]]) == 0


@pytest.mark.parametrize("flags,item", [(["--heartbeat"], "A10"),
                                        (["--mesh", "2x2"], "A9")])
def test_train_launcher_unported_flags_raise(flags, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        ttrain.main(TRAIN + flags)


def test_track_reference_needs_verify():
    with pytest.raises(SystemExit):
        ttrain.configure(["--reduced", "--device", "cpu",
                          "--track-reference", "x.jsonl"])


SERVE = ["--engine", "continuous", "--reduced", "--device", "cpu",
         "--requests", "4", "--slots", "2", "--prompt-len", "24", "--gen",
         "4"]


@pytest.mark.parametrize("extra", [[], ["--spec-k", "2"]])
def test_serve_launcher_track_and_trace(tmp_path, extra):
    track, trace = str(tmp_path / "s.jsonl"), str(tmp_path / "s.json")
    armed = tserve.main(SERVE + extra + ["--track", track,
                                         "--trace-out", trace])
    plain = tserve.main(SERVE + extra)
    assert _streams(armed) == _streams(plain)
    obj = json.load(open(trace))
    assert EX.validate_trace(obj, (EX.PROCESS_MODELED,
                                   EX.PROCESS_ACHIEVED)) == []
    events = read_jsonl(track)
    assert len([e for e in events if e["event"] == "serve_done"]) == 4
    rep = REP.RunReport.from_jsonl(track)
    assert rep.latency["ttft_s"]["n"] == 4.0
    assert rep.latency["per_token_s"]["n"] > 0


def test_serve_track_applies_to_the_continuous_engine():
    with pytest.raises(SystemExit):
        tserve.main(["--reduced", "--device", "cpu", "--track", "x.jsonl"])
