"""Fault injection in the port (``repro_torch.faults``) and determinism under
faults.

Within the port, the reference's plan and injector units
(``tests/test_faults.py``) and its chaos suite
(``tests/test_chaos_conformance.py``) case for case: the 11-cell
conformance matrix sampled and greedy, landing records that replay,
preemption under another arrival order, deadlines that free pages, shedding
that replays. Against the reference: plan keys and canonical JSON exactly
equal, the same landing digest for the same records, and under the same
plan the two engines take the same host decisions: greedy tokens,
preemptions, engine steps and landing digests equal."""
import json

import jax
import numpy as np
import pytest

from repro.configs import registry as jregistry
from repro.faults import FaultPlan as JPlan
from repro.faults import Injector as JInjector
from repro.faults.plan import Fault as JFault
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro_torch.ckpt import checkpoint as C
from repro_torch.configs import registry
from repro_torch.faults import (EngineCrash, Fault, FaultPlan,
                                InjectedIOError, Injector, armed_checkpoint)
from repro_torch.faults import conformance as CF
from repro_torch.faults.plan import KINDS, SITES
from repro_torch.launch import train as tlaunch
from repro_torch.models.convert import from_jax_params
from repro_torch.serve.engine import ContinuousEngine, QueueFull, SampleConfig

GEN = 8
PROMPT_LENS = [5, 13, 32, 7, 21, 9, 17, 3]
ENGINE_KW = dict(n_slots=4, max_seq=64, page_size=8, prefill_chunk=16)


# ------------------------------------------------------------------- Fault
def test_fault_validation():
    for kw in (dict(step=0, kind="meteor_strike"),
               dict(step=-1, kind="revoke_slot"),
               dict(step=0, kind="pool_exhaust", arg=-1),
               dict(step=0, kind="pool_exhaust", duration=0)):
        with pytest.raises(ValueError):
            Fault(**kw)


def test_fault_sites_cover_all_kinds():
    for k in KINDS:
        assert Fault(0, k).site == SITES[k]


def test_fault_roundtrip():
    f = Fault(7, "pool_exhaust", arg=3, duration=2)
    assert Fault.from_dict(f.to_dict()) == f


# ---------------------------------------------------------------- FaultPlan
def test_plan_key_is_content_addressed():
    a = FaultPlan(faults=(Fault(1, "revoke_slot"), Fault(5, "decode_stall")))
    b = FaultPlan(faults=(Fault(5, "decode_stall"), Fault(1, "revoke_slot")))
    assert a.key() == b.key() and a == b
    assert a.key() != FaultPlan(faults=(Fault(2, "revoke_slot"),)).key()
    assert a.key().startswith("faultplan-v")
    assert FaultPlan(faults=a.faults, name="x").key() == a.key()


def test_plan_json_roundtrip():
    plan = FaultPlan.seeded(9, steps=30, rate=0.5, name="rt")
    back = FaultPlan.from_json(plan.to_json())
    assert back == plan and back.key() == plan.key()
    with pytest.raises(ValueError):
        FaultPlan.from_json(json.dumps({"version": 99, "faults": []}))


def test_plan_is_hashable_and_sorted():
    plan = FaultPlan(faults=(Fault(9, "revoke_slot"), Fault(2, "crash")))
    hash(plan)
    assert [f.step for f in plan.faults] == [2, 9]


def test_seeded_plan_deterministic():
    a = FaultPlan.seeded(4, steps=50, rate=0.3)
    assert a == FaultPlan.seeded(4, steps=50, rate=0.3)
    assert FaultPlan.seeded(5, steps=50, rate=0.3) != a
    assert all(f.step < 50 for f in a.faults)
    assert all(f.kind in ("pool_exhaust", "revoke_slot", "decode_stall")
               for f in a.faults)


def test_seeded_plan_rejects_unschedulable_kinds():
    for kind in ("crash", "ckpt_io"):
        with pytest.raises(ValueError):
            FaultPlan.seeded(0, steps=10, kinds=(kind,))


def test_seeded_plan_crash_at():
    crashes = [f for f in FaultPlan.seeded(0, steps=20, crash_at=7).faults
               if f.kind == "crash"]
    assert len(crashes) == 1 and crashes[0].step == 7


def test_plan_lookup_helpers():
    plan = FaultPlan(faults=(Fault(3, "revoke_slot"),
                             Fault(3, "decode_stall", arg=2),
                             Fault(5, "ckpt_io", arg=2)))
    assert [f.kind for f in plan.at(3)] == ["decode_stall", "revoke_slot"]
    assert plan.at(4) == () and plan.at(5) == ()
    assert plan.ckpt_failures(5) == 2 and plan.ckpt_failures(3) == 0
    assert plan.horizon == 5 and len(plan) == 3


def test_seeded_ckpt_plan():
    plan = FaultPlan.seeded_ckpt(2, steps=100, every=10, rate=1.0,
                                 max_failures=2)
    assert len(plan) == 10
    assert all(f.kind == "ckpt_io" and f.step % 10 == 0 for f in plan.faults)


@pytest.mark.parametrize("seed", range(8))
def test_plan_keys_match_reference(seed):
    """Seeded plans are framework-neutral: the port's key() and
    canonical_json() are exactly the reference's."""
    pairs = [
        (FaultPlan.seeded(seed, steps=40, rate=0.35),
         JPlan.seeded(seed, steps=40, rate=0.35)),
        (FaultPlan.seeded(seed, steps=512, rate=0.2, crash_at=7,
                          name=f"serve-chaos-{seed}"),
         JPlan.seeded(seed, steps=512, rate=0.2, crash_at=7,
                      name=f"serve-chaos-{seed}")),
        (FaultPlan.seeded_ckpt(seed, steps=20, every=2, rate=0.5,
                               max_failures=C.IO_RETRIES),
         JPlan.seeded_ckpt(seed, steps=20, every=2, rate=0.5,
                           max_failures=C.IO_RETRIES)),
    ]
    for port, ref in pairs:
        assert port.key() == ref.key()
        assert port.canonical_json() == ref.canonical_json()
        assert FaultPlan.from_json(ref.to_json()) == port


# ----------------------------------------------------------------- Injector
def test_injector_crash_is_one_shot():
    f = Fault(4, "crash")
    inj = Injector(FaultPlan(faults=(f,)))
    assert inj.consume_crash(f) is True
    assert inj.consume_crash(f) is False


def test_injector_ckpt_attempt_schedule():
    inj = Injector(FaultPlan(faults=(Fault(10, "ckpt_io", arg=2),)))
    for attempt in range(2):
        with pytest.raises(InjectedIOError):
            inj.ckpt_attempt(10, attempt)
    inj.ckpt_attempt(10, 2)
    inj.ckpt_attempt(11, 0)
    assert [e["attempt"] for e in inj.history] == [0, 1]


def test_injector_history_digest_orders():
    def digest(entries):
        inj = Injector(FaultPlan())
        for f, info in entries:
            inj.record(f, **info)
        return inj.history_digest()

    a = (Fault(1, "revoke_slot"), {"victims": [3]})
    b = (Fault(2, "decode_stall"), {})
    assert digest([a, b]) == digest([a, b])
    assert digest([a, b]) != digest([b, a])
    assert digest([]) != digest([a])


def test_history_digest_matches_reference():
    """The same landing records digest equally in both packages."""
    records = [((1, "revoke_slot", 2, 1), {"engine_step": 1,
                                           "victims": [7, 6]}),
               ((3, "pool_exhaust", 4, 2), {"engine_step": 3, "pages": 4,
                                            "victims": []}),
               ((5, "decode_stall", 3, 1), {"engine_step": 5,
                                            "stalled_until": 8}),
               ((20, "ckpt_io", 2, 1), {"attempt": 1})]
    port, ref = Injector(FaultPlan()), JInjector(JPlan())
    assert port.history_digest() == ref.history_digest()
    for (step, kind, arg, dur), info in records:
        port.record(Fault(step, kind, arg, dur), **info)
        ref.record(JFault(step, kind, arg, dur), **info)
        assert port.history == ref.history
        assert port.history_digest() == ref.history_digest()


def test_injector_tracker_logs_fault_injected():
    """Every landed fault reaches the tracker as the reference's
    ``fault_injected`` event, its step the fault's."""
    from repro.obs import MemoryTracker as JMemory
    from repro_torch.obs import MemoryTracker
    port, ref = MemoryTracker(), JMemory()
    pi, ri = Injector(FaultPlan(), tracker=port), JInjector(JPlan(),
                                                           tracker=ref)
    for inj, fault in ((pi, Fault), (ri, JFault)):
        inj.record(fault(4, "pool_exhaust", 3, 2), engine_step=4, pages=3,
                   victims=[1])
        inj.record(fault(9, "ckpt_io", 2), attempt=1)
    assert port.events == ref.events
    assert [e["event"] for e in port.events] == ["fault_injected"] * 2
    assert [e["step"] for e in port.events] == [4, 9]
    assert pi.history_digest() == ri.history_digest()


def test_armed_checkpoint_none_is_noop():
    with armed_checkpoint(None) as got:
        assert got is None and C._IO_HOOK is None


def test_armed_checkpoint_restores_hook_on_error():
    inj = Injector(FaultPlan())
    with pytest.raises(RuntimeError):
        with armed_checkpoint(inj):
            assert C._IO_HOOK is not None
            raise RuntimeError("boom")
    assert C._IO_HOOK is None


def test_armed_checkpoint_retries_through_the_port_writer(tmp_path):
    """Injected IO errors go through the port's writer's bounded retry; an
    exhausted retry raises the injected error and publishes nothing."""
    import torch
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    inj = Injector(FaultPlan(faults=(Fault(1, "ckpt_io", arg=2),
                                     Fault(2, "ckpt_io", arg=9))))
    with armed_checkpoint(inj):
        C.save(str(tmp_path), 1, tree)
        with pytest.raises(InjectedIOError):
            C.save(str(tmp_path), 2, tree)
    assert C.available_steps(str(tmp_path)) == [1]
    assert [e["attempt"] for e in inj.history] == [0, 1, 0, 1, 2]
    got = C.restore(str(tmp_path), 1, {"w": torch.zeros(2, 3)})
    assert torch.equal(got["w"], tree["w"])


# ------------------------------------------------------- the chaos matrix
@pytest.fixture(scope="module")
def setup():
    cfg = registry.get("stablelm-1.6b").reduced()
    jparams = JT.init(jregistry.get("stablelm-1.6b").reduced(),
                      jax.random.PRNGKey(0))
    params = from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                             device="cpu")
    rng = np.random.RandomState(0)
    prompts = {i: rng.randint(1, cfg.vocab, size=n).tolist()
               for i, n in enumerate(PROMPT_LENS)}
    return cfg, params, prompts


def build(setup, *, scfg=SampleConfig(temperature=0.7, seed=11), ids=None,
          **kw):
    cfg, params, prompts = setup
    eng = ContinuousEngine(cfg, params, scfg=scfg, **ENGINE_KW, **kw)
    for i in (ids if ids is not None else sorted(prompts)):
        eng.submit(prompts[i], req_id=i, max_new_tokens=GEN)
    return eng


@pytest.fixture(scope="module")
def baseline(setup):
    return build(setup).run()


@pytest.mark.parametrize("sampled", [True, False])
def test_conformance_matrix(sampled):
    """All 11 cells of the matrix ok on the CPU, sampled and greedy; the
    report carries plan keys and landing digests."""
    report = CF.run_matrix(sampled=sampled, device="cpu")
    assert sorted(c["cell"] for c in report["cells"]) == sorted(CF.CELLS)
    assert len(CF.CELLS) == 11
    failed = [c["cell"] for c in report["cells"] if not c["ok"]]
    assert report["ok"], f"chaos conformance cells failed: {failed}"
    for c in report["cells"]:
        if c["plan"] is not None:
            assert c["plan"].startswith("faultplan-v")
        if c["faults_landed"]:
            assert c["history_digest"]
    by = {c["cell"]: c["detail"] for c in report["cells"]}
    assert by["slot_revocation"]["preemptions"] > 0
    assert by["pool_exhaustion"]["preemptions"] > 0
    assert by["spec_preempt"]["preemptions"] > 0


def test_matrix_artifact_roundtrips(tmp_path):
    out = tmp_path / "chaos_conformance.json"
    report = CF.run_matrix(out=str(out), cells=["unarmed_noop"],
                           device="cpu")
    disk = json.loads(out.read_text())
    assert disk["ok"] == report["ok"] is True
    assert disk["baseline_tokens_sha256"] == report["baseline_tokens_sha256"]
    assert disk["config"]["device"] == "cpu"


def test_matrix_cli_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "c.json"
    rc = CF.main(["--device", "cpu", "--reduced", "--greedy", "--out",
                  str(out), "--cells", "unarmed_noop", "decode_stall"])
    assert rc == 0 and json.loads(out.read_text())["ok"]
    assert "chaos conformance: OK" in capsys.readouterr().out


def test_unarmed_layer_is_bitwise_noop(setup, baseline):
    inj = Injector(FaultPlan())
    armed = build(setup, faults=inj).run()
    for i in baseline:
        np.testing.assert_array_equal(baseline[i], armed[i])
    assert inj.history == []


def test_fault_landing_record_replays_identically(setup):
    plan = FaultPlan.seeded(7, steps=40, rate=0.4)
    digs = []
    for _ in range(2):
        inj = Injector(plan)
        build(setup, faults=inj).run()
        digs.append(inj.history_digest())
    assert digs[0] == digs[1]
    inj = Injector(FaultPlan.seeded(8, steps=40, rate=0.4))
    build(setup, faults=inj).run()
    assert inj.history_digest() != digs[0]


def test_preemption_under_arrival_order_change(setup, baseline):
    plan = FaultPlan(faults=(Fault(2, "revoke_slot", arg=2),
                             Fault(5, "pool_exhaust", arg=16, duration=2)))
    eng = build(setup, faults=Injector(plan), ids=list(reversed(range(8))))
    got = eng.run()
    assert eng.preemptions > 0
    for i in baseline:
        np.testing.assert_array_equal(baseline[i], got[i],
                                      err_msg=f"request {i}")


def test_load_shedding_is_deterministic(setup, baseline):
    cfg, params, prompts = setup
    sheds = []
    for _ in range(2):
        eng = build(setup, ids=[], max_queue_depth=3)
        shed = []
        for i in sorted(prompts):
            try:
                eng.submit(prompts[i], req_id=i, max_new_tokens=GEN)
            except QueueFull as e:
                assert e.req_id == i and e.depth == 3
                shed.append(i)
        sheds.append((shed, eng.run(), dict(eng.rejected)))
    (shed, got, rejected), (shed2, got2, _) = sheds
    assert shed == shed2 == [3, 4, 5, 6, 7]
    assert rejected == {i: "queue_full" for i in shed}
    assert sorted(got) == [0, 1, 2]
    for i in got:
        np.testing.assert_array_equal(baseline[i], got[i])
        np.testing.assert_array_equal(got[i], got2[i])


def test_deadline_cancellation_frees_pages(setup, baseline):
    cfg, params, prompts = setup
    inj = Injector(FaultPlan(faults=(Fault(1, "decode_stall", arg=8),)))
    eng = build(setup, ids=[], faults=inj)
    for i in sorted(prompts):
        eng.submit(prompts[i], req_id=i, max_new_tokens=GEN,
                   deadline_steps=5 if i in (1, 2) else None)
    got = eng.run()
    assert sorted(eng.cancelled) == [1, 2]
    assert sorted(got) == [0, 3, 4, 5, 6, 7]
    for i in got:
        np.testing.assert_array_equal(baseline[i], got[i])
    for i in (1, 2):
        part = eng.cancelled[i]
        np.testing.assert_array_equal(part, baseline[i][:len(part)])
    assert eng.cache.free_pages == eng.cache.layout.n_pages


def test_pending_cancel_keeps_a_preempted_requests_tokens(setup, baseline):
    """A request preempted, then cancelled by its deadline while it waits
    for its restore, keeps the tokens it had produced in ``cancelled``."""
    cfg, params, prompts = setup
    inj = Injector(FaultPlan(faults=(Fault(3, "revoke_slot", arg=1),
                                     Fault(3, "pool_exhaust", arg=64,
                                           duration=20))))
    eng = build(setup, ids=[], faults=inj)
    for i in range(4):
        eng.submit(prompts[i], req_id=i, max_new_tokens=GEN,
                   deadline_steps=6 if i == 3 else None)
    got = eng.run()
    assert eng.preemptions >= 1 and 3 not in got
    part = eng.cancelled[3]
    assert len(part) >= 3, part
    np.testing.assert_array_equal(part, baseline[3][:len(part)])
    assert eng.cache.free_pages == eng.cache.layout.n_pages
    assert not eng._resume


def test_crash_without_snapshot_raises_engine_crash(setup):
    eng = build(setup, faults=Injector(FaultPlan(faults=(Fault(2, "crash"),
                                                         ))))
    with pytest.raises(EngineCrash) as exc:
        eng.run()
    assert exc.value.step == 2 == eng.engine_steps


# ------------------------------------------------------- vs the reference
@pytest.fixture(scope="module")
def fp32():
    kw = dict(dtype_name="float32", n_layers=2)
    jcfg = jregistry.get("stablelm-1.6b").reduced(**kw)
    tcfg = registry.get("stablelm-1.6b").reduced(**kw)
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


PLANS = {
    "pool_squeeze": lambda P, F: P(faults=(
        F(2, "pool_exhaust", arg=24, duration=3),
        F(6, "pool_exhaust", arg=16, duration=2),
        F(11, "pool_exhaust", arg=28, duration=4))),
    "revoke_storm": lambda P, F: P(faults=(
        F(1, "revoke_slot", arg=2), F(4, "revoke_slot", arg=1),
        F(7, "revoke_slot", arg=3), F(12, "revoke_slot", arg=1))),
    "seeded_1": lambda P, F: P.seeded(1, steps=40, rate=0.35),
    "seeded_2": lambda P, F: P.seeded(2, steps=40, rate=0.35),
    "stall_deadline": lambda P, F: P(faults=(F(2, "decode_stall", arg=6),)),
}


@pytest.mark.parametrize("name", sorted(PLANS))
def test_same_plan_same_host_decisions_as_reference(fp32, name):
    """One plan against both engines (greedy fp32): equal tokens, equal
    preemptions, cancellations and steps, and an equal landing digest: the
    engine's host decisions are framework-neutral."""
    jcfg, tcfg, jparams, tparams = fp32
    rng = np.random.RandomState(0)
    prompts = {i: rng.randint(1, tcfg.vocab, size=n).tolist()
               for i, n in enumerate(PROMPT_LENS)}
    jinj = JInjector(PLANS[name](JPlan, JFault))
    tinj = Injector(PLANS[name](FaultPlan, Fault))
    assert jinj.plan.key() == tinj.plan.key()
    jeng = JE.ContinuousEngine(jcfg, jparams, faults=jinj, **ENGINE_KW)
    teng = ContinuousEngine(tcfg, tparams, faults=tinj, **ENGINE_KW)
    for i, p in prompts.items():
        dl = 6 if i >= 6 else None
        jeng.submit(p, req_id=i, max_new_tokens=GEN, deadline_steps=dl)
        teng.submit(p, req_id=i, max_new_tokens=GEN, deadline_steps=dl)
    want, got = jeng.run(), teng.run()
    assert sorted(got) == sorted(want)
    for i in want:
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
        np.testing.assert_allclose(teng.result_logprobs[i],
                                   jeng.result_logprobs[i], atol=2e-5,
                                   rtol=2e-5)
    assert {k: v.tolist() for k, v in teng.cancelled.items()} == \
        {k: v.tolist() for k, v in jeng.cancelled.items()}
    assert (teng.preemptions, teng.decode_steps, teng.engine_steps) == (
        jeng.preemptions, jeng.decode_steps, jeng.engine_steps)
    assert tinj.history == jinj.history
    assert tinj.history_digest() == jinj.history_digest()


# ------------------------------------------------------- train --chaos
def test_train_chaos_absorbs_io_faults(tmp_path, capsys):
    """``--chaos`` arms seeded checkpoint-IO faults: each save retries
    through them and the digest chain is the unarmed run's."""
    argv = ["--reduced", "--device", "cpu", "--steps", "4", "--batch", "2",
            "--seq", "32", "--ckpt-every", "1", "--verify"]
    plain = tlaunch.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    armed = tlaunch.main(argv + ["--ckpt-dir", str(tmp_path / "b"),
                                 "--chaos", "3"])
    plan = FaultPlan.seeded_ckpt(3, steps=4, every=1, rate=0.5,
                                 max_failures=C.IO_RETRIES,
                                 name="train-chaos-3")
    assert armed["chaos_plan"] == plan.key()
    assert armed["chaos_faults_landed"] == sum(f.arg for f in plan.faults) > 0
    assert armed["digest_chain_head"] == plain["digest_chain_head"]
    assert "chaos_plan" not in plain and C._IO_HOOK is None
    assert "[chaos] armed faultplan-v1|" in capsys.readouterr().out
