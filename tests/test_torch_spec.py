"""Speculative decoding in the port (``repro_torch.serve.spec``).

Within the port, the reference's exactness suite
(``tests/test_spec_decode.py``) case for case: with ``spec_k >= 1`` the
continuous engine's tokens *and* logprobs are bitwise those of
``spec_k=0``, self-draft or a separate drafter (rejecting, or an exact
copy), greedy or seeded, GQA, through EOS, co-batch changes, preemption and
snapshot/restore. Against the reference, in greedy fp32: the port's
speculative tokens and telemetry equal the reference's, logprobs within
2e-5, and the drafter pairing is the reference's."""
import tempfile

import jax
import numpy as np
import pytest

from repro.configs import registry as jregistry
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro_torch.configs import registry
from repro_torch.faults import Fault, FaultPlan, Injector
from repro_torch.models.convert import from_jax_params
from repro_torch.serve.engine import ContinuousEngine, SampleConfig
from repro_torch.serve.snapshot import save_engine_snapshot

GEN = 10
PROMPT_LENS = [5, 13, 32, 7, 21, 9]
SCFGS = {
    "greedy": SampleConfig(),
    "seeded": SampleConfig(temperature=0.8, top_k=20, seed=11),
}
ENGINE_KW = dict(n_slots=3, max_seq=64, page_size=8, prefill_chunk=16)


def _params(cfg, jcfg, key):
    jparams = JT.init(jcfg, jax.random.PRNGKey(key))
    return from_jax_params(jax.tree.map(np.asarray, jparams), cfg,
                           device="cpu")


def _prompts(vocab):
    rng = np.random.RandomState(0)
    return {i: rng.randint(1, vocab, size=n).tolist()
            for i, n in enumerate(PROMPT_LENS)}


@pytest.fixture(scope="module")
def setup():
    """The reference suite's setup: reduced StableLM, weights from the
    reference's PRNGKey(0), prompts from RandomState(0)."""
    cfg = registry.get("stablelm-1.6b").reduced()
    jcfg = jregistry.get("stablelm-1.6b").reduced()
    return cfg, _params(cfg, jcfg, 0), _prompts(cfg.vocab)


@pytest.fixture(scope="module")
def drafter(setup):
    """An independent random drafter (the reference's PRNGKey(99))."""
    cfg = setup[0]
    return _params(cfg, jregistry.get("stablelm-1.6b").reduced(), 99)


def make_engine(cfg, params, scfg, **kw):
    return ContinuousEngine(cfg, params, scfg=scfg, **ENGINE_KW, **kw)


def run(cfg, params, prompts, scfg, ids=None, gen=GEN, **kw):
    eng = make_engine(cfg, params, scfg, **kw)
    for i in (ids if ids is not None else sorted(prompts)):
        eng.submit(prompts[i], req_id=i, max_new_tokens=gen)
    return eng, eng.run()


def assert_streams_equal(base_eng, base, spec_eng, got):
    """Tokens AND logprobs bitwise, every request."""
    assert sorted(base) == sorted(got)
    for i in sorted(base):
        np.testing.assert_array_equal(base[i], got[i],
                                      err_msg=f"request {i} tokens")
        np.testing.assert_array_equal(base_eng.result_logprobs[i],
                                      spec_eng.result_logprobs[i],
                                      err_msg=f"request {i} logprobs")


@pytest.fixture(scope="module")
def baselines(setup):
    cfg, params, prompts = setup
    return {name: run(cfg, params, prompts, scfg)
            for name, scfg in SCFGS.items()}


# ------------------------------------------------------------ within the port
@pytest.mark.parametrize("mode", sorted(SCFGS))
@pytest.mark.parametrize("k", [1, 2, 4])
def test_self_draft_bitwise(setup, baselines, k, mode):
    cfg, params, prompts = setup
    base_eng, base = baselines[mode]
    eng, got = run(cfg, params, prompts, SCFGS[mode], spec_k=k)
    assert_streams_equal(base_eng, base, eng, got)
    assert eng.spec.rounds > 0
    assert eng.spec.acceptance_rate() == 1.0
    assert eng.spec.accepted == eng.spec.drafted - eng.spec.truncated
    assert eng.decode_steps == eng.spec.rounds == len(eng.decode_s)
    if k >= 2:
        assert eng.decode_steps < base_eng.decode_steps


def test_self_draft_gqa_bitwise(setup):
    """GQA (reduced Qwen1.5-110B: 4 query heads on 1 KV head, QKV bias)."""
    _, _, prompts = setup
    gcfg = registry.get("qwen1.5-110b").reduced()
    assert gcfg.n_kv_heads < gcfg.n_heads
    gparams = _params(gcfg, jregistry.get("qwen1.5-110b").reduced(), 0)
    base_eng, base = run(gcfg, gparams, prompts, SCFGS["seeded"])
    eng, got = run(gcfg, gparams, prompts, SCFGS["seeded"], spec_k=4)
    assert_streams_equal(base_eng, base, eng, got)
    assert eng.spec.acceptance_rate() == 1.0


def test_separate_drafter_rejection_path_bitwise(setup, baselines, drafter):
    """A random drafter rejects nearly everything, and the stream is still
    bitwise the plain one: the rejection path, not only the accept lane."""
    cfg, params, prompts = setup
    for mode in sorted(SCFGS):
        base_eng, base = baselines[mode]
        eng, got = run(cfg, params, prompts, SCFGS[mode], spec_k=4,
                       draft_cfg=cfg, draft_params=drafter)
        assert_streams_equal(base_eng, base, eng, got)
        assert eng.spec.drafted - eng.spec.truncated > 0
        assert eng.spec.acceptance_rate() < 1.0
        assert eng.spec.draft_steps > 0


def test_separate_drafter_exact_copy_accepts_everything(setup, baselines):
    """The target as its own separate drafter (own pools) accepts 1.0
    through the teacher-forced verify: the drafter's chunked prefill and
    self-feed reproduce the plain samples."""
    cfg, params, prompts = setup
    base_eng, base = baselines["seeded"]
    eng, got = run(cfg, params, prompts, SCFGS["seeded"], spec_k=2,
                   draft_cfg=cfg, draft_params=params)
    assert_streams_equal(base_eng, base, eng, got)
    assert eng.spec.acceptance_rate() == 1.0
    assert not eng.spec.self_draft


def test_eos_truncation_bitwise(setup):
    cfg, params, prompts = setup
    _, free = run(cfg, params, prompts, SCFGS["seeded"], gen=16)
    eos = int(free[0][4])
    scfg = SampleConfig(temperature=0.8, top_k=20, seed=11, eos_id=eos)
    base_eng, base = run(cfg, params, prompts, scfg, gen=16)
    eng, got = run(cfg, params, prompts, scfg, gen=16, spec_k=4)
    assert_streams_equal(base_eng, base, eng, got)
    assert len(base[0]) < 16, "request 0 should stop at EOS"
    assert eng.spec.truncated > 0
    assert eng.spec.acceptance_rate() == 1.0


def test_cobatch_invariance_with_spec_on(setup):
    cfg, params, prompts = setup
    scfg = SCFGS["seeded"]
    solo_eng, solo = run(cfg, params, prompts, scfg, ids=[2], spec_k=4)
    both_eng, both = run(cfg, params, prompts, scfg, spec_k=4)
    np.testing.assert_array_equal(solo[2], both[2])
    np.testing.assert_array_equal(solo_eng.result_logprobs[2],
                                  both_eng.result_logprobs[2])


@pytest.mark.parametrize("separate", [False, True])
def test_spec_under_preemption_chaos(setup, baselines, drafter, separate):
    """Revocations between rounds: the restores recompute through the
    speculative path (the drafter's pools too) and every stream is bitwise
    the fault-free plain one."""
    cfg, params, prompts = setup
    base_eng, base = baselines["seeded"]
    plan = FaultPlan(name="spec-chaos", faults=(
        Fault(1, "revoke_slot", arg=2), Fault(3, "revoke_slot", arg=1),
        Fault(5, "revoke_slot", arg=3)))
    dkw = dict(draft_cfg=cfg, draft_params=drafter) if separate else {}
    eng, got = run(cfg, params, prompts, SCFGS["seeded"], spec_k=4,
                   faults=Injector(plan), **dkw)
    assert_streams_equal(base_eng, base, eng, got)
    assert eng.preemptions > 0 and eng.restore_positions


@pytest.mark.parametrize("which", ["self", "separate"])
def test_snapshot_restore_mid_run_bitwise(setup, baselines, drafter, which):
    cfg, params, prompts = setup
    base_eng, base = baselines["seeded"]
    dkw = ({} if which == "self"
           else dict(draft_cfg=cfg, draft_params=drafter))
    eng = make_engine(cfg, params, SCFGS["seeded"], spec_k=2, **dkw)
    for i in sorted(prompts):
        eng.submit(prompts[i], req_id=i, max_new_tokens=GEN)
    for _ in range(5):
        eng.step()
    with tempfile.TemporaryDirectory() as d:
        save_engine_snapshot(eng, d)
        eng2 = ContinuousEngine.from_snapshot(d, cfg, params, **dkw)
    assert eng2.spec is not None and eng2.spec.k == 2
    assert eng2.spec.self_draft == (which == "self")
    assert (eng2.spec.rounds, eng2.spec.draft_steps) == (
        eng.spec.rounds, eng.spec.draft_steps)
    got = eng2.run()
    assert_streams_equal(base_eng, base, eng2, got)


def test_spec_constructor_validation(setup, drafter):
    cfg, params, _ = setup
    with pytest.raises(ValueError, match="spec_k"):
        make_engine(cfg, params, SCFGS["greedy"], spec_k=-1)
    for kw in (dict(draft_params=drafter), dict(draft_cfg=cfg)):
        with pytest.raises(ValueError, match="require spec_k"):
            make_engine(cfg, params, SCFGS["greedy"], **kw)
    bad_vocab = registry.get("stablelm-1.6b").reduced(vocab=256)
    with pytest.raises(ValueError, match="vocab"):
        make_engine(cfg, params, SCFGS["greedy"], spec_k=2,
                    draft_cfg=bad_vocab, draft_params=drafter)


def test_spec_write_check_guards_the_reservation():
    from repro_torch.serve.kv_cache import PagedLayout
    lay = PagedLayout(page_size=8, n_pages=8, n_slots=2,
                      max_pages_per_slot=4)
    lay.check_spec_write(10, 6, 14)
    with pytest.raises(ValueError, match="draft clamp"):
        lay.check_spec_write(10, 6, 15)


def test_spec_run_to_run_bitwise(setup, baselines):
    cfg, params, prompts = setup
    base_eng, base = baselines["seeded"]
    for _ in range(3):
        eng, got = run(cfg, params, prompts, SCFGS["seeded"], spec_k=4)
        assert_streams_equal(base_eng, base, eng, got)


# ---------------------------------------------------------- vs the reference
@pytest.fixture(scope="module")
def fp32():
    kw = dict(dtype_name="float32", n_layers=2)
    jcfg = jregistry.get("stablelm-1.6b").reduced(**kw)
    tcfg = registry.get("stablelm-1.6b").reduced(**kw)
    jp = {key: JT.init(jcfg, jax.random.PRNGKey(key)) for key in (0, 99)}
    tp = {key: from_jax_params(jax.tree.map(np.asarray, p), tcfg,
                               device="cpu") for key, p in jp.items()}
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("k,separate", [(2, False), (4, False), (3, True)])
def test_spec_matches_reference(fp32, k, separate):
    """Greedy fp32: the port's speculative tokens, rounds and acceptance
    telemetry equal the reference engine's; logprobs within 2e-5."""
    jcfg, tcfg, jp, tp = fp32
    prompts = _prompts(tcfg.vocab)
    kw = dict(ENGINE_KW, spec_k=k)
    jkw, tkw = dict(kw), dict(kw)
    if separate:
        jkw.update(draft_cfg=jcfg, draft_params=jp[99])
        tkw.update(draft_cfg=tcfg, draft_params=tp[99])
    jeng = JE.ContinuousEngine(jcfg, jp[0], **jkw)
    teng = ContinuousEngine(tcfg, tp[0], **tkw)
    for i, p in prompts.items():
        jeng.submit(p, req_id=i, max_new_tokens=GEN)
        teng.submit(p, req_id=i, max_new_tokens=GEN)
    want, got = jeng.run(), teng.run()
    for i in prompts:
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
        np.testing.assert_allclose(teng.result_logprobs[i],
                                   jeng.result_logprobs[i], atol=2e-5,
                                   rtol=2e-5)
    names = ("rounds", "drafted", "accepted", "truncated", "draft_steps")
    assert [getattr(teng.spec, n) for n in names] == \
        [getattr(jeng.spec, n) for n in names]
    assert (teng.decode_steps, teng.engine_steps) == (jeng.decode_steps,
                                                      jeng.engine_steps)


def test_drafter_pairing_matches_reference():
    from repro.configs import registry as JR
    for name in ("stablelm-1.6b", "qwen1.5-110b", "mistral-nemo-12b",
                 "qwen1_5_110b", "nemotron-4-15b"):
        assert registry.drafter_for(name) == JR.drafter_for(name)
    for name in ("phi3.5-moe-42b-a6.6b", "dash-paper", "xlstm-350m"):
        with pytest.raises(KeyError, match="no drafter pairing"):
            registry.drafter_for(name)
