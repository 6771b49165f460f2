"""Port parity and contract for the continuous-batching engine.

Against the reference (``repro.serve``): the scheduler's and the page
allocator's decisions exactly, greedy streams on the reduced StableLM (fp32,
with and without a sliding window), the captured prefill logits (fp32 2e-5,
bf16 2e-2), ``submit``'s validation messages. Within the port, the
reference's single-device invariance suite
(``tests/test_serve_invariance.py``): a request's tokens *and logprobs* are
bitwise the same across co-batch, batch size and slot count, arrival order,
prefill chunk, prompt padding, page reuse, run to run, greedy and sampled;
plus the logprob contract, EOS, deadlines and load shedding; the launcher's
``--spec-k``, ``--draft-model`` and ``--chaos``; and the knobs that raise
until their ROADMAP items land (the tracker's are in
``tests/test_torch_obs_engine.py``)."""
import jax
import numpy as np
import pytest

from repro.configs import registry as jregistry
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro.serve import kv_cache as JK
from repro.serve import scheduler as JS
from repro_torch.configs import registry as tregistry
from repro_torch.launch import serve as tlaunch
from repro_torch.models.convert import from_jax_params
from repro_torch.serve import engine as TE
from repro_torch.serve import kv_cache as TK
from repro_torch.serve import scheduler as TS

GEN = 8
PROMPT_LENS = [5, 13, 32, 7, 21, 9, 17, 3]


def _models(dtype_name, n_layers=None, **over):
    kw = dict(dtype_name=dtype_name, **over)
    if n_layers:
        kw["n_layers"] = n_layers
    jcfg = jregistry.get("stablelm-1.6b").reduced(**kw)
    tcfg = tregistry.get("stablelm-1.6b").reduced(**kw)
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(vocab=512, seed=0):
    rng = np.random.RandomState(seed)
    return {i: rng.randint(1, vocab, size=n).tolist()
            for i, n in enumerate(PROMPT_LENS)}


@pytest.fixture(scope="module")
def setup():
    """The reference invariance suite's setup: reduced StableLM (bf16, one
    layer), weights from ``repro`` PRNGKey(0)."""
    _, tcfg, _, tparams = _models("bfloat16")
    return tcfg, tparams, _prompts()


@pytest.fixture(scope="module")
def fp32():
    return _models("float32", n_layers=2)


def run(setup, ids, *, n_slots=4, page_size=8, chunk=16, n_pages=None,
        scfg=TE.SampleConfig(), engine=False):
    cfg, params, prompts = setup
    eng = TE.ContinuousEngine(cfg, params, n_slots=n_slots, max_seq=64,
                              page_size=page_size, prefill_chunk=chunk,
                              n_pages=n_pages, scfg=scfg)
    for i in ids:
        eng.submit(prompts[i], req_id=i, max_new_tokens=GEN)
    out = eng.run()
    return (out, eng) if engine else (out, eng.result_logprobs)


def assert_same(a, b, ids):
    """Tokens and logprobs of each request in ``ids``, bitwise."""
    for i in ids:
        np.testing.assert_array_equal(a[0][i], b[0][i], err_msg=f"req {i}")
        np.testing.assert_array_equal(a[1][i], b[1][i],
                                      err_msg=f"req {i} logprobs")


# ------------------------------------------------------------ vs reference
def test_scheduler_and_allocator_decisions_match_reference():
    """One seeded stream of submits, admissions (with a page-capacity
    predicate), allocations, frees and write-target queries through both
    packages' host machinery: every decision equal."""
    cfg = tregistry.get("stablelm-1.6b").reduced()
    jcfg = jregistry.get("stablelm-1.6b").reduced()
    layout = dict(page_size=4, n_pages=11, n_slots=3, max_pages_per_slot=6)
    jc = JK.PagedKVCache(jcfg, JK.PagedLayout(**layout))
    tc = TK.PagedKVCache(cfg, TK.PagedLayout(**layout), "cpu")
    js, ts = JS.FCFSScheduler(3), TS.FCFSScheduler(3)
    rng = np.random.RandomState(0)
    next_id, live = 0, {}
    for _ in range(60):
        for _ in range(rng.randint(0, 3)):
            n, new = int(rng.randint(1, 12)), int(rng.randint(1, 8))
            js.submit(JS.Request(next_id, tuple(range(1, n + 1)), new))
            ts.submit(TS.Request(next_id, tuple(range(1, n + 1)), new))
            next_id += 1

        def fits(cache):
            reserved = [0]

            def f(req):
                need = -(-(len(req.tokens) + req.max_new_tokens) // 4)
                if need + reserved[0] > cache.free_pages:
                    return False
                reserved[0] += need
                return True
            return f
        ja, ta = js.admit(fits(jc)), ts.admit(fits(tc))
        assert [(s, r.id) for s, r in ja] == [(s, r.id) for s, r in ta]
        for slot, req in ta:
            need = -(-(len(req.tokens) + req.max_new_tokens) // 4)
            jc.alloc(slot, need)
            tc.alloc(slot, need)
            live[slot] = len(req.tokens) + req.max_new_tokens
        np.testing.assert_array_equal(jc.page_table, tc.page_table)
        np.testing.assert_array_equal(jc.pages_held, tc.pages_held)
        assert jc.free_pages == tc.free_pages
        for slot, n in live.items():
            pos = np.arange(0, n + 3)
            valid = pos < n
            for a, b in zip(jc.write_targets(slot, pos, valid),
                            tc.write_targets(slot, pos, valid)):
                np.testing.assert_array_equal(a, b)
        for slot in [s for s in live if rng.rand() < 0.4]:
            jc.free_slot(slot)
            tc.free_slot(slot)
            js.release(slot)
            ts.release(slot)
            del live[slot]
    assert next_id > 40


@pytest.mark.parametrize("window", [None, 8])
def test_greedy_streams_match_reference(fp32, window):
    """fp32 reduced StableLM (2 layers), 8 requests over 4 slots: every
    request's greedy tokens equal the reference engine's, logprobs within
    2e-5, and the two engines take the same numbers of steps."""
    jcfg, tcfg, jparams, tparams = fp32
    if window:
        jcfg, tcfg = (c.replace(attn_window=window) for c in (jcfg, tcfg))
    prompts = _prompts()
    kw = dict(n_slots=4, max_seq=64, page_size=8, prefill_chunk=16)
    jeng = JE.ContinuousEngine(jcfg, jparams, **kw)
    teng = TE.ContinuousEngine(tcfg, tparams, **kw)
    for i, p in prompts.items():
        jeng.submit(p, req_id=i, max_new_tokens=GEN)
        teng.submit(p, req_id=i, max_new_tokens=GEN)
    want, got = jeng.run(), teng.run()
    for i in prompts:
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"req {i}")
        np.testing.assert_allclose(teng.result_logprobs[i],
                                   jeng.result_logprobs[i], atol=2e-5,
                                   rtol=2e-5)
    assert (teng.decode_steps, teng.engine_steps) == (jeng.decode_steps,
                                                      jeng.engine_steps)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_prefill_logits_match_reference(dtype, tol):
    jcfg, tcfg, jparams, tparams = _models(dtype, n_layers=2)
    prompts = _prompts(seed=1)
    kw = dict(n_slots=2, max_seq=64, page_size=8, prefill_chunk=16,
              capture_prefill_logits=True)
    jeng = JE.ContinuousEngine(jcfg, jparams, **kw)
    teng = TE.ContinuousEngine(tcfg, tparams, **kw)
    for i in (0, 1, 2, 3):
        jeng.submit(prompts[i], req_id=i, max_new_tokens=1)
        teng.submit(prompts[i], req_id=i, max_new_tokens=1)
    jeng.run()
    teng.run()
    for i in (0, 1, 2, 3):
        got = teng.prefill_logits[i]
        assert got.shape == (PROMPT_LENS[i], tcfg.padded_vocab)
        np.testing.assert_allclose(
            got, jeng.prefill_logits[i].astype(np.float32), atol=tol,
            rtol=tol)


def test_submit_validation_matches_reference(fp32):
    jcfg, tcfg, jparams, tparams = fp32
    kw = dict(n_slots=2, max_seq=32, page_size=8, n_pages=3)
    jeng = JE.ContinuousEngine(jcfg, jparams, **kw)
    teng = TE.ContinuousEngine(tcfg, tparams, **kw)
    cases = [
        dict(tokens=[1] * 30, max_new_tokens=8),            # > max_seq
        dict(tokens=[1] * 20, max_new_tokens=8),            # > the pool
        dict(tokens=[1, 2], max_new_tokens=2, deadline_steps=0),
        dict(tokens=[], max_new_tokens=2),                   # empty prompt
        dict(tokens=[1, 2], max_new_tokens=0),
    ]
    for i, case in enumerate(cases):
        msgs = []
        for eng in (jeng, teng):
            with pytest.raises(ValueError) as exc:
                eng.submit(req_id=10 + i, **case)
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1], case
    for eng in (jeng, teng):
        eng.submit([1, 2, 3], req_id=0, max_new_tokens=2)
        eng.run()
    msgs = []
    for eng in (jeng, teng):
        with pytest.raises(ValueError) as exc:
            eng.submit([4], req_id=0)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1] == "request id 0 was already served"


def test_queue_depth_and_deadlines_match_reference(fp32):
    """Load shedding by queue depth and step deadlines: the same requests
    shed, cancelled and completed, with the same messages and partial
    lengths, as the reference engine."""
    jcfg, tcfg, jparams, tparams = fp32
    prompts = _prompts()
    kw = dict(n_slots=1, max_seq=64, page_size=8, prefill_chunk=16,
              max_queue_depth=2)
    out = []
    for eng in (JE.ContinuousEngine(jcfg, jparams, **kw),
                TE.ContinuousEngine(tcfg, tparams, **kw)):
        shed = []
        for i in range(4):
            try:
                eng.submit(prompts[i], req_id=i, max_new_tokens=GEN,
                           deadline_steps=5 if i == 1 else None)
            except RuntimeError as exc:
                shed.append((i, str(exc)))
        done = eng.run()
        out.append((shed, dict(eng.rejected), sorted(done),
                    {k: len(v) for k, v in eng.cancelled.items()},
                    {k: v.tolist() for k, v in done.items()}))
    assert out[0] == out[1]
    assert out[1][0] and out[1][3]          # something shed and cancelled
    assert isinstance(TE.QueueFull(3, 2), RuntimeError)


# ------------------------------------------------- invariance (port-internal)
def test_cobatch_composition_invariant(setup):
    full = run(setup, [0, 1, 2, 3])
    assert_same(full, run(setup, [0]), [0])
    assert_same(full, run(setup, [0, 2]), [0, 2])
    assert_same(full, run(setup, [1, 3]), [1, 3])


def test_batch_size_invariant(setup):
    full = run(setup, [0, 1, 2, 3])
    assert_same(full, run(setup, [1]), [1])
    assert_same(full, run(setup, [1, 2]), [1, 2])
    assert_same(full, run(setup, [0, 1, 2, 3], n_slots=2), [0, 1, 2, 3])


def test_arrival_order_invariant(setup):
    a = run(setup, [0, 1, 2, 3])
    assert_same(a, run(setup, [3, 1, 0, 2]), [0, 1, 2, 3])
    assert_same(a, run(setup, [2, 3, 0, 1]), [0, 1, 2, 3])


def test_prefill_chunk_invariant(setup):
    base = run(setup, [0, 1, 2, 3], chunk=16)
    for chunk in (4, 8, 32):
        assert_same(base, run(setup, [0, 1, 2, 3], chunk=chunk),
                    [0, 1, 2, 3])


def test_prompt_padding_invariant(setup):
    alone = run(setup, [3])
    assert_same(alone, run(setup, [2, 3]), [3])
    assert_same(alone, run(setup, [3], chunk=64), [3])
    assert_same(alone, run(setup, [3], chunk=1), [3])


def test_page_reuse_invariant(setup):
    wide = run(setup, list(range(8)))
    tight = run(setup, list(range(8)), n_slots=2, n_pages=13)
    assert_same(wide, tight, list(range(8)))


def test_sampled_invariance(setup):
    scfg = TE.SampleConfig(temperature=1.0, top_k=20, seed=7)
    full = run(setup, [0, 1, 2, 3], scfg=scfg)
    assert_same(full, run(setup, [1], scfg=scfg), [1])
    assert_same(full, run(setup, [1, 3], scfg=scfg), [1, 3])
    assert_same(full, run(setup, [0, 1, 2, 3], n_slots=2, chunk=8,
                          scfg=scfg), [0, 1, 2, 3])
    other = run(setup, [0, 1, 2, 3], scfg=TE.SampleConfig(
        temperature=1.0, top_k=20, seed=8))
    assert any(not np.array_equal(full[0][i], other[0][i]) for i in range(4))


def test_logprob_contract_pinned(setup):
    """Greedy reports log_softmax(raw)[argmax] (top_k does not leak in);
    sampled with top_k=1 is a point mass: the argmax, logprob exactly 0."""
    g_tok, g_lp = run(setup, [0, 1])
    gk_tok, gk_lp = run(setup, [0, 1], scfg=TE.SampleConfig(top_k=1))
    s_tok, s_lp = run(setup, [0, 1], scfg=TE.SampleConfig(
        temperature=1.0, top_k=1, seed=5))
    for i in (0, 1):
        np.testing.assert_array_equal(g_tok[i], gk_tok[i])
        np.testing.assert_array_equal(g_lp[i], gk_lp[i])
        assert (g_lp[i] < 0.0).all()
        np.testing.assert_array_equal(s_tok[i], g_tok[i])
        np.testing.assert_array_equal(s_lp[i], np.zeros_like(s_lp[i]))


def test_eos_finishes_request(setup):
    base, _ = run(setup, [0, 1])
    eos = int(base[0][2])
    got, _ = run(setup, [0, 1], scfg=TE.SampleConfig(eos_id=eos))
    np.testing.assert_array_equal(
        got[0], base[0][: list(base[0]).index(eos) + 1])


def test_run_to_run_bitwise(setup):
    for scfg in (TE.SampleConfig(),
                 TE.SampleConfig(temperature=0.7, top_k=50, seed=3)):
        base = run(setup, [0, 1, 2, 3], scfg=scfg)
        for _ in range(4):
            assert_same(base, run(setup, [0, 1, 2, 3], scfg=scfg),
                        [0, 1, 2, 3])


def test_streamed_arrivals_invariant(setup):
    """Requests submitted between engine steps get the tokens they get when
    everything is submitted up front."""
    cfg, params, prompts = setup
    base = run(setup, [0, 1, 2, 3])
    eng = TE.ContinuousEngine(cfg, params, n_slots=4, max_seq=64, page_size=8,
                              prefill_chunk=16)
    eng.submit(prompts[0], req_id=0, max_new_tokens=GEN)
    eng.step()
    eng.submit(prompts[1], req_id=1, max_new_tokens=GEN)
    eng.step()
    eng.submit(prompts[2], req_id=2, max_new_tokens=GEN)
    eng.submit(prompts[3], req_id=3, max_new_tokens=GEN)
    assert_same(base, (eng.run(), eng.result_logprobs), [0, 1, 2, 3])


def test_engine_telemetry(setup):
    (out, eng) = run(setup, list(range(8)), engine=True)
    assert sorted(out) == list(range(8)) and eng.cache.free_pages == \
        eng.cache.layout.n_pages
    assert len(eng.decode_s) == eng.decode_steps > 0
    assert sorted(eng.first_token_step) == list(range(8))
    assert all(t >= 0 for t in eng.ttft_s.values())


# ------------------------------------------------------------ not ported
@pytest.mark.parametrize("knob", ["mesh"])
def test_unported_knobs_raise(setup, knob):
    cfg, params, _ = setup
    value = object()
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        TE.ContinuousEngine(cfg, params, **{knob: value})


@pytest.mark.parametrize("knob", ["draft_cfg", "draft_params"])
def test_drafter_without_spec_k_raises(setup, knob):
    cfg, params, _ = setup
    value = cfg if knob == "draft_cfg" else params
    with pytest.raises(ValueError, match="require spec_k >= 1"):
        TE.ContinuousEngine(cfg, params, **{knob: value})


def test_launcher_continuous_on_cpu(capsys):
    eng = tlaunch.main(["--engine", "continuous", "--reduced", "--device",
                        "cpu", "--requests", "4", "--slots", "2",
                        "--prompt-len", "24", "--gen", "4"])
    assert sorted(eng.results) == [0, 1, 2, 3]
    assert all(len(v) == 4 for v in eng.results.values())
    text = capsys.readouterr().out
    assert "request 0 tokens:" in text and "continuous: 4 requests" in text


@pytest.mark.parametrize("flag", [["--tp", "2"], ["--mesh", "2x2"]])
def test_launcher_unported_flags_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        tlaunch.main(["--engine", "continuous", "--reduced", "--device",
                      "cpu"] + flag)


LAUNCH = ["--engine", "continuous", "--reduced", "--device", "cpu",
          "--requests", "6", "--slots", "3", "--prompt-len", "24", "--gen",
          "8"]


@pytest.fixture(scope="module")
def launched_plain():
    return tlaunch.main(LAUNCH)


def _same_streams(a, b):
    assert sorted(a.results) == sorted(b.results)
    for i in a.results:
        np.testing.assert_array_equal(a.results[i], b.results[i])
        np.testing.assert_array_equal(a.result_logprobs[i],
                                      b.result_logprobs[i])


@pytest.mark.parametrize("draft", ["self", "auto"])
def test_launcher_spec_k_self_draft(launched_plain, draft, capsys):
    eng = tlaunch.main(LAUNCH + ["--spec-k", "2", "--draft-model", draft])
    _same_streams(launched_plain, eng)
    assert eng.spec.self_draft and eng.spec.acceptance_rate() == 1.0
    assert eng.decode_steps < launched_plain.decode_steps
    assert "speculation: k=2 self-draft" in capsys.readouterr().out


def test_launcher_draft_model_arch(launched_plain, capsys):
    """A separate drafter of another arch (reduced Qwen1.5-110B, vocab 512
    like the target's), its weights from --seed + 1."""
    eng = tlaunch.main(LAUNCH + ["--spec-k", "2", "--draft-model",
                                 "qwen1.5-110b"])
    _same_streams(launched_plain, eng)
    assert not eng.spec.self_draft and eng.spec.dcfg.name == "qwen1.5-110b"
    assert eng.spec.draft_steps > 0
    out = capsys.readouterr().out
    assert "drafter: qwen1.5-110b" in out and "separate drafter" in out


def test_launcher_chaos(launched_plain, capsys):
    from repro_torch.faults import FaultPlan
    eng = tlaunch.main(LAUNCH + ["--chaos", "3"])
    _same_streams(launched_plain, eng)
    plan = FaultPlan.seeded(3, steps=16 * 8, rate=0.2, name="serve-chaos-3")
    assert eng.faults.plan == plan and eng.faults.history
    assert eng.cache.free_pages == eng.cache.layout.n_pages
    out = capsys.readouterr().out
    assert f"chaos armed: {plan.key()}" in out
    assert f"landing digest {eng.faults.history_digest()[:16]}" in out


def test_launcher_chaos_with_spec(launched_plain):
    eng = tlaunch.main(LAUNCH + ["--chaos", "1", "--spec-k", "3"])
    _same_streams(launched_plain, eng)


@pytest.mark.parametrize("argv", [["--spec-k", "2"], ["--chaos", "1"]])
def test_launcher_spec_and_chaos_need_the_continuous_engine(argv):
    with pytest.raises(SystemExit):
        tlaunch.main(["--reduced", "--device", "cpu"] + argv)


def test_launcher_rejects_a_negative_spec_k():
    with pytest.raises(SystemExit):
        tlaunch.main(LAUNCH + ["--spec-k", "-1"])
