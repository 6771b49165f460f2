"""Port parity for the static serving engine: greedy generation against the
reference ``repro.serve.engine.Engine`` (teacher-forced logits and tokens),
windowed (``attn_window``) as well as full causal attention, the exact-k
top-k transform, and the engine's own contracts (determinism, sticky EOS
with the all-done fast path, the launcher)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import transformer as JT
from repro.serve import engine as JE
from repro_torch.configs import registry as tregistry
from repro_torch.launch import serve as tlaunch
from repro_torch.models import transformer as TT
from repro_torch.models.convert import from_jax_params
from repro_torch.serve import engine as TE

S, N = 256, 8
# fp32 logits: the reference's fp32 tolerance (tests/test_kernels.py:22)
TOL = 2e-5


@pytest.fixture(scope="module")
def setup():
    kw = dict(n_layers=2, dtype_name="float32")
    jcfg = jregistry.get("stablelm-1.6b").reduced(attention_impl="xla", **kw)
    tcfg = tregistry.get("stablelm-1.6b").reduced(attention_impl="cuda", **kw)
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    prompt = np.random.default_rng(5).integers(1, 512, (2, S)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, prompt


def _reference_step_logits(jcfg, jparams, prompt, forced):
    """(N, B, V) logits of the reference, fed its own tokens `forced`."""
    logits, caches, _ = JT.prefill_step(jparams, {"tokens": jnp.asarray(prompt)},
                                        jcfg, max_seq=S + N)
    out = [np.asarray(logits[:, 0])]
    for i in range(N - 1):
        logits, caches = JT.decode_step(jparams, caches,
                                        jnp.asarray(forced[:, i:i + 1]), S + i,
                                        jcfg)
        out.append(np.asarray(logits[:, 0]))
    return np.stack(out)


@torch.inference_mode()
def _port_step_logits(tcfg, tparams, prompt, forced):
    logits, caches = TT.prefill_step(
        tparams, {"tokens": torch.from_numpy(prompt).long()}, tcfg,
        max_seq=S + N)
    out = [logits[:, 0].numpy()]
    for i in range(N - 1):
        logits, caches = TT.decode_step(
            tparams, caches, torch.from_numpy(forced[:, i:i + 1]).long(),
            S + i, tcfg)
        out.append(logits[:, 0].numpy())
    return np.stack(out)


def _check_greedy_against_reference(jcfg, tcfg, jparams, tparams, prompt):
    """Greedy tokens of both engines, and teacher-forced logits; returns the
    port's forced logits (N, B, V)."""
    ref_tokens = np.array(JE.Engine(jcfg, jparams, max_seq=S + N).generate(
        {"tokens": jnp.asarray(prompt)}, N))
    eng = TE.Engine(tcfg, tparams, max_seq=S + N)
    tokens = eng.generate({"tokens": torch.from_numpy(prompt).long()}, N)
    assert tokens.dtype == torch.int32 and tokens.shape == (2, N)
    assert eng.last_decode_steps == N - 1 == eng.dispatched_decode_steps

    # teacher forcing: both packages fed the reference's tokens
    ref = _reference_step_logits(jcfg, jparams, prompt, ref_tokens)
    ours = _port_step_logits(tcfg, tparams, prompt, ref_tokens)
    np.testing.assert_allclose(ours, ref, atol=TOL, rtol=TOL)

    top2 = np.sort(ref, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * TOL       # (N, B)
    assert clear.sum() >= N, "too few steps with a clear argmax to compare"
    forced_argmax = ours.argmax(-1)
    np.testing.assert_array_equal(forced_argmax[clear], ref_tokens.T[clear])
    # free-running tokens agree up to each row's first unclear step
    for b in range(2):
        n_clear = int(np.argmin(clear[:, b])) if not clear[:, b].all() else N
        np.testing.assert_array_equal(tokens[b, :n_clear].numpy(),
                                      ref_tokens[b, :n_clear])
    return ours


def test_greedy_engine_matches_reference(setup):
    _check_greedy_against_reference(*setup)


def test_windowed_greedy_engine_matches_reference(setup):
    """``attn_window=96`` below the 256-token prompt: the prefill runs the
    block-sparse forward (its plain version here) and decode keeps the last
    96 positions, as the reference's ``_sdpa_decode(window=)`` does."""
    jcfg, tcfg, jparams, tparams, prompt = setup
    ours = _check_greedy_against_reference(
        jcfg.replace(attn_window=96), tcfg.replace(attn_window=96), jparams,
        tparams, prompt)
    forced = np.array(JE.Engine(jcfg, jparams, max_seq=S + N).generate(
        {"tokens": jnp.asarray(prompt)}, N))
    full = _port_step_logits(tcfg, tparams, prompt, forced)
    windowed = _port_step_logits(tcfg.replace(attn_window=96), tparams,
                                 prompt, forced)
    assert np.abs(windowed - full).max() > 1e-3      # the window is honored
    assert ours.shape == windowed.shape


def test_top_k_keeps_exactly_k_lowest_id_ties():
    logits = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 0.5],
                       [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]], np.float32)
    for k in (1, 2, 4):
        scfg_j = JE.SampleConfig(temperature=0.5, top_k=k)
        scfg_t = TE.SampleConfig(temperature=0.5, top_k=k)
        ref = np.asarray(JE._transform_logits(jnp.asarray(logits), scfg_j))
        out = TE._transform_logits(torch.from_numpy(logits), scfg_t).numpy()
        np.testing.assert_array_equal(out, ref)
        assert ((out > -1e29).sum(-1) == k).all()


def test_sampled_generation_is_seeded(setup):
    _, tcfg, _, tparams, prompt = setup
    batch = {"tokens": torch.from_numpy(prompt[:, :128]).long()}

    def run(seed):
        scfg = TE.SampleConfig(temperature=1.0, top_k=50, seed=seed)
        return TE.Engine(tcfg, tparams, 160, scfg).generate(batch, 12)

    a, b, c = run(7), run(7), run(8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_eos_is_sticky_and_all_done_exits_early(setup):
    _, tcfg, _, tparams, prompt = setup
    batch = {"tokens": torch.from_numpy(prompt[:1, :128]).long()}
    free = TE.Engine(tcfg, tparams, max_seq=160)
    a = free.generate(batch, 16).numpy()
    assert free.last_decode_steps == 15
    eos = int(a[0, 1])                       # greedy emits this at step 1
    eng = TE.Engine(tcfg, tparams, max_seq=160, scfg=TE.SampleConfig(eos_id=eos))
    b = eng.generate(batch, 16).numpy()
    k = int(np.where(a[0] == eos)[0][0])
    np.testing.assert_array_equal(b[0, :k + 1], a[0, :k + 1])
    assert (b[0, k:] == eos).all()
    assert eng.last_decode_steps == k
    assert eng.dispatched_decode_steps < 15


def test_engine_refuses_overlong_request(setup):
    _, tcfg, _, tparams, prompt = setup
    eng = TE.Engine(tcfg, tparams, max_seq=S)
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate({"tokens": torch.from_numpy(prompt).long()}, 4)


def test_launcher_runs_on_cpu_and_refuses_ragged_prompts():
    tokens = tlaunch.main(["--reduced", "--device", "cpu", "--batch", "1",
                           "--prompt-len", "128", "--gen", "4"])
    assert tokens.shape == (1, 4)
    with pytest.raises(SystemExit):
        tlaunch.main(["--reduced", "--device", "cpu", "--prompt-len", "100"])
    windowed = tlaunch.main(["--reduced", "--device", "cpu", "--batch", "1",
                             "--prompt-len", "128", "--gen", "4",
                             "--attn-window", "32"])
    assert windowed.shape == (1, 4)
