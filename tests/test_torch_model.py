"""Port parity for the model: ``forward`` and ``prefill_step`` logits of
``repro_torch.models.transformer`` against ``repro.models.transformer`` on the
reduced StableLM config (2 layers), with the reference's weights bridged by
``repro_torch.models.convert.from_jax_params`` and the same token ids.

The reference runs its plain attention (``"xla"``); the port runs both of its
impls on the CPU — ``"torch"`` and ``"cuda"`` (whose CPU path is the kernel's
plain version) — with and without GQA.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import registry as tregistry
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import from_jax_params

S = 256
# fp32: the reference's fp32 tolerance (tests/test_kernels.py:22); measured
# max |Δ| ~1e-6 at logits of magnitude ~1. bf16: the reference's bf16 kernel
# tolerance; the packages round to bf16 at the same points but from fp32
# values summed in different orders (measured max |Δ| ~5e-3).
TOLS = {"float32": dict(atol=2e-5, rtol=2e-5),
        "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _cfgs(dtype, impl, n_kv_heads):
    kw = dict(n_layers=2, dtype_name=dtype, n_kv_heads=n_kv_heads)
    jcfg = jregistry.get("stablelm-1.6b").reduced(attention_impl="xla", **kw)
    tcfg = tregistry.get("stablelm-1.6b").reduced(attention_impl=impl, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 512, (2, S)).astype(np.int32)


def _setup(dtype, impl, n_kv_heads):
    jcfg, tcfg = _cfgs(dtype, impl, n_kv_heads)
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("n_kv_heads", [4, 2])
def test_forward_and_prefill_match_reference(tokens, dtype, impl, n_kv_heads):
    jcfg, tcfg, jparams, tparams = _setup(dtype, impl, n_kv_heads)
    jt, tt = jnp.asarray(tokens), torch.from_numpy(tokens).long()
    jlogits, _ = JT.forward(jparams, {"tokens": jt}, jcfg)
    jlast, _, _ = JT.prefill_step(jparams, {"tokens": jt}, jcfg, max_seq=S + 8)
    with torch.inference_mode():
        tlogits, aux = TT.forward(tparams, {"tokens": tt}, tcfg)
        tlast, caches = TT.prefill_step(tparams, {"tokens": tt}, tcfg,
                                        max_seq=S + 8)
    assert tlogits.shape == (2, S, tcfg.padded_vocab)
    assert tlast.shape == (2, 1, tcfg.padded_vocab)
    assert float(aux) == 0.0
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits, np.float32),
                               **TOLS[dtype])
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast, np.float32),
                               **TOLS[dtype])
    k_cache, _ = caches["b0_attn"]["attn"]
    assert k_cache.shape == (2, 2, S + 8, n_kv_heads, 32)
    assert not k_cache[:, :, S:].any()          # positions past the prompt


def _packed_batch():
    """B=1, S=64: two 32-token documents, positions restarting at 0."""
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 512, (1, 64)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.full((1, 1), -100, np.int32)],
                            axis=1)
    segment_ids = np.repeat(np.arange(2, dtype=np.int32), 32)[None]
    positions = np.tile(np.arange(32, dtype=np.int32), 2)[None]
    return dict(tokens=tokens, labels=labels, segment_ids=segment_ids,
                positions=positions)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_packed_batch_matches_reference(dtype, impl):
    """A packed batch's ``positions`` and ``segment_ids`` reach every layer's
    RoPE and attention, with and without remat (the reference reads both
    keys in ``_forward_body``)."""
    jcfg, tcfg, jparams, tparams = _setup(dtype, impl, 4)
    batch = _packed_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    jlogits, _ = JT.forward(jparams, jbatch, jcfg)
    jloss, _ = JT.loss_fn(jparams, jbatch, jcfg, remat=True)
    tlogits, _ = TT.forward(tparams, tbatch, tcfg)
    tloss, _ = TT.loss_fn(tparams, tbatch, tcfg, remat=True)
    np.testing.assert_allclose(tlogits.detach().numpy(),
                               np.asarray(jlogits, np.float32), **TOLS[dtype])
    np.testing.assert_allclose(float(tloss), float(jloss), **TOLS[dtype])
    # the second document is its own sequence: it equals the reference's
    # forward of its tokens alone, and not the unpacked forward of the batch
    alone, _ = JT.forward(jparams, {"tokens": jbatch["tokens"][:, 32:]}, jcfg)
    unpacked, _ = JT.forward(jparams, {"tokens": jbatch["tokens"]}, jcfg)
    second = tlogits[:, 32:].detach().numpy()
    np.testing.assert_allclose(second, np.asarray(alone, np.float32),
                               **TOLS[dtype])
    assert np.abs(second - np.asarray(unpacked[:, 32:], np.float32)).max() > 0.1


@pytest.mark.parametrize("pct", [1.0, 0.25])
def test_rope_matches_reference(pct):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 4, 32)).astype(np.float32)
    pos = np.arange(16, dtype=np.int32)[None, :] + 5
    ref = JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, pct)
    out = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0, pct)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_norm_matches_reference(norm):
    jcfg, tcfg = _cfgs("float32", "torch", 4)
    jcfg, tcfg = jcfg.replace(norm=norm), tcfg.replace(norm=norm)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 128)).astype(np.float32) * 3 + 1
    p = {k: rng.standard_normal(128).astype(np.float32)
         for k in JL.norm_defs(jcfg)}
    ref = JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), jcfg)
    out = TL.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                        torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_learned_position_embeddings_raise_naming_a8():
    _, tcfg = _cfgs("float32", "torch", 4)
    assert tcfg.pos_embed == "rope"
    TT.param_defs(tcfg.replace(pos_embed="none"))
    with pytest.raises(NotImplementedError, match="ROADMAP A8"):
        TT.param_defs(tcfg.replace(pos_embed="learned"))


def test_unported_configs_raise():
    _, tcfg = _cfgs("float32", "torch", 4)
    with pytest.raises(NotImplementedError, match="not ported"):
        TT.param_defs(tcfg.replace(block_pattern=("attn", "attn_cross")))
    with pytest.raises(NotImplementedError, match="not ported"):
        TT.forward(TT.init(tcfg, device="cpu"),
                   {"tokens": torch.zeros((1, 128), dtype=torch.long)},
                   tcfg.replace(block_pattern=("attn_cross",)))
    with pytest.raises(NotImplementedError, match="not ported"):
        tregistry.get("whisper-base")
