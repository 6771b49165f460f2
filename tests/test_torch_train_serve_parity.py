"""Train ≡ serve parity in the port: the canonical training forward IS the
continuous engine's chunked prefill.

``ModelConfig.canonical_reductions = N`` runs ``forward`` under the port's
canonical scope (``dist/fold.py``): attention walks the serve kernel's pages
(N tokens a page) and every product and norm takes its row-invariant form.
Its logits must be bitwise the engine's captured prefill logits at
``page_size=N``, per prompt position, for each of the reference's parity
archs, packed or not, any GQA group; and within the reference's tolerances
of ``repro``'s own ``forward(canonical_reductions=8)``. Weights come from
``repro.models.transformer.init(PRNGKey(0))`` through ``models/convert.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import transformer as JT
from repro_torch.configs import registry as tregistry
from repro_torch.models import transformer as TT
from repro_torch.models.convert import from_jax_params
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.verify import lifecycle as L

PAGE = 8
PROMPT_LENS = (5, 13, 32, 7)
ARCHS = ("stablelm-1.6b", "qwen1.5-110b", "mistral-nemo-12b")
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _models(arch, seed=0, **kw):
    jcfg = jregistry.get(arch).reduced(**kw)
    tcfg = tregistry.get(arch).reduced(**kw)
    jparams = JT.init(jcfg, jax.random.PRNGKey(seed))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(cfg, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, cfg.vocab, size=n).tolist() for n in PROMPT_LENS]


def _serve_prefill(cfg, params, prompts):
    eng = ContinuousEngine(cfg, params, n_slots=2, max_seq=64, page_size=PAGE,
                           prefill_chunk=16, capture_prefill_logits=True)
    for i, p in enumerate(prompts):
        eng.submit(p, req_id=i, max_new_tokens=1)
    eng.run()
    return eng


def _train_logits(cfg, params, batch):
    pcfg = cfg.replace(canonical_reductions=PAGE)
    return TT.forward(params, batch, pcfg)[0]


def _tokens(p):
    return torch.tensor([p], dtype=torch.int64)


@pytest.mark.parametrize("arch", ARCHS)
def test_unpacked_parity(arch):
    """Per arch (GQA 1, 4/1 and 4/1 with head_dim set, QKV bias): the
    canonical forward's logits equal the engine's prefill logits bitwise."""
    _, tcfg, _, tparams = _models(arch)
    prompts = _prompts(tcfg)
    eng = _serve_prefill(tcfg, tparams, prompts)
    for i, p in enumerate(prompts):
        logits = _train_logits(tcfg, tparams, {"tokens": _tokens(p)})[0]
        np.testing.assert_array_equal(logits.numpy(), eng.prefill_logits[i],
                                      err_msg=f"{arch} req {i}")


@pytest.mark.parametrize("kv_heads", [4, 2])
def test_gqa_groups_parity(kv_heads):
    _, tcfg, _, tparams = _models("stablelm-1.6b", seed=1, n_kv_heads=kv_heads)
    prompts = _prompts(tcfg, seed=1)
    eng = _serve_prefill(tcfg, tparams, prompts)
    for i, p in enumerate(prompts):
        logits = _train_logits(tcfg, tparams, {"tokens": _tokens(p)})[0]
        np.testing.assert_array_equal(logits.numpy(), eng.prefill_logits[i],
                                      err_msg=f"kv={kv_heads} req {i}")


def test_packed_parity():
    """A packed row (two documents, RoPE restarting, segment-masked
    attention) gives, per document, the logits the engine gives serving each
    document as its own request."""
    _, tcfg, _, tparams = _models("stablelm-1.6b")
    rng = np.random.RandomState(2)
    docs = [rng.randint(1, tcfg.vocab, size=n).tolist() for n in (7, 9)]
    pk = tcfg.replace(packed_inputs=True)
    batch = {
        "tokens": torch.tensor([docs[0] + docs[1]], dtype=torch.int64),
        "positions": torch.tensor([list(range(7)) + list(range(9))]),
        "segment_ids": torch.tensor([[1] * 7 + [2] * 9])}
    packed = _train_logits(pk, tparams, batch)[0].numpy()
    eng = _serve_prefill(tcfg, tparams, docs)
    off = 0
    for j, d in enumerate(docs):
        np.testing.assert_array_equal(packed[off:off + len(d)],
                                      eng.prefill_logits[j],
                                      err_msg=f"doc {j}")
        off += len(d)


def test_windowed_serve_equals_windowed_train_generation():
    """Greedy engine decode under a window equals teacher-forced argmax
    generation from the canonical forward."""
    _, tcfg, _, tparams = _models("stablelm-1.6b")
    tcfg = tcfg.replace(attn_window=8)
    prompts = _prompts(tcfg)
    eng = ContinuousEngine(tcfg, tparams, n_slots=4, max_seq=64,
                           page_size=PAGE, prefill_chunk=16)
    for i, p in enumerate(prompts):
        eng.submit(p, req_id=i, max_new_tokens=6)
    served = eng.run()
    for i, p in enumerate(prompts):
        seq = list(p)
        for _ in range(6):
            lg = _train_logits(tcfg, tparams, {"tokens": _tokens(seq)})[0]
            seq.append(int(torch.argmax(lg[len(seq) - 1])))
        np.testing.assert_array_equal(np.asarray(seq[len(p):], np.int32),
                                      served[i], err_msg=f"req {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_canonical_forward_matches_reference(arch, dtype):
    """The port's canonical forward within the reference's tolerance of
    ``repro``'s ``forward(canonical_reductions=8)``, packed row included."""
    jcfg, tcfg, jparams, tparams = _models(arch, n_layers=2,
                                           dtype_name=dtype)
    prompt = _prompts(tcfg)[2]
    jc = jcfg.replace(canonical_reductions=PAGE)
    want = np.asarray(JT.forward(jparams, {"tokens": jnp.asarray(
        np.asarray(prompt, np.int32)[None])}, jc)[0].astype(jnp.float32))
    got = _train_logits(tcfg, tparams, {"tokens": _tokens(prompt)})
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_canonical_forward_has_no_gradient():
    _, tcfg, _, tparams = _models("stablelm-1.6b")
    pcfg = tcfg.replace(canonical_reductions=PAGE)
    batch = {"tokens": _tokens([1, 2, 3])}
    tparams["lm_head"]["w"].requires_grad_(True)
    try:
        with pytest.raises(NotImplementedError, match="no gradient"):
            TT.forward(tparams, batch, pcfg)
    finally:
        tparams["lm_head"]["w"].requires_grad_(False)
    with pytest.raises(NotImplementedError, match="no gradient"):
        TT.forward(tparams, batch, pcfg, remat=True)
    logits, _ = TT.forward(tparams, batch, pcfg)
    assert not logits.requires_grad


def test_lifecycle_cell_is_conformant(capsys):
    """The ``train_serve_parity`` lifecycle cell over the reference's
    PARITY_ARCHS, through ``run_cell`` and the module's CLI."""
    assert L.PARITY_ARCHS == ("stablelm-1.6b", "qwen1.5-110b",
                              "mistral-nemo-12b")
    rep = L.run_cell("train_serve_parity", device="cpu")
    assert rep["conformant"] is True and rep["first_divergence"] == {}
    assert set(rep["heads"]) == {f"{a}/{k}" for a in ARCHS
                                 for k in ("train", "serve")}
    assert L.main(["--cells", "train_serve_parity", "--device", "cpu"]) == 0
    assert "[OK ] train_serve_parity" in capsys.readouterr().out
