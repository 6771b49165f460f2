"""Port parity for the packed-document and memmap data sources: the packer's
arrays equal the reference's, ``PackedDocs`` and ``MemmapCorpus`` are pure
functions of (seed, step) whose host slices partition the global batch, and
a packed batch (the reference's ``PackedDocs`` batch, fed to both packages)
gives the reference's loss, logits, grads and AdamW step.

Weights come from the reference's ``init`` through ``from_jax_params``. The
port's streams differ from the reference's (torch generators, not
threefry), so parity is checked on the reference's batches.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.data import pipeline as JP
from repro.models import transformer as JT
from repro.train import optimizer as JO
from repro.train import step as JS
from repro_torch.configs import registry as tregistry
from repro_torch.data import pipeline as TP
from repro_torch.models import transformer as TT
from repro_torch.models.convert import from_jax_params
from repro_torch.models.module import set_path, tree_paths
from repro_torch.train import optimizer as TO
from repro_torch.train import step as TS
from repro_torch.verify.digest import batch_digest

SEQ = 64
# fp32: loss and logits 2e-5, grads 5e-5 (summation order only); bf16 2e-2
TOLS = {"float32": dict(atol=2e-5, rtol=2e-5),
        "bfloat16": dict(atol=2e-2, rtol=2e-2)}
GRAD_TOLS = {"float32": dict(atol=5e-5, rtol=5e-5),
             "bfloat16": dict(atol=2e-2, rtol=2e-2)}


def _docs(seed):
    """Seeded documents of 1..100 tokens for seq=32: single-token docs and
    docs longer than a row (split into pieces) among them."""
    rng = np.random.default_rng(seed)
    lens = list(rng.integers(1, 101, 12)) + [1, 70, 1, 32, 33]
    return [rng.integers(0, 1000, n).astype(np.int64) for n in lens]


@pytest.mark.parametrize("seed", range(4))
def test_pack_documents_equals_reference(seed):
    docs = _docs(seed)
    ours = TP.pack_documents(docs, seq=32, pad_id=7)
    ref = JP.pack_documents(docs, seq=32, pad_id=7)
    assert sorted(ours) == sorted(ref)
    for key in ref:
        assert ours[key].dtype == ref[key].dtype == np.int32, key
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)
    # every token of every document lands once, in order within its doc
    segs = ours["segment_ids"]
    assert sorted(ours["tokens"][segs > 0].tolist()) == sorted(
        np.concatenate(docs).tolist())


def test_pack_documents_rejects_an_empty_document():
    with pytest.raises(ValueError, match="empty"):
        TP.pack_documents([np.arange(3), np.zeros(0)], seq=8)


def test_packed_docs_deterministic_and_host_sliced():
    cfg = TP.DataConfig(seed=3, batch=4, seq=SEQ, vocab=256)
    src = TP.PackedDocs(cfg)
    b1, b2 = src.batch(5), src.batch(5)
    assert batch_digest(b1) == batch_digest(b2)
    assert batch_digest(src.batch(6)) != batch_digest(b1)
    assert set(b1) == {"tokens", "labels", "segment_ids", "positions"}
    assert all(v.shape == (4, SEQ) and v.dtype == torch.int64
               for v in b1.values())
    # more than one document a row, RoPE restarting in each
    assert int(b1["segment_ids"].max()) > 4
    assert int((b1["positions"] == 0).sum()) > 4
    for n_hosts in (2, 4):
        parts = [TP.PackedDocs(TP.DataConfig(seed=3, batch=4, seq=SEQ,
                                             vocab=256, host_index=i,
                                             host_count=n_hosts)).batch(5)
                 for i in range(n_hosts)]
        for key in b1:
            assert torch.equal(torch.cat([p[key] for p in parts]), b1[key])


@pytest.mark.parametrize("min_doc,max_doc", [(40, 30), (16, SEQ + 1),
                                             (SEQ // 2 + 1, None)])
def test_packed_docs_refuses_bad_doc_lengths(min_doc, max_doc):
    """min_doc <= max_doc <= seq, loudly (an empty length range would
    quietly turn packing off)."""
    cfg = TP.DataConfig(seed=0, batch=2, seq=SEQ, vocab=256)
    with pytest.raises(ValueError, match="min_doc <= max_doc <= seq"):
        TP.PackedDocs(cfg, min_doc=min_doc, max_doc=max_doc)


# ------------------------------------------------------------------ memmap
def _corpus(tmp_path, n=1000):
    """A uint32 token file whose token i is 2**31 + i (above int32's range:
    no wrap on the way to int64)."""
    path = tmp_path / "corpus.bin"
    (np.arange(n, dtype=np.uint32) + np.uint32(2**31)).tofile(path)
    return str(path)


def test_memmap_rows_are_windows_of_the_file(tmp_path):
    path = _corpus(tmp_path)
    data = np.fromfile(path, dtype=np.uint32).astype(np.int64)
    seq = 16
    src = TP.make_source(TP.DataConfig(seed=1, batch=6, seq=seq, path=path))
    assert isinstance(src, TP.MemmapCorpus)
    assert src.n_windows == (len(data) - 1) // seq
    starts = set()
    for step in range(3):
        b = src.batch(step)
        assert b["tokens"].dtype == torch.int64
        for row_t, row_l in zip(b["tokens"].numpy(), b["labels"].numpy()):
            s = int(row_t[0] - 2**31)
            assert s % seq == 0 and s // seq < src.n_windows
            np.testing.assert_array_equal(row_t, data[s:s + seq])
            np.testing.assert_array_equal(row_l, data[s + 1:s + seq + 1])
            starts.add(s)
    assert len(starts) > 3                    # windows drawn, not one


def test_memmap_deterministic_and_host_sliced(tmp_path):
    path = _corpus(tmp_path)
    cfg = TP.DataConfig(seed=2, batch=4, seq=16, path=path)
    a = TP.MemmapCorpus(cfg)
    assert batch_digest(a.batch(3)) == batch_digest(TP.MemmapCorpus(cfg)
                                                    .batch(3))
    assert batch_digest(a.batch(3)) != batch_digest(a.batch(4))
    parts = [TP.MemmapCorpus(TP.DataConfig(seed=2, batch=4, seq=16,
                                           path=path, host_index=i,
                                           host_count=2)).batch(3)
             for i in range(2)]
    for key in ("tokens", "labels"):
        assert torch.equal(torch.cat([p[key] for p in parts]),
                           a.batch(3)[key])


# ------------------------------------------------- packed loss, grads, step
def _cfgs(impl, dtype):
    kw = dict(n_layers=2, dtype_name=dtype, packed_inputs=True)
    return (jregistry.get("stablelm-1.6b").reduced(attention_impl="xla", **kw),
            tregistry.get("stablelm-1.6b").reduced(attention_impl=impl, **kw))


@pytest.fixture(scope="module")
def packed():
    """The reference's packed batch (PackedDocs, seed 0, step 1) and its
    reduced weights (seed 0)."""
    jcfg, _ = _cfgs("torch", "float32")
    jb = JP.PackedDocs(JP.DataConfig(seed=0, batch=2, seq=SEQ,
                                     vocab=jcfg.vocab)).batch(1)
    nb = {k: np.asarray(v) for k, v in jb.items()}
    assert nb["segment_ids"].max() > 2           # several documents
    return JT.init(jcfg, jax.random.PRNGKey(0)), nb


def _both(nb):
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(np.array(v)).long() for k, v in nb.items()})


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], path)
        else:
            yield path, tree[key]


def _close_trees(ours, ref, **tol):
    ref = dict(_leaves(jax.tree.map(np.asarray, ref)))
    ours = dict(_leaves(ours))
    assert sorted(ours) == sorted(ref)
    for path, r in ref.items():
        np.testing.assert_allclose(ours[path].float().numpy(),
                                   r.astype(np.float32), err_msg=path, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_packed_loss_logits_and_grads_match_reference(packed, impl, dtype):
    jparams32, nb = packed
    jcfg, tcfg = _cfgs(impl, dtype)
    jparams = (jparams32 if dtype == "float32"
               else JT.init(jcfg, jax.random.PRNGKey(0)))
    jb, tb = _both(nb)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jb, jcfg, remat=True), has_aux=True)(jparams)
    jlogits, _ = JT.forward(jparams, jb, jcfg)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    tlogits, _ = TT.forward(tparams, tb, tcfg)
    np.testing.assert_allclose(tlogits.detach().float().numpy(),
                               np.asarray(jlogits, np.float32), **TOLS[dtype])
    paths = [p for p, _ in tree_paths(tparams)]
    leaves = [x.requires_grad_(True) for x in TO.tree_leaves(tparams)]
    loss, _ = TT.loss_fn(tparams, tb, tcfg, remat=True)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               **TOLS[dtype])
    gtree = {}
    for p, g in zip(paths, torch.autograd.grad(loss, leaves)):
        set_path(gtree, p, g)
    _close_trees(gtree, jgrads, **GRAD_TOLS[dtype])
    # the packing matters: the same tokens unpacked give another loss
    plain = {"tokens": tb["tokens"], "labels": tb["labels"]}
    unpacked, _ = TT.loss_fn(tparams, plain,
                             tcfg.replace(attention_impl="torch"))
    assert abs(float(unpacked.detach()) - float(loss.detach())) > 1e-4


@pytest.mark.parametrize("microbatches", [1, 2])
def test_packed_train_step_matches_reference(packed, microbatches):
    """One fp32 AdamW step (warmup 1) on the packed batch: params and both
    moments leaf by leaf, loss and grad norm."""
    jparams, nb = packed
    jcfg, tcfg = _cfgs("cuda", "float32")
    jb, tb = _both(nb)
    opt = dict(warmup_steps=1, lr=1e-3)
    jt = JS.TrainConfig(opt=JO.OptConfig(**opt), microbatches=microbatches)
    tt = TS.TrainConfig(opt=TO.OptConfig(**opt), microbatches=microbatches)
    jstate = {"params": jparams, "opt": JO.opt_init(jt.opt, jparams),
              "step": jnp.zeros((), jnp.int32)}
    jnew, jm = JS.make_train_step(jcfg, jt)(jstate, jb)
    tstate = TS.state_from_params(
        from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                        device="cpu"), tt)
    tnew, tm = TS.make_train_step(tcfg, tt)(tstate, tb)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               **TOLS["float32"])
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               atol=5e-5, rtol=5e-5)
    _close_trees(tnew["params"], jnew["params"], atol=5e-5, rtol=5e-5)
    _close_trees(tnew["opt"]["m"], jnew["opt"]["m"], atol=5e-6, rtol=5e-4)
    _close_trees(tnew["opt"]["v"], jnew["opt"]["v"], atol=1e-9, rtol=1e-3)
