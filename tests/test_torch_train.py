"""Port parity for the training slice on the reduced StableLM config: the
loss and every gradient leaf against ``jax.grad`` of the reference's
``loss_fn``, one AdamW step (and one with two microbatches) against the
reference's ``make_train_step``, the deterministic embedding backward, the
state digests, the data source and the launcher; plus the port's own
bitwise contract (two runs of three steps give equal digest chains). The
windowed slice (``attn_window``, with the query-chunked plain attention) is
held to the reference's loss and grads the same way.

The reference's weights are bridged with ``from_jax_params`` and its
batches fed to both packages. The reference runs its plain attention
(``"xla"``): its Pallas path runs on the CPU only in interpret mode. The
port runs ``"torch"`` and ``"cuda"`` (whose CPU path is the kernels' plain
versions). Numerics compare in fp32, where the point is the algorithm: a
bf16 step at these sizes rounds most updates back to the old weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train import optimizer as JO
from repro.train import step as JS
from repro.verify import digest as JD
from repro_torch.configs import registry as tregistry
from repro_torch.data.pipeline import (DataConfig, MemmapCorpus, SyntheticLM,
                                       make_source)
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.convert import from_jax_params
from repro_torch.models.module import set_path, tree_paths
from repro_torch.train import optimizer as TO
from repro_torch.train import step as TS
from repro_torch.verify import digest as TD

S = 128
# fp32, summation order only (measured: loss ~6.25 equal, grads max |Δ| 4e-8
# at |g| <= 0.04); 2e-5 is the reference's fp32 kernel tolerance
LOSS_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-5, rtol=2e-4)


def _cfgs(impl, dtype="float32", **kw):
    kw = dict(n_layers=2, dtype_name=dtype, **kw)
    return (jregistry.get("stablelm-1.6b").reduced(attention_impl="xla", **kw),
            tregistry.get("stablelm-1.6b").reduced(attention_impl=impl, **kw))


def _batch(b=2, seed=0, s=S):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 512, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :5] = -100                      # masked targets
    return ({"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(labels)},
            {"tokens": torch.from_numpy(toks[:, :-1]).long(),
             "labels": torch.from_numpy(labels).long()})


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
        o = ours[path]
        assert tuple(o.shape) == r.shape, path
        np.testing.assert_allclose(o.float().numpy(), r.astype(np.float32),
                                   err_msg=path, **tol)


@pytest.fixture(scope="module")
def setup():
    jcfg, _ = _cfgs("torch")
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    return jparams, _batch()


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_loss_and_grads_match_reference(setup, impl):
    jparams, (jb, tb) = setup
    jcfg, tcfg = _cfgs(impl)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jb, jcfg, remat=True), has_aux=True)(jparams)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    paths = [p for p, _ in tree_paths(tparams)]
    leaves = [x.requires_grad_(True) for x in TO.tree_leaves(tparams)]
    loss, metrics = TT.loss_fn(tparams, tb, tcfg, remat=True)
    grads = dict(zip(paths, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS_TOL)
    assert float(metrics["aux"]) == 0.0
    gtree = {}
    for p, g in grads.items():
        set_path(gtree, p, g)
    _close_trees(gtree, jgrads, **GRAD_TOL)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_adamw_step_matches_reference(setup, microbatches):
    """One step with warmup_steps=1 (so the first step moves the weights):
    new params and both moments, leaf by leaf, and loss/grad-norm/lr."""
    jparams, (jb, tb) = setup
    jcfg, tcfg = _cfgs("cuda")
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
    assert int(tnew["step"]) == 1 and tnew["step"].dtype == torch.int32
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               **LOSS_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               atol=2e-5, rtol=2e-4)
    assert tm["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
    # params move by ~lr = 1e-3 a step; fp32 grads agree to ~1e-6
    _close_trees(tnew["params"], jnew["params"], atol=2e-5, rtol=2e-5)
    _close_trees(tnew["opt"]["m"], jnew["opt"]["m"], atol=2e-6, rtol=2e-4)
    _close_trees(tnew["opt"]["v"], jnew["opt"]["v"], atol=1e-9, rtol=1e-3)
    moved = sum(int((a != b).sum()) for (_, a), (_, b) in
                zip(_leaves(tnew["params"]), _leaves(tstate["params"])))
    assert moved > 0.9 * sum(x.numel() for _, x in _leaves(tnew["params"]))


def test_embedding_backward_matches_reference(monkeypatch):
    """Duplicate tokens, several fixed token blocks plus padding (the
    one-hot budget is shrunk in both packages so the multi-block path runs
    at a small vocab); the port's grad equals the reference's to fp32
    rounding, and equals the dense scatter-add."""
    monkeypatch.setattr(JL, "_EMBED_BWD_ELEMS", 1 << 13)
    monkeypatch.setattr(TL, "_EMBED_BWD_ELEMS", 1 << 13)
    vocab, d = 512, 16                        # block = max(64, 16) = 64
    rng = np.random.default_rng(1)
    table = rng.standard_normal((vocab, d)).astype(np.float32)
    tokens = rng.integers(0, 40, (3, 70)).astype(np.int32)   # 210 tokens
    dy = rng.standard_normal((3, 70, d)).astype(np.float32)
    jcfg, tcfg = _cfgs("torch")
    _, pull = jax.vjp(lambda t: JL.apply_embed({"tok": t},
                                               jnp.asarray(tokens), jcfg),
                      jnp.asarray(table))
    (want,) = pull(jnp.asarray(dy))
    t = torch.from_numpy(table).requires_grad_(True)
    out = TL.apply_embed({"tok": t}, torch.from_numpy(tokens).long(), tcfg)
    (got,) = torch.autograd.grad(out, t, torch.from_numpy(dy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    dense = np.zeros_like(table)
    np.add.at(dense, tokens.reshape(-1), dy.reshape(-1, d))
    np.testing.assert_allclose(got.numpy(), dense, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_digests_match_reference(dtype):
    jcfg, tcfg = _cfgs("torch", dtype)
    jparams = JT.init(jcfg, jax.random.PRNGKey(3))
    jstate = {"params": jparams,
              "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": from_jax_params(jax.tree.map(np.asarray, jparams),
                                        tcfg, device="cpu"),
              "step": torch.zeros((), dtype=torch.int32)}
    assert TD.tree_leaf_digests(tstate) == JD.tree_leaf_digests(jstate)
    assert TD.tree_digest(tstate) == JD.tree_digest(jstate)
    chain = TD.DigestChain()
    chain.append(1, tstate)
    assert TD.DigestChain.from_json(chain.to_json()) == chain


def test_three_steps_twice_give_equal_digest_chains():
    """The port's determinism contract on the CPU path of the kernels: two
    runs from one seed agree bitwise after every step, and the weights
    move (bf16, warmup 1, as the card's train phase runs)."""
    _, tcfg = _cfgs("cuda", "bfloat16")
    tt = TS.TrainConfig(opt=TO.OptConfig(warmup_steps=1))
    data = SyntheticLM(DataConfig(seed=0, batch=2, seq=S, vocab=tcfg.vocab))
    chains = []
    for _ in range(2):
        state = TS.init_state(tcfg, tt, seed=0, device="cpu")
        first = {p: x.clone() for p, x in _leaves(state["params"])}
        step = TS.make_train_step(tcfg, tt)
        chain = TD.DigestChain()
        for i in range(3):
            state, _ = step(state, data.batch(i))
            chain.append(i + 1, state)
        chains.append(chain)
    assert chains[0] == chains[1] and len(chains[0]) == 3
    moved = sum(int((x != first[p]).sum()) for p, x in
                _leaves(state["params"]))
    assert moved > 0


def test_synthetic_batches_are_pure_functions_of_seed_and_step(tmp_path):
    cfg = DataConfig(seed=4, batch=4, seq=16, vocab=100)
    src = make_source(cfg)
    a, b, c = src.batch(2), src.batch(2), src.batch(3)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], c["tokens"])
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    halves = [SyntheticLM(DataConfig(seed=4, batch=4, seq=16, vocab=100,
                                     host_index=i, host_count=2)).batch(2)
              for i in range(2)]
    assert torch.equal(torch.cat([h["tokens"] for h in halves]), a["tokens"])
    # a path selects the memmap corpus; it never falls back to synthetic
    path = tmp_path / "tokens.bin"
    np.arange(100, dtype=np.uint32).tofile(path)
    assert isinstance(make_source(DataConfig(path=str(path), seq=16)),
                      MemmapCorpus)
    with pytest.raises(FileNotFoundError):
        make_source(DataConfig(path=str(tmp_path / "missing.bin")))


def test_train_launcher_runs_on_the_cpu(capsys):
    summary = tlaunch.main(["--reduced", "--device", "cpu", "--steps", "2",
                            "--batch", "2", "--seq", "128", "--verify",
                            "--profile-step", "2"])
    out = capsys.readouterr().out.strip().splitlines()
    assert np.isfinite(summary["final_loss"])
    assert len(summary["step_ms"]) == 2 and summary["profile"]["ops"] > 0
    assert '"final_step": 2' in out[-1] and "digest_chain_head" in out[-1]
    assert not torch.are_deterministic_algorithms_enabled()
    ada = tlaunch.main(["--reduced", "--device", "cpu", "--steps", "1",
                        "--batch", "2", "--seq", "128", "--opt", "adafactor"])
    assert np.isfinite(ada["final_loss"])


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_windowed_loss_and_grads_match_reference(setup, impl):
    """``attn_window=96`` with ``attn_chunk_q=128`` at S=256: the reference's
    plain attention takes its query-chunked path with the window mask per
    chunk; the port's ``"torch"`` takes its chunked path and ``"cuda"`` the
    block-sparse forward and the masked DASH backward (plain versions)."""
    jparams, _ = setup
    kw = dict(attn_window=96, attn_chunk_q=128)
    jcfg, tcfg = _cfgs(impl, **kw)
    jb, tb = _batch(s=256, seed=2)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jb, jcfg, remat=True), has_aux=True)(jparams)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    paths = [p for p, _ in tree_paths(tparams)]
    leaves = [x.requires_grad_(True) for x in TO.tree_leaves(tparams)]
    loss, _ = TT.loss_fn(tparams, tb, tcfg, remat=True)
    grads = dict(zip(paths, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **LOSS_TOL)
    gtree = {}
    for p, g in grads.items():
        set_path(gtree, p, g)
    _close_trees(gtree, jgrads, **GRAD_TOL)
    # the window matters: the full causal loss differs
    full, _ = TT.loss_fn(tparams, tb, tcfg.replace(attn_window=0))
    assert abs(float(full.detach()) - float(loss.detach())) > 1e-4


def test_train_launcher_takes_a_window(capsys):
    args, cfg, *_ = tlaunch.configure(["--reduced", "--device", "cpu",
                                       "--attn-window", "96"])
    assert cfg.attn_window == 96 and args.attn_window == 96
    assert tlaunch.configure(["--reduced", "--device", "cpu"])[1].attn_window \
        == 0
    summary = tlaunch.main(["--reduced", "--device", "cpu", "--steps", "2",
                            "--batch", "1", "--seq", "256", "--attn-window",
                            "96", "--verify"])
    assert np.isfinite(summary["final_loss"])
    assert "digest_chain_head" in capsys.readouterr().out.splitlines()[-1]
    with pytest.raises(SystemExit):
        tlaunch.configure(["--reduced", "--device", "cpu", "--attn-window",
                           "-1"])
