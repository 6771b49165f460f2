"""Port parity for Adafactor: the factored state's structure, one update on
identical grads, state and params against the reference's (fp32 2e-5), the
toy quadratic the reference's substrate test minimises, bf16 state, and an
Adafactor train step on the reduced model."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.train import optimizer as JO
from repro.train import step as JS
from repro_torch.configs import registry as tregistry
from repro_torch.models.convert import from_jax_params
from repro_torch.train import optimizer as TO
from repro_torch.train import step as TS

TOL = dict(atol=2e-5, rtol=2e-5)


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], path)
        else:
            yield path, tree[key]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(ours, ref, **tol):
    ref, ours = dict(_leaves(ref)), dict(_leaves(ours))
    assert sorted(ours) == sorted(ref)
    for path, r in ref.items():
        assert tuple(ours[path].shape) == tuple(r.shape), path
        np.testing.assert_allclose(_np(ours[path]), _np(r), err_msg=path,
                                   **tol)


def _tree(seed, scale=1.0):
    """Leaves of rank 0-3 (factored from rank 2 up)."""
    rng = np.random.default_rng(seed)
    return {"w": (rng.standard_normal((6, 5)) * scale).astype(np.float32),
            "stack": {"k": (rng.standard_normal((2, 4, 7)) * scale)
                      .astype(np.float32)},
            "b": (rng.standard_normal(5) * scale).astype(np.float32),
            "s": np.array(rng.standard_normal() * scale, np.float32)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_init_structure_matches_reference(state_dtype):
    p = _tree(0)
    cfg = dict(name="adafactor", state_dtype=state_dtype)
    ours = TO.opt_init(TO.OptConfig(**cfg), jax.tree.map(torch.from_numpy, p))
    ref = JO.opt_init(JO.OptConfig(**cfg), jax.tree.map(jnp.asarray, p))
    assert set(ours) == {"f"}
    ol, rl = dict(_leaves(ours)), dict(_leaves(ref))
    assert sorted(ol) == sorted(rl)
    assert "f/w/vr" in ol and "f/w/vc" in ol and "f/b/v" in ol
    for path, r in rl.items():
        assert tuple(ol[path].shape) == tuple(r.shape), path
        assert str(ol[path].dtype).removeprefix("torch.") == str(r.dtype)
        assert not ol[path].any()


@pytest.mark.parametrize("step", [0, 7])
def test_one_update_matches_reference(step):
    """Identical grads, state (non-zero second moments) and params; clipping
    on (the grads' norm exceeds clip_norm) and weight decay on."""
    cfg = dict(name="adafactor", lr=1e-2, warmup_steps=3, total_steps=20,
               clip_norm=1.0, weight_decay=0.1)
    p, g = _tree(1), _tree(2, scale=0.7)
    state_np = {"f": {"w": {"vr": np.abs(_tree(3)["w"]).mean(-1),
                            "vc": np.abs(_tree(4)["w"]).mean(-2)},
                      "stack": {"k": {"vr": np.abs(_tree(5)["stack"]["k"])
                                      .mean(-1),
                                      "vc": np.abs(_tree(6)["stack"]["k"])
                                      .mean(-2)}},
                      "b": {"v": np.abs(_tree(7)["b"])},
                      "s": {"v": np.array(abs(_tree(8)["s"]))}}}
    to_t, to_j = (lambda t: jax.tree.map(torch.from_numpy, t),
                  lambda t: jax.tree.map(jnp.asarray, t))
    tp, ts, tn = TO.opt_update(TO.OptConfig(**cfg), to_t(g), to_t(state_np),
                               to_t(p), step)
    jp, js, jn = JO.opt_update(JO.OptConfig(**cfg), to_j(g), to_j(state_np),
                               to_j(p), jnp.asarray(step, jnp.int32))
    np.testing.assert_allclose(float(tn), float(jn), **TOL)
    assert float(jn) > 1.0                    # the clip is active
    _close(tp, jp, **TOL)
    _close(ts, js, **TOL)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_reduces_quadratic(state_dtype):
    """tests/test_train_substrate.py's toy problem, on the port."""
    cfg = TO.OptConfig(name="adafactor", lr=0.05, warmup_steps=5,
                       total_steps=200, weight_decay=0.0, clip_norm=10.0,
                       state_dtype=state_dtype)
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((8, 4), generator=gen),
              "b": torch.zeros(4)}
    target = {"w": torch.randn((8, 4), generator=gen),
              "b": torch.randn(4, generator=gen)}
    state = TO.opt_init(cfg, params)
    assert all(x.dtype == getattr(torch, state_dtype)
               for _, x in _leaves(state))

    def loss(p):
        return sum(torch.sum((p[k] - target[k]) ** 2) for k in p)

    l0 = float(loss(params))
    for i in range(150):
        leaves = {k: v.detach().requires_grad_(True) for k, v in
                  params.items()}
        grads = dict(zip(leaves, torch.autograd.grad(loss(leaves),
                                                     list(leaves.values()))))
        params, state, _ = TO.opt_update(cfg, grads, state, params, i)
    assert float(loss(params)) < 0.05 * l0


def test_adafactor_train_step_matches_reference():
    """One fp32 Adafactor step (warmup 1) on the reduced model: params and
    factored state leaf by leaf."""
    kw = dict(n_layers=2, dtype_name="float32")
    jcfg = jregistry.get("stablelm-1.6b").reduced(attention_impl="xla", **kw)
    tcfg = tregistry.get("stablelm-1.6b").reduced(attention_impl="cuda", **kw)
    opt = dict(name="adafactor", warmup_steps=1, lr=1e-3)
    jt = JS.TrainConfig(opt=JO.OptConfig(**opt))
    tt = TS.TrainConfig(opt=TO.OptConfig(**opt))
    jstate = JS.init_state(jcfg, jt, jax.random.PRNGKey(0))
    tstate = TS.state_from_params(from_jax_params(
        jax.tree.map(np.asarray, jstate["params"]), tcfg, device="cpu"), tt)
    toks = np.random.default_rng(0).integers(0, 512, (2, 129)).astype(
        np.int32)
    jnew, jm = JS.make_train_step(jcfg, jt)(
        jstate, {"tokens": jnp.asarray(toks[:, :-1]),
                 "labels": jnp.asarray(toks[:, 1:])})
    tnew, tm = TS.make_train_step(tcfg, tt)(
        tstate, {"tokens": torch.from_numpy(toks[:, :-1]).long(),
                 "labels": torch.from_numpy(toks[:, 1:]).long()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    _close(tnew["params"], jnew["params"], **TOL)
    _close(tnew["opt"], jnew["opt"], atol=1e-9, rtol=1e-3)
