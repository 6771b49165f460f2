"""Remat policies ``"dots"`` and ``"names"`` (selective checkpointing).

Within the port, every policy recomputes the same values: grads are bitwise
equal to ``remat=True`` with ``"none"`` and to no remat at all. Against the
reference under the same policy (``jax.checkpoint`` with ``dots_saveable``
or ``save_only_these_names``), loss and grads agree to fp32 rounding.

Launches per policy: the DASH forward is a ``torch.autograd.Function`` whose
kernel launch is no dispatched op, so no policy can keep its output — under
remat it runs twice a layer for every policy (once without remat), the
backward once. Counted here by wrapping the op's forward and backward entry
points (the plain versions run on the CPU; the CUDA launch counters stay 0);
``chip_smoke.py``'s lifecycle phase counts the card's launches.
"""
import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as jregistry
from repro.models import transformer as JT
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import ops
from repro_torch.models import transformer as TT
from repro_torch.models.convert import from_jax_params
from repro_torch.models.module import set_path, tree_paths
from repro_torch.train import optimizer as TO

POLICIES = [(False, "none"), (True, "none"), (True, "dots"), (True, "names")]
S = 128


def _cfgs(impl):
    kw = dict(n_layers=2, dtype_name="float32")
    return (jregistry.get("stablelm-1.6b").reduced(attention_impl="xla", **kw),
            tregistry.get("stablelm-1.6b").reduced(attention_impl=impl, **kw))


@pytest.fixture(scope="module")
def setup():
    jcfg, _ = _cfgs("torch")
    jparams = JT.init(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, 512, (2, S + 1)).astype(
        np.int32)
    return jparams, toks


def _grads(tparams, batch, cfg, remat, policy):
    paths = [p for p, _ in tree_paths(tparams)]
    leaves = [x.detach().requires_grad_(True)
              for x in TO.tree_leaves(tparams)]
    tree = {}
    for p, x in zip(paths, leaves):
        set_path(tree, p, x)
    loss, _ = TT.loss_fn(tree, batch, cfg, remat=remat, remat_policy=policy)
    return loss.detach(), dict(zip(paths, torch.autograd.grad(loss, leaves)))


def _batches(toks):
    jb = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    return jb, {k: torch.from_numpy(v.copy()).long() for k, v in jb.items()}


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_policies_give_bitwise_equal_grads(setup, impl):
    jparams, toks = setup
    _, tcfg = _cfgs(impl)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    _, tb = _batches(toks)
    base_loss, base = _grads(tparams, tb, tcfg, True, "none")
    for remat, policy in POLICIES:
        loss, grads = _grads(tparams, tb, tcfg, remat, policy)
        assert torch.equal(loss, base_loss), (remat, policy)
        for path, g in grads.items():
            assert torch.equal(g, base[path]), (remat, policy, path)


@pytest.mark.parametrize("policy", ["dots", "names"])
def test_policy_matches_reference(setup, policy):
    jparams, toks = setup
    jcfg, tcfg = _cfgs("cuda")
    jb, tb = _batches(toks)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jb, jcfg, remat=True, remat_policy=policy),
        has_aux=True)(jparams)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    loss, grads = _grads(tparams, tb, tcfg, True, policy)
    np.testing.assert_allclose(float(loss), float(jloss), atol=2e-5,
                               rtol=2e-5)
    ref = dict(tree_paths(jax.tree.map(np.asarray, jgrads)))
    assert sorted(ref) == sorted(grads)
    for path, r in ref.items():
        np.testing.assert_allclose(grads[path].numpy(), r, atol=5e-5,
                                   rtol=5e-5, err_msg=path)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_attention_launches_per_policy(setup, impl, monkeypatch):
    jparams, toks = setup
    _, tcfg = _cfgs(impl)
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    _, tb = _batches(toks)
    calls = {"fwd": 0, "bwd": 0}

    def counting(name, real):
        def run(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return run

    monkeypatch.setattr(ops, "flash_fwd", counting("fwd", ops.flash_fwd))
    monkeypatch.setattr(ops, "flash_bwd", counting("bwd", ops.flash_bwd))
    before = ops.launch_counts()
    n = tcfg.n_layers
    for remat, policy in POLICIES:
        calls.update(fwd=0, bwd=0)
        _grads(tparams, tb, tcfg, remat, policy)
        want = ({"fwd": (2 if remat else 1) * n, "bwd": n} if impl == "cuda"
                else {"fwd": 0, "bwd": 0})
        assert calls == want, (remat, policy)
    assert ops.launch_counts() == before       # no CUDA kernel on the CPU


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_dots_keeps_the_products_outputs(setup):
    """The backward of ``"dots"`` recomputes no matrix product of the
    layers (fewer products than ``"none"``); ``"names"`` and ``"none"``
    recompute all of them (PyTorch re-runs the layer's code, a kept output
    replaces only its own op)."""
    jparams, toks = setup
    _, tcfg = _cfgs("torch")
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    _, tb = _batches(toks)
    counts = {}
    for policy in ("none", "dots", "names"):
        leaves = [x.detach().requires_grad_(True)
                  for x in TO.tree_leaves(tparams)]
        tree = {}
        for (p, _), x in zip(tree_paths(tparams), leaves):
            set_path(tree, p, x)
        loss, _ = TT.loss_fn(tree, tb, tcfg, remat=True, remat_policy=policy)
        with _CountMatmuls() as c:
            torch.autograd.grad(loss, leaves)
        counts[policy] = c.n
    assert counts["dots"] < counts["none"] == counts["names"]


def test_unknown_policy_raises(setup):
    _, tcfg = _cfgs("torch")
    with pytest.raises(ValueError, match="remat_policy"):
        TT.forward(TT.init(tcfg, device="cpu"),
                   {"tokens": torch.zeros((1, 8), dtype=torch.long)}, tcfg,
                   remat=True, remat_policy="offload")
