"""Port parity for the mixture-of-experts FFN (``repro_torch.models.moe``)
against ``repro.models.moe`` on reduced Phi-3.5-MoE (top-2, renormalised
gates) and Llama-4-Scout (top-1, raw gates), the same numpy inputs and the
reference's weights carried across.

* outputs and aux within fp32 2e-5 / bf16 2e-2 for both dispatch impls, at
  capacity factors 0.5, 1.25 and 8.0, ungrouped and in 4 groups;
* the routing arrays — top-k expert ids, queue positions, ``keep`` —
  *equal* to the reference's (integers, framework-neutral);
* gradients through the router, the experts and the input against
  ``jax.grad`` at 5e-5 (fp32);
* the port's counterparts of ``tests/test_moe.py``: ties to the lowest
  expert index, capacity never exceeded, grouped ≡ ungrouped, gather ≡
  einsum, run to run bitwise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import registry as jregistry
from repro.models import moe as JM
from repro.models.module import init_tree
from repro_torch.configs import registry as tregistry
from repro_torch.models import moe as TM

ARCHS = ["phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e"]
# the port's model tolerances (tests/test_torch_model.py): fp32 summation
# order only; bf16 values rounded at the same points from fp32 sums
TOLS = {"float32": dict(atol=2e-5, rtol=2e-5),
        "bfloat16": dict(atol=2e-2, rtol=2e-2)}
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
# gather vs einsum: tests/test_moe.py's tolerance (dot association)
IMPL_TOL = dict(atol=2e-3, rtol=2e-2)
IMPLS = {"einsum": (JM.apply_moe, TM.apply_moe),
         "gather": (JM.apply_moe_gather, TM.apply_moe_gather)}


def _setup(arch, dtype="bfloat16", seed=1, shape=(2, 64), **kw):
    jcfg = jregistry.get(arch).reduced(dtype_name=dtype, **kw)
    tcfg = tregistry.get(arch).reduced(dtype_name=dtype, **kw)
    jp = init_tree(JM.moe_defs(jcfg), jax.random.PRNGKey(0), jcfg.dtype)
    # through fp32: exact for bf16 leaves, and the router stays fp32
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if k == "router" else tcfg.dtype)
        for k, v in jp.items()}
    x = np.random.default_rng(seed).standard_normal(
        shape + (jcfg.d_model,)).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def _np(a):
    return np.asarray(a, np.float32)


def _ref_routing(jp, x, jcfg):
    """The reference's routing arrays, by its own expressions
    (``repro/models/moe.py:56-82``)."""
    b0, s0, d = x.shape
    gpr = jcfg.moe_groups
    if gpr > 1 and s0 % gpr == 0 and (s0 // gpr) * jcfg.top_k >= jcfg.n_experts:
        x = x.reshape(b0 * gpr, s0 // gpr, d)
    b, s, _ = x.shape
    e, k = jcfg.n_experts, jcfg.top_k
    cap = int(s * k / e * jcfg.capacity_factor)
    cap = max(8, (cap + 7) // 8 * 8)
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), jp["router"])
    _, gate_idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    onehot = jax.nn.one_hot(gate_idx, e, dtype=jnp.float32)
    flat = onehot.reshape(b, s * k, e)
    pos = jnp.sum((jnp.cumsum(flat, axis=1) - flat).reshape(b, s, k, e)
                  * onehot, -1)
    return np.asarray(gate_idx), np.asarray(pos).astype(np.int64), \
        np.asarray(pos < cap), cap


def _port_routing(tp, x, tcfg):
    xg = TM._groups(x, tcfg)
    _, _, idx = TM.route(tp, xg, tcfg)
    _, pos = TM.queue_positions(idx, tcfg.n_experts)
    cap = TM.capacity(xg.shape[1], tcfg)
    return idx.numpy(), pos.numpy(), (pos < cap).numpy(), cap


# ------------------------------------------------------------ vs reference
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_outputs_and_aux_match_reference(arch, dtype, impl, cf, groups):
    jcfg, tcfg, jp, tp, x = _setup(arch, dtype, capacity_factor=cf,
                                   moe_groups=groups)
    jfn, tfn = IMPLS[impl]
    jy, ja = jfn(jp, jnp.asarray(x).astype(jcfg.dtype), jcfg)
    ty, ta = tfn(tp, torch.from_numpy(x).to(tcfg.dtype), tcfg)
    assert ty.dtype == tcfg.dtype and tuple(ty.shape) == x.shape
    assert ta.dtype == torch.float32 and ta.shape == ()
    np.testing.assert_allclose(_np(ty.float()), _np(jy), **TOLS[dtype])
    np.testing.assert_allclose(float(ta), float(ja), **TOLS[dtype])


@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_arrays_equal_reference(arch, dtype, cf, groups):
    """Expert ids, queue positions and ``keep``, equal (not close)."""
    jcfg, tcfg, jp, tp, x = _setup(arch, dtype, capacity_factor=cf,
                                   moe_groups=groups)
    jidx, jpos, jkeep, jcap = _ref_routing(
        jp, jnp.asarray(x).astype(jcfg.dtype), jcfg)
    tidx, tpos, tkeep, tcap = _port_routing(
        tp, torch.from_numpy(x).to(tcfg.dtype), tcfg)
    assert tcap == jcap
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tpos, jpos)
    np.testing.assert_array_equal(tkeep, jkeep)
    if cf == 0.5 and groups == 1:    # 64 tokens a group: some are dropped
        assert not tkeep.all()


@pytest.mark.parametrize("impl", ["einsum", "gather"])
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(arch, impl):
    """d/d(router, experts, x) of Σ y·r + aux against ``jax.grad`` (fp32,
    capacity drops on: factor 1.0)."""
    jcfg, tcfg, jp, tp, x = _setup(arch, "float32", capacity_factor=1.0)
    r = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)
    jfn, tfn = IMPLS[impl]

    def jloss(p, xx):
        y, aux = jfn(p, xx, jcfg)
        return jnp.sum(y * r) + aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = tfn(leaves, tx, tcfg)
    (torch.sum(y * torch.from_numpy(r)) + aux).backward()
    assert sorted(leaves) == sorted(jg)
    for k, v in leaves.items():
        np.testing.assert_allclose(v.grad.numpy(), _np(jg[k]), err_msg=k,
                                   **GRAD_TOL)
    np.testing.assert_allclose(tx.grad.numpy(), _np(jgx), **GRAD_TOL)


# ------------------------------------------------------------ the port alone
def test_router_tie_break_by_index():
    """An all-equal row routes to experts 0 and 1, as ``lax.top_k`` does."""
    cfg = tregistry.get("phi3.5-moe-42b-a6.6b").reduced(n_experts=8)
    p = {"router": torch.zeros((cfg.d_model, 8))}
    probs, vals, idx = TM.route(p, torch.randn(1, 3, cfg.d_model), cfg)
    assert idx.tolist() == [[[0, 1]] * 3]
    assert torch.equal(vals, torch.full((1, 3, 2), 0.5))
    _, jidx = jax.lax.top_k(jnp.ones((1, 1, 8)) * 0.125, 2)
    assert idx[0, 0].tolist() == jidx[0, 0].tolist()


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 50))
def test_capacity_never_exceeded(seed):
    """No expert takes more than ``cap`` tokens, kept places are distinct
    and below ``cap``, and both impls drop the same set."""
    _, cfg, _, tp, x = _setup("phi3.5-moe-42b-a6.6b", capacity_factor=1.0,
                              seed=seed, shape=(1, 64))
    xt = torch.from_numpy(x).to(cfg.dtype)
    idx, pos, keep, cap = _port_routing(tp, xt, cfg)
    for e in range(cfg.n_experts):
        kept = pos[(idx == e) & keep]
        assert len(kept) <= cap
        assert sorted(kept.tolist()) == list(range(len(kept)))
    y1, _ = TM.apply_moe(tp, xt, cfg)
    y2, _ = TM.apply_moe_gather(tp, xt, cfg)
    np.testing.assert_allclose(_np(y1.float()), _np(y2.float()), **IMPL_TOL)


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_grouped_dispatch_matches_ungrouped(impl):
    _, cfg, _, tp, x = _setup("phi3.5-moe-42b-a6.6b", capacity_factor=8.0)
    fn = IMPLS[impl][1]
    xt = torch.from_numpy(x).to(cfg.dtype)
    y1, _ = fn(tp, xt, cfg)
    y2, _ = fn(tp, xt, cfg.replace(moe_groups=4))
    np.testing.assert_allclose(_np(y1.float()), _np(y2.float()), **IMPL_TOL)


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_gather_matches_einsum(arch, cf):
    _, cfg, _, tp, x = _setup(arch, capacity_factor=cf)
    xt = torch.from_numpy(x).to(cfg.dtype)
    y1, a1 = TM.apply_moe(tp, xt, cfg)
    y2, a2 = TM.apply_moe_gather(tp, xt, cfg)
    np.testing.assert_allclose(_np(y1.float()), _np(y2.float()), **IMPL_TOL)
    assert float(a1) == pytest.approx(float(a2), rel=1e-5)


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_moe_run_to_run_bitwise(impl):
    _, cfg, _, tp, x = _setup("phi3.5-moe-42b-a6.6b")
    fn = IMPLS[impl][1]
    xt = torch.from_numpy(x).to(cfg.dtype)
    (y1, a1), (y2, a2) = fn(tp, xt, cfg), fn(tp, xt, cfg)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)


def test_capacity_expression_is_the_references():
    for s, cf in [(1, 1.25), (64, 0.5), (1024, 1.25), (333, 8.0), (7, 1.0)]:
        cfg = tregistry.get("phi3.5-moe-42b-a6.6b").replace(capacity_factor=cf)
        want = max(8, (int(s * 2 / 16 * cf) + 7) // 8 * 8)
        assert TM.capacity(s, cfg) == want
    assert TM.capacity(1024, tregistry.get("phi3.5-moe-42b-a6.6b")) == 160


def test_moe_defs_match_reference():
    """Leaves, shapes and dtypes of the expert parameters (the router fp32;
    no ``w_gate`` for an ungated activation)."""
    for arch, act in [(ARCHS[0], "silu"), (ARCHS[1], "silu"),
                      (ARCHS[0], "relu2"), (ARCHS[0], "gelu")]:
        jcfg = jregistry.get(arch).reduced(activation=act)
        tcfg = tregistry.get(arch).reduced(activation=act)
        jd, td = JM.moe_defs(jcfg), TM.moe_defs(tcfg)
        assert sorted(jd) == sorted(td)
        for k in jd:
            assert jd[k].shape == td[k].shape and jd[k].init == td[k].init
            assert (td[k].dtype == torch.float32) == (jd[k].dtype is not None)


@pytest.mark.parametrize("act", ["silu", "geglu", "gelu", "relu2"])
def test_expert_activation_matches_reference(act):
    rng = np.random.default_rng(3)
    g, u = (rng.standard_normal((4, 33)).astype(np.float32) * 3
            for _ in range(2))
    jcfg = jregistry.get(ARCHS[0]).reduced(activation=act)
    tcfg = tregistry.get(ARCHS[0]).reduced(activation=act)
    want = JM._act(jnp.asarray(g), jnp.asarray(u), jcfg)
    got = TM._act(torch.from_numpy(g), torch.from_numpy(u), tcfg)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5, rtol=2e-5)
