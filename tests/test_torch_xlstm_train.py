"""The xLSTM backwards of the port on the CPU: ``kernels/mlstm.py::
mlstm_parallel_backward_plain`` and ``kernels/slstm.py::
slstm_backward_plain``, the math of the backward kernels
(``csrc/mlstm_parallel_bwd.cu``, ``csrc/slstm_bwd.cu``; the mLSTM's as
the card runs it, from the forward's row statistics:
``mlstm_parallel_stats_plain`` and ``mlstm_parallel_backward_stats_plain``,
bitwise the plain forward's ``out`` and the plain backward's gradients),
held

* against ``jax.vjp`` of the reference's ``apply_mlstm`` (parallel form)
  and ``apply_slstm`` (from the initial and from a carried state) in fp32
  at the reduced config, within ``GRAD_TOL`` (5e-5): the port's mixers run
  through the autograd Functions the card runs (``_ParallelFn``,
  ``_SLSTMFn``), with the kernels' wrappers replaced by the plain forwards
  and the plain backwards; at random inputs and at edge inputs (S no
  multiple of the kernels' 32-row tiles, the exp(-m) branch of the
  mLSTM's normalizer, the 1e-6 clamp of each mixer, ties in each
  stabilizer's max);
* against autograd of the plain forwards at the same edges, on the
  mixers' own operands;
* through the whole model: ``loss_fn``'s gradients with both plain
  backwards wired in against ``jax.grad`` of the reference's, remat on and
  off;
* the forward's kept states (``slstm_plain(keep=True)``) against the
  recurrence's own.

Inputs are drawn by numpy from a seed and handed to both packages."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as JT
from repro_torch.kernels import mlstm as ML
from repro_torch.kernels import slstm as SL
from repro_torch.models import transformer as TT
from test_torch_xlstm import (APPLY, CUT, GRAD_TOL, JCFG, TCFG, _flat,
                              _jax_params, _mixer_params, _models, _np,
                              _state, _tokens, _torch_params, _x)


@contextlib.contextmanager
def functions_on_plain():
    """The mixers through the card's autograd Functions (``_ParallelFn``,
    ``_SLSTMFn``) with each kernel wrapper replaced by its plain version:
    the Function's forward the plain forward (under no autograd; the
    mLSTM's also handing over its row statistics), its backward the plain
    backward (the mLSTM's from those statistics), and its casts and saved
    tensors its own."""
    names = ((ML, ("mlstm_parallel", "mlstm_parallel_cuda",
                   "mlstm_parallel_stats_cuda",
                   "mlstm_parallel_backward_cuda")),
             (SL, ("slstm", "slstm_cuda", "slstm_backward_cuda")))
    saved = [(mod, n, getattr(mod, n)) for mod, ns in names for n in ns]

    def slstm(z, r, state):
        out, *new = SL._SLSTMFn.apply(*z, *r, *state)
        return out, tuple(new)
    ML.mlstm_parallel = ML._ParallelFn.apply
    ML.mlstm_parallel_cuda = ML.mlstm_parallel_plain
    ML.mlstm_parallel_stats_cuda = ML.mlstm_parallel_stats_plain
    ML.mlstm_parallel_backward_cuda = ML.mlstm_parallel_backward_stats_plain
    SL.slstm = slstm
    SL.slstm_cuda = SL.slstm_plain
    SL.slstm_backward_cuda = SL.slstm_backward_plain
    try:
        yield
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)


# edge inputs of each mixer, as changes to its parameters (and state):
# * ragged: S = 45, no multiple of the kernels' 32-row tiles;
# * exp_branch: the mLSTM's input gate near -6, so exp(-m_i) > |s_i| in
#   every row;
# * clamp: the mLSTM's input gate near +20 and q ~ 1e-9, so max(|s_i|,
#   exp(-m_i)) < 1e-6 in every row; the sLSTM's c, n ~ 1e-9 under a
#   stabilizer of 30, so n_t < 1e-6 at every step (and h stays ~1e-3);
# * ties: every D_ij of a row equal (a constant input gate, forget gates
#   log_sigmoid(200) = -0); the sLSTM's log_sigmoid(pre_f) + m equal to
#   pre_i at the first step (h = 0, m = 0.5, pre_i = 0.5, pre_f = 200).
MLSTM_EDGES = ("random", "ragged", "exp_branch", "clamp", "ties")
SLSTM_EDGES = ("initial", "carried", "ragged", "clamp", "ties")


def _edge_inputs(kind, edge):
    """(numpy params, x, state or None) of ``kind`` at ``edge``."""
    p = _mixer_params(kind)
    x = _x(s=45 if edge == "ragged" else 24)
    state = None if kind == "mlstm" else _state("slstm")
    if edge == "exp_branch":
        p["b_i"] = p["b_i"] - 6.0
    elif edge == "clamp" and kind == "mlstm":
        p["b_i"] = p["b_i"] + 20.0
        p["wq"] = (p["wq"] * 1e-9).astype(np.float32)
    elif edge == "clamp":
        state[0] = (1e-9 * state[0]).astype(np.float32)
        state[1] = np.full_like(state[1], 1e-9)
        state[3] = np.full_like(state[3], 30.0)
        p["b_f"] = p["b_f"] + 5.0
    elif edge == "ties" and kind == "mlstm":
        p["w_i"] = np.zeros_like(p["w_i"])
        p["w_f"] = np.zeros_like(p["w_f"])
        p["b_i"] = np.full_like(p["b_i"], 0.7)
        p["b_f"] = np.full_like(p["b_f"], 200.0)
    elif edge == "ties":
        state[2] = np.zeros_like(state[2])
        state[3] = np.full_like(state[3], 0.5)
        p["w_i"] = np.zeros_like(p["w_i"])
        p["w_f"] = np.zeros_like(p["w_f"])
        p["b_i"] = np.full_like(p["b_i"], 0.5)
        p["b_f"] = np.full_like(p["b_f"], 200.0)
    elif edge == "initial":
        state = None
    return p, x, state


def _cotangents(shapes, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("kind,edge", [("mlstm", e) for e in MLSTM_EDGES]
                         + [("slstm", e) for e in SLSTM_EDGES])
def test_plain_backward_matches_jax_vjp(kind, edge):
    """d (y . dy + new_state . dstate) / d (every parameter, x, the carried
    state), fp32: the mixer through its Function on the plain backward
    against ``jax.vjp`` of the reference's, each gradient within GRAD_TOL
    of max(1, max |jax|) (at the mLSTM's clamp the gradients reach ~4e5:
    an element-wise tolerance would hold their cancellations to fp32's
    last bits there)."""
    p, x, state = _edge_inputs(kind, edge)
    japply, tapply = APPLY[kind]
    jst = None if state is None else tuple(jnp.asarray(s) for s in state)
    (jy, jnew), vjp = jax.vjp(
        lambda pp, xx, st: japply(pp, xx, JCFG, state=st),
        _jax_params(p, jnp.float32), jnp.asarray(x), jst)
    cot = _cotangents([jy.shape] + ([] if jnew is None
                                    else [t.shape for t in jnew]))
    jnew_cot = None if jnew is None else tuple(jnp.asarray(c)
                                               for c in cot[1:])
    jg_p, jg_x, jg_st = vjp((jnp.asarray(cot[0]), jnew_cot))

    tp = _torch_params(p, torch.float32, grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    tst = (None if state is None else
           tuple(torch.from_numpy(s).requires_grad_(True) for s in state))
    with functions_on_plain():
        y, new = tapply(tp, tx, TCFG, state=tst)
        loss = (y * torch.from_numpy(cot[0])).sum()
        if new is not None:
            loss = loss + sum((t * torch.from_numpy(c)).sum()
                              for t, c in zip(new, cot[1:]))
        loss.backward()
    pairs = [("x", tx.grad, jg_x)] + [(k, t.grad, jg_p[k])
                                      for k, t in tp.items()]
    if tst is not None:
        pairs += [(f"state {i}", t.grad, want)
                  for i, (t, want) in enumerate(zip(tst, jg_st))]
    for name, got, want in pairs:
        err = _rel_err(got, torch.tensor(_np(want)))
        assert err <= GRAD_TOL["rtol"], (name, err)


def _rel_err(got, want):
    """max |got - want| / max(1, max |want|)."""
    return float((got - want).abs().max()) / max(1.0, float(
        want.abs().max()))


def _mlstm_operands(edge, seed=0):
    """q, k (divided by sqrt(hd)), v (B, S, H, hd) and ig, fg (B, S, H),
    fp32, at ``edge``."""
    rng = np.random.default_rng(seed)
    b, s, h, hd = 2, 45 if edge == "ragged" else 37, 3, 8

    def f(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))
    q = f(b, s, h, hd, scale=1e-9 if edge == "clamp" else 1.0)
    k, v = f(b, s, h, hd, scale=hd ** -0.5), f(b, s, h, hd)
    ig = f(b, s, h) + {"exp_branch": -6.0, "clamp": 20.0}.get(edge, 0.0)
    fg = torch.nn.functional.logsigmoid(f(b, s, h) + 1.0)
    if edge == "ties":
        ig, fg = torch.full_like(ig, 0.7), torch.zeros_like(fg)
    return q, k, v, ig, fg


def _mlstm_branches(q, k, v, ig, fg):
    """The rows' share in the |s| branch, in the 1e-6 clamp, and the pairs'
    share of ties in the stabilizer, of the plain forward."""
    s = q.shape[1]
    F = torch.cumsum(fg, 1)
    D = F[:, :, None] - F[:, None] + ig[:, None]
    tri = torch.ones((s, s), dtype=torch.bool).tril()[None, :, :, None]
    D = torch.where(tri, D, ML.NEG)
    m = D.amax(2)
    ssum = (torch.einsum("bihe,bjhe->bijh", q, k)
            * torch.exp(D - m[:, :, None])).sum(2)
    em = torch.exp(-m)
    return (float((ssum.abs() > em).float().mean()),
            float((torch.maximum(ssum.abs(), em) < 1e-6).float().mean()),
            float(((D == m[:, :, None]) & tri).sum() / tri.sum() / D.shape[0]
                  / D.shape[-1]))


@pytest.mark.parametrize("edge", MLSTM_EDGES)
def test_mlstm_plain_backward_matches_autograd(edge):
    """mlstm_parallel_backward_plain against autograd of
    mlstm_parallel_plain on the same operands, each gradient within
    GRAD_TOL of max(1, max |autograd|); the edge inputs take the branch
    they are meant to."""
    args = _mlstm_operands(edge)
    s_branch, clamped, ties = _mlstm_branches(*args)
    want_branch = {"exp_branch": s_branch == 0.0, "clamp": clamped == 1.0,
                   "ties": ties == 1.0}.get(edge, 0.2 < s_branch < 1.0)
    assert want_branch, (s_branch, clamped, ties)
    leaves = [a.clone().requires_grad_(True) for a in args]
    out = ML.mlstm_parallel_plain(*leaves)
    dout = torch.from_numpy(np.random.default_rng(5).standard_normal(
        out.shape).astype(np.float32))
    grads = torch.autograd.grad(out, leaves, dout)
    mine = ML.mlstm_parallel_backward_plain(*args, dout)
    for name, g, w in zip(("dq", "dk", "dv", "dig", "dfg"), mine, grads):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _rel_err(g, w) <= GRAD_TOL["rtol"], (name, _rel_err(g, w))


@pytest.mark.parametrize("edge", MLSTM_EDGES)
def test_mlstm_backward_from_the_forwards_stats_is_the_plain_backward(edge):
    """The plain forward that hands over its row statistics returns
    ``mlstm_parallel_plain``'s ``out`` bit for bit, with F = cumsum(fg),
    each row's stabilizer m_i (the max of its D_ij), signed row sum s_i
    and tie count (the D_ij equal to m_i); the plain backward from them
    returns ``mlstm_parallel_backward_plain``'s five gradients bit for bit
    (the edges: ragged S, the exp(-m) branch, the 1e-6 clamp, ties)."""
    args = _mlstm_operands(edge)
    q, k, v, ig, fg = args
    out, F, stats = ML.mlstm_parallel_stats_plain(*args)
    assert torch.equal(out, ML.mlstm_parallel_plain(*args))
    assert torch.equal(F, torch.cumsum(fg, 1))
    assert stats.shape == q.shape[:3] + (3,) and stats.dtype == torch.float32
    m, s, ties = stats.unbind(-1)
    b, n, h = ig.shape
    for i in range(n):
        D = F[:, i, None] - F[:, :i + 1] + ig[:, :i + 1]       # (B, j, H)
        assert torch.equal(m[:, i], D.amax(1))
        assert torch.equal(ties[:, i], (D == m[:, i, None]).sum(1).float())
        w = torch.exp(D - m[:, i, None])
        row = (torch.einsum("bhe,bjhe->bjh", q[:, i], k[:, :i + 1]) * w).sum(1)
        torch.testing.assert_close(s[:, i], row, rtol=1e-5, atol=1e-6)
    if edge == "ties":
        assert bool((ties == torch.arange(1, n + 1).float()[None, :, None])
                    .all())
    dout = torch.from_numpy(np.random.default_rng(5).standard_normal(
        out.shape).astype(np.float32))
    want = ML.mlstm_parallel_backward_plain(*args, dout)
    got = ML.mlstm_parallel_backward_stats_plain(q, k, v, ig, F, out, dout,
                                                 stats)
    for name, g, w in zip(("dq", "dk", "dv", "dig", "dfg"), got, want):
        assert torch.equal(g, w), name


def _slstm_operands(edge, seed=1):
    """z (four (B, S, H, hd)), r (four (H, hd, hd)) and the state, fp32,
    at ``edge``."""
    rng = np.random.default_rng(seed)
    b, s, h, hd = 2, 45 if edge == "ragged" else 19, 3, 8

    def f(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))
    z = [f(b, s, h, hd) for _ in range(4)]
    r = [f(h, hd, hd, scale=hd ** -0.5) for _ in range(4)]
    state = [0.3 * f(b, h, hd), 0.5 + f(b, h, hd).abs(), 0.3 * f(b, h, hd),
             f(b, h, hd).tanh()]
    if edge == "initial":
        state = [torch.zeros(b, h, hd)] * 3 + [torch.full((b, h, hd),
                                                          ML.NEG)]
    elif edge == "clamp":
        state[0] = 1e-9 * state[0]
        state[1], state[3] = torch.full((b, h, hd), 1e-9), torch.full(
            (b, h, hd), 30.0)
        z[1] = z[1] + 5.0
    elif edge == "ties":
        state[2], state[3] = torch.zeros(b, h, hd), torch.full((b, h, hd),
                                                               0.5)
        z[0][:, 0], z[1][:, 0] = 0.5, 200.0
    return z, r, state


@pytest.mark.parametrize("edge", SLSTM_EDGES)
def test_slstm_plain_backward_matches_autograd(edge):
    """slstm_backward_plain against autograd of slstm_plain on the same
    operands (the gradients of every step's h and of the returned state
    both given), each gradient within GRAD_TOL of max(1, max |autograd|);
    the edge inputs take the branch they are meant to."""
    z, r, state = _slstm_operands(edge)
    _, _, kept = SL.slstm_plain(z, r, state, keep=True)
    c_all, n_all, m_all, pi, pf = kept[:5]
    if edge == "clamp":
        assert bool((n_all < 1e-6).all())
    if edge == "ties":
        a = torch.nn.functional.logsigmoid(pf[:, 0]) + state[3]
        assert bool((a == pi[:, 0]).all())
    leaves = [t.clone().requires_grad_(True) for t in (*z, *r, *state)]
    h_all, new = SL.slstm_plain(leaves[:4], leaves[4:8], leaves[8:])
    rng = np.random.default_rng(6)
    cot = [torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
           for t in (h_all, *new)]
    grads = torch.autograd.grad((h_all, *new), leaves, cot)
    dz, dr, d0 = SL.slstm_backward_plain(z, r, state, (h_all.detach(), kept),
                                         cot[0], tuple(cot[1:]))
    names = [f"dz_{g}" for g in "ifzo"] + [f"dr_{g}" for g in "ifzo"] + [
        "dc0", "dn0", "dh0", "dm0"]
    for name, g, w in zip(names, (*dz, *dr, *d0), grads):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        assert _rel_err(g, w) <= GRAD_TOL["rtol"], (name, _rel_err(g, w))


@pytest.mark.parametrize("carried", [False, True])
def test_slstm_kept_states_are_the_recurrences(carried):
    """slstm_plain(keep=True) returns the recurrence's own h_all and state
    and, for each step, its c, n, m (the next step's carried state) and the
    pre-activations z_g + h_{t-1} r_g."""
    z, r, state = _slstm_operands("carried" if carried else "initial")
    h_all, new = SL.slstm_plain(z, r, state)
    h2, new2, kept = SL.slstm_plain(z, r, state, keep=True)
    assert kept.shape == (len(SL.KEPT), *h_all.shape)
    assert torch.equal(h_all, h2)
    assert all(torch.equal(a, b) for a, b in zip(new, new2))
    c_all, n_all, m_all = kept[:3]
    assert torch.equal(c_all[:, -1], new[0])
    assert torch.equal(n_all[:, -1], new[1])
    assert torch.equal(m_all[:, -1], new[3])
    h_prev = torch.cat([state[2][:, None], h_all[:, :-1]], 1)
    for g, (zg, rg) in enumerate(zip(z, r)):
        pre = zg + torch.einsum("bshe,hev->bshv", h_prev, rg)
        torch.testing.assert_close(kept[3 + g], pre, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("remat", [False, True])
def test_loss_grads_through_the_plain_backwards_match_reference(remat):
    """fp32 grads of ``loss_fn`` for every leaf at reduced depth (one
    mLSTM and the sLSTM block), with both mixers through their Functions
    on the plain backwards, against ``jax.grad`` of the reference's, with
    and without remat."""
    jcfg, tcfg, jparams, tparams = _models(pattern=CUT, seed=1)
    toks = _tokens(1, (2, 25))
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {k: torch.from_numpy(np.array(v)).long() for k, v in jb.items()}
    jg = _flat(jax.grad(lambda p: JT.loss_fn(p, jb, jcfg)[0])(jparams))
    leaves = {p: t.clone().requires_grad_(True)
              for p, t in _flat(tparams).items()}
    tree = {}
    for p, t in leaves.items():
        node = tree
        *parents, leaf = p.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = t
    with functions_on_plain():
        loss, _ = TT.loss_fn(tree, tb, tcfg, remat=remat)
        loss.backward()
    assert sorted(leaves) == sorted(jg)
    for p, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg[p]),
                                   err_msg=p, **GRAD_TOL)


def test_slstm_input_gate_shift_leaves_h_unchanged():
    """h is invariant under a uniform shift of the sLSTM's input gate (c
    and n scale alike under the stabilizer), so the gradient of the input
    gate's bias is exactly 0: in float64 it is at rounding level beside the
    other gates' biases (the reason the card's step-1 check holds that
    leaf over its layer's gradient norm, not its own)."""
    z, r, state = _slstm_operands("initial")
    z = [t.double() for t in z]
    r = [t.double() for t in r]
    state = [t.double() for t in state]
    bias = [torch.zeros(z[0].shape[2:], dtype=torch.float64,
                        requires_grad=True) for _ in range(4)]
    saved = SL.F32
    SL.F32 = torch.float64                 # the plain recurrence in float64
    try:
        h_all, _ = SL.slstm_plain([zg + b for zg, b in zip(z, bias)], r,
                                  state)
    finally:
        SL.F32 = saved
    cot = torch.from_numpy(np.random.default_rng(7).standard_normal(
        h_all.shape))
    grads = torch.autograd.grad((h_all * cot).sum(), bias)
    others = min(float(g.abs().max()) for g in grads[1:])
    assert float(grads[0].abs().max()) <= 1e-12 * others
