"""Port parity for xLSTM (``models/xlstm.py``, the ``mlstm``/``slstm``
blocks, ``kernels/mlstm.py`` and ``kernels/slstm.py``) on the CPU against
the reference at the reduced xLSTM-350M config (8 layers: 7 mLSTM and 1
sLSTM; d = 128, 4 heads of 32, vocab 512). Mixer inputs and parameters are
drawn by numpy and handed to both packages; the model's weights come from
``JT.init`` through ``from_jax_params``. Tolerances: fp32 2e-5 forward,
5e-5 gradients, bf16 2e-2.

* ``apply_mlstm`` (parallel form, and the recurrence from a carried state)
  and ``apply_slstm`` (from the initial and a carried state): outputs and
  new states in both dtypes;
* the plain versions' gradients (parameters and input) against
  ``jax.grad``: the oracle of the kernels' backward;
* the split-state continuation (the reference's
  ``test_models_numerics.py`` identities);
* ``forward`` / ``loss_fn`` and their gradients, ``prefill_step`` +
  ``decode_step`` against the reference's, and against ``forward``;
  ``init_cache``; the static engine's greedy tokens; the config and the
  weight bridge;
* the dispatch (CPU tensors take the plain versions, other devices raise;
  the kernel wrappers, the backward ones too, refuse CPU tensors), the
  recurrence's Function's backward refusing, both launchers on the CPU
  (the continuous engine refuses xLSTM with the reference's reason; the
  train launcher trains it, and refuses the card no longer).

The backward kernels' plain versions against ``jax.vjp`` and autograd:
``tests/test_torch_xlstm_train.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import InputShape
from repro.launch.specs import make_batch
from repro.models import transformer as JT
from repro.models import xlstm as JX
from repro.serve import engine as JE
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import mlstm as ML
from repro_torch.kernels import slstm as SL
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as TT
from repro_torch.models import xlstm as TX
from repro_torch.models.convert import from_jax_params
from repro_torch.models.module import iter_defs
from repro_torch.serve import engine as TE

ARCH = "xlstm-350m"
S = 48
TOLS = {"float32": dict(atol=2e-5, rtol=2e-5),
        "bfloat16": dict(atol=2e-2, rtol=2e-2)}
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
# the reference's own limits: parallel vs recurrent mLSTM, and forward vs
# prefill + decode (tests/test_models_numerics.py, test_archs_smoke.py)
FORMS_TOL = dict(atol=2e-3, rtol=2e-2)
SMOKE_TOL = dict(atol=5e-2, rtol=5e-2)
# forward ≈ prefill + decode in fp32, where the two forms differ by
# rounding only (readings 2e-6 to 1.7e-5); in bf16 the identity's max |diff|
# (the logits reach ~1), which the reference's own readings bring near
# SMOKE_TOL and past it at PRNGKey(2)
IDENTITY_FP32_TOL = dict(atol=1e-4, rtol=1e-4)
IDENTITY_BF16_ATOL = 0.1


def _cfgs(dtype="float32"):
    return (jregistry.get(ARCH).reduced(dtype_name=dtype),
            tregistry.get(ARCH).reduced(dtype_name=dtype))


JCFG, TCFG = _cfgs()


def _mixer_params(kind, seed=0):
    """numpy parameters of one mixer: matrices at their fan-in scale, the
    biases random (the reference inits them to zeros and ones)."""
    rng = np.random.default_rng(seed)
    defs = TX.mlstm_defs(TCFG) if kind == "mlstm" else TX.slstm_defs(TCFG)
    out = {}
    for name, d in sorted(defs.items()):
        if len(d.shape) >= 2:
            v = rng.standard_normal(d.shape) / np.sqrt(d.shape[-2])
        else:
            v = 0.5 * rng.standard_normal(d.shape) + (name == "b_f")
        out[name] = v.astype(np.float32)
    return out


def _x(seed=1, s=S, b=2):
    return (0.5 * np.random.default_rng(seed).standard_normal(
        (b, s, TCFG.d_model))).astype(np.float32)


def _state(kind, seed=3, b=2):
    """A carried state as a prefix would leave it (C, n, m / c, n, h, m)."""
    rng = np.random.default_rng(seed)
    h, hd = TCFG.n_heads, TCFG.head_dim
    if kind == "mlstm":
        shapes = [(b, h, hd, hd), (b, h, hd), (b, h)]
        st = [0.1 * rng.standard_normal(sh) for sh in shapes]
        st[2] = rng.uniform(-1.0, 1.0, shapes[2])
    else:
        st = [0.3 * rng.standard_normal((b, h, hd)) for _ in range(3)]
        st[1] = rng.uniform(0.5, 2.0, (b, h, hd))
        st.append(rng.uniform(-1.0, 1.0, (b, h, hd)))
    return [s.astype(np.float32) for s in st]


def _jax_params(p, dtype):
    return {k: jnp.asarray(v, jnp.float32 if k.startswith("b_") else dtype)
            for k, v in p.items()}


def _torch_params(p, dtype, grad=False):
    return {k: torch.from_numpy(v).to(torch.float32 if k.startswith("b_")
                                      else dtype).requires_grad_(grad)
            for k, v in p.items()}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


APPLY = {"mlstm": (JX.apply_mlstm, TX.apply_mlstm),
         "slstm": (JX.apply_slstm, TX.apply_slstm)}


def _run_mixer(kind, dtype, state):
    p, x = _mixer_params(kind), _x()
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    japply, tapply = APPLY[kind]
    jst = None if state is None else tuple(jnp.asarray(s) for s in state)
    tst = None if state is None else tuple(torch.from_numpy(s) for s in state)
    jy, jnew = japply(_jax_params(p, jdt), jnp.asarray(x, jdt), JCFG,
                      state=jst)
    with torch.no_grad():
        ty, tnew = tapply(_torch_params(p, tdt), torch.from_numpy(x).to(tdt),
                          TCFG, state=tst)
    return jy, jnew, ty, tnew


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["parallel", "recurrent"])
def test_apply_mlstm_matches_reference(form, dtype):
    state = None if form == "parallel" else _state("mlstm")
    jy, jnew, ty, tnew = _run_mixer("mlstm", dtype, state)
    assert ty.dtype == getattr(torch, dtype) and ty.shape == jy.shape
    np.testing.assert_allclose(_np(ty), _np(jy), **TOLS[dtype])
    if form == "parallel":
        assert jnew is None and tnew is None
        return
    for got, want in zip(tnew, jnew):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carried", [False, True])
def test_apply_slstm_matches_reference(carried, dtype):
    state = _state("slstm") if carried else None
    jy, jnew, ty, tnew = _run_mixer("slstm", dtype, state)
    assert ty.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOLS[dtype])
    for got, want in zip(tnew, jnew):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_np(got), _np(want), **TOLS[dtype])


@pytest.mark.parametrize("kind,form", [("mlstm", "parallel"),
                                       ("mlstm", "recurrent"),
                                       ("slstm", "recurrent")])
def test_plain_gradients_match_jax_grad(kind, form):
    """d sum(y * dy) / d (every parameter, x), fp32: the plain versions
    under autograd against ``jax.grad`` of the reference."""
    p, x = _mixer_params(kind), _x(s=24)
    dy = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)
    state = None if form == "parallel" else _state(kind)
    japply, tapply = APPLY[kind]

    def jloss(params, xx):
        st = None if state is None else tuple(jnp.asarray(s) for s in state)
        y, _ = japply(params, xx, JCFG, state=st)
        return jnp.sum(y * dy)
    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        _jax_params(p, jnp.float32), jnp.asarray(x))
    tp = _torch_params(p, torch.float32, grad=True)
    tx = torch.from_numpy(x).requires_grad_(True)
    tst = None if state is None else tuple(torch.from_numpy(s) for s in state)
    y, _ = tapply(tp, tx, TCFG, state=tst)
    (y * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), _np(jg_x), **GRAD_TOL)
    for k, t in tp.items():
        np.testing.assert_allclose(t.grad.numpy(), _np(jg_p[k]), err_msg=k,
                                   **GRAD_TOL)


@torch.no_grad()
@pytest.mark.parametrize("case", ["slstm_split", "mlstm_split",
                                  "mlstm_parallel_vs_recurrent"])
def test_split_state_continuation(case):
    """A sequence split over two calls (the second from the first's state)
    equals one call, as the reference's ``test_slstm_stepwise_consistency``
    (1e-5 / 1e-4); mLSTM's parallel form equals its recurrence from the
    zero state, as its ``test_mlstm_parallel_matches_recurrent``."""
    kind = case.split("_")[0]
    p = _torch_params(_mixer_params(kind), torch.float32)
    x = torch.from_numpy(_x(s=12))
    apply = APPLY[kind][1]
    init = (TX.mlstm_init_state if kind == "mlstm"
            else TX.slstm_init_state)(TCFG, 2, "cpu")
    if case == "mlstm_parallel_vs_recurrent":
        y_par, _ = apply(p, x, TCFG)
        y_rec, _ = apply(p, x, TCFG, state=init)
        np.testing.assert_allclose(y_par.numpy(), y_rec.numpy(), **FORMS_TOL)
        return
    y_full, st_full = apply(p, x, TCFG, state=init)
    y1, st = apply(p, x[:, :7], TCFG, state=init)
    y2, st2 = apply(p, x[:, 7:], TCFG, state=st)
    np.testing.assert_allclose(y_full.numpy(), torch.cat([y1, y2], 1).numpy(),
                               atol=1e-5, rtol=1e-4)
    for a, b in zip(st_full, st2):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-4)


# ------------------------------------------------------------ the model
CUT = ("mlstm", "slstm")     # reduced depth: one block of each kind


def _models(dtype="float32", pattern=None, seed=0):
    jcfg, tcfg = _cfgs(dtype)
    if pattern is not None:
        jcfg, tcfg = (c.replace(n_layers=len(pattern), block_pattern=pattern)
                      for c in (jcfg, tcfg))
    jparams = JT.init(jcfg, jax.random.PRNGKey(seed))
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return jcfg, tcfg, jparams, tparams


def _tokens(seed=0, shape=(2, S + 1)):
    return np.random.default_rng(seed).integers(0, 512, shape).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, path) if isinstance(v, dict) else {path: v})
    return out


@pytest.mark.parametrize("reduced", [False, True])
def test_config_equals_reference_on_shared_fields(reduced):
    jcfg, tcfg = jregistry.get(ARCH), tregistry.get(ARCH)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    shared = [f.name for f in dataclasses.fields(tcfg)
              if f.name != "attention_impl"]
    for n in shared:
        assert getattr(tcfg, n) == getattr(jcfg, n), n
    assert (tcfg.head_dim, tcfg.padded_vocab) == (jcfg.head_dim,
                                                  jcfg.padded_vocab)
    assert tcfg.family == "ssm" and tcfg.d_ff == 0
    with pytest.raises(KeyError):
        tregistry.drafter_for(ARCH)


def test_bridge_maps_every_leaf():
    """Every reference leaf once, r_g (H, hd, hd) in both packages, the
    gate biases fp32, no ln2 and no MLP."""
    _, tcfg, jparams, tparams = _models("bfloat16")
    ref, ours = _flat(jax.tree.map(np.asarray, jparams)), _flat(tparams)
    assert sorted(ref) == sorted(ours) == sorted(
        p for p, _ in iter_defs(TT.param_defs(tcfg)))
    for path, arr in ref.items():
        assert tuple(ours[path].shape) == arr.shape, path
        np.testing.assert_array_equal(ours[path].float().numpy(),
                                      np.asarray(arr, np.float32))
    assert ours["blocks/b7_slstm/slstm/r_f"].shape == (1, 4, 32, 32)
    assert ours["blocks/b0_mlstm/mlstm/b_f"].dtype == torch.float32
    assert ours["blocks/b7_slstm/slstm/r_f"].dtype == torch.bfloat16
    assert not [p for p in ours if "ln2" in p or "mlp" in p]


@pytest.mark.parametrize("dtype,pattern", [("float32", None),
                                           ("bfloat16", CUT)])
def test_forward_and_loss_match_reference(dtype, pattern):
    """Logits, loss and ce: fp32 at the reduced config's 8 layers, bf16 at
    reduced depth (one mLSTM and the sLSTM block): at 8 bf16 layers the
    reference's own jit and op-by-op runs already differ beyond 2e-2 in
    the logits (its jit keeps excess precision, the port rounds every
    op)."""
    jcfg, tcfg, jparams, tparams = _models(dtype, pattern)
    toks = _tokens()
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {k: torch.from_numpy(np.array(v)).long() for k, v in jb.items()}
    jlogits, _ = JT.forward(jparams, jb, jcfg)
    jloss, jm = JT.loss_fn(jparams, jb, jcfg)
    with torch.no_grad():
        tlogits, _ = TT.forward(tparams, tb, tcfg)
        tloss, tm = TT.loss_fn(tparams, tb, tcfg)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), **TOLS[dtype])
    for got, want in [(tloss, jloss), (tm["ce"], jm["ce"])]:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), **TOLS[dtype])


@pytest.mark.parametrize("remat", [False, True])
def test_loss_grads_match_reference(remat):
    """fp32 grads of ``loss_fn`` for every leaf at reduced depth (one
    mLSTM and the sLSTM block), with and without remat."""
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
    loss, _ = TT.loss_fn(tree, tb, tcfg, remat=remat)
    loss.backward()
    assert sorted(leaves) == sorted(jg)
    for p, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg[p]),
                                   err_msg=p, **GRAD_TOL)


@pytest.fixture(scope="module")
def models_fp32():
    return _models()


@torch.no_grad()
def test_prefill_and_decode_match_reference(models_fp32):
    """The cached path (mLSTM's recurrence over the prompt, then one-token
    steps) against the reference's prefill_step/decode_step: the logits at
    every step and the caches after them."""
    jcfg, tcfg, jparams, tparams = models_fp32
    toks = _tokens(2, (2, S))
    p = S - 4
    jlast, jcaches, _ = JT.prefill_step(
        jparams, {"tokens": jnp.asarray(toks[:, :p])}, jcfg, max_seq=S)
    tlast, tcaches = TT.prefill_step(
        tparams, {"tokens": torch.from_numpy(toks[:, :p]).long()}, tcfg,
        max_seq=S)
    np.testing.assert_allclose(_np(tlast), _np(jlast), **TOLS["float32"])
    for i in range(p, S):
        jout, jcaches = JT.decode_step(jparams, jcaches,
                                       jnp.asarray(toks[:, i:i + 1]),
                                       jnp.asarray(i, jnp.int32), jcfg)
        tout, tcaches = TT.decode_step(
            tparams, tcaches, torch.from_numpy(toks[:, i:i + 1]).long(), i,
            tcfg)
        np.testing.assert_allclose(_np(tout), _np(jout), **TOLS["float32"])
    ref, ours = _flat(jcaches), _flat(tcaches)
    assert sorted(ref) == sorted(ours)
    for k, leaves in ours.items():
        for got, want in zip(leaves, ref[k]):
            np.testing.assert_allclose(_np(got), _np(want), err_msg=k,
                                       **TOLS["float32"])


@torch.no_grad()
def test_forward_equals_prefill_plus_decode(models_fp32):
    """The reference's identity ``forward ≈ prefill + decode``
    (tests/test_archs_smoke.py) in fp32, within ``IDENTITY_FP32_TOL``: the
    parallel mLSTM form against the recurrence, through the whole model."""
    _, tcfg, _, tparams = models_fp32
    toks = torch.from_numpy(_tokens(3, (2, S))).long()
    for got, want in _port_identity(tparams, tcfg, toks):
        np.testing.assert_allclose(got, want, **IDENTITY_FP32_TOL)


def _port_identity(params, cfg, toks):
    """(prefill of all but the last token, forward at that position) and
    (one decode step, forward at the last), as fp32 numpy."""
    s = toks.shape[1]
    with torch.no_grad():
        full, _ = TT.forward(params, {"tokens": toks}, cfg)
        last, caches = TT.prefill_step(params, {"tokens": toks[:, :-1]},
                                       cfg, max_seq=s)
        step, _ = TT.decode_step(params, caches, toks[:, -1:], s - 1, cfg)
    return [(_np(a), _np(b)) for a, b in ((last[:, 0], full[:, s - 2]),
                                          (step[:, 0], full[:, s - 1]))]


def _reference_identity(params, cfg, toks):
    s = toks.shape[1]
    full, _ = JT.forward(params, {"tokens": toks}, cfg)
    last, caches, _ = JT.prefill_step(params, {"tokens": toks[:, :-1]}, cfg,
                                      max_seq=s)
    step, _ = JT.decode_step(params, caches, toks[:, -1:],
                             jnp.asarray(s - 1, jnp.int32), cfg)
    return [(_np(a), _np(b)) for a, b in ((last[:, 0], full[:, s - 2]),
                                          (step[:, 0], full[:, s - 1]))]


def _smoke_models(key):
    """The reference's test_prefill_decode_matches_forward inputs: its
    reduced bf16 config, ``JT.init`` at PRNGKey(key), ``make_batch``'s
    (2, 64) prompt; the port's weights through the bridge."""
    jcfg = jregistry.get(ARCH).reduced(capacity_factor=8.0)
    tcfg = tregistry.get(ARCH).reduced()
    assert jcfg.dtype_name == tcfg.dtype_name == "bfloat16"
    rkey = jax.random.PRNGKey(key)
    jparams = JT.init(jcfg, rkey)
    toks = make_batch(jcfg, InputShape("smoke_prefill", "prefill", 64, 2),
                      rkey)["batch"]["tokens"]
    tparams = from_jax_params(jax.tree.map(np.asarray, jparams), tcfg,
                              device="cpu")
    return (jcfg, jparams, toks), (tcfg, tparams,
                                   torch.from_numpy(np.array(toks)).long())


def test_bf16_forward_equals_prefill_plus_decode_on_the_references_inputs():
    """The reference's test_prefill_decode_matches_forward for xLSTM, run by
    the port on the same weights and tokens, within its allclose(5e-2)."""
    _, (tcfg, tparams, toks) = _smoke_models(0)
    for got, want in _port_identity(tparams, tcfg, toks):
        np.testing.assert_allclose(got, want, **SMOKE_TOL)


@pytest.mark.parametrize("key", [0, 1, 2])
def test_bf16_identity_readings(key):
    """The bf16 identity's max |diff| in both packages on the same weights
    and tokens (printed; the reference's passes its own SMOKE_TOL at keys 0
    and 1 and not at 2): the port's within IDENTITY_BF16_ATOL, the bound
    chip_smoke.py holds the kernels' run to on the card."""
    (jcfg, jparams, jtoks), (tcfg, tparams, ttoks) = _smoke_models(key)
    reading = {name: [float(np.abs(a - b).max()) for a, b in pairs]
               for name, pairs in (
                   ("reference", _reference_identity(jparams, jcfg, jtoks)),
                   ("port", _port_identity(tparams, tcfg, ttoks)))}
    print(f"PRNGKey({key}) max |diff| (prefill, decode): {reading}")
    assert max(reading["port"]) <= IDENTITY_BF16_ATOL


def test_init_cache_matches_reference():
    jcfg, tcfg = _cfgs("bfloat16")
    ref = _flat(JT.init_cache(jcfg, 3, 16))
    ours = _flat(TT.init_cache(tcfg, 3, 16, "cpu"))
    assert sorted(ref) == sorted(ours) == sorted(
        [f"b{i}_mlstm/mlstm" for i in range(7)] + ["b7_slstm/slstm"])
    for k, leaves in ours.items():
        assert len(leaves) == len(ref[k]) == (3 if "mlstm" in k else 4)
        for got, want in zip(leaves, ref[k]):
            assert got.dtype == torch.float32 and want.dtype == jnp.float32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_static_engine_tokens_match_reference(models_fp32):
    jcfg, tcfg, jparams, tparams = models_fp32
    prompt = _tokens(5, (2, 32))
    n = 8
    want = np.array(JE.Engine(jcfg, jparams, max_seq=32 + n).generate(
        {"tokens": jnp.asarray(prompt)}, n))
    got = TE.Engine(tcfg, tparams, max_seq=32 + n).generate(
        {"tokens": torch.from_numpy(prompt).long()}, n)
    np.testing.assert_array_equal(got.numpy(), want)


# ------------------------------------------------------------ dispatch
def _mlstm_operands(device="cpu", hd=32):
    q = torch.zeros((1, 4, 2, hd), device=device)
    g = torch.zeros((1, 4, 2), device=device)
    st = (torch.zeros((1, 2, hd, hd), device=device),
          torch.zeros((1, 2, hd), device=device),
          torch.zeros((1, 2), device=device))
    return (q, q, q, g, g), st


def _slstm_operands(device="cpu", hd=32):
    z = tuple(torch.zeros((1, 4, 2, hd), device=device) for _ in range(4))
    r = tuple(torch.zeros((2, hd, hd), device=device) for _ in range(4))
    st = tuple(torch.zeros((1, 2, hd), device=device) for _ in range(4))
    return z, r, st


CALLS = {
    "mlstm_parallel": lambda dev: ML.mlstm_parallel(*_mlstm_operands(dev)[0]),
    "mlstm_recurrent": lambda dev: ML.mlstm_recurrent(
        *_mlstm_operands(dev)[0], *_mlstm_operands(dev)[1]),
    "slstm": lambda dev: SL.slstm(*_slstm_operands(dev)),
}
KERNELS = {
    "mlstm_parallel": lambda: ML.mlstm_parallel_cuda(*_mlstm_operands()[0]),
    "mlstm_parallel_stats": lambda: ML.mlstm_parallel_stats_cuda(
        *_mlstm_operands()[0]),
    "mlstm_recurrent": lambda: ML.mlstm_recurrent_cuda(
        *_mlstm_operands()[0], *_mlstm_operands()[1]),
    "slstm": lambda: SL.slstm_cuda(*_slstm_operands()),
}


@pytest.mark.parametrize("name", list(CALLS))
def test_dispatch_takes_plain_on_cpu_and_refuses_other_devices(name):
    before = (ML.launches_parallel, ML.launches_recurrent, SL.launches)
    out = CALLS[name]("cpu")
    out = out[0] if isinstance(out, tuple) else out
    assert out.shape == (1, 4, 2, 32) and out.dtype == torch.float32
    assert (ML.launches_parallel, ML.launches_recurrent,
            SL.launches) == before
    with pytest.raises(ValueError, match="CUDA or CPU"):
        CALLS[name]("meta")


@pytest.mark.parametrize("name", list(KERNELS))
def test_kernel_wrappers_refuse_cpu_tensors(name):
    """A kernel wrapper never computes on the CPU: it raises before any
    launch or build."""
    with pytest.raises(ValueError, match="CUDA device"):
        KERNELS[name]()


def _backward_operands():
    """The backward wrappers' arguments on the CPU."""
    (q, k, v, ig, fg), st = _mlstm_operands()
    z, r, sst = _slstm_operands()
    stats = torch.zeros(q.shape[:3] + (3,))
    return ((q, k, v, ig, torch.cumsum(fg, 1), q.clone(), q.clone(), stats),
            (z, r, sst, (z[0].clone(), torch.zeros((7, 1, 4, 2, 32))),
             z[0].clone()))


@pytest.mark.parametrize("fn", [ML._ParallelFn, ML._RecurrentFn,
                                SL._SLSTMFn])
def test_kernel_backwards_raise_naming_a8(fn):
    """The recurrence's Function's backward raises, naming why (no
    training path runs it); the other two Functions' backward wrappers
    refuse CPU tensors before any build or launch."""
    if fn is ML._RecurrentFn:
        with pytest.raises(NotImplementedError, match="no training path"):
            fn.backward(None, torch.zeros(1))
        return
    mlstm_args, slstm_args = _backward_operands()
    before = (ML.launches_parallel_bwd, SL.launches_bwd)
    with pytest.raises(ValueError, match="CUDA device"):
        if fn is ML._ParallelFn:
            ML.mlstm_parallel_backward_cuda(*mlstm_args)
        else:
            SL.slstm_backward_cuda(*slstm_args)
    assert (ML.launches_parallel_bwd, SL.launches_bwd) == before


# ------------------------------------------------------------ launchers
def test_serve_launcher_static_and_paged_refusal():
    tokens = tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "128", "--gen",
                          "4"])
    assert tokens.shape == (2, 4)
    with pytest.raises(NotImplementedError, match="SSM states are unpaged"):
        tserve.main(["--engine", "continuous", "--arch", ARCH, "--reduced",
                     "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="attention-only"):
        TE.ContinuousEngine(TCFG, None, n_slots=2, max_seq=64)


def test_train_launcher_trains_xlstm_on_cpu():
    """The train launcher trains xLSTM on the CPU, through the plain
    mixers."""
    summary = ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "2", "--batch", "2", "--seq", "32",
                           "--log-every", "1", "--verify"])
    assert np.isfinite(summary["final_loss"])
    assert len(summary["step_ms"]) == 2 and summary["digest_chain_head"]
