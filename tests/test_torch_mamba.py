"""Port parity for the Mamba block (``models/mamba.py``) and the selective
scan's plain version (``kernels/scan.py``), on the CPU against the
reference at the reduced Jamba widths (d = 128, Din = 256, N = 16), with
parameters and inputs drawn by numpy and handed to both:

* ``apply_mamba`` outputs (y, conv state, SSM state) in fp32 within 2e-5
  and the grads of every parameter and the input within 5e-5, the
  reference run at chunks 8, 32 and S (its chunked association) and the
  port at the same ``ssm_chunk`` (which changes no port result);
* bf16 outputs within 2e-2;
* prefill then one-token decodes equal to the full pass (2e-4 / 2e-3, the
  reference's own limits) and to the reference's stepwise run;
* the plain scan against a float64 sequential recurrence, and against the
  reference's chunked scan;
* the causal conv continued across call boundaries (pieces shorter than
  its k - 1 state too) equal to one call, and to the reference's;
* the scan's dispatch: CPU tensors take the plain version, other devices
  raise."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import mamba as JM
from repro_torch.configs import registry as tregistry
from repro_torch.kernels import scan as SCAN
from repro_torch.models import mamba as TM

JCFG = jregistry.get("jamba-1.5-large-398b").reduced()
TCFG = tregistry.get("jamba-1.5-large-398b").reduced()
S = 64
TOLS = {"float32": dict(atol=2e-5, rtol=2e-5),
        "bfloat16": dict(atol=2e-2, rtol=2e-2)}
GRAD_TOL = dict(atol=5e-5, rtol=5e-5)
SPLIT_TOL = dict(atol=2e-4, rtol=2e-3)


def _params(seed=0):
    """numpy parameters for one Mamba block: the matrices at their
    fan-in scale, A_log in [-1, 1.5], D, the conv bias and the dt bias
    random (the reference's inits are ones and zeros)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, d in sorted(TM.mamba_defs(TCFG).items()):
        if name == "A_log":
            v = rng.uniform(-1.0, 1.5, d.shape)
        elif len(d.shape) == 2:
            v = rng.standard_normal(d.shape) / np.sqrt(d.shape[0])
        else:
            v = 0.5 * rng.standard_normal(d.shape)
        out[name] = v.astype(np.float32)
    return out


def _x(seed=1, s=S, b=2):
    return np.random.default_rng(seed).standard_normal(
        (b, s, TCFG.d_model)).astype(np.float32)


def _jax_params(p, dtype):
    return {k: jnp.asarray(v, jnp.float32 if k in ("A_log", "D") else dtype)
            for k, v in p.items()}


def _torch_params(p, dtype):
    return {k: torch.from_numpy(v).to(torch.float32 if k in ("A_log", "D")
                                      else dtype) for k, v in p.items()}


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().detach().numpy()


@pytest.mark.parametrize("chunk", [8, 32, S])
def test_apply_mamba_matches_reference_fp32(chunk):
    p, x = _params(), _x()
    dy = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    jp = _jax_params(p, jnp.float32)

    def jloss(jp_, x_):
        y, (conv, h) = JM.apply_mamba(jp_, x_, JCFG, chunk=chunk)
        return jnp.sum(y * dy), (y, conv, h)
    (_, (jy, jconv, jh)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    tp = {k: v.requires_grad_(True) for k, v in
          _torch_params(p, torch.float32).items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, (tconv, th) = TM.apply_mamba(tp, tx, TCFG.replace(ssm_chunk=chunk))
    (ty * torch.from_numpy(dy)).sum().backward()
    for got, want in [(ty, jy), (tconv, jconv), (th, jh)]:
        np.testing.assert_allclose(_f32(got), _f32(want), **TOLS["float32"])
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), **GRAD_TOL)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]),
                                   err_msg=k, **GRAD_TOL)


def test_apply_mamba_matches_reference_bf16():
    p, x = _params(3), _x(4)
    jy, (jconv, jh) = JM.apply_mamba(_jax_params(p, jnp.bfloat16),
                                     jnp.asarray(x, jnp.bfloat16), JCFG,
                                     chunk=JCFG.ssm_chunk)
    ty, (tconv, th) = TM.apply_mamba(_torch_params(p, torch.bfloat16),
                                     torch.from_numpy(x).bfloat16(), TCFG)
    assert ty.dtype == tconv.dtype == torch.bfloat16
    assert th.dtype == torch.float32
    for got, want in [(ty, jy), (tconv, jconv), (th, jh)]:
        np.testing.assert_allclose(_f32(got), _f32(want), **TOLS["bfloat16"])


@torch.no_grad()
def test_prefill_then_decode_equals_full_pass():
    """[0, 48) in one call, then 48..63 a token at a time with the carried
    (conv, ssm) state, against one call over all 64 (the reference's test
    at the port), and the reference's own stepwise run."""
    p, x = _params(5), _x(6, b=1)
    tp = _torch_params(p, torch.float32)
    tx = torch.from_numpy(x)
    full, _ = TM.apply_mamba(tp, tx, TCFG)
    d_in, _, d_state, k_conv = TM.mamba_dims(TCFG)
    state = (torch.zeros((1, k_conv - 1, d_in)),
             torch.zeros((1, d_in, d_state)))
    y, state = TM.apply_mamba(tp, tx[:, :48], TCFG, state=state)
    ys = [y]
    for t in range(48, S):
        y, state = TM.apply_mamba(tp, tx[:, t:t + 1], TCFG, state=state)
        ys.append(y)
    steps = torch.cat(ys, 1)
    np.testing.assert_allclose(steps.numpy(), full.numpy(), **SPLIT_TOL)

    jp = _jax_params(p, jnp.float32)
    jstate = (jnp.zeros((1, k_conv - 1, d_in)), jnp.zeros((1, d_in, d_state)))
    jy, jstate = JM.apply_mamba(jp, jnp.asarray(x[:, :48]), JCFG,
                                state=jstate, chunk=8)
    jys = [jy]
    for t in range(48, S):
        jy, jstate = JM.apply_mamba(jp, jnp.asarray(x[:, t:t + 1]), JCFG,
                                    state=jstate)
        jys.append(jy)
    np.testing.assert_allclose(steps.numpy(),
                               np.asarray(jnp.concatenate(jys, 1)),
                               **TOLS["float32"])
    for got, want in zip(state, jstate):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOLS["float32"])


def _scan_operands(b, s, din, seed):
    rng = np.random.default_rng(seed)
    n = SCAN.STATE
    r = lambda *shape: rng.standard_normal(shape)              # noqa: E731
    return dict(
        u=r(b, s, din), dt=np.log1p(np.exp(r(b, s, din) - 1.0)),
        A=-np.exp(rng.uniform(-1, 1, (din, n))), B=r(b, s, n), C=r(b, s, n),
        D=r(din), z=r(b, s, din), h0=0.5 * r(b, din, n))


def _recurrence64(o):
    """The scan in float64, one step at a time (numpy)."""
    h = o["h0"].copy()
    ys = []
    for t in range(o["u"].shape[1]):
        dt = o["dt"][:, t, :, None]
        h = np.exp(dt * o["A"]) * h + (dt * o["u"][:, t, :, None]
                                       ) * o["B"][:, t, None, :]
        ys.append((h * o["C"][:, t, None, :]).sum(-1))
    y = np.stack(ys, 1) + o["D"] * o["u"]
    return y * o["z"] / (1 + np.exp(-o["z"])), h


@pytest.mark.parametrize("shape", [(2, 37, 256), (1, 1, 128), (3, 70, 384)])
def test_plain_scan_matches_the_sequential_recurrence(shape):
    o = _scan_operands(*shape, seed=sum(shape))
    t = {k: torch.from_numpy(v.astype(np.float32)) for k, v in o.items()}
    y, h = SCAN.selective_scan(*(t[k] for k in ("u", "dt", "A", "B", "C",
                                               "D", "z", "h0")), chunk=16)
    wy, wh = _recurrence64(o)
    np.testing.assert_allclose(y.numpy(), wy, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(h.numpy(), wh, atol=2e-5, rtol=2e-5)


def test_plain_scan_matches_the_references_chunked_scan():
    """The plain version's states against ``_ssm_scan_chunked`` over the
    same a = exp(dt A) and bx = dt u B (its last state and, through C, D
    and the gate, the output)."""
    o = _scan_operands(2, 64, 128, seed=9)
    f32 = {k: v.astype(np.float32) for k, v in o.items()}
    a = np.exp(f32["dt"][..., None] * f32["A"])
    bx = (f32["dt"] * f32["u"])[..., None] * f32["B"][:, :, None, :]
    for chunk in (8, 16, 64):
        h_all, h_last = JM._ssm_scan_chunked(jnp.asarray(a), jnp.asarray(bx),
                                             jnp.asarray(f32["h0"]), chunk)
        y = jnp.einsum("bsen,bsn->bse", h_all, f32["C"]) + f32["D"] * f32["u"]
        y = y * jax.nn.silu(jnp.asarray(f32["z"]))
        t = {k: torch.from_numpy(v) for k, v in f32.items()}
        ty, th = SCAN.selective_scan_plain(*(t[k] for k in (
            "u", "dt", "A", "B", "C", "D", "z", "h0")))
        np.testing.assert_allclose(ty.numpy(), np.asarray(y),
                                   **TOLS["float32"])
        np.testing.assert_allclose(th.numpy(), np.asarray(h_last),
                                   **TOLS["float32"])


@pytest.mark.parametrize("pieces", [(64,), (3, 61), (1, 1, 1, 61),
                                    (2, 30, 32), (5, 1, 2, 56)])
def test_conv_state_carries_across_call_boundaries(pieces):
    """The conv over the pieces in turn, each continuing the previous
    one's state, equals one conv over the whole sequence; each piece's
    output and state equal the reference's."""
    rng = np.random.default_rng(len(pieces))
    d_in, _, _, k = TM.mamba_dims(TCFG)
    x = rng.standard_normal((2, 64, d_in)).astype(np.float32)
    w = (rng.standard_normal((k, d_in)) / 2).astype(np.float32)
    b = rng.standard_normal(d_in).astype(np.float32)
    tw, tb = torch.from_numpy(w), torch.from_numpy(b)
    full, full_state = TM._causal_conv(torch.from_numpy(x), tw, tb, k)
    state, jstate, outs, start = None, None, [], 0
    for n in pieces:
        piece = x[:, start:start + n]
        y, state = TM._causal_conv(torch.from_numpy(piece), tw, tb, k, state)
        jy, jstate = JM._causal_conv(jnp.asarray(piece), jnp.asarray(w),
                                     jnp.asarray(b), k, jstate)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
        outs.append(y)
        start += n
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(state.numpy(), full_state.numpy())


def test_scan_dispatch_takes_the_plain_version_only_on_the_cpu():
    o = _scan_operands(1, 4, 128, seed=1)
    t = [torch.from_numpy(o[k].astype(np.float32)) for k in (
        "u", "dt", "A", "B", "C", "D", "z", "h0")]
    y, h = SCAN.selective_scan(*t, chunk=2)
    wy, wh = SCAN.selective_scan_plain(*t)
    assert torch.equal(y, wy) and torch.equal(h, wh)
    meta = [x.to("meta") for x in t]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        SCAN.selective_scan(*meta, chunk=2)
    with pytest.raises(ValueError, match="one CUDA device"):
        SCAN.scan_fwd_cuda(*t, chunk=2)


def test_fold_plain_sums_in_ascending_order():
    rng = np.random.default_rng(0)
    bc = torch.from_numpy(rng.standard_normal((2, 3, 5, 32)).astype(
        np.float32))
    ad = torch.from_numpy(rng.standard_normal((2, 128 * 17)).astype(
        np.float32))
    got_bc, got_ad = SCAN.fold_plain(bc, ad)
    assert torch.equal(got_bc, (bc[:, 0] + bc[:, 1]) + bc[:, 2])
    assert torch.equal(got_ad, ad[0] + ad[1])
