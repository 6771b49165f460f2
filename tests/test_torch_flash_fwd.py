"""Port parity for the causal flash forward: the task grid and the plain
version of ``repro_torch.kernels.flash_fwd`` against the reference
``repro.kernels.flash_fwd`` (the Pallas kernel in interpret mode), plus the
checks the attention op must make before any kernel runs.

Inputs are drawn once with numpy and handed to both packages; bf16 inputs are
rounded from the same fp32 values on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_fwd as jfwd
from repro_torch.kernels import flash_fwd as tfwd
from repro_torch.kernels import ops as tops


def _tols(dtype):
    # the reference's own kernel tolerances (tests/test_kernels.py:21-22)
    if dtype == "bfloat16":
        return dict(atol=2e-2, rtol=2e-2)
    return dict(atol=2e-5, rtol=2e-5)


def _lse_tols(dtype):
    # bf16 as in tests/test_kernels.py; fp32 at the fp32 output tolerance
    if dtype == "bfloat16":
        return dict(atol=1e-2, rtol=1e-3)
    return dict(atol=2e-5, rtol=2e-5)


def _inputs(bh, s, d, group, seed):
    """q: (BH·group, S, D) over B=BH batches of `group` query heads sharing
    one KV head; k, v: (BH, S, D)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh * group, s, d)).astype(np.float32)
    k = rng.standard_normal((bh, s, d)).astype(np.float32)
    v = rng.standard_normal((bh, s, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("n", range(1, 17))
def test_causal_grid_matches_reference(n):
    ours = tfwd.causal_grid(n, n, 128, 128)
    ref = jfwd.causal_grid(n, n, 128, 128)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        assert np.array_equal(a, b)


@pytest.mark.parametrize("bh,s,d", [(2, 256, 64), (3, 384, 64), (2, 256, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 2])
def test_plain_flash_fwd_matches_reference(bh, s, d, dtype, group):
    q, k, v = _inputs(bh, s, d, group, seed=bh * s + d + group)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    rout, rlse = jfwd.flash_fwd(jq, jk, jv, causal=True, interpret=True,
                                n_heads=group, n_kv_heads=1)
    tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    out, lse = tfwd.flash_fwd(tq, tk, tv, causal=True, n_heads=group,
                              n_kv_heads=1)
    assert out.dtype == tq.dtype and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(rout, np.float32), **_tols(dtype))
    np.testing.assert_allclose(lse.numpy(), np.asarray(rlse), **_lse_tols(dtype))


def test_flash_fwd_refuses_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(x) for x in _inputs(1, 256, 64, 1, seed=0))
    with pytest.raises(ValueError, match="sq == sk"):
        tfwd.flash_fwd(q, k[:, :128], v[:, :128], causal=True)
    with pytest.raises(ValueError, match="multiple"):
        tfwd.flash_fwd(q[:, :200], k[:, :200], v[:, :200], causal=True)
    with pytest.raises(ValueError, match="inconsistent"):
        tfwd.flash_fwd(q, k, v, causal=True, n_heads=2, n_kv_heads=1)


def test_dash_attention_is_forward_only():
    """No longer: the DASH backward is ported, so an input that requires
    grad gets one (the schedule checks still come first)."""
    q = torch.zeros((1, 2, 128, 32), requires_grad=True)
    k = v = torch.zeros((1, 2, 128, 32))
    out = tops.dash_attention(q, k, v, causal=True)
    (dq,) = torch.autograd.grad(out.sum(), q)
    assert dq.shape == q.shape and dq.dtype == q.dtype
    with pytest.raises(ValueError, match="unknown DASH schedule"):
        tops.dash_attention(q.detach(), k, v, causal=True, schedule="bogus")
    assert tops.resolve_schedule("symmetric_shift_or_shift", True) == \
        "symmetric_shift"
    assert tops.resolve_schedule("symmetric_shift_or_shift", False) == "shift"


@pytest.mark.parametrize("hk", [4, 2])
def test_attention_impls_agree_on_cpu(hk):
    """impl="cuda" on CPU tensors takes the kernel's plain version; it must
    equal the plain torch attention (fp32, at the fp32 kernel tolerance)."""
    rng = np.random.default_rng(hk)
    q = torch.from_numpy(rng.standard_normal((2, 4, 256, 32)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, hk, 256, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, hk, 256, 32)).astype(np.float32))
    a = tops.attention(q, k, v, causal=True, impl="cuda")
    b = tops.attention(q, k, v, causal=True, impl="torch")
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-5)
