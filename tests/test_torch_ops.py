"""Port parity for the differentiable attention op: ``dash_attention``'s
output and grads (``torch.autograd``) against the reference's
``dash_attention(interpret=True)`` through ``jax.vjp``, with native GQA
groups 1, 2 and 8, causal and full; and the op's two CPU impls against each
other. Inputs and the output cotangent are drawn once with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops as tops

TOLS = {  # (out, grads): the reference's kernel and grad tolerances
    "float32": (dict(atol=2e-5, rtol=2e-5), dict(atol=2e-5, rtol=2e-5)),
    "bfloat16": (dict(atol=2e-2, rtol=2e-2), dict(atol=0.1, rtol=5e-2)),
}


def _inputs(b, h, hk, s, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, s, d)).astype(np.float32)
    do = rng.standard_normal((b, h, s, d)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("causal,schedule", [(True, "symmetric_shift_or_shift"),
                                             (False, "symmetric_shift_or_shift"),
                                             (True, "fa3")])
@pytest.mark.parametrize("group", [1, 2, 8])
def test_dash_attention_grads_match_reference(causal, schedule, group):
    q, k, v, do = _inputs(1, 8, 8 // group, 256, 32, seed=group)
    jx = [jnp.asarray(a) for a in (q, k, v)]
    ref_out, pull = jax.vjp(
        lambda a, b, c: jops.dash_attention(a, b, c, causal=causal,
                                            schedule=schedule,
                                            interpret=True), *jx)
    ref_grads = pull(jnp.asarray(do))
    tx = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = tops.dash_attention(*tx, causal=causal, schedule=schedule)
    grads = torch.autograd.grad(out, tx, torch.from_numpy(do))
    out_tol, grad_tol = TOLS["float32"]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               **out_tol)
    for g, r, x, nm in zip(grads, ref_grads, tx, ("dq", "dk", "dv")):
        assert g.shape == x.shape and g.dtype == x.dtype
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=nm,
                                   **grad_tol)


def test_dash_attention_bf16_grads_match_reference():
    q, k, v, do = _inputs(2, 4, 2, 256, 64, seed=9)
    jx = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    ref_out, pull = jax.vjp(
        lambda a, b, c: jops.dash_attention(a, b, c, causal=True,
                                            interpret=True), *jx)
    ref_grads = pull(jnp.asarray(do, jnp.bfloat16))
    tx = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
          for a in (q, k, v)]
    out = tops.dash_attention(*tx, causal=True)
    grads = torch.autograd.grad(out, tx,
                                torch.from_numpy(do).to(torch.bfloat16))
    out_tol, grad_tol = TOLS["bfloat16"]
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(ref_out, np.float32), **out_tol)
    for g, r in zip(grads, ref_grads):
        assert g.dtype == torch.bfloat16      # cast back to the input dtype
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32), **grad_tol)


@pytest.mark.parametrize("causal", [True, False])
def test_worker_parallel_and_serialized_grads_are_bitwise_equal(causal):
    q, k, v, do = _inputs(2, 4, 2, 384, 32, seed=3)
    grads = []
    for wp in (True, False):
        tx = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = tops.dash_attention(*tx, causal=causal, worker_parallel=wp)
        grads.append(torch.autograd.grad(out, tx, torch.from_numpy(do)))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("hk", [4, 1])
def test_cuda_and_torch_impls_agree_in_grads_on_cpu(hk):
    """impl="cuda" on CPU tensors runs the kernels' plain versions; its
    grads equal autograd's through the plain attention (fp32 tolerance)."""
    q, k, v, do = _inputs(2, 4, hk, 256, 32, seed=hk)
    grads = {}
    for impl in ("cuda", "torch"):
        tx = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        out = tops.attention(*tx, causal=True, impl=impl)
        grads[impl] = torch.autograd.grad(out, tx, torch.from_numpy(do))
    for a, b in zip(grads["cuda"], grads["torch"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, rtol=2e-5)
