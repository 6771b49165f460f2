"""Port parity for the differentiable attention op: ``dash_attention``'s
output and grads (``torch.autograd``) against the reference's
``dash_attention(interpret=True)`` through ``jax.vjp``, with native GQA
groups 1, 2 and 8, causal, full and block-sparse masks; ``torch_attention``
with masks, segment ids and query chunks against ``xla_attention``; and the
op's two CPU impls against each other. Inputs and the output cotangent are
drawn once with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import masks as JM
from repro.kernels import ops as jops
from repro_torch import masks as TM
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


# ---------------------------------------------------- block-sparse masks
MASKS = {
    "window": lambda m: m.SlidingWindow(96),
    "document": lambda m: m.Document.from_lengths((100, 156)),
    "sink": lambda m: m.Causal() & m.Sink(16),
}
# the reference's fp32 tolerance for masked grads (tests/test_mask_kernels.py)
MASK_TOL = dict(atol=3e-5, rtol=3e-5)


def _vjp_reference(fn, q, k, v, do):
    jx = [jnp.asarray(a) for a in (q, k, v)]
    out, pull = jax.vjp(fn, *jx)
    return np.asarray(out), [np.asarray(g) for g in pull(jnp.asarray(do))]


def _port_grads(fn, q, k, v, do):
    tx = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = fn(*tx)
    return out, torch.autograd.grad(out, tx, torch.from_numpy(do))


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("name", list(MASKS))
def test_masked_dash_attention_grads_match_reference(name, group):
    """dash_attention(mask=…) out and grads against the reference's
    dash_attention(mask=…, interpret=True) through jax.vjp, native GQA."""
    q, k, v, do = _inputs(1, 4, 4 // group, 256, 32, seed=len(name) + group)
    jmask, tmask = MASKS[name](JM), MASKS[name](TM)
    ref_out, ref_grads = _vjp_reference(
        lambda a, b, c: jops.dash_attention(a, b, c, mask=jmask, block=64,
                                            interpret=True), q, k, v, do)
    out, grads = _port_grads(
        lambda a, b, c: tops.dash_attention(a, b, c, mask=tmask, block=64),
        q, k, v, do)
    np.testing.assert_allclose(out.detach().numpy(), ref_out, **MASK_TOL)
    for g, r, nm in zip(grads, ref_grads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), r, err_msg=nm, **MASK_TOL)


TORCH_CASES = {   # (causal, mask, segments)
    "mask": (False, "window", False),
    "causal_segments": (True, None, True),
    "mask_segments": (False, "document", True),
    "causal_mask": (True, "sink", False),
}


@pytest.mark.parametrize("chunk_q", [None, 64])
@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("case", list(TORCH_CASES))
def test_torch_attention_masks_segments_and_chunks_match_reference(
        case, group, chunk_q):
    """torch_attention with a mask, with segment ids, and on the
    query-chunked path (S > chunk_q), out and grads against
    xla_attention's."""
    causal, mask_name, segments = TORCH_CASES[case]
    q, k, v, do = _inputs(2, 4, 4 // group, 256, 32, seed=group)
    seg = np.repeat(np.array([[1, 2, 3, 4], [1, 1, 2, 2]]), 64,
                    axis=1).astype(np.int32) if segments else None
    kw = dict(causal=causal, chunk_q=chunk_q)
    jkw = dict(kw, mask=MASKS[mask_name](JM) if mask_name else None,
               segment_ids=None if seg is None else jnp.asarray(seg))
    tkw = dict(kw, mask=MASKS[mask_name](TM) if mask_name else None,
               segment_ids=None if seg is None else torch.from_numpy(seg))
    ref_out, ref_grads = _vjp_reference(
        lambda a, b, c: jops.xla_attention(a, b, c, **jkw), q, k, v, do)
    out, grads = _port_grads(
        lambda a, b, c: tops.torch_attention(a, b, c, **tkw), q, k, v, do)
    out_tol, grad_tol = TOLS["float32"]
    np.testing.assert_allclose(out.detach().numpy(), ref_out, **out_tol)
    for g, r, nm in zip(grads, ref_grads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(g.numpy(), r, err_msg=nm, **grad_tol)


def test_chunked_attention_matches_the_unchunked_one():
    """The chunked path (one checkpointed chunk at a time) computes the
    unchunked function: end-aligned causal at sq == sk, and a window."""
    q, k, v, do = _inputs(1, 4, 2, 512, 32, seed=4)
    for kw in (dict(causal=True), dict(mask=TM.SlidingWindow(100))):
        whole, gw = _port_grads(
            lambda a, b, c: tops.torch_attention(a, b, c, **kw), q, k, v, do)
        parts, gp = _port_grads(
            lambda a, b, c: tops.torch_attention(a, b, c, chunk_q=128, **kw),
            q, k, v, do)
        out_tol, grad_tol = TOLS["float32"]
        np.testing.assert_allclose(parts.detach().numpy(),
                                   whole.detach().numpy(), **out_tol)
        for a, b in zip(gp, gw):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **grad_tol)


@pytest.mark.parametrize("spec,causal", [(TM.Full(), False),
                                         (TM.Causal(), True)])
def test_full_and_causal_specs_take_the_flag_form_bitwise(spec, causal):
    q, k, v, do = _inputs(1, 4, 2, 256, 32, seed=6)
    a_out, a_grads = _port_grads(
        lambda a, b, c: tops.dash_attention(a, b, c, mask=spec), q, k, v, do)
    b_out, b_grads = _port_grads(
        lambda a, b, c: tops.dash_attention(a, b, c, causal=causal), q, k, v,
        do)
    assert torch.equal(a_out, b_out)
    for x, y in zip(a_grads, b_grads):
        assert torch.equal(x, y)


def test_masked_dash_attention_refuses_what_it_does_not_take():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 256, 32, 0))
    mask = TM.SlidingWindow(96)
    for bad in ("descending", "symmetric_shift"):
        with pytest.raises(ValueError, match="placement"):
            tops.dash_attention(q, k, v, mask=mask, schedule=bad)
    with pytest.raises(ValueError, match="supersedes"):
        tops.dash_attention(q, k, v, causal=True, mask=mask)
    # the fa3 placement is taken, and differs from shift only in order
    a = tops.dash_attention(q, k, v, mask=mask, schedule="fa3")
    b = tops.dash_attention(q, k, v, mask=mask)
    assert torch.equal(a, b)


def test_segment_ids_always_take_the_plain_path():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 2, 2, 256, 32, 1))
    seg = torch.from_numpy(np.repeat([[1, 2]], 128, axis=1).astype(np.int32))
    got = tops.attention(q, k, v, causal=True, impl="cuda", segment_ids=seg)
    want = tops.torch_attention(q, k, v, causal=True, segment_ids=seg)
    assert torch.equal(got, want)
