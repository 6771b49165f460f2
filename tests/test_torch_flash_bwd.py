"""Port parity for the DASH backward and the full-mask forward: the plain
versions in ``repro_torch.kernels.flash_bwd`` / ``flash_fwd`` against the
reference Pallas kernels in interpret mode, and the port's own bitwise
contracts (serialized ≡ worker-parallel + ordered fold).

Inputs are drawn once with numpy and handed to both packages; bf16 inputs
are rounded from the same fp32 values on both sides. The backward of both
packages is fed the reference forward's out/lse, so each comparison holds
one function.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.schedules import make_schedule as jmake
from repro.kernels import flash_bwd as jbwd
from repro.kernels import flash_fwd as jfwd
from repro.kernels import ref as jref
from repro_torch.core.schedules import make_schedule as tmake
from repro_torch.kernels import flash_bwd as tbwd
from repro_torch.kernels import flash_fwd as tfwd
from repro_torch.kernels import ref as tref
from repro_torch.masks import SlidingWindow

SCHEDULES = [("fa3", False), ("descending", False), ("shift", False),
             ("fa3", True), ("descending", True), ("symmetric_shift", True)]


def _grad_tols(dtype):
    # the reference's grad tolerances (tests/test_kernels.py:59)
    if dtype == "bfloat16":
        return dict(atol=0.1, rtol=5e-2)
    return dict(atol=2e-5, rtol=2e-5)


def _fwd_tols(dtype):
    # the reference's forward tolerances (tests/test_kernels.py:21-22, 44)
    if dtype == "bfloat16":
        return dict(atol=2e-2, rtol=2e-2), dict(atol=1e-2, rtol=1e-3)
    return dict(atol=2e-5, rtol=2e-5), dict(atol=2e-5, rtol=2e-5)


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _both(arrs, dtype):
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def _t(x):
    """A reference array as a torch tensor of the same values."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _case(bh, s, d, dtype, causal, sched, seed, group=1):
    """Reference residuals + schedules for one backward case."""
    q, do = _arrays([(bh * group, s, d)] * 2, seed)
    k, v = _arrays([(bh, s, d)] * 2, seed + 1)
    (jq, jk, jv, jdo), (tq, tk, tv, tdo) = _both([q, k, v, do], dtype)
    heads = dict(n_heads=group, n_kv_heads=1)
    out, lse = jfwd.flash_fwd(jq, jk, jv, causal=causal, interpret=True,
                              **heads)
    js = jmake(sched, s // 128, 1, causal)
    ref = jbwd.flash_bwd(jq, jk, jv, out, lse, jdo, js, causal=causal,
                         interpret=True, **heads)
    ts = tmake(sched, s // 128, 1, causal)
    port = dict(q=tq, k=tk, v=tv, out=_t(out), lse=_t(lse), do=tdo,
                schedule=ts, causal=causal, **heads)
    return ref, port


def _check(ref, got, dtype):
    for r, g, nm in zip(ref, got, ("dq", "dk", "dv")):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=nm,
                                   **_grad_tols(dtype))


@pytest.mark.parametrize("sched,causal", SCHEDULES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bwd_matches_reference(sched, causal, dtype):
    ref, port = _case(3, 384, 64, dtype, causal, sched, seed=11)
    par = tbwd.flash_bwd(**port)
    ser = tbwd.flash_bwd(**port, worker_parallel=False)
    _check(ref, par, dtype)
    for a, b in zip(par, ser):     # the port's own contract: bit for bit
        assert torch.equal(a, b)


@pytest.mark.parametrize("bh,s,d", [(1, 256, 64), (2, 512, 128)])
@pytest.mark.parametrize("sched,causal", [("symmetric_shift", True),
                                          ("shift", False)])
def test_plain_bwd_matches_reference_at_other_shapes(bh, s, d, sched,
                                                     causal):
    ref, port = _case(bh, s, d, "float32", causal, sched, seed=bh + s + d)
    _check(ref, tbwd.flash_bwd(**port), "float32")


@pytest.mark.parametrize("group", [2, 4])
def test_plain_bwd_gqa_matches_reference(group):
    """dK/dV of a KV group folded in ascending query-head order."""
    ref, port = _case(2, 256, 32, "float32", True, "symmetric_shift",
                      seed=group, group=group)
    got = tbwd.flash_bwd(**port)
    assert got[1].shape == (2, 256, 32)
    _check(ref, got, "float32")


@pytest.mark.parametrize("sched,causal", SCHEDULES)
def test_plain_bwd_matches_untiled_oracle(sched, causal):
    """The port's oracle ``ref.mha_bwd`` equals the reference's, and the
    tiled plain backward equals both (fp32)."""
    q, k, v, do = _arrays([(2, 256, 32)] * 4, seed=5)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = tref.mha_fwd(tq, tk, tv, causal=causal)
    want = jref.mha_bwd(*(jnp.asarray(a) for a in (q, k, v)),
                        jnp.asarray(out.numpy()), jnp.asarray(lse.numpy()),
                        jnp.asarray(do), causal=causal)
    oracle = tref.mha_bwd(tq, tk, tv, out, lse, tdo, causal=causal)
    got = tbwd.flash_bwd(tq, tk, tv, out, lse, tdo,
                         tmake(sched, 2, 1, causal), causal=causal)
    for w, o, g in zip(want, oracle, got):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5)
        np.testing.assert_allclose(g.numpy(), o.numpy(), atol=2e-5,
                                   rtol=2e-5)


def test_fold_is_the_ordered_left_fold():
    """The reference's fold test (tests/test_worker_parallel_bwd.py:139):
    bitwise against a numpy fp32 left fold, masked-out (garbage) partials
    skipped; plus a tile whose only partial is -0.0, which must stay -0.0
    (a 0.0 + x start would make it +0.0). The reference fold, in interpret
    mode, agrees bit for bit."""
    rng = np.random.default_rng(0)
    n, r, s, d, blk = 2, 4, 384, 64, 128
    parts = rng.standard_normal((n, r, s, d), dtype=np.float32) * 100
    parts[:, 1, 256:] = -0.0
    parts[:, 3, :128] = np.nan          # never visited: must not leak
    visited = np.ones((r, s // blk), np.int32)
    visited[2, 0] = 0
    visited[3, 0] = 0
    visited[[0, 2, 3], 2] = 0            # tile 2: partial 1 (all -0.0) only
    got = tbwd.fold_combine(torch.from_numpy(parts), torch.from_numpy(visited),
                            blk).numpy()
    want = np.zeros((n, s, d), np.float32)
    for ti in range(s // blk):
        sl = slice(ti * blk, (ti + 1) * blk)
        acc = None
        for j in range(r):
            if visited[j, ti]:
                acc = (parts[:, j, sl].copy() if acc is None
                       else acc + parts[:, j, sl])
        want[:, sl] = acc
    assert np.array_equal(got, want)
    assert np.signbit(got[:, 256:]).all()
    ref = np.asarray(jbwd.fold_combine(jnp.asarray(parts), visited, blk,
                                       interpret=True))
    assert np.array_equal(got, ref)


@pytest.mark.parametrize("bh,sq,sk,d", [(2, 256, 256, 64), (3, 384, 384, 32),
                                        (2, 256, 384, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_mask_forward_matches_reference(bh, sq, sk, d, dtype):
    q, = _arrays([(bh, sq, d)], seed=bh)
    k, v = _arrays([(bh, sk, d)] * 2, seed=bh + 1)
    (jq, jk, jv), (tq, tk, tv) = _both([q, k, v], dtype)
    rout, rlse = jfwd.flash_fwd(jq, jk, jv, causal=False, interpret=True)
    out, lse = tfwd.flash_fwd(tq, tk, tv, causal=False)
    tol, lse_tol = _fwd_tols(dtype)
    assert out.dtype == tq.dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(rout, np.float32), **tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(rlse), **lse_tol)


def test_flash_bwd_refuses_what_it_does_not_take():
    q, k, v, do = (torch.from_numpy(a) for a in _arrays([(1, 256, 32)] * 4, 0))
    out, lse = tref.mha_fwd(q, k, v, causal=True)
    with pytest.raises(ValueError, match="causal"):
        tbwd.flash_bwd(q, k, v, out, lse, do, tmake("shift", 2, 1, False),
                       causal=True)
    with pytest.raises(ValueError, match="tiling"):
        tbwd.flash_bwd(q, k, v, out, lse, do, tmake("fa3", 4, 1, True),
                       causal=True)
    # a mask excludes the causal flag, and a mask's schedule needs its mask
    with pytest.raises(ValueError, match="supersedes"):
        tbwd.flash_bwd(q, k, v, out, lse, do, tmake("fa3", 2, 1, True),
                       causal=True, mask=SlidingWindow(64))
    with pytest.raises(ValueError, match="requires its mask"):
        tbwd.flash_bwd(q, k, v, out, lse, do,
                       tmake("shift", 2, mask=SlidingWindow(64)))
