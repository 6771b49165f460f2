"""Port parity for the block-sparse mask kernels' plain versions: the masked
forward (``flash_fwd(mask=)``) and the masked DASH backward (worker-parallel
+ ordered fold, and serialized) against the reference's Pallas kernels in
interpret mode, for the reference's mask families plus ``Causal() &
Sink(16)`` (which leaves KV rows with no task) × fp32/bf16 × GQA groups 1
and 2; and the port's own contracts: serialized ≡ worker + fold bit for bit
under every mask and placement, KV rows no task visits come out exactly 0.

Inputs are drawn once with numpy and handed to both packages; the backward
of both is fed the reference forward's out/lse. Tolerances are the
reference's (``tests/test_mask_kernels.py:36-38``, forward
``tests/test_kernels.py:21-22,44``).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import masks as JM
from repro.kernels import flash_bwd as jbwd
from repro.kernels import flash_fwd as jfwd
from repro_torch import masks as TM
from repro_torch.kernels import flash_bwd as tbwd
from repro_torch.kernels import flash_fwd as tfwd

S, D, BLK = 256, 64, 64
N = S // BLK
MASKS = {
    "window": lambda m: m.SlidingWindow(96),
    "prefix": lambda m: m.PrefixLM(80),
    "document": lambda m: m.Document.from_lengths((100, 156)),
    "streaming": lambda m: m.streaming_mask(64, 16),
    "sink": lambda m: m.Causal() & m.Sink(16),
}


def _grad_tols(dtype):
    if dtype == "bfloat16":
        return dict(atol=0.1, rtol=5e-2)
    return dict(atol=3e-5, rtol=3e-5)


def _fwd_tols(dtype):
    if dtype == "bfloat16":
        return dict(atol=2e-2, rtol=2e-2), dict(atol=1e-2, rtol=1e-3)
    return dict(atol=2e-5, rtol=2e-5), dict(atol=2e-5, rtol=2e-5)


def _t(x):
    """A reference array as a torch tensor of the same values."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _case(name, dtype, group):
    """One KV head and ``group`` query heads: the port's operands, the
    reference forward's (out, lse) and its worker-parallel backward on the
    mask's ``shift`` schedule."""
    rng = np.random.default_rng(len(name) + group)
    q, do = (rng.standard_normal((group, S, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((1, S, D)).astype(np.float32)
            for _ in range(2))
    jmask, tmask = MASKS[name](JM), MASKS[name](TM)
    jx = [jnp.asarray(a, dtype) for a in (q, k, v, do)]
    heads = dict(n_heads=group, n_kv_heads=1)
    out, lse = jfwd.flash_fwd(*jx[:3], mask=jmask, block_q=BLK, block_k=BLK,
                              interpret=True, **heads)
    sch = JM.compile_block_schedule(jmask, N, N, BLK, BLK)
    grads = jbwd.flash_bwd(*jx[:3], out, lse, jx[3], sch, block_q=BLK,
                           block_k=BLK, interpret=True, mask=jmask, **heads)
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v, do)]
    port = dict(q=tx[0], k=tx[1], v=tx[2], do=tx[3], out=_t(out), lse=_t(lse),
                mask=tmask, **heads)
    return port, (np.asarray(out, np.float32), np.asarray(lse)), tuple(
        np.asarray(g) for g in grads)


def _bwd(port, placement="shift", **kw):
    sch = TM.compile_block_schedule(port["mask"], N, N, BLK, BLK, placement)
    return tbwd.flash_bwd(port["q"], port["k"], port["v"], port["out"],
                          port["lse"], port["do"], sch, block_q=BLK,
                          block_k=BLK, mask=port["mask"],
                          n_heads=port["n_heads"],
                          n_kv_heads=port["n_kv_heads"], **kw)


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(MASKS))
def test_plain_masked_fwd_matches_reference(name, dtype, group):
    port, (rout, rlse), _ = _case(name, dtype, group)
    out, lse = tfwd.flash_fwd(port["q"], port["k"], port["v"],
                              mask=port["mask"], block_q=BLK, block_k=BLK,
                              n_heads=group, n_kv_heads=1)
    tol, lse_tol = _fwd_tols(dtype)
    assert out.dtype == port["q"].dtype and lse.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), rout, **tol)
    np.testing.assert_allclose(lse.numpy(), rlse, **lse_tol)


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(MASKS))
def test_plain_masked_bwd_matches_reference(name, dtype, group):
    port, _, ref = _case(name, dtype, group)
    par = _bwd(port)
    ser = _bwd(port, worker_parallel=False)
    for got, want, nm in zip(par, ref, ("dq", "dk", "dv")):
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, err_msg=nm,
                                   **_grad_tols(dtype))
    for a, b in zip(par, ser):       # the port's own contract: bit for bit
        assert torch.equal(a, b)


@pytest.mark.parametrize("placement", ["shift", "fa3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(MASKS))
def test_masked_bwd_serialized_equals_worker_fold_bitwise(name, dtype,
                                                          placement):
    """On the port's own forward, under both placements."""
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, S, D)).astype(
        np.float32)).to(getattr(torch, dtype)) for _ in range(4))
    mask = MASKS[name](TM)
    out, lse = tfwd.flash_fwd(q, k, v, mask=mask, block_q=BLK, block_k=BLK)
    port = dict(q=q, k=k, v=v, do=do, out=out, lse=lse, mask=mask,
                n_heads=1, n_kv_heads=1)
    sch = TM.compile_block_schedule(mask, N, N, BLK, BLK, placement)
    assert sch.worker_chains()["single_visit"]
    par = _bwd(port, placement)
    ser = _bwd(port, placement, worker_parallel=False)
    for a, b in zip(par, ser):
        assert torch.equal(a, b)
        assert bool(torch.isfinite(a).all())


@pytest.mark.parametrize("group", [1, 2])
def test_dead_kv_rows_are_exact_zeros(monkeypatch, group):
    """``Causal() & Sink(16)``: only KV tile 0 has tasks. Its dK/dV rows
    beyond come out exactly 0, as the reference's do — also when the
    backward leaves those rows uninitialised (NaN, as ``torch.empty`` under
    deterministic algorithms on the card): the zeroing comes before the
    GQA group fold."""
    port, _, ref = _case("sink", "float32", group)
    sch = TM.compile_block_schedule(port["mask"], N, N, BLK, BLK)
    assert sch.n_workers == 1 and sch.n_kv == N
    for r in ref[1:]:
        assert not r[:, BLK:].any()
    plain = tbwd.worker_bwd_plain

    def uninitialised(*args, **kw):
        dq_part, dk, dv = plain(*args, **kw)
        return dq_part, dk.index_fill(1, torch.arange(BLK, S), np.nan), \
            dv.index_fill(1, torch.arange(BLK, S), np.nan)

    monkeypatch.setattr(tbwd, "worker_bwd_plain", uninitialised)
    dq, dk, dv = _bwd(port)
    for x in (dk, dv):
        assert bool((x[:, BLK:] == 0).all()) and not torch.signbit(
            x[:, BLK:]).any()
        assert bool(torch.isfinite(x).all())
    np.testing.assert_allclose(dk.numpy(), ref[1], **_grad_tols("float32"))


def test_masked_entry_points_refuse_what_they_do_not_take():
    port, _, _ = _case("window", "float32", 1)
    q, k, v = port["q"], port["k"], port["v"]
    mask = port["mask"]
    with pytest.raises(ValueError, match="supersedes"):
        tfwd.flash_fwd(q, k, v, causal=True, mask=mask, block_q=BLK,
                       block_k=BLK)
    with pytest.raises(ValueError, match="square"):
        tfwd.flash_fwd(q, k[:, :128].contiguous(), v[:, :128].contiguous(),
                       mask=mask, block_q=BLK, block_k=BLK)
    other = TM.compile_block_schedule(TM.PrefixLM(80), N, N, BLK, BLK)
    args = (q, k, v, port["out"], port["lse"], port["do"])
    with pytest.raises(ValueError, match="compiled for mask"):
        tbwd.flash_bwd(*args, other, block_q=BLK, block_k=BLK, mask=mask)
    with pytest.raises(ValueError, match="requires its mask"):
        tbwd.flash_bwd(*args, other, block_q=BLK, block_k=BLK)
    with pytest.raises(ValueError, match="supersedes"):
        tbwd.flash_bwd(*args, other, causal=True, block_q=BLK, block_k=BLK,
                       mask=mask)
