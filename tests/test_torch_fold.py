"""Port parity for the canonical fold (``dist/fold.py``) and the plain
versions of the M-invariant GEMM and the row reductions
(``kernels/gemm.py``, ``kernels/rows.py``).

``canonical_row_dot`` against ``repro.dist.fold.canonical_row_dot`` in fp32
(2e-5), ``fixed_fold_psum`` and the scope's semantics against the
reference's; the GEMM's, the norm's and the log-softmax's plain versions
against the reference's XLA functions, and each row of their results bitwise
the same whatever the number of rows in the call (the property the serve
path needs from them)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.dist import fold as JF
from repro.models import layers as JL
from repro_torch.dist import fold as TF
from repro_torch.kernels import gemm, rows

TOL = 2e-5


def _np(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


@pytest.mark.parametrize("m,k,n,width", [(1, 128, 64, 32), (5, 256, 128, 64),
                                         (16, 352, 96, 176), (3, 64, 40, 16)])
def test_canonical_row_dot_matches_reference(m, k, n, width):
    x, w = _np((m, k), 0), _np((k, n), 1, 0.05)
    want = np.asarray(JF.canonical_row_dot(jnp.asarray(x), jnp.asarray(w),
                                           width))
    got = TF.canonical_row_dot(torch.from_numpy(x), torch.from_numpy(w),
                               width)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    # cast form, and a leading batch axis
    got16 = TF.canonical_row_dot(torch.from_numpy(x)[None],
                                 torch.from_numpy(w), width,
                                 out_dtype=torch.bfloat16)
    assert got16.shape == (1, m, n) and got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16[0].float().numpy(), want, atol=2e-2,
                               rtol=2e-2)


def test_fixed_fold_psum_is_the_ascending_left_fold():
    parts = _np((5, 3, 7), 2)
    want = np.asarray(JF.fixed_fold_psum(jnp.asarray(parts)))
    got = TF.fixed_fold_psum(torch.from_numpy(parts)).numpy()
    np.testing.assert_array_equal(got, want)
    acc = np.zeros((3, 7), np.float32)
    for p in parts:
        acc = acc + p
    np.testing.assert_array_equal(got, acc)
    with pytest.raises(NotImplementedError, match="A9"):
        TF.fixed_fold_psum(torch.from_numpy(parts), "model")


def test_canonical_scope_outer_wins_and_mesh_raises():
    assert not TF.active() and TF.scope_pages() == 0
    with TF.canonical_scope(page_size=8):
        assert TF.active() and TF.scope_pages() == 8
        with TF.canonical_scope():          # inner entry: a no-op
            assert TF.scope_pages() == 8 and TF.scope_axis() is None
        assert TF.active()
    assert not TF.active()
    with pytest.raises(NotImplementedError, match="A9"):
        with TF.canonical_scope(axis_name="model"):
            pass


@pytest.mark.parametrize("width", [0, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_plain_rows_are_m_invariant(width, dtype):
    """Each row of the plain product is bitwise the same at M = 1, 3, 4, 32
    and wherever it sits (``torch.matmul`` on the CPU is not)."""
    x = torch.from_numpy(_np((32, 128), 3)).to(dtype)
    w = torch.from_numpy(_np((128, 96), 4, 0.05)).to(dtype)
    full = gemm.matmul(x, w, shard_width=width)
    for m in (1, 3, 4):
        assert torch.equal(gemm.matmul(x[:m], w, shard_width=width), full[:m])
    moved = gemm.matmul(torch.cat([x[5:9], x[:1]]), w, shard_width=width)
    assert torch.equal(moved[4], full[0])
    want = np.asarray(JL.dot(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(w.float().numpy()).astype(
            jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)))
    np.testing.assert_allclose(full.numpy(), want, atol=TOL, rtol=TOL)


def test_gemm_wrapper_validates():
    x, w = torch.zeros((2, 64)), torch.zeros((64, 8))
    with pytest.raises(ValueError, match="shard_width"):
        gemm.matmul(x, w, shard_width=48)
    with pytest.raises(ValueError, match="takes x"):
        gemm.matmul(x, torch.zeros((32, 8)))
    with pytest.raises(TypeError, match="out_dtype"):
        gemm.matmul(x, w, out_dtype=torch.float16)


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norm_plain_matches_reference_and_is_m_invariant(norm, dtype):
    cfg = jregistry.get("stablelm-1.6b").reduced(norm=norm, dtype_name=dtype)
    x = _np((32, cfg.d_model), 5, 3.0) + 1.0
    p = {"scale": _np((cfg.d_model,), 6) + 1.0}
    if norm == "layernorm":
        p["bias"] = _np((cfg.d_model,), 7)
    want = np.asarray(JL.apply_norm(
        {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(x).astype(dtype), cfg).astype(jnp.float32))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = rows.norm(xt, tp["scale"], tp.get("bias"))
    assert got.dtype == xt.dtype
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    for m in (1, 3, 4):
        assert torch.equal(rows.norm(xt[:m], tp["scale"], tp.get("bias")),
                           got[:m])


def test_log_softmax_argmax_plain_matches_reference():
    x = _np((6, 512), 8, 4.0)
    x[2, 11] = x[2, 300] = x[2].max() + 1.0     # a tie: the lowest id wins
    lp, arg = rows.log_softmax_argmax(torch.from_numpy(x))
    want = np.asarray(jax.nn.log_softmax(jnp.asarray(x), axis=-1))
    np.testing.assert_allclose(lp.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(arg.numpy(), np.argmax(x, -1))
    assert int(arg[2]) == 11
    for m in (1, 4):
        sub_lp, sub_arg = rows.log_softmax_argmax(torch.from_numpy(x[:m]))
        assert torch.equal(sub_lp, lp[:m]) and torch.equal(sub_arg, arg[:m])
