"""Port parity for the paged attention (``kernels/decode.py``).

The plain version (the CPU path) against ``repro.kernels.decode.
paged_attention`` on the same numpy inputs, with windows, segment ids and
GQA, at the reference's tolerances (fp32 2e-5, bf16 2e-2); the published
page order array-equal; and the reference's bitwise properties
(``tests/test_decode_kernel.py``) held within the port: page-table
permutations, trailing pages, co-batched rows, repetitions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode as JD
from repro_torch.kernels import decode as TD

D = 16
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def build_paged(k, v, page_size, n_extra_pages=0, perm_seed=None):
    """Scatter contiguous (B, S, Hk, D) K/V into page pools + a page table
    (numpy; the reference's test helper)."""
    b, s, hk, d = k.shape
    ppr = -(-s // page_size)
    n_pages = b * ppr + n_extra_pages
    rng = np.random.RandomState(0 if perm_seed is None else perm_seed)
    phys = np.arange(n_pages) if perm_seed is None else rng.permutation(
        n_pages)
    k_pages = np.zeros((n_pages, page_size, hk, d), np.float32)
    v_pages = np.zeros((n_pages, page_size, hk, d), np.float32)
    table = np.zeros((b, ppr), np.int32)
    pad = ppr * page_size - s
    kp = np.pad(k, ((0, 0), (0, pad), (0, 0), (0, 0)))
    vp = np.pad(v, ((0, 0), (0, pad), (0, 0), (0, 0)))
    for i in range(b):
        for j in range(ppr):
            p = phys[i * ppr + j]
            table[i, j] = p
            k_pages[p] = kp[i, j * page_size:(j + 1) * page_size]
            v_pages[p] = vp[i, j * page_size:(j + 1) * page_size]
    return k_pages, v_pages, table


def rand_qkv(seed, b, s, h, hk, l=1):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, l, h, D).astype(np.float32)
    k = rng.randn(b, s, hk, D).astype(np.float32)
    v = rng.randn(b, s, hk, D).astype(np.float32)
    lens = rng.randint(l, s + 1, size=b)
    return q, k, v, lens


def port(q, kp, vp, tbl, qpos, dtype=torch.float32, **kw):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    seg = {k: (None if a is None else t(a)) for k, a in kw.items()
           if k in ("q_segments", "kv_segments")}
    out = TD.paged_attention(t(q).to(dtype), t(kp).to(dtype), t(vp).to(dtype),
                             t(tbl), t(qpos), window=kw.get("window"), **seg)
    return out.float().numpy()


def ref(q, kp, vp, tbl, qpos, dtype="float32", **kw):
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    cast = lambda a: jnp.asarray(a).astype(dtype)       # noqa: E731
    out = JD.paged_attention(cast(q), cast(kp), cast(vp), jnp.asarray(tbl),
                             jnp.asarray(qpos), window=kw.get("window"),
                             q_segments=j(kw.get("q_segments")),
                             kv_segments=j(kw.get("kv_segments")))
    return np.asarray(out.astype(jnp.float32))


CASES = [  # (seed, b, l, h, hk, page_size, window, segments)
    (0, 3, 1, 4, 4, 8, None, False),      # decode
    (1, 3, 1, 4, 2, 4, None, False),      # decode, GQA 4/2
    (2, 1, 6, 4, 1, 8, None, False),      # prefill rows, GQA 4/1
    (3, 2, 5, 4, 2, 8, 7, False),         # window
    (4, 2, 4, 4, 4, 4, None, True),       # segment ids
    (5, 2, 3, 8, 2, 16, 9, True),         # all three
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_reference(case, dtype):
    seed, b, l, h, hk, ps, window, segs = case
    q, k, v, lens = rand_qkv(seed, b, 24, h, hk, l)
    kp, vp, tbl = build_paged(k, v, ps, n_extra_pages=2, perm_seed=seed + 1)
    qpos = (lens[:, None] - l + np.arange(l)[None]).astype(np.int32)
    kw = dict(window=window)
    if segs:
        rng = np.random.RandomState(seed + 7)
        kw["q_segments"] = rng.randint(0, 2, size=(b, l)).astype(np.int32)
        kw["kv_segments"] = rng.randint(0, 2, size=kp.shape[:2]).astype(
            np.int32)
    out = port(q, kp, vp, tbl, qpos, getattr(torch, dtype), **kw)
    want = ref(q, kp, vp, tbl, qpos, dtype, **kw)
    np.testing.assert_allclose(out, want, atol=TOL[dtype], rtol=TOL[dtype])


def test_page_reduction_order_equals_reference():
    for n in (1, 7, 64):
        np.testing.assert_array_equal(TD.page_reduction_order(n),
                                      JD.page_reduction_order(n))


def test_page_table_permutation_bitwise():
    q, k, v, lens = rand_qkv(0, 3, 24, 4, 4)
    qpos = (lens - 1).astype(np.int32)[:, None]
    base = None
    for perm_seed in (None, 1, 2, 3):
        kp, vp, tbl = build_paged(k, v, 8, n_extra_pages=5,
                                  perm_seed=perm_seed)
        out = port(q, kp, vp, tbl, qpos)
        if base is None:
            base = out
        np.testing.assert_array_equal(base, out)


def test_trailing_pages_bitwise():
    """Extra table columns pointing at garbage (even NaN) pages beyond every
    row's position change nothing, bitwise."""
    q, k, v, lens = rand_qkv(1, 3, 24, 4, 2)
    qpos = (lens - 1).astype(np.int32)[:, None]
    kp, vp, tbl = build_paged(k, v, 8, n_extra_pages=4)
    out = port(q, kp, vp, tbl, qpos)
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[-4:] = np.nan
    vp2[-4:] = np.nan
    garbage = np.random.RandomState(9).randint(kp.shape[0] - 4, kp.shape[0],
                                               size=(3, 6)).astype(np.int32)
    out_long = port(q, kp2, vp2, np.concatenate([tbl, garbage], 1), qpos)
    np.testing.assert_array_equal(out, out_long)


def test_cobatch_rows_bitwise():
    """Row 0's output is a function of row 0 alone: other rows' queries,
    pages and tables, and the batch size, leave it bitwise unchanged."""
    q, k, v, lens = rand_qkv(2, 4, 24, 4, 4)
    qpos = (lens - 1).astype(np.int32)[:, None]
    kp, vp, tbl = build_paged(k, v, 8)
    base = port(q, kp, vp, tbl, qpos)[0]
    rng = np.random.RandomState(7)
    q2 = q.copy()
    q2[1:] = rng.randn(*q2[1:].shape)
    ppr = tbl.shape[1]
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[ppr:] = rng.randn(*kp2[ppr:].shape)
    vp2[ppr:] = rng.randn(*vp2[ppr:].shape)
    tbl2 = tbl.copy()
    tbl2[1:] = tbl2[1:][:, ::-1]
    qpos2 = qpos.copy()
    qpos2[1:] = 5
    np.testing.assert_array_equal(base, port(q2, kp2, vp2, tbl2, qpos2)[0])
    np.testing.assert_array_equal(
        base, port(q[:1], kp, vp, tbl[:1], qpos[:1])[0])


def test_prefill_rows_equal_decode_rows_bitwise():
    """A chunk's row at position p is bitwise the one-row decode at p (the
    chunk-size invariance of the engine rests on it)."""
    q, k, v, _ = rand_qkv(3, 1, 24, 4, 2, l=6)
    kp, vp, tbl = build_paged(k, v, 8)
    qpos = np.arange(10, 16, dtype=np.int32)[None]
    chunk = port(q, kp, vp, tbl, qpos)
    for j in range(6):
        one = port(q[:, j:j + 1], kp, vp, tbl, qpos[:, j:j + 1])
        np.testing.assert_array_equal(chunk[:, j:j + 1], one)


def test_repetitions_bitwise():
    q, k, v, lens = rand_qkv(4, 3, 24, 4, 2)
    qpos = (lens - 1).astype(np.int32)[:, None]
    base = None
    for rep in range(20):
        perm = (rep % 5) if rep % 5 else None
        kp, vp, tbl = build_paged(k, v, 8, perm_seed=perm)
        out = port(q, kp, vp, tbl, qpos)
        if base is None:
            base = out
        np.testing.assert_array_equal(base, out)


def test_gather_kv_roundtrip_and_empty_rows():
    q, k, v, lens = rand_qkv(3, 3, 24, 4, 4)
    kp, vp, tbl = build_paged(k, v, 8, perm_seed=11)
    got = TD.gather_kv(torch.from_numpy(kp), torch.from_numpy(tbl), 24)
    np.testing.assert_array_equal(got.numpy(), k)
    want = np.asarray(JD.gather_kv(jnp.asarray(kp), jnp.asarray(tbl), 24))
    np.testing.assert_array_equal(got.numpy(), want)
    # a row with no live position (q_position -1) divides by 1: exact zeros
    out = port(q, kp, vp, tbl, np.full((3, 1), -1, np.int32))
    assert (out == 0).all()


def test_wrapper_validates():
    q = torch.zeros((2, 1, 4, D))
    pools = torch.zeros((4, 8, 2, D))
    tbl = torch.zeros((2, 3), dtype=torch.int32)
    pos = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="segment"):
        TD.paged_attention(q, pools, pools, tbl, pos,
                           q_segments=torch.zeros((2, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple"):
        TD.paged_attention(torch.zeros((2, 1, 3, D)), pools, pools, tbl, pos)
    with pytest.raises(ValueError, match="window"):
        TD.paged_attention(q, pools, pools, tbl, pos, window=0)
