"""The reformulations behind the serve path's kernels, modelled on the CPU.

``csrc/paged_attn.cu`` walks a row's pages in chunks and phases: every score
of a chunk first, then each row's running max over the chunk's pages, then
p, each page's sum p and p·v, then the carry ``(l, acc)`` in ascending page
order. ``csrc/gemm.cu`` computes the canonical fold's shard partials
independently, several at once, and adds them onto the running sum in
ascending shard order. ``csrc/rows.cu`` spreads the row log-softmax's
1024 chains over a cluster of CTAs, several threads a chain, and gathers
the warp partials across the cluster. No kernel runs here, so each reformulation is a
test-local model written with the same elementwise torch ops as the plain
version (or the first design's tree) it must equal bit for bit (fp32): the
models show that the new order of the work leaves every row's arithmetic
as it was. The kernels themselves are held against their first designs bit
for bit on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode as TD
from repro_torch.kernels import gemm as TG

F32 = torch.float32
NEG = TD.NEG_INF
ROWS_A_TILE = 8          # query rows a CTA of csrc/paged_attn.cu


def _row_ranges(qpos, window, ps, max_pages):
    """Per row: (lo, page_lo, page_hi), page_hi -1 for a row with no live
    position (the kernel's rule)."""
    out = []
    for qp in qpos:
        lo = max(0, qp - window + 1) if window else 0
        hi = -1 if qp < 0 or lo > qp else min(qp // ps, max_pages - 1)
        out.append((lo, lo // ps, hi))
    return out


def paged_walk_phased(q, k_pages, v_pages, page_table, q_positions, scale,
                      window=None, q_segments=None, kv_segments=None,
                      chunk_pages=4):
    """The kernel's walk: per (b, KV head, tile of 8 rows) the hull of the
    rows' pages in chunks of ``chunk_pages``, each chunk in phases (b)-(e),
    a page outside a row's range skipped for that row; arithmetic as
    :func:`decode.paged_attention_plain` writes it."""
    b, l, h, d = q.shape
    _, ps, hk, _ = k_pages.shape
    g, max_pages = h // hk, page_table.shape[1]
    out = torch.zeros((b, l, h, d), dtype=F32)
    qf = q.to(F32) * scale
    for bi in range(b):
        qpos = [int(v) for v in q_positions[bi]]
        for kv in range(hk):
            for r0 in range(0, l * g, ROWS_A_TILE):
                rows = range(r0, min(r0 + ROWS_A_TILE, l * g))
                ls = [r // g for r in rows]
                heads = [kv * g + r % g for r in rows]
                rq = torch.stack([qf[bi, li, hh] for li, hh in zip(ls, heads)])
                rng = _row_ranges([qpos[li] for li in ls], window, ps,
                                  max_pages)
                live_rows = [x for x in rng if x[2] >= 0]
                n = len(ls)
                m = torch.full((n,), NEG, dtype=F32)
                lsum = torch.zeros((n,), dtype=F32)
                acc = torch.zeros((n, d), dtype=F32)
                if live_rows:
                    c_lo = min(x[1] for x in live_rows)
                    c_hi = max(x[2] for x in live_rows)
                else:
                    c_lo, c_hi = 0, -1
                for c0 in range(c_lo, c_hi + 1, chunk_pages):
                    pages = list(range(c0, min(c0 + chunk_pages, c_hi + 1)))
                    phys = page_table[bi, pages].long()
                    kc = k_pages[phys, :, kv].to(F32).reshape(-1, d)
                    vc = v_pages[phys, :, kv].to(F32).reshape(-1, d)
                    at = torch.tensor([j * ps + s for j in pages
                                       for s in range(ps)])
                    jof = torch.tensor([j for j in pages for _ in range(ps)])
                    qp_t = torch.tensor([qpos[li] for li in ls])[:, None]
                    lo_t = torch.tensor([x[0] for x in rng])[:, None]
                    plo_t = torch.tensor([x[1] for x in rng])[:, None]
                    phi_t = torch.tensor([x[2] for x in rng])[:, None]
                    in_rng = (jof >= plo_t) & (jof <= phi_t)
                    live = in_rng & (at <= qp_t) & (at >= lo_t)
                    if q_segments is not None:
                        seg = kv_segments[phys].reshape(-1)
                        qs = torch.tensor([int(q_segments[bi, li])
                                           for li in ls])[:, None]
                        live = live & (seg[None] == qs)
                    # (b) every score of the chunk for every row
                    sc = torch.zeros((n, len(at)), dtype=F32)
                    for e in range(d):
                        sc = sc + rq[:, e, None] * kc[None, :, e]
                    sm = torch.where(live, sc, torch.full_like(sc, NEG))
                    # (c) page maxima, then the running max page by page
                    pmax = sm.reshape(n, len(pages), ps).amax(-1)
                    page_in = in_rng.reshape(n, len(pages), ps)[..., 0]
                    mprev = torch.empty((n, len(pages)), dtype=F32)
                    mnew = torch.empty((n, len(pages)), dtype=F32)
                    for jj in range(len(pages)):
                        mn = torch.maximum(m, pmax[:, jj])
                        mprev[:, jj], mnew[:, jj] = m, mn
                        m = torch.where(page_in[:, jj], mn, m)
                    # (d) p, corr, each page's sum p and p.v
                    mpos = mnew.repeat_interleave(ps, 1)
                    p = torch.where(live, torch.exp(sm - mpos),
                                    torch.zeros_like(sm))
                    corr = torch.exp(mprev - mnew)
                    p3 = p.reshape(n, len(pages), ps)
                    l3 = live.reshape(n, len(pages), ps)
                    v3 = vc.reshape(len(pages), ps, d)
                    psum = torch.zeros((n, len(pages)), dtype=F32)
                    pv = torch.zeros((n, len(pages), d), dtype=F32)
                    for s in range(ps):
                        psum = psum + p3[..., s]
                        pv = pv + torch.where(
                            l3[..., s, None], p3[..., s, None] * v3[None, :, s],
                            torch.zeros_like(pv))
                    # (e) the carry, ascending page order
                    for jj in range(len(pages)):
                        keep = page_in[:, jj]
                        lsum = torch.where(keep, lsum * corr[:, jj]
                                           + psum[:, jj], lsum)
                        acc = torch.where(keep[:, None],
                                          acc * corr[:, jj, None]
                                          + pv[:, jj], acc)
                denom = torch.where(lsum == 0.0, torch.ones_like(lsum), lsum)
                res = acc / denom[:, None]
                for i, (li, hh) in enumerate(zip(ls, heads)):
                    out[bi, li, hh] = res[i]
    return out.to(q.dtype)


def _paged_case(seed, b, l, h, hk, d, ps, n_pg, window, segments, nan_pages):
    """Pools at permuted physical ids (+ ``nan_pages`` unused NaN pages
    behind trailing table columns), q, each row's last ``l`` positions up
    to a seeded length, numpy-seeded."""
    rng = np.random.RandomState(seed)
    n_pages = b * n_pg + nan_pages
    kp = torch.from_numpy(rng.randn(n_pages, ps, hk, d).astype(np.float32))
    vp = torch.from_numpy(rng.randn(n_pages, ps, hk, d).astype(np.float32))
    perm = rng.permutation(n_pages)
    table = perm[:b * n_pg].reshape(b, n_pg)
    if nan_pages:
        spare = perm[b * n_pg:]
        kp[spare] = float("nan")
        vp[spare] = float("nan")
        table = np.concatenate([table, np.tile(spare, (b, 1))], 1)
    ends = rng.randint(l, n_pg * ps + 1, size=(b, 1))
    qpos = ends - l + np.arange(l)
    q = torch.from_numpy(rng.randn(b, l, h, d).astype(np.float32))
    kw = {"window": window}
    if segments:
        kw["q_segments"] = torch.from_numpy(
            rng.randint(0, 2, (b, l)).astype(np.int32))
        kw["kv_segments"] = torch.from_numpy(
            rng.randint(0, 2, (n_pages, ps)).astype(np.int32))
    return (q, kp, vp, torch.from_numpy(table.astype(np.int32)),
            torch.from_numpy(qpos.astype(np.int32)), kw)


PAGED_CASES = {  # (b, l, h, hk, d, page size, pages a row, window, segments,
                 #  trailing NaN pages)
    "decode": (4, 1, 4, 4, 16, 4, 6, None, False, 0),
    "prefill": (1, 11, 4, 4, 16, 4, 6, None, False, 0),
    "window": (2, 5, 4, 2, 16, 4, 7, 9, False, 0),
    "segments": (2, 4, 4, 2, 16, 4, 5, None, True, 0),
    "gqa_32_8": (2, 2, 32, 8, 8, 4, 4, None, False, 0),
    "trailing_nan_pages": (3, 3, 4, 2, 16, 4, 5, None, False, 3),
}


@pytest.mark.parametrize("chunk_pages", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_phased_paged_walk_equals_the_plain_walk_bitwise(case, chunk_pages):
    b, l, h, hk, d, ps, n_pg, window, segments, nan_pages = PAGED_CASES[case]
    q, kp, vp, table, qpos, kw = _paged_case(
        len(case) + chunk_pages, b, l, h, hk, d, ps, n_pg, window, segments,
        nan_pages)
    scale = d ** -0.5
    plain = TD.paged_attention_plain(q, kp, vp, table, qpos, scale, **kw)
    phased = paged_walk_phased(q, kp, vp, table, qpos, scale,
                               chunk_pages=chunk_pages, **kw)
    assert torch.isfinite(plain).all()
    assert torch.equal(phased, plain)


def canonical_by_stages(x, w, shard_width, shards_a_stage):
    """The canonical GEMM as the kernel orders its work: each shard's
    partial an independent product from 0, computed a stage
    (``shards_a_stage`` shards) at a time, the stages and the shards within
    a stage in reverse order; then the partials added onto a running sum
    from 0 in ascending shard order."""
    k, n = w.shape
    xf, wf = x.reshape(-1, k).to(F32), w.to(F32)
    starts = list(range(0, k, shard_width))
    stages = [starts[i:i + shards_a_stage]
              for i in range(0, len(starts), shards_a_stage)]
    rows = []
    for i in range(xf.shape[0]):
        xi = xf[i:i + 1].clone()
        part = {}
        for stage in reversed(stages):
            for s in reversed(stage):
                part[s] = xi[:, s:s + shard_width] @ wf[s:s + shard_width]
        acc = torch.zeros((1, n), dtype=F32)
        for s in starts:
            acc = acc + part[s]
        rows.append(acc)
    return torch.cat(rows).reshape(x.shape[:-1] + (n,))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n,width,sps", [(4, 352, 40, 176, 2),
                                             (3, 512, 24, 64, 8),
                                             (5, 384, 16, 64, 3),
                                             (1, 256, 8, 16, 8)])
def test_independent_shards_folded_ascending_equal_plain_bitwise(
        m, k, n, width, sps, dtype):
    rng = np.random.RandomState(k + n)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.randn(k, n) * 0.05).astype(np.float32)).to(
        dtype)
    plain = TG.matmul_plain(x, w, shard_width=width)
    assert torch.equal(canonical_by_stages(x, w, width, sps), plain)
    if k // width < 3:
        return
    # and the fold's order is what fixes the bits: a descending fold of the
    # same partials gives other bits for some element
    xf, wf = x.to(F32), w.to(F32)
    desc = torch.zeros((m, n), dtype=F32)
    for s in reversed(range(0, k, width)):
        desc = desc + torch.cat([xf[i:i + 1, s:s + width] @ wf[s:s + width]
                                 for i in range(m)])
    assert not torch.equal(desc, plain)


# ------------------------------------------- the row log-softmax's cluster
# csrc/rows_v1.cu takes a row's log-softmax and argmax in one CTA of 1024
# chains (chain t: i = t, t + 1024, ... ascending), a xor butterfly in each
# warp of 32 chains, and the 32 warp partials folded from empty (sums from
# 0) in ascending order. csrc/rows.cu spreads the chains over a cluster of C
# CTAs with H threads a chain: a chain's argmax as H interleaved sub-chains
# joined in order, the warp partials pushed to every CTA and the argmax's
# fold taken as a butterfly over them (warp 0's NaN kept). The models below
# write both with the same elementwise fp32 torch ops, vectorised over the
# 1024 chains; the exps are one tensor both read, since the kernel's order
# of work leaves each element's exp as it was.
CHAINS = 1024
MINUS_INF = float("-inf")


def _arg_better(v, i, v2, i2):
    """rows_v1.cu's rule: the larger value, the lower index on ties, an
    index < 0 empty (a NaN compares false: taken only into an empty
    pair)."""
    take = (i2 >= 0) & ((i < 0) | (v2 > v) | ((v2 == v) & (i2 < i)))
    return torch.where(take, v2, v), torch.where(take, i2, i)


def _chain_grid(x):
    """Row x (V,) as (n_max, 1024): element [k, t] = x[t + 1024 k], its
    index, and whether it exists."""
    v = x.numel()
    n_max = -(-v // CHAINS)
    grid = torch.zeros(n_max * CHAINS, dtype=F32)
    grid[:v] = x
    idx = torch.arange(n_max * CHAINS, dtype=torch.int64)
    return (grid.view(n_max, CHAINS), idx.view(n_max, CHAINS),
            (idx < v).view(n_max, CHAINS))


def _butterfly(vals, combine):
    """Each warp of 32 lanes' xor butterfly (16, 8, 4, 2, 1), every lane
    reading its partner's value of the step before."""
    lanes = torch.arange(CHAINS)
    for o in (16, 8, 4, 2, 1):
        partner = lanes ^ o
        vals = combine(vals, tuple(t[partner] for t in vals))
    return vals


def _lane0(t):
    return t.view(-1, 32)[:, 0]


def _exps(grid, mx):
    return torch.exp(grid - mx)


def log_softmax_one_cta(x):
    """rows_v1.cu's tree: (log-softmax (V,), argmax)."""
    grid, idx, valid = _chain_grid(x)
    v = torch.full((CHAINS,), MINUS_INF)
    i = torch.full((CHAINS,), -1, dtype=torch.int64)
    for k in range(grid.shape[0]):
        v, i = _arg_better(v, i, grid[k], torch.where(valid[k], idx[k], -1))
    v, i = _butterfly((v, i), lambda a, b: _arg_better(*a, *b))
    mx, mi = torch.tensor(MINUS_INF), torch.tensor(-1)
    for pv, pi in zip(_lane0(v), _lane0(i)):
        mx, mi = _arg_better(mx, mi, pv, pi)
    e = _exps(grid, mx)
    s = torch.zeros(CHAINS, dtype=F32)
    for k in range(grid.shape[0]):
        s = torch.where(valid[k], s + e[k], s)
    (s,) = _butterfly((s,), lambda a, b: (a[0] + b[0],))
    tot = torch.zeros((), dtype=F32)
    for p in _lane0(s):
        tot = tot + p
    return (x - mx) - torch.log(tot), int(mi)


def log_softmax_cluster(x, c, h):
    """rows.cu's order of the work, a cluster of ``c`` CTAs with ``h``
    threads a chain: (log-softmax (V,), argmax, the max each CTA folds)."""
    grid, idx, valid = _chain_grid(x)
    subs = []
    for q in range(h):
        v = torch.full((CHAINS,), MINUS_INF)
        i = torch.full((CHAINS,), -1, dtype=torch.int64)
        for k in range(q, grid.shape[0], h):
            if k == 0:              # the head, whatever it holds
                take = valid[0]
            else:                   # a strictly larger value
                take = valid[k] & (grid[k] > v)
            v, i = torch.where(take, grid[k], v), torch.where(take, idx[k], i)
        subs.append((v, i))
    v, i = subs[0]
    for sv, si in subs[1:]:
        v, i = _arg_better(v, i, sv, si)
    v, i = _butterfly((v, i), lambda a, b: _arg_better(*a, *b))
    # the partials pushed by CTA r's warps land in slot w of every CTA:
    # gathered CTA by CTA, warp by warp, i.e. in ascending warp order
    per_cta = CHAINS // c // 32
    order = [r * per_cta + w for r in range(c) for w in range(per_cta)]
    pv, pi = _lane0(v)[order], _lane0(i)[order]
    # each CTA's fold: warp 0's partial if a NaN, else a butterfly over
    # the partials with the NaNs emptied
    nan = torch.isnan(pv)
    tv = torch.where(nan, MINUS_INF, pv)
    ti = torch.where(nan, -1, pi)
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        tv, ti = _arg_better(tv, ti, tv[lanes ^ o], ti[lanes ^ o])
    maxes = [(pv[0], pi[0]) if nan[0] else (tv[lane], ti[lane])
             for lane in range(32)]
    mx, mi = maxes[0]
    e = _exps(grid, mx)
    s = torch.zeros(CHAINS, dtype=F32)
    for k in range(grid.shape[0]):      # the owner's ascending adds
        s = torch.where(valid[k], s + e[k], s)
    (s,) = _butterfly((s,), lambda a, b: (a[0] + b[0],))
    tot = torch.zeros((), dtype=F32)
    for p in _lane0(s)[order]:
        tot = tot + p
    return (x - mx) - torch.log(tot), int(mi), maxes


def _special_row(v, kind, rng):
    """A row of ``v`` fp32 logits: random, or with the sampler's hard
    cases."""
    x = torch.from_numpy((rng.randn(v) * 4).astype(np.float32))
    top = float(x.max()) + 1.0
    if kind == "tie":
        x[11] = x[7 * v // 10] = top
    elif kind == "topk_mask":               # engine.py's -1e30 mask
        keep = torch.from_numpy(rng.permutation(v)[:40])
        m = torch.full((v,), -1e30)
        m[keep] = x[keep]
        m[keep[3]] = m[keep[17]] = top
        x = m
    elif kind == "inf":
        x[v // 3] = x[v - 2] = float("inf")
        x[[5, v // 7, v - 1]] = MINUS_INF
    elif kind == "neg_inf":
        x[:] = MINUS_INF
        x[v // 4] = 2.0
    elif kind == "nan_head":                # the head of chain 0
        x[0] = float("nan")
    elif kind == "nan_warp_head":           # heads warp 2's chain 64
        x[64] = float("nan")
    elif kind == "nan_inside":
        x[min(v - 1, 3 * CHAINS + 5)] = float("nan")
    elif kind == "signed_zero":             # max 0 as -0.0 and +0.0
        x = -x.abs() - 1.0
        x[100], x[50], x[v - 3] = -0.0, 0.0, -0.0
    return x


ROW_KINDS = ["random", "tie", "topk_mask", "inf", "neg_inf", "nan_head",
             "nan_warp_head", "nan_inside", "signed_zero"]


def _bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("c", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("v", [1000, 100352, 131072, 152064])
def test_cluster_log_softmax_equals_one_cta_tree_bitwise(v, c):
    rng = np.random.RandomState(v + c)
    for kind in ROW_KINDS:
        x = _special_row(v, kind, rng)
        want, want_arg = log_softmax_one_cta(x)
        for h in (1, 4, 8):
            got, got_arg, maxes = log_softmax_cluster(x, c, h)
            assert torch.equal(_bits(got), _bits(want)), (kind, h)
            assert got_arg == want_arg, (kind, h)
            # every CTA (every lane of the fold) finds the same max
            assert all(torch.equal(_bits(m[0]), _bits(maxes[0][0]))
                       and int(m[1]) == int(maxes[0][1]) for m in maxes)
    # and the rules are what fix the bits: emptying warp 0's NaN like the
    # others' moves the argmax of the NaN-headed row, and the sums folded
    # in descending warp order give another row for some random row
    x = _special_row(v, "nan_head", rng)
    grid, idx, valid = _chain_grid(x)
    _, want_arg = log_softmax_one_cta(x)
    finite = torch.where(torch.isnan(x), MINUS_INF, x)
    assert want_arg == 0 and int(torch.argmax(finite)) != 0
    sums = []
    for _ in range(4):
        grid, _, valid = _chain_grid(_special_row(v, "random", rng))
        e = _exps(grid, grid.max())
        s = torch.zeros(CHAINS, dtype=F32)
        for k in range(grid.shape[0]):
            s = torch.where(valid[k], s + e[k], s)
        sums.append(_lane0(_butterfly((s,), lambda a, b: (a[0] + b[0],))[0]))
    asc, desc = [], []
    for parts in sums:
        a_ = d_ = torch.zeros((), dtype=F32)
        for p_ in parts:
            a_ = a_ + p_
        for p_ in reversed(parts):
            d_ = d_ + p_
        asc.append(a_)
        desc.append(d_)
    assert not torch.equal(torch.stack(asc), torch.stack(desc))


@pytest.mark.parametrize("v", [1000, 100352, 131072, 152064])
def test_cluster_log_softmax_model_matches_plain(v):
    """The model's log-softmax against the plain version the CPU path runs
    (itself held to ``jax.nn.log_softmax`` in test_torch_fold.py), fp32
    2e-5; the argmax equal on rows without a NaN."""
    from repro_torch.kernels import rows
    rng = np.random.RandomState(v)
    for kind in ROW_KINDS:
        x = _special_row(v, kind, rng)
        got, got_arg, _ = log_softmax_cluster(x, 16, 4)
        plain, plain_arg = rows.log_softmax_argmax_plain(x[None])
        torch.testing.assert_close(got, plain[0], atol=2e-5, rtol=2e-5,
                                   equal_nan=True)
        if not torch.isnan(x).any():
            assert got_arg == int(plain_arg[0]), kind
