"""The reformulations behind the serve path's kernels, modelled on the CPU.

``csrc/paged_attn.cu`` walks a row's pages in chunks and phases: every score
of a chunk first, then each row's running max over the chunk's pages, then
p, each page's sum p and p·v, then the carry ``(l, acc)`` in ascending page
order. ``csrc/gemm.cu`` computes the canonical fold's shard partials
independently, several at once, and adds them onto the running sum in
ascending shard order. Neither kernel runs here, so each reformulation is a
test-local model written with the same elementwise torch ops as the plain
version it must equal bit for bit (fp32): the models show that the new order
of the work leaves every row's arithmetic as the plain walk has it. The
kernels themselves are held against their first designs bit for bit on the
card (``tests/test_torch_cuda.py``, ``chip_smoke.py``)."""
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
