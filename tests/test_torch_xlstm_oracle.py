"""The xLSTM kernels' redesigns beside their first designs, on the CPU:
the first designs' wrappers refuse CPU tensors, all eight sources (the
two backwards and the mLSTM backward's first design too) are built and
exported under distinct names, none names an atomic, the redesigned
mLSTM backward keeps its first design's expressions, the algorithm of
the mLSTM's reduce-scatter of 32 row sums gives each sum the bits of the
first design's butterfly, the redesigned parallel form keeps the first
design's expressions, its causal pairs of query tiles cover every tile
once, and summing q . k in the tensor cores' k-steps stays well inside the
checks' tolerance. That the kernels keep the first designs' bits (or
tolerance, for the parallel form's bf16 q . k) is held on the card
(``tests/test_torch_cuda.py``)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import mlstm as ML
from repro_torch.kernels import slstm as SL

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
EXPORT = re.compile(r'^extern "C" \w+ (\w+)\(', re.MULTILINE)
# as tests/test_torch_hygiene.py: CUDA's atomic functions and PTX's atom.* /
# red.* instructions
ATOMIC = re.compile(r"atomic|\batom\.|\bred\.", re.IGNORECASE)
SOURCES = ("mlstm", "mlstm_v1", "slstm", "slstm_v1", "mlstm_parallel_v1",
           "mlstm_parallel_bwd", "slstm_bwd", "mlstm_parallel_bwd_v1")


def _mlstm_operands(b=1, s=3, h=2, hd=32, seed=0):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return (f(b, s, h, hd), f(b, s, h, hd), f(b, s, h, hd), f(b, s, h),
            f(b, s, h)), (f(b, h, hd, hd), f(b, h, hd), f(b, h))


def test_mlstm_first_design_refuses_cpu_tensors():
    args, state = _mlstm_operands()
    with pytest.raises(ValueError, match="one CUDA device"):
        ML.mlstm_recurrent_v1_cuda(*args, *state)


def test_mlstm_parallel_first_design_refuses_cpu_tensors():
    args, _ = _mlstm_operands()
    with pytest.raises(ValueError, match="one CUDA device"):
        ML.mlstm_parallel_v1_cuda(*args)


def test_slstm_first_design_refuses_cpu_tensors():
    rng = np.random.default_rng(1)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    z = tuple(f(1, 3, 2, 32) for _ in range(4))
    r = tuple(f(2, 32, 32) for _ in range(4))
    state = tuple(f(1, 2, 32) for _ in range(4))
    with pytest.raises(ValueError, match="one CUDA device"):
        SL.slstm_v1_cuda(z, r, state)


def test_mlstm_backward_first_design_refuses_cpu_tensors():
    """The backward's first design (``mlstm_parallel_backward_v1_cuda``)
    refuses CPU tensors before any build or launch, and counts in no launch
    counter."""
    args, _ = _mlstm_operands()
    before = ML.launches_parallel_bwd
    with pytest.raises(ValueError, match="one CUDA device"):
        ML.mlstm_parallel_backward_v1_cuda(*args, args[0].clone(),
                                           args[0].clone())
    assert ML.launches_parallel_bwd == before


def test_first_designs_count_no_launches():
    """A refused first-design call leaves the redesigns' counters alone
    (the first designs count in none)."""
    before = (ML.launches_parallel, ML.launches_recurrent, SL.launches)
    args, state = _mlstm_operands()
    with pytest.raises(ValueError):
        ML.mlstm_recurrent_v1_cuda(*args, *state)
    with pytest.raises(ValueError):
        ML.mlstm_parallel_v1_cuda(*args)
    assert (ML.launches_parallel, ML.launches_recurrent,
            SL.launches) == before


@pytest.mark.parametrize("name", SOURCES)
def test_xlstm_sources_are_built(name):
    assert name in build.SOURCES
    assert (CSRC / f"{name}.cu").is_file()


def test_first_designs_export_their_own_names():
    """All eight libraries can be loaded into one process: the first
    designs' entry points are the redesigns' with a ``_v1`` suffix, the
    mLSTM's recurrence, parallel form and parallel backward each in a
    source of its own, and the backwards' (the parallel form's three
    passes, the sLSTM's) are each their own, bound by the wrappers under
    those names."""
    names = {n: set(EXPORT.findall((CSRC / f"{n}.cu").read_text()))
             for n in SOURCES}
    assert {"dash_mlstm_parallel", "dash_mlstm_recurrent",
            "dash_mlstm_recurrent_layout"} <= names["mlstm"]
    assert names["mlstm_v1"] == {"dash_mlstm_recurrent_v1"}
    assert names["mlstm_parallel_v1"] == {"dash_mlstm_parallel_v1"}
    assert "dash_slstm" in names["slstm"]
    assert names["slstm_v1"] == {"dash_slstm_v1"}
    assert names["mlstm_parallel_bwd"] == set(ML.BWD_PASSES)
    assert names["mlstm_parallel_bwd_v1"] == {f"{n}_v1"
                                              for n in ML.BWD_PASSES}
    assert names["slstm_bwd"] == {"dash_slstm_bwd"}
    everything = [x for n in SOURCES for x in names[n]]
    assert len(everything) == len(set(everything))


@pytest.mark.parametrize("name", SOURCES)
def test_xlstm_sources_use_no_atomics(name):
    path = CSRC / f"{name}.cu"
    offenders = [f"{i}: {line.strip()}" for i, line in
                 enumerate(path.read_text().splitlines(), 1)
                 if ATOMIC.search(line)]
    assert not offenders, offenders


def _butterfly(x):
    """v1's warp_sum of each column of x (32 lanes, N values), fp32: every
    lane's result (all equal)."""
    x = x.copy()
    o = 16
    while o:
        x = (x + x[np.arange(32) ^ o]).astype(np.float32)
        o //= 2
    return x


def _reduce_scatter(x):
    """A NumPy model of csrc/mlstm.cu's reduce_scatter of N values a lane
    (x: 32 x N fp32): lane l's v[0] after the five xor stages."""
    lanes = np.arange(32)
    v = x.copy()
    n, o = x.shape[1], 16
    while o:
        up = (lanes & o) != 0
        if n > 1:
            half = n // 2
            lo, hi = v[:, :half], v[:, half:n]
            send = np.where(up[:, None], lo, hi)
            keep = np.where(up[:, None], hi, lo)
            v = (keep + send[lanes ^ o]).astype(np.float32)
            n = half
        else:
            v = (v + v[lanes ^ o]).astype(np.float32)
        o //= 2
    return v[:, 0]


@pytest.mark.parametrize("n", [32, 16, 8, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reduce_scatter_gives_the_butterflys_bits(n, seed):
    """Each lane's sum from the reduce-scatter is bitwise the butterfly's
    sum of that value (value l >> (5 - log2 n) for lane l), on values
    spread over many magnitudes so that the order of the additions
    shows. This checks the algorithm in a NumPy model, not the kernel: the
    kernel's bits are held against the first design's on the card."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((32, n)) * 10.0 ** rng.integers(
        -4, 5, (32, n))).astype(np.float32)
    got = _reduce_scatter(x)
    want = _butterfly(x)
    index = np.arange(32) >> (5 - int(np.log2(n)))
    assert np.array_equal(got.view(np.int32),
                          want[np.arange(32), index].view(np.int32))
    # a different association (lanes summed in order) differs somewhere
    if n == 32 and seed == 0:
        seq = np.zeros(n, dtype=np.float32)
        for lane in range(32):
            seq = (seq + x[lane]).astype(np.float32)
        assert not np.array_equal(seq.view(np.int32),
                                  want[0].view(np.int32))


def test_variant_builds_are_libraries_of_their_own():
    """A source built with -D defines (the clock64() stamps) gets its own
    library path for each set of defines; the plain build's path is
    unchanged by the option."""
    plain = build.library_path("mlstm")
    assert build.library_path("mlstm", ()) == plain
    stamped = build.library_path("mlstm", ("DASH_STAMPS",))
    assert stamped != plain and stamped.parent == plain.parent
    assert build.library_path("mlstm", ("DASH_STAMPS", "NDEBUG")) not in (
        plain, stamped)


# ------------------------------------------- the parallel form's backward
def _bwd_source(name):
    return (CSRC / f"{name}.cu").read_text()


# (what the first design computes, its expression, the redesign's): the
# row terms, the pair terms and each summation chain whose bits the
# redesign keeps
KEPT_BWD = [
    ("g_i: a lane's fmaf chain, then the xor pairs 16 .. 1",
     "g = fmaf(dout[at.row<HD>(i) + e], out[at.row<HD>(i) + e], g);",
     "for (int e = lane; e < HD; e += 32) g = fmaf(d[e], o[e], g);"),
    ("the butterfly's adds",
     "x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));",
     "x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));"),
    ("the normalizer", "const float norm = fmaxf(fabsf(s), em);",
     "const float norm = fmaxf(fabsf(s), em);"),
    ("dnorm where norm > 1e-6",
     "const float dnorm = norm > 1e-6f ? __fdiv_rn(-g, den) : 0.f;",
     "const float dnorm = norm > 1e-6f ? __fdiv_rn(-g, den) : 0.f;"),
    ("ds in the |s| branch",
     "const float ds = s_branch ? (s > 0.f ? dnorm : -dnorm) : 0.f;",
     "const float ds = s_branch ? (s > 0.f ? dnorm : -dnorm) : 0.f;"),
    ("dm", "const float dm = __fsub_rn(__fsub_rn(-g, __fmul_rn(ds, s)),",
     "const float dm = __fsub_rn(__fsub_rn(-g, __fmul_rn(ds, s)),"),
    ("dnum = dout / den, IEEE", "__fdiv_rn(x[u], den[r])",
     "__fdiv_rn(d[e], den)"),
    ("the gate decay", "return __fadd_rn(__fsub_rn(fi, fj), ij);",
     "return __fadd_rn(__fsub_rn(fi, fj), ij);"),
    ("the pair terms' weight", "const float w = expf(__fsub_rn(d, mi));",
     "const float w = expf(__fsub_rn(d, mi));"),
    ("dD with the tie share",
     "p.dd = __fadd_rn(__fmul_rn(ds, s), d == mi ? shi : 0.f);",
     "p.dd = __fadd_rn(__fmul_rn(ds, s), d == mi ? shi : 0.f);"),
    ("dv: an fmaf chain over the queries",
     "acc_dv[x] = fmaf(p4.x, a, acc_dv[x]);",
     "acc_dv[u][e] = fmaf(s[u], a[e], acc_dv[u][e]);"),
    ("dk: an fmaf chain over the queries",
     "acc_dk[x] = fmaf(g4.x, qv, acc_dk[x]);",
     "acc_dk[u][e] = fmaf(gw[u], a[e], acc_dk[u][e]);"),
    ("dq: an fmaf chain over the keys",
     "acc_dq[x] = fmaf(g4.x, kv[0], acc_dq[x]);",
     "acc[x][e] = fmaf(gw[x], kv[e], acc[x][e]);"),
    ("dig: plain adds over the queries",
     "acc_dig = __fadd_rn(acc_dig, Ds[r * BP + tid]);",
     "acc_dig = __fadd_rn(acc_dig, Ds[r * LDP + lane]);"),
    ("dF: the row sums' plain adds, less dig",
     "__fsub_rn(acc_row, dig[at.gate(i0 + tid)])",
     "__fsub_rn(acc_row, dig[at.gate(i0 + tid)])"),
]


@pytest.mark.parametrize("what,old,new", KEPT_BWD,
                         ids=[k[0] for k in KEPT_BWD])
def test_backward_redesign_keeps_the_first_designs_expressions(what, old,
                                                               new):
    """Each step whose bits the redesigned backward keeps is written with
    the first design's expression, operands renamed."""
    assert old in _bwd_source("mlstm_parallel_bwd_v1"), what
    assert new in _bwd_source("mlstm_parallel_bwd"), what


def test_backward_redesign_sums_dots_from_zero_and_bf16_qk_as_forward():
    """q . k (fp32) and dnum . v are one fmaf chain a pair over hd from +0;
    bf16 q . k is the forward's mma order (two m16n8k16 a 32-column step,
    rows as A, keys as B, one accumulator from +0); no reciprocal or fast
    exponential."""
    src = _bwd_source("mlstm_parallel_bwd")
    assert "acc[x][y] = fmaf(a[x][e], b[y][e], acc[x][y]);" in src
    assert "for (int y = 0; y < 2; ++y) acc[x][y] = 0.f;" in src
    assert "float c[4] = {0.f, 0.f, 0.f, 0.f};" in src
    assert ("dash_mma::mma_16816(c, a[0], b);\n"
            "    dash_mma::mma_16816(c, a[1], b + 2);") in src
    fwd = _parallel_section("mlstm")
    assert ("dash_mma::mma_16816(c[nt], qf[s][0], kf[nt]);\n"
            "      dash_mma::mma_16816(c[nt], qf[s][1], kf[nt] + 2);") in fwd
    assert not re.search(r"__frcp|__fdividef|rcp\.approx|__expf", src)


def test_forward_hands_over_the_backwards_row_statistics():
    """The forward's `stats` (m_i, s_i, ties_i) are its own stabilizer,
    its signed row sums and a count of its rounded D_ij equal to m_i, as
    the first design's rows pass counts them; the serve path passes none."""
    src = _parallel_section("mlstm")
    assert "ties[x] += (fi[x] - fj) + gj == mx[x];" in src
    assert "mx[x] = fmaxf(mx[x], (fi[x] - fj) + gj);" in src
    assert "stats[3 * gate_off(i0 + tid - P::RS) + 1] = rs;" in src
    v1 = _bwd_source("mlstm_parallel_bwd_v1")
    assert ("ties += gate_decay(fi, F[at.gate(j)], ig[at.gate(j)]) == mx;"
            in v1)
    wrapper = (ROOT / "src" / "repro_torch" / "kernels" /
               "mlstm.py").read_text()
    assert "0 if st is None else st.data_ptr()" in wrapper


# ------------------------------------------------------- the parallel form
def _parallel_section(name):
    """The parallel form's source: all of csrc/mlstm_parallel_v1.cu, or
    csrc/mlstm.cu from its parallel-form banner to the recurrence's."""
    text = (CSRC / f"{name}.cu").read_text()
    if name == "mlstm_parallel_v1":
        return text
    start = text.index("// ---- parallel form".replace("----", "-" * 60))
    return text[start:text.index("-" * 63 + " recurrence", start)]


# (what the first design computes, its expression there, the redesign's)
KEPT = [
    ("stabilizer: the max of the rounded (F_i - F_j) + ig_j",
     "mx = fmaxf(mx, (fi - F[gate_off(j)]) + ig[gate_off(j)]);",
     "mx[x] = fmaxf(mx[x], (fi[x] - fj) + gj);"),
    ("the gate decay d = (F_i - F_j) + ig_j",
     "const float d = (Fq[r] - Fk[lane]) + Ik[lane];",
     "const float d = (Fq[r] - Fk[jj]) + Ik[jj];"),
    ("the score s = dot * exp(d - m_i)",
     "s = dot * expf(d - Mq[r]);", "s = dot * expf(d - Mq[r]);"),
    ("masking: pairs j > i and rows past S give 0",
     "if (r < rows && j0 + lane <= i0 + r) {",
     "if (r < rows && j0 + jj <= i0 + r) {"),
    ("the signed row sums: plain adds, keys ascending",
     "for (int jj = 0; jj < keys; ++jj) rs += Ss[tid * (BK + 1) + jj];",
     "if (sums) rs += r;"),
    ("S.v: one fmaf chain an output over the keys ascending",
     "acc[x] = fmaf(Ss[(rg + RG * x) * (BK + 1) + jj], vv, acc[x]);",
     "acc[x][y] = fmaf(s[x], vv[y], acc[x][y]);"),
    ("fp32 q.k: one fmaf chain over hd ascending",
     "for (int c = 0; c < HD; ++c) dot = fmaf(qr[c], kj[c], dot);",
     "d[x][y] = fmaf(qv[x][e], kv[y][e], d[x][y]);"),
    ("the normalizer max(|rowsum|, exp(-m_i))",
     "const float norm = fmaxf(fabsf(rowsum[r]), expf(-Mq[r]));",
     "const float norm = fmaxf(fabsf(Rs[r]), expf(-Mq[r]));"),
    ("the epilogue's clamp at 1e-6", "acc[x] / fmaxf(norm, 1e-6f)",
     "const float den = fmaxf(norm, 1e-6f);"),
]


@pytest.mark.parametrize("what,old,new", KEPT, ids=[k[0] for k in KEPT])
def test_parallel_redesign_keeps_the_first_designs_expressions(what, old,
                                                               new):
    """Each step whose bits the redesign keeps (the stabilizer, scores,
    masking, row sums, S.v, fp32 q.k and the epilogue) is written with the
    first design's expression, operands renamed."""
    assert old in _parallel_section("mlstm_parallel_v1"), what
    assert new in _parallel_section("mlstm"), what


def test_parallel_redesign_sums_from_zero_and_keeps_F_in_the_wrapper():
    """Every chain starts from +0 (the row sums, S.v and fp32 q.k), the
    division is IEEE (no reciprocal), and F = cumsum(fg) stays in the
    wrapper, as in the first design."""
    src = _parallel_section("mlstm")
    assert "float rs = 0.f;" in src
    # the row sums' operand: row tid - RS's score of key jj
    assert "if (sums) rx = Sc[jj * P::LDS + tid - P::RS];" in src
    assert "for (int y = 0; y < P::TC; ++y) acc[x][y] = 0.f;" in src
    assert "for (int y = 0; y < P::QK; ++y) d[x][y] = 0.f;" in src
    assert "acc[x][y] / den" in src
    assert not re.search(r"__frcp|__fdividef|rcp\.approx|__expf", src)
    wrapper = (ROOT / "src" / "repro_torch" / "kernels" / "mlstm.py")
    assert "F = torch.cumsum(fg, 1)" in wrapper.read_text()


def test_parallel_redesign_keeps_fp32_off_the_tensor_cores():
    """The tensor cores' fp32 path is tf32: the fp32 q.k (the QKTile
    specialization for fp32 operands) names no mma or ldmatrix, and the
    bf16 one is the only user of them."""
    src = _parallel_section("mlstm")
    fp32 = src[src.index("struct QKTile<T, HD, false>"):
               src.index("// query tile [i0, i0 + BQ)")]
    bf16 = src[src.index("struct QKTile<T, HD, true>"):
               src.index("struct QKTile<T, HD, false>")]
    assert not re.search(r"mma|ldsm", fp32)
    assert "mma_16816" in bf16 and "ldsm_x4" in bf16
    assert len(re.findall(r"mma_16816\(", src)) == 2


def _constant(name):
    found = re.search(rf"^constexpr int {name} = (\d+);",
                      (CSRC / "mlstm.cu").read_text(), re.MULTILINE)
    return int(found.group(1))


def _pairs(s):
    """A NumPy model of csrc/mlstm.cu's causal pairing for one (b, h): CTA
    p of ceil(n / 2) takes query tiles n - 1 - p, then p unless it is the
    same; each query tile t walks the key tiles j0 < min(S, (t + 1) BQ).
    Returns the tiles of each CTA and the key tiles each walks."""
    bq, bk = _constant("BQ"), _constant("BK")
    n = -(-s // bq)
    ctas = np.arange((n + 1) // 2)
    tiles = [sorted({n - 1 - p, p}, reverse=True) for p in ctas]
    walks = np.array([sum(-(-min(s, (t + 1) * bq) // bk) for t in ts)
                      for ts in tiles])
    return n, tiles, walks


@pytest.mark.parametrize("b,s,h,hd", [(4, 512, 4, 256), (4, 2048, 4, 256),
                                      (2, 300, 4, 256), (2, 77, 4, 32),
                                      (1, 1, 4, 256)])
def test_causal_pairs_cover_each_query_tile_once(b, s, h, hd):
    """Every (b, h, query tile) is taken by exactly one CTA, and no CTA
    walks more than n + 1 key tiles (the pair's n + 1; the middle tile of
    an odd n its (n + 1) / 2); at (4, 512) the grid is one wave of 128
    CTAs on the card's 132 SMs. The model's rules are the source's: its
    launch grid and its pair are checked as text."""
    src = _parallel_section("mlstm")
    launch = (CSRC / "mlstm.cu").read_text()
    assert "const int pairs = ((S + BQ - 1) / BQ + 1) / 2;" in launch
    assert "kernel<<<dim3(pairs, H, B), THREADS, smem, stream>>>" in launch
    assert "last = n - 1 - p;" in src and "if (p != last) {" in src
    n, tiles, walks = _pairs(s)
    grid = [(bb, hh, t) for bb in range(b) for hh in range(h)
            for ts in tiles for t in ts]
    assert sorted(grid) == [(bb, hh, t) for bb in range(b)
                            for hh in range(h) for t in range(n)]
    assert walks.max() <= n + 1
    if n > 1:
        assert walks.min() >= (n + 1) // 2
    if (b, s, h) == (4, 512, 4):
        assert b * h * len(tiles) == 128 and set(walks) == {n + 1}


def test_xlstm_tol_budget_for_the_tensor_cores_q_k():
    """The bf16 q . k on the tensor cores sums each 16-wide k-step, then
    adds the steps in order. Modelled on the CPU, that order moves the
    plain form's output by under a tenth of ``XLSTM_TOL`` (relative to
    max(1, max |out|), as the checks measure) at xLSTM-350M's heads (1,
    512, 4 heads of 256) on bf16 inputs: the tolerance the card's checks
    hold the redesign to leaves room for the mma's own rounding inside a
    step."""
    tol = float(re.search(r"^XLSTM_TOL = (\S+)$",
                          (ROOT / "chip_smoke.py").read_text(),
                          re.MULTILINE).group(1))
    rng = np.random.default_rng(30)
    b, s, h, hd = 1, 512, 4, 256

    def bf16(x):
        return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    q = bf16(rng.standard_normal((b, s, h, hd)))
    k = bf16(rng.standard_normal((b, s, h, hd)) / hd ** 0.5)
    v = bf16(rng.standard_normal((b, s, h, hd)))
    ig = torch.from_numpy(rng.standard_normal((b, s, h)).astype(np.float32))
    fg = torch.nn.functional.logsigmoid(torch.from_numpy(
        rng.standard_normal((b, s, h)).astype(np.float32)) + 1.0)
    with torch.no_grad():
        want = ML.mlstm_parallel_plain(q, k, v, ig, fg)
        qk = torch.zeros((b, s, s, h))
        for c in range(0, hd, 16):
            qk = qk + torch.einsum("bihe,bjhe->bijh",
                                   q[..., c:c + 16].float(),
                                   k[..., c:c + 16].float())
        got = ML.mlstm_parallel_from_qk(qk, v, ig, fg)
    err = float((got - want).abs().max()) / max(1.0, float(want.abs().max()))
    assert 0.0 < err <= tol / 10, err
