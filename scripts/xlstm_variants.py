"""Time variants of the xLSTM kernels (``csrc/mlstm.cu``'s parallel form
and (C, n, m) recurrence, ``csrc/slstm.cu``, the parallel form's backward
``csrc/mlstm_parallel_bwd.cu``) beside their first designs on one card,
to see what sets their speed.

    python3 scripts/xlstm_variants.py [--out FILE] [--only NAME,...]
                                      [--kernels KIND,...]

Each variant is a copy of the kernel's source changed by text substitutions
(the script stops if the source no longer holds the text), built into
``build/xlstm_variants/``:

  mlstm_wr4              4 rows of C a consumer warp (``REC_WROWS``)
                         instead of 2 at S > 8: 8 consumer warps a CTA,
                         not 16, and 8 steps a stage, not 16 (rows x steps
                         = 32 sums a reduce-scatter);
  mlstm_dec4, mlstm_dec2 4 or 2 rows a warp at S <= 8
                         (``REC_WROWS_DECODE``) instead of 8: the decode
                         step's shape;
  mlstm_cta16            16 rows of C a CTA (``REC_CTA_ROWS``) instead of
                         32 at S > 8: two CTAs an SM, each with its own
                         scalar warp;
  mlstm_dcta32           32 rows of C a CTA at S <= 8
                         (``REC_CTA_ROWS_DECODE``) instead of 16;
  mlstm_look1            one stage of copies in flight (``REC_LOOK``)
                         instead of 2;
  mlstm_ns3              a ring of 3 prepared stages (``REC_NS``), not 2;
  slstm_sync             the first design's exchange: h stored into every
                         CTA of the cluster, then one cluster barrier a
                         step, against st.async onto each CTA's mbarrier;
  slstm_push1            each lane pushes its own h into every CTA (8
                         4-byte st.async) instead of two 16-byte pieces
                         into one;
  slstm_spin             the wait for h spins on mbarrier.test_wait
                         instead of try_wait;
  slstm_z2               z prefetched 2 steps ahead (``ZD``), not 8;
  slstm_rows1            1 batch row a cluster (``RB``), not 2: a (b, h) a
                         cluster as in the first design, the half-1 warps
                         handing their sums to the half-0 warps;
  slstm_pd1, slstm_pd8   h loaded 1 or 8 float4s ahead of its multiply-
                         adds (``PD``), not 4;
  par_unpaired           the parallel form without its causal pairs: a
                         CTA a query tile, the longest first (tile n - 1 -
                         blockIdx.x), n CTAs a (b, h) instead of ceil(n / 2);
  par_bq64               64 queries a tile (``BQ``) with 512 threads a CTA
                         (``THREADS``), S.v's micro-tile unchanged;
  par_sv4x8              S.v's micro-tile 4 rows x 8 columns a thread, 4
                         lanes across (``SV_TR``, ``SV_TC``, ``SV_WC``)
                         instead of 8 x 4, 8;
  par_t512               512 threads a CTA with 4 x 4 micro-tiles (four
                         warps a scheduler instead of two);
  bwd_unpaired           the backward's key and query passes without
                         their causal pairs: a CTA a tile, the longest
                         first, n CTAs a (b, h) instead of ceil(n / 2);
  bwd_keys1              the keys pass compiled for one CTA an SM
                         (``__launch_bounds__(THREADS, 1)``: registers
                         unbounded by a second CTA, no spills) instead of
                         two;
  bwd_rows8, bwd_dots8   the keys pass's dv and dk loops (over a tile's
                         queries), or its dnum . v and fp32 q . k loops
                         (over hd), unrolled 8 times instead of 4;

and the kernels built with ``-DDASH_STAMPS`` (``phases``), whose
``clock64()`` stamps give the share of each warp's clocks in each phase
of the recurrence (``mlstm.recurrent_phases``, ``slstm.slstm_phases``);
for the parallel form, a copy with ``clock64()`` stamps added by text
substitution (``PAR_PHASES``: warp 0's and the last warp's clocks a CTA
in each phase, ``PAR_PHASE_NAMES``, at the prefill shape); for the
backward's keys pass likewise (``BWD_PHASES``, ``BWD_PHASE_NAMES``:
warp 0's and the dig warp's, at ``[train-xlstm]``'s shape, B = 4, S =
1024, bf16).

For the kernels, the first designs (``v1``: ``csrc/mlstm_v1.cu``,
``csrc/slstm_v1.cu``, ``csrc/mlstm_parallel_v1.cu``) and every variant it
prints ptxas' registers and spills; checks each recurrence variant's
outputs and states bitwise against the first design at small shapes
(``CHECKS``: hd 256 and 32, bf16 and fp32, S = 1, a carried state and the
model's initial one), and each parallel-form variant against its first
design at ``PAR_CHECKS`` (fp32 bitwise, bf16 within ``XLSTM_TOL``); then
times each at the serve slice's prefill (B = 4, S = 512, 4 heads of 256,
bf16) and the recurrences' decode step (S = 1), the parallel form also at
S = 2048, in turns (kernel, v1, the variants, then the same in reverse)
with the calls queued behind a spin kernel. The backward and its variants
are checked against its first design (``csrc/mlstm_parallel_bwd_v1.cu``)
at ``BWD_CHECKS`` (fp32 bitwise on all five gradients, bf16 within
``XLSTM_TOL``) and timed, wrappers whole, in turns at ``[train-xlstm]``'s
shape. ``--kernels`` picks the kinds run (default all: mlstm, slstm,
mlstm_parallel, mlstm_parallel_bwd). Imports nothing of JAX; needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import mlstm as ML  # noqa: E402
from repro_torch.kernels import slstm as SL  # noqa: E402

OUT_DIR = build.BUILD_DIR.parent / "xlstm_variants"


def _const(name, old, new):
    """One substitution: ``constexpr int name = old;`` becomes ``new``."""
    return (f"constexpr int {name} = {old};", f"constexpr int {name} = {new};",
            1)


def _kind(name):
    """The kernel a variant is of: "mlstm_parallel", "mlstm", "slstm" or
    "mlstm_parallel_bwd"."""
    return "mlstm_parallel" if name in PARALLEL else VARIANTS[name][0]


# csrc/slstm.cu's wait for a step's h and its push of the new h
SLSTM_WAIT = (
    "      mbar_wait(smem_u32(&mb[buf]), ((t - 1) >> 1) & 1);\n"
    "      // re-armed for step t + 2 only after this thread saw step t's h\n"
    "      if (tid == 0) mbar_expect_tx(smem_u32(&mb[buf]), STEP_BYTES);\n")
SLSTM_PUSH = (
    "      const int q = 4 * (lane & 3);\n"
    "      float x0[4], x1[4];\n"
    "#pragma unroll\n"
    "      for (int i = 0; i < 4; ++i) {\n"
    "        x0[i] = __shfl_sync(0xffffffffu, hv, q + i);\n"
    "        x1[i] = __shfl_sync(0xffffffffu, hv, q + 16 + i);\n"
    "      }\n"
    "      if (peer < CL) {\n"
    "        const uint32_t dst = push_dst[nb] + row * 2 * HD * 4;\n"
    "        st_async_v4(dst, x0[0], x0[1], x0[2], x0[3], push_bar[nb]);\n"
    "        st_async_v4(dst + 64, x1[0], x1[1], x1[2], x1[3], "
    "push_bar[nb]);\n"
    "      }\n")
# helpers the exchange variants add before the kernel
SLSTM_HELPERS_AT = ("template <typename T, int HD>\n"
                    "constexpr size_t slstm_smem()")
ST_ASYNC_F32 = (
    "__device__ __forceinline__ void st_async_f32(uint32_t dst, float a,\n"
    "                                             uint32_t bar) {\n"
    "  asm volatile(\n"
    "      \"st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
    "[%0], %1, \"\n"
    "      \"[%2];\\n\" ::\"r\"(dst),\n"
    "      \"r\"(__float_as_uint(a)), \"r\"(bar)\n"
    "      : \"memory\");\n}\n\n")
MBAR_TEST_WAIT = (
    "__device__ __forceinline__ bool mbar_test_wait(uint32_t bar,\n"
    "                                               uint32_t parity) {\n"
    "  uint32_t done;\n"
    "  asm volatile(\n"
    "      \"{\\n.reg .pred p;\\n\"\n"
    "      \"mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\\n\"\n"
    "      \"selp.u32 %0, 1, 0, p;\\n}\\n\"\n"
    "      : \"=r\"(done)\n"
    "      : \"r\"(bar), \"r\"(parity)\n"
    "      : \"memory\");\n"
    "  return done != 0;\n}\n\n")
PUSH_SETUP_AT = ("  // every CTA's barriers exist before any CTA pushes to "
                 "them\n")
PUSH1_SETUP = (
    "  uint32_t one_dst[2][CL], one_bar[2][CL];\n"
    "#pragma unroll\n"
    "  for (int p = 0; p < 2; ++p)\n"
    "#pragma unroll\n"
    "    for (int r = 0; r < CL; ++r) {\n"
    "      one_dst[p][r] = cluster_addr(hbuf + p * HD + v0 + lane, r);\n"
    "      one_bar[p][r] = cluster_addr(&mb[p], r);\n"
    "    }\n")
SLSTM_SWAP = (
    "    part[((1 - half) * GATES + g) * OUTS + lane] =\n"
    "        half == 0 ? acc[1] : acc[0];\n"
    "    named_sync(1 + g, 64);\n"
    "    const float other = part[(half * GATES + g) * OUTS + lane];\n"
    "    const float lo = half == 0 ? acc[0] : other;\n"
    "    const float hi = half == 0 ? other : acc[1];\n")
ROWS1_SWAP = (
    "    if (half == 1) {\n"
    "      part[g * OUTS + lane] = acc[0];\n"
    "      named_arrive(1 + g, 64);\n"
    "      STAMP(2)\n"
    "      continue;\n"
    "    }\n"
    "    named_sync(1 + g, 64);\n"
    "    const float lo = acc[0];\n"
    "    const float hi = part[g * OUTS + lane];\n")
Z_FILL = "  for (int t = 0; t < ZD - 1; ++t) z_issue(t);\n"
Z_NEXT = "    z_issue(t + ZD - 1);\n"
ROLES = "  const int row = half;\n  const bool updater = g == 0;\n"

# name: (source, [(old text, new text, times the source holds it)])
VARIANTS = {
    "mlstm_wr4": ("mlstm", [_const("REC_WROWS", 2, 4)]),
    "mlstm_dec4": ("mlstm", [_const("REC_WROWS_DECODE", 8, 4)]),
    "mlstm_dec2": ("mlstm", [_const("REC_WROWS_DECODE", 8, 2)]),
    "mlstm_cta16": ("mlstm", [_const("REC_CTA_ROWS", 32, 16)]),
    "mlstm_dcta32": ("mlstm", [_const("REC_CTA_ROWS_DECODE", 16, 32)]),
    "mlstm_look1": ("mlstm", [_const("REC_LOOK", 2, 1)]),
    "mlstm_ns3": ("mlstm", [_const("REC_NS", 2, 3)]),
    "slstm_sync": ("slstm", [
        (SLSTM_WAIT, "      cg::this_cluster().sync();\n", 1),
        (SLSTM_PUSH,
         "      float* next = hbuf + (row * 2 + nb) * HD + v0 + lane;\n"
         "#pragma unroll\n"
         "      for (int p = 0; p < CL; ++p)\n"
         "        *cg::this_cluster().map_shared_rank(next, p) = hv;\n", 1)]),
    "slstm_push1": ("slstm", [
        (SLSTM_HELPERS_AT, ST_ASYNC_F32 + SLSTM_HELPERS_AT, 1),
        (PUSH_SETUP_AT, PUSH1_SETUP + PUSH_SETUP_AT, 1),
        (SLSTM_PUSH,
         "#pragma unroll\n"
         "      for (int p = 0; p < CL; ++p)\n"
         "        st_async_f32(one_dst[nb][p] + row * 2 * HD * 4, hv, "
         "one_bar[nb][p]);\n", 1)]),
    "slstm_spin": ("slstm", [
        (SLSTM_HELPERS_AT, MBAR_TEST_WAIT + SLSTM_HELPERS_AT, 1),
        ("      mbar_wait(smem_u32(&mb[buf]), ((t - 1) >> 1) & 1);\n",
         "      while (!mbar_test_wait(smem_u32(&mb[buf]), "
         "((t - 1) >> 1) & 1)) {\n      }\n", 1)]),
    "slstm_z2": ("slstm", [_const("ZD", 8, 2)]),
    "slstm_rows1": ("slstm", [
        _const("RB", 2, 1),
        (ROLES, "  const int row = 0;\n  const bool active = half == 0;\n"
                "  const bool updater = active && g == 0;\n", 1),
        (Z_FILL, "  if (active)\n  " + Z_FILL, 1),
        (Z_NEXT, "    if (active) z_issue(t + ZD - 1);\n", 1),
        (SLSTM_SWAP, ROWS1_SWAP, 1)]),
    "slstm_pd1": ("slstm", [_const("PD", 4, 1)]),
    "slstm_pd8": ("slstm", [_const("PD", 4, 8)]),
    "par_unpaired": ("mlstm", [
        ("  if (p != last) {  // the pair's short tile",
         "  if (false) {  // the pair's short tile", 1),
        ("  const int pairs = ((S + BQ - 1) / BQ + 1) / 2;  // CTAs a (b, h)",
         "  const int pairs = (S + BQ - 1) / BQ;  // CTAs a (b, h)", 1)]),
    "par_bq64": ("mlstm", [_const("BQ", 32, 64), _const("THREADS", 256, 512)]),
    "par_sv4x8": ("mlstm", [_const("SV_TR", 8, 4), _const("SV_TC", 4, 8),
                            _const("SV_WC", 8, 4)]),
    "par_t512": ("mlstm", [_const("THREADS", 256, 512),
                           _const("SV_TR", 8, 4)]),
}
# the variants of the parallel form (the others are recurrences')
PARALLEL = {"par_unpaired", "par_bq64", "par_sv4x8", "par_t512"}


def _stamp(i):
    """Add the clocks since the last stamp to phase i."""
    return (f"    {{ const long long u_ = clock64(); ck[{i}] += u_ - tt; "
            f"tt = u_; }}\n")


# the parallel form's phases, in the order of PAR_PHASES' stamps
PAR_PHASE_NAMES = ("stabilizer", "first_wait", "first_qk", "barrier",
                   "issue", "s_v_loop", "v_wait", "epilogue")
_NP = len(PAR_PHASE_NAMES)
_LOOP_TOP = ("                      // tile kt - 1's reads are done\n"
             "    const int g = g0 + kt;\n")
# csrc/mlstm.cu with clock64() stamps in the parallel form: per CTA, the
# clocks of warp 0 (thread 0) and of the last warp in each phase, summed
# over the CTA's query tiles (one writer a slot: no atomics)
PAR_PHASES = [
    ("// query tile [i0, i0 + BQ) of (b, h)",
     f"__device__ long long g_par[8192 * 2 * {_NP}];\n"
     "// query tile [i0, i0 + BQ) of (b, h)", 1),
    ("  float* Rs = Mq + BQ;\n  const uint32_t qbar",
     f"  float* Rs = Mq + BQ;\n  long long ck[{_NP}] = {{0}};\n"
     "  long long tt = clock64();\n  const uint32_t qbar", 1),
    ("  // key tile 0's scores\n  cp_async_wait<1>();\n",
     "  // key tile 0's scores\n" + _stamp(0) + "  cp_async_wait<1>();\n",
     1),
    ("  mbar_wait(kbar(g0), (g0 / 2) & 1);\n",
     "  mbar_wait(kbar(g0), (g0 / 2) & 1);\n" + _stamp(1), 1),
    ("  // S.v: this thread's rows row0 + x",
     "  __syncwarp();\n" + _stamp(2) + "  // S.v: this thread's rows row0 + x",
     1),
    ("    cp_async_wait<0>();\n",
     "    tt = clock64();\n    cp_async_wait<0>();\n", 1),
    (_LOOP_TOP, _LOOP_TOP + _stamp(3), 1),
    ("    const bool next = kt + 1 < tiles, qk_next = next && mma_warp;\n",
     _stamp(4) +
     "    const bool next = kt + 1 < tiles, qk_next = next && mma_warp;\n",
     1),
    ("    const float* Sc = St + (g % 2) * BK * P::LDS;\n",
     _stamp(6) + "    const float* Sc = St + (g % 2) * BK * P::LDS;\n", 1),
    ("    if (qk_next && P::STEPS == BK * P::SPK) qk.mul(P::STEPS - 1);\n",
     _stamp(5) +
     "    if (qk_next && P::STEPS == BK * P::SPK) qk.mul(P::STEPS - 1);\n",
     1),
    ("  if (sums) Rs[tid - P::RS] = rs;\n",
     "  tt = clock64();\n  if (sums) Rs[tid - P::RS] = rs;\n", 1),
    ("              make_float2(acc[x][y] / den, acc[x][y + 1] / den);\n"
     "      }\n    }\n  }\n}\n",
     "              make_float2(acc[x][y] / den, acc[x][y + 1] / den);\n"
     "      }\n    }\n  }\n" + _stamp(7) +
     "  const int cta = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +\n"
     "                  blockIdx.x;\n"
     "  if (cta < 8192 && (tid == 0 || tid == THREADS - 32))\n"
     f"    for (int i = 0; i < {_NP}; ++i)\n"
     f"      g_par[(2 * cta + (tid != 0)) * {_NP} + i] += ck[i];\n}}\n", 1),
    ('extern "C" int dash_mlstm_parallel(',
     'extern "C" int dash_par_phases(void* out, int n) {\n'
     "  return static_cast<int>(\n"
     "      cudaMemcpyFromSymbol(out, g_par, n * sizeof(long long)));\n}\n"
     'extern "C" int dash_mlstm_parallel(', 1),
]
VARIANTS["par_phases"] = ("mlstm", PAR_PHASES)

# the backward's keys pass, in the order of BWD_PHASES' stamps: the setup
# of a key tile (copies issued, gates staged; the writes at its end), then per
# query tile the wait for dnum, dnum . v, the wait for q, q . k with the
# pair terms, the dv loop, the dk loop with dig
BWD_PHASE_NAMES = ("setup", "wait_dnum", "dnum_v", "wait_q", "pair_terms",
                   "dv", "dk_dig")
_NB = len(BWD_PHASE_NAMES)


def _bwd_stamp(i):
    return (f"    {{ const long long u_ = clock64(); ck[{i}] += u_ - tt; "
            f"tt = u_; }}\n")


_BWD_LOOP_END = ("    __syncthreads();                   // q and the pair "
                 "terms are read\n    if (qt + 1 < n) {\n      "
                 "issue_q(qt + 1);\n    } else {\n      "
                 "dash_mma::cp_async_commit();\n    }\n")
_BWD_TILE_END = ("  if (dig_warp && j0 + lane < S) dig[at.gate(j0 + lane)] = "
                 "acc_dig;\n")
# csrc/mlstm_parallel_bwd.cu with clock64() stamps in the keys pass: per
# CTA, the clocks of warp 0 (thread 0) and of the dig warp in each phase,
# summed over the CTA's key tiles (one writer a slot: no atomics)
BWD_PHASES = [
    ("// key tile [j0, j0 + BT) of (b, h)",
     f"__device__ long long g_bwd[8192 * 2 * {_NB}];\n"
     "// key tile [j0, j0 + BT) of (b, h)", 1),
    ("  const int j0 = kt * BT, S = at.S;\n",
     "  const int j0 = kt * BT, S = at.S;\n"
     f"  long long ck[{_NB}] = {{0}};\n  long long tt = clock64();\n", 1),
    ("  const bool dig_warp = warp == WARPS - 1;\n",
     "  const bool dig_warp = warp == WARPS - 1;\n" + _bwd_stamp(0), 1),
    ("    __syncthreads();                   // dnum and the row terms are "
     "in\n",
     "    __syncthreads();                   // dnum and the row terms are "
     "in\n" + _bwd_stamp(1), 1),
    ("    dots<HD, T>(Ns, Vs, rb + g, kb + 2 * t, nv);\n",
     "    dots<HD, T>(Ns, Vs, rb + g, kb + 2 * t, nv);\n" + _bwd_stamp(2), 1),
    ("    __syncthreads();                   // q is in\n",
     "    __syncthreads();                   // q is in\n" + _bwd_stamp(3), 1),
    ("    __syncthreads();                   // the pair terms are in\n",
     "    __syncthreads();                   // the pair terms are in\n"
     + _bwd_stamp(4), 1),
    ("    __syncthreads();                   // dnum and the row terms are "
     "read\n",
     "    __syncthreads();                   // dnum and the row terms are "
     "read\n" + _bwd_stamp(5), 1),
    (_BWD_LOOP_END, _BWD_LOOP_END + _bwd_stamp(6), 1),
    (_BWD_TILE_END, _BWD_TILE_END + _bwd_stamp(0) +
     "  const int cta = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +\n"
     "                  blockIdx.x;\n"
     "  if (cta < 8192 && (tid == 0 || dig_warp && lane == 0))\n"
     f"    for (int i = 0; i < {_NB}; ++i)\n"
     f"      g_bwd[(2 * cta + (tid != 0)) * {_NB} + i] += ck[i];\n", 1),
    ('extern "C" int dash_mlstm_bwd_rows(',
     'extern "C" int dash_bwd_phases(void* out, int n) {\n'
     "  return static_cast<int>(\n"
     "      cudaMemcpyFromSymbol(out, g_bwd, n * sizeof(long long)));\n}\n"
     'extern "C" int dash_mlstm_bwd_rows(', 1),
]
VARIANTS.update({
    "bwd_phases": ("mlstm_parallel_bwd", BWD_PHASES),
    "bwd_unpaired": ("mlstm_parallel_bwd", [
        ("  if (p != last) {\n", "  if (false) {\n", 2),
        ("dim3 pair_grid(int B, int S, int H) {\n"
         "  return dim3(((S + BT - 1) / BT + 1) / 2, H, B);",
         "dim3 pair_grid(int B, int S, int H) {\n"
         "  return dim3((S + BT - 1) / BT, H, B);", 1)]),
    "bwd_keys1": ("mlstm_parallel_bwd", [
        ("__global__ void __launch_bounds__(THREADS, 2)",
         "__global__ void __launch_bounds__(THREADS, 1)", 1)]),
    "bwd_rows8": ("mlstm_parallel_bwd", [
        ("#pragma unroll 4\n    for (int r = 0; r < BT; ++r) {",
         "#pragma unroll 8\n    for (int r = 0; r < BT; ++r) {", 2)]),
    "bwd_dots8": ("mlstm_parallel_bwd", [
        ("#pragma unroll 4\n  for (int c = 0; c < HD; c += 4) {",
         "#pragma unroll 8\n  for (int c = 0; c < HD; c += 4) {", 1)]),
})
# the backward's checks against its first design (case, B, S, H, hd,
# dtype) and its timed shape, [train-xlstm]'s
BWD_CHECKS = [("hd256_bf16", 2, 77, 4, 256, torch.bfloat16),
              ("hd256_fp32", 1, 130, 4, 256, torch.float32),
              ("hd32_bf16", 3, 45, 4, 32, torch.bfloat16),
              ("hd32_fp32", 2, 64, 2, 32, torch.float32),
              ("s1", 1, 1, 4, 256, torch.float32)]
TRAIN = (4, 1024)
# (case, B, S, hd, dtype, carried)
CHECKS = [("hd256_bf16", 2, 77, 256, torch.bfloat16, True),
          ("hd256_fp32_init", 3, 40, 256, torch.float32, False),
          ("hd32_fp32", 2, 100, 32, torch.float32, True),
          ("hd32_bf16", 2, 33, 32, torch.bfloat16, True),
          ("decode", 1, 1, 256, torch.bfloat16, True)]
PREFILL = (4, 512)
DECODE = (4, 1)
# the parallel form's checks (case, B, S, hd, dtype) and its long shape
PAR_CHECKS = [("hd256_bf16", 2, 300, 256, torch.bfloat16),
              ("hd256_fp32", 1, 200, 256, torch.float32),
              ("hd32_bf16", 2, 77, 32, torch.bfloat16),
              ("hd32_fp32", 2, 100, 32, torch.float32),
              ("s1", 1, 1, 256, torch.bfloat16)]
LONG = (4, 2048)


def build_variants(names):
    """Start nvcc for each named variant, all at once; returns
    ``{name: (library path, process)}``."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        source, edits = VARIANTS[name]
        text = (build.CSRC / f"{source}.cu").read_text()
        for old, new, count in edits:
            if text.count(old) != count:
                raise SystemExit(f"{name}: {source}.cu no longer holds "
                                 f"{old[:60]!r} {count} times")
            text = text.replace(old, new)
        text = text.replace('#include "', f'#include "{build.CSRC}/')
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        out = OUT_DIR / f"lib{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(cu)]
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def _bind(kernel, lib):
    if kernel == "mlstm_parallel_bwd":
        bound = ML._bind_passes(lib, "", (6, 11, 5))
        return lambda a: ML._backward(lambda: bound, False, *a)
    if kernel == "mlstm_parallel":
        fn = ML._bind_parallel(lib.dash_mlstm_parallel)
        return lambda a: ML._parallel(lambda: fn, *a)
    if kernel == "mlstm":
        fn = ML._bind_recurrent(lib.dash_mlstm_recurrent)
        return lambda a, st: ML._recurrent(lambda: fn, *a, *st)
    fn = SL._bind(lib.dash_slstm, kept=True)
    return lambda a, st, rr: SL._launch(lambda: fn, a, rr, st, None)


def _inputs(kernel, b, s, hd, dtype, seed, carried=True):
    if kernel == "mlstm":
        args, state = CS._mlstm_inputs(b, s, hd, dtype, seed, carried)
        return args, state, None
    z, rr, state = CS._slstm_inputs(b, s, hd, dtype, seed, carried)
    return z, state, rr


def _call(kernel, fn, args, state, rr):
    return fn(args, state) if kernel == "mlstm" else fn(args, state, rr)


def parallel_phases(lib, b, s):
    """One launch of the stamped parallel form (``par_phases``) at (b, s,
    4 heads of 256, bf16): the median share of each phase
    (``PAR_PHASE_NAMES``) in warp 0's and the last warp's clocks over the
    CTAs, and their median clocks a CTA."""
    fn = ML._bind_parallel(lib.dash_mlstm_parallel)
    args, _ = CS._mlstm_inputs(b, s, 256, torch.bfloat16, seed=31)
    ctas = b * CS.XLSTM_HEADS * ((-(-s // 32) + 1) // 2)
    n = ctas * 2 * _NP
    before = (ctypes.c_longlong * n)()
    lib.dash_par_phases(before, n)
    ML._parallel(lambda: fn, *args)
    torch.cuda.synchronize()
    after = (ctypes.c_longlong * n)()
    lib.dash_par_phases(after, n)
    clocks = [[after[(2 * c + w) * _NP + i] - before[(2 * c + w) * _NP + i]
               for i in range(_NP)] for c in range(ctas) for w in (0, 1)]
    out = {}
    for w, name in ((0, "warp0"), (1, "last_warp")):
        rows = clocks[w::2]
        out[name] = {p: statistics.median(r[i] / sum(r) for r in rows)
                     for i, p in enumerate(PAR_PHASE_NAMES)}
        out[name]["clocks"] = statistics.median(sum(r) for r in rows)
    return out


def _bwd_inputs(b, s, h, hd, dtype, seed):
    """The backward's operands: (new, v1) argument tuples on the same
    inputs, the forward's ``out`` and row statistics from the kernel."""
    args, _ = CS._mlstm_inputs(b, s, hd, dtype, seed=seed, h=h)
    with torch.no_grad():
        out, F, stats = ML.mlstm_parallel_stats_cuda(*args)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dout = torch.randn(out.shape, generator=gen, device="cuda")
    return (*args[:4], F, out, dout, stats), (*args, out, dout)


def check_backward(fn):
    """``fn``'s five gradients against the first design's at BWD_CHECKS:
    fp32 bitwise, bf16 within ``XLSTM_TOL``."""
    out = {}
    for case, b, s, h, hd, dtype in BWD_CHECKS:
        new, old = _bwd_inputs(b, s, h, hd, dtype, seed=s + hd)
        got, want = fn(new), ML.mlstm_parallel_backward_v1_cuda(*old)
        if dtype == torch.float32:
            out[case] = all(torch.equal(g, w) for g, w in zip(got, want))
        else:
            out[case] = all(CS._scan_err(g, w) <= CS.XLSTM_TOL
                            for g, w in zip(got, want))
    return out


def backward_phases(lib, b, s):
    """One backward through the stamped keys pass (``bwd_phases``) at (b,
    s, 4 heads of 256, bf16): the median share of each phase
    (``BWD_PHASE_NAMES``) in warp 0's and the dig warp's clocks over the
    CTAs, and their median clocks a CTA."""
    fn = _bind("mlstm_parallel_bwd", lib)
    new, _ = _bwd_inputs(b, s, CS.XLSTM_HEADS, 256, torch.bfloat16, seed=41)
    ctas = b * CS.XLSTM_HEADS * ((-(-s // 32) + 1) // 2)
    n = ctas * 2 * _NB
    before = (ctypes.c_longlong * n)()
    lib.dash_bwd_phases(before, n)
    fn(new)
    torch.cuda.synchronize()
    after = (ctypes.c_longlong * n)()
    lib.dash_bwd_phases(after, n)
    clocks = [[after[(2 * c + w) * _NB + i] - before[(2 * c + w) * _NB + i]
               for i in range(_NB)] for c in range(ctas) for w in (0, 1)]
    out = {}
    for w, name in ((0, "warp0"), (1, "dig_warp")):
        rows = clocks[w::2]
        out[name] = {p: statistics.median(r[i] / sum(r) for r in rows)
                     for i, p in enumerate(BWD_PHASE_NAMES)}
        out[name]["clocks"] = statistics.median(sum(r) for r in rows)
    return out


def check_parallel(fn):
    """``fn``'s output against the first design's at PAR_CHECKS: fp32
    bitwise, bf16 within ``XLSTM_TOL`` (relative to max(1, max |v1|))."""
    out = {}
    for case, b, s, hd, dtype in PAR_CHECKS:
        args, _ = CS._mlstm_inputs(b, s, hd, dtype, seed=s + hd)
        got, want = fn(args), ML.mlstm_parallel_v1_cuda(*args)
        if dtype == torch.float32:
            out[case] = bool(torch.equal(got, want))
        else:
            out[case] = CS._scan_err(got, want) <= CS.XLSTM_TOL
    return out


def check(kernel, fn, ref):
    """``fn``'s outputs and states against the first design's at CHECKS,
    each bitwise."""
    out = {}
    for case, b, s, hd, dtype, carried in CHECKS:
        args, state, rr = _inputs(kernel, b, s, hd, dtype, seed=s + hd,
                                  carried=carried)
        got = _call(kernel, fn, args, state, rr)
        want = _call(kernel, ref, args, state, rr)
        out[case] = CS._same(got, want)
    return out


def in_turns(calls, reps):
    """``_queued_ms`` of each call in turns (forward, then reversed): the
    mean of each call's two readings."""
    times = {c: [] for c in calls}
    order = list(calls)
    for name in order + order[::-1]:
        times[name].append(CS._queued_ms(calls[name], reps=reps, rounds=3))
    return {c: statistics.mean(t) for c, t in times.items()}


def phase_shares(kernel, args, state, rr):
    """The median share of each phase in a warp's clocks, per group of
    warps, at these inputs (``chip_smoke._xlstm_phase_shares``)."""
    if kernel == "mlstm":
        return CS._xlstm_phase_shares(ML.recurrent_phases(*args, *state),
                                      CS.XLSTM_MLSTM_PHASES)
    return CS._xlstm_phase_shares(SL.slstm_phases(args, rr, state),
                                  CS.XLSTM_SLSTM_PHASES)


KINDS = ("mlstm", "slstm", "mlstm_parallel", "mlstm_parallel_bwd")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the results as JSON")
    ap.add_argument("--only", default=",".join(VARIANTS),
                    help="comma-separated variants to build (default all)")
    ap.add_argument("--kernels", default=",".join(KINDS),
                    help="comma-separated kinds to check and time (default "
                         "all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("xlstm_variants: no CUDA device", file=sys.stderr)
        return 2
    card = CS.phase_device()
    kinds = [k for k in args.kernels.split(",") if k]
    names = [n for n in args.only.split(",")
             if n and ("mlstm_parallel" if n == "par_phases" else _kind(n))
             in kinds]
    procs = build_variants(names)
    built = build.build_variants(
        [("mlstm", ()), ("mlstm_v1", ()), ("slstm", ()), ("slstm_v1", ()),
         ("mlstm_parallel_v1", ()), ("mlstm", ("DASH_STAMPS",)),
         ("slstm", ("DASH_STAMPS",)), ("mlstm_parallel_bwd", ()),
         ("mlstm_parallel_bwd_v1", ())])
    variant_libs, stamped, bwd_stamped = {}, None, None
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        if name == "par_phases":
            stamped = ctypes.CDLL(str(out))
            continue
        if name == "bwd_phases":
            bwd_stamped = ctypes.CDLL(str(out))
            continue
        variant_libs[name] = (ctypes.CDLL(str(out)), log)
    result = dict(card=card, variants={}, layout=ML.recurrent_layout())
    calls = {}
    for kernel in kinds:
        if kernel == "mlstm":
            ref = (lambda a, st: ML.mlstm_recurrent_v1_cuda(*a, *st))
        elif kernel == "slstm":
            ref = (lambda a, st, rr: SL.slstm_v1_cuda(a, rr, st))
        elif kernel == "mlstm_parallel":
            ref = (lambda a: ML.mlstm_parallel_v1_cuda(*a))
        else:
            ref = None                 # the backward's v1 takes other args
        source = {"mlstm_parallel": "mlstm"}.get(kernel, kernel)
        members = {"kernel": (_bind(kernel, build.load(source)),
                              built[(source, ())]["ptxas"]),
                   "v1": (ref, built[(f"{kernel}_v1", ())]["ptxas"])}
        members.update({n: (_bind(kernel, lib), log)
                        for n, (lib, log) in variant_libs.items()
                        if _kind(n) == kernel})
        calls[kernel] = {}
        for name, (fn, ptxas) in members.items():
            calls[kernel][name] = fn
            row = dict(ptxas=[r for r in CS.xlstm_resources(ptxas)
                              if (r["kernel"] == "mlstm_parallel")
                              == (kernel == "mlstm_parallel")])
            if name != "v1" and kernel == "mlstm_parallel_bwd":
                row["matches_v1"] = check_backward(fn)
            elif name != "v1" and kernel == "mlstm_parallel":
                row["matches_v1"] = check_parallel(fn)
            elif name != "v1":
                row["bitwise_v1"] = check(kernel, fn, ref)
            result["variants"][f"{kernel}/{name}"] = row
            print(f"[variant] {kernel}/{name} " + json.dumps(row),
                  flush=True)
    torch.cuda.synchronize()
    hd = 256
    with torch.no_grad():
        backward = calls.pop("mlstm_parallel_bwd", None)
        if backward is not None:
            new, old = _bwd_inputs(*TRAIN, CS.XLSTM_HEADS, hd, torch.bfloat16,
                                   seed=41)
            timed = {n: (lambda fn=fn: fn(new)) for n, fn in backward.items()
                     if n != "v1"}
            timed["v1"] = lambda: ML.mlstm_parallel_backward_v1_cuda(*old)
            result["mlstm_parallel_bwd_train_ms"] = in_turns(timed, reps=5)
            print("[timing] mlstm_parallel_bwd_train_ms " + json.dumps(
                result["mlstm_parallel_bwd_train_ms"]), flush=True)
            del new, old
            if bwd_stamped is not None:
                result["mlstm_parallel_bwd_phases"] = backward_phases(
                    bwd_stamped, *TRAIN)
                print("[phases] mlstm_parallel_bwd keys pass " + json.dumps(
                    result["mlstm_parallel_bwd_phases"]), flush=True)
        parallel = calls.pop("mlstm_parallel", None)
        for label, (b, s), reps in (("prefill", PREFILL, 20),
                                    ("long", LONG, 5)):
            if parallel is None:
                break
            a, _ = CS._mlstm_inputs(b, s, hd, torch.bfloat16, seed=31)
            key = f"mlstm_parallel_{label}_ms"
            result[key] = in_turns(
                {n: (lambda fn=fn: fn(a)) for n, fn in parallel.items()},
                reps=reps)
            print(f"[timing] {key} " + json.dumps(result[key]), flush=True)
        if stamped is not None:
            result["mlstm_parallel_phases"] = parallel_phases(stamped,
                                                              *PREFILL)
            print("[phases] mlstm_parallel " + json.dumps(
                result["mlstm_parallel_phases"]), flush=True)
        for kernel, fns in calls.items():
            for label, (b, s), reps in (("prefill", PREFILL, 10),
                                        ("decode", DECODE, 50)):
                a, st, rr = _inputs(kernel, b, s, hd, torch.bfloat16,
                                    seed=31, carried=s == 1)
                timed = {n: (lambda fn=fn: _call(kernel, fn, a, st, rr))
                         for n, fn in fns.items()}
                key = f"{kernel}_{label}_ms"
                result[key] = in_turns(timed, reps=reps)
                print(f"[timing] {key} " + json.dumps(result[key]),
                      flush=True)
            a, st, rr = _inputs(kernel, *PREFILL, hd, torch.bfloat16,
                                seed=31, carried=False)
            result[f"{kernel}_phases"] = phase_shares(kernel, a, st, rr)
            print(f"[phases] {kernel} " + json.dumps(
                result[f"{kernel}_phases"]), flush=True)
    result["sm_clock_after"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0 if all(all(v.get("bitwise_v1", {}).values())
                    and all(v.get("matches_v1", {}).values())
                    for v in result["variants"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
