"""Time variants of the port's serve kernels (the M-invariant GEMM and the
paged attention) side by side on one card, to see what holds them back.

    python3 scripts/serve_variants.py [--out chiprun_out/serve_variants.json]

Each variant is ``src/repro_torch/kernels/csrc/gemm.cu`` or
``paged_attn.cu`` changed by a text substitution (the script stops if the
source no longer holds the text):

  gemm_copy_only     no products: the weight and x copies alone;
  gemm_compute_only  no weight copies (the products run on stale tiles):
                     the ring's barriers and the products alone;
  gemm_bk192         the BN = 32 tile with 192-deep stages instead of 256,
                     a ring that fits twice on an SM at M = 32;
  gemm_phases        the kernel with clock64() stamps, per CTA: clocks to
                     the first stage's arrival, waiting on later stages, in
                     the products;
  paged_phases       the paged attention with clock64() stamps around each
                     phase of a chunk (wait, scores, running max, p, p·v and
                     sum p, carry), per CTA.

The copy-only and compute-only variants compute wrong outputs; only their
times mean something. ``gemm_bk192`` must give the kernel's bits (checked).
Each is built with the port's nvcc flags into ``build/serve_variants/``
and timed against the kernel in turns (kernel, variants, variants in
reverse, kernel) with the calls queued behind a spin kernel, at the serve
path's shapes (StableLM-1.6B, bf16): the GEMM at M = 4 for q/k/v (2048 x
2048), the up projection (2048 x 5632) and canonical w_down (5632 x 2048,
shard 176), and at M = 32 for the up projection; the paged attention at
decode (4 rows) and a (1, 32) prefill chunk at positions 480-511. Imports
nothing of JAX; needs a card.
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
from repro_torch.kernels import decode as DEC  # noqa: E402
from repro_torch.kernels import gemm as GEMM  # noqa: E402

OUT_DIR = build.BUILD_DIR.parent / "serve_variants"

# clock64() stamps: per CTA, written by its thread 0 into a device array
GEMM_STAMPS = [
    ("  const bool wlive = col0 < N;\n",
     "  const bool wlive = col0 < N;\n"
     "  long long t0_ = clock64(), wait_ = 0, comp_ = 0, first_ = 0;\n"),
    ("    cp_async_wait<STAGES - 2>();\n    __syncthreads();\n    const int next",
     "    long long a_ = clock64();\n    cp_async_wait<STAGES - 2>();\n"
     "    __syncthreads();\n    if (kt == 0) first_ = clock64() - t0_;\n"
     "    else wait_ += clock64() - a_;\n    const int next"),
    ("    if (mb == 1)\n      stage_steps(Int<1>(), st, n16);\n    else\n"
     "      stage_steps(Int<2>(), st, n16);\n  }\n",
     "    long long b_ = clock64();\n    if (mb == 1)\n"
     "      stage_steps(Int<1>(), st, n16);\n    else\n"
     "      stage_steps(Int<2>(), st, n16);\n"
     "    comp_ += clock64() - b_;\n  }\n"
     "  if (tid == 0) {\n    long long* o = g_stamps + 4 * (blockIdx.y * "
     "gridDim.x + blockIdx.x);\n    o[0] = clock64() - t0_; o[1] = first_;"
     " o[2] = wait_; o[3] = comp_;\n  }\n"),
]
PAGED_STAMPS = [
    ("  for (int k = 0; k < C::ACC; ++k) acc[k] = lsum[k] = 0.f;\n",
     "  for (int k = 0; k < C::ACC; ++k) acc[k] = lsum[k] = 0.f;\n"
     "  long long t0_ = clock64(), ph_[6] = {0, 0, 0, 0, 0, 0}, tq_ = 0;\n"),
    ("    cp_async_wait<C::NST - 2>();\n    __syncthreads();",
     "    tq_ = clock64();\n    cp_async_wait<C::NST - 2>();\n"
     "    __syncthreads();\n    ph_[0] += clock64() - tq_; tq_ = clock64();"),
    ("    // (c) one warp a row",
     "    ph_[1] += clock64() - tq_; tq_ = clock64();\n"
     "    // (c) one warp a row"),
    ("    // (d) p for live lanes",
     "    ph_[2] += clock64() - tq_; tq_ = clock64();\n"
     "    // (d) p for live lanes"),
    ("    __syncthreads();\n    // each page's p.v",
     "    __syncthreads();\n    ph_[3] += clock64() - tq_; tq_ = clock64();"
     "\n    // each page's p.v"),
    ("    __syncthreads();\n\n    // (e) the carry",
     "    __syncthreads();\n    ph_[4] += clock64() - tq_; tq_ = clock64();"
     "\n    // (e) the carry"),
    ("  }\n  cp_async_wait<0>();\n",
     "    ph_[5] += clock64() - tq_;\n  }\n  cp_async_wait<0>();\n"
     "  if (tid == 0) {\n    long long* o = g_stamps + 8 * (blockIdx.x + "
     "gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z));\n"
     "    o[0] = clock64() - t0_;\n"
     "    for (int i = 0; i < 6; ++i) o[1 + i] = ph_[i];\n"
     "    o[7] = n_chunks;\n  }\n"),
]
STAMP_BUFFER = ("__device__ long long g_stamps[8 * 16384];\n"
                "extern \"C\" int dash_stamps(void* out, int n) {\n"
                "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
                "      out, g_stamps, n * sizeof(long long)));\n}\n")
VARIANTS = {
    "gemm_copy_only": ("gemm.cu", [("    if (!wlive) continue;\n",
                                    "    continue;\n")]),
    "gemm_compute_only": ("gemm.cu", [
        ("    if (n0 + (tid % CPR) * 8 < N) {", "    if (false) {")]),
    "gemm_bk192": ("gemm.cu", [
        ("  tl.bk = STAGE_W_BYTES / (2 * tl.bn);",
         "  tl.bk = tl.bn == 32 ? 192 : STAGE_W_BYTES / (2 * tl.bn);")]),
    "gemm_phases": ("gemm.cu", GEMM_STAMPS),
    "paged_phases": ("paged_attn.cu", PAGED_STAMPS),
}
GEMM_SHAPES = (("qkv", 4, 2048, 2048, 0), ("up", 4, 2048, 5632, 0),
               ("w_down_canonical", 4, 5632, 2048, 176),
               ("up_m32", 32, 2048, 5632, 0))


def build_all():
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (source, edits) in VARIANTS.items():
        text = (build.CSRC / source).read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {source} no longer holds "
                                 f"{old[:60]!r} once")
            text = text.replace(old, new)
        text = text.replace('#include "', f'#include "{build.CSRC}/')
        text = text.replace("namespace {\n", STAMP_BUFFER + "namespace {\n",
                            1)
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o",
               str(OUT_DIR / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(OUT_DIR / f"lib{name}.so"))
    return libs


def stamps(lib, n):
    buf = (ctypes.c_longlong * n)()
    lib.dash_stamps(buf, n)
    return list(buf)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the results as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("serve_variants: no CUDA device", file=sys.stderr)
        return 2
    card = CS.phase_device()
    build.build(["gemm", "paged_attn"])
    libs = build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    dt = torch.bfloat16
    result = dict(card=card, gemm={}, paged={})
    gemm_names = [n for n in VARIANTS if n.startswith("gemm")]
    for label, m, k, n, width in GEMM_SHAPES:
        x = CS._rand((m, k), gen, dt)
        w = CS._rand((k, n), gen, dt, 0.02)
        out = torch.empty((m, n), device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        calls = {"kernel": lambda: GEMM.matmul_cuda(x, w, shard_width=width)}
        for name in gemm_names:
            fn = GEMM._bind(libs[name].dash_gemm)
            calls[name] = (lambda fn=fn: fn(x.data_ptr(), w.data_ptr(),
                                            out.data_ptr(), m, n, k, width,
                                            1, 0, stream))
        times = {c: [] for c in calls}
        order = list(calls)
        for name in order + order[::-1]:
            times[name].append(CS._queued_ms(calls[name]))
        row = {c: statistics.mean(t) for c, t in times.items()}
        ref = GEMM.matmul_cuda(x, w, shard_width=width)
        calls["gemm_bk192"]()
        torch.cuda.synchronize()
        row["gemm_bk192_bitwise"] = torch.equal(out, ref)
        calls["gemm_phases"]()
        torch.cuda.synchronize()
        bn, _ = GEMM.tile(k, n)
        ctas = -(-m // 32) * -(-n // bn)
        per = stamps(libs["gemm_phases"], 4 * ctas)
        row["phases_median_clocks"] = {
            key: statistics.median(per[4 * i + j] for i in range(ctas))
            for j, key in enumerate(("total", "first_stage", "waiting",
                                     "products"))}
        row["tile_bn_bk"] = GEMM.tile(k, n)
        result["gemm"][label] = row
        print(f"[gemm] {label} M={m} K={k} N={n} shard {width}: "
              + json.dumps(row), flush=True)

    h, hk, d = 32, 32, 64
    ends = [[p - 1 + CS.SERVE_GEN // 2] for p in (236, 359, 283, 195)]
    cases = {
        "decode": CS._paged_inputs(4, 1, h, hk, d, dt, 31,
                                   positions=ends)[:5],
        "prefill_chunk": CS._paged_inputs(
            1, CS.SERVE_CHUNK, h, hk, d, dt, 32,
            positions=[list(range(480, 480 + CS.SERVE_CHUNK))])[:5]}
    phased = DEC._bind(libs["paged_phases"].dash_paged_attention)
    for label, args_ in cases.items():
        scale = d ** -0.5
        kernel = CS._queued_ms(lambda: DEC.paged_attention_cuda(*args_,
                                                                scale))
        ref = DEC.paged_attention_cuda(*args_, scale)
        out = DEC._launch(phased, *args_, scale, None, None, None)[0]
        torch.cuda.synchronize()
        b, l = args_[0].shape[:2]
        ctas = b * hk * -(-l * (h // hk) // 8)
        per = stamps(libs["paged_phases"], 8 * ctas)
        keys = ("total", "wait", "scores", "running_max", "p", "pv_psum",
                "carry", "chunks")
        row = dict(kernel_ms=kernel, phases_bitwise=torch.equal(out, ref),
                   phases_median_clocks={
                       key: statistics.median(per[8 * i + j]
                                              for i in range(ctas))
                       for j, key in enumerate(keys)})
        result["paged"][label] = row
        print(f"[paged] {label}: " + json.dumps(row), flush=True)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip()
    result["sm_clock_after"] = clocks
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
