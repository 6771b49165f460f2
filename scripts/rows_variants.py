"""Time variants of the port's row kernels (``csrc/rows.cu``: the row norm
and the sampler's row log-softmax with argmax) side by side on one card, to
see what holds them back.

    python3 scripts/rows_variants.py [--out FILE]

Each variant is ``src/repro_torch/kernels/csrc/rows.cu`` changed by a text
substitution (the script stops if the source no longer holds the text):

  lsm_c8       the log-softmax on clusters of 8 CTAs of 512 threads
               instead of 16 of 256;
  lsm_h2, lsm_h8
               2 or 8 threads a chain instead of 4;
  lsm_batch8   8 exps a thread in flight instead of 4;
  lsm_nopdl    the log-softmax launched without programmatic dependent
               launch;
  lsm_scalar   4-byte copies and stores where 16-byte ones would do;
  lsm_phases   the log-softmax with clock64() stamps, per CTA: clocks to the
               staged row, to the sub-chains' argmaxes, to the max (pushed
               over the cluster and folded), to the exps, to the
               log-sum-exp (pushed and folded), to the end;
  norm_phases  the norm with clock64() stamps, per CTA: clocks to the
               loaded registers, to the first and the second reduction, to
               the end;
  norm_nopdl   the norm launched without programmatic dependent launch;
  norm_prefetch  scale and bias loaded before ``griddepcontrol.wait`` (x
               after it): they would overlap the kernel before, but read
               stale weights if that kernel wrote them, so the kernel waits
               first.

Every variant must give the kernel's bits (checked, through integer
views).
Each is built with the port's nvcc flags into ``build/rows_variants/`` and
timed against the kernel and the first design (``csrc/rows_v1.cu``) in
turns (kernel, v1, variants, variants in reverse, v1, kernel) with the calls
queued behind a spin kernel, at the serve path's shapes (StableLM-1.6B): the
log-softmax over V = 100,352 at M = 1, 4 and 32, the norm at d = 2048, bf16,
LayerNorm, at M = 4 and 32; ``torch.log_softmax`` and ``F.layer_norm``
beside them. Imports nothing of JAX; needs a card.
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
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as CS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import rows as ROWS  # noqa: E402

OUT_DIR = build.BUILD_DIR.parent / "rows_variants"

LSM_STAMPS = [
    ("  const unsigned c = cluster_rank();\n",
     "  long long t0_ = clock64(), ts_[6];\n"
     "  const unsigned c = cluster_rank();\n"),
    ("  cp_async_wait_all();\n  __syncthreads();\n",
     "  cp_async_wait_all();\n  __syncthreads();\n"
     "  ts_[0] = clock64() - t0_;\n"),
    ("  __syncthreads();\n  cluster_wait();\n",
     "  __syncthreads();\n  ts_[1] = clock64() - t0_;\n  cluster_wait();\n"),
    ("    mi = isnan(p0.v) ? p0.i : i;\n  }\n",
     "    mi = isnan(p0.v) ? p0.i : i;\n  }\n"
     "  ts_[2] = stamp_after(mx) - t0_;\n"),
    ("      if (k < n) es[k * T + j] = expf(__fsub_rn(e[u], mx));\n    }\n"
     "  }\n  __syncthreads();\n",
     "      if (k < n) es[k * T + j] = expf(__fsub_rn(e[u], mx));\n    }\n"
     "  }\n  __syncthreads();\n  ts_[3] = clock64() - t0_;\n"),
    ("  const float lse = logf(tot);\n",
     "  const float lse = logf(tot);\n  ts_[4] = stamp_after(lse) - t0_;\n"),
    ("  if (c == 0 && tid == 0) arg[blockIdx.y] = mi;\n",
     "  if (c == 0 && tid == 0) arg[blockIdx.y] = mi;\n"
     "  ts_[5] = clock64() - t0_;\n"
     "  if (tid == 0) {\n"
     "    long long* o = g_stamps + 8 * (blockIdx.y * gridDim.x + "
     "blockIdx.x);\n"
     "    for (int i = 0; i < 6; ++i) o[i] = ts_[i];\n  }\n"),
]
LSM_STAMP_KEYS = ("staged", "subchains", "max", "exps", "lse", "end")
NORM_STAMPS = [
    ("  const int t = threadIdx.x;\n  float v[N]",
     "  const int t = threadIdx.x;\n  long long t0_ = clock64(), ts_[4];\n"
     "  float v[N]"),
    ("  float r, mu = 0.f;\n",
     "  float r, mu = 0.f;\n  { float z_ = 0.f;\n"
     "    for (int k = 0; k < N; ++k) z_ += v[k] + sc[k] + bs[k];\n"
     "    if (z_ == 1.2345f) y[row] = v[0];\n    ts_[0] = clock64() - t0_; }\n"),
    ("    mu = __fdiv_rn(block_sum<NORM_THREADS>(s, part[0]),\n"
     "                   static_cast<float>(d));\n",
     "    mu = __fdiv_rn(block_sum<NORM_THREADS>(s, part[0]),\n"
     "                   static_cast<float>(d));\n"
     "    ts_[1] = clock64() - t0_;\n"),
    ("    r = rsqrtf(__fadd_rn(var, eps));\n",
     "    r = rsqrtf(__fadd_rn(var, eps));\n    ts_[2] = clock64() - t0_;\n"),
    ("      store_f(y, row + i, out);\n    }\n  }\n}\n",
     "      store_f(y, row + i, out);\n    }\n  }\n"
     "  ts_[3] = clock64() - t0_;\n"
     "  if (t == 0) {\n    long long* o = g_stamps + 4 * blockIdx.x;\n"
     "    for (int i = 0; i < 4; ++i) o[i] = ts_[i];\n  }\n}\n"),
]
STAMP_BUFFER = ("__device__ long long g_stamps[8 * 16384];\n"
                "__device__ __forceinline__ long long stamp_after(float v) {\n"
                "  long long t;\n"
                "  asm volatile(\"mov.u64 %0, %%clock64;\" : \"=l\"(t) : "
                "\"f\"(v) : \"memory\");\n  return t;\n}\n"
                "extern \"C\" int dash_stamps(void* out, int n) {\n"
                "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
                "      out, g_stamps, n * sizeof(long long)));\n}\n")
CLUSTER = "constexpr int LSM_CLUSTER = 16;"
HELPERS = "constexpr int LSM_HELPERS = 4;"
NORM_LOADS = (
    "  griddep_wait();\n#pragma unroll\n  for (int k = 0; k < N; ++k) {\n"
    "    const int i = t + k * NORM_THREADS;\n    v[k] = sc[k] = bs[k] = 0.f;\n"
    "    if (i < d) {\n      v[k] = load_f(x, row + i);\n"
    "      sc[k] = scale[i];\n      if (bias != nullptr) bs[k] = bias[i];\n"
    "    }\n  }\n")
NORM_PREFETCH_LOADS = (
    "#pragma unroll\n  for (int k = 0; k < N; ++k) {\n"
    "    const int i = t + k * NORM_THREADS;\n    v[k] = sc[k] = bs[k] = 0.f;\n"
    "    if (i < d) {\n      sc[k] = scale[i];\n"
    "      if (bias != nullptr) bs[k] = bias[i];\n    }\n  }\n"
    "  griddep_wait();\n#pragma unroll\n  for (int k = 0; k < N; ++k)\n"
    "    if (t + k * NORM_THREADS < d) v[k] = load_f(x, row + t + k * "
    "NORM_THREADS);\n")
VARIANTS = {
    "lsm_c8": [(CLUSTER, "constexpr int LSM_CLUSTER = 8;")],
    "lsm_h2": [(HELPERS, "constexpr int LSM_HELPERS = 2;")],
    "lsm_h8": [(HELPERS, "constexpr int LSM_HELPERS = 8;")],
    "lsm_batch8": [("constexpr int LSM_BATCH = 4;",
                    "constexpr int LSM_BATCH = 8;")],
    "lsm_nopdl": [("  cfg.numAttrs = 2;\n", "  cfg.numAttrs = 1;\n")],
    "lsm_scalar": [("  const bool vec = v_len % 4 == 0 &&",
                    "  const bool vec = false && v_len % 4 == 0 &&")],
    "lsm_phases": LSM_STAMPS,
    "norm_phases": NORM_STAMPS,
    "norm_nopdl": [("  cfg.attrs = attr;\n  cfg.numAttrs = 1;\n",
                    "  cfg.attrs = attr;\n  cfg.numAttrs = 0;\n")],
    "norm_prefetch": [(NORM_LOADS, NORM_PREFETCH_LOADS)],
}
V = 100352
LSM_M = (1, 4, 32)
NORM_M = (4, 32)


def build_all():
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = (build.CSRC / "rows.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: rows.cu no longer holds "
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


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t.view(
        torch.int16)


def in_turns(calls):
    """``_queued_ms`` of each call in turns (forward, then reversed): the
    mean of each call's two readings."""
    times = {c: [] for c in calls}
    order = list(calls)
    for name in order + order[::-1]:
        times[name].append(CS._queued_ms(calls[name]))
    return {c: statistics.mean(t) for c, t in times.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the results as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rows_variants: no CUDA device", file=sys.stderr)
        return 2
    card = CS.phase_device()
    build.build(["rows", "rows_v1"])
    libs = build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = dict(card=card, log_softmax={}, norm={})
    stream = torch.cuda.current_stream().cuda_stream
    lsm_names = [n for n in VARIANTS if n.startswith("lsm")]
    for m in LSM_M:
        x = CS._rand((m, V), gen, scale=4.0)
        ref, ref_arg = ROWS.log_softmax_argmax_v1(x)
        calls = {"kernel": lambda x=x: ROWS.log_softmax_argmax_cuda(x),
                 "v1": lambda x=x: ROWS.log_softmax_argmax_v1(x),
                 "torch.log_softmax": lambda x=x: torch.log_softmax(x, -1)}
        outs = {}
        for name in lsm_names:
            fn = ROWS._bind(libs[name])[1]
            out = torch.empty_like(x)
            arg = torch.empty((m,), dtype=torch.int64, device="cuda")
            outs[name] = (out, arg)
            calls[name] = (lambda fn=fn, x=x, out=out, arg=arg: fn(
                x.data_ptr(), out.data_ptr(), arg.data_ptr(), m, V, stream))
        row = in_turns(calls)
        got, got_arg = ROWS.log_softmax_argmax_cuda(x)
        torch.cuda.synchronize()
        row["kernel_bitwise_v1"] = (torch.equal(bits(got), bits(ref))
                                    and torch.equal(got_arg, ref_arg))
        for name, (out, arg) in outs.items():
            row[f"{name}_bitwise_v1"] = (torch.equal(bits(out), bits(ref))
                                         and torch.equal(arg, ref_arg))
        per = stamps(libs["lsm_phases"], 8 * 16 * m)
        row["lsm_phases_median_clocks"] = {
            key: statistics.median(per[8 * i + j] for i in range(16 * m))
            for j, key in enumerate(LSM_STAMP_KEYS)}
        result["log_softmax"][f"M={m}"] = row
        print(f"[log_softmax] M={m} V={V}: " + json.dumps(row), flush=True)
    d, dt = 2048, torch.bfloat16
    sc, bi = CS._rand((d,), gen) + 1, CS._rand((d,), gen)
    sc16, bi16 = sc.to(dt), bi.to(dt)
    norm_fns = {name: ROWS._bind(libs[name])[0]
                for name in VARIANTS if name.startswith("norm")}
    for m in NORM_M:
        x = (CS._rand((m, d), gen) * 3).to(dt)
        outs = {name: torch.empty_like(x) for name in norm_fns}
        calls = {"kernel": lambda x=x: ROWS.norm_cuda(x, sc, bi),
                 "v1": lambda x=x: ROWS.norm_v1(x, sc, bi),
                 "F.layer_norm": lambda x=x: F.layer_norm(x, (d,), sc16,
                                                          bi16)}
        for name, fn in norm_fns.items():
            calls[name] = (lambda fn=fn, x=x, out=outs[name]: fn(
                x.data_ptr(), sc.data_ptr(), bi.data_ptr(), out.data_ptr(),
                m, d, 1e-5, 1, stream))
        row = in_turns(calls)
        ref = ROWS.norm_v1(x, sc, bi)
        got = ROWS.norm_cuda(x, sc, bi)
        for name in norm_fns:
            calls[name]()
        torch.cuda.synchronize()
        row["kernel_bitwise_v1"] = torch.equal(bits(got), bits(ref))
        for name, out in outs.items():
            row[f"{name}_bitwise_v1"] = torch.equal(bits(out), bits(ref))
        per = stamps(libs["norm_phases"], 4 * m)
        row["norm_phases_median_clocks"] = {
            key: statistics.median(per[4 * i + j] for i in range(m))
            for j, key in enumerate(("loaded", "mean", "var", "end"))}
        result["norm"][f"M={m}"] = row
        print(f"[norm] M={m} d={d} bf16 layernorm: " + json.dumps(row),
              flush=True)
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
