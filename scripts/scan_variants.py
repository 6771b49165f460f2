"""Time variants of the selective scan (``csrc/selective_scan.cu``) beside
its first design on one card, to see what sets its speed and what bounds it.

    python3 scripts/scan_variants.py [--out FILE] [--only NAME,...]

Each variant is the kernel's source built with other compile-time settings
(``nvcc -D``):

  L1, L4       1 or 4 lanes a channel (``SCAN_LANES``) instead of 2: the
               warps a CTA (4, 8 or 16; one backward CTA an SM at B = 1)
               against the registers a thread and the per-step work each
               lane repeats (8 lanes, 1024 threads, do not build: a lane's
               two spent exponentials cannot hold its four kept sums);
  s1, s2       1 or 2 stages in the load ring (``SCAN_STAGES``) instead of 3
               (the backward with fp32 z takes 2 of the 3: 3 do not fit):
               with one stage every tile waits for its loads;

and three that give wrong results on purpose, timed only (text
substitutions in the source):

  noload       no tile loaded after the ring's first fill: the kernels run
               on stale stages, so their time is their arithmetic alone;
  fastexp      ``__expf`` (one SFU op and a multiply) for the state's
               exponential: what the exact ``expf`` costs;
  phases, phases_L4
               ``clock64()`` stamps (2 and 4 lanes): the share of each
               warp's clocks in each phase of the forward (waiting for a
               tile, the steps, the gate) and of the backward (waiting,
               pass 1, the gate's terms, pass 2, the two reverse halves,
               finishing du/ddt/dz, the dB/dC barriers).

For the kernel (``kernel``: 2 lanes, 3 stages), the first design (``v1``,
``csrc/selective_scan_v1.cu``) and every variant it prints ptxas' registers
and spills of each kernel instantiation and the dynamic shared memory;
checks each against v1 at small ragged shapes (both z dtypes; S not a
multiple of 16, chunk not a multiple of 16, B = 2, and S = 1): ``h_last``
and the kept states bitwise, y and the gradients within ``SCAN_TOL``
(``chip_smoke.py``); then times the forward and the backward at the train
slice's Mamba shape (B = 1, S = 4096, Din = 16384, bf16 z, chunk 512), the
forward at the serve prefill (4, 512) and at the decode step (4, 1), each in
turns (kernel, v1, the variants, then the same in reverse) with the calls
queued behind a spin kernel. Imports nothing of JAX; needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
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
from repro_torch.kernels import scan as SCAN  # noqa: E402

OUT_DIR = build.BUILD_DIR.parent / "scan_variants"
REFILL = "if (tid == 0 && k > 0 && k - 1 + {} < n_tiles) {{"
VARIANTS = {"L1": (1, 3, []), "L4": (4, 3, []),
            "s1": (2, 1, []), "s2": (2, 2, []),
            "noload": (2, 3, [
                (REFILL.format("STAGES"), "if (false) {", 1),
                (REFILL.format("NS"), "if (false) {", 1),
                ("    mbar_wait(smem_u32(&sm.full[s]), (k / STAGES) & 1);",
                 "    if (k < STAGES) mbar_wait(smem_u32(&sm.full[s]), "
                 "(k / STAGES) & 1);", 1),
                ("mbar_wait(full, parity);",
                 "if (k < STAGES) mbar_wait(full, parity);", 2)]),
            "fastexp": (2, 3, [("expf(dtv * an[", "__expf(dtv * an[", 3)])}
# clock64() stamps a warp adds up over its tiles (per warp: the phases then
# the whole kernel), into a device buffer that dash_stamps copies out
STAMP_BUFFER = ("__device__ long long g_stamps[1 << 18];\n"
                "extern \"C\" int dash_stamps(void* out, int n) {\n"
                "  return static_cast<int>(cudaMemcpyFromSymbol(\n"
                "      out, g_stamps, n * sizeof(long long)));\n}\n")
FWD_PHASES = ("wait", "steps", "gate")
BARRIER_B = ("    named_sync(1, THREADS);  // before the next sub-chunk's "
             "exponentials\n")
FWD_END = ("  store_vec(h_last + (static_cast<size_t>(b) * Din + ch) * N + "
           "q * NL, h);\n}\n")
BWD_END = ("  if (q == 0) ad_part[row + static_cast<size_t>(Din) * N + ch] = "
           "dD;\n}\n")
# a warp's phases and whole-kernel clocks, written by its lane 0 at the end
STAMPS_OUT = ("  if (lane == 0) {\n    long long* o_ = g_stamps + 9 * "
              "((blockIdx.y * gridDim.x + blockIdx.x) * WARPS + warp);\n"
              "    for (int i = 0; i < 8; ++i) o_[i] = ph_[i];\n"
              "    o_[8] = clock64() - t_start_;\n  }\n}\n")
BWD_PHASES = ("wait", "pass1", "gate_terms", "pass2", "reverse_hi",
              "recompute_and_reverse_lo", "finish", "dBdC_barriers")
PHASE_EDITS = [
    ("  const int n_tiles = (S + TILE - 1) / TILE;\n",
     "  const int n_tiles = (S + TILE - 1) / TILE;\n"
     "  const long long t_start_ = clock64();\n"
     "  long long ph_[8] = {0, 0, 0, 0, 0, 0, 0, 0}, c0_ = 0;\n", 1),
    ("    mbar_wait(smem_u32(&sm.full[s]), (k / STAGES) & 1);\n",
     "    c0_ = clock64();\n"
     "    mbar_wait(smem_u32(&sm.full[s]), (k / STAGES) & 1);\n"
     "    ph_[0] += clock64() - c0_; c0_ = clock64();\n", 1),
    ("      __syncwarp();\n      // the warp's own channels: the lanes'",
     "      ph_[1] += clock64() - c0_; c0_ = clock64();\n"
     "      __syncwarp();\n      // the warp's own channels: the lanes'", 1),
    ("    __syncwarp();\n    if (lane == 0) mbar_arrive(smem_u32(&sm.empty[s]"
     "));\n  }\n  store_vec(h_last",
     "    __syncwarp();\n    ph_[2] += clock64() - c0_;\n"
     "    if (lane == 0) mbar_arrive(smem_u32(&sm.empty[s]));\n  }\n"
     "  store_vec(h_last", 1),
    ("  const int n_tiles = bwd_tiles(S, chunk);\n",
     "  const int n_tiles = bwd_tiles(S, chunk);\n"
     "  const long long t_start_ = clock64();\n"
     "  long long ph_[8] = {0, 0, 0, 0, 0, 0, 0, 0}, c0_ = 0;\n", 1),
    ("      mbar_wait(full, parity);\n#pragma unroll\n",
     "      c0_ = clock64();\n      mbar_wait(full, parity);\n"
     "      ph_[0] += clock64() - c0_; c0_ = clock64();\n#pragma unroll\n",
     1),
    ("      __syncwarp();\n      if (lane == 0) mbar_arrive(smem_u32(&sm.empty"
     "[s]));\n      continue;\n",
     "      __syncwarp();\n      ph_[1] += clock64() - c0_;\n"
     "      if (lane == 0) mbar_arrive(smem_u32(&sm.empty[s]));\n"
     "      continue;\n", 1),
    ("    mbar_wait(full, parity);\n    // the gate's terms",
     "    c0_ = clock64();\n    mbar_wait(full, parity);\n"
     "    ph_[0] += clock64() - c0_; c0_ = clock64();\n"
     "    // the gate's terms", 1),
    ("    __syncwarp();\n    // The reverse step i from",
     "    __syncwarp();\n    ph_[2] += clock64() - c0_; c0_ = clock64();\n"
     "    // The reverse step i from", 1),
    ("#pragma unroll\n    for (int i = TILE - 1; i >= HALF; --i)\n",
     "    ph_[3] += clock64() - c0_; c0_ = clock64();\n"
     "#pragma unroll\n    for (int i = TILE - 1; i >= HALF; --i)\n", 1),
    ("      if (i < len) reverse(i, hs[i - HALF], hs[i - HALF + 1]);\n",
     "      if (i < len) reverse(i, hs[i - HALF], hs[i - HALF + 1]);\n"
     "    ph_[4] += clock64() - c0_; c0_ = clock64();\n", 1),
    ("      if (i < len) reverse(i, hs[i], hs[i + 1]);\n",
     "      if (i < len) reverse(i, hs[i], hs[i + 1]);\n"
     "    ph_[5] += clock64() - c0_; c0_ = clock64();\n", 1),
    ("    __syncwarp();\n    if (lane == 0) mbar_arrive(smem_u32(&sm.empty[s]"
     "));\n    // dB, dC",
     "    __syncwarp();\n    ph_[6] += clock64() - c0_; c0_ = clock64();\n"
     "    if (lane == 0) mbar_arrive(smem_u32(&sm.empty[s]));\n    // dB, dC",
     1),
    (BARRIER_B, BARRIER_B + "    ph_[7] += clock64() - c0_;\n", 1),
    (FWD_END, FWD_END[:-2] + STAMPS_OUT, 1),
    (BWD_END, BWD_END[:-2] + STAMPS_OUT, 1),
]
VARIANTS["phases"] = (2, 3, PHASE_EDITS)
VARIANTS["phases_L4"] = (4, 3, PHASE_EDITS)
WRONG_ON_PURPOSE = ("noload", "fastexp", "phases", "phases_L4")
CHECKS = [("ragged_fp32", 2, 100, 256, 24, torch.float32),
          ("ragged_bf16", 2, 100, 256, 24, torch.bfloat16),
          ("one_step", 2, 1, 256, 512, torch.bfloat16)]
TRAIN = CS.SCAN_TRAIN
PREFILL = (4, 512, 16384)
DECODE = (4, 1, 16384)


def build_variants(names):
    """nvcc each variant in parallel; returns {name: (lib, ptxas log)}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lanes, stages, edits = VARIANTS[name]
        text = (build.CSRC / "selective_scan.cu").read_text()
        for old, new, count in edits:
            if text.count(old) != count:
                raise SystemExit(f"{name}: selective_scan.cu no longer holds "
                                 f"{old[:60]!r} {count} times")
            text = text.replace(old, new)
        text = text.replace('#include "', f'#include "{build.CSRC}/')
        if name.startswith("phases"):
            text = text.replace("namespace {\n",
                                STAMP_BUFFER + "namespace {\n", 1)
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        out = OUT_DIR / f"libscan_{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-DSCAN_LANES={lanes}",
               f"-DSCAN_STAGES={stages}", "-o", str(out), str(cu)]
        procs[name] = (out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name] = (ctypes.CDLL(str(out)), log)
    return libs


def resources(ptxas):
    """Registers and spills of each scan kernel instantiation."""
    def classify(name):
        found = re.search(r"scan_(fwd|bwd|fold)_kernel", name)
        if found is None:
            return None
        return dict(kernel=found.group(1),
                    dtype="bfloat16" if "bfloat16" in name else "float32")
    return CS._ptxas_entries(ptxas, classify)


def _inputs(b, s, din, dtype, seed):
    x, dy, dh_last = CS._scan_inputs(b, s, din, dtype, seed)
    return [x[k] for k in CS._SCAN_ARGS], dy, dh_last


def _grads(lib, v1, args, dy, h_chk, chunk, dh_last):
    du, ddt, dz, dh0, bc_part, ad_part = SCAN._bwd_partials(
        lib, v1, *args, dy, h_chk, chunk, dh_last)
    bc, ad = SCAN.fold_plain(bc_part, ad_part)
    return dict(du=du, ddt=ddt, dz=dz, dh0=dh0, dBdC=bc, dAdD=ad)


def check(lib, ref):
    """``lib``'s forward and backward against the first design's at
    ``CHECKS``: states bitwise, the rest within ``SCAN_TOL``."""
    out = {}
    for name, b, s, din, chunk, dtype in CHECKS:
        args, dy, dh_last = _inputs(b, s, din, dtype, seed=s + chunk)
        y, h, hc = SCAN._fwd(lib, *args, chunk, True)
        y1, h1, hc1 = SCAN._fwd(ref, *args, chunk, True)
        row = dict(h_last_equal=bool(torch.equal(h, h1)),
                   h_chk_equal=bool(torch.equal(hc, hc1)),
                   y_err=CS._scan_err(y, y1))
        ok = row["h_last_equal"] and row["h_chk_equal"] and (
            row["y_err"] <= CS.SCAN_TOL[dtype])
        try:
            g = _grads(lib, False, args, dy, hc, chunk, dh_last)
        except RuntimeError as err:  # a launch the build refuses
            row["bwd"] = f"refused: {err}"
        else:
            g1 = _grads(ref, True, args, dy, hc1, chunk, dh_last)
            for k in g:
                row[k + "_err"] = CS._scan_err(g[k], g1[k])
                tol = CS.SCAN_TOL[dtype if k == "dz" else torch.float32]
                ok = ok and row[k + "_err"] <= tol
        row["ok"] = ok
        out[name] = row
    return out


def in_turns(calls, reps):
    """``_queued_ms`` of each call in turns (forward, then reversed): the
    mean of each call's two readings."""
    times = {c: [] for c in calls}
    order = list(calls)
    for name in order + order[::-1]:
        times[name].append(CS._queued_ms(calls[name], reps=reps, rounds=3))
    return {c: statistics.mean(t) for c, t in times.items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the results as JSON")
    ap.add_argument("--only", default=",".join(VARIANTS),
                    help="comma-separated variants to build (default all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 2
    card = CS.phase_device()
    names = [n for n in args.only.split(",") if n]
    built = build.build(["selective_scan", "selective_scan_v1"])
    libs = build_variants(names)
    binds = {"kernel": SCAN._lib, "v1": SCAN._lib_v1}
    logs = {"kernel": built["selective_scan"]["ptxas"],
            "v1": built["selective_scan_v1"]["ptxas"]}
    layouts = {"kernel": SCAN.layout()}
    for name, (lib, log) in libs.items():
        bound = SCAN._bind(lib, "", 1)
        binds[name] = (lambda bound=bound: bound)
        logs[name] = log
        out = (ctypes.c_int * 9)()
        lib.dash_scan_layout(out)
        layouts[name] = list(out)
    result = dict(card=card, variants={})
    for name in binds:
        row = dict(ptxas=resources(logs[name]), layout=layouts.get(name))
        if name not in ("v1",) + WRONG_ON_PURPOSE:
            row["check"] = check(binds[name], SCAN._lib_v1)
        result["variants"][name] = row
        print(f"[variant] {name} " + json.dumps(row), flush=True)
    torch.cuda.synchronize()
    # the train shape: forward and backward
    b, s, din, chunk = TRAIN
    targs, tdy, _ = _inputs(b, s, din, torch.bfloat16, seed=13)
    with torch.no_grad():
        fwd = {n: (lambda lib=lib: SCAN._fwd(lib, *targs, chunk, True))
               for n, lib in binds.items()}
        result["train_fwd_ms"] = in_turns(fwd, reps=10)
        h_chk = SCAN._fwd(SCAN._lib, *targs, chunk, True)[2]
        bwd = {}
        for n, lib in binds.items():
            try:
                SCAN._bwd_partials(lib, n == "v1", *targs, tdy, h_chk, chunk,
                                   None)
            except RuntimeError:
                continue
            bwd[n] = (lambda lib=lib, v1=n == "v1": SCAN._bwd_partials(
                lib, v1, *targs, tdy, h_chk, chunk, None))
        result["train_bwd_ms"] = in_turns(bwd, reps=5)
        del targs, tdy, h_chk
        for key, (pb, ps, pdin), reps in (("prefill_fwd_ms", PREFILL, 10),
                                          ("decode_fwd_ms", DECODE, 50)):
            pargs, _, _ = _inputs(pb, ps, pdin, torch.bfloat16, seed=14)
            calls = {n: (lambda lib=lib, a=pargs: SCAN._fwd(
                lib, *a, 512, False)) for n, lib in binds.items()}
            result[key] = in_turns(calls, reps=reps)
    for key in ("train_fwd_ms", "train_bwd_ms", "prefill_fwd_ms",
                "decode_fwd_ms"):
        print(f"[timing] {key} " + json.dumps(result[key]), flush=True)
    for name in binds:
        if not name.startswith("phases"):
            continue
        lib = libs[name][0]
        warps = 4 * VARIANTS[name][0]
        for kind, phases, call in (
                ("fwd", FWD_PHASES, lambda lib=binds[name]: SCAN._fwd(
                    lib, *_inputs(b, s, din, torch.bfloat16, 13)[0], chunk,
                    True)),
                ("bwd", BWD_PHASES, None)):
            if call is None:
                targs2, tdy2, _ = _inputs(b, s, din, torch.bfloat16, 13)
                h_chk2 = SCAN._fwd(binds[name], *targs2, chunk, True)[2]
                SCAN._bwd_partials(binds[name], False, *targs2, tdy2, h_chk2,
                                   chunk, None)
                del targs2, tdy2, h_chk2
            else:
                call()
            torch.cuda.synchronize()
            n = 9 * (din // 128) * b * warps
            buf = (ctypes.c_longlong * n)()
            lib.dash_stamps(buf, n)
            per = [list(buf[9 * i:9 * i + 9]) for i in range(n // 9)]
            total = statistics.median(p[8] for p in per)
            result[f"{name}_{kind}_share"] = {
                ph: statistics.median(p[i] for p in per) / total
                for i, ph in enumerate(phases)}
            result[f"{name}_{kind}_clocks"] = total
            print(f"[phases] {name} {kind} " + json.dumps(
                result[f"{name}_{kind}_share"]) + f" of {total} clocks",
                flush=True)
    result["sm_clock_after"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0 if all(c["ok"] for v in result["variants"].values()
                    for c in v.get("check", {}).values()) else 1


if __name__ == "__main__":
    sys.exit(main())
