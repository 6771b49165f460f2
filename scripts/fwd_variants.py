"""Time variants of the port's bf16 forward kernel side by side on one card,
to see what holds it back.

    python3 scripts/fwd_variants.py [--out chiprun_out/fwd_variants.json]

Each variant is ``src/repro_torch/kernels/csrc/flash_fwd.cu`` with one part
taken out by a text substitution (the script stops if the source no longer
holds the text):

  base                the kernel as the port builds it;
  no_softmax          the online softmax skipped (P = the raw scores): the
                      products, the K/V loads and the pipeline alone;
  no_load             after the ring's first fill the producer loads no K/V
                      tile (the consumers reuse stale ones): all but the K/V
                      traffic;
  no_load_no_softmax  both: the tensor-core pipeline alone;
  no_pingpong         the consumer warpgroups' named-barrier hand-over gone;
  two_stages          a K/V ring of 2 stages instead of 4.

Variants that skip work compute wrong outputs; only their times mean
something. Each is built with the port's nvcc flags into
``build/fwd_variants/`` and timed in turns (every variant, then again in
reverse order) with CUDA events over direct calls of the C entry points on
preallocated outputs, at the training slice's attention shape (B=4, H=32,
S=1024, D=64, bf16: full mask and causal) and the serving slice's (causal,
S=512), beside SDPA. ``phases`` is ``base`` with clock64() stamps in the
steady-state loop of CTA 0's two consumer warpgroups: the clocks a kv tile
spends in each phase of the full-mask forward, and per work item.
Imports nothing of JAX; needs a card.
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

from repro_torch.kernels import build  # noqa: E402

SOURCE = build.CSRC / "flash_fwd.cu"
OUT_DIR = build.BUILD_DIR.parent / "fwd_variants"

NO_SOFTMAX = [("      online_softmax<MODE>(s, m, l, alpha, scale_log2,",
               "      if (0) online_softmax<MODE>(s, m, l, alpha, "
               "scale_log2,")]
NO_LOAD = [("      mbar_expect_tx(sm.full(s), 2 * T::TILE);\n",
            "      mbar_expect_tx(sm.full(s), it < T::STAGES ? 2 * T::TILE : "
            "0);\n      if (it >= T::STAGES) continue;\n")]
NO_PINGPONG = [("named_sync(mine, 2 * WG);", ""),
               ("named_arrive(other, 2 * WG);", ""),
               ("if (c == 1) named_arrive(BAR_TURN, 2 * WG);", ""),
               ("if (c == 0) named_sync(BAR_TURN, 2 * WG);", "")]
TWO_STAGES = [("constexpr int MAX_STAGES = 4;",
               "constexpr int MAX_STAGES = 2;")]
VARIANTS = dict(base=[], no_softmax=NO_SOFTMAX, no_load=NO_LOAD,
                no_load_no_softmax=NO_LOAD + NO_SOFTMAX,
                no_pingpong=NO_PINGPONG, two_stages=TWO_STAGES)

# the phases of a steady-state kv tile (j >= 1), stamped by CTA 0's first
# thread of each consumer warpgroup
PHASE_NAMES = ("wait_full", "turn", "issue", "wait_s", "softmax", "wait_pv",
               "rescale_pack")
PHASES = [
    ("namespace {\n",
     "__device__ unsigned long long g_phases[2][10];\nnamespace {\n"),
    ("""      mbar_wait(sm.full(st), (cur / T::STAGES) & 1);
      named_sync(mine, 2 * WG);""",
     """      long long ts[8];
      ts[0] = clock64();
      mbar_wait(sm.full(st), (cur / T::STAGES) & 1);
      ts[1] = clock64();
      named_sync(mine, 2 * WG);
      ts[2] = clock64();"""),
    ("""      named_arrive(other, 2 * WG);
      wgmma_wait<1>();
      fence_regs(s);""",
     """      named_arrive(other, 2 * WG);
      ts[3] = clock64();
      wgmma_wait<1>();
      fence_regs(s);
      ts[4] = clock64();"""),
    ("""      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);""",
     """      fence_regs(s);
      ts[5] = clock64();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      ts[6] = clock64();"""),
    ("""      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p(p, s);
    }""",
     """      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      pack_p(p, s);
      fence_regs(p);
      ts[7] = clock64();
      if (blockIdx.x == 0 && tid % WG == 0) {
        for (int z = 0; z < 7; ++z) g_phases[c][z] += ts[z + 1] - ts[z];
        g_phases[c][7] += 1;
      }
    }"""),
    ("""    const int row_g = qt * BLOCK_M + r0;""",
     """    const int row_g = qt * BLOCK_M + r0;
    const long long item0 = clock64();"""),
    ("""    store_output<D>(o, m, l, stage, c, warp, g, t,
                    static_cast<size_t>(bh) * seq + qt * BLOCK_M, out, lse);""",
     """    store_output<D>(o, m, l, stage, c, warp, g, t,
                    static_cast<size_t>(bh) * seq + qt * BLOCK_M, out, lse);
    if (blockIdx.x == 0 && tid % WG == 0) {
      g_phases[c][8] += clock64() - item0;
      g_phases[c][9] += 1;
    }"""),
]
PHASES_TAIL = """
extern "C" int dash_fwd_phases(void* out) {
  return cudaMemcpyFromSymbol(out, g_phases, sizeof(g_phases));
}
"""


def variant_source(name, text):
    edits = PHASES if name == "phases" else VARIANTS[name]
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: the kernel source no longer holds "
                             f"{old[:60]!r}")
        text = text.replace(old, new)
    text = text.replace('#include "', f'#include "{build.CSRC}/')
    return text + (PHASES_TAIL if name == "phases" else "")


def build_all(names):
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    procs = {}
    for name in names:
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(variant_source(name, text))
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o",
               str(OUT_DIR / f"lib{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
        lib = ctypes.CDLL(str(OUT_DIR / f"lib{name}.so"))
        full, causal = lib.dash_flash_fwd_full, lib.dash_flash_fwd_causal
        full.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        causal.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        libs[name] = lib
    return libs


def ms(fn, reps=50, rounds=5):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the results as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fwd_variants: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = build_all(list(VARIANTS) + ["phases"])

    b, h, s, d = 4, 32, 1024, 64
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((b * h, s, d), generator=gen, device="cuda")
               .bfloat16() for _ in range(3))
    out = torch.empty_like(q)
    lse = torch.empty((b * h, s), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr())
    scale = d ** -0.5
    serve = [x.view(b, h, s, d)[:, :, :512].contiguous() for x in (q, k, v)]
    sptrs = tuple(x.data_ptr() for x in serve) + (out.data_ptr(),
                                                  lse.data_ptr())
    calls = dict(
        full=lambda lib: lib.dash_flash_fwd_full(*ptrs, b * h, s, s, d, h, h,
                                                 scale, 1, stream),
        causal=lambda lib: lib.dash_flash_fwd_causal(*ptrs, b * h, s, d, h,
                                                     h, scale, 1, stream),
        causal_512=lambda lib: lib.dash_flash_fwd_causal(
            *sptrs, b * h, 512, d, h, h, scale, 1, stream))
    names = list(VARIANTS)
    times = {n: {c: [] for c in calls} for n in names}
    for name in names + names[::-1]:
        for call, fn in calls.items():
            times[name][call].append(ms(lambda: fn(libs[name])))
    torch.cuda.synchronize()
    q4, k4, v4 = (x.view(b, h, s, d) for x in (q, k, v))
    sdpa = dict(
        full=ms(lambda: F.scaled_dot_product_attention(q4, k4, v4)),
        causal=ms(lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                         is_causal=True)),
        causal_512=ms(lambda: F.scaled_dot_product_attention(
            *serve, is_causal=True)))
    for name in names:
        print(f"[variant] {name}: " + json.dumps(times[name]), flush=True)
    print("[variant] sdpa: " + json.dumps(sdpa), flush=True)

    lib = libs["phases"]
    calls["full"](lib)
    torch.cuda.synchronize()
    before = (ctypes.c_ulonglong * 20)()
    lib.dash_fwd_phases(before)
    calls["full"](lib)
    torch.cuda.synchronize()
    after = (ctypes.c_ulonglong * 20)()
    lib.dash_fwd_phases(after)
    phases = {}
    for c in range(2):
        delta = [after[c * 10 + i] - before[c * 10 + i] for i in range(10)]
        tiles, items = max(delta[7], 1), max(delta[9], 1)
        phases[f"consumer{c}"] = dict(
            {n: delta[i] / tiles for i, n in enumerate(PHASE_NAMES)},
            steady_tiles=delta[7], clocks_per_item=delta[8] / items,
            items=delta[9])
        print(f"[phases] consumer {c} (clocks a steady kv tile, full mask): "
              + json.dumps(phases[f"consumer{c}"]), flush=True)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                             "--format=csv,noheader"], capture_output=True,
                            text=True).stdout.strip()
    result = dict(card=card, sm_clock_after=clocks, ms=times, sdpa_ms=sdpa,
                  phases=phases)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
