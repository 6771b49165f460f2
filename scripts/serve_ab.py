"""Serve from several checkouts of the repo in turns on one card, to compare
what a serving user feels between two commits within one call.

    python3 scripts/serve_ab.py TREE [TREE ...] [--slice xlstm] [--out FILE]

Each TREE is the root of a checkout, for example the parent commit unpacked
with ``git archive`` into ``build/parent``. For each, in a fresh process
started in that tree, the script builds the slice's kernels and runs it
with that checkout's own code, then prints one JSON line per run. Name the
trees in turns (parent, change, change, parent). Imports nothing of JAX;
needs a card. The slices:

  continuous  (the default) StableLM-1.6B through the continuous engine:
              the checkout's ``chip_smoke.run_serve_continuous()`` (the
              ``[serve-continuous]`` phase: 8 requests, 4 slots, full
              width, random weights from seed 0): decode step ms, decode
              tok/s, one decode step's device time;
  xlstm       xLSTM-350M at full width and depth (bf16, random weights
              from seed 0) at ``chip_smoke.SERVE_XLSTM``'s shape (4 x
              prompt 512): the static engine's prefill
              (``transformer.prefill_step``, the recurrences) and
              ``transformer.forward`` (the parallel form), each the median
              of 7 host-clock runs after 3 warm-ups, and each once under
              the profiler: the device's busy ms beside the host's; then
              the static decode as ``chip_smoke`` times it (from a fresh
              prefill, 31 greedy ``transformer.decode_step`` calls
              synchronised at the end): decode tok/s, the median of 7
              runs after 2 warm-ups (each run's beside it), the median
              step's ms, and one run under the profiler: the device's
              busy ms a step.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

RUN = """
import json, sys
sys.path[:0] = ["src", "."]
import chip_smoke as CS
from repro_torch.kernels import build
build.build(["paged_attn", "gemm", "rows"])
CS.run_serve_continuous()
"""
RUN_XLSTM = """
import json, statistics, sys, time
sys.path[:0] = ["src", "."]
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
import chip_smoke as CS
from repro_torch.configs import registry
from repro_torch.kernels import build
from repro_torch.models import transformer as T
build.build(["mlstm", "slstm"])
s = CS.SERVE_XLSTM
cfg = registry.get(s["arch"])
params = T.init(cfg, seed=0, device="cuda")
gen = torch.Generator(device="cuda").manual_seed(1)
batch = {"tokens": torch.randint(1, cfg.vocab, (s["batch"], s["prompt"]),
                                 generator=gen, device="cuda")}
calls = {"prefill": lambda: T.prefill_step(params, batch, cfg,
                                           max_seq=s["prompt"] + s["gen"]),
         "forward": lambda: T.forward(params, batch, cfg)}
row = {}
with torch.inference_mode():
    for name, fn in calls.items():
        for _ in range(3):
            fn()
        row[name + "_ms"] = statistics.median(
            CS._timed(fn)[1] * 1e3 for _ in range(7))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        row[name + "_device_busy_ms"] = sum(
            a.self_device_time_total for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA) / 1e3

    def decode_all():
        # chip_smoke's static decode: from a fresh prefill, gen - 1 greedy
        # steps, synchronised only at the end
        logits, caches = calls["prefill"]()
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(1, s["gen"]):
            out, _ = T.decode_step(params, caches, tok, s["prompt"] + i - 1,
                                   cfg)
            tok = torch.argmax(out[:, -1], -1)[:, None].to(torch.int32)
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    steps = s["gen"] - 1
    for _ in range(2):
        decode_all()
    runs = [decode_all() for _ in range(7)]
    row["decode_tok_per_s_runs"] = [s["batch"] * steps / x for x in runs]
    row["decode_tok_per_s"] = statistics.median(row["decode_tok_per_s_runs"])
    row["decode_step_ms"] = statistics.median(runs) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        decode_all()
    row["decode_step_device_busy_ms"] = sum(
        a.self_device_time_total for a in prof.key_averages()
        if a.device_type == DeviceType.CUDA) / 1e3 / steps
print("[xlstm-ab] " + json.dumps(row), flush=True)
"""
KEYS = ("decode_step_ms_median", "decode_step_ms_p90", "decode_tok_per_s",
        "prefill_chunk_ms", "run_s", "launches_per_decode_step")
PROFILE_KEYS = ("device_busy_ms", "wall_ms_traced", "busy_share",
                "device_ms_by_kernel")


def _phase_line(out, tag):
    prefix = f"[{tag}] "
    for line in out.splitlines():
        if line.startswith(prefix):
            return json.loads(line[len(prefix):])
    raise RuntimeError(f"no {prefix!r} line in the run's output")


def run(tree, slice_="continuous"):
    tree = Path(tree).resolve()
    env = dict(os.environ, PYTHONPATH=f"{tree / 'src'}{os.pathsep}{tree}")
    code = RUN_XLSTM if slice_ == "xlstm" else RUN
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    if slice_ == "xlstm":
        return dict(tree=str(tree), **_phase_line(proc.stdout, "xlstm-ab"))
    serve = _phase_line(proc.stdout, "serve-continuous")
    profile = _phase_line(proc.stdout, "serve-continuous-profile")
    row = {"tree": str(tree)}
    row.update({k: serve[k] for k in KEYS})
    row.update({k: profile[k] for k in PROFILE_KEYS})
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, in turns")
    ap.add_argument("--slice", choices=("continuous", "xlstm"),
                    default="continuous", help="what to serve (see above)")
    ap.add_argument("--out", default=None, help="write the runs as JSON")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    rows = []
    for tree in args.trees:
        rows.append(run(tree, args.slice))
        print("[serve-ab] " + json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card, runs=rows),
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
