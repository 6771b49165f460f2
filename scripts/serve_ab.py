"""Serve StableLM-1.6B through the continuous engine from several checkouts
of the repo in turns on one card, to compare what a serving user feels
(decode step ms, decode tok/s) and one decode step's device time between
two commits within one call.

    python3 scripts/serve_ab.py TREE [TREE ...] [--out FILE]

Each TREE is the root of a checkout, for example the parent commit unpacked
with ``git archive`` into ``build/parent``. For each, in a fresh process
started in that tree, the script builds the serve path's kernels and runs
that checkout's own ``chip_smoke.run_serve_continuous()`` (the
``[serve-continuous]`` phase: 8 requests, 4 slots, full width, random
weights from seed 0), then prints one JSON line per run with the phase's
numbers. Name the trees in turns (parent, change, change, parent). Imports
nothing of JAX; needs a card.
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


def run(tree):
    tree = Path(tree).resolve()
    env = dict(os.environ, PYTHONPATH=f"{tree / 'src'}{os.pathsep}{tree}")
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree, env=env,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    serve = _phase_line(proc.stdout, "serve-continuous")
    profile = _phase_line(proc.stdout, "serve-continuous-profile")
    row = {"tree": str(tree)}
    row.update({k: serve[k] for k in KEYS})
    row.update({k: profile[k] for k in PROFILE_KEYS})
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkout roots, in turns")
    ap.add_argument("--out", default=None, help="write the runs as JSON")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    rows = []
    for tree in args.trees:
        rows.append(run(tree))
        print("[serve-ab] " + json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card, runs=rows),
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
