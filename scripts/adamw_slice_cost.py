"""What updating a large leaf in slices costs the dense train step
(card only).

    python3 scripts/adamw_slice_cost.py

StableLM-1.6B at full width and depth, ``chip_smoke.py``'s ``[train]``
flags without their ``--layers`` cut (B=4, S=1024, the DASH kernels,
random weights from seed 0). Three
settings of ``train/optimizer.py``'s ``UPDATE_WHOLE``: ``whole`` (the
default: every leaf of the model is updated in one call), ``mlp_sliced``
(2^28: the three MLP stacks, 2^28.04 elements each, are updated in slices
and copied into the result) and ``sliced`` (``UPDATE_SLICE``: the
embedding and the head, 2^27.6 each, too). After one untimed warm-up
step they run in the order whole, mlp_sliced, sliced, sliced, mlp_sliced,
whole; each turn times ``STEPS`` train steps and ``UPDATES`` calls of
``opt_update`` on the state's own params with grads of ones. Prints one JSON line per turn with each step's
and each update's ms, then one with each setting's medians and the card's
name and power limit.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

STEPS, UPDATES = 3, 5
SETTINGS = {"whole": O.UPDATE_WHOLE, "mlp_sliced": 1 << 28,
            "sliced": O.UPDATE_SLICE}
ORDER = ("whole", "mlp_sliced", "sliced", "sliced", "mlp_sliced", "whole")
_CUT = C.TRAIN_ARGV.index("--layers")
TRAIN_ARGV = C.TRAIN_ARGV[:_CUT] + C.TRAIN_ARGV[_CUT + 2:]


def _ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main():
    if not torch.cuda.is_available():
        print("adamw_slice_cost: needs a CUDA card", file=sys.stderr)
        return 2
    C.phase_build()
    args, cfg, tcfg, data, device = launch_train.configure(TRAIN_ARGV)
    state = TS.init_state(cfg, tcfg, seed=args.seed, device=device)
    step = TS.make_train_step(cfg, tcfg)
    batch = data.batch(0)
    state = step(state, batch)[0]                   # warm-up
    ones = O.tree_map(torch.ones_like, state["params"])
    big = [n for n in (x.numel() for x in O.tree_leaves(state["params"]))
           if n > O.UPDATE_SLICE]
    times = {k: {"step": [], "update": []} for k in SETTINGS}
    for name in ORDER:
        O.UPDATE_WHOLE = SETTINGS[name]
        steps, updates = [], []
        for i in range(STEPS):
            state, ms = _ms(lambda: step(state, data.batch(i + 1))[0])
            steps.append(ms)
        for _ in range(UPDATES):
            updates.append(_ms(lambda: O.opt_update(
                tcfg.opt, ones, state["opt"], state["params"],
                int(state["step"])))[1])
        times[name]["step"] += steps
        times[name]["update"] += updates
        print(json.dumps(dict(setting=name, update_whole=O.UPDATE_WHOLE,
                              step_ms=steps, update_ms=updates)), flush=True)
    O.UPDATE_WHOLE = SETTINGS["whole"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps(dict(
        leaves_over_update_slice=big,
        median_step_ms={k: statistics.median(v["step"])
                        for k, v in times.items()},
        median_update_ms={k: statistics.median(v["update"])
                          for k, v in times.items()},
        card=card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
