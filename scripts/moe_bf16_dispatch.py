"""How far the bf16 gather dispatch sits from the einsum dispatch, against
``chip_smoke.py``'s limit, on the sound path and on three faulty ones
(card only).

    python3 scripts/moe_bf16_dispatch.py

One full-width Phi-3.5-MoE expert layer as ``[train-moe-gather]`` makes it
(weights from seed 0, normal inputs of ``MOE_GATHER_SHAPE``, deterministic
algorithms). Each case runs ``apply_moe`` on the model's config at a
capacity factor and ``apply_moe_gather`` on the case's variant of it, and
prints one JSON line with ``chip_smoke.moe_bf16_gap``'s reading (the largest
|difference|, the largest |expert output| m, the limit, the difference in
bf16 ulps of m). The cases:

* ``sound``: the same config, at each capacity factor of
  ``MOE_GATHER_CAPACITY``;
* ``float16``: the gather path in float16, a path that rounds differently;
* ``no_capacity``: the gather path at capacity factor 8 against the einsum
  path at 0.5, so none of the tokens that the einsum path drops is dropped;
* ``no_renorm``: the gather path without ``renorm_topk``.

Then the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models.module import init_tree  # noqa: E402


@torch.inference_mode()
def main():
    if not torch.cuda.is_available():
        print("moe_bf16_dispatch: needs a CUDA card", file=sys.stderr)
        return 2
    base = registry.get(C.TRAIN_MOE_ARGV[1])
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = init_tree(MOE.moe_defs(base), gen, base.dtype, "cuda")
    b, s = C.MOE_GATHER_SHAPE
    x = torch.randn((b, s, base.d_model), generator=gen,
                    device="cuda").to(base.dtype)
    cases = [("sound", cf, None, {}) for cf in C.MOE_GATHER_CAPACITY] + [
        ("float16", 1.25, x.half(), dict(dtype_name="float16")),
        ("no_capacity", 0.5, None, dict(capacity_factor=8.0)),
        ("no_renorm", 1.25, None, dict(renorm_topk=False))]
    torch.use_deterministic_algorithms(True)
    try:
        for name, cf, gx, change in cases:
            cfg = base.replace(capacity_factor=cf)
            gap = C.moe_bf16_gap(p, x, cfg, gx, cfg.replace(**change))[0]
            print(json.dumps(dict(case=name, capacity_factor=cf,
                                  gather_change=change, **gap)), flush=True)
    finally:
        torch.use_deterministic_algorithms(False)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
