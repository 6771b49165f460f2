"""How far the DASH kernels' logits sit from the plain attention's, by depth,
with and without the router's choices pinned (card only).

    python3 scripts/moe_logits_noise.py

For each (arch, layers) of CASES at full width (random weights from seed 0;
B=4 prompts of S=512 tokens from seed 1): the forward's logits with
``attention_impl="cuda"`` and with ``"torch"``, the second run once with
its own router choices and once with the first run's (``chip_smoke.
_PinnedRouting``). Prints one JSON line per case: the router choices that
differ per layer unpinned, and for the pinned pair the largest absolute
difference, the quantiles (0.5, 0.9, 0.99, 1) over the 2048 rows of each
row's largest absolute difference and of its relative error norm
|cuda - plain| / |plain|, and the largest logit; then the card's name and
power limit. The dense Mistral-NeMo rows show what depth alone does.
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
from repro_torch.models import transformer as T  # noqa: E402

CASES = [("mistral-nemo-12b", 2), ("mistral-nemo-12b", 4),
         ("phi3.5-moe-42b-a6.6b", 1), ("phi3.5-moe-42b-a6.6b", 2),
         ("phi3.5-moe-42b-a6.6b", 4), ("llama4-scout-17b-a16e", 1)]
B, S = 4, 512
QUANTILES = (0.5, 0.9, 0.99, 1.0)


@torch.inference_mode()
def case(arch, layers):
    cfg = registry.get(arch).replace(attention_impl="cuda", n_layers=layers)
    plain_cfg = cfg.replace(attention_impl="torch")
    params = T.init(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(1, cfg.vocab, (B, S), generator=gen,
                           device="cuda")
    pin, own = C._PinnedRouting(), C._PinnedRouting()
    with pin.record():
        a, _ = T.forward(params, {"tokens": tokens}, cfg)
    with own.record():
        T.forward(params, {"tokens": tokens}, plain_cfg)
    with pin.replay():
        b, _ = T.forward(params, {"tokens": tokens}, plain_cfg)
    d = (a - b).abs()
    rel = (torch.linalg.vector_norm(a - b, dim=-1)
           / torch.linalg.vector_norm(b, dim=-1))
    q = torch.tensor(QUANTILES, device="cuda")
    out = dict(
        arch=arch, layers=layers, rows=B * S,
        unpinned_flips_per_layer=[int((x != y).any(-1).sum()) for x, y in
                                  zip(pin.calls, own.calls)],
        pinned_max_abs=d.max().item(), max_abs_logit=b.abs().max().item(),
        pinned_row_max_abs_quantiles=torch.quantile(
            d.amax(-1).flatten(), q).tolist(),
        pinned_row_rel_norm_quantiles=torch.quantile(rel.flatten(),
                                                     q).tolist())
    print(json.dumps(out), flush=True)
    del params
    C._free_device_memory()


def main():
    if not torch.cuda.is_available():
        print("moe_logits_noise: needs a CUDA card", file=sys.stderr)
        return 2
    C.phase_build()
    for arch, layers in CASES:
        case(arch, layers)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
