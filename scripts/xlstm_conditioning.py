"""How xLSTM-350M's depth amplifies the kernels' rounding differences.

    python3 scripts/xlstm_conditioning.py [--out xlstm_cond.json]

On the card, for fp32 and bf16 and for cuts of xLSTM-350M at full width
(one mLSTM layer, one sLSTM layer, the two, four mLSTM layers, 8, 16 and
all 24 layers; random weights from seed 0, the serve slice's 4 x 512
prompt): the prefill logits (the recurrent kernels) and the ``forward``
logits (the parallel kernel) against the same model on the plain mixers
(``chip_smoke._plain_mixers``): max |diff|, max row relative error, argmax
agreement. Each kernel alone agrees with its plain version within ~1e-6
(``chip_smoke.py``'s ``[kernel-check] xlstm``); this shows what the layers
make of that, and why ``[serve-xlstm]`` gates the fp32 model's logits and
reads the bf16 model's. One JSON line a (dtype, cut), the card's name and
power limit first. Card only; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as CS  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.launch.train import cut_layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

CUTS = (("mlstm",), ("slstm",), ("mlstm", "slstm"), ("mlstm",) * 4, "8",
        "16", "24")


@torch.inference_mode()
def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("xlstm_conditioning: needs the card")
    rows = [dict(device=CS.phase_device())]
    base = registry.get(CS.SERVE_XLSTM["arch"])
    b, s = CS.SERVE_XLSTM["batch"], CS.SERVE_XLSTM["prompt"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(1, base.vocab, (b, s), generator=gen,
                           device="cuda")
    batch = {"tokens": prompt}
    for dtype in ("float32", "bfloat16"):
        for cut in CUTS:
            cfg = base.replace(dtype_name=dtype)
            cfg = (cut_layers(cfg, cut) if isinstance(cut, str) else
                   cfg.replace(n_layers=len(cut), block_pattern=cut))
            params = T.init(cfg, seed=0, device="cuda")
            row = dict(dtype=dtype, pattern=list(cfg.block_pattern),
                       layers=cfg.n_layers,
                       prefill=CS._vs_plain(lambda: T.prefill_step(
                           params, batch, cfg, max_seq=s)[0]),
                       forward=CS._vs_plain(
                           lambda: T.forward(params, batch, cfg)[0]))
            print(json.dumps(row), flush=True)
            rows.append(row)
            del params
    if args.out:
        Path(args.out).write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
