"""Serving launcher: the static engine on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --batch 4 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --reduced --device cpu --prompt-len 128 --gen 8

Weights are random, from ``--seed``. On the card the prefill attention is
the causal DASH forward kernel (``attention_impl="cuda"``), or with
``--attn-window N`` (the config's ``attn_window``) the block-sparse forward
over an N-token sliding window, which decode then honors too; with
``--device cpu`` it is the plain PyTorch attention. The prompt length must be
a multiple of 128, the kernel's square tile. ``--profile`` (card only)
then traces one prefill and one decode step with ``torch.profiler`` and
prints wall time, device-busy time and the kernels that take it. The
continuous engine comes with its own slice.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.kernels.flash_fwd import BLOCK
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Engine, SampleConfig


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile(label, fn):
    """Trace one call of ``fn`` on the card: wall ms (inflated by the
    profiler), device-busy ms (sum of kernel and copy times on the device),
    device ops launched, and the six ops that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    busy_ms = sum(a.self_device_time_total for a in ops) / 1e3
    print(f"[profile] {label}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}), "
          f"{sum(a.count for a in ops)} device ops")
    for a in sorted(ops, key=lambda a: -a.self_device_time_total)[:6]:
        print(f"[profile]   {a.self_device_time_total / 1e3:9.3f} ms "
              f"x{a.count:<5d} {a.key[:100]}")


@torch.inference_mode()
def profile_steps(cfg, params, prompt, max_seq):
    logits, caches = T.prefill_step(params, {"tokens": prompt}, cfg,
                                    max_seq=max_seq)     # warm-up
    _profile("prefill", lambda: T.prefill_step(params, {"tokens": prompt}, cfg,
                                               max_seq=max_seq))
    tok = torch.argmax(logits[:, -1], -1)[:, None]
    _profile("decode step", lambda: T.decode_step(params, caches, tok,
                                                  prompt.shape[1], cfg))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=512)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--profile", action="store_true",
                    help="trace one prefill and one decode step on the card")
    ap.add_argument("--attn-window", type=int, default=None, metavar="N",
                    help="sliding-window attention over the last N tokens "
                         "(the config's attn_window; 0: full causal)")
    args = ap.parse_args(argv)
    if args.prompt_len <= 0 or args.prompt_len % BLOCK:
        ap.error(f"--prompt-len must be a positive multiple of {BLOCK} (the "
                 f"attention kernel's square tile); got {args.prompt_len}")
    if args.gen < 1:
        ap.error("--gen must be >= 1")
    if args.attn_window is not None and args.attn_window < 0:
        ap.error("--attn-window must be >= 0")

    device = resolve_device(args.device)
    if args.profile and device.type != "cuda":
        ap.error("--profile traces the card")
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(attention_impl="cuda" if device.type == "cuda"
                      else "torch")
    if args.attn_window is not None:
        cfg = cfg.replace(attn_window=args.attn_window)
    params = T.init(cfg, seed=args.seed, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    prompt = torch.randint(1, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    engine = Engine(cfg, params, max_seq=args.prompt_len + args.gen,
                    scfg=SampleConfig(seed=args.seed))
    _sync(device)
    t0 = time.perf_counter()
    tokens = engine.generate({"tokens": prompt}, args.gen)
    _sync(device)
    dt = time.perf_counter() - t0
    print(f"{cfg.name} on {device} ({cfg.attention_impl} attention): "
          f"{args.batch}x{args.prompt_len} prompt + {args.gen} tokens in "
          f"{dt:.3f}s ({args.batch * args.gen / dt:.1f} tok/s incl. prefill)")
    print("sample tokens[0,:16]:", tokens[0, :16].tolist())
    if args.profile:
        profile_steps(cfg, params, prompt, args.prompt_len + args.gen)
    return tokens


if __name__ == "__main__":
    main()
