"""Training launcher: the train step on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --steps 3 --batch 4 --seq 1024 --verify
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
        --steps 2 --batch 2 --seq 128

Weights are random, from ``--seed``; data is the synthetic source
(``data.pipeline.SyntheticLM``, a pure function of (seed, step)). On the
card the attention runs the DASH kernels (``attention_impl="cuda"``: the
flash forward and the deterministic backward), built before the first step;
with ``--device cpu`` it is the plain PyTorch attention. bf16, AdamW, remat
on, causal. The steps run under ``torch.use_deterministic_algorithms`` (with
cuBLAS's fixed workspace), so two runs from one seed give the same state.
``--verify`` digests the whole state (params and optimizer moments) after
every step into a :class:`~repro_torch.verify.digest.DigestChain` and prints
its head; ``--profile-step N`` runs step N under ``torch.profiler`` and prints
its busy time and top ops. The last line is the reference's summary JSON,
plus each step's wall time. Checkpoints, ``--tune``, ``--track`` and
``--chaos`` are not ported yet.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.kernels import build
from repro_torch.kernels.flash_fwd import BLOCK
from repro_torch.train import optimizer as O
from repro_torch.train import step as S
from repro_torch.verify.digest import DigestChain


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def configure(argv=None):
    """Parse the flags and build what a run needs: (args, cfg, tcfg, data,
    device). :func:`main` runs exactly these, so a caller that checks the
    launcher's run against another path builds its inputs here."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup-steps", type=int,
                    default=O.OptConfig.warmup_steps)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--opt", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--verify", action="store_true",
                    help="record a per-step state digest chain and print "
                         "its head")
    ap.add_argument("--profile-step", type=int, default=None, metavar="N",
                    help="run step N (from 1) under torch.profiler")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be >= 1")

    device = resolve_device(args.device)
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = cfg.replace(attention_impl="cuda" if device.type == "cuda"
                      else "torch")
    if device.type == "cuda" and args.seq % BLOCK:
        ap.error(f"--seq must be a multiple of {BLOCK} (the attention "
                 f"kernels' square tile); got {args.seq}")

    tcfg = S.TrainConfig(
        opt=O.OptConfig(name=args.opt, lr=args.lr,
                        warmup_steps=args.warmup_steps,
                        total_steps=args.steps),
        microbatches=args.microbatches, remat=True, seed=args.seed)
    data = make_source(DataConfig(seed=args.seed, batch=args.batch,
                                  seq=args.seq, vocab=cfg.vocab), device)
    return args, cfg, tcfg, data, device


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else []))


def _profile_summary(prof, device):
    """A profiled step on ``device``'s timeline: busy ms, op count, and the
    ten ops that take the most time."""
    from torch.autograd import DeviceType
    on_card = device.type == "cuda"
    kind = DeviceType.CUDA if on_card else DeviceType.CPU
    ops = [a for a in prof.key_averages() if a.device_type == kind]
    own = (lambda a: a.self_device_time_total) if on_card else (
        lambda a: a.self_cpu_time_total)
    top = [dict(ms=own(a) / 1e3, calls=a.count, op=a.key[:90])
           for a in sorted(ops, key=lambda a: -own(a))[:10]]
    return dict(busy_ms=sum(own(a) for a in ops) / 1e3,
                ops=sum(a.count for a in ops), top_ops=top)


def main(argv=None, on_step=None):
    """Run the flags' training. ``on_step(step, state, metrics)``, if given,
    is called after each step, outside its timing. Returns the summary:
    the printed last line's keys, plus ``profile`` under ``--profile-step``."""
    # cuBLAS reads this when the process makes its first handle: set before
    # the first product on the card, it lets the GEMMs run deterministically
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    args, cfg, tcfg, data, device = configure(argv)
    if device.type == "cuda":
        t0 = time.perf_counter()
        build.build()
        print(f"[build] CUDA kernels ready in {time.perf_counter() - t0:.1f}s",
              flush=True)
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        state = S.init_state(cfg, tcfg, seed=args.seed, device=device)
        step_fn = S.make_train_step(cfg, tcfg)
        chain = DigestChain() if args.verify else None
        step_ms, profile = [], None
        for step in range(args.steps):
            batch = data.batch(step)
            profiling = step + 1 == args.profile_step
            # the profiler starts before and is read after the timed step
            with (_profiler(device) if profiling
                  else contextlib.nullcontext()) as prof:
                _sync(device)
                t0 = time.perf_counter()
                state, metrics = step_fn(state, batch)
                _sync(device)
                step_ms.append((time.perf_counter() - t0) * 1e3)
            if profiling:
                profile = _profile_summary(prof, device)
            if chain is not None:
                chain.append(step + 1, state)
            if on_step is not None:
                on_step(step + 1, state, metrics)
            if (step + 1) % args.log_every == 0 or step == 0:
                m = S.step_event(metrics)
                print(f"step {step + 1} loss={m['loss']:.4f} "
                      f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                      f"({step_ms[-1]:.1f} ms)", flush=True)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
    if profile is not None:
        print(f"[profile] step {args.profile_step}: " + json.dumps(profile),
              flush=True)
    summary = {"final_step": args.steps, "final_loss": float(metrics["loss"]),
               "step_ms": step_ms}
    if chain is not None:
        print(f"[verify] digest chain head {chain.head} ({len(chain)} "
              f"records)", flush=True)
        summary["digest_chain_head"] = chain.head
    print(json.dumps(summary))
    return dict(summary, profile=profile)


if __name__ == "__main__":
    main()
