"""Serving launcher: the static engine or continuous batching over paged
KV, on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --batch 4 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --reduced --device cpu --prompt-len 128 --gen 8
    PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \
        --requests 8 --slots 4 --prompt-len 512 --gen 32
    PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \
        --reduced --device cpu --requests 8 --slots 4 --prompt-len 64 --gen 8
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch phi3.5-moe-42b-a6.6b --reduced --device cpu --prompt-len 128 \
        --gen 8
    PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \
        --arch nemotron-4-15b --reduced --device cpu --requests 8 --slots 4 \
        --prompt-len 64 --gen 8
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch jamba-1.5-large-398b --reduced --device cpu --prompt-len 128 \
        --gen 8
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m \
        --batch 4 --prompt-len 512 --gen 32

``--arch`` takes every ported arch (``configs/registry.py``). The
mixture-of-experts archs (``phi3.5-moe-42b-a6.6b``,
``llama4-scout-17b-a16e``), Jamba (``jamba-1.5-large-398b``) and xLSTM
(``xlstm-350m``) serve on the static engine only: with ``--engine
continuous`` they raise the paged engine's refusal before any weights are
made, as in the reference (capacity routing couples the rows of a batch;
SSM and xLSTM states are unpaged). On the card Jamba's scan runs
``csrc/selective_scan.cu``, and xLSTM's mixers ``csrc/mlstm.cu`` (the
recurrence) and ``csrc/slstm.cu``, in the prefill and in every decode step
(S = 1, the carried state).

Weights are random, from ``--seed``. On the card the prefill attention is
the causal DASH forward kernel (``attention_impl="cuda"``), or with
``--attn-window N`` (the config's ``attn_window``) the block-sparse forward
over an N-token sliding window, which decode then honors too; with
``--device cpu`` it is the plain PyTorch attention. The prompt length must be
a multiple of 128, the kernel's square tile. ``--profile`` (card only)
then traces one prefill and one decode step with ``torch.profiler`` and
prints wall time, device-busy time and the kernels that take it.

``--engine continuous`` runs :class:`repro_torch.serve.engine.
ContinuousEngine` (chunked prefill into paged KV pools, batched one-token
decode over the live slots, keyed per-request sampling): ``--requests``
prompts of lengths drawn from ``[--min-prompt-len, --prompt-len]`` (by
default the reference's ``[prompt_len // 2, prompt_len]``) with the
reference's numpy draws from ``--seed``, ``--gen`` greedy tokens each, over
``--slots`` slots, with the reference's 16-token pages and
``min(32, prompt_len)``-token prefill chunks. Every request's tokens are
bitwise the same whatever the co-batch, slot count, chunk or page
placement.

``--spec-k K`` drafts K tokens a round and verifies them with exact
acceptance (:mod:`repro_torch.serve.spec`): tokens and logprobs stay bitwise
those of ``--spec-k 0``. ``--draft-model self`` (the default) self-drafts,
``auto`` takes the registry's pairing (``registry.drafter_for``), any other
value names a drafter arch, whose weights are random from ``--seed + 1``.
``--chaos SEED`` arms a seeded fault plan (pool exhaustion, slot
revocation, decode stalls; ``FaultPlan.seeded(SEED, steps=16 * gen,
rate=0.2)``) against the engine; completed requests stay bitwise those of
the unarmed run. ``--track FILE`` writes the engine's ``repro_torch.obs``
event stream (``serve_*`` events and the request, queue, prefill, chunk,
decode and speculative-round spans) and ``--trace-out FILE`` a
Perfetto/Chrome trace of the spans beside the attention schedule's modeled
and achieved lanes at the slot capacity (on the card the achieved lane times
the port's CUDA backward kernel and fold); both apply to ``--engine
continuous``, and tokens are bitwise those of an untracked run. The
reference's ``--tp/--mesh`` (ROADMAP A9) raise until their item lands.

    PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \
        --reduced --device cpu --requests 6 --slots 3 --prompt-len 24 \
        --gen 8 --spec-k 2 --draft-model auto --chaos 5
    PYTHONPATH=src python -m repro_torch.launch.serve --engine continuous \
        --track S.jsonl --trace-out S.json
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.faults import FaultPlan, Injector
from repro_torch.kernels.flash_fwd import BLOCK
from repro_torch.models import transformer as T
from repro_torch.obs import CompositeTracker, MemoryTracker, open_tracker
from repro_torch.serve.engine import ContinuousEngine, Engine, SampleConfig

# the reference's continuous-engine flags this port does not cover yet
_UNPORTED_FLAGS = {
    "tp": "--tp (mesh-sharded serving) waits for ROADMAP A9",
    "mesh": "--mesh (mesh-sharded serving) waits for ROADMAP A9",
}


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


def continuous_prompts(vocab: int, requests: int, min_len: int,
                       max_len: int, seed: int):
    """The continuous run's prompts: ``requests`` lengths uniform in
    ``[min_len, max_len]`` and tokens in ``[1, vocab)``, drawn in turn from
    ``np.random.RandomState(seed)`` (the reference launcher's draws)."""
    rng = np.random.RandomState(seed)
    prompts = []
    for _ in range(requests):
        plen = rng.randint(min_len, max_len + 1)
        prompts.append(rng.randint(1, vocab, size=plen).tolist())
    return prompts


def _spec_kwargs(args, device):
    """``--spec-k``/``--draft-model`` → the engine's speculation kwargs."""
    if not args.spec_k:
        return {}
    kw = {"spec_k": args.spec_k}
    draft = args.draft_model
    if draft == "auto":
        draft = registry.drafter_for(args.arch) or "self"
    if draft != "self":
        dcfg = registry.get(draft)
        if args.reduced:
            dcfg = dcfg.reduced()
        kw["draft_cfg"] = dcfg
        kw["draft_params"] = T.init(dcfg, seed=args.seed + 1, device=device)
        print(f"drafter: {draft} (exact acceptance; tokens bitwise equal "
              "to --spec-k 0)")
    return kw


def _continuous(cfg, params, args, device):
    """The continuous engine over ``args.requests`` seeded prompts; prints
    the run's totals and each request's first tokens, returns the engine."""
    tracker = open_tracker(args.track)
    trace_mem = None
    if args.trace_out is not None:
        trace_mem = MemoryTracker()
        tracker = CompositeTracker([tracker, trace_mem])
    with tracker:
        return _serve(cfg, params, args, device, tracker, trace_mem)


def _serve(cfg, params, args, device, tracker, trace_mem):
    run_id = f"serve-{args.arch}-s{args.seed}"
    page = 16
    max_seq = args.max_seq or -(-(args.prompt_len + args.gen) // page) * page
    injector = None
    if args.chaos is not None:
        plan = FaultPlan.seeded(args.chaos, steps=16 * args.gen, rate=0.2,
                                name=f"serve-chaos-{args.chaos}")
        injector = Injector(plan)
        print(f"chaos armed: {plan.key()} ({len(plan)} scheduled faults; "
              "tokens stay bitwise identical)")
    eng = ContinuousEngine(cfg, params, n_slots=args.slots, max_seq=max_seq,
                           page_size=page,
                           prefill_chunk=min(32, args.prompt_len),
                           scfg=SampleConfig(seed=args.seed), faults=injector,
                           tracker=tracker, run_id=run_id,
                           **_spec_kwargs(args, device))
    lo = args.min_prompt_len or max(1, args.prompt_len // 2)
    prompts = continuous_prompts(cfg.vocab, args.requests, lo,
                                 args.prompt_len, args.seed)
    for i, prompt in enumerate(prompts):
        eng.submit(prompt, req_id=i, max_new_tokens=args.gen)
    _sync(device)
    out = eng.run()
    dt = eng.run_s
    total = sum(len(v) for v in out.values())
    print(f"continuous: {args.requests} requests / {args.slots} slots, "
          f"{total} tokens in {dt:.2f}s ({total / max(1e-9, dt):.1f} tok/s, "
          f"{eng.decode_steps} decode steps, {eng.engine_steps} engine steps)"
          f" on {device}")
    if eng.spec is not None:
        sp = eng.spec
        print(f"speculation: k={sp.k} "
              f"{'self-draft' if sp.self_draft else 'separate drafter'}, "
              f"{sp.rounds} rounds, acceptance {sp.acceptance_rate():.3f} "
              f"({sp.accepted}/{sp.drafted - sp.truncated} evaluated "
              "drafts)")
    if injector is not None:
        print(f"chaos: {len(injector.history)} faults landed, "
              f"{eng.preemptions} preemptions, landing digest "
              f"{injector.history_digest()[:16]}")
    if args.trace_out is not None:
        from repro_torch.obs import export as EX
        events = EX.spans_to_trace(trace_mem.events, process_name=run_id)
        events += EX.attention_timeline(max_seq, cfg.head_dim, causal=True,
                                        measure=True, device=device)
        EX.write_trace(args.trace_out, events)
        print(f"[trace] {len(events)} events -> {args.trace_out}", flush=True)
    for rid in sorted(out):
        print(f"request {rid} tokens:", out[rid][:16].tolist())
    return eng


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--engine", choices=("static", "continuous"),
                    default="static")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--min-prompt-len", type=int, default=None,
                    help="--engine continuous: the shortest prompt (default "
                         "prompt_len // 2)")
    ap.add_argument("--max-seq", type=int, default=None,
                    help="--engine continuous: slot capacity (default the "
                         "prompt + gen rounded up to a page)")
    ap.add_argument("--spec-k", type=int, default=0, metavar="K",
                    help="--engine continuous: speculative decoding, K "
                         "drafts a round with exact acceptance (tokens and "
                         "logprobs bitwise those of --spec-k 0)")
    ap.add_argument("--draft-model", default="self",
                    help='drafter for --spec-k: "self" (default), "auto" '
                         "(the registry's pairing) or an arch name")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="--engine continuous: arm a seeded fault plan (pool "
                         "exhaustion, slot revocation, decode stalls); "
                         "tokens are bitwise invariant to it")
    ap.add_argument("--track", default=None, metavar="JSONL",
                    help="--engine continuous: write the engine's event "
                         "stream (serve_* events and spans) here; tokens are "
                         "bitwise those of an untracked run")
    ap.add_argument("--trace-out", default=None, metavar="TRACE.json",
                    help="--engine continuous: write a Perfetto/Chrome trace "
                         "of the spans and the attention schedule's modeled "
                         "and achieved lanes")
    for flag, kind in (("--tp", int), ("--mesh", str)):
        ap.add_argument(flag, type=kind, default=None,
                        help="not ported yet: raises NotImplementedError")
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
    for name, why in _UNPORTED_FLAGS.items():
        if getattr(args, name) is not None:
            raise NotImplementedError(why)
    if args.gen < 1:
        ap.error("--gen must be >= 1")
    if args.chaos is not None and args.engine != "continuous":
        ap.error("--chaos applies to --engine continuous")
    if args.spec_k and args.engine != "continuous":
        ap.error("--spec-k applies to --engine continuous")
    if args.spec_k < 0:
        ap.error("--spec-k must be >= 0")
    if (args.track or args.trace_out) and args.engine != "continuous":
        ap.error("--track/--trace-out apply to --engine continuous")
    if args.engine == "continuous":
        if args.requests < 1 or args.slots < 1 or args.prompt_len < 1:
            ap.error("--requests, --slots and --prompt-len must be >= 1")
        if args.profile or args.attn_window is not None:
            ap.error("--profile and --attn-window apply to the static engine")
        cfg = registry.get(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        if not T.supports_paged(cfg):      # before the weights are made
            raise NotImplementedError(T.paged_refusal(cfg))
        device = resolve_device(args.device)
        params = T.init(cfg, seed=args.seed, device=device)
        return _continuous(cfg, params, args, device)
    if args.prompt_len <= 0 or args.prompt_len % BLOCK:
        ap.error(f"--prompt-len must be a positive multiple of {BLOCK} (the "
                 f"attention kernel's square tile); got {args.prompt_len}")
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
