"""Training launcher: the train step on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --steps 3 --batch 4 --seq 1024 --verify
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --batch 1 --seq 4096 --attn-window 1024 --steps 3 --verify
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
        --steps 2 --batch 2 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --arch dash-paper \
        --tune measure --batch 16 --seq 1024 --steps 3 --verify
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --batch 4 --seq 1024 --steps 3 --verify --tune sim \
        --track A.jsonl --trace-out A.json
    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --batch 4 --seq 1024 --steps 3 --verify --tune sim \
        --track B.jsonl --track-reference A.jsonl
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch phi3.5-moe-42b-a6.6b --layers 2 --batch 4 --seq 1024 \
        --steps 3 --warmup-steps 1 --log-every 1 --verify
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch llama4-scout-17b-a16e --reduced --device cpu --steps 2 \
        --batch 2 --seq 128 --verify
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch jamba-1.5-large-398b --layers 0,4 --batch 1 --seq 4096 \
        --steps 3 --warmup-steps 1 --log-every 1 --verify
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \
        --batch 4 --seq 1024 --steps 3 --warmup-steps 1 --verify

``--arch`` takes every ported arch (``configs/registry.py``), the
mixture-of-experts ones too (their aux loss enters the objective, weighted
by ``moe_aux_weight``, and is logged as ``aux``), and Jamba's hybrid of
Mamba, MoE and attention blocks (on the card its scan runs
``csrc/selective_scan.cu``), and ``xlstm-350m`` (on the card the mLSTM
parallel form and the sLSTM run ``csrc/mlstm.cu`` and ``csrc/slstm.cu``,
their backwards ``csrc/mlstm_parallel_bwd.cu`` and ``csrc/slstm_bwd.cu``;
on the CPU the plain mixers under autograd). ``--layers`` cuts the depth
and keeps the
widths: ``N`` (a multiple of the block pattern's length) keeps the first N
layers; a comma-separated list of positions in the pattern keeps one layer
of each of those kinds, in order (``0,4``: Jamba's first ``mamba`` and its
``attn`` layer).

Weights are random, from ``--seed``; data is the synthetic source
(``data.pipeline.SyntheticLM``, a pure function of (seed, step)) or, with
``--data FILE``, windows of a flat ``uint32`` token file (``MemmapCorpus``).
On the card the attention runs the DASH kernels (``attention_impl="cuda"``:
the flash forward and the deterministic backward), built before the first
step; with ``--device cpu`` it is the plain PyTorch attention. bf16, remat
on, causal; AdamW or ``--opt adafactor``; ``--grad-compression int8`` adds
int8 error-feedback compression. ``--attn-window N`` sets the config's
``attn_window`` (a causal N-token sliding window: on the card the
block-sparse forward and the masked DASH backward, on the CPU the plain
masked attention). The steps run under ``torch.use_deterministic_algorithms``
(with cuBLAS's fixed workspace), so two runs from one seed give the same
state.

Checkpoints (off unless ``--ckpt-dir`` is given): every ``--ckpt-every``
steps an async save (``ckpt.checkpoint``; the previous one is joined first,
the last one before the run ends; a failed save fails the run), the newest
``--ckpt-keep`` kept; ``--resume`` restores the latest durable checkpoint
and continues from its step; ``--die-at-step N`` kills the process with
``os._exit(17)`` at the top of step N (from 0), a save possibly in flight —
the fault-tolerance protocol of ``launch/failures.py``.

``--verify`` digests the whole state (params, optimizer state, error
feedback) after every step into a
:class:`~repro_torch.verify.digest.DigestChain` and prints its head, and
ships the live uint32 state fingerprint in each step's metrics
(``TrainConfig.digest_metrics``; on the card one launch of
``csrc/fingerprint.cu`` a step, inside the step's time); the chain is
written to ``--verify-out`` (default ``<ckpt-dir>/digest_chain.json``
with ``--ckpt-dir``) at every save and at the end, and a resumed run
continues it from the restored step, so its head equals a straight run's.
``--profile-step N`` runs step N under ``torch.profiler`` and prints its busy
time and top ops. ``--tune sim|measure`` resolves the attention's schedule
knobs with :func:`repro_torch.tune.tune_attention` once before training and
prints ``[tune] <candidate> source=... modeled_makespan=...
modeled_step(attn)=...``; as in the reference, the choice is logged, not
applied to ``cfg.dash_schedule``, and "measure" ranks as "sim" does unless
the tuner's cache holds a measured decision for the key. The last line is
the reference's summary JSON, plus each step's wall time and, on the card,
each step's kernel launches. ``--chaos SEED`` arms
``FaultPlan.seeded_ckpt`` against the checkpoint writes (the reference's
transient IO faults, each absorbed by the writer's bounded retry) and adds
``chaos_plan``, ``chaos_faults_landed`` and ``chaos_landing_digest`` to the
summary.

Observability (``repro_torch.obs``, the reference's wiring): ``--track
FILE`` writes the run's JSONL event stream — ``run_config``,
``tune_choice``/``tune_cache`` (with ``--tune``), a ``step`` event a step
(a ``StepMeter`` payload: tokens/s, step ms and, with ``--tune``,
``utilization_vs_modeled``, the modeled attention time of a step over the
step's measured time), with ``--verify`` a ``fingerprint`` event a step, a
``leaf_digests`` record a step (the same hashing pass that feeds the
chain) and ``fingerprint_ok`` in the summary, then ``cache_info`` and
``run_summary``; and the spans ``train_data``, ``train_step``,
``train_digest`` and ``train_ckpt``. ``--track-reference FILE`` (with
``--verify``) compares the live fingerprints with an earlier run's
``--track`` file and logs ``fingerprint_divergence`` at the first step that
differs. ``--trace-out FILE`` writes a Perfetto/Chrome trace: the spans plus
the attention schedule's modeled and achieved lanes
(``obs.export.attention_timeline``; on the card the achieved lane times the
port's CUDA backward kernel and fold). ``--heartbeat`` waits for
``launch/heartbeat.py`` (ROADMAP A10) and ``--mesh`` for the distributed
slice (A9): both raise.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import checkpoint as C
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, make_source
from repro_torch.faults import FaultPlan, Injector, armed_checkpoint
from repro_torch.kernels import build
from repro_torch.kernels.flash_fwd import BLOCK
from repro_torch.kernels.ops import launch_counts
from repro_torch.models import transformer as T
from repro_torch.obs import (CompositeTracker, DivergenceAlarm, MemoryTracker,
                             Profiler, StepMeter, open_tracker,
                             record_state_digests)
from repro_torch.train import optimizer as O
from repro_torch.train import step as S
from repro_torch.verify.digest import DigestChain


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cut_layers(cfg, spec: str):
    """``cfg`` cut in depth by ``--layers``: ``"N"`` keeps the first N
    layers (N a positive multiple of the pattern's length); ``"I,J,..."``
    keeps one layer at each of those positions of the pattern, in order,
    as a pattern of its own repeated once."""
    pattern = cfg.block_pattern
    if "," not in spec:
        n = int(spec)
        if n < 1 or n % len(pattern):
            raise ValueError(f"--layers must be a positive multiple of "
                             f"{len(pattern)}")
        return cfg.replace(n_layers=n)
    pos = [int(i) for i in spec.split(",")]
    if any(not 0 <= i < len(pattern) for i in pos):
        raise ValueError(f"--layers positions must lie in [0, "
                         f"{len(pattern)}): got {pos}")
    return cfg.replace(n_layers=len(pos),
                       block_pattern=tuple(pattern[i] for i in pos))


def configure(argv=None):
    """Parse the flags and build what a run needs: (args, cfg, tcfg, data,
    device). :func:`main` runs exactly these, so a caller that checks the
    launcher's run against another path builds its inputs here."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", default=None, metavar="N|I,J,...",
                    help="cut the model to N layers, or to the pattern's "
                         "layers at positions I, J, ... (depth only; the "
                         "widths stay the config's)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup-steps", type=int,
                    default=O.OptConfig.warmup_steps)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--opt", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--grad-compression", default=None, choices=["int8"])
    ap.add_argument("--data", default=None,
                    help="memmap uint32 token file (else synthetic)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--ckpt-keep", type=int, default=3, metavar="N",
                    help="keep the newest N checkpoints (the reference "
                         "keeps 3)")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint in --ckpt-dir")
    ap.add_argument("--die-at-step", type=int, default=None, metavar="N",
                    help="simulate a hard failure: os._exit(17) at the top "
                         "of step N")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--verify", action="store_true",
                    help="record a per-step state digest chain and print "
                         "its head")
    ap.add_argument("--verify-out", default=None,
                    help="write the digest-chain JSON here (default: "
                         "<ckpt-dir>/digest_chain.json with --ckpt-dir)")
    ap.add_argument("--profile-step", type=int, default=None, metavar="N",
                    help="run step N (from 1) under torch.profiler")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--attn-window", type=int, default=None, metavar="N",
                    help="sliding-window attention over the last N tokens "
                         "(the config's attn_window; 0: full causal)")
    ap.add_argument("--tune", default="off", choices=["off", "sim", "measure"],
                    help="resolve the attention schedule knobs with "
                         "repro_torch.tune before training and print the "
                         "choice: 'sim' ranks by modeled makespan; 'measure' "
                         "takes a measured decision from the tuner's cache "
                         "($REPRO_TORCH_TUNE_CACHE), else ranks as 'sim'")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="arm a seeded checkpoint-IO fault plan: saves at "
                         "random --ckpt-every multiples fail their first "
                         "1..IO_RETRIES write attempts, absorbed by the "
                         "writer's bounded retry (the state is unchanged)")
    ap.add_argument("--track", default=None, metavar="JSONL",
                    help="write the run's repro_torch.obs event stream here: "
                         "per-step throughput, utilization-vs-modeled, "
                         "fingerprint and divergence events (with --verify), "
                         "tuner decisions, spans")
    ap.add_argument("--track-reference", default=None, metavar="JSONL",
                    help="an earlier run's --track file; with --verify the "
                         "live fingerprints are compared against it and the "
                         "first mismatch logs a fingerprint_divergence event")
    ap.add_argument("--trace-out", default=None, metavar="TRACE.json",
                    help="write a Perfetto/Chrome trace of the run: the "
                         "per-step spans plus the attention schedule's "
                         "modeled and achieved lanes")
    ap.add_argument("--heartbeat", action="store_true",
                    help="not ported yet: raises NotImplementedError")
    ap.add_argument("--mesh", default=None,
                    help="not ported yet: raises NotImplementedError")
    args = ap.parse_args(argv)
    if args.heartbeat:
        raise NotImplementedError("--heartbeat (launch/heartbeat.py) waits "
                                  "for ROADMAP A10")
    if args.mesh is not None:
        raise NotImplementedError("--mesh (the distributed train step) waits "
                                  "for ROADMAP A9")
    if args.steps < 1:
        ap.error("--steps must be >= 1")
    if args.attn_window is not None and args.attn_window < 0:
        ap.error("--attn-window must be >= 0")
    if args.ckpt_every < 1 or args.ckpt_keep < 1:
        ap.error("--ckpt-every and --ckpt-keep must be >= 1")
    if args.resume and not args.ckpt_dir:
        ap.error("--resume needs --ckpt-dir")
    if args.track_reference and not args.verify:
        ap.error("--track-reference compares fingerprints: it needs --verify")

    device = resolve_device(args.device)
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers is not None:
        try:
            cfg = cut_layers(cfg, args.layers)
        except ValueError as e:
            ap.error(str(e))
    cfg = cfg.replace(attention_impl="cuda" if device.type == "cuda"
                      else "torch")
    if args.attn_window is not None:
        cfg = cfg.replace(attn_window=args.attn_window)
    if device.type == "cuda" and args.seq % BLOCK:
        ap.error(f"--seq must be a multiple of {BLOCK} (the attention "
                 f"kernels' square tile); got {args.seq}")

    tcfg = S.TrainConfig(
        opt=O.OptConfig(name=args.opt, lr=args.lr,
                        warmup_steps=args.warmup_steps,
                        total_steps=args.steps),
        microbatches=args.microbatches, remat=True,
        grad_compression=args.grad_compression, seed=args.seed,
        digest_metrics=args.verify)
    data = make_source(DataConfig(seed=args.seed, batch=args.batch,
                                  seq=args.seq, vocab=cfg.vocab,
                                  path=args.data), device)
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


def _chain_path(args):
    if args.verify_out:
        return args.verify_out
    return (os.path.join(args.ckpt_dir, "digest_chain.json") if args.ckpt_dir
            else None)


def _write_chain(path, chain):
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        f.write(chain.to_json())


def _join(pending, saves):
    """Wait for an async save; record and print its times."""
    if pending is None:
        return
    thread, info = pending
    t0 = time.perf_counter()
    thread.join()
    info.update(wait_s=time.perf_counter() - t0, **thread.stats)
    if "write_s" not in info:
        raise RuntimeError(f"the checkpoint of step {info['step']} failed "
                           f"(its writer's exception is printed above)")
    saves.append(info)
    print(f"[ckpt] step {info['step']}: snapshot {info['snapshot_s']:.2f}s, "
          f"written in {info['write_s']:.2f}s ({info['wait_s']:.2f}s "
          f"waited)", flush=True)


def _tune(args, cfg, tracker):
    """The reference's ``--tune``: resolve the causal attention geometry
    once and print the choice with its modeled makespan and the modeled
    attention time of a step (the makespan, a per-bh schedule, times every
    (layer, batch row, head)), which it returns for the utilization metric.
    Logged only: ``cfg.dash_schedule`` is left as it is."""
    from repro_torch.tune import tune_attention
    tres = tune_attention(seq=args.seq, head_dim=cfg.head_dim,
                          dtype=cfg.dtype_name, causal=True,
                          n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                          mode=args.tune, tracker=tracker)
    n_rep = cfg.n_layers // len(cfg.block_pattern)
    n_attn = n_rep * sum(1 for k in cfg.block_pattern if k.startswith("attn"))
    modeled_step_s = (tres.modeled_makespan_s * n_attn * args.batch
                      * cfg.n_heads) or None
    print(f"[tune] {tres.candidate.key()} source={tres.source} "
          f"modeled_makespan={tres.modeled_makespan_s:.3e}s "
          f"modeled_step(attn)={modeled_step_s or 0:.3e}s", flush=True)
    return modeled_step_s


def main(argv=None, on_step=None):
    """Run the flags' training. ``on_step(step, state, metrics)``, if given,
    is called after each step, outside its timing. Returns the summary:
    the printed last line's keys, plus ``profile`` under ``--profile-step``."""
    # cuBLAS reads this when the process makes its first handle: set before
    # the first product on the card, it lets the GEMMs run deterministically
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    args, cfg, tcfg, data, device = configure(argv)
    tracker = open_tracker(args.track)
    trace_mem = None
    if args.trace_out is not None:
        # --trace-out needs the span stream even without --track
        trace_mem = MemoryTracker()
        tracker = CompositeTracker([tracker, trace_mem])
    with tracker:
        return _run(args, cfg, tcfg, data, device, on_step, tracker,
                    trace_mem)


def _run(args, cfg, tcfg, data, device, on_step, tracker, trace_mem):
    run_id = f"train-{args.arch}-s{args.seed}"
    prof = Profiler(tracker, run_id=run_id)
    tracker.log("run_config", {
        "arch": args.arch, "steps": args.steps, "batch": args.batch,
        "seq": args.seq, "microbatches": args.microbatches, "run_id": run_id,
        "seed": args.seed, "tune": args.tune, "verify": bool(args.verify)})
    modeled_step_s = None
    if args.tune != "off":
        modeled_step_s = _tune(args, cfg, tracker)
    if device.type == "cuda":
        t0 = time.perf_counter()
        build.build()
        print(f"[build] CUDA kernels ready in {time.perf_counter() - t0:.1f}s",
              flush=True)
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        state = S.init_state(cfg, tcfg, seed=args.seed, device=device)
        start, restore_s = 0, None
        if args.resume:
            k = C.latest_step(args.ckpt_dir)
            if k is None:
                print(f"[ckpt] no checkpoint in {args.ckpt_dir}; starting "
                      f"from step 0", flush=True)
            else:
                t0 = time.perf_counter()
                state = C.restore(args.ckpt_dir, k, state)
                _sync(device)
                restore_s = time.perf_counter() - t0
                start = k
                print(f"resumed from step {start}", flush=True)
        step_fn = S.make_train_step(cfg, tcfg)
        chain_path = _chain_path(args)
        chain = alarm = None
        if args.verify:
            chain = DigestChain()
            if start and chain_path and os.path.exists(chain_path):
                # keep the records up to the restored step, so the resumed
                # run's head stays comparable to a straight run's
                with open(chain_path) as f:
                    prior = DigestChain.from_json(f.read())
                chain = DigestChain(
                    records=[(s, d) for s, d in prior.records if s <= start])
                print(f"[verify] resumed digest chain at step {start} "
                      f"({len(chain)} records)", flush=True)
            alarm = (DivergenceAlarm.from_jsonl(args.track_reference,
                                                tracker=tracker)
                     if args.track_reference
                     else DivergenceAlarm(tracker=tracker))
        step_ms, saves, profile, metrics, pending = [], [], None, None, None
        launches = []       # per step, on the card: each kernel's launches
        injector = None
        if args.chaos is not None:
            plan = FaultPlan.seeded_ckpt(args.chaos, steps=args.steps,
                                         every=args.ckpt_every, rate=0.5,
                                         max_failures=C.IO_RETRIES,
                                         name=f"train-chaos-{args.chaos}")
            injector = Injector(plan, tracker=tracker)
            print(f"[chaos] armed {plan.key()} ({len(plan)} flaky saves; all "
                  "within the writer's retry budget)", flush=True)
        meter = StepMeter(modeled_step_s=modeled_step_s)
        tracking = args.track is not None or args.trace_out is not None
        tokens_per_step = args.batch * args.seq
        # the hook stays armed through the last async save's join: the
        # writer thread consults it mid-write
        with armed_checkpoint(injector):
            for step in range(start, args.steps):
                if step == args.die_at_step:
                    print(f"simulated failure at step {step}", flush=True)
                    os._exit(17)
                scope = f"step:{step + 1}"
                with prof.span("train_data", scope=scope, lane="host",
                               step=step + 1):
                    batch = data.batch(step)
                profiling = step + 1 == args.profile_step
                # the profiler starts before and is read after the timed step
                with (_profiler(device) if profiling
                      else contextlib.nullcontext()) as torch_prof:
                    _sync(device)
                    before = launch_counts()
                    step_span = prof.begin("train_step", scope=scope,
                                           lane="device", step=step + 1)
                    t0 = time.perf_counter()
                    state, metrics = step_fn(state, batch)
                    _sync(device)
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    prof.end(step_span)
                    launches.append({k: v - before[k]
                                     for k, v in launch_counts().items()})
                if profiling:
                    profile = _profile_summary(torch_prof, device)
                if chain is not None:
                    with prof.span("train_digest", scope=scope, lane="host",
                                   step=step + 1):
                        # one hashing pass feeds the chain and the
                        # per-leaf record diff_runs triages with
                        record_state_digests(state, step + 1, tracker=tracker,
                                             chain=chain)
                if tracking:
                    # the step's own time (it ends in a sync), not the
                    # digest's: utilization is modeled attention over it
                    payload = meter.update(tokens_per_step,
                                           step_ms[-1] / 1e3)
                    payload.update(S.step_event(metrics))
                    tracker.log("step", payload, step=step + 1)
                if alarm is not None and alarm.observe(
                        step + 1, metrics["state_fingerprint"]):
                    print(f"[verify] fingerprint divergence at step "
                          f"{step + 1} (see tracker)", flush=True)
                if on_step is not None:
                    on_step(step + 1, state, metrics)
                if (step + 1) % args.log_every == 0 or step == start:
                    m = S.step_event(metrics)
                    print(f"step {step + 1} loss={m['loss']:.4f} "
                          f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                          f"({step_ms[-1]:.1f} ms)", flush=True)
                if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
                    with prof.span("train_ckpt", scope=scope, lane="host",
                                   step=step + 1):
                        _join(pending, saves)
                        t0 = time.perf_counter()
                        thread = C.save(args.ckpt_dir, step + 1, state,
                                        async_=True,
                                        keep_last=args.ckpt_keep)
                        pending = (thread, dict(
                            step=step + 1,
                            snapshot_s=time.perf_counter() - t0))
                        if chain is not None and chain_path:
                            _write_chain(chain_path, chain)  # survives a crash
            _join(pending, saves)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)
    if profile is not None:
        print(f"[profile] step {args.profile_step}: " + json.dumps(profile),
              flush=True)
    summary = {"final_step": args.steps,
               "final_loss": None if metrics is None
               else float(metrics["loss"]),
               "step_ms": step_ms}
    if device.type == "cuda":
        summary["launches"] = launches
    if args.ckpt_dir:
        summary.update(start_step=start, restore_s=restore_s, ckpt=saves)
    if injector is not None:
        summary["chaos_plan"] = injector.plan.key()
        summary["chaos_faults_landed"] = len(injector.history)
        summary["chaos_landing_digest"] = injector.history_digest()
        print(f"[chaos] {len(injector.history)} injected IO failures "
              f"absorbed by retry; landing digest "
              f"{injector.history_digest()[:16]}", flush=True)
    if chain is not None:
        if chain_path:
            _write_chain(chain_path, chain)
        print(f"[verify] digest chain head {chain.head} ({len(chain)} "
              f"records)" + (f" -> {chain_path}" if chain_path else ""),
              flush=True)
        summary["digest_chain_head"] = chain.head
    if alarm is not None:
        summary["fingerprint_ok"] = alarm.ok
    if tracking:
        from repro_torch.masks import cache_info
        tracker.log("cache_info", cache_info())
        tracker.log("run_summary", dict(
            summary, tokens_per_s_avg=meter.event().get("tokens_per_s_avg",
                                                        0.0)))
    if args.trace_out is not None:
        from repro_torch.obs import export as EX
        events = EX.spans_to_trace(trace_mem.events, process_name=run_id)
        if any(k.startswith("attn") for k in cfg.block_pattern):
            # the attention schedule's modeled and achieved lanes
            events += EX.attention_timeline(args.seq, cfg.head_dim,
                                            causal=True, measure=True,
                                            device=device)
        EX.write_trace(args.trace_out, events)
        print(f"[trace] {len(events)} events -> {args.trace_out}", flush=True)
    print(json.dumps(summary))
    return dict(summary, profile=profile)


if __name__ == "__main__":
    main()
