"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. build   — compile every CUDA source of the port with nvcc, in parallel,
               and report the registers, spills and shared memory of each
               forward and backward kernel instantiation (``[ptxas]``
               lines); the library's shared memory per head dim must be the
               host's budget (``flash_fwd.fwd_smem_bytes``);
  2. device  — the card's name and power limit (nvidia-smi);
  3. kernels — hold each kernel against its plain PyTorch version on the
               card: the causal and full-mask forwards (with the edge cases
               one tile, seq_k != seq_q, GQA 32/8 at D=128, D=32); 20
               repetitions of each forward mode bitwise identical, and each
               sequence of a batch-4 causal launch equal bit for bit to the
               sequence launched alone; and for every
               backward schedule (fa3, descending, shift full; fa3,
               descending, symmetric_shift causal) the worker-parallel
               backward + ordered fold; the serialized backward must equal
               worker + fold bit for bit, and 20 repetitions of the worker
               backward must be bitwise identical. Then the block-sparse
               masks (sliding window, prefix-LM, documents, streaming,
               causal ∧ sink at S=1024; bf16 and fp32; GQA 32/32 and 32/8):
               the masked forward and both masked backwards against their
               plain versions, serialized ≡ worker + fold bit for bit, KV
               rows no task visits exactly 0, and 20 bitwise-identical
               repetitions of the window's worker backward;
  4. serve   — serve StableLM-1.6B at full width and depth in bf16 (random
               weights, seed 0) through the static engine: greedy, batch 4,
               prompt 512, 32 new tokens. Checks that the prefill launched the
               attention kernel once per layer, that tokens are in range and
               bitwise equal across two runs, and that the prefill logits match
               the plain attention's on the same weights;
  5. train   — train StableLM-1.6B at full width and depth (bf16, AdamW,
               remat, causal, B=4, S=1024, 3 steps, warmup 1) through the
               DASH kernels, twice from seed 0 under
               ``torch.use_deterministic_algorithms``: equal state digests
               after every step, weights that move, the launch counts remat
               predicts, step 1 against the plain attention's step, then one
               profiled step;
  6. train-resume — the train phase's flags (full width and depth) as two
               launcher subprocesses with a checkpoint after every step (in
               a temporary directory on tmpfs, the newest one kept): run
               B killed with ``os._exit(17)`` at the top of step 2 (step 2's
               async save possibly in flight), run C ``--resume``d from the
               latest durable checkpoint; run C's digest chain head must
               equal the train phase's first run's, it must resume from step
               1 or 2, and each of its steps must launch 48 causal forwards,
               24 worker backwards and 24 folds. Prints the checkpoint's
               bytes, save and restore seconds, the directory's filesystem
               and free bytes;
  7. lifecycle — every cell of ``verify.lifecycle`` (base, mb4, int8, remat
               "dots", gqa, bf16opt, plus adafactor and packed documents) at
               full width cut to 2 layers, B=2 (mb4: 4), S=1024, 4 steps,
               crash at 2, on the DASH kernels: straight ≡ crash/resume bit
               for bit, with the launches each cell predicts;
  8. ops     — ``dash_attention`` forward and backward at the training
               shape, full mask (schedule ``shift``) and serialized, against
               the plain op, counting the kernels each path launches; and a
               1024-token sliding window at the windowed training shape
               (B=1, H=32, S=4096, D=64; worker-parallel and serialized)
               against the plain query-chunked masked op, which must differ
               from the causal op beyond the window;
  9. slice-window — the serving slice with ``attn_window=1024``: batch 2,
               prompt 2048, 32 new tokens; the prefill must launch the
               block-sparse forward once per layer;
 10. train-window — the train phase again with ``--attn-window 1024`` at
               B=1, S=4096 (the launcher's flags): 48 block-sparse forwards,
               24 masked worker backwards and 24 folds a step, no causal
               forward, step 1 and every layer's attention grads against the
               plain masked, query-chunked attention's step, then one
               profiled step;
 11. timing  — each kernel at its training slice's attention shape beside
               its plain version, the PyTorch library call for the same
               function where there is one (for a mask, SDPA with the dense
               boolean mask; for the fold, ``torch.sum`` over the partials
               with the unvisited tiles zeroed), and its bound.
The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script exits
non-zero and prints no result; so does a machine without CUDA.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# cuBLAS reads this when the card's first handle is made: set it before
# torch touches the card, so the train phase's GEMMs are deterministic
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.ckpt import checkpoint as CK  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.schedules import cached_schedule  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_bwd as FB  # noqa: E402
from repro_torch.kernels import flash_fwd as FF  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch import masks as M  # noqa: E402
from repro_torch.models.module import count_params, set_path, tree_paths  # noqa: E402,E501
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.verify import lifecycle as LC  # noqa: E402

# H100 SXM, NVIDIA's data sheet (dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# |out - plain| <= tol + tol * |plain| (the reference's kernel tolerances)
OUT_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
LSE_RTOL = 1e-3                                         # |Δlse| / max(|lse|, 1)
# prefill logits (fp32 head over bf16 activations), cuda vs plain attention:
# the two round the attention output to bf16 from differently ordered fp32
# sums, and one-ulp differences grow through 24 layers
LOGITS_ATOL = 0.1

# the reference's grad tolerances (tests/test_kernels.py:59)
GRAD_TOL = {torch.bfloat16: dict(atol=0.1, rtol=5e-2),
            torch.float32: dict(atol=2e-5, rtol=2e-5)}
# train step 1, DASH kernels vs the plain attention on the same weights and
# batch (bf16 activations, 24 layers): the two round the attention output to
# bf16 from differently ordered fp32 sums, and one-ulp differences grow
# through the layers. Measured on an H100 80GB HBM3 at 700 W: loss rel. diff
# 2.2e-5, grad-norm rel. diff 3.1e-4; each limit is ten times its reading.
# The loss is the forward's check; the grad norm over 1.6e9 grads is
# dominated by the LM head and embedding, so the backward kernels are held
# per layer too: |g_cuda - g_plain| / |g_plain| of each layer's wq (through
# dQ), wk (dK), wv (dV) and wo. A wrong or swapped dQ/dK/dV reads ~1 there.
LOSS_RTOL = 2e-4
GNORM_RTOL = 3e-3
ATTN_GRAD_RTOL = 5e-2
ATTN_LEAVES = tuple(f"blocks/b0_attn/attn/{w}" for w in ("wq", "wk", "wv",
                                                         "wo"))

# (name, batch, heads, kv heads, seq, head_dim, dtype)
KERNEL_CASES = [
    ("slice", 4, 32, 32, 512, 64, torch.bfloat16),
    ("gqa", 1, 32, 8, 1024, 128, torch.bfloat16),
    ("fp32", 2, 8, 8, 384, 64, torch.float32),
    ("reduced", 2, 4, 4, 256, 32, torch.bfloat16),
]
# the training slice's attention shape first
TRAIN_CASES = [("train", 4, 32, 32, 1024, 64, torch.bfloat16)] + KERNEL_CASES[1:]
# forward edge cases (the last field, where present, is seq_k; full mask
# only): one 128-row tile, seq_k != seq_q, GQA 32/8 at D=128 with two
# batches, D=32
FWD_EDGE_CASES = [
    ("one_tile", 2, 8, 8, 128, 64, torch.bfloat16),
    ("gqa_d128", 2, 32, 8, 512, 128, torch.bfloat16),
    ("d32", 2, 8, 8, 512, 32, torch.bfloat16),
]
FULL_EDGE_CASES = FWD_EDGE_CASES + [
    ("seq_k_1024", 2, 8, 8, 512, 64, torch.bfloat16, 1024)]
BWD_SCHEDULES = [("fa3", False), ("descending", False), ("shift", False),
                 ("fa3", True), ("descending", True), ("symmetric_shift", True)]
SLICE = dict(arch="stablelm-1.6b", batch=4, prompt=512, gen=32, window=0)
SLICE_WINDOW = dict(arch="stablelm-1.6b", batch=2, prompt=2048, gen=32,
                    window=1024)
# the train launcher's flags for the train phase (3 steps, warmup 1 so the
# weights move), and for the windowed one
TRAIN_ARGV = ["--arch", "stablelm-1.6b", "--batch", "4", "--seq", "1024",
              "--steps", "3", "--warmup-steps", "1", "--seed", "0",
              "--log-every", "1", "--verify"]
TRAIN_WINDOW_ARGV = ["--arch", "stablelm-1.6b", "--batch", "1", "--seq",
                     "4096", "--attn-window", "1024", "--steps", "3",
                     "--warmup-steps", "1", "--seed", "0", "--log-every", "1",
                     "--verify"]
# [train-resume]: TRAIN_ARGV killed with os._exit(17) at the top of step 2
# (from 0) after a checkpoint at every step (the newest kept), then resumed;
# each run a subprocess of the launcher with up to this many seconds
RESUME_DIE_AT = 2
RESUME_TIMEOUT_S = 600
# checkpoints go to RAM (tmpfs): a full-width checkpoint is ~20 GB, and the
# chip machine's disk takes ~45 GB of writes in one call, freed blocks
# included
CKPT_ROOT = "/dev/shm"
# [lifecycle]: the lifecycle cells at full width, cut to 2 layers, B=2
# (mb4: B=4, so each of its 4 microbatches holds a row), S=1024, 4 steps,
# crash at 2, on the DASH kernels
LIFECYCLE = dict(reduced=False, steps=4, batch=2, seq=1024)
LIFECYCLE_OVERRIDES = (("n_layers", 2), ("attention_impl", "cuda"))
LIFECYCLE_CRASH_AT = 2
# the windowed training slice's attention shape (B, H, Hk, S, D, dtype) and
# mask
WINDOW_CASE = ("train_window", 1, 32, 32, 4096, 64, torch.bfloat16)
WINDOW = M.SlidingWindow(1024)
# the mask families of the kernel checks: the reference's
# (tests/test_mask_kernels.py:43-48) scaled from S=256 to S=1024, and
# causal ∧ sink, which leaves KV rows with no task
MASK_S = 1024
MASK_CASES = [
    ("window", M.SlidingWindow(384)),
    ("prefix", M.PrefixLM(320)),
    ("document", M.Document.from_lengths((400, 624))),
    ("streaming", M.streaming_mask(256, 64)),
    ("sink", M.Causal() & M.Sink(64)),
]


def _qkv(b, h, hk, s, d, dtype, seed=0, sk=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b * h, s, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b * hk, sk or s, d), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    return q, k, v


def _ptxas_entries(ptxas, classify):
    """Per kernel instantiation in nvcc's ``-Xptxas -v`` log that
    ``classify(mangled name)`` names (a dict, else None): registers and
    spilled bytes added to that dict."""
    out, kernel = [], None
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            kernel = classify(line.split("'")[1])
            if kernel is not None:
                out.append(kernel)
        elif kernel is not None and "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill", line)
            kernel.update(spill_store_bytes=int(stores),
                          spill_load_bytes=int(loads))
        elif kernel is not None and "Used" in line and "registers" in line:
            kernel["registers"] = int(re.search(r"Used (\d+) registers",
                                                line).group(1))
    return out


def bwd_resources(ptxas):
    """Per backward kernel instantiation of ``csrc/flash_bwd.cu`` (each runs
    the task body ``play`` of its dtype): registers and spilled bytes, with
    the dynamic shared memory it launches with."""
    def classify(name):
        kind = next((k for k in ("worker_bwd", "serial_bwd") if k in name),
                    None)
        head_dim = re.search(r"ILi(\d+)E", name)
        if not (kind and head_dim):
            return None
        dtype = torch.bfloat16 if "bfloat16" in name else torch.float32
        d = int(head_dim.group(1))
        return dict(kernel=kind, head_dim=d, dtype=str(dtype).split(".")[-1],
                    smem_bytes=FB.smem_bytes(d, dtype))
    return _ptxas_entries(ptxas, classify)


FWD_MODES = {0: "full", 1: "causal", 2: "block_sparse"}


def fwd_resources(ptxas):
    """Per forward kernel instantiation of ``csrc/flash_fwd.cu`` (``fwd_bf16``
    and ``fwd_f32`` per head dim and mode): registers and spilled bytes,
    with the dynamic shared memory it launches with (bf16: the K/V ring of
    ``fwd_stages`` stages)."""
    def classify(name):
        found = re.search(r"fwd_(bf16|f32)ILi(\d+)ELi(\d)E", name)
        if found is None:
            return None
        bf16, d = found.group(1) == "bf16", int(found.group(2))
        kernel = dict(kernel="fwd_" + found.group(1), head_dim=d,
                      mode=FWD_MODES[int(found.group(3))],
                      dtype="bfloat16" if bf16 else "float32",
                      smem_bytes=FF.kernel_smem_bytes(
                          d, torch.bfloat16 if bf16 else torch.float32))
        if bf16:
            kernel["stages"] = FF.fwd_stages(d)
        return kernel
    return _ptxas_entries(ptxas, classify)


def phase_build():
    t0 = time.perf_counter()
    built = build.build()
    for name, info in built.items():
        print(f"[build] {name}: {info['path'].relative_to(ROOT)} "
              f"({info['seconds']:.1f}s)")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] {time.perf_counter() - t0:.1f}s in all", flush=True)
    # the slices launch the bf16, D = 64 instantiations
    kernels = (fwd_resources(built["flash_fwd"]["ptxas"])
               + bwd_resources(built["flash_bwd"]["ptxas"]))
    for k in kernels:
        k["launched_by_slices"] = (k["dtype"], k["head_dim"]) == (
            "bfloat16", 64)
        print("[ptxas] " + json.dumps(k), flush=True)
    budget = {d: (FF.kernel_smem_bytes(d, torch.bfloat16),
                  FF.fwd_smem_bytes(d, FF.fwd_stages(d)))
              for d in FF.HEAD_DIMS}
    if any(lib != host or lib > FF.SMEM_MAX for lib, host in budget.values()):
        raise AssertionError(f"bf16 forward shared memory, library vs host "
                             f"budget: {budget}")


def phase_device():
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    print(line, flush=True)
    return line


def check_forward(causal, cases):
    """Each case: the causal or full-mask forward kernel vs its plain
    version on the same inputs on the card."""
    results, failed = [], []
    for name, b, h, hk, s, d, dtype, *sk in cases:
        q, k, v = _qkv(b, h, hk, s, d, dtype, seed=int(not causal),
                       sk=sk[0] if sk else None)
        scale = d ** -0.5
        out, lse = FF.flash_fwd_cuda(q, k, v, scale, h, hk, causal)
        ref_out, ref_lse = FF.flash_fwd_plain(q, k, v, scale, h, hk, causal)
        torch.cuda.synchronize()
        err_out = (out.float() - ref_out.float()).abs().max().item()
        err_lse = ((lse - ref_lse).abs()
                   / ref_lse.abs().clamp_min(1.0)).max().item()
        tol = OUT_TOL[dtype]
        ok = (bool(torch.isfinite(out).all()) and err_lse <= LSE_RTOL
              and torch.allclose(out.float(), ref_out.float(), atol=tol,
                                 rtol=tol))
        results.append(dict(case=name, shape=[b, h, hk, s, d] + sk,
                            dtype=str(dtype).split(".")[-1],
                            max_abs_err_out=err_out, max_rel_err_lse=err_lse,
                            tol_out=OUT_TOL[dtype], tol_lse=LSE_RTOL, ok=ok))
        if not ok:
            failed.append(name)
    kind = "causal" if causal else "full-mask"
    print(f"[kernel-check] {kind} forward " + json.dumps(results), flush=True)
    if failed:
        raise AssertionError(f"{kind} forward disagrees with its plain "
                             f"version in cases {failed}")
    return results


def check_forward_bits():
    """20 repetitions of each forward mode (causal and full at the training
    slice's shape, block-sparse at the windowed one's) give out and lse
    identical bit for bit to the first launch; and each sequence of a
    batch-4 causal launch at the serving slice's shape equals, bit for bit,
    the same sequence launched alone (a tile's arithmetic does not depend on
    its batch neighbours: the serving contract)."""
    name, b, h, hk, s, d, dtype = TRAIN_CASES[0]
    q, k, v = _qkv(b, h, hk, s, d, dtype, seed=7)
    _, wb, wh, whk, ws, wd, wdtype = WINDOW_CASE
    wq, wk, wv = _qkv(wb, wh, whk, ws, wd, wdtype, seed=8)
    runs = dict(
        causal=lambda: FF.flash_fwd_cuda(q, k, v, d ** -0.5, h, hk, True),
        full=lambda: FF.flash_fwd_cuda(q, k, v, d ** -0.5, h, hk, False),
        block_sparse=lambda: FF.flash_fwd_mask_cuda(wq, wk, wv, wd ** -0.5,
                                                    wh, whk, WINDOW))
    reps = {}
    for mode, run in runs.items():
        out, lse = run()
        same = True
        for _ in range(20):
            again = run()
            same &= torch.equal(again[0], out) and torch.equal(again[1], lse)
        reps[mode] = bool(same)
    name, b, h, hk, s, d, dtype = KERNEL_CASES[0]
    q, k, v = _qkv(b, h, hk, s, d, dtype, seed=9)
    out, lse = FF.flash_fwd_cuda(q, k, v, d ** -0.5, h, hk, True)
    alone = []
    for i in range(b):
        one, one_lse = FF.flash_fwd_cuda(
            q[i * h:(i + 1) * h].contiguous(),
            k[i * hk:(i + 1) * hk].contiguous(),
            v[i * hk:(i + 1) * hk].contiguous(), d ** -0.5, h, hk, True)
        alone.append(torch.equal(one, out[i * h:(i + 1) * h])
                     and torch.equal(one_lse, lse[i * h:(i + 1) * h]))
    torch.cuda.synchronize()
    result = dict(reps20_bitwise=reps, batch_invariant=alone,
                  batch_shape=[b, h, hk, s, d])
    print("[kernel-check] forward bits " + json.dumps(result), flush=True)
    if not (all(reps.values()) and all(alone)):
        raise AssertionError(f"forward kernels are not bitwise reproducible "
                             f"or batch invariant: {result}")
    return result


_counts = ops.launch_counts


def _zero_counts():
    FF.launches = FF.launches_full = FF.launches_mask = 0
    FB.launches_worker = FB.launches_serial = FB.launches_fold = 0


def _bwd_operands(b, h, hk, s, d, dtype, causal, seed, mask=None):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((b * h, s, d), generator=gen, device="cuda")
             .to(dtype) for _ in range(2))
    k, v = (torch.randn((b * hk, s, d), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    if mask is None:
        out, lse = FF.flash_fwd_cuda(q, k, v, d ** -0.5, h, hk, causal=causal)
    else:
        out, lse = FF.flash_fwd_mask_cuda(q, k, v, d ** -0.5, h, hk, mask)
    delta = torch.sum(do.float() * out.float(), dim=-1)
    return q, k, v, do, out, lse, delta


def check_backward():
    """Per case and schedule: worker kernel + fold vs the plain worker
    backward + plain fold, and the serialized kernel vs the plain serialized
    backward, at the reference's grad tolerances; the serialized kernel ≡
    worker + fold bit for bit; the fold kernel ≡ the plain fold bit for bit
    on the same partials; 20 repetitions of the worker backward bitwise
    identical on each case's default schedule."""
    results, failed = [], []
    for name, b, h, hk, s, d, dtype in TRAIN_CASES:
        n = s // FB.BLOCK
        for sched, causal in BWD_SCHEDULES:
            q, k, v, do, out, lse, delta = _bwd_operands(
                b, h, hk, s, d, dtype, causal, seed=len(sched) + causal)
            schedule = cached_schedule(sched, n, n_heads=1, causal=causal)
            wc = schedule.worker_chains()
            scale = d ** -0.5
            part, dk, dv = FB.worker_bwd_cuda(q, k, v, do, lse, delta,
                                              schedule, scale, causal, h, hk)
            visited = torch.from_numpy(wc["visited"]).cuda()
            dq = FB.fold_cuda(part, visited, FB.BLOCK)
            sdq, sdk, sdv = FB.serial_bwd_cuda(q, k, v, do, lse, delta,
                                               schedule, scale, causal, h, hk)
            ppart, pdk, pdv = FB.worker_bwd_plain(
                q, k, v, do, lse, delta, wc, scale, causal, FB.BLOCK,
                FB.BLOCK, h, hk)
            pdq = FB.fold_plain(ppart, visited, FB.BLOCK)
            kv_ids, q_ids = schedule.prefetch_arrays()
            pser = FB.serial_bwd_plain(
                q, k, v, do, lse, delta, kv_ids, q_ids,
                FB.first_visit_flags(kv_ids, q_ids), scale, causal, FB.BLOCK,
                FB.BLOCK, h, hk)
            # the fold alone, on the kernel's own partials
            fold_ref = FB.fold_plain(part, visited, FB.BLOCK)
            fold_same = torch.equal(dq, fold_ref)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(x, y) for x, y in
                          ((dq, sdq), (dk, sdk), (dv, sdv)))
            # each kernel's own error against its plain version: the worker
            # kernel's partials on the tiles a worker visits (the rest is
            # never written), the serialized kernel's dq/dk/dv, the fold's
            # output on the same partials
            seen = visited.repeat_interleave(FB.BLOCK, 1).bool()[None, :, :,
                                                                 None]
            err = dict(
                worker=dict(dq_part=(part - ppart).abs().where(
                    seen, 0.0).max().item(),
                    dk=(dk - pdk).abs().max().item(),
                    dv=(dv - pdv).abs().max().item()),
                serial=dict(zip(("dq", "dk", "dv"), (
                    (x - y).abs().max().item()
                    for x, y in zip((sdq, sdk, sdv), pser)))),
                fold=(dq - fold_ref).abs().max().item())
            pairs = ((dq, pdq), (dk, pdk), (dv, pdv)) + tuple(
                zip((sdq, sdk, sdv), pser))
            close = all(torch.allclose(x, y, **GRAD_TOL[dtype])
                        for x, y in pairs)
            finite = all(bool(torch.isfinite(x).all()) for x in (dq, dk, dv))
            reps_equal = None
            if sched in ("shift", "symmetric_shift"):
                reps_equal = True
                for _ in range(20):
                    again = FB.worker_bwd_cuda(q, k, v, do, lse, delta,
                                               schedule, scale, causal, h, hk)
                    again_dq = FB.fold_cuda(again[0], visited, FB.BLOCK)
                    reps_equal &= (torch.equal(again_dq, dq)
                                   and torch.equal(again[1], dk)
                                   and torch.equal(again[2], dv))
            ok = (bitwise and close and finite and fold_same
                  and reps_equal is not False)
            results.append(dict(case=name, schedule=sched, causal=causal,
                                dtype=str(dtype).split(".")[-1],
                                max_abs_err=err,
                                serial_bitwise_eq_worker_fold=bitwise,
                                fold_bitwise_eq_plain=fold_same,
                                reps20_bitwise=reps_equal, ok=ok))
            if not ok:
                failed.append(f"{name}/{sched}/causal={causal}")
    print("[kernel-check] backward " + json.dumps(results), flush=True)
    _print_kernel_errors("backward", results)
    if failed:
        raise AssertionError(f"backward kernels failed their checks in "
                             f"{failed}")
    return results


def _print_kernel_errors(label, results):
    """Each backward kernel's largest |kernel - plain| over the checks, per
    dtype (bf16: the tensor-core products; fp32: the CUDA-core body)."""
    worst = {}
    for r in results:
        for kernel in ("worker", "serial"):
            key = f"{kernel}/{r['dtype']}"
            worst[key] = max(worst.get(key, 0.0),
                             max(r["max_abs_err"][kernel].values()))
    print(f"[kernel-check] {label} max |kernel - plain| " + json.dumps(worst),
          flush=True)


def check_masks():
    """Per mask family, dtype and GQA group at S=1024, D=64: the block-sparse
    forward kernel vs its plain version; the masked worker kernel + fold and
    the masked serialized kernel vs their plain versions (on the KV rows
    some task visits: the kernels leave the others unwritten); serialized ≡
    worker + fold bit for bit; the host ``flash_bwd`` under deterministic
    algorithms (which fill fresh memory with NaN) gives exact zeros on the
    unvisited KV rows; 20 repetitions of the window's worker backward are
    bitwise identical."""
    results, failed = [], []
    b, h, s, d = 1, 32, MASK_S, 64
    n = s // FB.BLOCK
    scale = d ** -0.5
    for name, mask in MASK_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            for hk in (32, 8):
                q, k, v = _qkv(b, h, hk, s, d, dtype, seed=len(name) + hk)
                out, lse = FF.flash_fwd_mask_cuda(q, k, v, scale, h, hk, mask)
                ref_out, ref_lse = FF.flash_fwd_plain(q, k, v, scale, h, hk,
                                                      mask=mask)
                torch.cuda.synchronize()
                err_out = (out.float() - ref_out.float()).abs().max().item()
                err_lse = ((lse - ref_lse).abs()
                           / ref_lse.abs().clamp_min(1.0)).max().item()
                tol = OUT_TOL[dtype]
                fwd_ok = (bool(torch.isfinite(out).all())
                          and err_lse <= LSE_RTOL
                          and torch.allclose(out.float(), ref_out.float(),
                                             atol=tol, rtol=tol))

                q, k, v, do, out, lse, delta = _bwd_operands(
                    b, h, hk, s, d, dtype, False, seed=len(name), mask=mask)
                schedule = cached_schedule("shift", n, mask=mask)
                wc = schedule.worker_chains()
                visited = torch.from_numpy(wc["visited"]).cuda()
                args = (q, k, v, do, lse, delta)
                part, dk, dv = FB.worker_bwd_cuda(*args, schedule, scale,
                                                  False, h, hk, mask)
                dq = FB.fold_cuda(part, visited, FB.BLOCK)
                sdq, sdk, sdv = FB.serial_bwd_cuda(*args, schedule, scale,
                                                   False, h, hk, mask)
                ppart, pdk, pdv = FB.worker_bwd_plain(
                    *args, wc, scale, False, FB.BLOCK, FB.BLOCK, h, hk, mask)
                pdq = FB.fold_plain(ppart, visited, FB.BLOCK)
                kv_ids, q_ids = schedule.prefetch_arrays()
                pser = FB.serial_bwd_plain(
                    *args, kv_ids, q_ids, FB.first_visit_flags(kv_ids, q_ids),
                    scale, False, FB.BLOCK, FB.BLOCK, h, hk, mask)
                live = FB._live_rows(schedule, FB.BLOCK, q.device)[None]
                n_dead = s - int(live.sum())
                seen = visited.repeat_interleave(FB.BLOCK, 1).bool()[
                    None, :, :, None]

                def on_live(x):
                    return x.where(live, 0.0)

                bitwise = (torch.equal(dq, sdq)
                           and torch.equal(on_live(dk), on_live(sdk))
                           and torch.equal(on_live(dv), on_live(sdv)))
                err = dict(
                    fwd=err_out,
                    worker=dict(dq_part=(part - ppart).abs().where(
                        seen, 0.0).max().item(),
                        dk=on_live((dk - pdk).abs()).max().item(),
                        dv=on_live((dv - pdv).abs()).max().item()),
                    serial=dict(
                        dq=(sdq - pser[0]).abs().max().item(),
                        dk=on_live((sdk - pser[1]).abs()).max().item(),
                        dv=on_live((sdv - pser[2]).abs()).max().item()))
                pairs = ((dq, pdq), (on_live(dk), pdk), (on_live(dv), pdv),
                         (sdq, pser[0]), (on_live(sdk), pser[1]),
                         (on_live(sdv), pser[2]))
                close = all(torch.allclose(x, y, **GRAD_TOL[dtype])
                            for x, y in pairs)
                # the host path: dead rows zeroed, before the GQA fold
                torch.use_deterministic_algorithms(True)
                try:
                    hdq, hdk, hdv = FB.flash_bwd(q, k, v, out, lse, do,
                                                 schedule, n_heads=h,
                                                 n_kv_heads=hk, mask=mask)
                finally:
                    torch.use_deterministic_algorithms(False)
                host_ok = all(bool(torch.isfinite(x).all())
                              and bool((x.where(~live, 0.0) == 0).all())
                              for x in (hdk, hdv)) and bool(
                                  torch.isfinite(hdq).all())
                reps_equal = None
                if name == "window" and dtype == torch.bfloat16:
                    reps_equal = True
                    for _ in range(20):
                        again = FB.worker_bwd_cuda(*args, schedule, scale,
                                                   False, h, hk, mask)
                        again_dq = FB.fold_cuda(again[0], visited, FB.BLOCK)
                        reps_equal &= (torch.equal(again_dq, dq)
                                       and torch.equal(on_live(again[1]),
                                                       on_live(dk))
                                       and torch.equal(on_live(again[2]),
                                                       on_live(dv)))
                torch.cuda.synchronize()
                ok = (fwd_ok and bitwise and close and host_ok
                      and reps_equal is not False)
                results.append(dict(
                    mask=name, key=mask.key(), dtype=str(dtype).split(".")[-1],
                    heads=[h, hk], tasks=int(wc["valid"].sum()),
                    partial_tiles=len(schedule.partial_cells),
                    dead_kv_rows=n_dead, max_abs_err=err,
                    max_rel_err_lse=err_lse,
                    serial_bitwise_eq_worker_fold=bitwise,
                    host_dead_rows_zero=host_ok, reps20_bitwise=reps_equal,
                    ok=ok))
                if not ok:
                    failed.append(f"{name}/{dtype}/hk={hk}")
    print("[kernel-check] mask " + json.dumps(results), flush=True)
    _print_kernel_errors("masked backward", results)
    if failed:
        raise AssertionError(f"block-sparse mask kernels failed their checks "
                             f"in {failed}")
    return results


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@torch.inference_mode()
def run_slice(slice_=SLICE, label="slice"):
    """The static engine at full width and depth: greedy, twice (bitwise
    equal tokens), the prefill's attention launches (the causal forward, or
    the block-sparse one under a window, once per layer), prefill logits vs
    the plain attention's, prefill ms and decode tok/s."""
    cfg = registry.get(slice_["arch"]).replace(attention_impl="cuda",
                                               attn_window=slice_["window"])
    b, s, n = slice_["batch"], slice_["prompt"], slice_["gen"]
    params = T.init(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(1, cfg.vocab, (b, s), generator=gen, device="cuda")
    batch = {"tokens": prompt}
    engine = Engine(cfg, params, max_seq=s + n)

    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    tokens, t_run = _timed(lambda: engine.generate(batch, n))
    counts = _counts()
    kind = "fwd_mask" if cfg.attn_window else "fwd_causal"
    launches = counts[kind]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != cfg.n_layers or sum(counts.values()) != launches:
        raise AssertionError(f"prefill launched {counts}, expected "
                             f"{cfg.n_layers} of {kind} and nothing else")
    if tokens.shape != (b, n) or not bool(
            ((tokens >= 0) & (tokens < cfg.padded_vocab)).all()):
        raise AssertionError(f"tokens out of range or misshapen: "
                             f"{tuple(tokens.shape)}")
    again = engine.generate(batch, n)
    if not torch.equal(tokens, again):
        raise AssertionError("two greedy runs gave different tokens")

    # prefill and decode times, outside the counted run
    (logits, caches), t_prefill = _timed(
        lambda: T.prefill_step(params, batch, cfg, max_seq=s + n))

    def decode_all():
        tok = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
        for i in range(1, n):
            out, _ = T.decode_step(params, caches, tok, s + i - 1, cfg)
            tok = torch.argmax(out[:, -1], -1)[:, None].to(torch.int32)
        return tok
    _, t_decode = _timed(decode_all)

    plain_cfg = cfg.replace(attention_impl="torch")
    plain_logits, _ = T.prefill_step(params, batch, plain_cfg, max_seq=s)
    err = (logits - plain_logits).abs().max().item()
    finite = bool(torch.isfinite(logits).all())
    same_argmax = (logits.argmax(-1) == plain_logits.argmax(-1)).float().mean()
    result = dict(
        arch=cfg.name, params=count_params(params), batch=b, prompt=s,
        new_tokens=n, attn_window=cfg.attn_window, attention_launches=launches,
        run_s=t_run, prefill_ms=t_prefill * 1e3,
        decode_tok_per_s=b * (n - 1) / t_decode, peak_mem_gb=peak_gb,
        tokens_bitwise_equal=True, logits_max_abs_err_vs_plain=err,
        logits_atol=LOGITS_ATOL, max_abs_logit=plain_logits.abs().max().item(),
        argmax_agreement=same_argmax.item(), tokens_row0=tokens[0, :8].tolist())
    print(f"[{label}] " + json.dumps(result), flush=True)
    if not finite or err > LOGITS_ATOL:
        raise AssertionError(f"prefill logits: finite={finite}, max |cuda - "
                             f"plain| = {err} > {LOGITS_ATOL}")
    return result


def _attn_grads(cfg, params, batch):
    """Step 1's loss grads of every layer's attention projections (the
    stacked wq, wk, wv, wo), as the train step takes them: remat on. dQ
    reaches wq, dK wk, dV wv; wo sees the attention output."""
    paths = [p for p, _ in tree_paths(params)]
    leaves = [x.detach().requires_grad_(p in ATTN_LEAVES)
              for p, x in zip(paths, O.tree_leaves(params))]
    tree = {}
    for path, leaf in zip(paths, leaves):
        set_path(tree, path, leaf)
    loss, _ = T.loss_fn(tree, batch, cfg, remat=True)
    wanted = [(p, x) for p, x in zip(paths, leaves) if x.requires_grad]
    grads = torch.autograd.grad(loss, [x for _, x in wanted])
    return {p: g for (p, _), g in zip(wanted, grads)}


def run_train(argv=TRAIN_ARGV, label="train"):
    """StableLM-1.6B at full width and depth, 3 AdamW steps through the train
    launcher (``repro_torch.launch.train.main``, the DASH kernels) with the
    flags ``argv``, twice from seed 0; the launcher's step 1 against the
    plain attention's on the same weights and batch (with a window: the
    plain masked, query-chunked attention); step 3 of the second run under
    the profiler."""
    args, cfg, tcfg, data, device = launch_train.configure(argv)
    fwd = "fwd_mask" if cfg.attn_window else "fwd_causal"
    want = dict(fwd_causal=0, fwd_full=0, fwd_mask=0,
                bwd_worker=cfg.n_layers, bwd_serial=0, fold=cfg.n_layers)
    want[fwd] = 2 * cfg.n_layers
    batch0 = data.batch(0)

    # step 1 on the plain attention, and the attention grads both ways
    torch.use_deterministic_algorithms(True)
    try:
        state = TS.init_state(cfg, tcfg, seed=args.seed, device=device)
        plain_cfg = cfg.replace(attention_impl="torch")
        plain_m = TS.make_train_step(plain_cfg, tcfg)(state, batch0)[1]
        plain_m = {k: float(plain_m[k]) for k in ("loss", "grad_norm")}
        ga = _attn_grads(cfg, state["params"], batch0)
        gp = _attn_grads(plain_cfg, state["params"], batch0)
        torch.cuda.synchronize()
        del state
    finally:
        torch.use_deterministic_algorithms(False)
    # per leaf, the largest over layers of |g_cuda - g_plain| / |g_plain|
    attn_err = {}
    for path in ATTN_LEAVES:
        a, p = ga[path].float(), gp[path].float()
        attn_err[path.split("/")[-1]] = max(
            (torch.linalg.vector_norm(x - y) / torch.linalg.vector_norm(y))
            .item() for x, y in zip(a, p))
    del ga, gp

    runs = []
    for run in range(2):
        counts, metrics1, changed = [], {}, []

        def on_step(step, state, metrics):
            counts.append(_counts())
            _zero_counts()
            if step == 1:
                metrics1.update(loss=float(metrics["loss"]),
                                grad_norm=float(metrics["grad_norm"]))
            if step == args.steps and run == 0:   # against the seed's init
                initial = T.init(cfg, seed=args.seed, device=device)
                changed.append(sum(int((x != y).sum()) for x, y in zip(
                    O.tree_leaves(state["params"]), O.tree_leaves(initial))))

        run_argv = argv + (["--profile-step", str(args.steps)] if run
                           else [])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        summary = launch_train.main(run_argv, on_step=on_step)
        runs.append(dict(summary, launches=counts, step1=metrics1,
                         peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                         params_changed=changed[0] if changed else None))
    a, b_ = runs
    for i, c in enumerate(a["launches"] + b_["launches"]):
        if c != want:
            raise AssertionError(f"train step {i % args.steps + 1} launched "
                                 f"{c}, expected {want}")
    # the second run's last step ran under the profiler
    steady = statistics.median(a["step_ms"][1:] + b_["step_ms"][1:-1])
    prof = b_["profile"]
    first = dict(a["step1"], plain_loss=plain_m["loss"],
                 plain_grad_norm=plain_m["grad_norm"])
    rel_loss = abs(first["loss"] - first["plain_loss"]) / abs(
        first["plain_loss"])
    rel_gn = abs(first["grad_norm"] - first["plain_grad_norm"]) / abs(
        first["plain_grad_norm"])
    result = dict(
        arch=cfg.name, batch=args.batch, seq=args.seq, steps=args.steps,
        attn_window=cfg.attn_window,
        entry="repro_torch.launch.train.main " + " ".join(argv),
        # a hash chain over every step's state digest: equal heads mean
        # equal params and moments after every step
        digest_chain_heads=[a["digest_chain_head"], b_["digest_chain_head"]],
        digests_equal=a["digest_chain_head"] == b_["digest_chain_head"],
        final_losses=[a["final_loss"], b_["final_loss"]],
        params_changed=a["params_changed"],
        launches_per_step=a["launches"][0], step_ms=a["step_ms"],
        step_ms_run2=b_["step_ms"], steady_step_ms=steady,
        tokens_per_s=args.batch * args.seq / (steady / 1e3),
        peak_mem_gb=a["peak_gb"], step1_vs_plain=first,
        loss_rel_diff=rel_loss, loss_rtol=LOSS_RTOL, gnorm_rel_diff=rel_gn,
        gnorm_rtol=GNORM_RTOL, attn_grad_rel_err=attn_err,
        attn_grad_rtol=ATTN_GRAD_RTOL)
    print(f"[{label}] " + json.dumps(result), flush=True)
    print(f"[{label}-profile] " + json.dumps(dict(
        step=args.steps, wall_ms_traced=b_["step_ms"][-1],
        device_busy_ms=prof["busy_ms"],
        device_busy_share_of_steady_step=prof["busy_ms"] / steady,
        device_ops=prof["ops"], top_device_ops=prof["top_ops"])), flush=True)
    if not result["digests_equal"]:
        raise AssertionError("two training runs from seed 0 gave different "
                             "state digests")
    if not result["params_changed"]:
        raise AssertionError("three training steps changed no parameter")
    if not all(x == x and abs(x) < 1e4 for x in result["final_losses"]):
        raise AssertionError(f"non-finite losses {result['final_losses']}")
    if rel_loss > LOSS_RTOL or rel_gn > GNORM_RTOL:
        raise AssertionError(f"train step 1 vs the plain attention: loss "
                             f"rel. diff {rel_loss} (tol {LOSS_RTOL}), grad "
                             f"norm rel. diff {rel_gn} (tol {GNORM_RTOL})")
    if max(attn_err.values()) > ATTN_GRAD_RTOL:
        raise AssertionError(f"attention grads vs the plain attention: "
                             f"{attn_err} > {ATTN_GRAD_RTOL}")
    return result


def _free_device_memory():
    """Drop this process's cached device memory before a subprocess takes
    the card."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 1e9


def _filesystem(path):
    """(mount point, type) of the filesystem holding ``path``."""
    path, best = os.path.realpath(path), ("?", "?")
    with open("/proc/mounts") as f:
        for line in f:
            _, mount, fstype = line.split()[:3]
            if (path == mount or path.startswith(mount.rstrip("/") + "/")) \
                    and len(mount) >= len(best[0]):
                best = (mount, fstype)
    return best


def _mem_available_gb():
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) / 1e6
    return None


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _, files in os.walk(path) for f in files)


def _launcher(argv, timeout=RESUME_TIMEOUT_S):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                       + argv, env=env, cwd=ROOT, capture_output=True,
                       text=True, timeout=timeout)
    return r, time.perf_counter() - t0


def run_train_resume(straight, label="train-resume"):
    """StableLM-1.6B at full width and depth with ``TRAIN_ARGV``'s flags, as
    two launcher subprocesses: run B saves a checkpoint after every step and
    is killed with ``os._exit(17)`` at the top of step ``RESUME_DIE_AT``
    (step 2's async save possibly in flight); run C resumes from the latest
    durable checkpoint. Run C's digest chain head must equal ``straight``'s
    (the first run of ``[train]``, in this process), and each of its steps
    must launch what ``[train]``'s did."""
    args, cfg, *_ = launch_train.configure(TRAIN_ARGV)
    want = dict(fwd_causal=2 * cfg.n_layers, fwd_full=0, fwd_mask=0,
                bwd_worker=cfg.n_layers, bwd_serial=0, fold=cfg.n_layers)
    reserved_gb = _free_device_memory()
    with tempfile.TemporaryDirectory(prefix="repro_torch_ckpt_",
                                     dir=CKPT_ROOT) as d:
        mount, fstype = _filesystem(d)
        free_before = shutil.disk_usage(d).free
        host_gb = _mem_available_gb()
        flags = TRAIN_ARGV + ["--ckpt-dir", d, "--ckpt-every", "1",
                              "--ckpt-keep", "1",
                              "--verify-out", os.path.join(d, "chain.json")]
        b, b_s = _launcher(flags + ["--die-at-step", str(RESUME_DIE_AT)])
        if b.returncode != 17:
            raise AssertionError(f"run B exited {b.returncode}, not 17:\n"
                                 f"{b.stdout[-4000:]}\n{b.stderr[-4000:]}")
        after_b = sorted(os.listdir(d))
        durable = CK.available_steps(d)
        ckpt_bytes = {s: _dir_bytes(os.path.join(d, f"step_{s}"))
                      for s in durable}
        b_saves = [dict(step=int(m[1]), snapshot_s=float(m[2]),
                        write_s=float(m[3]), wait_s=float(m[4]))
                   for m in re.finditer(r"\[ckpt\] step (\d+): snapshot "
                                        r"([\d.]+)s, written in ([\d.]+)s "
                                        r"\(([\d.]+)s waited\)", b.stdout)]
        c, c_s = _launcher(flags + ["--resume"])
        if c.returncode != 0:
            raise AssertionError(f"run C exited {c.returncode}:\n"
                                 f"{c.stdout[-4000:]}\n{c.stderr[-4000:]}")
        resumed = re.search(r"^resumed from step (\d+)$", c.stdout, re.M)
        summary = json.loads(c.stdout.strip().splitlines()[-1])
    k = int(resumed[1]) if resumed else None
    result = dict(
        arch=cfg.name, batch=args.batch, seq=args.seq, steps=args.steps,
        entry="python -m repro_torch.launch.train " + " ".join(TRAIN_ARGV)
        + " --ckpt-dir D --ckpt-every 1 --ckpt-keep 1 --verify-out "
        "D/chain.json, "
        f"--die-at-step {RESUME_DIE_AT}, then --resume",
        ckpt_dir_filesystem=dict(mount=mount, type=fstype),
        free_bytes_before=free_before, host_mem_available_gb=host_gb,
        parent_reserved_gb=reserved_gb,
        run_b=dict(exit=b.returncode, seconds=b_s, dir_after=after_b,
                   durable_steps=durable, saves=b_saves),
        checkpoint_bytes=ckpt_bytes, resumed_from=k,
        restore_s=summary.get("restore_s"), run_c_saves=summary.get("ckpt"),
        run_c=dict(exit=c.returncode, seconds=c_s,
                   step_ms=summary["step_ms"],
                   final_loss=summary["final_loss"]),
        launches_per_step=summary.get("launches"),
        digest_chain_head=summary.get("digest_chain_head"),
        straight_head=straight, heads_equal=summary.get(
            "digest_chain_head") == straight)
    print(f"[{label}] " + json.dumps(result), flush=True)
    if k is None or not 1 <= k <= RESUME_DIE_AT or summary["start_step"] != k:
        raise AssertionError(f"run C resumed from {k} (summary "
                             f"{summary.get('start_step')}); expected a "
                             f"durable step in 1..{RESUME_DIE_AT}")
    if not result["heads_equal"]:
        raise AssertionError("the resumed run's digest chain head differs "
                             "from the straight run's")
    if [l for l in summary["launches"] if l != want] or \
            len(summary["launches"]) != args.steps - k:
        raise AssertionError(f"run C's steps launched {summary['launches']},"
                             f" expected {want} for each of "
                             f"{args.steps - k} steps")
    return result


def _lifecycle_config(name):
    """The cell's config at full width, 2 layers, on the DASH kernels."""
    base = LC.cell_config(name)
    kw = dict(LIFECYCLE, overrides=base.overrides + LIFECYCLE_OVERRIDES)
    if base.microbatches > LIFECYCLE["batch"]:
        kw["batch"] = base.microbatches
    return dataclasses.replace(base, **kw)


def _lifecycle_launches(lc, cfg):
    """What a cell's runs launch: straight and resume both take ``steps``
    steps; a step runs each layer's forward once per microbatch (twice
    under remat) and its backward and folds once; packed batches take the
    plain segment-masked attention."""
    if lc.packed:
        return dict.fromkeys(("fwd_causal", "fwd_full", "fwd_mask",
                              "bwd_worker", "bwd_serial", "fold"), 0)
    per = 2 * lc.steps * lc.microbatches * cfg.n_layers
    # a GQA backward folds dK and dV over each group besides the dQ partials
    folds = 3 if cfg.n_kv_heads < cfg.n_heads else 1
    return dict(fwd_causal=per * (2 if lc.remat else 1), fwd_full=0,
                fwd_mask=0, bwd_worker=per, bwd_serial=0, fold=folds * per)


def run_lifecycle(label="lifecycle"):
    """Every lifecycle cell (the reference's matrix, plus Adafactor and
    packed documents) through straight ≡ crash/resume on the card."""
    reports = []
    for name in list(LC.MATRIX) + list(LC.EXTRA):
        lc = _lifecycle_config(name)
        cfg = lc.model_config()
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        rep = LC.run_cell(name, crash_at=LIFECYCLE_CRASH_AT, device="cuda",
                          lc=lc, tmp_root=CKPT_ROOT)
        torch.cuda.synchronize()
        counts = _counts()
        want = _lifecycle_launches(lc, cfg)
        line = dict(cell=name, heads=rep["heads"],
                    conformant=rep["conformant"],
                    first_divergence=rep["first_divergence"],
                    layers=cfg.n_layers, d_model=cfg.d_model,
                    n_kv_heads=cfg.n_kv_heads, batch=lc.batch, seq=lc.seq,
                    steps=lc.steps, crash_at=LIFECYCLE_CRASH_AT,
                    launches=counts, launches_expected=want,
                    seconds=time.perf_counter() - t0)
        print(f"[{label}] " + json.dumps(line), flush=True)
        reports.append(line)
        if counts != want:
            raise AssertionError(f"lifecycle cell {name} launched {counts}, "
                                 f"expected {want}")
    bad = [r["cell"] for r in reports if not r["conformant"]]
    if bad:
        raise AssertionError(f"lifecycle cells not conformant: {bad}")
    _free_device_memory()
    return reports


def _op_path(q, k, v, do, dtype, kw, ref_kw):
    """One ``dash_attention`` path forward + backward, its launches counted
    from zero, against ``torch_attention(**ref_kw)`` on the same inputs."""
    x = [t.clone().requires_grad_(True) for t in (q, k, v)]
    torch.cuda.synchronize()
    _zero_counts()
    out = ops.dash_attention(*x, **kw)
    grads = torch.autograd.grad(out, x, do)
    torch.cuda.synchronize()
    counts = _counts()
    y = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = ops.torch_attention(*y, **ref_kw)
    ref_grads = torch.autograd.grad(ref, y, do)
    err = [(g.float() - r.float()).abs().max().item()
           for g, r in zip((out,) + grads, (ref,) + ref_grads)]
    ok = (torch.allclose(out.float(), ref.float(), atol=OUT_TOL[dtype],
                         rtol=OUT_TOL[dtype])
          and all(torch.allclose(g.float(), r.float(), **GRAD_TOL[dtype])
                  for g, r in zip(grads, ref_grads)))
    return out.detach(), dict(launches=counts, max_abs_err=dict(
        zip(("out", "dq", "dk", "dv"), err)), ok=ok)


def run_ops():
    """``dash_attention`` forward + backward at the training shape, through
    its default path (causal, worker-parallel + fold) and its two others,
    and at the windowed training shape with the 1024-token window
    (worker-parallel + fold, and serialized), against the plain op at the
    reference's grad tolerances (the window's: masked and query-chunked);
    each path's launches are counted from zero. The window's output must
    also differ from the causal op's beyond the window."""
    name, b, h, hk, s, d, dtype = TRAIN_CASES[0]
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    results = {}
    for label, kw in (("causal_default", dict(causal=True)),
                      ("full_shift", dict(causal=False, schedule="shift")),
                      ("causal_serialized", dict(causal=True,
                                                 worker_parallel=False))):
        _, results[label] = _op_path(q, k, v, do, dtype, kw,
                                     dict(causal=kw["causal"]))
    name, b, h, hk, s, d, dtype = WINDOW_CASE
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    ref_kw = dict(mask=WINDOW, chunk_q=1024)
    out, results["window_default"] = _op_path(q, k, v, do, dtype,
                                              dict(mask=WINDOW), ref_kw)
    _, results["window_serialized"] = _op_path(
        q, k, v, do, dtype, dict(mask=WINDOW, worker_parallel=False), ref_kw)
    with torch.no_grad():
        causal = ops.dash_attention(q, k, v, causal=True)
    beyond = WINDOW.window
    gap = (causal[:, :, beyond:].float() - out[:, :, beyond:].float()).abs()
    results["window_default"]["max_abs_diff_vs_causal_beyond_window"] = (
        gap.max().item())
    window_dropped = gap.max().item() <= OUT_TOL[dtype]
    print("[ops] " + json.dumps(results), flush=True)
    if not all(r["ok"] for r in results.values()):
        raise AssertionError(f"dash_attention disagrees with the plain op: "
                             f"{results}")
    if window_dropped:
        raise AssertionError("the windowed op equals the causal op beyond "
                             "the window: the window was dropped")
    none = dict(fwd_causal=0, fwd_full=0, fwd_mask=0, bwd_worker=0,
                bwd_serial=0, fold=0)
    want = dict(
        causal_default=dict(none, fwd_causal=1, bwd_worker=1, fold=1),
        full_shift=dict(none, fwd_full=1, bwd_worker=1, fold=1),
        causal_serialized=dict(none, fwd_causal=1, bwd_serial=1),
        window_default=dict(none, fwd_mask=1, bwd_worker=1, fold=1),
        window_serialized=dict(none, fwd_mask=1, bwd_serial=1))
    if any(results[k]["launches"] != w for k, w in want.items()):
        raise AssertionError(f"unexpected launches: {results}")
    return results


def _ms(fn, reps, rounds=5, warmup=3):
    """Median over rounds of the mean time of `reps` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def _queued_ms(fn, reps=50, rounds=5):
    """Like ``_ms``, but the calls are enqueued behind a ~25 ms spin kernel,
    so they run back to back on the card whatever the host's cost a call
    (30-50 µs for the forward's wrapper, more than a kernel of 20 µs)."""
    fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(rounds):
        torch.cuda._sleep(50_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / reps)
    return statistics.median(samples)


def _bound(moved_bytes, flops, dtype):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    operations over the dtype's peak rate."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bound_fwd(q, k, v, causal, block=FF.BLOCK, mask=None):
    """Least time for the forward on these inputs: q, k, v read once, out
    and lse written once, against the live tiles' products (QK^T and PV, 2
    flops per multiply-add; under a mask, the tiles of its grid) at the peak
    rate of the dtype."""
    bh, s, d = q.shape
    sk = k.shape[1]
    moved = (q.numel() + k.numel() + v.numel() + q.numel()) * q.element_size()
    moved += bh * s * 4
    if mask is not None:
        n_tiles = len(FF.mask_grid(mask, s // block, s // block, block,
                                   block)[0])
    elif causal:
        n_tiles = len(FF.causal_grid(s // block, s // block, block, block)[0])
    else:
        n_tiles = (s // block) * (sk // block)
    return _bound(moved, bh * n_tiles * 4 * block * block * d, q.dtype)


def bound_bwd(q, k, schedule, worker, block=FB.BLOCK):
    """Least time for the backward on these inputs: q, k, v, do read once
    (q's dtype), lse and delta read once (fp32), dK/dV written once (fp32)
    and dQ written once — as the visited tiles of the worker partials for
    the worker kernel, as one fp32 array for the serialized one — against
    the live tasks' five products (10·block²·D flops each)."""
    bh, s, d = q.shape
    wc = schedule.worker_chains()
    n_tasks = int(wc["valid"].sum())
    moved = (2 * q.numel() + 2 * k.numel()) * q.element_size() + 2 * bh * s * 4
    moved += 2 * bh * s * d * 4
    if worker:
        moved += bh * int(wc["visited"].sum()) * block * d * 4
    else:
        moved += bh * s * d * 4
    return _bound(moved, bh * n_tasks * 10 * block * block * d, q.dtype)


def bound_fold(part, visited, block=FB.BLOCK):
    """Least time for the fold: the visited partial tiles read once, the
    output written once; one fp32 add per element beyond the first."""
    n, r, s, d = part.shape
    tiles = int(visited.sum())
    moved = n * (tiles + s // block) * block * d * 4
    return _bound(moved, n * (tiles - s // block) * block * d, torch.float32)


def _entry(name, source, replaces, launches, path, err, ms, plain_ms, bound,
           library_ms, tasks=None):
    """One kernel's entry of the ``{"kernels": ...}`` line. The worker
    backward also reports its tasks (over all bh) and the time a task holds
    an SM (ms · SMs / tasks), which compares schedules and masks."""
    t = dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=launches, launch_path=path, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
             library_ms=library_ms)
    per_task = ""
    if tasks is not None:
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        t.update(tasks=tasks, us_per_task_per_sm=ms * 1e3 * sms / tasks)
        per_task = (f", {tasks} tasks, {t['us_per_task_per_sm']:.1f} us a "
                    f"task per SM")
    print(f"[timing] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {'-' if library_ms is None else f'{library_ms:.4f}'} ms, "
          f"bound {bound[0]:.4f} ms ({bound[1]}), {bound[0] / ms:.1%} of "
          f"bound{per_task}", flush=True)
    return t


@torch.inference_mode()
def time_forward(fwd_check, full_check, launches):
    """Both forwards at the training slice's attention shape; the causal one
    also at the serving slice's. Beside ``_ms``, the kernel's and SDPA's
    ``_queued_ms``."""
    entries = []
    for causal in (True, False):
        name, b, h, hk, s, d, dtype = TRAIN_CASES[0]
        q, k, v = _qkv(b, h, hk, s, d, dtype)
        scale = d ** -0.5

        def kernel():
            return FF.flash_fwd_cuda(q, k, v, scale, h, hk, causal)
        q4, k4, v4 = (x.view(b, -1, s, d) for x in (q, k, v))

        def library():
            return F.scaled_dot_product_attention(q4, k4, v4,
                                                  is_causal=causal,
                                                  scale=scale)
        ms = _ms(kernel, reps=50)
        plain_ms = _ms(lambda: FF.flash_fwd_plain(q, k, v, scale, h, hk,
                                                  causal), reps=5)
        library_ms = _ms(library, reps=50)
        queued = dict(queued_ms=_queued_ms(kernel),
                      library_queued_ms=_queued_ms(library))
        print(f"[timing] {'causal' if causal else 'full-mask'} forward, "
              f"calls queued: kernel {queued['queued_ms']:.4f} ms, library "
              f"{queued['library_queued_ms']:.4f} ms", flush=True)
        if causal:
            err = next(c for c in fwd_check if c["case"] == "train")
            entries.append(_entry(
                "flash_fwd_causal", "src/repro_torch/kernels/csrc/flash_fwd.cu",
                "src/repro/kernels/flash_fwd.py:177", launches["fwd_causal"],
                "train step (remat: 2 per layer)", err["max_abs_err_out"], ms,
                plain_ms, bound_fwd(q, k, v, True), library_ms))
            entries[-1].update(queued)
        else:
            err = next(c for c in full_check if c["case"] == "train")
            entries.append(_entry(
                "flash_fwd_full", "src/repro_torch/kernels/csrc/flash_fwd.cu",
                "src/repro/kernels/flash_fwd.py:157", launches["fwd_full"],
                "dash_attention(causal=False, schedule='shift') fwd + bwd",
                err["max_abs_err_out"], ms, plain_ms,
                bound_fwd(q, k, v, False), library_ms))
            entries[-1].update(queued)
    name, b, h, hk, s, d, dtype = KERNEL_CASES[0]
    q, k, v = _qkv(b, h, hk, s, d, dtype)
    q4, k4, v4 = (x.view(b, -1, s, d) for x in (q, k, v))

    def kernel():
        return FF.flash_fwd_cuda(q, k, v, d ** -0.5, h, hk)

    def library():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                              scale=d ** -0.5)
    serving = dict(serving_shape_ms=_ms(kernel, reps=50),
                   serving_shape_library_ms=_ms(library, reps=50),
                   serving_shape_queued_ms=_queued_ms(kernel),
                   serving_shape_library_queued_ms=_queued_ms(library),
                   serving_shape_bound_ms=bound_fwd(q, k, v, True)[0])
    print(f"[timing] flash_fwd_causal at the serving slice's shape B={b} "
          f"H={h} S={s} D={d}: " + json.dumps(serving), flush=True)
    entries[0].update(serving)
    return entries


def time_backward(bwd_check, launches):
    """The worker backward, the serialized backward and the fold at the
    training slice's attention shape, on its default causal schedule."""
    name, b, h, hk, s, d, dtype = TRAIN_CASES[0]
    q, k, v, do, out, lse, delta = _bwd_operands(b, h, hk, s, d, dtype, True,
                                                 seed=2)
    scale = d ** -0.5
    schedule = cached_schedule("symmetric_shift", s // FB.BLOCK, n_heads=1,
                               causal=True)
    wc = schedule.worker_chains()
    visited = torch.from_numpy(wc["visited"]).cuda()
    args = (q, k, v, do, lse, delta)
    worker_ms = _ms(lambda: FB.worker_bwd_cuda(*args, schedule, scale, True,
                                               h, hk), reps=10)
    serial_ms = _ms(lambda: FB.serial_bwd_cuda(*args, schedule, scale, True,
                                               h, hk), reps=3)
    part = FB.worker_bwd_cuda(*args, schedule, scale, True, h, hk)[0]
    fold_ms = _ms(lambda: FB.fold_cuda(part, visited, FB.BLOCK), reps=50)
    worker_plain_ms = _ms(lambda: FB.worker_bwd_plain(
        *args, wc, scale, True, FB.BLOCK, FB.BLOCK, h, hk), reps=2, rounds=3)
    kv_ids, q_ids = schedule.prefetch_arrays()
    first = FB.first_visit_flags(kv_ids, q_ids)
    serial_plain_ms = _ms(lambda: FB.serial_bwd_plain(
        *args, kv_ids, q_ids, first, scale, True, FB.BLOCK, FB.BLOCK, h, hk),
        reps=2, rounds=3)
    fold_plain_ms = _ms(lambda: FB.fold_plain(part, visited, FB.BLOCK),
                        reps=5)
    # one PyTorch call for the fold: a sum over the workers, which computes
    # the same function once the tiles no worker visits are zeroed (done
    # here, outside the timing)
    seen = visited.repeat_interleave(FB.BLOCK, 1).bool()[None, :, :, None]
    part0 = part.where(seen, 0.0)
    fold_library_ms = _ms(lambda: torch.sum(part0, dim=1), reps=50)
    fold_vs_sum = (torch.sum(part0, dim=1)
                   - FB.fold_cuda(part, visited, FB.BLOCK)).abs().max().item()
    print(f"[timing] fold vs torch.sum over the zeroed partials: max |diff| "
          f"{fold_vs_sum}", flush=True)
    del part0
    # one PyTorch call for the same function: SDPA's backward (all three
    # grads), through autograd over one retained SDPA graph
    q4, k4, v4 = (x.view(b, -1, s, d).detach().requires_grad_(True)
                  for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                          scale=scale)
    do4 = do.view(b, h, s, d)
    library_ms = _ms(lambda: torch.autograd.grad(sdpa, (q4, k4, v4), do4,
                                                 retain_graph=True), reps=20)
    tasks = b * h * int(wc["valid"].sum())
    errs = next(c for c in bwd_check if c["case"] == "train"
                and c["schedule"] == "symmetric_shift")["max_abs_err"]
    worker_err = max(errs["worker"].values())
    serial_err = max(errs["serial"].values())
    src = "src/repro_torch/kernels/csrc/"
    return [
        _entry("flash_bwd_worker", src + "flash_bwd.cu",
               "src/repro/kernels/flash_bwd.py:249", launches["bwd_worker"],
               "train step (one per layer)", worker_err, worker_ms,
               worker_plain_ms, bound_bwd(q, k, schedule, True), library_ms,
               tasks),
        _entry("flash_bwd_serial", src + "flash_bwd.cu",
               "src/repro/kernels/flash_bwd.py:132", launches["bwd_serial"],
               "dash_attention(causal=True, worker_parallel=False) fwd + bwd",
               serial_err, serial_ms, serial_plain_ms,
               bound_bwd(q, k, schedule, False), library_ms),
        _entry("fold", src + "fold.cu", "src/repro/kernels/flash_bwd.py:380",
               launches["fold"], "train step (dQ combine, one per layer)",
               errs["fold"], fold_ms, fold_plain_ms,
               bound_fold(part, visited), fold_library_ms),
    ]


def time_masks(mask_check, launches):
    """The block-sparse forward and both masked backwards at the windowed
    training slice's attention shape (B=1, H=32, S=4096, D=64, bf16, the
    1024-token window), beside their plain versions and SDPA with the dense
    boolean window mask (forward; backward through autograd)."""
    name, b, h, hk, s, d, dtype = WINDOW_CASE
    scale = d ** -0.5
    q, k, v, do, out, lse, delta = _bwd_operands(b, h, hk, s, d, dtype, False,
                                                 seed=3, mask=WINDOW)
    fwd_ms = _ms(lambda: FF.flash_fwd_mask_cuda(q, k, v, scale, h, hk,
                                                WINDOW), reps=50)
    fwd_plain_ms = _ms(lambda: FF.flash_fwd_plain(q, k, v, scale, h, hk,
                                                  mask=WINDOW), reps=2,
                       rounds=3)
    q4, k4, v4 = (x.view(b, -1, s, d).detach().requires_grad_(True)
                  for x in (q, k, v))
    dense = torch.from_numpy(WINDOW.materialize(s)).cuda()
    with torch.no_grad():
        fwd_library_ms = _ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=dense, scale=scale), reps=20)
    schedule = cached_schedule("shift", s // FB.BLOCK, mask=WINDOW)
    wc = schedule.worker_chains()
    args = (q, k, v, do, lse, delta)
    worker_ms = _ms(lambda: FB.worker_bwd_cuda(*args, schedule, scale, False,
                                               h, hk, WINDOW), reps=10)
    serial_ms = _ms(lambda: FB.serial_bwd_cuda(*args, schedule, scale, False,
                                               h, hk, WINDOW), reps=3)
    worker_plain_ms = _ms(lambda: FB.worker_bwd_plain(
        *args, wc, scale, False, FB.BLOCK, FB.BLOCK, h, hk, WINDOW), reps=1,
        rounds=3, warmup=1)
    kv_ids, q_ids = schedule.prefetch_arrays()
    first = FB.first_visit_flags(kv_ids, q_ids)
    serial_plain_ms = _ms(lambda: FB.serial_bwd_plain(
        *args, kv_ids, q_ids, first, scale, False, FB.BLOCK, FB.BLOCK, h, hk,
        WINDOW), reps=1, rounds=3, warmup=1)
    sdpa = F.scaled_dot_product_attention(q4, k4, v4, attn_mask=dense,
                                          scale=scale)
    do4 = do.view(b, h, s, d)
    bwd_library_ms = _ms(lambda: torch.autograd.grad(
        sdpa, (q4, k4, v4), do4, retain_graph=True), reps=10)
    tasks = b * h * int(wc["valid"].sum())
    window_checks = [c for c in mask_check if c["mask"] == "window"]
    fwd_err = max(c["max_abs_err"]["fwd"] for c in window_checks)
    worker_err = max(max(c["max_abs_err"]["worker"].values())
                     for c in window_checks)
    serial_err = max(max(c["max_abs_err"]["serial"].values())
                     for c in window_checks)
    src = "src/repro_torch/kernels/csrc/"
    return [
        _entry("flash_fwd_mask", src + "flash_fwd.cu",
               "src/repro/kernels/flash_fwd.py:198", launches["fwd_mask"],
               "windowed train step (remat: 2 per layer)", fwd_err, fwd_ms,
               fwd_plain_ms, bound_fwd(q, k, v, False, mask=WINDOW),
               fwd_library_ms),
        _entry("flash_bwd_worker_mask", src + "flash_bwd.cu",
               "src/repro/kernels/flash_bwd.py:249", launches["bwd_worker"],
               "windowed train step (one per layer)", worker_err, worker_ms,
               worker_plain_ms, bound_bwd(q, k, schedule, True),
               bwd_library_ms, tasks),
        _entry("flash_bwd_serial_mask", src + "flash_bwd.cu",
               "src/repro/kernels/flash_bwd.py:132", launches["bwd_serial"],
               "dash_attention(mask=SlidingWindow(1024), "
               "worker_parallel=False) fwd + bwd", serial_err, serial_ms,
               serial_plain_ms, bound_bwd(q, k, schedule, False),
               bwd_library_ms),
    ]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    phase_build()
    phase_device()
    fwd_check = check_forward(True, KERNEL_CASES + TRAIN_CASES[:1]
                              + FWD_EDGE_CASES)
    full_check = check_forward(False, TRAIN_CASES + FULL_EDGE_CASES)
    check_forward_bits()
    bwd_check = check_backward()
    mask_check = check_masks()
    serve = run_slice()
    serve_window = run_slice(SLICE_WINDOW, "slice-window")
    train = run_train()
    resume = run_train_resume(train["digest_chain_heads"][0])
    run_lifecycle()
    train_window = run_train(TRAIN_WINDOW_ARGV, "train-window")
    op_paths = run_ops()
    launches = dict(train["launches_per_step"])
    launches["fwd_full"] = op_paths["full_shift"]["launches"]["fwd_full"]
    launches["bwd_serial"] = op_paths["causal_serialized"]["launches"][
        "bwd_serial"]
    window_launches = dict(train_window["launches_per_step"])
    window_launches["bwd_serial"] = op_paths["window_serialized"][
        "launches"]["bwd_serial"]
    kernels = time_forward(fwd_check, full_check, launches)
    kernels += time_backward(bwd_check, launches)
    kernels += time_masks(mask_check, window_launches)
    print(f"[done] serving prefill launched the causal forward "
          f"{serve['attention_launches']} times, the windowed one the "
          f"block-sparse forward {serve_window['attention_launches']} times; "
          f"training resumed from step {resume['resumed_from']} with the "
          f"straight run's digest chain; "
          f"{time.perf_counter() - t0:.1f}s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
