"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. build   — compile every CUDA source of the port with nvcc, in parallel;
  2. device  — the card's name and power limit (nvidia-smi);
  3. kernels — hold each kernel against its plain PyTorch version on the
               card: the causal and full-mask forwards, and for every
               backward schedule (fa3, descending, shift full; fa3,
               descending, symmetric_shift causal) the worker-parallel
               backward + ordered fold; the serialized backward must equal
               worker + fold bit for bit, and 20 repetitions of the worker
               backward must be bitwise identical;
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
  6. ops     — ``dash_attention`` forward and backward at the training
               shape, full mask (schedule ``shift``) and serialized, against
               the plain op, counting the kernels each path launches;
  7. timing  — each kernel at the training slice's attention shape beside its
               plain version, the PyTorch library call for the same function
               where there is one, and its bound.
The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script exits
non-zero and prints no result; so does a machine without CUDA.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

# cuBLAS reads this when the card's first handle is made: set it before
# torch touches the card, so the train phase's GEMMs are deterministic
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core.schedules import cached_schedule  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_bwd as FB  # noqa: E402
from repro_torch.kernels import flash_fwd as FF  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.module import count_params, set_path, tree_paths  # noqa: E402,E501
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.train import optimizer as O  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402

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
BWD_SCHEDULES = [("fa3", False), ("descending", False), ("shift", False),
                 ("fa3", True), ("descending", True), ("symmetric_shift", True)]
SLICE = dict(arch="stablelm-1.6b", batch=4, prompt=512, gen=32)
# the train launcher's flags for the train phase (3 steps, warmup 1 so the
# weights move)
TRAIN_ARGV = ["--arch", "stablelm-1.6b", "--batch", "4", "--seq", "1024",
              "--steps", "3", "--warmup-steps", "1", "--seed", "0",
              "--log-every", "1", "--verify"]


def _qkv(b, h, hk, s, d, dtype, seed=0):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b * h, s, d), generator=gen, device="cuda").to(dtype)
    k = torch.randn((b * hk, s, d), generator=gen, device="cuda").to(dtype)
    v = torch.randn((b * hk, s, d), generator=gen, device="cuda").to(dtype)
    return q, k, v


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
    for name, b, h, hk, s, d, dtype in cases:
        q, k, v = _qkv(b, h, hk, s, d, dtype, seed=int(not causal))
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
        results.append(dict(case=name, shape=[b, h, hk, s, d],
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


def _counts():
    return dict(fwd_causal=FF.launches, fwd_full=FF.launches_full,
                bwd_worker=FB.launches_worker, bwd_serial=FB.launches_serial,
                fold=FB.launches_fold)


def _zero_counts():
    FF.launches = FF.launches_full = 0
    FB.launches_worker = FB.launches_serial = FB.launches_fold = 0


def _bwd_operands(b, h, hk, s, d, dtype, causal, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn((b * h, s, d), generator=gen, device="cuda")
             .to(dtype) for _ in range(2))
    k, v = (torch.randn((b * hk, s, d), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    out, lse = FF.flash_fwd_cuda(q, k, v, d ** -0.5, h, hk, causal=causal)
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
    if failed:
        raise AssertionError(f"backward kernels failed their checks in "
                             f"{failed}")
    return results


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


@torch.inference_mode()
def run_slice():
    cfg = registry.get(SLICE["arch"]).replace(attention_impl="cuda")
    b, s, n = SLICE["batch"], SLICE["prompt"], SLICE["gen"]
    params = T.init(cfg, seed=0, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(1, cfg.vocab, (b, s), generator=gen, device="cuda")
    batch = {"tokens": prompt}
    engine = Engine(cfg, params, max_seq=s + n)

    torch.cuda.reset_peak_memory_stats()
    FF.launches = 0
    tokens, t_run = _timed(lambda: engine.generate(batch, n))
    launches = FF.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != cfg.n_layers:
        raise AssertionError(f"prefill launched the attention kernel "
                             f"{launches} times, expected {cfg.n_layers}")
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
        new_tokens=n, attention_launches=launches,
        run_s=t_run, prefill_ms=t_prefill * 1e3,
        decode_tok_per_s=b * (n - 1) / t_decode, peak_mem_gb=peak_gb,
        tokens_bitwise_equal=True, logits_max_abs_err_vs_plain=err,
        logits_atol=LOGITS_ATOL, max_abs_logit=plain_logits.abs().max().item(),
        argmax_agreement=same_argmax.item(), tokens_row0=tokens[0, :8].tolist())
    print("[slice] " + json.dumps(result), flush=True)
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


def run_train():
    """StableLM-1.6B at full width and depth, 3 AdamW steps through the train
    launcher (``repro_torch.launch.train.main``, the DASH kernels), twice
    from seed 0; the launcher's step 1 against the plain attention's on the
    same weights and batch; step 3 of the second run under the profiler."""
    args, cfg, tcfg, data, device = launch_train.configure(TRAIN_ARGV)
    want = dict(fwd_causal=2 * cfg.n_layers, fwd_full=0,
                bwd_worker=cfg.n_layers, bwd_serial=0, fold=cfg.n_layers)
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

        argv = TRAIN_ARGV + (["--profile-step", str(args.steps)] if run
                             else [])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_counts()
        summary = launch_train.main(argv, on_step=on_step)
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
        entry="repro_torch.launch.train.main " + " ".join(TRAIN_ARGV),
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
    print("[train] " + json.dumps(result), flush=True)
    print("[train-profile] " + json.dumps(dict(
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


def run_ops():
    """``dash_attention`` forward + backward at the training shape, through
    its default path (causal, worker-parallel + fold) and its two others,
    against the plain op at the reference's grad tolerances; each path's
    launches are counted from zero."""
    name, b, h, hk, s, d, dtype = TRAIN_CASES[0]
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn((b, h, s, d), generator=gen, device="cuda")
                   .to(dtype) for _ in range(4))
    results = {}
    for label, kw in (("causal_default", dict(causal=True)),
                      ("full_shift", dict(causal=False, schedule="shift")),
                      ("causal_serialized", dict(causal=True,
                                                 worker_parallel=False))):
        x = [t.clone().requires_grad_(True) for t in (q, k, v)]
        torch.cuda.synchronize()
        _zero_counts()
        out = ops.dash_attention(*x, **kw)
        grads = torch.autograd.grad(out, x, do)
        torch.cuda.synchronize()
        counts = _counts()
        y = [t.clone().requires_grad_(True) for t in (q, k, v)]
        ref = ops.torch_attention(*y, causal=kw["causal"])
        ref_grads = torch.autograd.grad(ref, y, do)
        err = [(g.float() - r.float()).abs().max().item()
               for g, r in zip((out,) + grads, (ref,) + ref_grads)]
        ok = (torch.allclose(out.float(), ref.float(), atol=OUT_TOL[dtype],
                             rtol=OUT_TOL[dtype])
              and all(torch.allclose(g.float(), r.float(), **GRAD_TOL[dtype])
                      for g, r in zip(grads, ref_grads)))
        results[label] = dict(launches=counts, max_abs_err=dict(
            zip(("out", "dq", "dk", "dv"), err)), ok=ok)
    print("[ops] " + json.dumps(results), flush=True)
    if not all(r["ok"] for r in results.values()):
        raise AssertionError(f"dash_attention disagrees with the plain op: "
                             f"{results}")
    want = dict(
        causal_default=dict(fwd_causal=1, fwd_full=0, bwd_worker=1,
                            bwd_serial=0, fold=1),
        full_shift=dict(fwd_causal=0, fwd_full=1, bwd_worker=1, bwd_serial=0,
                        fold=1),
        causal_serialized=dict(fwd_causal=1, fwd_full=0, bwd_worker=0,
                               bwd_serial=1, fold=0))
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


def _bound(moved_bytes, flops, dtype):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    operations over the dtype's peak rate."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bound_fwd(q, k, v, causal, block=FF.BLOCK):
    """Least time for the forward on these inputs: q, k, v read once, out
    and lse written once, against the live tiles' products (QK^T and PV, 2
    flops per multiply-add) at the peak rate of the dtype."""
    bh, s, d = q.shape
    sk = k.shape[1]
    moved = (q.numel() + k.numel() + v.numel() + q.numel()) * q.element_size()
    moved += bh * s * 4
    if causal:
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
           library_ms):
    t = dict(name=name, route="cuda", source=source, replaces=replaces,
             launches=launches, launch_path=path, max_abs_err=err, ms=ms,
             plain_ms=plain_ms, bound_ms=bound[0], bound_by=bound[1],
             library_ms=library_ms)
    print(f"[timing] {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {'-' if library_ms is None else f'{library_ms:.4f}'} ms, "
          f"bound {bound[0]:.4f} ms ({bound[1]}), {bound[0] / ms:.1%} of "
          f"bound", flush=True)
    return t


@torch.inference_mode()
def time_forward(fwd_check, full_check, launches):
    """Both forwards at the training slice's attention shape; the causal one
    also at the serving slice's."""
    entries = []
    for causal in (True, False):
        name, b, h, hk, s, d, dtype = TRAIN_CASES[0]
        q, k, v = _qkv(b, h, hk, s, d, dtype)
        scale = d ** -0.5
        ms = _ms(lambda: FF.flash_fwd_cuda(q, k, v, scale, h, hk, causal),
                 reps=50)
        plain_ms = _ms(lambda: FF.flash_fwd_plain(q, k, v, scale, h, hk,
                                                  causal), reps=5)
        q4, k4, v4 = (x.view(b, -1, s, d) for x in (q, k, v))
        library_ms = _ms(lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, scale=scale), reps=50)
        if causal:
            err = next(c for c in fwd_check if c["case"] == "train")
            entries.append(_entry(
                "flash_fwd_causal", "src/repro_torch/kernels/csrc/flash_fwd.cu",
                "src/repro/kernels/flash_fwd.py:177", launches["fwd_causal"],
                "train step (remat: 2 per layer)", err["max_abs_err_out"], ms,
                plain_ms, bound_fwd(q, k, v, True), library_ms))
        else:
            err = next(c for c in full_check if c["case"] == "train")
            entries.append(_entry(
                "flash_fwd_full", "src/repro_torch/kernels/csrc/flash_fwd.cu",
                "src/repro/kernels/flash_fwd.py:157", launches["fwd_full"],
                "dash_attention(causal=False, schedule='shift') fwd + bwd",
                err["max_abs_err_out"], ms, plain_ms,
                bound_fwd(q, k, v, False), library_ms))
    name, b, h, hk, s, d, dtype = KERNEL_CASES[0]
    q, k, v = _qkv(b, h, hk, s, d, dtype)
    ms = _ms(lambda: FF.flash_fwd_cuda(q, k, v, d ** -0.5, h, hk), reps=50)
    print(f"[timing] flash_fwd_causal at the serving slice's shape B={b} "
          f"H={h} S={s} D={d}: {ms:.4f} ms, bound "
          f"{bound_fwd(q, k, v, True)[0]:.4f} ms", flush=True)
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
    # one PyTorch call for the same function: SDPA's backward (all three
    # grads), through autograd over one retained SDPA graph
    q4, k4, v4 = (x.view(b, -1, s, d).detach().requires_grad_(True)
                  for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                          scale=scale)
    do4 = do.view(b, h, s, d)
    library_ms = _ms(lambda: torch.autograd.grad(sdpa, (q4, k4, v4), do4,
                                                 retain_graph=True), reps=20)
    errs = next(c for c in bwd_check if c["case"] == "train"
                and c["schedule"] == "symmetric_shift")["max_abs_err"]
    worker_err = max(errs["worker"].values())
    serial_err = max(errs["serial"].values())
    src = "src/repro_torch/kernels/csrc/"
    return [
        _entry("flash_bwd_worker", src + "flash_bwd.cu",
               "src/repro/kernels/flash_bwd.py:249", launches["bwd_worker"],
               "train step (one per layer)", worker_err, worker_ms,
               worker_plain_ms, bound_bwd(q, k, schedule, True), library_ms),
        _entry("flash_bwd_serial", src + "flash_bwd.cu",
               "src/repro/kernels/flash_bwd.py:132", launches["bwd_serial"],
               "dash_attention(causal=True, worker_parallel=False) fwd + bwd",
               serial_err, serial_ms, serial_plain_ms,
               bound_bwd(q, k, schedule, False), library_ms),
        _entry("fold", src + "fold.cu", "src/repro/kernels/flash_bwd.py:380",
               launches["fold"], "train step (dQ combine, one per layer)",
               errs["fold"], fold_ms, fold_plain_ms,
               bound_fold(part, visited), None),
    ]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    phase_build()
    phase_device()
    fwd_check = check_forward(True, KERNEL_CASES + TRAIN_CASES[:1])
    full_check = check_forward(False, TRAIN_CASES)
    bwd_check = check_backward()
    serve = run_slice()
    train = run_train()
    op_paths = run_ops()
    launches = dict(train["launches_per_step"])
    launches["fwd_full"] = op_paths["full_shift"]["launches"]["fwd_full"]
    launches["bwd_serial"] = op_paths["causal_serialized"]["launches"][
        "bwd_serial"]
    kernels = time_forward(fwd_check, full_check, launches)
    kernels += time_backward(bwd_check, launches)
    print(f"[done] serving prefill launched the causal forward "
          f"{serve['attention_launches']} times; {time.perf_counter() - t0:.1f}"
          f"s in all", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
