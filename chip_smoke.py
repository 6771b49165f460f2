"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each reported on its own line:
  1. build   — compile every CUDA source of the port with nvcc;
  2. device  — the card's name and power limit (nvidia-smi);
  3. kernels — hold each kernel against its plain PyTorch version on the card;
  4. slice   — serve StableLM-1.6B at full width and depth in bf16 (random
               weights, seed 0) through the static engine: greedy, batch 4,
               prompt 512, 32 new tokens. Checks that the prefill launched the
               attention kernel once per layer, that tokens are in range and
               bitwise equal across two runs, and that the prefill logits match
               the plain attention's on the same weights;
  5. timing  — each kernel at the slice's shape beside its plain version, the
               PyTorch library call for the same function, and its bound.
The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Any failed check raises, so the script exits
non-zero and prints no result; so does a machine without CUDA.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import registry  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_fwd as FF  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.module import count_params  # noqa: E402
from repro_torch.serve.engine import Engine  # noqa: E402

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

# (name, batch, heads, kv heads, seq, head_dim, dtype)
KERNEL_CASES = [
    ("slice", 4, 32, 32, 512, 64, torch.bfloat16),
    ("gqa", 1, 32, 8, 1024, 128, torch.bfloat16),
    ("fp32", 2, 8, 8, 384, 64, torch.float32),
    ("reduced", 2, 4, 4, 256, 32, torch.bfloat16),
]
SLICE = dict(arch="stablelm-1.6b", batch=4, prompt=512, gen=32)


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


def check_kernels():
    """Each case: kernel vs plain version on the same inputs on the card."""
    results, failed = [], []
    for name, b, h, hk, s, d, dtype in KERNEL_CASES:
        q, k, v = _qkv(b, h, hk, s, d, dtype)
        scale = d ** -0.5
        out, lse = FF.flash_fwd_cuda(q, k, v, scale, h, hk)
        ref_out, ref_lse = FF.flash_fwd_plain(q, k, v, scale, h, hk)
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
    print("[kernel-check] " + json.dumps(results), flush=True)
    if failed:
        raise AssertionError(f"flash_fwd kernel disagrees with its plain "
                             f"version in cases {failed}")
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


def bound_ms(q, k, v, block=FF.BLOCK):
    """Least time for the causal forward on these inputs: q, k, v read once,
    out and lse written once, against the live tiles' products
    (QK^T and PV, 2 flops per multiply-add) at the peak rate of the dtype."""
    bh, s, d = q.shape
    moved = (q.numel() + k.numel() + v.numel() + q.numel()) * q.element_size()
    moved += bh * s * 4
    n_tiles = len(FF.causal_grid(s // block, s // block, block, block)[0])
    flops = bh * n_tiles * 4 * block * block * d
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[q.dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


@torch.inference_mode()
def time_kernels(check, launches):
    name, b, h, hk, s, d, dtype = KERNEL_CASES[0]
    q, k, v = _qkv(b, h, hk, s, d, dtype)
    scale = d ** -0.5
    ms = _ms(lambda: FF.flash_fwd_cuda(q, k, v, scale, h, hk), reps=50)
    plain_ms = _ms(lambda: FF.flash_fwd_plain(q, k, v, scale, h, hk), reps=5)
    q4, k4, v4 = (x.view(b, -1, s, d) for x in (q, k, v))
    library_ms = _ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, scale=scale), reps=50)
    bound, bound_by = bound_ms(q, k, v)
    slice_case = next(c for c in check if c["case"] == name)
    entry = dict(name="flash_fwd_causal", route="cuda",
                 source="src/repro_torch/kernels/csrc/flash_fwd.cu",
                 replaces="src/repro/kernels/flash_fwd.py:177",
                 launches=launches, max_abs_err=slice_case["max_abs_err_out"],
                 ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                 library_ms=library_ms)
    print(f"[timing] flash_fwd_causal at B={b} H={h} S={s} D={d} "
          f"{str(dtype).split('.')[-1]}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound:.4f} ms "
          f"({bound_by}), {bound / ms:.1%} of bound", flush=True)
    return [entry]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card",
              file=sys.stderr)
        return 2
    phase_build()
    phase_device()
    check = check_kernels()
    result = run_slice()
    kernels = time_kernels(check, result["attention_launches"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
