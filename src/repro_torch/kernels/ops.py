"""Public attention op: a ``torch.autograd.Function`` around the DASH kernels.

``dash_attention(q, k, v, causal=..., schedule=...)`` runs the flash forward
and the schedule-driven deterministic backward (the counterpart of the
reference's ``jax.custom_vjp``). ``attention(..., impl=...)`` is the
model-facing dispatcher:

  impl="torch"  — plain PyTorch attention (counterpart of ``"xla"``),
                  differentiated by autograd;
  impl="cuda"   — the DASH kernels (counterpart of ``"pallas"``): on CUDA
                  tensors the forward runs ``csrc/flash_fwd.cu`` and the
                  backward ``csrc/flash_bwd.cu`` + ``csrc/fold.cu``; on CPU
                  tensors their plain versions.

Public shapes are (batch, heads, seq, head_dim). GQA is native on both paths:
K/V keep (batch, kv_heads, seq, head_dim) and are addressed by
``query_head // group``, never repeated.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.schedules import cached_schedule
from repro_torch.kernels import ref as ref_mod
from repro_torch.kernels.flash_bwd import flash_bwd
from repro_torch.kernels.flash_fwd import flash_fwd
from repro_torch.kernels.gqa import validate_group

SCHEDULES = ("fa3", "descending", "shift", "symmetric_shift",
             "symmetric_shift_or_shift")


def _flatten(x):  # (B, H, S, D) -> (BH, S, D)
    b, h, s, d = x.shape
    return x.reshape(b * h, s, d)


def _unflatten(x, b, h):
    bh, s, d = x.shape
    return x.reshape(b, h, s, d)


def resolve_schedule(schedule: str, causal: bool) -> str:
    """The backward schedule a call runs (``ops.py`` name resolution of the
    reference)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown DASH schedule {schedule!r}; one of "
                         f"{SCHEDULES}")
    if schedule == "symmetric_shift_or_shift":
        return "symmetric_shift" if causal else "shift"
    return schedule


class _DashAttention(torch.autograd.Function):
    """Forward: the flash forward kernel. Backward: the DASH backward over
    ``cached_schedule(name, S // block, n_heads=1, causal=...)``, as the
    reference's ``_bwd_rule`` resolves it (with one head, ``symmetric_shift``
    has no head pair and plays ``descending``'s chains). Residuals keep K/V
    at Hk heads."""

    @staticmethod
    def forward(ctx, q, k, v, causal, schedule_name, sm_scale, block,
                worker_parallel):
        b, h = q.shape[0], q.shape[1]
        out, lse = flash_fwd(_flatten(q), _flatten(k), _flatten(v),
                             causal=causal, sm_scale=sm_scale, block_q=block,
                             block_k=block, n_heads=h, n_kv_heads=k.shape[1])
        out = _unflatten(out, b, h)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, schedule_name, sm_scale, block, worker_parallel)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, schedule_name, sm_scale, block, worker_parallel = ctx.cfg
        b, h, s, _ = q.shape
        hk = k.shape[1]
        schedule = cached_schedule(schedule_name, s // block, n_heads=1,
                                   causal=causal, block_q=block,
                                   block_k=block)
        dq, dk, dv = flash_bwd(_flatten(q), _flatten(k), _flatten(v),
                               _flatten(out), lse,
                               _flatten(do.contiguous()), schedule,
                               causal=causal, sm_scale=sm_scale,
                               block_q=block, block_k=block,
                               worker_parallel=worker_parallel, n_heads=h,
                               n_kv_heads=hk)
        return (_unflatten(dq, b, h).to(q.dtype),
                _unflatten(dk, b, hk).to(k.dtype),
                _unflatten(dv, b, hk).to(v.dtype),
                None, None, None, None, None)


def dash_attention(q, k, v, causal: bool = False,
                   schedule: str = "symmetric_shift_or_shift",
                   sm_scale: Optional[float] = None, block: int = 128,
                   worker_parallel: bool = True):
    """DASH attention with the deterministic scheduled backward.

    Args:
      q: (B, H, S, D); k, v: (B, Hk, S, D) with H a multiple of Hk (native
        GQA — KV heads are addressed by group, never repeated).
      schedule: "fa3" | "descending" | "shift" | "symmetric_shift" |
        "symmetric_shift_or_shift" (the paper-optimal one for the mask).
      block: square tile size (128: the CUDA kernels' tile).
      worker_parallel: run the backward across the schedule's worker chains
        with the ordered dQ fold (bitwise equal to the serialized backward
        on single-visit schedules; falls back to it otherwise).
    Returns: (B, H, S, D) attention output, differentiable in q, k, v.
    """
    b, h, s, d = q.shape
    validate_group(h, k.shape[1])
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    name = resolve_schedule(schedule, causal)
    return _DashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal, name, sm_scale, block,
                                worker_parallel)


def _grouped_logits_mask(logits, causal):
    if not causal:
        return logits
    sq, sk = logits.shape[-2], logits.shape[-1]
    qpos = torch.arange(sq, device=logits.device)
    kpos = torch.arange(sk, device=logits.device)
    visible = qpos[:, None] >= kpos[None, :] + sq - sk
    return torch.where(visible, logits, torch.full_like(logits, -1e30))


def torch_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    chunk_q: Optional[int] = None):
    """Plain attention (B, H, S, D), fp32 math — counterpart of
    ``xla_attention`` without masks or segments.

    GQA-native: k/v may carry Hk < H heads; the einsums contract per KV-head
    group instead of repeating K/V. The query-chunked path of the reference
    (S > ``chunk_q``) is not ported and raises.
    """
    b, h, s, d = q.shape
    hk = k.shape[1]
    g = validate_group(h, hk)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if chunk_q and s > chunk_q and s % chunk_q == 0:
        raise NotImplementedError(
            f"query-chunked attention (S={s} > attn_chunk_q={chunk_q}) is not "
            f"ported yet (ROADMAP queue A, attention op)")
    if g == 1:
        out, _ = ref_mod.mha_fwd(_flatten(q), _flatten(k), _flatten(v),
                                 causal, sm_scale)
        return _unflatten(out, b, h)
    qg = q.reshape(b, hk, g, s, d)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg.float(), k.float()) * sm_scale
    logits = _grouped_logits_mask(logits, causal)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
    return out.reshape(b, h, s, d).to(q.dtype)


def attention(q, k, v, causal: bool = False, impl: str = "torch",
              schedule: str = "symmetric_shift_or_shift",
              sm_scale: Optional[float] = None,
              chunk_q: Optional[int] = None):
    """Model-facing dispatcher; see module docstring.

    Validates GQA group divisibility up front: q carries ``n_heads`` heads, k/v
    carry ``n_kv_heads`` — the former must be a multiple of the latter.
    """
    validate_group(q.shape[1], k.shape[1])
    if impl == "torch":
        return torch_attention(q, k, v, causal, sm_scale, chunk_q=chunk_q)
    if impl == "cuda":
        return dash_attention(q, k, v, causal, schedule, sm_scale)
    raise ValueError(f"unknown attention impl {impl!r}")
