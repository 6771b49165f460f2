"""Public attention op (forward only until the backward kernels are ported).

``attention(..., impl=...)`` is the model-facing dispatcher:

  impl="torch"  — plain PyTorch attention (counterpart of ``"xla"``);
  impl="cuda"   — the DASH kernels (counterpart of ``"pallas"``): the causal
                  forward runs ``csrc/flash_fwd.cu`` on CUDA tensors.

Public shapes are (batch, heads, seq, head_dim). GQA is native on both paths:
K/V keep (batch, kv_heads, seq, head_dim) and are addressed by
``query_head // group``, never repeated.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ref as ref_mod
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
    reference); the training slice's backward consumes it."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown DASH schedule {schedule!r}; one of "
                         f"{SCHEDULES}")
    if schedule == "symmetric_shift_or_shift":
        return "symmetric_shift" if causal else "shift"
    return schedule


def dash_attention(q, k, v, causal: bool = False,
                   schedule: str = "symmetric_shift_or_shift",
                   sm_scale: Optional[float] = None, block: int = 128):
    """DASH attention forward.

    Args:
      q: (B, H, S, D); k, v: (B, Hk, S, D) with H a multiple of Hk.
      schedule: the deterministic backward's schedule, resolved and checked
        here so that the training slice only adds the backward.
      block: square tile size (128: the CUDA kernel's tile).
    Returns: (B, H, S, D) attention output.

    Raises when an input requires grad: the backward kernels are not ported,
    and autograd must not differentiate a stand-in instead.
    """
    b, h, s, d = q.shape
    validate_group(h, k.shape[1])
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "dash_attention is forward-only until the DASH backward kernels "
            "are ported (ROADMAP queue A, training slice)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    resolve_schedule(schedule, causal)
    out, _ = flash_fwd(_flatten(q), _flatten(k), _flatten(v), causal=causal,
                       sm_scale=sm_scale, block_q=block, block_k=block,
                       n_heads=h, n_kv_heads=k.shape[1])
    return _unflatten(out, b, h)


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
