"""Public attention op: a ``torch.autograd.Function`` around the DASH kernels.

``dash_attention(q, k, v, causal=..., schedule=..., mask=...)`` runs the
flash forward and the schedule-driven deterministic backward (the
counterpart of the reference's ``jax.custom_vjp``); ``mask`` takes any
:class:`repro_torch.masks.spec.MaskSpec` (``causal=True`` is sugar for
``mask=Causal()``) and runs the block-sparse grid and the mask's compiled
ragged schedule. ``attention(..., impl=...)`` is the model-facing
dispatcher:

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
from torch.utils.checkpoint import checkpoint

from repro_torch.core.schedules import cached_schedule
from repro_torch.kernels import flash_bwd as FB
from repro_torch.kernels import fingerprint as FP
from repro_torch.kernels import flash_fwd as FF
from repro_torch.kernels import mlstm as ML
from repro_torch.kernels import ref as ref_mod
from repro_torch.kernels import scan as SC
from repro_torch.kernels import slstm as SL
from repro_torch.kernels.flash_bwd import flash_bwd
from repro_torch.kernels.flash_fwd import flash_fwd
from repro_torch.kernels.gqa import validate_group
from repro_torch.masks.spec import Causal, Full

SCHEDULES = ("fa3", "descending", "shift", "symmetric_shift",
             "symmetric_shift_or_shift")


def launch_counts():
    """The CUDA kernels' launch counters (each wrapper adds one per launch
    and nothing else touches them), by kernel."""
    return dict(fwd_causal=FF.launches, fwd_full=FF.launches_full,
                fwd_mask=FF.launches_mask, bwd_worker=FB.launches_worker,
                bwd_serial=FB.launches_serial, fold=FB.launches_fold,
                fingerprint=FP.launches, scan_fwd=SC.launches_fwd,
                scan_bwd=SC.launches_bwd, scan_fold=SC.launches_fold,
                mlstm_parallel=ML.launches_parallel,
                mlstm_parallel_bwd=ML.launches_parallel_bwd,
                mlstm_recurrent=ML.launches_recurrent, slstm=SL.launches,
                slstm_bwd=SL.launches_bwd)


def _flatten(x):  # (B, H, S, D) -> (BH, S, D)
    b, h, s, d = x.shape
    return x.reshape(b * h, s, d)


def _unflatten(x, b, h):
    bh, s, d = x.shape
    return x.reshape(b, h, s, d)


def resolve_schedule(schedule: str, causal: bool, mask=None) -> str:
    """The backward schedule (or, under a block-sparse mask, the placement)
    a call runs: the reference's name resolution (``ops.py:151-157``)."""
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown DASH schedule {schedule!r}; one of "
                         f"{SCHEDULES}")
    if schedule == "symmetric_shift_or_shift":
        schedule = ("shift" if mask is not None else
                    "symmetric_shift" if causal else "shift")
    if mask is not None and schedule not in ("shift", "fa3"):
        raise ValueError(f"block-sparse masks take placement 'shift' or "
                         f"'fa3'; got {schedule!r}")
    return schedule


class _DashAttention(torch.autograd.Function):
    """Forward: the flash forward kernel. Backward: the DASH backward over
    ``cached_schedule(name, S // block, n_heads=1, causal=..., mask=...)``,
    as the reference's ``_bwd_rule`` resolves it (with one head,
    ``symmetric_shift`` has no head pair and plays ``descending``'s chains;
    under a mask, the mask's compiled ragged schedule). Residuals keep K/V
    at Hk heads."""

    @staticmethod
    def forward(ctx, q, k, v, causal, schedule_name, sm_scale, block,
                worker_parallel, mask):
        b, h = q.shape[0], q.shape[1]
        out, lse = flash_fwd(_flatten(q), _flatten(k), _flatten(v),
                             causal=causal, sm_scale=sm_scale, block_q=block,
                             block_k=block, n_heads=h, n_kv_heads=k.shape[1],
                             mask=mask)
        out = _unflatten(out, b, h)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (causal, schedule_name, sm_scale, block, worker_parallel,
                   mask)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, schedule_name, sm_scale, block, worker_parallel, mask = ctx.cfg
        b, h, s, _ = q.shape
        hk = k.shape[1]
        # the key holds the mask spec: two masks never share a schedule
        schedule = cached_schedule(schedule_name, s // block, n_heads=1,
                                   causal=causal, mask=mask, block_q=block,
                                   block_k=block)
        dq, dk, dv = flash_bwd(_flatten(q), _flatten(k), _flatten(v),
                               _flatten(out), lse,
                               _flatten(do.contiguous()), schedule,
                               causal=causal, sm_scale=sm_scale,
                               block_q=block, block_k=block,
                               worker_parallel=worker_parallel, n_heads=h,
                               n_kv_heads=hk, mask=mask)
        return (_unflatten(dq, b, h).to(q.dtype),
                _unflatten(dk, b, hk).to(k.dtype),
                _unflatten(dv, b, hk).to(v.dtype),
                None, None, None, None, None, None)


def dash_attention(q, k, v, causal: bool = False,
                   schedule: str = "symmetric_shift_or_shift",
                   sm_scale: Optional[float] = None, block: int = 128,
                   worker_parallel: bool = True, mask=None, tune=False):
    """DASH attention with the deterministic scheduled backward.

    Args:
      q: (B, H, S, D); k, v: (B, Hk, S, D) with H a multiple of Hk (native
        GQA — KV heads are addressed by group, never repeated).
      causal: sugar for ``mask=Causal()``.
      schedule: "fa3" | "descending" | "shift" | "symmetric_shift" |
        "symmetric_shift_or_shift" (the paper-optimal one for the mask).
        Under a block-sparse mask this selects the *placement*: "shift" or
        "fa3".
      block: square tile size (128: the CUDA kernels' tile).
      worker_parallel: run the backward across the schedule's worker chains
        with the ordered dQ fold (bitwise equal to the serialized backward
        on single-visit schedules; falls back to it otherwise).
      mask: optional :class:`repro_torch.masks.spec.MaskSpec`. ``Full()`` /
        ``Causal()`` take the flag form (bitwise the same); any other spec
        runs the block-sparse forward and the mask's compiled schedule.
      tune: ``True``/"sim" lets :func:`repro_torch.tune.tune_attention`
        resolve (schedule, block, worker_parallel) from the modeled makespan
        for this (shape, dtype, mask) key; "measure" takes a decision a
        measured run left in the tuner's cache (with none there it ranks as
        "sim" does). Tuning only selects knobs, which override the three
        arguments: the tuned call is bitwise identical to the hand-picked
        call with the same resolved knobs.
    Returns: (B, H, S, D) attention output, differentiable in q, k, v.
    """
    b, h, s, d = q.shape
    validate_group(h, k.shape[1])
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if mask is not None:
        # Full/Causal are the paper masks: the registry schedules and the
        # full/causal kernels, bitwise the flag form
        if isinstance(mask, Full):
            causal, mask = False, None
        elif isinstance(mask, Causal):
            causal, mask = True, None
        elif causal:
            raise ValueError("mask supersedes the causal flag")
    if tune:
        from repro_torch.tune import tune_attention
        cand = tune_attention(seq=s, head_dim=d, dtype=q.dtype,
                              causal=causal, mask=mask, n_heads=h,
                              n_kv_heads=k.shape[1],
                              mode="sim" if tune is True else tune).candidate
        schedule = cand.schedule
        block = cand.block_q          # candidates are square-tiled
        worker_parallel = cand.worker_parallel
    name = resolve_schedule(schedule, causal, mask)
    return _DashAttention.apply(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal, name, sm_scale, block,
                                worker_parallel, mask)


def _grouped_logits_mask(logits, causal):
    if not causal:
        return logits
    sq, sk = logits.shape[-2], logits.shape[-1]
    qpos = torch.arange(sq, device=logits.device)
    kpos = torch.arange(sk, device=logits.device)
    visible = qpos[:, None] >= kpos[None, :] + sq - sk
    return torch.where(visible, logits, torch.full_like(logits, -1e30))


def _extra_mask(mask, segment_ids, sq: int, sk: int, device):
    """A static MaskSpec and per-row segment ids as one (B|1, Sq, Sk) bool
    visibility tensor (None if neither is given) — for the unchunked path
    only: the chunked one evaluates masks per chunk (:func:`_chunk_extra`)
    so the O(Sq·Sk) array is never resident."""
    ex = None
    if mask is not None:
        ex = torch.from_numpy(mask.materialize(sq, sk)).to(device)[None]
    if segment_ids is not None:
        seg = segment_ids[:, :, None] == segment_ids[:, None, :]
        ex = seg if ex is None else ex & seg
    return ex


def _chunk_extra(mask, segment_ids, off: int, chunk_q: int, sk: int, device):
    """(B|1, chunk, Sk) visibility for one query chunk: the spec's
    ``mask_fn`` on the chunk's positions, the segment ids of its rows."""
    ex = None
    if mask is not None:
        qpos = (off + torch.arange(chunk_q, device=device))[:, None]
        kpos = torch.arange(sk, device=device)[None, :]
        ex = mask.mask_fn(qpos, kpos)[None]
    if segment_ids is not None:
        seg_q = segment_ids[:, off:off + chunk_q]
        seg = seg_q[:, :, None] == segment_ids[:, None, :]
        ex = seg if ex is None else ex & seg
    return ex


def torch_attention(q, k, v, causal: bool = False,
                    sm_scale: Optional[float] = None,
                    chunk_q: Optional[int] = None, mask=None,
                    segment_ids=None):
    """Plain attention (B, H, S, D), fp32 math — counterpart of
    ``xla_attention``, differentiated by autograd.

    GQA-native: k/v may carry Hk < H heads; the einsums contract per KV-head
    group instead of repeating K/V. ``chunk_q``: above it (S a multiple of
    it) the queries run in chunks, each under ``torch.utils.checkpoint`` (the
    reference remats each chunk), so the (B, H, S, S) scores are never
    resident. ``mask``: a static :class:`repro_torch.masks.spec.MaskSpec`;
    ``segment_ids``: (B, S) packed-document ids (q sees k iff same
    segment). Both AND with ``causal`` (end-aligned when Sq != Sk).
    """
    b, h, s, d = q.shape
    hk = k.shape[1]
    g = validate_group(h, hk)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    chunked = bool(chunk_q) and s > chunk_q and s % chunk_q == 0
    extra = None if chunked else _extra_mask(mask, segment_ids, s,
                                             k.shape[2], q.device)

    if g == 1:
        if not chunked:
            if extra is None:
                out, _ = ref_mod.mha_fwd(_flatten(q), _flatten(k),
                                         _flatten(v), causal, sm_scale)
                return _unflatten(out, b, h)
            logits = torch.einsum("bhqd,bhkd->bhqk", q.float(),
                                  k.float()) * sm_scale
            logits = _grouped_logits_mask(logits, causal)
            logits = torch.where(extra[:, None], logits,
                                 torch.full_like(logits, -1e30))
            w = torch.softmax(logits, dim=-1)
            out = torch.einsum("bhqk,bhkd->bhqd", w, v.float())
            return out.to(q.dtype)
        return _chunked(q, k, v, causal, sm_scale, chunk_q,
                        "bhqd,bhkd->bhqk", "bhqk,bhkd->bhqd", mask=mask,
                        segment_ids=segment_ids)

    qg = q.reshape(b, hk, g, s, d)
    if not chunked:
        logits = torch.einsum("bkgqd,bksd->bkgqs", qg.float(),
                              k.float()) * sm_scale
        logits = _grouped_logits_mask(logits, causal)
        if extra is not None:
            logits = torch.where(extra[:, None, None], logits,
                                 torch.full_like(logits, -1e30))
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bkgqs,bksd->bkgqd", w, v.float())
        return out.reshape(b, h, s, d).to(q.dtype)
    out = _chunked(qg, k, v, causal, sm_scale, chunk_q,
                   "bkgqd,bksd->bkgqs", "bkgqs,bksd->bkgqd", mask=mask,
                   segment_ids=segment_ids)
    return out.reshape(b, h, s, d)


def _chunked(q, k, v, causal, sm_scale, chunk_q, score_eq, out_eq, mask=None,
             segment_ids=None):
    """Query-chunked attention shared by the flat and grouped GQA paths.

    q: (..., S, D) with leading batch/head(/group) axes named by the einsum
    equations; k/v: (B, Hk|H, S, D). Masks and segment ids are evaluated per
    chunk (:func:`_chunk_extra`); each chunk runs under
    ``torch.utils.checkpoint`` when grads are on, so the backward recomputes
    one chunk's scores at a time.
    """
    s, sk = q.shape[-2], k.shape[-2]
    kf, vf = k.float(), v.float()
    kpos = torch.arange(sk, device=q.device)

    def one_chunk(qch, off):
        logits = torch.einsum(score_eq, qch.float(), kf) * sm_scale
        if causal:
            # end-aligned causal convention (ref._mask's tril(sk - sq)):
            # query i may see keys <= i + sk - sq
            qpos = off + torch.arange(chunk_q, device=q.device) + (sk - s)
            cmask = qpos[:, None] >= kpos[None, :]
            logits = torch.where(cmask, logits,
                                 torch.full_like(logits, -1e30))
        if mask is not None or segment_ids is not None:
            ex = _chunk_extra(mask, segment_ids, off, chunk_q, sk, q.device)
            # (B|1, chunk, Sk) → broadcast over head (and group) axes
            ex = ex.reshape((ex.shape[0],) + (1,) * (logits.ndim - 3)
                            + ex.shape[1:])
            logits = torch.where(ex, logits, torch.full_like(logits, -1e30))
        w = torch.softmax(logits, dim=-1)
        return torch.einsum(out_eq, w, vf).to(q.dtype)

    outs = []
    for off in range(0, s, chunk_q):
        qch = q[..., off:off + chunk_q, :]
        if torch.is_grad_enabled():
            outs.append(checkpoint(one_chunk, qch, off, use_reentrant=False))
        else:
            outs.append(one_chunk(qch, off))
    return torch.cat(outs, dim=-2)


def attention(q, k, v, causal: bool = False, impl: str = "torch",
              schedule: str = "symmetric_shift_or_shift",
              sm_scale: Optional[float] = None,
              chunk_q: Optional[int] = None, mask=None, segment_ids=None):
    """Model-facing dispatcher; see module docstring.

    Validates GQA group divisibility up front: q carries ``n_heads`` heads, k/v
    carry ``n_kv_heads`` — the former must be a multiple of the latter.
    ``mask`` (a static MaskSpec) reaches both impls; ``segment_ids`` (dynamic
    per-row packing) has no static block map, so it always runs the plain
    path, as in the reference.
    """
    validate_group(q.shape[1], k.shape[1])
    if impl == "torch" or segment_ids is not None:
        return torch_attention(q, k, v, causal, sm_scale, chunk_q=chunk_q,
                               mask=mask, segment_ids=segment_ids)
    if impl == "cuda":
        return dash_attention(q, k, v, causal, schedule, sm_scale, mask=mask)
    raise ValueError(f"unknown attention impl {impl!r}")
