"""Causal flash-attention forward: task grid, plain version and CUDA kernel.

Counterpart of ``repro.kernels.flash_fwd`` for the causal mask. The TPU kernel
``_fwd_sched_kernel`` walks the task list of :func:`causal_grid` (descending
q tiles, kv ascending within a q tile, fully masked tiles never visited) on a
sequential grid axis. On the card that becomes ``csrc/flash_fwd.cu``: one
CTA per (bh, q tile), q tiles launched in descending order, the kv loop
inside the CTA stopping at the diagonal tile (see the note in the source).

:func:`flash_fwd` validates, then runs the kernel for CUDA tensors and the
plain version (:func:`flash_fwd_plain`, a masked dense softmax in fp32) for
CPU tensors — never one in place of the other. The full-mask and
block-sparse forwards (``_fwd_kernel``, ``_fwd_mask_kernel``) are not ported
yet and raise.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.gqa import kv_head_index

BLOCK = 128                  # the CUDA kernel's square tile
HEAD_DIMS = (32, 64, 128)    # head dims the CUDA kernel is instantiated for
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# launches of the CUDA kernel; the wrapper adds one per launch and nothing
# else touches it, so a caller can zero it and read how often a run used it
launches = 0


@functools.lru_cache(maxsize=256)
def causal_grid(n_q: int, n_k: int, block_q: int, block_k: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(kv_ids, q_ids, first, last) int32 task arrays for the causal forward.

    Tasks visit q tiles in **descending** order; within a q tile, kv ascends
    (the online-softmax chain). Only tiles with at least one unmasked element —
    ``kv·block_k < (q+1)·block_q`` — are emitted, so the grid contains zero
    fully-masked tiles by construction. ``first``/``last`` flag each q tile's
    chain boundaries (init / finalize). The CUDA kernel runs the same set of
    tiles in the same order per (bh, q tile).
    """
    kv_ids, q_ids, first, last = [], [], [], []
    for qi in range(n_q - 1, -1, -1):
        n_valid = min(n_k, -(-((qi + 1) * block_q) // block_k))
        for ki in range(n_valid):
            kv_ids.append(ki)
            q_ids.append(qi)
            first.append(1 if ki == 0 else 0)
            last.append(1 if ki == n_valid - 1 else 0)
    return (np.asarray(kv_ids, np.int32), np.asarray(q_ids, np.int32),
            np.asarray(first, np.int32), np.asarray(last, np.int32))


def flash_fwd_plain(q, k, v, sm_scale, n_heads, n_kv_heads):
    """Causal attention as a masked dense softmax in fp32 (any device): the
    oracle ``ref.mha_fwd`` on K/V gathered per query head.

    q (BH, S, D); k, v (B·Hk, S, D). Returns out (BH, S, D) in q's dtype and
    lse (BH, S) fp32 — the function the CUDA kernel computes.
    """
    kv = kv_head_index(torch.arange(q.shape[0], device=q.device), n_heads,
                       n_kv_heads)
    return ref.mha_fwd(q, k[kv], v[kv], causal=True, sm_scale=sm_scale)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("flash_fwd")
    fn = lib.dash_flash_fwd_causal
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_fwd_cuda(q, k, v, sm_scale, n_heads, n_kv_heads):
    """Launch ``csrc/flash_fwd.cu`` on PyTorch's current stream.

    Raises on anything the kernel does not take instead of computing it
    another way. Returns (out, lse) like :func:`flash_fwd_plain`.
    """
    global launches
    bh, s, d = q.shape
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_fwd_cuda needs q, k and v on one CUDA device")
    if q.dtype not in KERNEL_DTYPES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash_fwd_cuda takes one dtype of {KERNEL_DTYPES} "
                        f"for q, k, v; got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS or s % BLOCK:
        raise ValueError(f"flash_fwd_cuda takes head_dim in {HEAD_DIMS} and S "
                         f"a multiple of {BLOCK}; got S={s}, head_dim={d}")
    if k.shape != v.shape or k.shape != (bh // n_heads * n_kv_heads, s, d):
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} at heads {n_heads}/{n_kv_heads}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd_cuda needs contiguous q, k, v")
    fn = _lib()
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), bh, s, d, n_heads, n_kv_heads, sm_scale,
                 int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"flash_fwd CUDA kernel failed to launch: "
                           f"cudaError {err}")
    launches += 1
    return out, lse


def flash_fwd(q, k, v, causal=False, sm_scale=None, block_q=128, block_k=128,
              n_heads: Optional[int] = None, n_kv_heads: Optional[int] = None):
    """Flash attention forward (causal).

    Args:   q: (BH, S, D); k, v: (B·Hk, S, D) — pass ``n_heads``/``n_kv_heads``
            when the head counts differ (native GQA; no KV repetition).
            S divisible by the block sizes.
    Returns: out (BH, S, D) q.dtype, lse (BH, S) fp32.

    CUDA tensors go through the kernel (block 128 only); CPU tensors through
    :func:`flash_fwd_plain`. ``causal=False`` raises until the full-mask
    kernel is ported.
    """
    bh, sq, d = q.shape
    sk = k.shape[1]
    if n_heads is None or n_kv_heads is None:
        if k.shape[0] != bh:
            raise ValueError("k/v have fewer heads than q: pass n_heads and "
                             "n_kv_heads for native GQA")
        n_heads = n_kv_heads = 1
    if bh % n_heads or k.shape[0] != (bh // n_heads) * n_kv_heads:
        raise ValueError(f"flattened shapes {bh}x{k.shape[0]} inconsistent "
                         f"with heads {n_heads}/{n_kv_heads}")
    if not causal:
        raise NotImplementedError(
            "the full-mask forward (_fwd_kernel) is not ported yet (ROADMAP "
            "queue A, training slice)")
    if sq != sk:
        raise ValueError("causal flash_fwd requires sq == sk")
    if sq % block_q or sk % block_k:
        raise ValueError(f"S={sq} is not a multiple of the blocks "
                         f"({block_q}, {block_k})")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if q.is_cuda:
        if (block_q, block_k) != (BLOCK, BLOCK):
            raise ValueError(f"the CUDA kernel is square-tiled at {BLOCK}; "
                             f"got blocks ({block_q}, {block_k})")
        return flash_fwd_cuda(q, k, v, sm_scale, n_heads, n_kv_heads)
    if q.device.type != "cpu":
        raise ValueError(f"flash_fwd runs on CUDA or CPU tensors, not "
                         f"{q.device}")
    return flash_fwd_plain(q, k, v, sm_scale, n_heads, n_kv_heads)
