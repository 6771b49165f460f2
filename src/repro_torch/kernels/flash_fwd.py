"""Flash-attention forward, causal and full mask: task grid, plain version
and CUDA kernels.

Counterpart of ``repro.kernels.flash_fwd`` for the causal and the full mask.
The TPU kernel ``_fwd_sched_kernel`` walks the task list of
:func:`causal_grid` (descending q tiles, kv ascending within a q tile, fully
masked tiles never visited) on a sequential grid axis; ``_fwd_kernel`` walks
the dense ``(bh, n_q, n_k)`` grid. On the card both become one kernel
template in ``csrc/flash_fwd.cu``: one CTA per (bh, q tile), q tiles
launched in descending order, the kv loop inside the CTA ascending and, when
causal, stopping at the diagonal tile (see the note in the source).

:func:`flash_fwd` validates, then runs the kernel for CUDA tensors and the
plain version (:func:`flash_fwd_plain`, a dense softmax in fp32) for CPU
tensors — never one in place of the other. The block-sparse forward
(``_fwd_mask_kernel``) is not ported yet.
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

# launches of the causal and of the full-mask CUDA kernel; the wrapper adds
# one per launch and nothing else touches them, so a caller can zero them
# and read how often a run used each kernel
launches = 0
launches_full = 0


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


def flash_fwd_plain(q, k, v, sm_scale, n_heads, n_kv_heads, causal=True):
    """Attention as a (masked) dense softmax in fp32 (any device): the
    oracle ``ref.mha_fwd`` on K/V gathered per query head.

    q (BH, Sq, D); k, v (B·Hk, Sk, D). Returns out (BH, Sq, D) in q's dtype
    and lse (BH, Sq) fp32 — the function the CUDA kernels compute.
    """
    kv = kv_head_index(torch.arange(q.shape[0], device=q.device), n_heads,
                       n_kv_heads)
    return ref.mha_fwd(q, k[kv], v[kv], causal=causal, sm_scale=sm_scale)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("flash_fwd")
    causal = lib.dash_flash_fwd_causal
    causal.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    causal.restype = ctypes.c_int
    full = lib.dash_flash_fwd_full
    full.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    full.restype = ctypes.c_int
    return causal, full


def flash_fwd_cuda(q, k, v, sm_scale, n_heads, n_kv_heads, causal=True):
    """Launch ``csrc/flash_fwd.cu`` (causal or full-mask entry point) on
    PyTorch's current stream.

    Raises on anything the kernel does not take instead of computing it
    another way. Returns (out, lse) like :func:`flash_fwd_plain`.
    """
    global launches, launches_full
    bh, s, d = q.shape
    sk = k.shape[1]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_fwd_cuda needs q, k and v on one CUDA device")
    if q.dtype not in KERNEL_DTYPES or not (k.dtype == v.dtype == q.dtype):
        raise TypeError(f"flash_fwd_cuda takes one dtype of {KERNEL_DTYPES} "
                        f"for q, k, v; got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in HEAD_DIMS or s % BLOCK or sk % BLOCK:
        raise ValueError(f"flash_fwd_cuda takes head_dim in {HEAD_DIMS} and S "
                         f"a multiple of {BLOCK}; got S={s}/{sk}, "
                         f"head_dim={d}")
    if causal and sk != s:
        raise ValueError("the causal kernel takes sq == sk")
    if k.shape != v.shape or k.shape != (bh // n_heads * n_kv_heads, sk, d):
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} at heads {n_heads}/{n_kv_heads}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd_cuda needs contiguous q, k, v")
    fn_causal, fn_full = _lib()
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr())
    is_bf16 = int(q.dtype == torch.bfloat16)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if causal:
            err = fn_causal(*ptrs, bh, s, d, n_heads, n_kv_heads, sm_scale,
                            is_bf16, stream)
        else:
            err = fn_full(*ptrs, bh, s, sk, d, n_heads, n_kv_heads, sm_scale,
                          is_bf16, stream)
    if err:
        raise RuntimeError(f"flash_fwd CUDA kernel failed to launch: "
                           f"cudaError {err}")
    if causal:
        launches += 1
    else:
        launches_full += 1
    return out, lse


def flash_fwd(q, k, v, causal=False, sm_scale=None, block_q=128, block_k=128,
              n_heads: Optional[int] = None, n_kv_heads: Optional[int] = None):
    """Flash attention forward (causal or full mask).

    Args:   q: (BH, Sq, D); k, v: (B·Hk, Sk, D) — pass ``n_heads``/
            ``n_kv_heads`` when the head counts differ (native GQA; no KV
            repetition). Sq, Sk divisible by the block sizes; causal needs
            Sq == Sk.
    Returns: out (BH, Sq, D) q.dtype, lse (BH, Sq) fp32.

    CUDA tensors go through the kernels (block 128 only); CPU tensors
    through :func:`flash_fwd_plain`.
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
    if causal and sq != sk:
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
        return flash_fwd_cuda(q, k, v, sm_scale, n_heads, n_kv_heads, causal)
    if q.device.type != "cpu":
        raise ValueError(f"flash_fwd runs on CUDA or CPU tensors, not "
                         f"{q.device}")
    return flash_fwd_plain(q, k, v, sm_scale, n_heads, n_kv_heads, causal)
