"""Batch-invariant paged attention (fixed page reduction order).

Counterpart of ``repro.kernels.decode``. The continuous engine's contract (a
request's tokens are bitwise the same whatever it is batched with, however
its prompt was chunked, wherever its pages sit) rests on one property of the
attention: a query row's result is a function of that row's own query and
KV history. The page walk is serialized as ascending page-table position
(:func:`page_reduction_order`), and masked lanes add exact zeros, so

  * the physical page ids behind a sequence (the walk indirects through the
    page table),
  * the other rows of the batch (every step is row-independent),
  * trailing unallocated pages (a page with no live lane leaves the
    ``(m, l, acc)`` carry bitwise unchanged: ``max(m, -1e30) = m``,
    ``l·1 + 0``, ``acc·1 + 0``)

cannot reach a row's bits. Math is fp32; the output takes q's dtype. One
entry point serves one-token decode (``q: (B, 1, H, D)``), chunked prefill
(``q: (1, C, H, D)``) and the canonical forward (``(B, S)`` over trivially
paged pools).

CUDA tensors launch ``csrc/paged_attn.cu``: one CTA per (row b, KV head,
tile of 8 query rows) walks its rows' pages in chunks of up to 128
positions, K/V in flight through a cp.async ring, every thread on each phase
of a chunk (scores, page maxima and the running max, p, each page's sum p
and p·v) and one carry per (row, d) in ascending page order; it is bound by
the serial phases of a chunk, not yet by the bytes. Its first design,
``csrc/paged_attn_v1.cu`` (one warp walked one query row), stays as its bit
oracle: :func:`paged_attention_v1`, for ``chip_smoke.py`` and the gpu-marked
tests only. CPU tensors take :func:`paged_attention_plain`, the reference's
walk written with explicit ascending loops over the head dimension and over a
page's positions (the row-invariant formulation: the CPU's batched products
change their summation with the shape).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build

NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)
MAX_PAGE_SIZE = 64
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
F32 = torch.float32

# launches of the kernel; the wrapper adds one per launch and nothing else
# touches it
launches = 0


def page_reduction_order(max_pages: int) -> np.ndarray:
    """The serialized page accumulation order: ascending page-table
    position (logical page ``j`` holds positions ``[j·ps, (j+1)·ps)``)."""
    return np.arange(max_pages, dtype=np.int32)


def _check(q, k_pages, v_pages, page_table, q_positions, window, q_segments,
           kv_segments):
    b, l, h, d = q.shape
    n_pages, page_size, hk, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d:
        raise ValueError(f"pools {tuple(k_pages.shape)}/{tuple(v_pages.shape)}"
                         f" do not match q {tuple(q.shape)}")
    if hk <= 0 or h % hk:
        raise ValueError(f"query heads {h} are not a multiple of KV heads "
                         f"{hk}")
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError(f"page_table {tuple(page_table.shape)} is not "
                         f"(B={b}, max_pages)")
    if tuple(q_positions.shape) != (b, l):
        raise ValueError(f"q_positions {tuple(q_positions.shape)} is not "
                         f"({b}, {l})")
    if (q_segments is None) != (kv_segments is None):
        raise ValueError("segment masking needs both q_segments and "
                         "kv_segments")
    if q_segments is not None and (
            tuple(q_segments.shape) != (b, l)
            or tuple(kv_segments.shape) != (n_pages, page_size)):
        raise ValueError(f"segments {tuple(q_segments.shape)}/"
                         f"{tuple(kv_segments.shape)} are not ({b}, {l})/"
                         f"({n_pages}, {page_size})")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")


def paged_attention_plain(q, k_pages, v_pages, page_table, q_positions,
                          sm_scale: float, window: Optional[int] = None,
                          q_segments=None, kv_segments=None):
    """The reference's page walk in fp32, with each sum an explicit ascending
    loop: ``q·k`` over the head dimension, ``sum p`` and ``p·v`` over the
    page's positions. Pages that hold no live lane for any row are skipped
    (a bitwise identity, see the module docstring)."""
    b, l, h, d = q.shape
    n_pages, ps, hk, _ = k_pages.shape
    g = h // hk
    max_pages = page_table.shape[1]
    dev = q.device
    qf = q.to(F32).reshape(b, l, hk, g, d) * sm_scale
    qpos = q_positions.to(torch.int64)[:, :, None, None, None]
    in_page = torch.arange(ps, device=dev)
    m = torch.full((b, l, hk, g), NEG_INF, dtype=F32, device=dev)
    s_sum = torch.zeros((b, l, hk, g), dtype=F32, device=dev)
    acc = torch.zeros((b, l, hk, g, d), dtype=F32, device=dev)
    hi = int(q_positions.max()) if q_positions.numel() else -1
    lo = 0
    if window is not None and q_positions.numel():
        lo = max(0, int(q_positions.min()) - window + 1)
    for j in page_reduction_order(max_pages):
        if j * ps > hi or (j + 1) * ps - 1 < lo:
            continue                      # no live lane in any row
        phys = page_table[:, j].to(torch.int64)
        kp = k_pages[phys].to(F32).permute(0, 2, 3, 1)    # (B, Hk, D, ps)
        vp = v_pages[phys].to(F32)                        # (B, ps, Hk, D)
        kv_pos = int(j) * ps + in_page
        mask = kv_pos <= qpos                             # (B, L, 1, 1, ps)
        if window is not None:
            mask = mask & (kv_pos > qpos - window)
        if q_segments is not None:
            seg = kv_segments[phys]                       # (B, ps)
            mask = mask & (q_segments[:, :, None, None, None]
                           == seg[:, None, None, None, :])
        scores = torch.zeros((b, l, hk, g, ps), dtype=F32, device=dev)
        for e in range(d):
            scores = scores + qf[..., e, None] * kp[:, None, :, None, e, :]
        s_masked = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
        m_new = torch.maximum(m, s_masked.amax(-1))
        p = torch.where(mask, torch.exp(s_masked - m_new[..., None]),
                        torch.zeros_like(s_masked))
        corr = torch.exp(m - m_new)
        psum = torch.zeros_like(s_sum)
        pv = torch.zeros_like(acc)
        for s in range(ps):
            psum = psum + p[..., s]
            v_s = vp[:, s][:, None, :, None, :]           # (B, 1, Hk, 1, D)
            pv = pv + torch.where(mask[..., s, None], p[..., s, None] * v_s,
                                  torch.zeros_like(pv))
        s_sum = s_sum * corr + psum
        acc = acc * corr[..., None] + pv
        m = m_new
    denom = torch.where(s_sum == 0.0, torch.ones_like(s_sum), s_sum)
    out = acc / denom[..., None]
    return out.reshape(b, l, h, d).to(q.dtype)


def _bind(fn):
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _lib():
    return _bind(build.load("paged_attn").dash_paged_attention)


@functools.lru_cache(maxsize=None)
def _lib_v1():
    return _bind(build.load("paged_attn_v1").dash_paged_attention)


def _int32(t, name):
    if t.dtype != torch.int32 or not t.is_contiguous():
        raise TypeError(f"{name} must be contiguous int32, got {t.dtype}")
    return t


def _launch(fn, q, k_pages, v_pages, page_table, q_positions, sm_scale,
            window, q_segments, kv_segments):
    tensors = [q, k_pages, v_pages, page_table, q_positions] + [
        t for t in (q_segments, kv_segments) if t is not None]
    if not (q.is_cuda and all(t.device == q.device for t in tensors)):
        raise ValueError("paged_attention_cuda needs every operand on one "
                         "CUDA device")
    if q.dtype not in KERNEL_DTYPES or not (
            k_pages.dtype == v_pages.dtype == q.dtype):
        raise TypeError(f"paged_attention_cuda takes q and pools of one dtype "
                        f"of {KERNEL_DTYPES}; got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    for name, t in (("page_table", page_table), ("q_positions", q_positions),
                    ("q_segments", q_segments), ("kv_segments", kv_segments)):
        if t is not None:
            _int32(t, name)
    if not all(t.is_contiguous() for t in (q, k_pages, v_pages)):
        raise ValueError("paged_attention_cuda needs contiguous q and pools")
    b, l, h, d = q.shape
    n_pages, ps, hk, _ = k_pages.shape
    if d not in HEAD_DIMS or ps > MAX_PAGE_SIZE:
        raise ValueError(f"paged_attention_cuda takes head_dim in {HEAD_DIMS}"
                         f" and page_size <= {MAX_PAGE_SIZE}; got head_dim="
                         f"{d}, page_size={ps}")
    if (q.data_ptr() | k_pages.data_ptr() | v_pages.data_ptr()) % 16:
        raise ValueError("paged_attention_cuda needs 16-byte aligned q and "
                         "pools")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out, False
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), q_positions.data_ptr(),
            None if q_segments is None else q_segments.data_ptr(),
            None if kv_segments is None else kv_segments.data_ptr(),
            out.data_ptr(), b, l, h, hk, d, ps, page_table.shape[1],
            sm_scale, window or 0, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention CUDA kernel failed to launch: "
                           f"cudaError {err}")
    return out, True


def paged_attention_cuda(q, k_pages, v_pages, page_table, q_positions,
                         sm_scale: float, window: Optional[int] = None,
                         q_segments=None, kv_segments=None):
    """Launch ``csrc/paged_attn.cu`` on PyTorch's current stream. Raises on
    anything the kernel does not take: tensors off one CUDA device, dtypes
    other than one of bf16/fp32 for q and pools and int32 for the index
    arrays, non-contiguous operands, a head dim outside :data:`HEAD_DIMS`, a
    page size above :data:`MAX_PAGE_SIZE`."""
    global launches
    out, launched = _launch(_lib(), q, k_pages, v_pages, page_table,
                            q_positions, sm_scale, window, q_segments,
                            kv_segments)
    launches += launched
    return out


def paged_attention_v1(q, k_pages, v_pages, page_table, q_positions,
                       sm_scale: float, window: Optional[int] = None,
                       q_segments=None, kv_segments=None):
    """The kernel's first design, ``csrc/paged_attn_v1.cu``, kept as its bit
    oracle: for every input :func:`paged_attention_cuda` must return these
    bits. Only ``chip_smoke.py`` and the gpu-marked tests call it; it counts
    in no launch counter."""
    return _launch(_lib_v1(), q, k_pages, v_pages, page_table, q_positions,
                   sm_scale, window, q_segments, kv_segments)[0]


def paged_attention(q, k_pages, v_pages, page_table, q_positions,
                    sm_scale: Optional[float] = None, *,
                    window: Optional[int] = None,
                    q_segments=None, kv_segments=None):
    """Attention over a paged KV pool, batch-invariant per query row (the
    reference's signature and layout).

    Args:
      q: (B, L, H, D) queries (L=1 decode; L=chunk prefill).
      k_pages, v_pages: (P, page_size, Hk, D) page pools; query head
        ``h = kv·g + i`` reads KV head ``kv`` (``g = H / Hk``).
      page_table: (B, max_pages) int32 physical page per logical page
        (entries past a row's allocation may be any valid id: masked out).
      q_positions: (B, L) int32 absolute position of each query; a row
        attends to logical positions ``<= q_positions[b, l]``.
      sm_scale: softmax scale (default 1/sqrt(D)).
      window: optional sliding window: positions ``> q_position - window``.
      q_segments: optional (B, L) int32 document ids; kv_segments (P,
        page_size) int32 per pool token; both or neither.

    Returns (B, L, H, D) in q's dtype: the kernel for CUDA tensors,
    :func:`paged_attention_plain` for CPU tensors.
    """
    _check(q, k_pages, v_pages, page_table, q_positions, window, q_segments,
           kv_segments)
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return paged_attention_cuda(q, k_pages, v_pages, page_table,
                                    q_positions, sm_scale, window, q_segments,
                                    kv_segments)
    if q.device.type != "cpu":
        raise ValueError(f"paged_attention runs on CUDA or CPU tensors, not "
                         f"{q.device}")
    return paged_attention_plain(q, k_pages, v_pages, page_table, q_positions,
                                 sm_scale, window, q_segments, kv_segments)


def gather_kv(pages, page_table, seq_len: int):
    """Contiguous (B, seq_len, Hk, D) K or V from a paged pool (a test and
    yardstick helper: the serving path never forms this array). Rows with
    shorter live sequences carry stale pool content past their length."""
    n_pages, page_size, hk, d = pages.shape
    need = -(-seq_len // page_size)
    flat = pages[page_table[:, :need].to(torch.int64)]   # (B, need, ps, Hk, D)
    b = page_table.shape[0]
    return flat.reshape(b, need * page_size, hk, d)[:, :seq_len]
