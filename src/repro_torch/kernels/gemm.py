"""M-invariant matrix product: plain version and CUDA kernel.

The serving path (``transformer.paged_step``) and the canonical forward
(``ModelConfig.canonical_reductions``) run every projection through
:func:`matmul`: ``x @ w`` with fp32 accumulation and an optional cast, or,
with ``shard_width``, the canonical virtual-shard fold of
``repro.dist.fold.canonical_row_dot`` (``K`` cut into ``shard_width``-wide
shards, each partial from 0 in fp32, added onto a running sum from 0 in
ascending shard order). The reference leaves these products to XLA; the port
needs its own because the serving contract needs a row's result to be the
same bits whatever M is and wherever the row sits, and neither cuBLAS (which
picks its kernel and split-K by M) nor ``torch.matmul`` on the CPU (whose
blocking changes with M) gives that.

CUDA tensors launch ``csrc/gemm.cu``: bf16 on the tensor cores, each output
one ``mma.sync`` chain over ascending K, no split-K; a CTA owns a strip of
16-64 columns (:func:`tile`, a function of K and N, never of M) and streams
its weights through a deep cp.async ring, its warps split over N; canonical
mode restarts the chain at each shard and adds the shards' partials in
ascending order. fp32 operands stay on the CUDA cores. Its first design,
``csrc/gemm_v1.cu`` (one 64×32 tile, warps split over M), stays as its bit
oracle: :func:`matmul_v1`, for ``chip_smoke.py`` and the gpu-marked tests
only. CPU tensors take :func:`matmul_plain`, whose row-invariant formulation
is one ``(1, K) @ (K, N)`` product per row (per row and shard in canonical
mode), so a row's bits never depend on M there either.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

F32 = torch.float32
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

# launches of the kernel; the wrapper adds one per launch and nothing else
# touches it
launches = 0


def _check(x, w, out_dtype, shard_width):
    if w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"matmul takes x (..., K) and w (K, N); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if shard_width < 0 or (shard_width and w.shape[0] % shard_width):
        raise ValueError(f"shard_width={shard_width} does not divide "
                         f"K={w.shape[0]}")
    if out_dtype not in (None, F32, torch.bfloat16):
        raise TypeError(f"out_dtype {out_dtype}: fp32 (None) or bfloat16")


def matmul_plain(x, w, out_dtype=None, shard_width: int = 0):
    """``x @ w`` in fp32, one ``(1, K) @ (K, N)`` product per row (the
    row-invariant formulation); with ``shard_width`` the canonical fold
    ``((0 + p_0) + p_1) + ...`` of per-shard fp32 partials."""
    _check(x, w, out_dtype, shard_width)
    k, n = w.shape
    xf = x.reshape(-1, k).to(F32)
    wf = w.to(F32)
    rows = []
    for i in range(xf.shape[0]):
        xi = xf[i:i + 1].clone()
        if shard_width:
            acc = torch.zeros((1, n), dtype=F32, device=x.device)
            for s in range(0, k, shard_width):
                acc = acc + xi[:, s:s + shard_width] @ wf[s:s + shard_width]
        else:
            acc = xi @ wf
        rows.append(acc)
    y = (torch.cat(rows) if rows else xf.new_zeros((0, n)))
    y = y.reshape(x.shape[:-1] + (n,))
    return y if out_dtype is None else y.to(out_dtype)


def _bind(fn):
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _lib():
    return _bind(build.load("gemm").dash_gemm)


@functools.lru_cache(maxsize=None)
def _lib_v1():
    return _bind(build.load("gemm_v1").dash_gemm)


def tile(k: int, n: int):
    """``(BN, BK)``: the bf16 tile ``csrc/gemm.cu`` launches for these
    widths (a function of K and N, never of M)."""
    fn = build.load("gemm").dash_gemm_tile
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2
    fn.restype = None
    bn, bk = ctypes.c_int(), ctypes.c_int()
    fn(k, n, ctypes.byref(bn), ctypes.byref(bk))
    return bn.value, bk.value


def _launch(fn, x, w, out_dtype, shard_width):
    _check(x, w, out_dtype, shard_width)
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("matmul_cuda needs x and w on one CUDA device")
    if x.dtype not in KERNEL_DTYPES or w.dtype != x.dtype:
        raise TypeError(f"matmul_cuda takes x and w of one dtype of "
                        f"{KERNEL_DTYPES}; got {x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("matmul_cuda needs contiguous x and w")
    k, n = w.shape
    m = x.numel() // k
    bf16 = x.dtype == torch.bfloat16
    if bf16 and (k % 16 or n % 8 or shard_width % 16):
        raise ValueError(f"the bf16 kernel takes K and shard_width multiples "
                         f"of 16 and N a multiple of 8; got K={k}, N={n}, "
                         f"shard_width={shard_width}")
    if not bf16 and out_dtype == torch.bfloat16:
        raise TypeError("fp32 operands give an fp32 product")
    out = torch.empty(x.shape[:-1] + (n,), dtype=out_dtype or F32,
                      device=x.device)
    if m == 0:
        return out, False
    if bf16 and (x.data_ptr() | w.data_ptr() | out.data_ptr()) % 16:
        raise ValueError("the bf16 kernel needs 16-byte aligned operands")
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k,
                 shard_width, int(bf16), int(out.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gemm CUDA kernel failed to launch: cudaError "
                           f"{err}")
    return out, True


def matmul_cuda(x, w, out_dtype=None, shard_width: int = 0):
    """Launch ``csrc/gemm.cu`` on PyTorch's current stream. Raises on
    anything the kernel does not take: operands on different devices, of
    different dtypes or other than bf16/fp32, not contiguous, bf16 with K or
    ``shard_width`` not a multiple of 16 or N not a multiple of 8, a bf16
    output of fp32 operands."""
    global launches
    out, launched = _launch(_lib(), x, w, out_dtype, shard_width)
    launches += launched
    return out


def matmul_v1(x, w, out_dtype=None, shard_width: int = 0):
    """The kernel's first design, ``csrc/gemm_v1.cu``, kept as its bit
    oracle: for every input :func:`matmul_cuda` must return these bits.
    Only ``chip_smoke.py`` and the gpu-marked tests call it; it counts in no
    launch counter."""
    return _launch(_lib_v1(), x, w, out_dtype, shard_width)[0]


def matmul(x, w, out_dtype=None, shard_width: int = 0):
    """``x (..., K) @ w (K, N)`` with fp32 accumulation → (..., N) in fp32 or
    ``out_dtype``; ``shard_width > 0`` takes the canonical fold form. The
    kernel for CUDA tensors, :func:`matmul_plain` for CPU tensors."""
    if x.is_cuda:
        return matmul_cuda(x, w, out_dtype, shard_width)
    if x.device.type != "cpu":
        raise ValueError(f"matmul runs on CUDA or CPU tensors, not {x.device}")
    return matmul_plain(x, w, out_dtype, shard_width)
