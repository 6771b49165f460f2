"""Row reductions: the row norm and the row log-softmax with argmax.

The serving path and the canonical forward normalise through :func:`norm`
(``layers.apply_norm``: LayerNorm with a bias, else RMSNorm) and the
continuous engine's sampler takes :func:`log_softmax_argmax` over each row
of logits. The reference leaves both to XLA; the port needs its own because
the serving contract needs a row's bits to be the same whatever the number of
rows in the call, and PyTorch's CUDA reductions pick their thread layout by
the number of rows.

CUDA tensors launch ``csrc/rows.cu`` (one CTA a row, a block size and
reduction tree fixed per kernel); CPU tensors take the plain versions, which
compute each row alone (the row-invariant formulation: a row's reduction
then never sees how many rows the call holds).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

F32 = torch.float32

# launches of the two kernels; the wrappers add one per launch and nothing
# else touches them
launches_norm = 0
launches_log_softmax = 0


def _norm_row(xf, scale, bias, eps):
    if bias is not None:
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        return (xf - mu) * torch.rsqrt(var + eps) * scale + bias
    ms = xf.square().mean(-1, keepdim=True)
    return xf * torch.rsqrt(ms + eps) * scale


def norm_plain(x, scale, bias=None, eps: float = 1e-5):
    """``layers.apply_norm``'s arithmetic in fp32, one row at a time; the
    result in x's dtype."""
    d = x.shape[-1]
    xf = x.reshape(-1, d).to(F32)
    rows = [_norm_row(xf[i:i + 1].clone(), scale, bias, eps)
            for i in range(xf.shape[0])]
    y = torch.cat(rows) if rows else xf
    return y.reshape(x.shape).to(x.dtype)


def log_softmax_argmax_plain(x):
    """Per row of fp32 ``x (M, V)``: ``(x - max) - log(sum(exp(x - max)))``
    and the argmax (the lowest index among equal maxima), one row at a
    time. Returns (log-softmax (M, V) fp32, argmax (M,) int64)."""
    outs, args = [], []
    for i in range(x.shape[0]):
        row = x[i:i + 1].to(F32).clone()
        shifted = row - row.amax(-1, keepdim=True)
        outs.append(shifted - torch.log(torch.exp(shifted).sum(-1,
                                                                keepdim=True)))
        args.append(torch.argmax(row, -1))
    if not outs:
        return x.to(F32), torch.zeros((0,), dtype=torch.int64,
                                      device=x.device)
    return torch.cat(outs), torch.cat(args)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("rows")
    norm_fn = lib.dash_row_norm
    norm_fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    norm_fn.restype = ctypes.c_int
    lsm = lib.dash_row_log_softmax
    lsm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    lsm.restype = ctypes.c_int
    return norm_fn, lsm


def norm_cuda(x, scale, bias=None, eps: float = 1e-5):
    """Launch the row norm of ``csrc/rows.cu``. x: (..., d) bf16 or fp32,
    contiguous; scale (and bias, LayerNorm) (d,) fp32 on x's device."""
    global launches_norm
    d = x.shape[-1]
    params = [scale] + ([] if bias is None else [bias])
    if not (x.is_cuda and all(p.device == x.device for p in params)):
        raise ValueError("norm_cuda needs x, scale and bias on one CUDA "
                         "device")
    if x.dtype not in (torch.bfloat16, F32) or any(
            p.dtype != F32 or p.shape != (d,) or not p.is_contiguous()
            for p in params):
        raise TypeError(f"norm_cuda takes bf16/fp32 x and fp32 (d,) scale "
                        f"and bias; got {x.dtype}, "
                        f"{[(p.dtype, tuple(p.shape)) for p in params]}")
    if not x.is_contiguous():
        raise ValueError("norm_cuda needs a contiguous x")
    y = torch.empty_like(x)
    m = x.numel() // d
    if m == 0:
        return y
    with torch.cuda.device(x.device):
        err = _lib()[0](x.data_ptr(), scale.data_ptr(),
                        None if bias is None else bias.data_ptr(),
                        y.data_ptr(), m, d, eps,
                        int(x.dtype == torch.bfloat16),
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"row norm CUDA kernel failed to launch: "
                           f"cudaError {err}")
    launches_norm += 1
    return y


def log_softmax_argmax_cuda(x):
    """Launch the row log-softmax of ``csrc/rows.cu`` on fp32 ``x (M, V)``
    (contiguous). Returns (log-softmax (M, V) fp32, argmax (M,) int64)."""
    global launches_log_softmax
    if not x.is_cuda:
        raise ValueError("log_softmax_argmax_cuda needs a CUDA tensor")
    if x.dtype != F32 or x.dim() != 2 or not x.is_contiguous():
        raise TypeError(f"log_softmax_argmax_cuda takes contiguous fp32 "
                        f"(M, V) logits; got {x.dtype} {tuple(x.shape)}")
    out = torch.empty_like(x)
    arg = torch.empty((x.shape[0],), dtype=torch.int64, device=x.device)
    if x.shape[0] == 0:
        return out, arg
    with torch.cuda.device(x.device):
        err = _lib()[1](x.data_ptr(), out.data_ptr(), arg.data_ptr(),
                        x.shape[0], x.shape[1],
                        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"row log-softmax CUDA kernel failed to launch: "
                           f"cudaError {err}")
    launches_log_softmax += 1
    return out, arg


def norm(x, scale, bias=None, eps: float = 1e-5):
    """LayerNorm (``bias`` given) or RMSNorm over the last axis in fp32, the
    result in x's dtype: the kernel for CUDA tensors, :func:`norm_plain` for
    CPU tensors."""
    if x.is_cuda:
        return norm_cuda(x, scale, bias, eps)
    if x.device.type != "cpu":
        raise ValueError(f"norm runs on CUDA or CPU tensors, not {x.device}")
    return norm_plain(x, scale, bias, eps)


def log_softmax_argmax(x):
    """Row log-softmax and argmax of fp32 logits ``x (M, V)``: the kernel for
    CUDA tensors, :func:`log_softmax_argmax_plain` for CPU tensors."""
    if x.is_cuda:
        return log_softmax_argmax_cuda(x)
    if x.device.type != "cpu":
        raise ValueError(f"log_softmax_argmax runs on CUDA or CPU tensors, "
                         f"not {x.device}")
    return log_softmax_argmax_plain(x)
