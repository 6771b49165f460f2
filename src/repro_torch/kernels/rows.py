"""Row reductions: the row norm and the row log-softmax with argmax.

The serving path and the canonical forward normalise through :func:`norm`
(``layers.apply_norm``: LayerNorm with a bias, else RMSNorm) and the
continuous engine's sampler takes :func:`log_softmax_argmax` over each row
of logits. The reference leaves both to XLA; the port needs its own because
the serving contract needs a row's bits to be the same whatever the number of
rows in the call, and PyTorch's CUDA reductions pick their thread layout by
the number of rows.

CUDA tensors launch ``csrc/rows.cu``, whose reduction tree is fixed by the
row's width alone: the norm one CTA of 256 threads a row, each thread's
elements of x, scale and bias held in registers (d up to
:data:`NORM_MAX_WIDTH`); the log-softmax one thread-block cluster of 16
CTAs a row, its 1024 chains spread over them with 4 threads a chain, the
row staged once in shared memory and the warp partials pushed into every
CTA over distributed shared memory. Both launch programmatically: a launch
may start while the kernel before it drains. Their first design,
``csrc/rows_v1.cu`` (one CTA a row reading every pass from device
memory), stays as their bit oracle:
:func:`norm_v1` and :func:`log_softmax_argmax_v1`, for ``chip_smoke.py``
and the gpu-marked tests only. CPU tensors take the plain versions, which
compute each row alone (the row-invariant formulation: a row's reduction
then never sees how many rows the call holds).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

F32 = torch.float32

# the widest row csrc/rows.cu's norm takes (32 elements a thread)
NORM_MAX_WIDTH = 8192

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


def _bind(lib):
    norm_fn = lib.dash_row_norm
    norm_fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    norm_fn.restype = ctypes.c_int
    lsm = lib.dash_row_log_softmax
    lsm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    lsm.restype = ctypes.c_int
    return norm_fn, lsm


@functools.lru_cache(maxsize=None)
def _lib():
    return _bind(build.load("rows"))


@functools.lru_cache(maxsize=None)
def _lib_v1():
    return _bind(build.load("rows_v1"))


def _launch_norm(fn, x, scale, bias, eps, max_width=None):
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
    if max_width is not None and d > max_width:
        raise ValueError(f"norm_cuda takes rows up to {max_width} wide; got "
                         f"d={d}")
    y = torch.empty_like(x)
    m = x.numel() // d
    if m == 0:
        return y, False
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), scale.data_ptr(),
                 None if bias is None else bias.data_ptr(), y.data_ptr(), m,
                 d, eps, int(x.dtype == torch.bfloat16),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"row norm CUDA kernel failed to launch: "
                           f"cudaError {err}")
    return y, True


def _launch_log_softmax(fn, x, max_rows=None):
    if not x.is_cuda:
        raise ValueError("log_softmax_argmax_cuda needs a CUDA tensor")
    if x.dtype != F32 or x.dim() != 2 or not x.is_contiguous():
        raise TypeError(f"log_softmax_argmax_cuda takes contiguous fp32 "
                        f"(M, V) logits; got {x.dtype} {tuple(x.shape)}")
    if max_rows is not None and x.shape[0] > max_rows:
        raise ValueError(f"log_softmax_argmax_cuda takes up to {max_rows} "
                         f"rows a call; got {x.shape[0]}")
    out = torch.empty_like(x)
    arg = torch.empty((x.shape[0],), dtype=torch.int64, device=x.device)
    if x.shape[0] == 0:
        return out, arg, False
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), out.data_ptr(), arg.data_ptr(), x.shape[0],
                 x.shape[1], torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"row log-softmax CUDA kernel failed to launch: "
                           f"cudaError {err}")
    return out, arg, True


def norm_cuda(x, scale, bias=None, eps: float = 1e-5):
    """Launch the row norm of ``csrc/rows.cu``. x: (..., d) bf16 or fp32,
    contiguous, d at most :data:`NORM_MAX_WIDTH`; scale (and bias,
    LayerNorm) (d,) fp32 on x's device."""
    global launches_norm
    y, launched = _launch_norm(_lib()[0], x, scale, bias, eps,
                               NORM_MAX_WIDTH)
    launches_norm += launched
    return y


def norm_v1(x, scale, bias=None, eps: float = 1e-5):
    """The norm's first design, ``csrc/rows_v1.cu``, kept as its bit
    oracle: for every input :func:`norm_cuda` must return these bits. Only
    ``chip_smoke.py`` and the gpu-marked tests call it; it counts in no
    launch counter."""
    return _launch_norm(_lib_v1()[0], x, scale, bias, eps)[0]


def log_softmax_argmax_cuda(x):
    """Launch the row log-softmax of ``csrc/rows.cu`` on fp32 ``x (M, V)``
    (contiguous, M at most 65535): one thread-block cluster a row. Returns
    (log-softmax (M, V) fp32, argmax (M,) int64). A refused cluster launch
    raises."""
    global launches_log_softmax
    out, arg, launched = _launch_log_softmax(_lib()[1], x, 65535)
    launches_log_softmax += launched
    return out, arg


def log_softmax_argmax_v1(x):
    """The log-softmax's first design, ``csrc/rows_v1.cu``, kept as its bit
    oracle: for every input :func:`log_softmax_argmax_cuda` must return
    these bits. Only ``chip_smoke.py`` and the gpu-marked tests call it; it
    counts in no launch counter."""
    return _launch_log_softmax(_lib_v1()[1], x)[:2]


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
