"""The sLSTM recurrence: plain version, CUDA kernel, dispatch.

Counterpart of the ``lax.scan`` of ``repro.models.xlstm.apply_slstm``
(``:128-145``). For the four fp32 pre-activations ``z = (z_i, z_f, z_z,
z_o)`` (B, S, H, hd) (the input projections plus their biases), the
recurrent matrices ``r = (r_i, r_f, r_z, r_o)`` (H, hd, hd) in the model
dtype (used as fp32) and the carried state ``(c, n, h, m)`` (B, H, hd)
fp32, per step, with ``h r_g`` the sum over e of h[e] r_g[e, v]:

    i = z_i + h r_i,  f = z_f + h r_f,  m' = max(log_sigmoid(f) + m, i)
    c = exp(log_sigmoid(f) + m - m') c + exp(i - m') tanh(z_z + h r_z)
    n = exp(log_sigmoid(f) + m - m') n + exp(i - m')
    h = sigmoid(z_o + h r_o) c / max(n, 1e-6)

returning every step's h (B, S, H, hd) fp32 and the last state.
``csrc/slstm.cu`` runs all S steps in one launch, a head's two batch rows
on a cluster of hd / 32 CTAs (hd 32 or 256); its first design,
``csrc/slstm_v1.cu`` (a (b, h) a cluster, :func:`slstm_v1_cuda`), is kept
as its bit oracle: the redesign returns its h_all and state bitwise.
:func:`slstm` takes the plain version for CPU tensors and launches the
kernel for CUDA tensors (raising for anything it does not take), never one
in place of the other; on the card the kernel runs inside a
``torch.autograd.Function`` whose backward raises (the backward kernel
comes with xLSTM training, ROADMAP A8). The plain version is
differentiable by autograd.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.mlstm import ALIGN, DTYPES, HEAD_DIMS

F32 = torch.float32
TRAINING = ("the sLSTM kernel has no backward yet: it comes with xLSTM "
            "training (ROADMAP A8, 'xLSTM training')")

# launches of the CUDA kernel; the wrapper adds one per launch and nothing
# else touches it
launches = 0


def slstm_plain(z, r, state):
    """The recurrence one step at a time: returns ``(h_all, (c, n, h,
    m))``."""
    c, n, h, m = state
    zi, zf, zz, zo = z
    ri, rf, rz, ro = (x.to(F32) for x in r)
    outs = []
    for t in range(zi.shape[1]):
        it = zi[:, t] + torch.einsum("bhe,hev->bhv", h, ri)
        ft = zf[:, t] + torch.einsum("bhe,hev->bhv", h, rf)
        lsf = F.logsigmoid(ft)
        m_new = torch.maximum(lsf + m, it)
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(lsf + m - m_new)
        c = f_ * c + i_ * torch.tanh(zz[:, t] + torch.einsum(
            "bhe,hev->bhv", h, rz))
        n = f_ * n + i_
        h = torch.sigmoid(zo[:, t] + torch.einsum(
            "bhe,hev->bhv", h, ro)) * c / torch.clamp_min(n, 1e-6)
        m = m_new
        outs.append(h)
    return torch.stack(outs, 1), (c, n, h, m)


# --------------------------------------------------------------------------- #
# CUDA kernel (csrc/slstm.cu)
# --------------------------------------------------------------------------- #
def _bind(fn):
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _lib():
    return _bind(build.load("slstm").dash_slstm)


@functools.lru_cache(maxsize=None)
def _lib_v1():
    return _bind(build.load("slstm_v1").dash_slstm_v1)


def _check(z, r, state):
    """Raise for operands the kernel does not take."""
    zi = z[0]
    b, s, h, hd = zi.shape if zi.dim() == 4 else (0,) * 4
    tensors = (*z, *r, *state)
    if not all(t.is_cuda and t.device == zi.device for t in tensors):
        raise ValueError("the sLSTM kernel needs every operand on one CUDA "
                         "device")
    if any(t.dtype != F32 for t in (*z, *state)):
        raise TypeError("the sLSTM kernel takes fp32 pre-activations and "
                        "state")
    if r[0].dtype not in DTYPES or any(x.dtype != r[0].dtype for x in r):
        raise TypeError(f"the sLSTM kernel takes r_i, r_f, r_z, r_o of one "
                        f"dtype in {DTYPES}")
    bad = [tuple(t.shape) for t in z if tuple(t.shape) != (b, s, h, hd)]
    bad += [tuple(t.shape) for t in r if tuple(t.shape) != (h, hd, hd)]
    bad += [tuple(t.shape) for t in state if tuple(t.shape) != (b, h, hd)]
    if bad or hd not in HEAD_DIMS or s < 1 or b < 1:
        raise ValueError(f"the sLSTM kernel takes z (B, S, H, hd) with hd "
                         f"in {HEAD_DIMS}, r (H, hd, hd), state (B, H, hd); "
                         f"got z {tuple(zi.shape)}, mismatched {bad}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the sLSTM kernel needs contiguous operands")
    if any(t.data_ptr() % ALIGN for t in r):
        raise ValueError(f"the sLSTM kernel needs r_i, r_f, r_z, r_o aligned "
                         f"to {ALIGN} bytes")


def _launch(lib_fn, z, r, state):
    """Check the operands, then launch ``lib_fn()`` (the entry point, built
    at first use)."""
    _check(z, r, state)
    b, s, h, hd = z[0].shape
    out = torch.empty((b, s, h, hd), dtype=F32, device=z[0].device)
    new = tuple(torch.empty_like(t) for t in state)
    with torch.cuda.device(z[0].device):
        stream = torch.cuda.current_stream().cuda_stream
    err = lib_fn()(*(t.data_ptr() for t in (*z, *r, *state, out, *new)), b,
                   s, h, hd, int(r[0].dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"sLSTM kernel failed to launch: cudaError {err}")
    return out, new


def slstm_cuda(z, r, state):
    """Launch the kernel: returns ``(h_all, (c, n, h, m))``, the new state
    in new tensors."""
    global launches
    result = _launch(_lib, z, r, state)
    launches += 1
    return result


def slstm_v1_cuda(z, r, state):
    """The first design (``csrc/slstm_v1.cu``), kept as the bit oracle:
    :func:`slstm_cuda` must return these bits. Only the checks, the
    gpu-marked tests and ``scripts/xlstm_variants.py`` call it; it counts in
    no launch counter."""
    return _launch(_lib_v1, z, r, state)


PHASES = ("wait", "sum", "gate", "update", "push")
LAYOUT_KEYS = ("rows", "z_depth", "threads", "smem_bf16", "smem_fp32")


def layout(lib=None):
    """The kernel's build (``csrc/slstm.cu``): batch rows a cluster, steps
    of z in flight, threads a CTA, dynamic shared memory (bytes, hd =
    256)."""
    out = (ctypes.c_int * len(LAYOUT_KEYS))()
    (lib or build.load("slstm")).dash_slstm_layout(out)
    return dict(zip(LAYOUT_KEYS, out))


def slstm_phases(z, r, state):
    """One launch of the kernel built with ``-DDASH_STAMPS`` (its
    ``clock64()`` stamps; counted nowhere): per CTA and warp (warp w the
    (gate w % 4, half w // 4)) the clocks in each of :data:`PHASES` and in
    all, an int64 array (CTAs, 8, 6). The phases: waiting for the step's h,
    the sum over e, the gate (the halves, z and its nonlinearity, with the
    barriers), and in the warps that update a row (warps 0 and 4, the gate-i
    warp of each half) the state update and the push of h into the
    cluster."""
    lib = build.load("slstm", ("DASH_STAMPS",))
    _launch(lambda: _bind(lib.dash_slstm), z, r, state)
    torch.cuda.synchronize(z[0].device)
    b, _, h, hd = z[0].shape
    rows = layout(lib)["rows"]
    ctas, per = -(-b // rows) * h * (hd // 32), len(PHASES) + 1
    buf = (ctypes.c_longlong * (ctas * 8 * per))()
    if lib.dash_slstm_stamps(buf, len(buf)):
        raise RuntimeError("reading the sLSTM stamps failed")
    return np.frombuffer(buf, dtype=np.int64).reshape(ctas, 8, per).copy()


class _SLSTMFn(torch.autograd.Function):
    """The kernel; its backward raises (ROADMAP A8)."""

    @staticmethod
    def forward(ctx, zi, zf, zz, zo, ri, rf, rz, ro, c, n, h, m):
        out, new = slstm_cuda((zi, zf, zz, zo), (ri, rf, rz, ro),
                              (c, n, h, m))
        return (out, *new)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(TRAINING)


def slstm(z, r, state):
    """``(h_all, (c, n, h, m))`` of the recurrence (module docstring): the
    CUDA kernel for CUDA tensors, :func:`slstm_plain` for CPU tensors."""
    if z[0].is_cuda:
        out, *new = _SLSTMFn.apply(*z, *r, *state)
        return out, tuple(new)
    tensors = (*z, *r, *state)
    if any(t.device.type != "cpu" for t in tensors):
        raise ValueError(f"slstm runs on CUDA or CPU tensors, not "
                         f"{sorted({str(t.device) for t in tensors})}")
    return slstm_plain(z, r, state)
