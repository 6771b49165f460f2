"""The Mamba selective scan: plain version, CUDA kernels and their autograd.

Counterpart of the SSM core of ``repro.models.mamba.apply_mamba``, which XLA
computes as a ``lax.scan`` over chunks of an ``associative_scan``
(``_ssm_scan_chunked``) for prefill and training and as a sequential
``lax.scan`` for the decode step. For ``u``, ``dt`` (B, S, Din) fp32, ``A``
(Din, N) fp32, ``B``, ``C`` (B, S, N) fp32, ``D`` (Din,) fp32, ``z`` (B, S,
Din) in the model dtype and the carried state ``h0`` (B, Din, N) fp32:

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * u_t) * B_t
    y_t = (sum_n h_t[:, n] * C_t[n] + D * u_t) * silu(z_t)

returned as ``y`` in ``z``'s dtype and the last state ``h_S`` (fp32). The
(B, S, Din, N) states are never kept: :func:`selective_scan_plain` walks the
steps one at a time, and ``csrc/selective_scan.cu`` holds a channel's N
states in registers, split over 2 lanes of a warp, fed by a ring of TMA
tensor copies. Its forward gives the first design's
(``csrc/selective_scan_v1.cu``, kept as the bit oracle:
:func:`scan_fwd_v1_cuda`, :func:`scan_bwd_partials_v1_cuda`) ``h_last`` and
kept states bitwise; y and the gradients differ from it by the order of the
sums over the 16 states and over the channels.

:func:`selective_scan` takes the plain version for CPU tensors and launches
the kernels for CUDA tensors (raising for a shape they do not take: N other
than 16, Din not a multiple of 128), never one in place of the other. Its
gradient (``torch.autograd.Function``) is the backward kernel: a reverse
scan per chunk of ``chunk`` steps that recomputes the states from the ones
the forward kept every ``chunk`` steps, then an ordered fold of the
per-CTA partials of dB and dC (over channels) and of dA and dD (over the
batch). ``chunk`` (``cfg.ssm_chunk``) trades memory for recomputation and
changes no result: the sums' order depends on none of S, chunk, B or where a
launch starts. ``h0`` takes no gradient (the model starts every
sequence from a state without one).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

F32 = torch.float32
STATE = 16          # the state size N the kernels take
CHANNELS = 128      # channels a CTA of the kernels (Din must be a multiple)
SUB = 16            # steps the backward recomputes on chip at once
ALIGN = 16          # bytes the kernels' vector loads and TMA copies need

# launches of each CUDA kernel; the wrappers add one per launch and nothing
# else touches them
launches_fwd = 0
launches_bwd = 0
launches_fold = 0


def _silu(x):
    return x * torch.sigmoid(x)


def selective_scan_plain(u, dt, A, B, C, D, z, h0):
    """The sequential recurrence in PyTorch, one step at a time: returns
    ``(y, h_last)``. Differentiable by autograd (which keeps each step's
    (B, Din, N) states: at full width use it at lengths that fit)."""
    h = h0
    dtu = dt * u
    ys = []
    for t in range(u.shape[1]):
        a = torch.exp(dt[:, t, :, None] * A)
        h = a * h + dtu[:, t, :, None] * B[:, t, None, :]
        ys.append((h * C[:, t, None, :]).sum(-1))
    y = torch.stack(ys, 1) + D * u
    return (y * _silu(z.to(F32))).to(z.dtype), h


# --------------------------------------------------------------------------- #
# CUDA kernels (csrc/selective_scan.cu)
# --------------------------------------------------------------------------- #
def _bind(lib, suffix, bwd_scratch):
    """The forward, backward and fold entry points of a scan library; the
    backward takes ``bwd_scratch`` scratch pointers."""
    fwd, bwd, fold = (getattr(lib, f"dash_scan_{k}{suffix}")
                      for k in ("fwd", "bwd", "fold"))
    fwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    bwd.argtypes = [ctypes.c_void_p] * (16 + bwd_scratch) + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    fold.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    for fn in (fwd, bwd, fold):
        fn.restype = ctypes.c_int
    return fwd, bwd, fold


@functools.lru_cache(maxsize=None)
def _lib():
    return _bind(build.load("selective_scan"), "", 1)


@functools.lru_cache(maxsize=None)
def _lib_v1():
    return _bind(build.load("selective_scan_v1"), "_v1", 2)


def layout():
    """The build's layout: lanes a channel, the forward's ring stages,
    threads a CTA, the dynamic shared memory of each kernel (bytes; fp32 /
    bf16 z) and the backward's ring stages."""
    out = (ctypes.c_int * 9)()
    build.load("selective_scan").dash_scan_layout(out)
    keys = ("lanes", "stages", "threads", "fwd_smem_fp32", "fwd_smem_bf16",
            "bwd_smem_fp32", "bwd_smem_bf16", "bwd_stages_fp32",
            "bwd_stages_bf16")
    return dict(zip(keys, out))


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _check(u, dt, A, B, C, D, z, h0):
    """Raise for operands the kernels do not take."""
    b, s, din = u.shape
    tensors = (u, dt, A, B, C, D, z, h0)
    if not all(t.is_cuda and t.device == u.device for t in tensors):
        raise ValueError("the scan kernels need every operand on one CUDA "
                         "device")
    if any(t.dtype != F32 for t in (u, dt, A, B, C, D, h0)):
        raise TypeError("the scan kernels take fp32 u, dt, A, B, C, D, h0")
    if z.dtype not in (F32, torch.bfloat16):
        raise TypeError(f"the scan kernels take z in fp32 or bf16, not "
                        f"{z.dtype}")
    n = A.shape[-1]
    shapes = {"dt": (dt.shape, (b, s, din)), "z": (z.shape, (b, s, din)),
              "A": (A.shape, (din, n)), "B": (B.shape, (b, s, n)),
              "C": (C.shape, (b, s, n)), "D": (D.shape, (din,)),
              "h0": (h0.shape, (b, din, n))}
    bad = {k: tuple(g) for k, (g, w) in shapes.items() if tuple(g) != w}
    if bad:
        raise ValueError(f"scan operands for u {tuple(u.shape)}: {bad}")
    if n != STATE or din % CHANNELS or s < 1 or b < 1:
        raise ValueError(f"the scan kernels take N = {STATE} states and Din "
                         f"a multiple of {CHANNELS}; got N = {n}, Din = "
                         f"{din}, S = {s}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the scan kernels need contiguous operands")
    if any(t.data_ptr() % ALIGN for t in tensors):
        raise ValueError(f"the scan kernels need operands aligned to {ALIGN} "
                         f"bytes")


def n_chunks(s: int, chunk: int) -> int:
    return -(-s // chunk)


def scan_fwd_cuda(u, dt, A, B, C, D, z, h0, chunk, keep_states=True):
    """Launch the forward kernel. Returns ``(y, h_last, h_chk)``: ``h_chk``
    (B, n_chunks, N, Din) fp32 the state before each chunk's first step
    (what the backward restarts from), or None without ``keep_states``."""
    global launches_fwd
    out = _fwd(_lib, u, dt, A, B, C, D, z, h0, chunk, keep_states)
    launches_fwd += 1
    return out


def scan_fwd_v1_cuda(u, dt, A, B, C, D, z, h0, chunk, keep_states=True):
    """The forward's first design (``csrc/selective_scan_v1.cu``), kept as
    its bit oracle: :func:`scan_fwd_cuda` must return these ``h_last`` and
    ``h_chk`` bits. Only ``chip_smoke.py`` and the gpu-marked tests call it;
    it counts in no launch counter."""
    return _fwd(_lib_v1, u, dt, A, B, C, D, z, h0, chunk, keep_states)


def _fwd(lib, u, dt, A, B, C, D, z, h0, chunk, keep_states):
    """Check the operands, then launch ``lib()``'s forward."""
    _check(u, dt, A, B, C, D, z, h0)
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    b, s, din = u.shape
    y = torch.empty_like(z)
    h_last = torch.empty_like(h0)
    h_chk = (torch.empty((b, n_chunks(s, chunk), STATE, din), dtype=F32,
                         device=u.device) if keep_states else None)
    ptrs = [t.data_ptr() for t in (u, dt, A, B, C, D, z, h0, y, h_last)]
    err = lib()[0](*ptrs, None if h_chk is None else h_chk.data_ptr(), b, s,
                   din, chunk, int(z.dtype == torch.bfloat16),
                   _stream(u.device))
    if err:
        raise RuntimeError(f"selective scan forward kernel failed to "
                           f"launch: cudaError {err}")
    return y, h_last, h_chk


def scan_bwd_cuda(u, dt, A, B, C, D, z, h0, dy, h_chk, chunk, dh_last=None):
    """Launch the backward kernel and the fold of its partials. ``dy`` is
    the gradient of ``y`` (``z``'s dtype), ``dh_last`` that of the last
    state (None: zero). Returns ``(du, ddt, dA, dB, dC, dD, dz, dh0)``."""
    du, ddt, dz, dh0, bc_part, ad_part = scan_bwd_partials_cuda(
        u, dt, A, B, C, D, z, h0, dy, h_chk, chunk, dh_last)
    bc, ad = scan_fold_cuda(bc_part, ad_part)
    din = u.shape[-1]
    dA = ad[:din * STATE].view(din, STATE)
    dD = ad[din * STATE:]
    return (du, ddt, dA, bc[..., :STATE].contiguous(),
            bc[..., STATE:].contiguous(), dD, dz, dh0)


def scan_bwd_partials_cuda(u, dt, A, B, C, D, z, h0, dy, h_chk, chunk,
                           dh_last=None):
    """Launch the backward kernel alone. Returns ``(du, ddt, dz, dh0,
    bc_part, ad_part)``: ``bc_part`` (B, Din / 128, S, 2N) each CTA's sums
    of dB then dC over its channels, ``ad_part`` (B, Din * (N + 1)) each
    batch row's dA then dD."""
    global launches_bwd
    out = _bwd_partials(_lib, False, u, dt, A, B, C, D, z, h0, dy,
                        h_chk, chunk, dh_last)
    launches_bwd += 1
    return out


def scan_bwd_partials_v1_cuda(u, dt, A, B, C, D, z, h0, dy, h_chk, chunk,
                              dh_last=None):
    """The backward's first design (``csrc/selective_scan_v1.cu``), kept
    as its oracle: :func:`scan_bwd_partials_cuda`'s outputs agree with these
    within the order of the sums over the states and the channels. Only
    ``chip_smoke.py`` and the gpu-marked tests call it; it counts in no
    launch counter."""
    return _bwd_partials(_lib_v1, True, u, dt, A, B, C, D, z, h0, dy,
                         h_chk, chunk, dh_last)


def _bwd_partials(lib, v1, u, dt, A, B, C, D, z, h0, dy, h_chk, chunk,
                  dh_last):
    """Check the operands, then launch ``lib()``'s backward (``v1``: the
    first design's, which also takes a per-step scratch)."""
    _check(u, dt, A, B, C, D, z, h0)
    b, s, din = u.shape
    if dy.dtype != z.dtype or tuple(dy.shape) != (b, s, din) or not (
            dy.is_contiguous() and dy.device == u.device) or (
            dy.data_ptr() % ALIGN):
        raise ValueError("dy must be contiguous, aligned, on u's device, in "
                         "z's dtype and shape")
    if h_chk is None or tuple(h_chk.shape) != (b, n_chunks(s, chunk), STATE,
                                               din):
        raise ValueError(f"h_chk is not the forward's at chunk {chunk}")
    if dh_last is not None and (dh_last.dtype != F32 or tuple(
            dh_last.shape) != (b, din, STATE) or not dh_last.is_contiguous()
            or dh_last.data_ptr() % ALIGN):
        raise ValueError("dh_last must be a contiguous, aligned fp32 (B, "
                         "Din, N)")
    dev = u.device
    du, ddt = torch.empty_like(u), torch.empty_like(dt)
    dz = torch.empty_like(z)
    dh0 = torch.empty_like(h0)
    bc_part = torch.empty((b, din // CHANNELS, s, 2 * STATE), dtype=F32,
                          device=dev)
    ad_part = torch.empty((b, din * (STATE + 1)), dtype=F32, device=dev)
    # the states before each sub-chunk of a chunk (the first design also
    # passed each step's states of a sub-chunk through device memory)
    sub = torch.empty((b, -(-min(chunk, s) // SUB), STATE, din), dtype=F32,
                      device=dev)
    scratch = [sub.data_ptr()]
    if v1:
        hs = torch.empty((b, SUB, STATE, din), dtype=F32, device=dev)
        scratch.append(hs.data_ptr())
    ins = [t.data_ptr() for t in (u, dt, A, B, C, D, z, dy, h_chk)]
    outs = [t.data_ptr() for t in (du, ddt, dz, dh0, ad_part, bc_part)]
    err = lib()[1](*ins, None if dh_last is None else dh_last.data_ptr(),
                   *outs, *scratch, b, s, din, chunk,
                   int(z.dtype == torch.bfloat16), _stream(dev))
    if err:
        raise RuntimeError(f"selective scan backward kernel failed to "
                           f"launch: cudaError {err}")
    return du, ddt, dz, dh0, bc_part, ad_part


def scan_fold_cuda(bc_part, ad_part):
    """Launch the fold: ``bc_part`` (B, R, S, 2N) summed over R ascending
    and ``ad_part`` (B, Din * (N + 1)) over B ascending, each starting from
    its first partial. Returns ``(bc (B, S, 2N), ad (Din * (N + 1),))``."""
    global launches_fold
    b, n_blk, s, e = bc_part.shape
    din = ad_part.shape[1] // (STATE + 1)
    if (e != 2 * STATE or tuple(ad_part.shape) != (b, din * (STATE + 1))
            or bc_part.dtype != F32 or ad_part.dtype != F32
            or not (bc_part.is_cuda and ad_part.device == bc_part.device)
            or not (bc_part.is_contiguous() and ad_part.is_contiguous())):
        raise ValueError(f"scan_fold_cuda: bc_part {tuple(bc_part.shape)} "
                         f"{bc_part.dtype}, ad_part {tuple(ad_part.shape)} "
                         f"{ad_part.dtype}")
    bc = torch.empty((b, s, 2 * STATE), dtype=F32, device=bc_part.device)
    ad = torch.empty((din * (STATE + 1),), dtype=F32, device=bc_part.device)
    fold = _lib()[2]
    err = fold(bc_part.data_ptr(), bc.data_ptr(), ad_part.data_ptr(),
               ad.data_ptr(), b, n_blk, s, din, _stream(bc_part.device))
    if err:
        raise RuntimeError(f"selective scan fold kernel failed to launch: "
                           f"cudaError {err}")
    launches_fold += 1
    return bc, ad


def fold_plain(bc_part, ad_part):
    """The fold's plain version: the same sums, left to right."""
    bc, ad = bc_part[:, 0].clone(), ad_part[0].clone()
    for r in range(1, bc_part.shape[1]):
        bc += bc_part[:, r]
    for r in range(1, ad_part.shape[0]):
        ad += ad_part[r]
    return bc, ad


class _ScanFn(torch.autograd.Function):
    """The CUDA scan with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, u, dt, A, B, C, D, z, h0, chunk):
        keep = any(ctx.needs_input_grad[:7])
        y, h_last, h_chk = scan_fwd_cuda(u, dt, A, B, C, D, z, h0, chunk,
                                         keep_states=keep)
        if keep:
            ctx.save_for_backward(u, dt, A, B, C, D, z, h0, h_chk)
            ctx.chunk = chunk
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        # an output without a gradient arrives as zeros (autograd
        # materialises it)
        u, dt, A, B, C, D, z, h0, h_chk = ctx.saved_tensors
        grads = scan_bwd_cuda(u, dt, A, B, C, D, z, h0, dy.contiguous(),
                              h_chk, ctx.chunk, dh_last.contiguous())
        du, ddt, dA, dB, dC, dD, dz, _ = grads
        return du, ddt, dA, dB, dC, dD, dz, None, None


def selective_scan(u, dt, A, B, C, D, z, h0, chunk: int):
    """``(y, h_last)`` of the scan (module docstring): the CUDA kernels for
    CUDA tensors, :func:`selective_scan_plain` for CPU tensors."""
    if u.is_cuda:
        if h0.requires_grad:
            raise ValueError("the scan's initial state takes no gradient")
        return _ScanFn.apply(u, dt, A, B, C, D, z, h0, chunk)
    tensors = (u, dt, A, B, C, D, z, h0)
    if any(t.device.type != "cpu" for t in tensors):
        raise ValueError(f"selective_scan runs on CUDA or CPU tensors, not "
                         f"{sorted({str(t.device) for t in tensors})}")
    return selective_scan_plain(u, dt, A, B, C, D, z, h0)
