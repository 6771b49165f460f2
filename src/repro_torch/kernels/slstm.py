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
in place of the other. The plain version is differentiable by autograd.
On the card the kernel runs inside a ``torch.autograd.Function`` whose
backward is ``csrc/slstm_bwd.cu`` (:func:`slstm_backward_cuda`, the math
of :func:`slstm_backward_plain`); when a gradient is wanted the forward
also keeps every step's c, n, m and pre-activations (:data:`KEPT`).
"""
from __future__ import annotations

import contextlib
import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.mlstm import ALIGN, DTYPES, HEAD_DIMS, _stream

F32 = torch.float32
# what the forward keeps for the backward, each (B, S, H, hd) fp32, stacked
# in this order into one (7, B, S, H, hd) tensor: every step's state and
# pre-activations (z_g + h r_g)
KEPT = ("c", "n", "m", "pre_i", "pre_f", "pre_z", "pre_o")

# launches of the CUDA kernels; the wrappers add one per launch and nothing
# else touches them
launches = 0
launches_bwd = 0


def slstm_plain(z, r, state, keep=False):
    """The recurrence one step at a time: returns ``(h_all, (c, n, h,
    m))``, and with ``keep`` also what :func:`slstm_backward_plain` needs
    of the forward: :data:`KEPT`, (7, B, S, H, hd) fp32."""
    c, n, h, m = state
    zi, zf, zz, zo = z
    ri, rf, rz, ro = (x.to(F32) for x in r)
    outs, kept = [], []
    for t in range(zi.shape[1]):
        it = zi[:, t] + torch.einsum("bhe,hev->bhv", h, ri)
        ft = zf[:, t] + torch.einsum("bhe,hev->bhv", h, rf)
        zt = zz[:, t] + torch.einsum("bhe,hev->bhv", h, rz)
        ot = zo[:, t] + torch.einsum("bhe,hev->bhv", h, ro)
        lsf = F.logsigmoid(ft)
        m_new = torch.maximum(lsf + m, it)
        i_ = torch.exp(it - m_new)
        f_ = torch.exp(lsf + m - m_new)
        c = f_ * c + i_ * torch.tanh(zt)
        n = f_ * n + i_
        h = torch.sigmoid(ot) * c / torch.clamp_min(n, 1e-6)
        m = m_new
        outs.append(h)
        if keep:
            kept.append((c, n, m, it, ft, zt, ot))
    h_all = torch.stack(outs, 1)
    if not keep:
        return h_all, (c, n, h, m)
    return h_all, (c, n, h, m), torch.stack([torch.stack(x, 1)
                                             for x in zip(*kept)])


def slstm_backward_plain(z, r, state, saved, dh_all, dstate=None):
    """The recurrence's gradient, the reverse recurrence written out step
    by step in fp32 (t = S - 1 ... 0): ``(dz, dr, dstate0)`` for the
    gradients ``dh_all`` of every step's h and ``dstate`` of the returned
    ``(c, n, h, m)`` (zeros if None), from ``saved = (h_all, kept)``
    (:func:`slstm_plain` with ``keep``), all fp32: dz (four (B, S, H,
    hd)), dr (four (H, hd, hd); ``_SLSTMFn`` rounds it once to r's dtype)
    and dstate0, the gradients of the initial ``(c, n, h, m)``. It carries dc,
    dn, dm and dh_rec (the gradient reaching h_{t-1} through the recurrent
    matrices); at each step, with dh = dh_all[t] + dh_rec, den = max(n_t,
    1e-6) and i_, f_, tanh_z, o recomputed from the kept pre-activations:

    * dpre_o = dh (c_t / den) o (1 - o); dc += dh o / den; dn += -dh o c_t
      / den^2 where n_t > 1e-6;
    * df = dc c_{t-1} + dn n_{t-1}; di = dc tanh_z + dn; dpre_z = dc i_ (1
      - tanh_z^2);
    * through m_t = max(a_t, pre_i), a_t = log_sigmoid(pre_f) + m_{t-1}:
      dm_t = dm - di i_ - df f_, routed to a_t or pre_i by the max (ties
      split in half); dpre_i = di i_ + its share; da_t = df f_ + its share;
      dpre_f = da_t sigmoid(-pre_f);
    * passed to step t - 1: dc f_, dn f_, dm = da_t and dh_rec[e] = sum_g
      sum_v dpre_g[v] r_g[e, v].

    dz_g[t] = dpre_g; dr_g = sum over (b, t) of h_{t-1} (x) dpre_g, one
    fp32 einsum."""
    h_all, (c_all, n_all, m_all, *pre) = saved
    c0, n0, h0, m0 = state
    rf = tuple(x.to(F32) for x in r)
    dc, dn, dh_rec, dm = ((torch.zeros_like(c0),) * 4 if dstate is None
                          else dstate)
    dpre = [[] for _ in range(4)]
    for t in reversed(range(h_all.shape[1])):
        c_t, n_t, m_t = c_all[:, t], n_all[:, t], m_all[:, t]
        c_p, n_p, m_p = ((c0, n0, m0) if t == 0 else
                         (c_all[:, t - 1], n_all[:, t - 1], m_all[:, t - 1]))
        pi, pf, pz, po = (x[:, t] for x in pre)
        a = F.logsigmoid(pf) + m_p
        i_ = torch.exp(pi - m_t)
        f_ = torch.exp(a - m_t)
        tz, o = torch.tanh(pz), torch.sigmoid(po)
        den = torch.clamp_min(n_t, 1e-6)
        dh = dh_all[:, t] + dh_rec
        dpo = dh * (c_t / den) * o * (1 - o)
        dc = dc + dh * o / den
        dn = dn + torch.where(n_t > 1e-6, -dh * o * c_t / (den * den), 0.0)
        df = dc * c_p + dn * n_p
        di = dc * tz + dn
        dpz = dc * i_ * (1 - tz * tz)
        dmt = dm - di * i_ - df * f_
        to_a = torch.where(a > pi, 1.0, torch.where(a == pi, 0.5, 0.0))
        dpi = di * i_ + dmt * (1 - to_a)
        da = df * f_ + dmt * to_a
        dpf = da * torch.sigmoid(-pf)
        dc, dn, dm = dc * f_, dn * f_, da
        step = (dpi, dpf, dpz, dpo)
        dh_rec = sum(torch.einsum("bhv,hev->bhe", d, x)
                     for d, x in zip(step, rf))
        for acc, d in zip(dpre, step):
            acc.append(d)
    dz = tuple(torch.stack(x[::-1], 1) for x in dpre)
    h_prev = torch.cat([h0[:, None], h_all[:, :-1]], 1)
    dr = tuple(torch.einsum("bshe,bshv->hev", h_prev, d) for d in dz)
    return dz, dr, (dc, dn, dh_rec, dm)


# --------------------------------------------------------------------------- #
# CUDA kernels (csrc/slstm.cu, csrc/slstm_bwd.cu)
# --------------------------------------------------------------------------- #
def _bind(fn, kept=False):
    """Bind a forward entry: the redesign's (``kept``) also takes the
    pointer :data:`KEPT` goes to (NULL: keep nothing)."""
    fn.argtypes = [ctypes.c_void_p] * (17 + kept) + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _lib():
    return _bind(build.load("slstm").dash_slstm, kept=True)


@functools.lru_cache(maxsize=None)
def _lib_v1():
    return _bind(build.load("slstm_v1").dash_slstm_v1)


@functools.lru_cache(maxsize=None)
def _lib_bwd():
    fn = build.load("slstm_bwd").dash_slstm_bwd
    fn.argtypes = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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


def _launch(lib_fn, z, r, state, *extra):
    """Check the operands, then launch ``lib_fn()`` (the entry point, built
    at first use) with the pointers of ``extra`` (tensors, or None for
    NULL) after the new state's: the redesign's entry takes :data:`KEPT`'s,
    the first design's none."""
    _check(z, r, state)
    b, s, h, hd = z[0].shape
    out = torch.empty((b, s, h, hd), dtype=F32, device=z[0].device)
    new = tuple(torch.empty_like(t) for t in state)
    err = lib_fn()(*(t.data_ptr() for t in (*z, *r, *state, out, *new)),
                   *(None if t is None else t.data_ptr() for t in extra),
                   b, s, h, hd, int(r[0].dtype == torch.bfloat16),
                   _stream(z[0].device))
    if err:
        raise RuntimeError(f"sLSTM kernel failed to launch: cudaError {err}")
    return out, new


def slstm_cuda(z, r, state, keep=False):
    """Launch the kernel: returns ``(h_all, (c, n, h, m))``, the new state
    in new tensors, and with ``keep`` also :data:`KEPT` for
    :func:`slstm_backward_cuda` (h_all and the state keep their bits)."""
    global launches
    kept = (torch.empty((len(KEPT), *z[0].shape), dtype=F32,
                        device=z[0].device) if keep else None)
    out, new = _launch(_lib, z, r, state, kept)
    launches += 1
    return (out, new, kept) if keep else (out, new)


def slstm_v1_cuda(z, r, state):
    """The first design (``csrc/slstm_v1.cu``), kept as the bit oracle:
    :func:`slstm_cuda` must return these bits. Only the checks, the
    gpu-marked tests and ``scripts/xlstm_variants.py`` call it; it counts in
    no launch counter."""
    return _launch(_lib_v1, z, r, state)


@contextlib.contextmanager
def _fp32_matmul():
    """fp32 matrix products in fp32 (TF32 off) while open."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def slstm_backward_cuda(z, r, state, saved, dh_all, dstate=None):
    """The recurrence's backward on the card (``csrc/slstm_bwd.cu``, one
    launch): ``(dz, dr, dstate0)`` as :func:`slstm_backward_plain` computes
    them from the same arguments (``saved = (h_all, kept)``, ``kept`` the
    forward's :data:`KEPT`). The kernel runs the reverse recurrence; dr_g =
    sum over (b, t) of h_{t-1} (x) dz_g is one fp32 ``torch.einsum`` here,
    with TF32 off (the reference's einsum transpose, not a Pallas
    kernel)."""
    global launches_bwd
    h_all, kept = saved
    _check(z, r, state)
    b, s, h, hd = z[0].shape
    dstate = (tuple(torch.zeros_like(t) for t in state) if dstate is None
              else tuple(t.contiguous() for t in dstate))
    dh_all = dh_all.contiguous()
    for name, t, shape in (("h_all", h_all, (b, s, h, hd)),
                           ("kept", kept, (len(KEPT), b, s, h, hd)),
                           ("dh_all", dh_all, (b, s, h, hd)),
                           *(("dstate", t, (b, h, hd)) for t in dstate)):
        if (t.device != z[0].device or t.dtype != F32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"the sLSTM backward takes {name} as a "
                             f"contiguous {shape} fp32 tensor on z's "
                             f"device; got {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")
    dz = torch.empty((4, b, s, h, hd), dtype=F32, device=z[0].device)
    d0 = tuple(torch.empty_like(t) for t in state)
    c0, n0, h0, m0 = state
    err = _lib_bwd()(*(t.data_ptr() for t in (
        *r, kept, c0, n0, m0, dh_all, *dstate, *dz, *d0)), b, s, h, hd,
        int(r[0].dtype == torch.bfloat16), _stream(z[0].device))
    if err:
        raise RuntimeError(f"sLSTM backward kernel failed to launch: "
                           f"cudaError {err}")
    launches_bwd += 1
    h_prev = torch.cat([h0[:, None], h_all[:, :-1]], 1)
    with _fp32_matmul():
        dr = torch.einsum("bshe,gbshv->ghev", h_prev, dz)
    return tuple(dz), tuple(dr), d0


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
    _launch(lambda: _bind(lib.dash_slstm, kept=True), z, r, state, None)
    torch.cuda.synchronize(z[0].device)
    b, _, h, hd = z[0].shape
    rows = layout(lib)["rows"]
    ctas, per = -(-b // rows) * h * (hd // 32), len(PHASES) + 1
    buf = (ctypes.c_longlong * (ctas * 8 * per))()
    if lib.dash_slstm_stamps(buf, len(buf)):
        raise RuntimeError("reading the sLSTM stamps failed")
    return np.frombuffer(buf, dtype=np.int64).reshape(ctas, 8, per).copy()


class _SLSTMFn(torch.autograd.Function):
    """The kernel; its backward the backward kernel, whose fp32 dr it
    rounds once to r's dtype. The forward keeps :data:`KEPT` only when a
    gradient is wanted."""

    @staticmethod
    def forward(ctx, zi, zf, zz, zo, ri, rf, rz, ro, c, n, h, m):
        z, r, state = (zi, zf, zz, zo), (ri, rf, rz, ro), (c, n, h, m)
        if not any(ctx.needs_input_grad):
            out, new = slstm_cuda(z, r, state)
            return (out, *new)
        out, new, kept = slstm_cuda(z, r, state, keep=True)
        ctx.save_for_backward(*z, *r, *state, out, kept)
        return (out, *new)

    @staticmethod
    def backward(ctx, dout, *dstate):
        saved = ctx.saved_tensors           # unpacked once (remat)
        dz, dr, d0 = slstm_backward_cuda(saved[:4], saved[4:8], saved[8:12],
                                         saved[12:], dout, dstate)
        return tuple(g.to(x.dtype) if need else None for g, x, need in
                     zip((*dz, *dr, *d0), saved, ctx.needs_input_grad))


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
