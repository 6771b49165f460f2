"""The mLSTM mixer's two forms: plain versions, CUDA kernels, dispatch.

Counterpart of the core of ``repro.models.xlstm.apply_mlstm``, which XLA
computes as a quadratic parallel form without a state (``:57-69``) and as a
``lax.scan`` of the ``(C, n, m)`` recurrence with one (``:70-89``). For q,
k, v (B, S, H, hd) in the model dtype (k already divided by sqrt(hd)) and
the log input and forget gates ig, fg (B, S, H) fp32:

* parallel form (:func:`mlstm_parallel`): with F = cumsum(fg) over S and
  D_ij = (F_i - F_j) + ig_j for j <= i, m_i = max_j D_ij and S_ij = (q_i .
  k_j) exp(D_ij - m_i), ``out_i = sum_j S_ij v_j / max(max(|sum_j S_ij|,
  exp(-m_i)), 1e-6)``;
* recurrence (:func:`mlstm_recurrent`): from the carried C (B, H, hd, hd),
  n (B, H, hd), m (B, H) fp32, per step m' = max(f + m, i), C = fi C + ii
  v k^T, n = fi n + ii k, ``out = C q / max(|q . n|, exp(-m'))``; no
  ``1e-6`` clamp, and the model's initial m is 0.

Both return ``out`` (B, S, H, hd) fp32 (the recurrence also the new
state). ``csrc/mlstm.cu`` holds both kernels; it takes hd 32 (the reduced
configs) and 256 (xLSTM-350M). The recurrence's first design,
``csrc/mlstm_v1.cu`` (:func:`mlstm_recurrent_v1_cuda`), is kept as its bit
oracle: the redesign returns its ``out``, C', n' and m' bitwise. The
parallel form's, ``csrc/mlstm_parallel_v1.cu``
(:func:`mlstm_parallel_v1_cuda`), is kept as its oracle: the redesign
returns its bits for fp32 operands and, for bf16 ones, whose q . k it sums
on the tensor cores in another order, agrees with it within tolerance. The
dispatchers take the plain version for CPU tensors and launch the kernel
for CUDA tensors (raising for anything it does not take), never one in
place of the other. The plain versions are differentiable by autograd. On
the card each kernel runs inside a ``torch.autograd.Function``. The
parallel form's backward (training) is ``csrc/mlstm_parallel_bwd.cu``
(:func:`mlstm_parallel_backward_cuda`), whose math is
:func:`mlstm_parallel_backward_plain`: when a gradient is wanted the
forward also hands over its F and each row's (m_i, s_i, ties_i)
(:func:`mlstm_parallel_stats_cuda`; plain versions
:func:`mlstm_parallel_stats_plain`,
:func:`mlstm_parallel_backward_stats_plain`). Its first design,
``csrc/mlstm_parallel_bwd_v1.cu``
(:func:`mlstm_parallel_backward_v1_cuda`), is kept as its oracle: the
redesign returns its bits for fp32 operands and agrees with it within
tolerance for bf16 ones. The recurrence's backward raises: no training
path runs the recurrence (prefill and decode take no gradient).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.kernels import build

F32 = torch.float32
NEG = -1e30
HEAD_DIMS = (32, 256)            # the head dims the kernels take
DTYPES = (torch.bfloat16, F32)   # q, k, v dtypes the kernels take
ALIGN = 16                       # bytes the recurrence's 16-byte copies need
NO_RECURRENT_BACKWARD = (
    "the mLSTM recurrence has no backward: no training path runs it "
    "(training runs the parallel form; the recurrence serves prefill and "
    "decode, which take no gradient)")

# launches of each CUDA kernel; the wrappers add one per launch and nothing
# else touches them
launches_parallel = 0
launches_recurrent = 0
launches_parallel_bwd = 0


def mlstm_parallel_plain(q, k, v, ig, fg):
    """The parallel form as the reference writes it: the (B, S, S, H) gate
    decay, weights and scores in full."""
    qk = torch.einsum("bihe,bjhe->bijh", q.to(F32), k.to(F32))
    return mlstm_parallel_from_qk(qk, v, ig, fg)


def mlstm_parallel_from_qk(qk, v, ig, fg):
    """:func:`mlstm_parallel_plain` from its q . k products ``qk`` (B, S,
    S, H) fp32, however they were summed."""
    return _parallel_parts(qk, v, ig, fg)[0]


def _parallel_parts(qk, v, ig, fg):
    """The parallel form's ``out`` and what the backward keeps of it: F,
    the masked gate decay D (B, S, S, H), its row maxima m and the signed
    row sums s (B, S, H)."""
    s = qk.shape[1]
    F = torch.cumsum(fg, 1)
    Dm = F[:, :, None, :] - F[:, None, :, :] + ig[:, None, :, :]
    tri = torch.ones((s, s), dtype=torch.bool, device=qk.device).tril()
    Dm = torch.where(tri[None, :, :, None], Dm, NEG)
    m = Dm.amax(2, keepdim=True)
    w = torch.exp(Dm - m)
    scores = qk * w
    ssum = scores.sum(2)
    norm = torch.maximum(ssum.abs(), torch.exp(-m[:, :, 0]))
    out = torch.einsum("bijh,bjhe->bihe", scores, v.to(F32))
    return (out / torch.clamp_min(norm[..., None], 1e-6), F, Dm, m[:, :, 0],
            ssum)


def mlstm_parallel_stats_plain(q, k, v, ig, fg):
    """:func:`mlstm_parallel_plain`'s ``out`` (the same bits) with what
    the backward takes from the forward: ``(out, F, stats)``, F = cumsum(fg)
    (B, S, H) and ``stats`` (B, S, H, 3) fp32, each row's stabilizer m_i,
    signed row sum s_i = sum_j S_ij and the count of j <= i whose D_ij
    equals m_i (the ties)."""
    qk = torch.einsum("bihe,bjhe->bijh", q.to(F32), k.to(F32))
    out, F, Dm, m, ssum = _parallel_parts(qk, v, ig, fg)
    s = q.shape[1]
    tri = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    ties = ((Dm == m[:, :, None]) & tri[None, :, :, None]).sum(2).to(F32)
    return out, F, torch.stack([m, ssum, ties], -1)


def mlstm_parallel_backward_plain(q, k, v, ig, fg, dout):
    """The parallel form's gradient, written out step by step in fp32 over
    full (B, S, S, H) tensors: ``(dq, dk, dv, dig, dfg)`` for the gradient
    ``dout`` (B, S, H, hd) of ``out``, all fp32 (``_ParallelFn`` rounds
    dq, dk, dv once to q's dtype). It is the math
    ``csrc/mlstm_parallel_bwd.cu`` implements. With the module
    docstring's names, w = exp(D - m), S = qk w, s_i = sum_j S_ij, norm_i
    = max(|s_i|, exp(-m_i)), den_i = max(norm_i, 1e-6):

    * row terms: dnum_i = dout_i / den_i; dden_i = -(dout_i . out_i) /
      den_i; dnorm_i = dden_i where norm_i > 1e-6; ds_i = dnorm_i sign(s_i)
      where |s_i| > exp(-m_i) (else the exp branch takes dnorm_i); the
      stabilizer's dm_i in its row-local closed form -(dout_i . out_i) -
      ds_i s_i - [exp branch] exp(-m_i) dnorm_i, shared evenly among the
      D_ij equal to m_i (the ties), as ``torch.amax`` and ``jnp.max`` do;
    * pair terms: dS_ij = dnum_i . v_j + ds_i; dv_j = sum_i S_ij dnum_i;
      dq_i = sum_j dS_ij w_ij k_j, dk_j = sum_i dS_ij w_ij q_i; dD_ij =
      dS_ij S_ij plus the tie share;
    * gates: dig_j = sum_i dD_ij; dF_i = sum_j dD_ij - dig_i; dfg_t = the
      sum over i >= t of dF_i.
    """
    s = q.shape[1]
    qf, kf, vf = q.to(F32), k.to(F32), v.to(F32)
    F = torch.cumsum(fg, 1)
    Dm = F[:, :, None, :] - F[:, None, :, :] + ig[:, None, :, :]
    tri = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    tri = tri[None, :, :, None]
    Dm = torch.where(tri, Dm, NEG)
    m = Dm.amax(2)                                          # (B, S, H)
    w = torch.exp(Dm - m[:, :, None])
    scores = torch.einsum("bihe,bjhe->bijh", qf, kf) * w
    ssum = scores.sum(2)
    em = torch.exp(-m)
    norm = torch.maximum(ssum.abs(), em)
    den = torch.clamp_min(norm, 1e-6)
    out = torch.einsum("bijh,bjhe->bihe", scores, vf) / den[..., None]
    dnum = dout / den[..., None]
    g = (dout * out).sum(-1)                                # dout_i . out_i
    dnorm = torch.where(norm > 1e-6, -g / den, 0.0)
    s_branch = ssum.abs() > em
    ds = torch.where(s_branch, dnorm * torch.sign(ssum), 0.0)
    dm = -g - ds * ssum - torch.where(s_branch, 0.0, em * dnorm)
    ties = (Dm == m[:, :, None]) & tri
    share = dm / ties.sum(2)
    dS = torch.einsum("bihe,bjhe->bijh", dnum, vf) + ds[:, :, None]
    dv = torch.einsum("bijh,bihe->bjhe", scores, dnum)
    gw = dS * w
    dq = torch.einsum("bijh,bjhe->bihe", gw, kf)
    dk = torch.einsum("bijh,bihe->bjhe", gw, qf)
    dD = dS * scores + torch.where(ties, share[:, :, None], 0.0)
    dig = dD.sum(1)
    dF = dD.sum(2) - dig
    dfg = torch.flip(torch.cumsum(torch.flip(dF, (1,)), 1), (1,))
    return dq, dk, dv, dig, dfg


def mlstm_parallel_backward_stats_plain(q, k, v, ig, F, out, dout, stats):
    """:func:`mlstm_parallel_backward_plain`'s ``(dq, dk, dv, dig, dfg)``
    (the same bits on the CPU) from what the forward handed over
    (:func:`mlstm_parallel_stats_plain`): F, ``out`` and each row's (m_i,
    s_i, ties_i), as ``csrc/mlstm_parallel_bwd.cu`` takes them, so that
    neither the stabilizer, nor s_i, nor ``out`` is recomputed."""
    s = q.shape[1]
    qf, kf, vf = q.to(F32), k.to(F32), v.to(F32)
    m, ssum, n_ties = stats.unbind(-1)
    Dm = F[:, :, None, :] - F[:, None, :, :] + ig[:, None, :, :]
    tri = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    tri = tri[None, :, :, None]
    Dm = torch.where(tri, Dm, NEG)
    w = torch.exp(Dm - m[:, :, None])
    scores = torch.einsum("bihe,bjhe->bijh", qf, kf) * w
    em = torch.exp(-m)
    norm = torch.maximum(ssum.abs(), em)
    den = torch.clamp_min(norm, 1e-6)
    dnum = dout / den[..., None]
    g = (dout * out).sum(-1)
    dnorm = torch.where(norm > 1e-6, -g / den, 0.0)
    s_branch = ssum.abs() > em
    ds = torch.where(s_branch, dnorm * torch.sign(ssum), 0.0)
    dm = -g - ds * ssum - torch.where(s_branch, 0.0, em * dnorm)
    ties = (Dm == m[:, :, None]) & tri
    share = dm / n_ties
    dS = torch.einsum("bihe,bjhe->bijh", dnum, vf) + ds[:, :, None]
    dv = torch.einsum("bijh,bihe->bjhe", scores, dnum)
    gw = dS * w
    dq = torch.einsum("bijh,bjhe->bihe", gw, kf)
    dk = torch.einsum("bijh,bihe->bjhe", gw, qf)
    dD = dS * scores + torch.where(ties, share[:, :, None], 0.0)
    dig = dD.sum(1)
    dF = dD.sum(2) - dig
    dfg = torch.flip(torch.cumsum(torch.flip(dF, (1,)), 1), (1,))
    return dq, dk, dv, dig, dfg


def mlstm_recurrent_plain(q, k, v, ig, fg, C, n, m):
    """The recurrence one step at a time: returns ``(out, (C, n, m))``."""
    outs = []
    for t in range(q.shape[1]):
        qt, kt, vt = q[:, t], k[:, t], v[:, t]
        it, ft = ig[:, t], fg[:, t]
        m_new = torch.maximum(ft + m, it)
        fi = torch.exp(ft + m - m_new)[..., None, None]
        ii = torch.exp(it - m_new)[..., None, None]
        C = fi * C + ii * (vt[..., :, None] * kt[..., None, :])
        n = fi[..., 0] * n + ii[..., 0] * kt
        num = torch.einsum("bhe,bhve->bhv", qt.to(F32), C)
        den = torch.maximum(torch.abs(torch.sum(qt.to(F32) * n, -1)),
                            torch.exp(-m_new))
        outs.append(num / den[..., None])
        m = m_new
    return torch.stack(outs, 1), (C, n, m)


# --------------------------------------------------------------------------- #
# CUDA kernels (csrc/mlstm.cu)
# --------------------------------------------------------------------------- #
def _bind_recurrent(fn):
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _lib():
    lib = build.load("mlstm")
    _bind_parallel(lib.dash_mlstm_parallel)
    _bind_recurrent(lib.dash_mlstm_recurrent)
    return lib


def _bind_parallel(fn, pointers=7):
    """The parallel form's entry point: q, k, v, F, ig, out and (the
    redesign's, ``pointers`` 7) stats, then B, S, H, hd, is_bf16, the
    stream."""
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _recurrent_v1():
    return _bind_recurrent(build.load("mlstm_v1").dash_mlstm_recurrent_v1)


@functools.lru_cache(maxsize=None)
def _parallel_v1():
    """The first design's entry point, called as the redesign's (it takes
    no stats: the pointer is dropped)."""
    fn = _bind_parallel(
        build.load("mlstm_parallel_v1").dash_mlstm_parallel_v1, pointers=6)
    return lambda q, k, v, F, ig, out, stats, *shape: fn(q, k, v, F, ig,
                                                         out, *shape)


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def _check(q, k, v, ig, fg, state=()):
    """Raise for operands the kernels do not take."""
    b, s, h, hd = q.shape if q.dim() == 4 else (0,) * 4
    tensors = (q, k, v, ig, fg, *state)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("the mLSTM kernels need every operand on one CUDA "
                         "device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the mLSTM kernels take q, k, v of one dtype in "
                        f"{DTYPES}; got {q.dtype}, {k.dtype}, {v.dtype}")
    if any(t.dtype != F32 for t in (ig, fg, *state)):
        raise TypeError("the mLSTM kernels take fp32 gates and state")
    want = {"q": (q.shape, (b, s, h, hd)), "k": (k.shape, (b, s, h, hd)),
            "v": (v.shape, (b, s, h, hd)), "ig": (ig.shape, (b, s, h)),
            "fg": (fg.shape, (b, s, h))}
    if state:
        want.update(C=(state[0].shape, (b, h, hd, hd)),
                    n=(state[1].shape, (b, h, hd)), m=(state[2].shape, (b, h)))
    bad = {k_: tuple(g) for k_, (g, w) in want.items() if tuple(g) != w}
    if bad or hd not in HEAD_DIMS or s < 1 or b < 1:
        raise ValueError(f"the mLSTM kernels take q, k, v (B, S, H, hd) with "
                         f"hd in {HEAD_DIMS}, gates (B, S, H), state (B, H, "
                         f"hd, hd), (B, H, hd), (B, H); got q "
                         f"{tuple(q.shape)}, mismatched {bad}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the mLSTM kernels need contiguous operands")
    if any(t.data_ptr() % ALIGN for t in (q, k, v)):
        raise ValueError(f"the mLSTM kernels need q, k, v aligned to {ALIGN} "
                         f"bytes")


def _parallel(lib_fn, q, k, v, ig, fg, stats=False):
    """Check the operands, then launch ``lib_fn()`` (the entry point, built
    at first use); ``F = cumsum(fg)`` is ``torch.cumsum`` here, as the
    plain version takes it. Returns ``out``, or with ``stats`` ``(out, F,
    stats)`` (:func:`mlstm_parallel_stats_cuda`)."""
    _check(q, k, v, ig, fg)
    b, s, h, hd = q.shape
    F = torch.cumsum(fg, 1)
    out = torch.empty((b, s, h, hd), dtype=F32, device=q.device)
    st = (torch.empty((b, s, h, 3), dtype=F32, device=q.device) if stats
          else None)
    err = lib_fn()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), F.data_ptr(),
        ig.data_ptr(), out.data_ptr(), 0 if st is None else st.data_ptr(),
        b, s, h, hd, int(q.dtype == torch.bfloat16), _stream(q.device))
    if err:
        raise RuntimeError(f"mLSTM parallel kernel failed to launch: "
                           f"cudaError {err}")
    return (out, F, st) if stats else out


def mlstm_parallel_cuda(q, k, v, ig, fg):
    """Launch the parallel kernel."""
    global launches_parallel
    out = _parallel(lambda: _lib().dash_mlstm_parallel, q, k, v, ig, fg)
    launches_parallel += 1
    return out


def mlstm_parallel_stats_cuda(q, k, v, ig, fg):
    """Launch the parallel kernel for training: ``(out, F, stats)`` as
    :func:`mlstm_parallel_stats_plain` returns them (``out`` bitwise
    :func:`mlstm_parallel_cuda`'s), for the backward."""
    global launches_parallel
    result = _parallel(lambda: _lib().dash_mlstm_parallel, q, k, v, ig, fg,
                       stats=True)
    launches_parallel += 1
    return result


def mlstm_parallel_v1_cuda(q, k, v, ig, fg):
    """The parallel form's first design (``csrc/mlstm_parallel_v1.cu``),
    kept as its oracle: :func:`mlstm_parallel_cuda` must return these bits
    for fp32 operands and agree within the checks' tolerance for bf16 ones
    (whose q . k it sums on the tensor cores). Only the checks, the
    gpu-marked tests and ``scripts/xlstm_variants.py`` call it; it counts
    in no launch counter."""
    return _parallel(_parallel_v1, q, k, v, ig, fg)


# csrc/mlstm_parallel_bwd.cu's passes, in launch order: the row terms
# (and dnum), then the key tiles (dk, dv, dig; dS w and dD into a scratch),
# then the query tiles (dq, dF); the first design's are these names with
# a ``_v1`` suffix
BWD_PASSES = ("dash_mlstm_bwd_rows", "dash_mlstm_bwd_keys",
              "dash_mlstm_bwd_queries")
BWD_TILE = 32                    # queries or keys a tile of the passes


def _bind_passes(lib, suffix, pointers):
    for name, n in zip(BWD_PASSES, pointers):
        fn = getattr(lib, name + suffix)
        fn.argtypes = [ctypes.c_void_p] * n + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_lib():
    return _bind_passes(build.load("mlstm_parallel_bwd"), "", (6, 11, 5))


@functools.lru_cache(maxsize=None)
def _bwd_v1_lib():
    return _bind_passes(build.load("mlstm_parallel_bwd_v1"), "_v1",
                        (7, 10, 10))


def _check_bwd(q, tensors):
    """Raise unless each named tensor is (B, S, H, hd) or (B, S, H, x)
    fp32, contiguous, on q's device."""
    b, s, h, hd = q.shape
    for name, (t, last) in tensors.items():
        want = (b, s, h) + ((last,) if last else ())
        if (t.device != q.device or t.dtype != F32
                or tuple(t.shape) != want or not t.is_contiguous()):
            raise ValueError(f"the mLSTM parallel backward takes {name} as "
                             f"a contiguous {want} fp32 tensor on q's "
                             f"device; got {tuple(t.shape)} {t.dtype} "
                             f"{t.device}")


def _run_passes(lib, suffix, p, args, shape, count=False):
    global launches_parallel_bwd
    for name, names in zip(BWD_PASSES, args):
        err = getattr(lib, name + suffix)(*(p[x] for x in names), *shape)
        if err:
            raise RuntimeError(f"mLSTM parallel backward ({name}{suffix}) "
                               f"failed to launch: cudaError {err}")
        launches_parallel_bwd += count


def mlstm_parallel_backward_cuda(q, k, v, ig, F, out, dout, stats):
    """The parallel form's backward on the card (``csrc/
    mlstm_parallel_bwd.cu``): ``(dq, dk, dv, dig, dfg)`` as
    :func:`mlstm_parallel_backward_plain` computes them, from the forward's
    operands, its F, ``out`` and row statistics (m_i, s_i, ties_i)
    (:func:`mlstm_parallel_stats_cuda`) and the gradient ``dout`` (B, S,
    H, hd) fp32, all fp32. Three launches, each counted: the row terms
    ((F_i, m_i, ds_i, share_i) and dnum = dout / den), the key tiles (dk,
    dv and dig; each tile pair's dS w and dD into a scratch of n (n + 1) /
    2 blocks of 32 x 32 a (b, h), n = ceil(S / 32)) and the query tiles (dq
    and dF = the row sums of dD - dig). The reverse cumsum ``dfg =
    flip(cumsum(flip(dF)))`` is a ``torch`` call here."""
    return _backward(_bwd_lib, True, q, k, v, ig, F, out, dout, stats)


def _backward(lib_fn, count, q, k, v, ig, F, out, dout, stats):
    """:func:`mlstm_parallel_backward_cuda` through ``lib_fn()`` (the
    built source, or a variant of it, bound by :func:`_bind_passes` and
    built at first use), its launches counted when ``count``."""
    _check(q, k, v, ig, F)
    b, s, h, hd = q.shape
    _check_bwd(q, dict(out=(out, hd), dout=(dout, hd), stats=(stats, 3)))
    n = -(-s // BWD_TILE)
    rows = torch.empty((b, s, h, 4), dtype=F32, device=q.device)
    dnum = torch.empty(q.shape, dtype=F32, device=q.device)
    scratch = torch.empty((2, b * h * n * (n + 1) // 2,
                           BWD_TILE * BWD_TILE), dtype=F32, device=q.device)
    dq, dk, dv = (torch.empty(q.shape, dtype=F32, device=q.device)
                  for _ in range(3))
    dig, dF = (torch.empty_like(ig) for _ in range(2))
    p = {name: t.data_ptr() for name, t in dict(
        q=q, k=k, v=v, F=F, ig=ig, stats=stats, out=out, dout=dout,
        rows=rows, dnum=dnum, scratch=scratch, dq=dq, dk=dk, dv=dv, dig=dig,
        dF=dF).items()}
    _run_passes(lib_fn(), "", p, (
        ("F", "stats", "out", "dout", "rows", "dnum"),
        ("q", "k", "v", "F", "ig", "rows", "dnum", "dk", "dv", "dig",
         "scratch"),
        ("k", "scratch", "dig", "dq", "dF")),
        (b, s, h, hd, int(q.dtype == torch.bfloat16), _stream(q.device)),
        count)
    dfg = torch.flip(torch.cumsum(torch.flip(dF, (1,)), 1), (1,))
    return dq, dk, dv, dig, dfg


def backward_row_terms(q, k, v, ig, fg, out, dout, stats=None):
    """The backward's first pass alone, for the checks (counted nowhere):
    with the forward's ``stats`` the redesign's rows (F_i, m_i, ds_i,
    share_i), else the first design's (m_i, den_i, ds_i, share_i), each (B,
    S, H, 4) fp32: m_i, ds_i and share_i must agree bitwise for fp32
    operands (m_i also for bf16 ones)."""
    _check(q, k, v, ig, fg)
    b, s, h, hd = q.shape
    F = torch.cumsum(fg, 1)
    rows = torch.empty((b, s, h, 4), dtype=F32, device=q.device)
    shape = (b, s, h, hd, int(q.dtype == torch.bfloat16), _stream(q.device))
    if stats is None:
        err = _bwd_v1_lib().dash_mlstm_bwd_rows_v1(*(t.data_ptr() for t in (
            q, k, F, ig, out, dout, rows)), *shape)
    else:
        dnum = torch.empty(q.shape, dtype=F32, device=q.device)
        err = _bwd_lib().dash_mlstm_bwd_rows(*(t.data_ptr() for t in (
            F, stats, out, dout, rows, dnum)), *shape)
    if err:
        raise RuntimeError(f"mLSTM backward's rows pass failed to launch: "
                           f"cudaError {err}")
    return rows


def mlstm_parallel_backward_v1_cuda(q, k, v, ig, fg, out, dout):
    """The backward's first design (``csrc/mlstm_parallel_bwd_v1.cu``:
    rows, keys and queries passes, the rows pass rebuilding each row's
    stabilizer, ties and s_i), kept as its oracle:
    :func:`mlstm_parallel_backward_cuda` must return these bits for fp32
    operands and agree within the checks' tolerance for bf16 ones. ``F =
    torch.cumsum(fg, 1)`` and the reverse cumsum are ``torch`` calls here.
    Only the checks, the gpu-marked tests and ``scripts/xlstm_variants.py``
    call it; it counts in no launch counter."""
    _check(q, k, v, ig, fg)
    b, s, h, hd = q.shape
    _check_bwd(q, dict(out=(out, hd), dout=(dout, hd)))
    F = torch.cumsum(fg, 1)
    rows = torch.empty((b, s, h, 4), dtype=F32, device=q.device)
    dq, dk, dv = (torch.empty(q.shape, dtype=F32, device=q.device)
                  for _ in range(3))
    dig, dF = (torch.empty_like(ig) for _ in range(2))
    p = {name: t.data_ptr() for name, t in dict(
        q=q, k=k, v=v, F=F, ig=ig, out=out, dout=dout, rows=rows, dq=dq,
        dk=dk, dv=dv, dig=dig, dF=dF).items()}
    _run_passes(_bwd_v1_lib(), "_v1", p, (
        ("q", "k", "F", "ig", "out", "dout", "rows"),
        ("q", "k", "v", "F", "ig", "dout", "rows", "dk", "dv", "dig"),
        ("q", "k", "v", "F", "ig", "dout", "rows", "dig", "dq", "dF")),
        (b, s, h, hd, int(q.dtype == torch.bfloat16), _stream(q.device)))
    dfg = torch.flip(torch.cumsum(torch.flip(dF, (1,)), 1), (1,))
    return dq, dk, dv, dig, dfg


def _recurrent(lib_fn, q, k, v, ig, fg, C, n, m):
    """Check the operands, then launch ``lib_fn()`` (the entry point, built
    at first use)."""
    _check(q, k, v, ig, fg, (C, n, m))
    b, s, h, hd = q.shape
    out = torch.empty((b, s, h, hd), dtype=F32, device=q.device)
    C1, n1, m1 = (torch.empty_like(t) for t in (C, n, m))
    err = lib_fn()(*(t.data_ptr() for t in (q, k, v, ig, fg, C, n, m, out,
                                            C1, n1, m1)),
                   b, s, h, hd, int(q.dtype == torch.bfloat16),
                   _stream(q.device))
    if err:
        raise RuntimeError(f"mLSTM recurrent kernel failed to launch: "
                           f"cudaError {err}")
    return out, (C1, n1, m1)


def mlstm_recurrent_cuda(q, k, v, ig, fg, C, n, m):
    """Launch the recurrence from ``(C, n, m)``: returns ``(out, (C', n',
    m'))``, the new state in new tensors."""
    global launches_recurrent
    result = _recurrent(lambda: _lib().dash_mlstm_recurrent, q, k, v, ig, fg,
                        C, n, m)
    launches_recurrent += 1
    return result


def mlstm_recurrent_v1_cuda(q, k, v, ig, fg, C, n, m):
    """The recurrence's first design (``csrc/mlstm_v1.cu``), kept as its bit
    oracle: :func:`mlstm_recurrent_cuda` must return these bits. Only the
    checks, the gpu-marked tests and ``scripts/xlstm_variants.py`` call it;
    it counts in no launch counter."""
    return _recurrent(_recurrent_v1, q, k, v, ig, fg, C, n, m)


LAYOUT_KEYS = ("warp_rows", "decode_warp_rows", "decode_max_s", "cta_rows",
               "decode_cta_rows", "threads", "decode_threads", "lookahead",
               "stages", "smem_bf16", "smem_fp32")
# the phases of recurrent_phases: a consumer warp's, the scalar warp's
CONSUMER_PHASES = ("wait", "prepare", "update", "reduce", "wait_den")
SCALAR_PHASES = ("wait", "chain", "n", "reduce")


def recurrent_layout(lib=None):
    """The recurrence's build (``csrc/mlstm.cu``): rows of C a consumer
    warp and a CTA, threads a CTA (each also at S <= ``decode_max_s``),
    stages of copies in flight, prepared stages, dynamic shared memory
    (bytes, hd = 256)."""
    out = (ctypes.c_int * len(LAYOUT_KEYS))()
    (lib or _lib()).dash_mlstm_recurrent_layout(out)
    return dict(zip(LAYOUT_KEYS, out))


def recurrent_phases(q, k, v, ig, fg, C, n, m):
    """One launch of the recurrence built with ``-DDASH_STAMPS`` (its
    ``clock64()`` stamps; counted nowhere) at S > ``decode_max_s``: per CTA
    and warp (the consumer warps, then the scalar warp) the clocks in each
    phase and in all, an int64 array (CTAs, warps, 6). A consumer's phases
    (:data:`CONSUMER_PHASES`): waiting for the stage's layout and fi, ii;
    laying the next stage out (with its copies); the update; the
    reduce-scatter; waiting for the denominators (then the store). The
    scalar warp's (:data:`SCALAR_PHASES`): waiting, the stabilizer's chain,
    n and q . n, the reduce-scatter and denominators."""
    lib = build.load("mlstm", ("DASH_STAMPS",))
    _recurrent(lambda: _bind_recurrent(lib.dash_mlstm_recurrent), q, k, v,
               ig, fg, C, n, m)
    torch.cuda.synchronize(q.device)
    b, _, h, hd = q.shape
    layout = recurrent_layout(lib)
    warps, per = layout["threads"] // 32, len(CONSUMER_PHASES) + 1
    ctas = b * h * (hd // layout["cta_rows"])
    buf = (ctypes.c_longlong * (ctas * warps * per))()
    if lib.dash_mlstm_stamps(buf, len(buf)):
        raise RuntimeError("reading the mLSTM recurrence's stamps failed")
    return np.frombuffer(buf, dtype=np.int64).reshape(ctas, warps, per).copy()


class _ParallelFn(torch.autograd.Function):
    """The parallel kernel; its backward the backward kernel, whose fp32
    dq, dk, dv it rounds once to their inputs' dtype. Only when a gradient
    is wanted does the forward hand over its row statistics
    (:func:`mlstm_parallel_stats_cuda`) and keep its operands, F, ``out``
    and the statistics; else it is :func:`mlstm_parallel_cuda`."""

    @staticmethod
    def forward(ctx, q, k, v, ig, fg):
        if not any(ctx.needs_input_grad):
            return mlstm_parallel_cuda(q, k, v, ig, fg)
        out, F, stats = mlstm_parallel_stats_cuda(q, k, v, ig, fg)
        ctx.save_for_backward(q, k, v, ig, F, out, stats)
        ctx.dtypes = tuple(x.dtype for x in (q, k, v, ig, fg))
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, ig, F, out, stats = ctx.saved_tensors  # unpacked once
        grads = mlstm_parallel_backward_cuda(q, k, v, ig, F, out,
                                             dout.contiguous(), stats)
        return tuple(g.to(dt) if need else None for g, dt, need in
                     zip(grads, ctx.dtypes, ctx.needs_input_grad))


class _RecurrentFn(torch.autograd.Function):
    """The recurrent kernel; its backward raises
    (:data:`NO_RECURRENT_BACKWARD`)."""

    @staticmethod
    def forward(ctx, q, k, v, ig, fg, C, n, m):
        out, state = mlstm_recurrent_cuda(q, k, v, ig, fg, C, n, m)
        return (out, *state)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(NO_RECURRENT_BACKWARD)


def _on_cpu(name, tensors):
    if any(t.device.type != "cpu" for t in tensors):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not "
                         f"{sorted({str(t.device) for t in tensors})}")


def mlstm_parallel(q, k, v, ig, fg):
    """``out`` of the parallel form (module docstring): the CUDA kernel for
    CUDA tensors, :func:`mlstm_parallel_plain` for CPU tensors."""
    if q.is_cuda:
        return _ParallelFn.apply(q, k, v, ig, fg)
    _on_cpu("mlstm_parallel", (q, k, v, ig, fg))
    return mlstm_parallel_plain(q, k, v, ig, fg)


def mlstm_recurrent(q, k, v, ig, fg, C, n, m):
    """``(out, (C, n, m))`` of the recurrence (module docstring): the CUDA
    kernel for CUDA tensors, :func:`mlstm_recurrent_plain` for CPU
    tensors."""
    if q.is_cuda:
        out, *state = _RecurrentFn.apply(q, k, v, ig, fg, C, n, m)
        return out, tuple(state)
    _on_cpu("mlstm_recurrent", (q, k, v, ig, fg, C, n, m))
    return mlstm_recurrent_plain(q, k, v, ig, fg, C, n, m)
