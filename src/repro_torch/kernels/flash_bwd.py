"""DASH deterministic flash-attention backward: plain versions and CUDA kernels.

Counterpart of ``repro.kernels.flash_bwd``. Two realizations of one
schedule, bitwise identical to each other on every registry schedule and
each a pure function of the schedule (never of worker timing):

**Worker-parallel** (the default): the schedule's worker axis is a real grid
axis. Each worker plays its chain of :meth:`Schedule.worker_chains`; dK/dV
rows belong to one worker (paper §3.1) and accumulate over the row's
contiguous run; dQ goes to worker-private fp32 partials ``(BH, W, S, D)``,
which :func:`fold_combine` folds in **ascending worker order** — a fixed left
fold whose first visited partial *replaces* the accumulator.

**Serialized** (``worker_parallel=False``, and the fallback whenever a
worker visits a q column twice): one program per bh plays every chain in
turn, worker-major (:meth:`Schedule.prefetch_arrays`); dQ is a fresh write
on a column's first visit and a read-modify-write after that.

On the card these are ``csrc/flash_bwd.cu`` (both backward kernels, which
share one task function) and ``csrc/fold.cu``; on the CPU they are
:func:`worker_bwd_plain`, :func:`serial_bwd_plain` and :func:`fold_plain`,
which compute the same functions task by task in chain order, batched over
bh. :func:`flash_bwd` and :func:`fold_combine` run the kernels for CUDA
tensors and the plain versions for CPU tensors — never one in place of the
other. GQA is native: K/V stay at ``B·Hk`` heads, dK/dV come out per query
head and are folded per KV head in ascending query-head order by the same
fold. Block-sparse masks (``mask=``) come with the masks slice and raise.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import numpy as np
import torch

from repro_torch.core.schedules import Schedule
from repro_torch.kernels import build
from repro_torch.kernels.flash_fwd import BLOCK, HEAD_DIMS, KERNEL_DTYPES
from repro_torch.kernels.gqa import kv_head_index, validate_group

NEG_INF = -1e30

# launches of each CUDA kernel; the wrappers add one per launch and nothing
# else touches them, so a caller can zero them and read how often a run
# used each kernel
launches_worker = 0
launches_serial = 0
launches_fold = 0


# --------------------------------------------------------------------------- #
# schedule serialization (integer arrays, shared with the reference; the
# serialized task list itself is :meth:`Schedule.prefetch_arrays`)
# --------------------------------------------------------------------------- #
def first_visit_flags(kv_ids: np.ndarray, q_ids: np.ndarray) -> np.ndarray:
    """q_first[t] = 1 iff task t is the first in serialized order touching
    q_ids[t]."""
    seen = set()
    flags = np.zeros_like(q_ids)
    for t, q in enumerate(q_ids):
        if int(q) not in seen:
            flags[t] = 1
            seen.add(int(q))
    return flags.astype(np.int32)


# the schedules' task arrays and the GQA fold's all-ones mask as int32
# tensors on the card, copied once per (content, device) and kept here
_DEVICE_ARRAYS: dict = {}


def _device_arrays(schedule: Schedule, kind: str, device) -> dict:
    """The schedule's task arrays (``kind`` "worker" or "serial") as int32
    tensors on ``device``. The cache key holds the chains themselves, so two
    schedules share an entry only when their task lists are equal."""
    key = (kind, schedule.n_q, schedule.chains, str(device))
    if key not in _DEVICE_ARRAYS:
        if kind == "worker":
            wc = schedule.worker_chains()
            arrays = {n: wc[n] for n in ("kv_ids", "q_ids", "valid",
                                         "q_first", "visited")}
        else:
            kv_ids, q_ids = schedule.prefetch_arrays()
            arrays = dict(kv_ids=kv_ids, q_ids=q_ids,
                          q_first=first_visit_flags(kv_ids, q_ids))
        _DEVICE_ARRAYS[key] = {
            n: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
            for n, a in arrays.items()}
    return _DEVICE_ARRAYS[key]


def _all_visited(group: int, n_tiles: int, device) -> torch.Tensor:
    """The GQA dK/dV fold's mask: every query head visits every tile."""
    key = ("ones", group, n_tiles, str(device))
    if key not in _DEVICE_ARRAYS:
        _DEVICE_ARRAYS[key] = torch.ones((group, n_tiles), dtype=torch.int32,
                                         device=device)
    return _DEVICE_ARRAYS[key]


# --------------------------------------------------------------------------- #
# plain versions (any device; used for CPU tensors)
# --------------------------------------------------------------------------- #
def _task_grads(q, k, v, do, lse, delta, kv, qi, *, sm_scale, causal,
                block_q, block_k):
    """One (kv, q) tile of Algorithm 1, batched over bh, in fp32.

    q, do: (BH, block_q, D); k, v: (BH, block_k, D); lse, delta: (BH,
    block_q). Returns the (dq, dk, dv) contributions of the task."""
    s = torch.matmul(q, k.transpose(1, 2)) * sm_scale
    if causal:
        rows = qi * block_q + torch.arange(block_q, device=q.device)[:, None]
        cols = kv * block_k + torch.arange(block_k, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do, v.transpose(1, 2))
    ds = p * (dp - delta[..., None]) * sm_scale
    dv = torch.matmul(p.transpose(1, 2), do)
    dk = torch.matmul(ds.transpose(1, 2), q)
    dq = torch.matmul(ds, k)
    return dq, dk, dv


def _plain_operands(q, k, v, do, n_heads, n_kv_heads):
    """fp32 operands with K/V gathered per query head (BH rows)."""
    kv = kv_head_index(torch.arange(q.shape[0], device=q.device), n_heads,
                       n_kv_heads)
    return q.float(), k.float()[kv], v.float()[kv], do.float()


def worker_bwd_plain(q, k, v, do, lse, delta, wc, sm_scale, causal, block_q,
                     block_k, n_heads, n_kv_heads):
    """The worker-parallel backward task by task: for each worker, its chain
    of ``wc = schedule.worker_chains()`` in order. Returns dq_part (BH, W,
    Sq, D) fp32 (zero where the worker never visits) and dk, dv (BH, Sk, D)
    fp32 per query head."""
    qf, kf, vf, dof = _plain_operands(q, k, v, do, n_heads, n_kv_heads)
    bh, sq, d = qf.shape
    n_workers, n_steps = wc["kv_ids"].shape
    dq_part = torch.zeros((bh, n_workers, sq, d), dtype=torch.float32,
                          device=q.device)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for w in range(n_workers):
        for t in range(n_steps):
            if not wc["valid"][w, t]:
                continue
            kv, qi = int(wc["kv_ids"][w, t]), int(wc["q_ids"][w, t])
            qs = slice(qi * block_q, (qi + 1) * block_q)
            ks = slice(kv * block_k, (kv + 1) * block_k)
            dqc, dkc, dvc = _task_grads(
                qf[:, qs], kf[:, ks], vf[:, ks], dof[:, qs], lse[:, qs],
                delta[:, qs], kv, qi, sm_scale=sm_scale, causal=causal,
                block_q=block_q, block_k=block_k)
            if t == 0 or wc["kv_ids"][w, t - 1] != kv:
                dk[:, ks], dv[:, ks] = dkc, dvc
            else:
                dk[:, ks], dv[:, ks] = dk[:, ks] + dkc, dv[:, ks] + dvc
            if wc["q_first"][w, t]:
                dq_part[:, w, qs] = dqc
            else:
                dq_part[:, w, qs] = dq_part[:, w, qs] + dqc
    return dq_part, dk, dv


def serial_bwd_plain(q, k, v, do, lse, delta, kv_ids, q_ids, q_first,
                     sm_scale, causal, block_q, block_k, n_heads, n_kv_heads):
    """The serialized backward task by task, in the order of the serialized
    arrays. Returns dq (BH, Sq, D), dk, dv (BH, Sk, D) fp32 per query head."""
    qf, kf, vf, dof = _plain_operands(q, k, v, do, n_heads, n_kv_heads)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for t in range(len(kv_ids)):
        kv, qi = int(kv_ids[t]), int(q_ids[t])
        qs = slice(qi * block_q, (qi + 1) * block_q)
        ks = slice(kv * block_k, (kv + 1) * block_k)
        dqc, dkc, dvc = _task_grads(
            qf[:, qs], kf[:, ks], vf[:, ks], dof[:, qs], lse[:, qs],
            delta[:, qs], kv, qi, sm_scale=sm_scale, causal=causal,
            block_q=block_q, block_k=block_k)
        if t == 0 or kv_ids[t - 1] != kv:
            dk[:, ks], dv[:, ks] = dkc, dvc
        else:
            dk[:, ks], dv[:, ks] = dk[:, ks] + dkc, dv[:, ks] + dvc
        if q_first[t]:
            dq[:, qs] = dqc
        else:
            dq[:, qs] = dq[:, qs] + dqc
    return dq, dk, dv


def fold_plain(partials, visited, block):
    """Left fold of ``partials (N, R, S, D)`` over R in ascending order; the
    first visited partial of a tile replaces the accumulator, later ones are
    added; a tile no partial visited is 0. ``visited (R, S // block)`` is an
    int32 tensor."""
    n, r, s, d = partials.shape
    visited = visited.tolist()
    out = torch.zeros((n, s, d), dtype=torch.float32, device=partials.device)
    for ti in range(s // block):
        rows = slice(ti * block, (ti + 1) * block)
        acc = None
        for j in range(r):
            if not visited[j][ti]:
                continue
            part = partials[:, j, rows].float()
            acc = part.clone() if acc is None else acc + part
        if acc is not None:
            out[:, rows] = acc
    return out


# --------------------------------------------------------------------------- #
# CUDA kernels (csrc/flash_bwd.cu, csrc/fold.cu)
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _bwd_lib():
    lib = build.load("flash_bwd")
    worker = lib.dash_flash_bwd_worker
    worker.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
    worker.restype = ctypes.c_int
    serial = lib.dash_flash_bwd_serial
    serial.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
    serial.restype = ctypes.c_int
    return worker, serial


@functools.lru_cache(maxsize=None)
def _fold_lib():
    fn = build.load("fold").dash_fold
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_cuda_operands(q, k, v, do, lse, delta, n_heads, n_kv_heads):
    bh, s, d = q.shape
    tensors = (q, k, v, do, lse, delta)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("the backward kernels need every operand on one "
                         "CUDA device")
    if q.dtype not in KERNEL_DTYPES or not (k.dtype == v.dtype == do.dtype
                                            == q.dtype):
        raise TypeError(f"the backward kernels take one dtype of "
                        f"{KERNEL_DTYPES} for q, k, v, do")
    if lse.dtype != torch.float32 or delta.dtype != torch.float32:
        raise TypeError("lse and delta must be fp32")
    if d not in HEAD_DIMS or s % BLOCK:
        raise ValueError(f"the backward kernels take head_dim in {HEAD_DIMS} "
                         f"and S a multiple of {BLOCK}; got S={s}, "
                         f"head_dim={d}")
    if (k.shape != v.shape or k.shape != (bh // n_heads * n_kv_heads, s, d)
            or do.shape != q.shape or lse.shape != (bh, s)
            or delta.shape != (bh, s)):
        raise ValueError("backward operand shapes do not match q "
                         f"{tuple(q.shape)} at heads {n_heads}/{n_kv_heads}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the backward kernels need contiguous operands")


def _stream(device):
    with torch.cuda.device(device):
        return torch.cuda.current_stream().cuda_stream


def worker_bwd_cuda(q, k, v, do, lse, delta, schedule, sm_scale, causal,
                    n_heads, n_kv_heads):
    """Launch the worker-parallel kernel of ``csrc/flash_bwd.cu``. Returns
    dq_part (BH, W, S, D) fp32 (uninitialised where a worker never visits:
    fold it with ``worker_chains()['visited']``) and dk, dv (BH, S, D) fp32
    per query head."""
    global launches_worker
    _check_cuda_operands(q, k, v, do, lse, delta, n_heads, n_kv_heads)
    bh, s, d = q.shape
    arr = _device_arrays(schedule, "worker", q.device)
    n_workers, n_steps = arr["kv_ids"].shape
    dq_part = torch.empty((bh, n_workers, s, d), dtype=torch.float32,
                          device=q.device)
    dk = torch.empty((bh, s, d), dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    fn, _ = _bwd_lib()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), arr["kv_ids"].data_ptr(),
             arr["q_ids"].data_ptr(), arr["valid"].data_ptr(),
             arr["q_first"].data_ptr(), dq_part.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), bh, s, d, n_heads, n_kv_heads, n_workers, n_steps,
             sm_scale, int(causal), int(q.dtype == torch.bfloat16),
             _stream(q.device))
    if err:
        raise RuntimeError(f"worker-parallel backward kernel failed to "
                           f"launch: cudaError {err}")
    launches_worker += 1
    return dq_part, dk, dv


def serial_bwd_cuda(q, k, v, do, lse, delta, schedule, sm_scale, causal,
                    n_heads, n_kv_heads):
    """Launch the serialized kernel of ``csrc/flash_bwd.cu``. Returns dq, dk,
    dv (BH, S, D) fp32 (dk/dv per query head)."""
    global launches_serial
    _check_cuda_operands(q, k, v, do, lse, delta, n_heads, n_kv_heads)
    bh, s, d = q.shape
    arr = _device_arrays(schedule, "serial", q.device)
    dq = torch.empty((bh, s, d), dtype=torch.float32, device=q.device)
    dk = torch.empty_like(dq)
    dv = torch.empty_like(dq)
    _, fn = _bwd_lib()
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), arr["kv_ids"].data_ptr(),
             arr["q_ids"].data_ptr(), arr["q_first"].data_ptr(),
             dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bh, s, d, n_heads,
             n_kv_heads, int(arr["kv_ids"].shape[0]), sm_scale, int(causal),
             int(q.dtype == torch.bfloat16), _stream(q.device))
    if err:
        raise RuntimeError(f"serialized backward kernel failed to launch: "
                           f"cudaError {err}")
    launches_serial += 1
    return dq, dk, dv


def fold_cuda(partials, visited, block):
    """Launch ``csrc/fold.cu``: ``partials (N, R, S, D)`` fp32 and
    ``visited (R, S // block)`` int32 on the card → ``(N, S, D)`` fp32."""
    global launches_fold
    n, r, s, d = partials.shape
    if not (partials.is_cuda and visited.device == partials.device):
        raise ValueError("fold_cuda needs partials and visited on one CUDA "
                         "device")
    if partials.dtype != torch.float32 or visited.dtype != torch.int32:
        raise TypeError("fold_cuda takes fp32 partials and int32 visited")
    if s % block or (block * d) % 4 or visited.shape != (r, s // block):
        raise ValueError(f"fold_cuda: partials {tuple(partials.shape)}, "
                         f"visited {tuple(visited.shape)}, block {block}")
    if not (partials.is_contiguous() and visited.is_contiguous()):
        raise ValueError("fold_cuda needs contiguous inputs")
    out = torch.empty((n, s, d), dtype=torch.float32, device=partials.device)
    err = _fold_lib()(partials.data_ptr(), visited.data_ptr(),
                      out.data_ptr(), n, r, s, d, block,
                      _stream(partials.device))
    if err:
        raise RuntimeError(f"fold kernel failed to launch: cudaError {err}")
    launches_fold += 1
    return out


def fold_combine(partials, visited, block):
    """Reduce ``partials (N, R, S, D)`` over axis 1 → ``(N, S, D)`` fp32.

    The fold runs in **ascending r order** (r = worker for the dQ combine,
    r = query head within the KV group for the dK/dV combine), one partial
    at a time — a left fold fixed by construction. ``visited (R, S//block)``,
    an int32 tensor on the partials' device, masks partials that were never
    written. CUDA tensors run ``csrc/fold.cu``, CPU tensors
    :func:`fold_plain`.
    """
    if partials.ndim != 4 or tuple(visited.shape) != (
            partials.shape[1], partials.shape[2] // block):
        raise ValueError(f"fold_combine: partials {tuple(partials.shape)} and "
                         f"visited {tuple(visited.shape)} at block {block}")
    if partials.is_cuda:
        return fold_cuda(partials, visited, block)
    if partials.device.type != "cpu" or visited.device.type != "cpu":
        raise ValueError(f"fold_combine runs on CUDA or CPU tensors, not "
                         f"{partials.device} / {visited.device}")
    return fold_plain(partials, visited, block)


# --------------------------------------------------------------------------- #
# host wrapper
# --------------------------------------------------------------------------- #
def flash_bwd(q, k, v, out, lse, do, schedule: Schedule, causal=False,
              sm_scale=None, block_q=128, block_k=128, worker_parallel=True,
              n_heads: Optional[int] = None, n_kv_heads: Optional[int] = None,
              mask=None):
    """DASH backward. q/do/out: (BH, Sq, D); k/v: (B·Hk, Sk, D) — native GQA
    (pass ``n_heads``/``n_kv_heads`` when they differ); lse (BH, Sq) fp32.
    The schedule's (n_kv, n_q) must match (Sk // block_k, Sq // block_q).

    ``worker_parallel=True`` runs the worker-parallel realization and the
    ordered dQ fold; ``False`` the serialized one. A schedule on which a
    worker visits a q column twice, or a worker has no task, falls back to
    the serialized realization (the reference's rule). Returns dq (BH, Sq,
    D), dk/dv (B·Hk, Sk, D), all fp32. CUDA tensors run the kernels (block
    128 only), CPU tensors the plain versions.
    """
    if mask is not None:
        raise NotImplementedError(
            "the masked backward is not ported yet (ROADMAP queue A, masks "
            "slice)")
    bh, sq, d = q.shape
    bkh, sk, _ = k.shape
    if n_heads is None or n_kv_heads is None:
        if bh != bkh:
            raise ValueError("k/v have fewer heads than q: pass n_heads and "
                             "n_kv_heads for native GQA")
        n_heads = n_kv_heads = 1
        group = 1
    else:
        group = validate_group(n_heads, n_kv_heads)
        if bh % n_heads or bkh != (bh // n_heads) * n_kv_heads:
            raise ValueError(f"flattened shapes {bh}x{bkh} inconsistent with "
                             f"heads {n_heads}/{n_kv_heads}")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if causal and block_q != block_k:
        raise ValueError("causal schedules assume square tiles")
    if schedule.causal != causal:
        raise ValueError(f"schedule {schedule.name!r} is for causal="
                         f"{schedule.causal}, the call for causal={causal}")
    if schedule.mask_key is not None:
        raise ValueError("block-sparse schedule requires its mask")
    if schedule.n_kv != sk // block_k or schedule.n_q != sq // block_q:
        raise ValueError(f"schedule ({schedule.n_kv}x{schedule.n_q}) != "
                         f"tiling ({sk // block_k}x{sq // block_q})")
    # D = rowsum(dO ∘ O)  (Alg. 1 line 1 — preprocessing, outside the kernel)
    delta = torch.sum(do.float() * out.float(), dim=-1)

    if worker_parallel:
        try:
            wc = schedule.worker_chains()
            worker_parallel = wc["single_visit"]
        except ValueError:
            worker_parallel = False

    if q.is_cuda:
        if (block_q, block_k) != (BLOCK, BLOCK) or sq != sk:
            raise ValueError(f"the backward kernels are square-tiled at "
                             f"{BLOCK} with Sq == Sk; got blocks "
                             f"({block_q}, {block_k}), S {sq}/{sk}")
        if worker_parallel:
            dq_part, dk, dv = worker_bwd_cuda(q, k, v, do, lse, delta,
                                              schedule, sm_scale, causal,
                                              n_heads, n_kv_heads)
            visited = _device_arrays(schedule, "worker", q.device)["visited"]
            dq = fold_combine(dq_part, visited, block_q)
        else:
            dq, dk, dv = serial_bwd_cuda(q, k, v, do, lse, delta, schedule,
                                         sm_scale, causal, n_heads,
                                         n_kv_heads)
    elif q.device.type == "cpu":
        if worker_parallel:
            dq_part, dk, dv = worker_bwd_plain(q, k, v, do, lse, delta, wc,
                                               sm_scale, causal, block_q,
                                               block_k, n_heads, n_kv_heads)
            dq = fold_combine(dq_part, torch.from_numpy(wc["visited"]),
                              block_q)
        else:
            kv_ids, q_ids = schedule.prefetch_arrays()
            dq, dk, dv = serial_bwd_plain(
                q, k, v, do, lse, delta, kv_ids, q_ids,
                first_visit_flags(kv_ids, q_ids), sm_scale, causal, block_q,
                block_k, n_heads, n_kv_heads)
    else:
        raise ValueError(f"flash_bwd runs on CUDA or CPU tensors, not "
                         f"{q.device}")

    if group > 1:
        # dK/dV were produced per query head; fold each KV-head group in
        # ascending query-head order (query heads of a group are contiguous
        # in the flattened head axis: b·H + kh·g + j ↦ (b·Hk + kh)·g + j).
        ones = _all_visited(group, sk // block_k, q.device)
        dk = fold_combine(dk.reshape(bkh, group, sk, d), ones, block_k)
        dv = fold_combine(dv.reshape(bkh, group, sk, d), ones, block_k)
    return dq, dk, dv
