"""Flash-attention forward, causal, full and block-sparse mask: task grids,
plain versions and CUDA kernels.

Counterpart of ``repro.kernels.flash_fwd``. The TPU kernel
``_fwd_sched_kernel`` walks the task list of :func:`causal_grid`
(descending q tiles, kv ascending within a q tile, fully masked tiles never
visited) on a sequential grid axis; ``_fwd_kernel`` walks the dense
``(bh, n_q, n_k)`` grid; ``_fwd_mask_kernel`` walks :func:`mask_grid`'s task
list for a :class:`~repro_torch.masks.spec.MaskSpec` (EMPTY tiles never
visited, PARTIAL tiles mask-multiplied with exact-zero lanes). On the card
all three are one kernel template per dtype in ``csrc/flash_fwd.cu``: each
(bh, q tile) a work item, its kv loop ascending — causal, stopping at the
diagonal tile; block-sparse, over the q tile's live tiles, with the spec
lowered to a small program (:func:`mask_program`) that the kernel runs on
PARTIAL tiles. In bf16 the kernel is persistent (one CTA an SM walking
:func:`persistent_items`): a producer warpgroup streams K/V
tiles through a ring of :func:`fwd_stages` shared-memory stages with TMA and
two consumer warpgroups run both products on ``wgmma`` (see the note in the
source); :func:`fwd_smem_bytes` is the shared memory that takes.

:func:`flash_fwd` validates, then runs the kernel for CUDA tensors and the
plain version (:func:`flash_fwd_plain`: a dense softmax in fp32, or under a
mask the reference's online-softmax tile body over :func:`mask_grid`'s
chains) for CPU tensors — never one in place of the other.
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
from repro_torch.masks import spec as M

BLOCK = 128                  # the CUDA kernel's square tile
HEAD_DIMS = (32, 64, 128)    # head dims the CUDA kernel is instantiated for
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

NEG_INF = -1e30              # the reference's masked-score sentinel

# the bf16 kernel's shared memory: a block may use 232,448 bytes on an H100
SMEM_MAX = 232448
MAX_STAGES = 4

# launches of the causal, the full-mask and the block-sparse CUDA kernel;
# the wrapper adds one per launch and nothing else touches them, so a caller
# can zero them and read how often a run used each kernel
launches = 0
launches_full = 0
launches_mask = 0


def fwd_smem_bytes(head_dim: int, stages: int) -> int:
    """Dynamic shared memory of the bf16 kernel (``csrc/flash_fwd.cu``
    computes the same): 1024 bytes of alignment slack, two 128-row Q tiles,
    ``stages`` K/V tile pairs and the staged output tile, and an 8-byte
    full/empty mbarrier pair for each Q tile and each stage."""
    return (1024 + BLOCK * head_dim * 2 * (3 + 2 * stages)
            + 8 * (4 + 2 * stages))


def fwd_stages(head_dim: int) -> int:
    """The K/V ring depth of the bf16 kernel: the most stages, up to
    :data:`MAX_STAGES`, whose shared memory fits one block (2 at least)."""
    for stages in range(MAX_STAGES, 2, -1):
        if fwd_smem_bytes(head_dim, stages) <= SMEM_MAX:
            return stages
    return 2


def persistent_items(n_bh: int, n_q: int, n_ctas: int):
    """The bf16 kernel's persistent schedule, as the kernel computes it:
    ``n_ctas`` CTAs (``min(SMs, n_bh · n_q)``) share the ``n_bh · n_q``
    work items, item ``w`` being ``(bh = w % n_bh, rank = w // n_bh)`` where
    rank 0 is the longest q tile (causal and full: q tile ``n_q - 1 -
    rank``; block-sparse: ``order[rank]`` of :func:`mask_arrays`). CTA ``c``
    takes items ``k·n_ctas + c`` in even rounds ``k`` and ``k·n_ctas +
    n_ctas - 1 - c`` in odd ones, so it walks its items longest first.
    Returns each CTA's (bh, rank) list in the order it runs them."""
    total = n_bh * n_q
    schedule = []
    for c in range(n_ctas):
        items, k = [], 0
        while True:
            w = k * n_ctas + (c if k % 2 == 0 else n_ctas - 1 - c)
            if w >= total:
                break
            items.append((w % n_bh, w // n_bh))
            k += 1
        schedule.append(items)
    return schedule


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


@functools.lru_cache(maxsize=256)
def mask_grid(mask_spec, n_q: int, n_k: int, block_q: int, block_k: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                         np.ndarray]:
    """(kv_ids, q_ids, first, last, partial) int32 task arrays for a
    block-sparse mask forward.

    Same traversal as :func:`causal_grid` — descending q tiles, kv ascending
    within each q tile's online-softmax chain — but the valid set comes from
    the mask spec's block map: EMPTY tiles are excluded by construction, and
    ``partial`` flags the PARTIAL tiles. Cached on the (hashable) spec, so
    distinct masks never share a grid.
    """
    bm = mask_spec.block_map(n_k, n_q, block_q, block_k)      # (n_kv, n_q)
    kv_ids, q_ids, first, last, partial = [], [], [], [], []
    for qi in range(n_q - 1, -1, -1):
        ks = [ki for ki in range(n_k) if bm[ki, qi] != M.EMPTY]
        assert ks, (f"{mask_spec!r}: q tile {qi} attends to nothing — "
                    "undefined softmax rows")
        for j, ki in enumerate(ks):
            kv_ids.append(ki)
            q_ids.append(qi)
            first.append(1 if j == 0 else 0)
            last.append(1 if j == len(ks) - 1 else 0)
            partial.append(1 if bm[ki, qi] == M.PARTIAL else 0)
    return tuple(np.asarray(a, np.int32)
                 for a in (kv_ids, q_ids, first, last, partial))


# ------------------------------------------------------------------ masks
# the instruction set of csrc/mask_program.cuh
OP_FULL, OP_CAUSAL, OP_WINDOW, OP_PREFIX, OP_SINK = 0, 1, 2, 3, 4
OP_DOC, OP_DOC_CAUSAL, OP_AND, OP_OR = 5, 6, 7, 8
MAX_PROGRAM = 16


def mask_program(mask) -> Tuple[Tuple[int, int], ...]:
    """The spec as the kernels' postfix program of (op, arg) pairs: one
    instruction per atom, AND / OR after their two operands. Raises for a
    spec type outside ``masks.spec`` — the CUDA path never approximates a
    mask (a program longer than the kernels take raises when it is handed
    to them)."""
    kind = type(mask)
    if kind is M.And or kind is M.Or:
        return (mask_program(mask.a) + mask_program(mask.b)
                + ((OP_AND if kind is M.And else OP_OR, 0),))
    atoms = {M.Full: lambda m: (OP_FULL, 0),
             M.Causal: lambda m: (OP_CAUSAL, 0),
             M.SlidingWindow: lambda m: (OP_WINDOW, m.window),
             M.PrefixLM: lambda m: (OP_PREFIX, m.prefix_len),
             M.Sink: lambda m: (OP_SINK, m.n_sink),
             M.Document: lambda m: (OP_DOC_CAUSAL if m.causal else OP_DOC,
                                    0)}
    if kind not in atoms:
        raise ValueError(f"the CUDA kernels evaluate the atoms of "
                         f"repro_torch.masks.spec and their And/Or; got "
                         f"{kind.__name__}")
    return (atoms[kind](mask),)


def _program_array(mask) -> ctypes.Array:
    """The host array ``[n, op_0, arg_0, ...]`` a kernel entry takes."""
    prog = mask_program(mask)
    if len(prog) > MAX_PROGRAM:
        raise ValueError(f"{mask!r} lowers to {len(prog)} instructions; the "
                         f"kernels take at most {MAX_PROGRAM}")
    flat = [len(prog)] + [x for pair in prog for x in pair]
    return (ctypes.c_int * len(flat))(*flat)


def token_info(mask, s: int, device) -> torch.Tensor:
    """The spec's int32 token_info as a tensor on ``device`` (zeros for a
    position-only spec, as the reference hands its kernels)."""
    info = mask.token_info(s)
    info = np.zeros((s,), np.int32) if info is None else info
    return torch.from_numpy(np.ascontiguousarray(info, np.int32)).to(device)


# each mask's device arrays (the forward grid in CSR form, token_info) and
# its host program, kept per (spec, tiling, device); the key holds the spec
# itself, so two masks never share an entry
_MASK_ARRAYS: dict = {}


def mask_arrays(mask, s: int, block: int, device) -> dict:
    """``row_start``/``kv_ids``/``partial``: :func:`mask_grid`'s tasks per q
    tile, kv ascending (CSR over q tiles); ``order``: the q tiles in launch
    order, longest chain first (ties: descending q, the grid's order);
    ``info``: token_info; ``prog``: the host program."""
    key = (mask, s, block, str(device))
    if key not in _MASK_ARRAYS:
        n = s // block
        kv_ids, q_ids, _, _, partial = mask_grid(mask, n, n, block, block)
        by_q = np.argsort(q_ids, kind="stable")     # kv stays ascending
        counts = np.bincount(q_ids, minlength=n)
        row_start = np.concatenate([[0], np.cumsum(counts)])
        order = sorted(range(n), key=lambda qi: (-counts[qi], -qi))
        host = dict(row_start=row_start, kv_ids=kv_ids[by_q],
                    partial=partial[by_q], order=np.asarray(order))
        arrays = {name: torch.from_numpy(np.ascontiguousarray(
            a, np.int32)).to(device) for name, a in host.items()}
        arrays["info"] = token_info(mask, s, device)
        arrays["prog"] = _program_array(mask)
        _MASK_ARRAYS[key] = arrays
    return _MASK_ARRAYS[key]


def flash_fwd_plain(q, k, v, sm_scale, n_heads, n_kv_heads, causal=True,
                    mask=None, block_q=BLOCK, block_k=BLOCK):
    """The forward in fp32 on any device: without a mask, the oracle
    ``ref.mha_fwd`` (a dense softmax) on K/V gathered per query head; with
    one, the reference's ``_fwd_body`` — online softmax, masked lanes at
    NEG_INF and multiplied by the 0/1 ``tile_mask`` — tile by tile over
    :func:`mask_grid`'s chains, batched over bh.

    q (BH, Sq, D); k, v (B·Hk, Sk, D). Returns out (BH, Sq, D) in q's dtype
    and lse (BH, Sq) fp32 — the function the CUDA kernels compute.
    """
    kv = kv_head_index(torch.arange(q.shape[0], device=q.device), n_heads,
                       n_kv_heads)
    if mask is None:
        return ref.mha_fwd(q, k[kv], v[kv], causal=causal, sm_scale=sm_scale)
    qf, kf, vf = q.float(), k.float()[kv], v.float()[kv]
    bh, s, d = qf.shape
    kv_ids, q_ids, first, last, _ = mask_grid(mask, s // block_q,
                                              s // block_k, block_q, block_k)
    info = token_info(mask, s, q.device)
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    iq = torch.arange(block_q, device=q.device)[:, None]
    ik = torch.arange(block_k, device=q.device)[None, :]
    for t in range(len(kv_ids)):
        qi, ki = int(q_ids[t]), int(kv_ids[t])
        qs = slice(qi * block_q, (qi + 1) * block_q)
        ks = slice(ki * block_k, (ki + 1) * block_k)
        if first[t]:
            acc = torch.zeros((bh, block_q, d), dtype=torch.float32,
                              device=q.device)
            m = torch.full((bh, block_q, 1), NEG_INF, device=q.device)
            l = torch.zeros((bh, block_q, 1), device=q.device)
        sc = torch.matmul(qf[:, qs], kf[:, ks].transpose(1, 2)) * sm_scale
        msk = mask.tile_mask(qi * block_q + iq, ki * block_k + ik, info[qs],
                             info[ks])
        sc = torch.where(msk, sc, torch.full_like(sc, NEG_INF))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new) * msk.float()
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vf[:, ks])
        m = m_new
        if last[t]:
            l_safe = torch.where(l == 0, torch.ones_like(l), l)
            out[:, qs] = (acc / l_safe).to(q.dtype)
            lse[:, qs] = (m + torch.log(l_safe))[..., 0]
    return out, lse


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
    masked = lib.dash_flash_fwd_mask
    masked.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    masked.restype = ctypes.c_int
    return causal, full, masked


def kernel_smem_bytes(head_dim: int, dtype) -> int:
    """The dynamic shared memory the built library launches with for
    ``head_dim`` and ``dtype`` (-1 for a head_dim it has no instance of)."""
    fn = build.load("flash_fwd").dash_flash_fwd_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(head_dim, int(dtype == torch.bfloat16))


def _check_cuda_operands(q, k, v, n_heads, n_kv_heads, square):
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
    if square and sk != s:
        raise ValueError("the causal and block-sparse kernels take sq == sk")
    if k.shape != v.shape or k.shape != (bh // n_heads * n_kv_heads, sk, d):
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} at heads {n_heads}/{n_kv_heads}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd_cuda needs contiguous q, k, v")


def flash_fwd_cuda(q, k, v, sm_scale, n_heads, n_kv_heads, causal=True):
    """Launch ``csrc/flash_fwd.cu`` (causal or full-mask entry point) on
    PyTorch's current stream.

    Raises on anything the kernel does not take instead of computing it
    another way. Returns (out, lse) like :func:`flash_fwd_plain`.
    """
    global launches, launches_full
    _check_cuda_operands(q, k, v, n_heads, n_kv_heads, causal)
    bh, s, d = q.shape
    sk = k.shape[1]
    fn_causal, fn_full, _ = _lib()
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


def flash_fwd_mask_cuda(q, k, v, sm_scale, n_heads, n_kv_heads, mask):
    """Launch the block-sparse entry point of ``csrc/flash_fwd.cu`` for the
    mask spec ``mask`` (square, 128-tiled) on PyTorch's current stream.
    Raises on anything the kernel does not take, a mask it cannot evaluate
    included. Returns (out, lse) like :func:`flash_fwd_plain`."""
    global launches_mask
    _check_cuda_operands(q, k, v, n_heads, n_kv_heads, True)
    bh, s, d = q.shape
    arr = mask_arrays(mask, s, BLOCK, q.device)
    _, _, fn = _lib()
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 lse.data_ptr(), arr["row_start"].data_ptr(),
                 arr["kv_ids"].data_ptr(), arr["partial"].data_ptr(),
                 arr["order"].data_ptr(), arr["info"].data_ptr(),
                 ctypes.addressof(arr["prog"]), bh, s, d, n_heads,
                 n_kv_heads, sm_scale, int(q.dtype == torch.bfloat16), stream)
    if err:
        raise RuntimeError(f"block-sparse flash_fwd CUDA kernel failed to "
                           f"launch: cudaError {err}")
    launches_mask += 1
    return out, lse


def flash_fwd(q, k, v, causal=False, sm_scale=None, block_q=128, block_k=128,
              n_heads: Optional[int] = None, n_kv_heads: Optional[int] = None,
              mask=None):
    """Flash attention forward (causal, full or block-sparse mask).

    Args:   q: (BH, Sq, D); k, v: (B·Hk, Sk, D) — pass ``n_heads``/
            ``n_kv_heads`` when the head counts differ (native GQA; no KV
            repetition). Sq, Sk divisible by the block sizes; causal needs
            Sq == Sk.
            mask: optional :class:`repro_torch.masks.spec.MaskSpec` —
            block-sparse grid (EMPTY tiles skipped, PARTIAL tiles
            mask-multiplied with exact-zero lanes). Excludes ``causal``;
            square masks only.
    Returns: out (BH, Sq, D) q.dtype, lse (BH, Sq) fp32.

    CUDA tensors go through the kernels (block 128 only); CPU tensors
    through :func:`flash_fwd_plain`.
    """
    bh, sq, d = q.shape
    sk = k.shape[1]
    if mask is not None and causal:
        raise ValueError("mask supersedes the causal flag")
    if mask is not None and sq != sk:
        raise ValueError("block-sparse masks are square")
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
        if mask is not None:
            return flash_fwd_mask_cuda(q, k, v, sm_scale, n_heads,
                                       n_kv_heads, mask)
        return flash_fwd_cuda(q, k, v, sm_scale, n_heads, n_kv_heads, causal)
    if q.device.type != "cpu":
        raise ValueError(f"flash_fwd runs on CUDA or CPU tensors, not "
                         f"{q.device}")
    return flash_fwd_plain(q, k, v, sm_scale, n_heads, n_kv_heads, causal,
                           mask=mask, block_q=block_q, block_k=block_k)
