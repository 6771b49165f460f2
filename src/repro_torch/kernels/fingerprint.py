"""The live state fingerprint's per-leaf reduction: plain version and CUDA kernel.

Counterpart of ``repro.verify.digest._leaf_fp``, which XLA computes inside
the reference's jitted step. For one leaf, with ``bits[i]`` the i-th
element's bit pattern as a uint32 in C order (bf16 and f16 zero-extended
from their 16 bits, fp32 and int32 as they are, int8 sign-extended as
``astype(uint32)`` does, uint8 and bool zero-extended),

    fp = sum_i bits[i] * (i * 2654435761 + 1)   (mod 2**32).

The reference's order of leaves and its salted combine are
``repro_torch.verify.digest.tree_fingerprint``; this module gives the
per-leaf values. :func:`leaf_fingerprints` runs ``csrc/fingerprint.cu`` for
CUDA tensors (one launch over all of them: a CTA a fixed chunk of a leaf,
then a pass that adds each leaf's chunks) and :func:`fingerprint_plain` for
CPU tensors, never one in place of the other. The plain version computes in
int64 masked to 32 bits, in chunks, so its temporaries stay bounded.
Covered dtypes: bf16, f16, fp32, int32, int8, uint8, bool; any other raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build

GOLDEN = 2654435761
MASK32 = 0xFFFFFFFF
# the bit kinds of csrc/fingerprint.cu
KINDS = {torch.bfloat16: 0, torch.float16: 0, torch.float32: 1,
         torch.int32: 1, torch.int8: 2, torch.uint8: 3, torch.bool: 3}
# bytes of one leaf a CTA reduces (a multiple of 16, so every chunk of an
# aligned leaf starts aligned)
CHUNK_BYTES = 1 << 18
# elements a step of the plain version takes
_PLAIN_CHUNK = 1 << 22

# calls that launched the kernel (each call is its two passes); the wrapper
# adds one a call and nothing else touches it
launches = 0


def _check_dtype(x: torch.Tensor) -> None:
    if x.dtype not in KINDS:
        raise TypeError(f"the state fingerprint covers "
                        f"{sorted(str(d) for d in KINDS)}; got {x.dtype}")


def _bits(flat: torch.Tensor) -> torch.Tensor:
    """int64 bit patterns in [0, 2**32) of a flat tensor."""
    if flat.dtype in (torch.bfloat16, torch.float16):
        return flat.view(torch.int16).to(torch.int64) & 0xFFFF
    if flat.dtype in (torch.float32, torch.int32):
        return flat.view(torch.int32).to(torch.int64) & MASK32
    return flat.to(torch.int64) & MASK32


def fingerprint_plain(x: torch.Tensor) -> int:
    """One leaf's fingerprint on any device, in int64 arithmetic masked to
    32 bits: ``bits * weight mod 2**32`` as the low and high 16-bit halves
    of the weight, so no product leaves int64."""
    _check_dtype(x)
    flat = x.detach().contiguous().reshape(-1)
    total = 0
    for start in range(0, flat.numel(), _PLAIN_CHUNK):
        part = flat[start:start + _PLAIN_CHUNK]
        bits = _bits(part)
        idx = torch.arange(start, start + part.numel(), dtype=torch.int64,
                           device=flat.device)
        w = (idx * (GOLDEN & 0xFFFF)
             + (((idx * (GOLDEN >> 16)) & 0xFFFF) << 16) + 1) & MASK32
        prod = (bits * (w & 0xFFFF)
                + (((bits * (w >> 16)) & 0xFFFF) << 16)) & MASK32
        total += int(prod.sum())
    return total & MASK32


# --------------------------------------------------------------------------- #
# CUDA kernel (csrc/fingerprint.cu)
# --------------------------------------------------------------------------- #
@functools.lru_cache(maxsize=None)
def _lib():
    fn = build.load("fingerprint").dash_fingerprint
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=8)
def _layout(structure: Tuple[Tuple[int, int], ...], device: str):
    """The device tables of one tree structure ``((numel, kind), ...)``:
    numels, kinds, each chunk's leaf and first element, each leaf's first
    chunk. Built once a structure and device; the pointers change every
    call and are copied per call."""
    numels = np.array([n for n, _ in structure], np.int64)
    kinds = np.array([k for _, k in structure], np.int32)
    per_chunk = CHUNK_BYTES // np.array([2, 4, 1, 1], np.int64)[kinds]
    n_chunks = -(-numels // per_chunk)
    chunk0 = np.concatenate([[0], np.cumsum(n_chunks)]).astype(np.int32)
    chunk_leaf = np.repeat(np.arange(len(structure), dtype=np.int32),
                           n_chunks)
    chunk_start = (np.arange(int(chunk0[-1]), dtype=np.int64)
                   - np.repeat(chunk0[:-1].astype(np.int64), n_chunks)
                   ) * np.repeat(per_chunk, n_chunks)
    dev = torch.device(device)
    return (int(chunk0[-1]),
            *(torch.from_numpy(a).to(dev) for a in
              (numels, kinds, chunk_leaf, chunk_start, chunk0)))


class Plan(NamedTuple):
    """One tree's launch of ``csrc/fingerprint.cu``: the contiguous leaves
    (kept alive while the plan is), their pointers and the structure's
    tables on the card, and the buffers the two passes write."""
    flats: List[torch.Tensor]
    ptrs: torch.Tensor
    n_chunks: int
    tables: Tuple[torch.Tensor, ...]
    partials: torch.Tensor
    out: torch.Tensor


def plan_cuda(leaves: Sequence[torch.Tensor]) -> Plan:
    """The :class:`Plan` of ``leaves`` (CUDA tensors on one device, at least
    one). A non-contiguous leaf is made contiguous first."""
    device = leaves[0].device
    if not all(x.is_cuda and x.device == device for x in leaves):
        raise ValueError("the fingerprint kernel needs every leaf on one "
                         "CUDA device")
    for x in leaves:
        _check_dtype(x)
    flats = [x.detach().contiguous() for x in leaves]
    n_chunks, *tables = _layout(
        tuple((x.numel(), KINDS[x.dtype]) for x in flats), str(device))
    ptrs = torch.tensor([x.data_ptr() for x in flats], dtype=torch.int64
                        ).to(device)
    return Plan(flats, ptrs, n_chunks, tuple(tables),
                torch.empty(max(1, n_chunks), dtype=torch.int32,
                            device=device),
                torch.empty(len(flats), dtype=torch.int32, device=device))


def launch_cuda(plan: Plan) -> torch.Tensor:
    """Launch both passes of ``csrc/fingerprint.cu`` on the current stream →
    ``plan.out``, each leaf's fingerprint as an int32 on the card."""
    global launches
    err = _lib()(plan.ptrs.data_ptr(),
                 *(t.data_ptr() for t in plan.tables), plan.n_chunks,
                 len(plan.flats), CHUNK_BYTES, plan.partials.data_ptr(),
                 plan.out.data_ptr(),
                 torch.cuda.current_stream(plan.out.device).cuda_stream)
    if err:
        raise RuntimeError(f"fingerprint kernel failed to launch: "
                           f"cudaError {err}")
    launches += 1
    return plan.out


def leaf_fingerprints_cuda(leaves: Sequence[torch.Tensor]) -> List[int]:
    """Launch ``csrc/fingerprint.cu`` over ``leaves`` (CUDA tensors on one
    device) → each leaf's fingerprint, after one device→host copy of the
    per-leaf values."""
    if not leaves:
        return []
    return [v & MASK32 for v in launch_cuda(plan_cuda(leaves)).cpu().tolist()]


def leaf_fingerprints(leaves: Sequence[torch.Tensor]) -> List[int]:
    """Each leaf's fingerprint: the CUDA leaves in one launch of the kernel
    (they must share one device), the CPU leaves through
    :func:`fingerprint_plain`."""
    out: List[int] = [0] * len(leaves)
    on_card = [i for i, x in enumerate(leaves) if x.is_cuda]
    for i, fp in zip(on_card, leaf_fingerprints_cuda(
            [leaves[i] for i in on_card])):
        out[i] = fp
    for i, x in enumerate(leaves):
        if x.is_cuda:
            continue
        if x.device.type != "cpu":
            raise ValueError(f"the fingerprint runs on CUDA or CPU tensors, "
                             f"not {x.device}")
        out[i] = fingerprint_plain(x)
    return out
