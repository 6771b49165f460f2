"""Declarative attention-mask specs and their block-level classification.

Port of ``repro.masks.spec``. A :class:`MaskSpec` is a frozen, hashable
description of a boolean attention mask ``mask[q_pos, k_pos]`` ("may query
position q attend to key position k"). Hashability is load-bearing: specs are
lru-cache keys, so two calls with distinct masks can never share a cached
grid or schedule. The class names, field names and field order are the
reference's, so ``repr`` — and with it :meth:`MaskSpec.key`, which hashes
``repr`` — comes out byte-equal to the reference's.

Three evaluation layers, all derived from the one :meth:`MaskSpec.mask_fn`
definition so they cannot drift apart:

  ``materialize(sq, sk)``      dense numpy bool reference;
  ``block_map(n_kv, n_q, bq, bk)``
                               per-tile classification into {EMPTY, PARTIAL,
                               FULL} — EMPTY tiles are removed from kernel
                               grids and schedules, FULL tiles run unmasked,
                               PARTIAL tiles mask-multiply;
  ``mask_fn(rows, cols)``      works on numpy *and* torch index arrays — the
                               plain kernel versions call it (through
                               :meth:`MaskSpec.tile_mask`) on tile iotas. The
                               CUDA kernels evaluate the same predicates from
                               a postfix program of the spec's atoms
                               (``kernels/flash_fwd.py::mask_program``).

Determinism contract for PARTIAL tiles: kernels multiply the probabilities
with the 0/1 mask, so masked lanes contribute **exact zeros** to every
accumulation, and a FULL tile's math is bit for bit the unmasked math.

Atoms are pure predicates; combine with ``&`` / ``|`` (:class:`And` /
:class:`Or`). E.g. the StreamingLLM mask is
``Causal() & (SlidingWindow(w) | Sink(n))`` (see :func:`streaming_mask`).
Every mask must leave each query row at least one visible key;
:meth:`MaskSpec.check` and the block-map classifier assert this.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import Tuple

import numpy as np
import torch

# block classification (int8 in the block map)
EMPTY, PARTIAL, FULL = 0, 1, 2


def _take(table: Tuple[int, ...], idx):
    """Index a static int table with numpy or torch indices."""
    if isinstance(idx, torch.Tensor):
        return torch.as_tensor(table, dtype=torch.int32,
                               device=idx.device)[idx]
    return np.asarray(table, np.int32)[idx]


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Base class. Subclasses implement :meth:`mask_fn` as vectorized index
    math (comparisons / ``&`` / ``|`` only) so one definition serves numpy
    (reference) and torch (plain kernel) evaluation."""

    def mask_fn(self, q, k):
        """Boolean mask over broadcastable int position arrays (q, k)."""
        raise NotImplementedError

    # ------------------------------------------------------ kernel evaluation
    def token_info(self, s: int):
        """Optional per-token int32 metadata of length ``s`` (e.g. Document
        segment ids), handed to the kernels as a real input; position-only
        specs return ``None``."""
        return None

    def tile_mask(self, rows, cols, q_info=None, k_info=None):
        """Mask evaluation on one tile: ``rows``/``cols`` are (bq, bk)
        absolute-position iotas, ``q_info``/``k_info`` the (bq,)/(bk,)
        slices of :meth:`token_info` (ignored by position-only specs)."""
        return self.mask_fn(rows, cols)

    # ------------------------------------------------------------- composition
    def __and__(self, other: "MaskSpec") -> "MaskSpec":
        return And(self, other)

    def __or__(self, other: "MaskSpec") -> "MaskSpec":
        return Or(self, other)

    # ---------------------------------------------------------------- layers
    def materialize(self, sq: int, sk: int = None) -> np.ndarray:
        """Dense (sq, sk) bool reference mask."""
        sk = sq if sk is None else sk
        q = np.arange(sq, dtype=np.int64)[:, None]
        k = np.arange(sk, dtype=np.int64)[None, :]
        return np.asarray(self.mask_fn(q, k), bool)

    def block_map(self, n_kv: int, n_q: int, block_q: int,
                  block_k: int) -> np.ndarray:
        """(n_kv, n_q) int8 classification; ``bm[kv, q]`` ∈ {EMPTY, PARTIAL,
        FULL} — the (kv, q) orientation matches the schedule's task cells."""
        return _block_map(self, n_kv, n_q, block_q, block_k)

    def check(self, sq: int, sk: int = None) -> None:
        """Raise if some query row is fully masked (undefined softmax)."""
        dense = self.materialize(sq, sk)
        bad = np.where(~dense.any(axis=1))[0]
        if bad.size:
            raise ValueError(
                f"{self!r}: query rows {bad[:8].tolist()} attend to nothing")

    def key(self) -> str:
        """Stable short identifier for cache keys / Schedule.mask_key."""
        r = repr(self)
        return f"{type(self).__name__}:{hashlib.sha256(r.encode()).hexdigest()[:12]}"


@functools.lru_cache(maxsize=512)
def _block_map(spec: MaskSpec, n_kv: int, n_q: int, block_q: int,
               block_k: int) -> np.ndarray:
    dense = spec.materialize(n_q * block_q, n_kv * block_k)
    if not dense.any(axis=1).all():
        spec.check(n_q * block_q, n_kv * block_k)  # raises with row detail
    counts = dense.reshape(n_q, block_q, n_kv, block_k).sum(axis=(1, 3))
    bm = np.where(counts == 0, EMPTY,
                  np.where(counts == block_q * block_k, FULL,
                           PARTIAL)).astype(np.int8).T  # → (n_kv, n_q)
    bm.setflags(write=False)
    return bm


# --------------------------------------------------------------------- atoms
@dataclasses.dataclass(frozen=True)
class Full(MaskSpec):
    """Every query sees every key (bidirectional)."""

    def mask_fn(self, q, k):
        return (q >= 0) & (k >= 0)


@dataclasses.dataclass(frozen=True)
class Causal(MaskSpec):
    """q may attend to keys at positions ≤ q (start-aligned, square use)."""

    def mask_fn(self, q, k):
        return q >= k


@dataclasses.dataclass(frozen=True)
class SlidingWindow(MaskSpec):
    """Causal window: q sees the ``window`` most recent keys (incl. itself),
    i.e. positions in ``(q - window, q]``. ``window >= 1``."""

    window: int

    def __post_init__(self):
        assert self.window >= 1, "window must cover at least the token itself"

    def mask_fn(self, q, k):
        return (q >= k) & (k > q - self.window)


@dataclasses.dataclass(frozen=True)
class PrefixLM(MaskSpec):
    """Bidirectional over the prefix ``[0, prefix_len)``, causal beyond it."""

    prefix_len: int

    def mask_fn(self, q, k):
        return (q >= k) | (k < self.prefix_len)


@dataclasses.dataclass(frozen=True)
class Sink(MaskSpec):
    """Keys in ``[0, n_sink)`` are always visible (StreamingLLM attention
    sinks). Pure predicate — compose with Causal()/SlidingWindow for the
    streaming mask (:func:`streaming_mask`)."""

    n_sink: int

    def mask_fn(self, q, k):
        return (k < self.n_sink) & (q >= 0)


@dataclasses.dataclass(frozen=True)
class Document(MaskSpec):
    """Packed-document (segment) mask: q sees k iff both carry the same
    segment id (and causally, by default). ``segment_ids`` is a static
    per-token tuple — the packing layout is part of the spec identity, so two
    packings never share a grid. Square masks only (self-attention over one
    packed sequence)."""

    segment_ids: Tuple[int, ...]
    causal: bool = True

    @classmethod
    def from_lengths(cls, lengths: Tuple[int, ...], causal: bool = True
                     ) -> "Document":
        """Segments 1..len(lengths) laid out back to back."""
        ids = []
        for i, n in enumerate(lengths):
            ids += [i + 1] * n
        return cls(tuple(ids), causal)

    def mask_fn(self, q, k):
        seg = tuple(self.segment_ids)
        same = _take(seg, q) == _take(seg, k)
        return same & (q >= k) if self.causal else same

    def token_info(self, s: int):
        assert s == len(self.segment_ids), (s, len(self.segment_ids))
        return np.asarray(self.segment_ids, np.int32)

    def tile_mask(self, rows, cols, q_info=None, k_info=None):
        same = q_info[:, None] == k_info[None, :]
        return same & (rows >= cols) if self.causal else same

    def materialize(self, sq: int, sk: int = None) -> np.ndarray:
        sk = sq if sk is None else sk
        assert sq == sk == len(self.segment_ids), (
            f"Document mask is square over its {len(self.segment_ids)} packed "
            f"tokens; got ({sq}, {sk})")
        return super().materialize(sq, sk)


# -------------------------------------------------------------- combinators
class _Binary(MaskSpec):
    def token_info(self, s: int):
        ia, ib = self.a.token_info(s), self.b.token_info(s)
        if ia is not None and ib is not None:
            assert (ia == ib).all(), (
                "composed specs carry conflicting token_info tables — the "
                "kernels thread exactly one q_info/k_info input pair")
            return ia
        return ia if ia is not None else ib


@dataclasses.dataclass(frozen=True)
class And(_Binary):
    a: MaskSpec
    b: MaskSpec

    def mask_fn(self, q, k):
        return self.a.mask_fn(q, k) & self.b.mask_fn(q, k)

    def tile_mask(self, rows, cols, q_info=None, k_info=None):
        return (self.a.tile_mask(rows, cols, q_info, k_info)
                & self.b.tile_mask(rows, cols, q_info, k_info))


@dataclasses.dataclass(frozen=True)
class Or(_Binary):
    a: MaskSpec
    b: MaskSpec

    def mask_fn(self, q, k):
        return self.a.mask_fn(q, k) | self.b.mask_fn(q, k)

    def tile_mask(self, rows, cols, q_info=None, k_info=None):
        return (self.a.tile_mask(rows, cols, q_info, k_info)
                | self.b.tile_mask(rows, cols, q_info, k_info))


def streaming_mask(window: int, n_sink: int) -> MaskSpec:
    """The StreamingLLM mask: causal ∧ (recent window ∨ attention sinks)."""
    return Causal() & (SlidingWindow(window) | Sink(n_sink))
