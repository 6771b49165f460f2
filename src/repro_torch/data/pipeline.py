"""Deterministic, stateless training data.

Port of ``repro.data.pipeline``. ``batch(step)`` is a pure function of
(seed, step): a restart at step k reproduces the exact token stream without
replaying k steps. Each step draws one constant-size **global** batch and a
host takes its contiguous slice, so any host split concatenates back to the
same global batch (the reference's v2 contract).

Three sources:
  * :class:`SyntheticLM` — random tokens;
  * :class:`MemmapCorpus` — windows of a flat ``uint32`` token file, their
    starts drawn per step (deterministic shuffling, no replay state);
  * :class:`PackedDocs` — random documents packed by :func:`pack_documents`
    into multi-document rows with segment ids and per-document positions.

The port's streams are its own: the reference keys ``jax.random`` threefry by
``fold_in(seed, step)`` (and a stream tag), the port seeds a CPU
``torch.Generator`` from a sha256 of (seed, step, tag). Token values, window
starts and document lengths therefore differ between the packages; tests that
compare the packages feed both the reference's batches. Draws happen on the
CPU, whatever the device, so a stream does not depend on it; the batch is then
moved to ``device``. :func:`pack_documents` has no randomness and equals the
reference's array for array.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional

import numpy as np
import torch

DATA_STREAM_VERSION = 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq: int = 128
    vocab: int = 32_000
    path: Optional[str] = None        # memmap corpus (uint32); None = synthetic
    host_index: int = 0
    host_count: int = 1


def step_generator(seed: int, step: int, tag: Optional[int] = None
                   ) -> torch.Generator:
    """A CPU generator seeded from (seed, step) and an optional stream tag;
    distinct tags give independent streams of one step."""
    key = f"repro_torch.data|{seed}|{step}" + ("" if tag is None
                                                else f"|{tag}")
    digest = hashlib.sha256(key.encode()).digest()
    return torch.Generator().manual_seed(int.from_bytes(digest[:8], "little")
                                         >> 1)


def _check_split(cfg: DataConfig):
    if cfg.batch % cfg.host_count:
        raise ValueError(f"batch {cfg.batch} does not split over "
                         f"{cfg.host_count} hosts")


def _host_rows(cfg: DataConfig) -> slice:
    per_host = cfg.batch // cfg.host_count
    return slice(cfg.host_index * per_host, (cfg.host_index + 1) * per_host)


class SyntheticLM:
    def __init__(self, cfg: DataConfig, device="cpu"):
        _check_split(cfg)
        self.cfg = cfg
        self.device = torch.device(device)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        c = self.cfg
        toks = torch.randint(0, c.vocab, (c.batch, c.seq + 1),
                             generator=step_generator(c.seed, step),
                             dtype=torch.int64)
        toks = toks[_host_rows(c)].to(self.device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class MemmapCorpus:
    """Windows of ``seq + 1`` tokens from a flat ``uint32`` file: per step
    one constant-size global draw of window indices (stream tag
    ``_IDX_TAG``), the host's slice read from the file."""

    _IDX_TAG = 100

    def __init__(self, cfg: DataConfig, device="cpu"):
        _check_split(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.data = np.memmap(cfg.path, dtype=np.uint32, mode="r")
        self.n_windows = (len(self.data) - 1) // cfg.seq
        if self.n_windows < 1:
            raise ValueError(f"{cfg.path}: {len(self.data)} tokens hold no "
                             f"window of {cfg.seq + 1}")

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        c = self.cfg
        idx = torch.randint(0, self.n_windows, (c.batch,),
                            generator=step_generator(c.seed, step,
                                                     self._IDX_TAG))
        starts = idx[_host_rows(c)].numpy() * c.seq
        rows = np.stack([self.data[s:s + c.seq + 1].astype(np.int64)
                         for s in starts])
        rows = torch.from_numpy(rows).to(self.device)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


# --------------------------------------------------------------------------- #
# deterministic sequence packing (multi-document rows + segment masks)
# --------------------------------------------------------------------------- #
def pack_documents(docs, seq: int, pad_id: int = 0):
    """Greedy first-fit-in-order packer → the packed-batch format.

    Pure function of (docs, seq): documents are placed in order, each into the
    current row while it fits, else a new row opens.

    Returns a dict of int32 numpy arrays, all (n_rows, seq):
      ``tokens``       packed token ids, ``pad_id`` in the tail slack;
      ``labels``       next token *within the same document*; -100 on the last
                       token of each document and on padding (the CE mask);
      ``segment_ids``  1-based document id per token, 0 on padding;
      ``positions``    RoPE positions restarting at 0 inside each document.

    A document longer than ``seq`` is split into ``seq``-sized pieces that keep
    distinct segment ids (a piece boundary behaves like a document boundary).
    """
    pieces = []
    for doc in docs:
        doc = np.asarray(doc, np.int32).reshape(-1)
        if doc.size == 0:
            raise ValueError("empty document")
        for s in range(0, doc.size, seq):
            pieces.append(doc[s:s + seq])

    rows, row, used = [], [], 0
    for piece in pieces:
        if used + piece.size > seq:
            rows.append(row)
            row, used = [], 0
        row.append(piece)
        used += piece.size
    if row:
        rows.append(row)

    n = len(rows)
    tokens = np.full((n, seq), pad_id, np.int32)
    labels = np.full((n, seq), -100, np.int32)
    segment_ids = np.zeros((n, seq), np.int32)
    positions = np.zeros((n, seq), np.int32)
    seg = 0
    for r, row_pieces in enumerate(rows):
        off = 0
        for piece in row_pieces:
            seg += 1
            ln = piece.size
            tokens[r, off:off + ln] = piece
            labels[r, off:off + ln - 1] = piece[1:]   # last token: no target
            segment_ids[r, off:off + ln] = seg
            positions[r, off:off + ln] = np.arange(ln)
            off += ln
    return {"tokens": tokens, "labels": labels,
            "segment_ids": segment_ids, "positions": positions}


class PackedDocs:
    """Synthetic packed-document source: deterministic multi-doc rows with
    segment ids and per-document positions.

    Per step, document lengths (stream tag ``_LEN_TAG``) and tokens
    (``_TOK_TAG``) are drawn in constant-size draws and packed by
    :func:`pack_documents` into exactly ``cfg.batch`` global rows; each host
    takes its contiguous row slice. Batches are int64 tensors on ``device``.
    """

    # distinct stream tags: the doc-length and token draws never alias the
    # SyntheticLM stream (no tag) or each other
    _LEN_TAG, _TOK_TAG = 101, 102

    def __init__(self, cfg: DataConfig, min_doc: int = 16,
                 max_doc: Optional[int] = None, device="cpu"):
        _check_split(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.min_doc = min_doc
        self.max_doc = max_doc or cfg.seq // 2
        # loud, not clamped: an empty range would quietly disable packing
        if not self.min_doc <= self.max_doc <= cfg.seq:
            raise ValueError(f"need min_doc <= max_doc <= seq, got "
                             f"{self.min_doc}/{self.max_doc}/{cfg.seq}")

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        c = self.cfg
        # token budget: first-fit wastes < max_doc slack per row, so docs
        # totaling 2·batch·seq tokens always fill >= batch rows
        budget = 2 * c.batch * c.seq
        n_docs = budget // self.min_doc + 1           # worst case: all minimal
        lens = torch.randint(self.min_doc, self.max_doc + 1, (n_docs,),
                             generator=step_generator(c.seed, step,
                                                      self._LEN_TAG)).numpy()
        toks = torch.randint(0, c.vocab, (budget + self.max_doc,),
                             generator=step_generator(c.seed, step,
                                                      self._TOK_TAG),
                             dtype=torch.int32).numpy()
        docs, off = [], 0
        for ln in lens:
            if off >= budget:
                break                                  # token budget consumed
            docs.append(toks[off:off + int(ln)])
            off += int(ln)
        packed = pack_documents(docs, c.seq)
        if packed["tokens"].shape[0] < c.batch:
            raise RuntimeError("the packer filled fewer rows than the batch")
        rows = _host_rows(c)
        return {k: torch.from_numpy(v[:c.batch][rows]).long().to(self.device)
                for k, v in packed.items()}


def make_source(cfg: DataConfig, device="cpu"):
    return (MemmapCorpus(cfg, device) if cfg.path
            else SyntheticLM(cfg, device))
