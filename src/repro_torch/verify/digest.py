"""Canonical bitwise tree digests + per-step digest chains.

Port of ``repro.verify.digest`` (without the in-graph fingerprint). The
digest of a leaf is sha256 over ``dtype|shape|raw bytes`` of the
C-contiguous host copy, with numpy's dtype names and shape tuples and bf16
hashed through its 2-byte bit pattern, so equal values digest equally in
both packages: ``tree_digest`` of a bridged parameter tree equals the
reference's ``tree_digest`` of the original. Trees are nested dicts; paths
are the keys joined by ``/``.

A :class:`DigestChain` folds one digest per step into a running sha256 —
two training runs are bitwise-conformant iff their chain heads match, and
the first diverging step is recoverable from the per-step record.
"""
from __future__ import annotations

import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.module import tree_paths

_DIGEST_THREADS = min(8, os.cpu_count() or 1)


def _host_array(x) -> Tuple[str, np.ndarray]:
    """(numpy dtype name, C-contiguous host array of the raw bits)."""
    # np.ascontiguousarray makes 0-d arrays 1-d, as the reference's digest
    # does, so a scalar leaf hashes with shape (1,) in both packages
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:   # numpy has no bf16: hash its bits
            return "bfloat16", np.ascontiguousarray(t.view(torch.int16).numpy())
        a = t.numpy()
    else:
        a = np.asarray(x)
    return str(a.dtype), np.ascontiguousarray(a)


def leaf_digest(x) -> str:
    """sha256 hex over ``dtype|shape|raw bytes`` of one array (host order)."""
    name, a = _host_array(x)
    h = hashlib.sha256()
    h.update(f"{name}|{tuple(a.shape)}|".encode())
    # the C-contiguous array's own buffer: the bytes tobytes() would copy,
    # hashed without the copy and without the interpreter lock, so the
    # threads of tree_leaf_digests run in parallel
    h.update(a.reshape(-1).view(np.uint8))
    return h.hexdigest()


def combine_leaf_digests(named: Dict[str, str]) -> str:
    """Fold ``{path: leaf_digest}`` into one tree digest (path-sorted lines)."""
    h = hashlib.sha256()
    for line in sorted(f"{k}={v}" for k, v in named.items()):
        h.update(line.encode())
        h.update(b"\n")
    return h.hexdigest()


def tree_leaf_digests(tree) -> Dict[str, str]:
    """``{path: leaf_digest}`` for every leaf of a nested dict. Leaves are
    hashed on a few threads (sha256 releases the interpreter lock on large
    buffers): a full-size train state is ~16 GB. The result does not depend
    on the thread count."""
    named = list(tree_paths(tree))
    with ThreadPoolExecutor(max_workers=_DIGEST_THREADS) as pool:
        digests = list(pool.map(leaf_digest, [x for _, x in named]))
    return {path: dg for (path, _), dg in zip(named, digests)}


def tree_digest(tree) -> str:
    """sha256 hex over the path-sorted ``path=leaf_digest`` lines of a tree."""
    return combine_leaf_digests(tree_leaf_digests(tree))


def batch_digest(batch: Dict) -> str:
    """Digest of one data batch — the token-stream conformance unit."""
    return tree_digest(batch)


class DigestChain:
    """Append-only sha256 chain of (step, tree_digest) records.

    ``head`` commits to every digest *and* its step index in order, so a
    run that replays, skips, or reorders a step cannot collide with the
    straight run.
    """

    def __init__(self, records: Optional[List[Tuple[int, str]]] = None):
        self.records: List[Tuple[int, str]] = []
        self._head = hashlib.sha256().hexdigest()
        for step, dg in records or []:
            self._append(step, dg)

    @property
    def head(self) -> str:
        return self._head

    def _append(self, step: int, digest: str):
        h = hashlib.sha256()
        h.update(self._head.encode())
        h.update(f"|{step}|{digest}".encode())
        self._head = h.hexdigest()
        self.records.append((int(step), digest))

    def append(self, step: int, tree) -> str:
        """Digest ``tree`` and fold it into the chain; returns the new head."""
        self._append(step, tree_digest(tree))
        return self._head

    def append_digest(self, step: int, digest: str) -> str:
        self._append(step, digest)
        return self._head

    def __eq__(self, other) -> bool:
        return (isinstance(other, DigestChain) and self.head == other.head
                and self.records == other.records)

    def __len__(self) -> int:
        return len(self.records)

    def first_divergence(self, other: "DigestChain") -> Optional[int]:
        """Step index of the first differing record, or None if conformant."""
        for (sa, da), (sb, db) in zip(self.records, other.records):
            if (sa, da) != (sb, db):
                return sa
        if len(self.records) != len(other.records):
            longer = (self.records if len(self.records) > len(other.records)
                      else other.records)
            return longer[min(len(self.records), len(other.records))][0]
        return None

    def to_json(self) -> str:
        return json.dumps({"head": self.head,
                           "records": [[s, d] for s, d in self.records]})

    @classmethod
    def from_json(cls, text: str) -> "DigestChain":
        obj = json.loads(text)
        chain = cls(records=[(int(s), d) for s, d in obj["records"]])
        if chain.head != obj["head"]:
            raise ValueError("digest chain JSON is internally inconsistent: "
                             f"recomputed head {chain.head} != recorded "
                             f"{obj['head']}")
        return chain
