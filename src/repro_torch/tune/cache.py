"""Content-addressed JSON store for tuner decisions.

Keyed like ``cached_schedule`` — mask hash, shape, dtype, worker budget,
backend, tuner version — so a decision can never leak across geometries, and
bumping ``TUNER_VERSION`` (new space/model semantics) invalidates every old
entry at once.  One decision per file, filename = sha256 of the key: reads
verify the stored key matches (hash-prefix collisions fail loudly, and a file
edited by hand no longer addresses itself).

Writes are atomic (tmp + rename) with sorted keys, so an entry is
byte-reproducible from its record and safe under concurrent tuners.  The
store is what makes tuning *sticky*: the same machine re-picks the same
candidate forever (bitwise same numerics), even in measure mode where the
first pick involved a clock.

Hit/miss counters stream to an optional tracker, any object with a
``log(kind, payload)`` method (``tune_cache`` events).

Port of ``repro.tune.cache``: the same key format, self-addressing and atomic
writes. Its own root (``$REPRO_TORCH_TUNE_CACHE`` or
``~/.cache/repro_torch/tune``), and the tuner's backend string in every key
(``"cuda-sm90"``, :data:`repro_torch.tune.api.DEFAULT_BACKEND`), keep a
decision made for another backend from ever being read here.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Dict, Optional

from repro_torch.tune.space import Candidate

TUNER_VERSION = 1
ENV_VAR = "REPRO_TORCH_TUNE_CACHE"


def make_key(*, mask_key: str, seq_q: int, seq_kv: int, head_dim: int,
             n_heads: int, n_kv_heads: int, dtype: str, backend: str,
             n_workers: Optional[int] = None) -> str:
    """Canonical cache key. ``mask_key`` is ``MaskSpec.key()`` (spec-hash) or
    the literal ``"causal"`` / ``"full"`` for the paper masks; ``n_workers``
    is the *hardware worker budget* (None = schedule-defined), not the tiling
    worker count — that one is part of the candidate, not the key."""
    return "|".join([
        f"tuner-v{TUNER_VERSION}", f"mask={mask_key}",
        f"shape={seq_q}x{seq_kv}x{head_dim}", f"heads={n_heads}/{n_kv_heads}",
        f"dtype={dtype}", f"workers={'auto' if n_workers is None else n_workers}",
        f"backend={backend}",
    ])


class TuneCache:
    """Directory-backed content-addressed store of tuner records."""

    def __init__(self, root: Optional[str] = None, tracker=None):
        self.root = root or os.environ.get(ENV_VAR) or os.path.join(
            os.path.expanduser("~"), ".cache", "repro_torch", "tune")
        self.tracker = tracker
        self.hits = 0
        self.misses = 0

    def path(self, key: str) -> str:
        return os.path.join(
            self.root, hashlib.sha256(key.encode()).hexdigest()[:24] + ".json")

    def _emit(self, result: str, key: str):
        if self.tracker is not None:
            self.tracker.log("tune_cache", {"result": result, "key": key,
                                            "hits": self.hits,
                                            "misses": self.misses})

    # ----------------------------------------------------------------- store
    def get(self, key: str) -> Optional[Dict]:
        """Stored record for ``key`` or None. Verifies the record addresses
        itself (stored key == requested key, version current)."""
        p = self.path(key)
        try:
            with open(p) as f:
                rec = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            self.misses += 1
            self._emit("miss", key)
            return None
        if rec.get("key") != key or rec.get("tuner_version") != TUNER_VERSION:
            self.misses += 1
            self._emit("stale", key)
            return None
        self.hits += 1
        self._emit("hit", key)
        return rec

    def put(self, key: str, candidate: Candidate, extras: Optional[Dict] = None
            ) -> Dict:
        """Persist a decision atomically; returns the record written."""
        rec = {"key": key, "tuner_version": TUNER_VERSION,
               "candidate": candidate.to_dict(), **(extras or {})}
        os.makedirs(self.root, exist_ok=True)
        payload = json.dumps(rec, indent=1, sort_keys=True)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            os.replace(tmp, self.path(key))
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return rec

    @staticmethod
    def candidate_of(rec: Dict) -> Candidate:
        return Candidate.from_dict(rec["candidate"])

    # ------------------------------------------------------------- telemetry
    def cache_info(self) -> Dict[str, int]:
        size = 0
        if os.path.isdir(self.root):
            size = sum(1 for f in os.listdir(self.root) if f.endswith(".json"))
        return {"hits": self.hits, "misses": self.misses, "entries": size}


@dataclasses.dataclass
class _DefaultCache:
    cache: Optional[TuneCache] = None


_default = _DefaultCache()


def default_cache() -> TuneCache:
    """Process-wide default store (``$REPRO_TORCH_TUNE_CACHE`` or
    ``~/.cache/repro_torch/tune``). Re-created if the env var changed
    (tests)."""
    root = os.environ.get(ENV_VAR)
    if _default.cache is None or (root and _default.cache.root != root):
        _default.cache = TuneCache()
    return _default.cache
