"""Tracker protocol + the standard sinks.

Port of ``repro.obs.tracker``: the same classes and the same canonical
encoding, so a ``timestamps=False`` stream is byte-for-byte the
reference's for the same ``log`` calls.

A tracker is anything with ``log(event, data, step=None)`` and ``close()``.
Producers (train loop, serving engine, tuner cache) call ``log`` with plain
scalars; the sink decides persistence.  The contract that keeps tracking out
of the reproducibility story:

  * trackers are **host-side only** — producers hand them host scalars
    they already hold (``float()``/``int()`` after the step's own sync), so
    tracking adds no device sync;
  * a tracker must never influence the computation it observes: swapping
    ``JsonlTracker`` for ``NoopTracker`` cannot change a single emitted token
    or gradient bit (tests/test_torch_obs_engine.py asserts this on the
    serving engine);
  * the JSONL encoding is canonical — sorted keys, monotone ``seq`` — so two
    runs of a deterministic program with ``timestamps=False`` produce
    byte-identical streams (the artifact-diffing use case), while production
    runs keep ``timestamps=True`` for real dashboards.

Event record schema (one JSON object per line):

    {"seq": <int>, "event": <str>, "step": <int|absent>, "t": <unix s|absent>,
     ...event data...}
"""
from __future__ import annotations

import json
import os
import time
import warnings
from typing import Dict, Iterable, Mapping, Optional


class Tracker:
    """Base/no-op sink; subclasses override :meth:`log` (and ``close``)."""

    def log(self, event: str, data: Optional[Mapping] = None,
            step: Optional[int] = None) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self) -> "Tracker":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class NoopTracker(Tracker):
    """Discards everything — the default wherever tracking is optional."""

    def log(self, event, data=None, step=None) -> None:
        pass


class JsonlTracker(Tracker):
    """Append events to a JSON-Lines file.

    ``timestamps=False`` drops the wall-clock field so the stream is a pure
    function of the logged events (byte-reproducible artifacts);
    ``flush_every`` bounds loss on a crash (1 = flush each event — the alarm
    use case wants the divergence record on disk *before* anything dies).
    """

    def __init__(self, path: str, timestamps: bool = True,
                 flush_every: int = 1):
        self.path = path
        self.timestamps = timestamps
        self.flush_every = max(1, flush_every)
        self._seq = 0
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        self._f = open(path, "a")

    def log(self, event, data=None, step=None) -> None:
        rec: Dict = {"seq": self._seq, "event": str(event)}
        if step is not None:
            rec["step"] = int(step)
        if self.timestamps:
            rec["t"] = round(time.time(), 6)
        for k, v in (data or {}).items():
            rec.setdefault(k, v)
        self._f.write(json.dumps(rec, sort_keys=True) + "\n")
        self._seq += 1
        if self._seq % self.flush_every == 0:
            self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


class CompositeTracker(Tracker):
    """Fan one event stream out to several sinks (e.g. JSONL + in-memory)."""

    def __init__(self, trackers: Iterable[Tracker]):
        self.trackers = list(trackers)

    def log(self, event, data=None, step=None) -> None:
        for t in self.trackers:
            t.log(event, data, step)

    def close(self) -> None:
        for t in self.trackers:
            t.close()


class MemoryTracker(Tracker):
    """Keep events in a list — tests and in-process dashboards."""

    def __init__(self):
        self.events = []

    def log(self, event, data=None, step=None) -> None:
        rec = {"event": str(event), **(dict(data) if data else {})}
        if step is not None:
            rec["step"] = int(step)
        self.events.append(rec)

    def of(self, event: str):
        return [e for e in self.events if e["event"] == event]


def open_tracker(path: Optional[str], timestamps: bool = True) -> Tracker:
    """``JsonlTracker(path)`` when a path is given, else ``NoopTracker`` —
    the one-liner CLIs use for an optional ``--track`` flag."""
    return JsonlTracker(path, timestamps=timestamps) if path else NoopTracker()


def read_jsonl(path: str, event: Optional[str] = None, strict: bool = False):
    """Parse a tracker JSONL back into dicts (optionally one event type).

    Crash tolerance: a run killed mid-``write`` leaves at most one torn line,
    and only at the end of the file (``JsonlTracker`` flushes every event by
    default and each event is a single ``write`` call).  A malformed *final*
    line is therefore skipped with a warning so a crashed run's trace is
    still triageable; malformed interior lines mean real corruption and
    always raise.  ``strict=True`` restores raise-on-any-bad-line.
    """
    out = []
    with open(path) as f:
        lines = f.readlines()
    for i, line in enumerate(lines):
        stripped = line.strip()
        if not stripped:
            continue
        try:
            rec = json.loads(stripped)
        except json.JSONDecodeError:
            if i == len(lines) - 1 and not strict:
                warnings.warn(
                    f"{path}: skipping torn final line ({len(stripped)} "
                    "bytes) — likely a crash mid-write", RuntimeWarning)
                continue
            raise
        if event is None or rec.get("event") == event:
            out.append(rec)
    return out
