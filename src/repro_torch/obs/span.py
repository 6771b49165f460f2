"""Deterministic span tracing over the :mod:`repro_torch.obs.tracker` protocol.

Port of ``repro.obs.span``: equal span ids and equal records for the same
calls under the same clock.

A span is a named interval of host work (a prefill, a decode step, a train
step phase).  The design constraint that keeps spans compatible with the
repo's bitwise story:

  * **identity is deterministic** — ``span_id`` is a sha256 of
    ``(run_id, scope, phase)``, never a clock, counter race, or object id.
    Two runs of the same program emit the same span ids in the same order,
    so span streams from byte-reproducible runs diff clean and
    ``diff_runs`` can join spans across runs by id;
  * **time is payload, not identity** — wall-clock fields (``begin_s``,
    ``dur_s``, relative to the tracer's first observation) are observations
    *about* the run, carried in the event data, and are the only
    nondeterministic fields in a span record;
  * **disarmed is free** — against a :class:`~repro_torch.obs.tracker.NoopTracker`
    the tracer never reads the clock and never allocates a ``Span``, so an
    untracked run does not even perturb host timing, let alone a token bit
    (tests/test_torch_obs_engine.py proves bitwise invariance on the plain,
    spec and chaos serve paths).

Span event record (one ``"span"`` event per *completed* span)::

    {"event": "span", "phase": <str>, "scope": <str>, "span_id": <16 hex>,
     "parent_id": <16 hex|null>, "lane": <str|absent>,
     "begin_s": <float>, "dur_s": <float>, "step": <int|absent>,
     ...attrs from begin() and end()...}

``lane`` groups spans into horizontal tracks for the Perfetto export
(:mod:`repro_torch.obs.export`); ``scope`` is the deterministic instance key
(``"req:3"``, ``"step:17"``) that, hashed with the phase, yields the id.
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional

from repro_torch.obs.tracker import NoopTracker, Tracker


def span_id(run_id: str, scope: str, phase: str) -> str:
    """Deterministic 16-hex span identity: sha256 of ``run_id|scope|phase``.

    Pure function of its arguments — no clock, no sequence number — so the
    same logical span gets the same id in every run of the same program.
    """
    h = hashlib.sha256(f"{run_id}|{scope}|{phase}".encode()).hexdigest()
    return h[:16]


@dataclasses.dataclass
class Span:
    """An open span handle; pass back to :meth:`SpanTracer.end` to emit."""

    id: str
    phase: str
    scope: str
    begin_s: float
    parent_id: Optional[str] = None
    lane: Optional[str] = None
    step: Optional[int] = None
    attrs: Dict = dataclasses.field(default_factory=dict)


class SpanTracer:
    """Emit deterministic-identity spans into a tracker.

    ``clock`` is injectable (tests pass a fake counter to get byte-identical
    span streams); the default is ``time.perf_counter`` re-based to the first
    observation so ``begin_s`` values are small run-relative floats.
    """

    def __init__(self, tracker: Optional[Tracker] = None, run_id: str = "run",
                 clock: Callable[[], float] = time.perf_counter):
        self.tracker = tracker if tracker is not None else NoopTracker()
        self.run_id = run_id
        self._clock = clock
        self._epoch: Optional[float] = None

    @property
    def armed(self) -> bool:
        """False against a NoopTracker — every tracer call short-circuits."""
        return not isinstance(self.tracker, NoopTracker)

    def now(self) -> float:
        """Run-relative wall time (0.0 at the tracer's first observation)."""
        if not self.armed:
            return 0.0
        t = self._clock()
        if self._epoch is None:
            self._epoch = t
        return t - self._epoch

    def begin(self, phase: str, scope: str, *, parent: Optional[Span] = None,
              lane: Optional[str] = None, step: Optional[int] = None,
              **attrs) -> Optional[Span]:
        """Open a span; returns ``None`` when disarmed (``end(None)`` no-ops)."""
        if not self.armed:
            return None
        return Span(id=span_id(self.run_id, scope, phase), phase=phase,
                    scope=scope, begin_s=self.now(),
                    parent_id=parent.id if parent is not None else None,
                    lane=lane, step=step, attrs=dict(attrs))

    def end(self, span: Optional[Span], **attrs) -> None:
        """Close a span and emit the ``"span"`` event (no-op on ``None``)."""
        if span is None:
            return
        data: Dict = {"phase": span.phase, "scope": span.scope,
                      "span_id": span.id, "parent_id": span.parent_id,
                      "begin_s": round(span.begin_s, 9),
                      "dur_s": round(self.now() - span.begin_s, 9)}
        if span.lane is not None:
            data["lane"] = span.lane
        data.update(span.attrs)
        data.update(attrs)
        self.tracker.log("span", data, step=span.step)

    @contextmanager
    def span(self, phase: str, scope: str, *, parent: Optional[Span] = None,
             lane: Optional[str] = None, step: Optional[int] = None, **attrs):
        """``with tracer.span("decode", "step:7"): ...`` — begin/end pair."""
        s = self.begin(phase, scope, parent=parent, lane=lane, step=step,
                       **attrs)
        try:
            yield s
        finally:
            self.end(s)

    def mark(self, name: str, data: Optional[Dict] = None,
             step: Optional[int] = None) -> None:
        """Zero-duration instant event (``at_s`` payload) — e.g. a preempt."""
        if not self.armed:
            return
        rec = {"at_s": round(self.now(), 9)}
        rec.update(data or {})
        self.tracker.log(name, rec, step=step)
