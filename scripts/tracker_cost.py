"""Host cost of the obs tracker for one decode step's events.

    PYTHONPATH=src python3 scripts/tracker_cost.py [DIR ...]

For each directory (by default the system's temporary directory and, where
it exists, /dev/shm), times STEPS decode steps' worth of tracker work as
``ContinuousEngine`` emits it — a ``decode`` span (begin and end) and a
``serve_decode`` event — into a ``JsonlTracker`` there with
``flush_every=1`` (the default: each event on disk before the next) and
with ``flush_every=STEPS``, and into a ``MemoryTracker``. Prints one JSON
line per sink: microseconds a step (the median of REPEATS runs). Needs no
card: it measures the host's share of a tracked decode step.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.obs import JsonlTracker, MemoryTracker, Profiler  # noqa: E402

STEPS, REPEATS = 2000, 5


def _steps(tracker) -> float:
    """Microseconds a step of STEPS steps' events into ``tracker``."""
    prof = Profiler(tracker, run_id="serve")
    t0 = time.perf_counter()
    for i in range(STEPS):
        span = prof.begin("decode", scope=f"step:{i}", lane="engine", step=i)
        prof.end(span, live_slots=4, committed=4)
        tracker.log("serve_decode", {"live_slots": 4}, step=i + 1)
    tracker.close()
    return (time.perf_counter() - t0) / STEPS * 1e6


def main(argv=None) -> int:
    dirs = list(argv if argv is not None else sys.argv[1:]) or [
        tempfile.gettempdir()] + (["/dev/shm"] if os.path.isdir("/dev/shm")
                                  else [])
    sinks = [("memory", None, lambda path: MemoryTracker())]
    for d in dirs:
        for flush in (1, STEPS):
            sinks.append((f"jsonl flush_every={flush}", d,
                          lambda path, flush=flush: JsonlTracker(
                              path, flush_every=flush)))
    for name, d, make in sinks:
        us = []
        for _ in range(REPEATS):
            with tempfile.TemporaryDirectory(dir=d) as tmp:
                us.append(_steps(make(os.path.join(tmp, "t.jsonl"))))
        print(json.dumps({"sink": name, "dir": d, "steps": STEPS,
                          "us_per_step_median": statistics.median(us),
                          "us_per_step": us}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
