"""repro_torch.obs — run-wide metrics and tracing (port of ``repro.obs``).

Three live signals from every train/serve run: throughput (tokens/s),
achieved-vs-modeled-makespan utilization, and digest divergence (did two
runs that must be bitwise equal stop being so, caught while the run is
live).

  :mod:`repro_torch.obs.tracker`  the event sink protocol + ``JsonlTracker``
                                  / ``NoopTracker`` / ``CompositeTracker``
                                  / ``MemoryTracker``;
  :mod:`repro_torch.obs.metrics`  counters / timers / histograms and the
                                  ``StepMeter`` throughput+utilization
                                  aggregator;
  :mod:`repro_torch.obs.alarm`    ``DivergenceAlarm`` — compares the live
                                  uint32 ``verify.digest.tree_fingerprint``
                                  stream (a CUDA reduction on the card)
                                  against a reference run;
  :mod:`repro_torch.obs.span`     deterministic-identity spans (ids are
                                  sha256 of ``(run_id, scope, phase)``);
  :mod:`repro_torch.obs.prof`     the ``Profiler`` facade the serve engine
                                  and the train loop thread, +
                                  ``record_state_digests``;
  :mod:`repro_torch.obs.export`   Perfetto/Chrome-trace JSON: modeled vs
                                  achieved schedule lanes + span timelines;
  :mod:`repro_torch.obs.report`   ``RunReport`` and ``diff_runs``.

Event stream format: JSON Lines, one object per event, sorted keys, with a
monotone ``seq`` number — the reference's encoding, so streams of both
packages read and diff alike. Trackers are host-side only: producers hand
them host scalars they already hold.
"""
from repro_torch.obs.alarm import DivergenceAlarm
from repro_torch.obs.metrics import (Counter, Histogram, StepMeter, Timer,
                                     quantile_lower, utilization_vs_modeled)
from repro_torch.obs.prof import Profiler, open_profiler, record_state_digests
from repro_torch.obs.report import RunDiff, RunReport, diff_runs
from repro_torch.obs.span import Span, SpanTracer, span_id
from repro_torch.obs.tracker import (CompositeTracker, JsonlTracker,
                                     MemoryTracker, NoopTracker, Tracker,
                                     open_tracker, read_jsonl)

__all__ = [
    "Tracker", "JsonlTracker", "NoopTracker", "CompositeTracker",
    "MemoryTracker", "open_tracker", "read_jsonl",
    "Counter", "Timer", "Histogram", "StepMeter", "quantile_lower",
    "utilization_vs_modeled",
    "DivergenceAlarm",
    "Span", "SpanTracer", "span_id",
    "Profiler", "open_profiler", "record_state_digests",
    "RunReport", "RunDiff", "diff_runs",
]
