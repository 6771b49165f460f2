"""Counters / timers / histograms + the train-loop ``StepMeter``.

Port of ``repro.obs.metrics``. Small, dependency-free instruments that
aggregate host-side and emit through a :mod:`repro_torch.obs.tracker`.
Nothing here touches a tensor: producers hand in host python scalars, so
instrumenting a loop can never add a device sync the loop didn't already
have.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence


def quantile_lower(values: Sequence[float], q: float) -> float:
    """Exact order-statistic quantile with deterministic lowest-index
    tie-break — ``numpy.quantile(values, q, method="lower")`` semantics.

    The sorted sample is indexed at ``floor(q * (n - 1))``: always an
    *observed* value (never interpolated), and because ``sorted`` is stable,
    equal values resolve to the lowest index — so the result is a pure
    function of the multiset of observations, bit-identical across runs and
    platforms.  This is the one quantile definition every percentile in the
    repo (``Histogram.percentile``, ``report.RunReport``) uses.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile q must be in [0, 1], got {q}")
    vs = sorted(values)
    if not vs:
        raise ValueError("quantile of an empty sample")
    return vs[int(math.floor(q * (len(vs) - 1)))]


class Counter:
    """Monotone event counter."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> int:
        self.value += n
        return self.value

    def snapshot(self) -> Dict[str, float]:
        return {self.name: float(self.value)}


class Timer:
    """Accumulating wall-clock timer (context manager or explicit add)."""

    def __init__(self, name: str):
        self.name = name
        self.total_s = 0.0
        self.count = 0
        self._t0: Optional[float] = None

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.add(time.perf_counter() - self._t0)
        self._t0 = None

    def add(self, seconds: float) -> None:
        self.total_s += seconds
        self.count += 1

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0

    def snapshot(self) -> Dict[str, float]:
        return {f"{self.name}_total_s": self.total_s,
                f"{self.name}_mean_s": self.mean_s,
                f"{self.name}_count": float(self.count)}


class Histogram:
    """Fixed-boundary histogram (boundaries are upper edges; +inf implicit)
    that also retains the raw observations for **exact** percentiles.

    Fixed boundaries keep the bucket summary a pure function of the observed
    values — no t-digest style data-dependent resizing that would make two
    identical runs disagree on bucket layout.  Percentiles are *not* read off
    the buckets (bucket interpolation is a layout-dependent estimate):
    :meth:`percentile` is the exact order statistic over the retained sample,
    ``sorted(values)[floor(q * (n - 1))]`` with stable lowest-index tie-break
    — :func:`quantile_lower`, i.e. ``numpy.quantile(method="lower")``.  The
    retained sample is O(n) host memory; these histograms aggregate per-run
    host-side latencies (thousands of points), not per-token device data."""

    def __init__(self, name: str, boundaries: Sequence[float]):
        self.name = name
        self.boundaries = sorted(float(b) for b in boundaries)
        self.counts = [0] * (len(self.boundaries) + 1)
        self.values: List[float] = []
        self.total = 0.0
        self.n = 0
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.boundaries, value)] += 1
        self.values.append(float(value))
        self.total += value
        self.n += 1
        self.max = max(self.max, value)

    def percentile(self, q: float) -> float:
        """Exact order-statistic quantile of the observed sample (see
        :func:`quantile_lower` for the pinned semantics)."""
        return quantile_lower(self.values, q)

    def snapshot(self) -> Dict[str, float]:
        out = {f"{self.name}_count": float(self.n),
               f"{self.name}_mean": self.total / self.n if self.n else 0.0,
               f"{self.name}_max": self.max if self.n else 0.0}
        if self.n:
            for q, tag in ((0.5, "p50"), (0.9, "p90"), (0.99, "p99")):
                out[f"{self.name}_{tag}"] = self.percentile(q)
        for edge, c in zip(self.boundaries + [float("inf")], self.counts):
            out[f"{self.name}_le_{edge:g}"] = float(c)
        return out


def utilization_vs_modeled(modeled_s: float, achieved_s: float) -> float:
    """Achieved-vs-modeled-makespan utilization: the fraction of measured
    wall time the DAG model says the scheduled work needs. 1.0 = the hardware
    delivers exactly the modeled makespan; < 1 = overhead/stalls the model
    does not account for; > 1 usually means the model's roofline constants
    are stale for this part."""
    return modeled_s / achieved_s if achieved_s > 0 else 0.0


@dataclasses.dataclass
class StepMeter:
    """Per-step throughput + utilization aggregator for training loops.

    ``update(tokens, dt_s)`` per step; ``event()`` returns the tracker payload
    (instantaneous + running tokens/s, step ms, utilization-vs-modeled when a
    modeled per-step makespan is configured — see
    ``launch/train.py --tune/--track``)."""

    modeled_step_s: Optional[float] = None      # modeled makespan of one step's
                                                # scheduled attention work
    tokens: int = 0
    total_s: float = 0.0
    steps: int = 0
    last_tokens_per_s: float = 0.0
    last_step_s: float = 0.0

    def update(self, tokens: int, dt_s: float) -> Dict[str, float]:
        self.tokens += tokens
        self.total_s += dt_s
        self.steps += 1
        self.last_step_s = dt_s
        self.last_tokens_per_s = tokens / dt_s if dt_s > 0 else 0.0
        return self.event()

    def event(self) -> Dict[str, float]:
        out = {
            "tokens_per_s": self.last_tokens_per_s,
            "tokens_per_s_avg": self.tokens / self.total_s
            if self.total_s > 0 else 0.0,
            "step_ms": self.last_step_s * 1e3,
            "steps": float(self.steps),
        }
        if self.modeled_step_s is not None:
            out["modeled_step_s"] = self.modeled_step_s
            out["utilization_vs_modeled"] = utilization_vs_modeled(
                self.modeled_step_s, self.last_step_s)
        return out


class MetricSet:
    """Named bundle of instruments with one ``emit`` into a tracker."""

    def __init__(self):
        self._instruments: List = []

    def add(self, instrument):
        self._instruments.append(instrument)
        return instrument

    def counter(self, name: str) -> Counter:
        return self.add(Counter(name))

    def timer(self, name: str) -> Timer:
        return self.add(Timer(name))

    def histogram(self, name: str, boundaries: Sequence[float]) -> Histogram:
        return self.add(Histogram(name, boundaries))

    def emit(self, tracker, event: str = "metrics",
             step: Optional[int] = None) -> Dict[str, float]:
        snap: Dict[str, float] = {}
        for inst in self._instruments:
            snap.update(inst.snapshot())
        tracker.log(event, snap, step=step)
        return snap
