"""Run reports: roll a tracker JSONL into percentiles, counters, and a
divergence triage.

Port of ``repro.obs.report``: equal reports and diffs for equal event
streams.

:class:`RunReport` is the offline consumer of everything the obs layer
records: latency distributions (TTFT, per-token, queue wait — exact
order-statistic quantiles via :func:`repro_torch.obs.metrics.quantile_lower`,
lowest-index tie-break, so two reports over the same stream are
bit-identical), throughput, preemption/shed/cancel/acceptance counters, and
the reproducibility stream (uint32 fingerprints + the per-leaf sha256
records ``repro_torch.obs.prof.record_state_digests`` emits).

:func:`diff_runs` is the divergence triage: given two runs' reports it
reconstructs each run's ``verify.digest.DigestChain`` from the recorded
tree digests, names the **first diverging step** via
``DigestChain.first_divergence`` (falling back to the fingerprint stream
when no digests were recorded), then diffs the per-leaf digests at that
step to name the **leaf path(s)** that changed — "step 3, params/embed" is
actionable; "the run diverged" is not.

CLI::

    python -m repro_torch.obs.report run.jsonl [--out report.json]
    python -m repro_torch.obs.report a.jsonl --diff b.jsonl   # exit 1 on divergence
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from collections import Counter as _Counter
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import quantile_lower

_PCTS = ((0.5, "p50"), (0.9, "p90"), (0.99, "p99"))


def _dist(values: Sequence[float]) -> Optional[Dict[str, float]]:
    """Summary of a latency sample: exact percentiles + mean/max/count."""
    vs = [float(v) for v in values]
    if not vs:
        return None
    out = {"n": float(len(vs)), "mean": sum(vs) / len(vs), "max": max(vs)}
    for q, tag in _PCTS:
        out[tag] = quantile_lower(vs, q)
    return out


@dataclasses.dataclass
class RunReport:
    """Aggregated view of one run's event stream (see module docstring)."""

    source: str = "<events>"
    run_id: Optional[str] = None
    n_events: int = 0
    counters: Dict[str, int] = dataclasses.field(default_factory=dict)
    latency: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    spans: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    throughput: Dict[str, float] = dataclasses.field(default_factory=dict)
    spec: Dict[str, float] = dataclasses.field(default_factory=dict)
    fingerprints: Dict[int, int] = dataclasses.field(default_factory=dict)
    digests: List[Tuple[int, str]] = dataclasses.field(default_factory=list)
    leaf_digests: Dict[int, Dict[str, str]] = dataclasses.field(
        default_factory=dict)

    # ------------------------------------------------------------- builders
    @classmethod
    def from_jsonl(cls, path: str) -> "RunReport":
        from repro_torch.obs.tracker import read_jsonl
        rep = cls.from_events(read_jsonl(path))
        rep.source = path
        return rep

    @classmethod
    def from_events(cls, events: Sequence[Dict]) -> "RunReport":
        rep = cls(n_events=len(events))
        counters = _Counter()
        ttft: List[float] = []
        queue_wait: List[float] = []
        queue_steps: List[float] = []
        per_token: List[float] = []
        decode_step: List[float] = []
        train_step: List[float] = []
        by_phase: Dict[str, List[float]] = {}
        spec_committed_by_step: Dict[int, int] = {}
        spec_accepted = spec_evaluated = spec_committed = 0
        done_tokens = 0
        spec_spans: List[Tuple[int, float]] = []

        for rec in events:
            ev = rec.get("event")
            counters[ev] += 1
            if ev == "serve_spec_round":
                spec_accepted += int(rec.get("accepted", 0))
                spec_evaluated += int(rec.get("evaluated", 0))
                committed = int(rec.get("committed", 0))
                spec_committed += committed
                if "step" in rec:
                    spec_committed_by_step[int(rec["step"])] = committed
            elif ev == "serve_done":
                done_tokens += int(rec.get("n_tokens", 0))
            elif ev == "fingerprint":
                rep.fingerprints[int(rec["step"])] = int(rec["fingerprint"])
            elif ev == "leaf_digests":
                step = int(rec["step"])
                rep.digests.append((step, rec["tree_digest"]))
                rep.leaf_digests[step] = dict(rec.get("leaves", {}))
            elif ev == "span":
                phase, dur = rec.get("phase"), float(rec.get("dur_s", 0.0))
                by_phase.setdefault(phase, []).append(dur)
                if phase == "queue":
                    queue_wait.append(dur)
                    if "queued_steps" in rec:
                        queue_steps.append(float(rec["queued_steps"]))
                elif phase == "prefill" and "ttft_s" in rec:
                    ttft.append(float(rec["ttft_s"]))
                elif phase == "decode":
                    decode_step.append(dur)
                    committed = int(rec.get("committed", 0))
                    if committed > 0:
                        per_token.append(dur / committed)
                elif phase == "spec_round" and "step" in rec:
                    spec_spans.append((int(rec["step"]), dur))
                elif phase == "train_step":
                    train_step.append(dur)

        # per-token latency of spec rounds needs the committed count from the
        # serve_spec_round event at the same engine step
        for step, dur in spec_spans:
            committed = spec_committed_by_step.get(step, 0)
            if committed > 0:
                per_token.append(dur / committed)

        rep.digests.sort()
        rep.counters = dict(sorted(counters.items()))
        for name, sample in (("ttft_s", ttft), ("queue_wait_s", queue_wait),
                             ("queue_wait_steps", queue_steps),
                             ("per_token_s", per_token),
                             ("decode_step_s", decode_step),
                             ("train_step_s", train_step)):
            d = _dist(sample)
            if d is not None:
                rep.latency[name] = d
        for phase, durs in sorted(by_phase.items()):
            rep.spans[phase] = {"n": float(len(durs)), "total_s": sum(durs),
                                "mean_s": sum(durs) / len(durs)}

        decode_total = sum(by_phase.get("decode", [])) + sum(
            d for _, d in spec_spans)
        rep.throughput = {}
        if done_tokens:
            rep.throughput["completed_tokens"] = float(done_tokens)
        if decode_total > 0 and done_tokens:
            rep.throughput["decode_tokens_per_s"] = done_tokens / decode_total
        for rec in events:
            if rec.get("event") == "run_summary":
                for k in ("tokens_per_s_avg", "final_loss", "final_step"):
                    if k in rec:
                        rep.throughput[k] = float(rec[k])
            elif rec.get("event") == "run_config" and rep.run_id is None:
                rep.run_id = rec.get("run_id")
        if spec_evaluated:
            rep.spec = {"accepted": float(spec_accepted),
                        "evaluated": float(spec_evaluated),
                        "committed": float(spec_committed),
                        "accept_rate": spec_accepted / spec_evaluated}
        return rep

    # ------------------------------------------------------------ serialize
    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["fingerprints"] = {str(k): v for k, v in self.fingerprints.items()}
        d["leaf_digests"] = {str(k): v for k, v in self.leaf_digests.items()}
        d["digests"] = [[s, dg] for s, dg in self.digests]
        return d

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent)


@dataclasses.dataclass
class RunDiff:
    """Result of :func:`diff_runs` — where two runs stopped agreeing."""

    clean: bool
    first_step: Optional[int] = None
    leaf_paths: Tuple[str, ...] = ()
    via: str = "none"        # "digest_chain" | "fingerprint" | "none"
    detail: str = ""

    def __str__(self) -> str:
        if self.clean:
            return f"clean ({self.via}): runs are bitwise-conformant"
        leaves = (", ".join(self.leaf_paths[:4])
                  + (" …" if len(self.leaf_paths) > 4 else "")
                  if self.leaf_paths else "<leaf digests not recorded>")
        return (f"DIVERGED at step {self.first_step} (via {self.via}); "
                f"leaf paths: {leaves}")


def diff_runs(a: RunReport, b: RunReport) -> RunDiff:
    """Name the first diverging step *and leaf path* between two runs.

    Prefers the recorded sha256 tree digests (exact, localizing) folded into
    ``verify.digest.DigestChain`` so ``first_divergence`` applies unchanged;
    falls back to the live uint32 fingerprint stream when digests were not
    recorded.  Leaf paths come from diffing the truncated per-leaf digests
    both runs recorded at the diverging step.
    """
    from repro_torch.verify.digest import DigestChain

    if a.digests and b.digests:
        ca, cb = DigestChain(), DigestChain()
        for step, dg in a.digests:
            ca.append_digest(step, dg)
        for step, dg in b.digests:
            cb.append_digest(step, dg)
        step = ca.first_divergence(cb)
        if step is None:
            return RunDiff(clean=True, via="digest_chain",
                           detail=f"{len(ca)} digest records agree "
                                  f"(head {ca.head[:16]})")
        la, lb = a.leaf_digests.get(step, {}), b.leaf_digests.get(step, {})
        paths = tuple(sorted(k for k in set(la) | set(lb)
                             if la.get(k) != lb.get(k)))
        return RunDiff(clean=False, first_step=step, leaf_paths=paths,
                       via="digest_chain",
                       detail=f"{len(paths)} of {len(set(la) | set(lb))} "
                              f"leaves differ at step {step}")

    if a.fingerprints or b.fingerprints:
        steps = sorted(set(a.fingerprints) | set(b.fingerprints))
        for step in steps:
            if a.fingerprints.get(step) != b.fingerprints.get(step):
                return RunDiff(clean=False, first_step=step,
                               via="fingerprint",
                               detail="uint32 fingerprint mismatch (record "
                                      "leaf digests for leaf-level triage)")
        return RunDiff(clean=True, via="fingerprint",
                       detail=f"{len(steps)} fingerprints agree")
    return RunDiff(clean=True, via="none",
                   detail="no digests or fingerprints recorded in either run")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="repro_torch.obs.report",
        description="Roll a tracker JSONL into a RunReport (and diff runs)")
    p.add_argument("events", help="tracker JSONL of the run")
    p.add_argument("--out", help="write the report JSON here")
    p.add_argument("--diff", metavar="OTHER.jsonl",
                   help="diff against another run; exit 1 on divergence")
    args = p.parse_args(argv)

    rep = RunReport.from_jsonl(args.events)
    if args.out:
        with open(args.out, "w") as f:
            f.write(rep.to_json(indent=1) + "\n")
    summary = {"source": rep.source, "n_events": rep.n_events,
               "counters": rep.counters, "latency": rep.latency,
               "throughput": rep.throughput}
    print(json.dumps(summary, sort_keys=True, indent=1))
    if args.diff:
        diff = diff_runs(rep, RunReport.from_jsonl(args.diff))
        print(str(diff))
        return 0 if diff.clean else 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
