"""Perfetto / Chrome-trace JSON export for schedules and span streams.

Port of ``repro.obs.export``. Generalizes :mod:`repro_torch.core.gantt`
(terminal ASCII, write-only) to a *loadable artifact*: drop the emitted JSON
on https://ui.perfetto.dev or ``chrome://tracing`` and scrub the same
per-worker lanes the paper's Gantt figures draw. Three producers:

  * :func:`schedule_to_trace` — a ``core.schedules.Schedule`` rendered twice:
    a **modeled** process (one thread per worker, task compute/reduce phases
    at the simulator's ``(c, r)`` roofline costs — the DAG ``tune/model.py``
    ranks candidates with) beside an **achieved** process (the same layout
    uniformly stretched so the modeled makespan lands on the measured wall
    time). Per-tile achieved times are not host-observable — the backward
    is one opaque launch — so the achieved lane shows where the modeled
    schedule *would* place each tile at the measured rate; the honest
    number is the stall factor (``achieved_s / modeled_makespan``) recorded
    in every event's args. Equal inputs give the reference's event list.
  * :func:`attention_timeline` — build the schedule for a (seq, head_dim,
    mask) attention shape, cost it with ``tune.model.task_costs`` (the H100
    constants), optionally *measure* the achieved lane. This is where the
    two packages measure different quantities on purpose: the reference
    times its plain backward under ``jit`` (a Pallas kernel in interpret
    mode cannot be timed); on the card the port times **its own DASH
    backward kernel** (``flash_bwd``: the worker-parallel kernel and the
    ordered fold) on the resolved schedule, and on the CPU the plain
    versions of the same two.
  * :func:`spans_to_trace` — a recorded span stream
    (``repro_torch.obs.span`` events out of a tracker JSONL /
    ``MemoryTracker``) as one process with one thread per lane.

``python -m repro_torch.obs.export --validate run.json`` schema-checks an
artifact; ``--from-events events.jsonl --out run.json`` converts a tracker
stream offline.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional, Sequence

_US = 1e6                      # trace timestamps are microseconds (float ok)
PID_MODELED = 1
PID_ACHIEVED = 2
PID_RUN = 3
PROCESS_MODELED = "schedule (modeled)"
PROCESS_ACHIEVED = "schedule (achieved)"


def _meta(pid: int, name: str, tids: Optional[Dict[int, str]] = None) -> List[Dict]:
    out = [{"ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": name}}]
    for tid, tname in (tids or {}).items():
        out.append({"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                    "args": {"name": tname}})
    return out


# --------------------------------------------------------------- schedules
def schedule_to_trace(schedule, c: float, r: float,
                      achieved_s: Optional[float] = None,
                      link: float = 0.0) -> List[Dict]:
    """Trace events for one schedule: modeled lanes (+ achieved if measured).

    ``c``/``r`` are the simulator task costs in **seconds** (see
    ``tune.model.task_costs``); ``achieved_s`` is the measured wall time the
    scheduled work actually took.  Returns a flat event list — wrap with
    :func:`make_trace` / :func:`write_trace`.
    """
    from repro_torch.core.simulator import simulate

    res = simulate(schedule, c, r, link=link)
    worker_of = {}
    for w, chain in enumerate(schedule.chains):
        for task in chain:
            worker_of[task] = w
    stretch = (achieved_s / res.makespan
               if achieved_s and res.makespan > 0 else None)
    base_args = {"modeled_makespan_s": res.makespan,
                 "modeled_utilization": res.utilization,
                 "c_s": c, "r_s": r}
    if achieved_s is not None:
        base_args["achieved_s"] = achieved_s
        base_args["stall_factor"] = (achieved_s / res.makespan
                                     if res.makespan > 0 else 0.0)

    tids = {w: f"worker {w}" for w in range(schedule.n_workers)}
    events = _meta(PID_MODELED, PROCESS_MODELED, tids)
    if stretch is not None:
        events += _meta(PID_ACHIEVED, PROCESS_ACHIEVED, tids)

    for task, (cs, rs, re) in sorted(res.task_times.items()):
        h, kv, q = task
        w = worker_of[task]
        args = {"head": h, "kv": kv, "q": q, "worker": w, **base_args}
        phases = [(f"c h{h} kv{kv} q{q}", "compute", cs, c),
                  (f"r h{h} kv{kv} q{q}", "reduce", rs, re - rs)]
        for name, cat, t0, dur in phases:
            events.append({"ph": "X", "pid": PID_MODELED, "tid": w,
                           "name": name, "cat": cat,
                           "ts": t0 * _US, "dur": dur * _US, "args": args})
            if stretch is not None:
                events.append({"ph": "X", "pid": PID_ACHIEVED, "tid": w,
                               "name": name, "cat": cat,
                               "ts": t0 * stretch * _US,
                               "dur": dur * stretch * _US, "args": args})
    return events


def attention_timeline(seq: int, head_dim: int, *, causal: bool = True,
                       block: int = 128,
                       schedule: str = "symmetric_shift_or_shift",
                       mask=None, measure: bool = False, reps: int = 3,
                       device=None) -> List[Dict]:
    """Schedule-timeline events for one attention shape.

    Resolves the schedule as ``kernels.ops.dash_attention`` does, costs it
    with the roofline model and — when ``measure=True`` — times the port's
    DASH backward on that schedule for the achieved lane: ``flash_bwd``
    (the worker-parallel backward and the ordered fold) at B=1, H=1, fp32,
    over the schedule's ``n · block`` tokens (``seq`` rounded down to the
    tile) on ``device`` (the card unless ``"cpu"`` is given), the best of
    ``reps`` after a warm-up, each call ended by
    ``torch.cuda.synchronize()``. On the card that is the CUDA kernels; on
    the CPU their plain versions. (The reference's ``achieved_s`` times its
    plain backward under ``jit`` at ``seq`` instead.) ``block`` defaults to
    128, the kernels' tile. The measurement is dense causal/full — a
    block-sparse ``mask`` shapes the modeled lanes only.
    """
    from repro_torch.core.schedules import cached_schedule
    from repro_torch.tune.model import task_costs

    block = min(block, seq)
    n = max(1, seq // block)
    name = schedule
    if name == "symmetric_shift_or_shift":
        name = "symmetric_shift" if causal else "shift"
    sched = cached_schedule(name, n, n_heads=1, causal=causal, n_q=n,
                            mask=mask, block_q=block, block_k=block)
    c, r = task_costs(block, block, head_dim)
    achieved = (_time_backward(sched, n * block, head_dim, causal, block,
                               reps, device) if measure else None)
    return schedule_to_trace(sched, c, r, achieved_s=achieved)


def _time_backward(sched, seq, head_dim, causal, block, reps, device):
    """Best wall seconds of one fp32 DASH backward (worker kernel + fold)
    on ``sched`` at B=1, H=1."""
    import time

    import torch

    from repro_torch import resolve_device
    from repro_torch.kernels import flash_bwd as FB
    from repro_torch.kernels import flash_fwd as FF

    device = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    q, k, v, do = (torch.randn((1, seq, head_dim), generator=gen)
                   .to(device) for _ in range(4))
    scale = head_dim ** -0.5
    out, lse = FF.flash_fwd(q, k, v, causal=causal, sm_scale=scale,
                            block_q=block, block_k=block)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def bwd():
        FB.flash_bwd(q, k, v, out, lse, do, sched, causal=causal,
                     sm_scale=scale, block_q=block, block_k=block)
        sync()

    bwd()                                                  # warm-up
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        bwd()
        best = min(best, time.perf_counter() - t0)
    return best


# ------------------------------------------------------------ span streams
def spans_to_trace(records: Sequence[Dict], pid: int = PID_RUN,
                   process_name: str = "run") -> List[Dict]:
    """Trace events for a recorded span stream (tracker dicts).

    Span events become complete ("X") slices on one thread per ``lane``
    (spans without a lane track under their phase name); instant events
    (anything carrying ``at_s``, e.g. ``serve_preempt`` marks) become
    Perfetto instants.  Non-span records without ``at_s`` are ignored.
    """
    spans = [r for r in records
             if r.get("event") == "span" and "begin_s" in r and "dur_s" in r]
    instants = [r for r in records
                if r.get("event") != "span" and "at_s" in r]
    lanes = {str(s.get("lane") or s.get("phase")) for s in spans}
    if instants:
        lanes.add("events")
    tid_of = {lane: i for i, lane in enumerate(sorted(lanes))}

    events = _meta(pid, process_name,
                   {i: lane for lane, i in tid_of.items()})
    for s in spans:
        lane = str(s.get("lane") or s.get("phase"))
        args = {k: v for k, v in s.items()
                if k not in ("event", "begin_s", "dur_s", "lane", "t")}
        name = s["phase"]
        if s.get("scope"):
            name = f"{s['phase']} {s['scope']}"
        events.append({"ph": "X", "pid": pid, "tid": tid_of[lane],
                       "name": name, "cat": s["phase"],
                       "ts": max(0.0, float(s["begin_s"])) * _US,
                       "dur": max(0.0, float(s["dur_s"])) * _US,
                       "args": args})
    for r in instants:
        args = {k: v for k, v in r.items() if k not in ("at_s", "t")}
        events.append({"ph": "i", "pid": pid, "tid": tid_of.get("events", 0),
                       "name": r["event"], "s": "p",
                       "ts": max(0.0, float(r["at_s"])) * _US, "args": args})
    return events


# ------------------------------------------------------- artifact plumbing
def make_trace(events: Sequence[Dict], other: Optional[Dict] = None) -> Dict:
    obj = {"traceEvents": list(events), "displayTimeUnit": "ms"}
    if other:
        obj["otherData"] = dict(other)
    return obj


def write_trace(path: str, events_or_obj, other: Optional[Dict] = None) -> Dict:
    """Write a Perfetto-loadable JSON; accepts an event list or a full obj."""
    obj = (events_or_obj if isinstance(events_or_obj, dict)
           else make_trace(events_or_obj, other))
    problems = validate_trace(obj)
    if problems:
        raise ValueError("refusing to write invalid trace: "
                         + "; ".join(problems[:5]))
    with open(path, "w") as f:
        json.dump(obj, f, sort_keys=True)
        f.write("\n")
    return obj


_PHASES = {"X", "M", "i", "B", "E", "C"}


def validate_trace(obj, require_processes: Sequence[str] = ()) -> List[str]:
    """Chrome-trace schema check; returns a list of problems (empty = ok).

    Checks the subset of the trace-event format the exporters emit — enough
    that Perfetto/chrome://tracing will load the file: ``traceEvents`` is a
    non-empty list; every event has a known ``ph``; complete events carry
    numeric non-negative ``ts``/``dur`` plus ``name``/``pid``/``tid``;
    metadata events name a process or thread.  ``require_processes`` asserts
    specific process lanes exist (``--trace-out`` artifacts carry the modeled + achieved
    schedule lanes in a ``--trace-out`` artifact).
    """
    problems: List[str] = []
    if not isinstance(obj, dict):
        return [f"trace must be a JSON object, got {type(obj).__name__}"]
    events = obj.get("traceEvents")
    if not isinstance(events, list) or not events:
        return ["traceEvents must be a non-empty list"]
    seen_processes = set()
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _PHASES:
            problems.append(f"{where}: bad ph {ph!r}")
            continue
        if ph == "X":
            for field in ("name", "pid", "tid"):
                if field not in ev:
                    problems.append(f"{where}: X event missing {field}")
            for field in ("ts", "dur"):
                val = ev.get(field)
                if not isinstance(val, (int, float)) or val < 0:
                    problems.append(f"{where}: X event {field} must be a "
                                    f"non-negative number, got {val!r}")
        elif ph == "M":
            if ev.get("name") not in ("process_name", "thread_name"):
                problems.append(f"{where}: M event name {ev.get('name')!r}")
            elif not isinstance(ev.get("args", {}).get("name"), str):
                problems.append(f"{where}: M event missing args.name")
            elif ev["name"] == "process_name":
                seen_processes.add(ev["args"]["name"])
        elif ph == "i":
            if not isinstance(ev.get("ts"), (int, float)):
                problems.append(f"{where}: instant missing numeric ts")
    for proc in require_processes:
        if proc not in seen_processes:
            problems.append(f"required process lane {proc!r} absent")
    return problems


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="repro_torch.obs.export",
        description="Validate or build Perfetto trace artifacts")
    p.add_argument("--validate", nargs="+", metavar="TRACE.json",
                   help="schema-check trace files; nonzero exit on failure")
    p.add_argument("--require-schedule-lanes", action="store_true",
                   help="with --validate: require modeled+achieved schedule "
                        "process lanes")
    p.add_argument("--from-events", metavar="EVENTS.jsonl",
                   help="convert a tracker JSONL span stream to a trace")
    p.add_argument("--out", metavar="TRACE.json",
                   help="output path for --from-events")
    args = p.parse_args(argv)

    rc = 0
    if args.validate:
        require = ((PROCESS_MODELED, PROCESS_ACHIEVED)
                   if args.require_schedule_lanes else ())
        for path in args.validate:
            with open(path) as f:
                obj = json.load(f)
            problems = validate_trace(obj, require_processes=require)
            n = len(obj.get("traceEvents", []) or [])
            if problems:
                rc = 1
                print(f"{path}: INVALID ({len(problems)} problems)")
                for prob in problems[:10]:
                    print(f"  - {prob}")
            else:
                print(f"{path}: ok ({n} events)")
    if args.from_events:
        if not args.out:
            p.error("--from-events requires --out")
        from repro_torch.obs.tracker import read_jsonl
        events = spans_to_trace(read_jsonl(args.from_events))
        write_trace(args.out, events)
        print(f"{args.out}: {len(events)} events")
    if not args.validate and not args.from_events:
        p.error("nothing to do: pass --validate and/or --from-events")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
