"""Chaos conformance: every completed request bitwise equal under faults.

Port of ``repro.faults.conformance``: the same 11 cells, the same literal
and seeded plans, the same artifact. Each drives the continuous engine (or
the checkpoint writer) of the port:

  unarmed_noop          an armed *empty* plan: tokens bitwise, nothing lands
  pool_exhaustion       page quarantines force deterministic preemption
  slot_revocation       repeated victim eviction + recompute-restore
  decode_stall          stalls delay, never change a token
  deadlines             step deadlines under a stall: the cancelled set is
                        the same in two runs, the survivors bitwise
  load_shedding         bounded admission: the shed set replays exactly
  engine_crash_restore  crash → snapshot restore → every stream bitwise
                        (plus the crash-before-any-snapshot fallback)
  ckpt_io_retry         transient IO errors absorbed by the bounded retry;
                        the restored tree digest-identical
  spec_preempt          ``spec_k=4`` under slot revocations, bitwise equal
                        to the fault-free *non-speculative* run
  seeded_mix_1, _2      ``FaultPlan.seeded`` mixes of the serve faults

Each cell records the plan's key, the injector's landing digest and each
request's token sha256; the report's ``work`` sums what every engine of the
matrix dispatched (:func:`engine_work`), which ``chip_smoke.py`` holds the
kernels' launch counts to. :func:`run_matrix` takes the reference's reduced
StableLM by default; ``reduced=False`` with ``overrides`` runs the published
widths cut as the overrides say (``chip_smoke.py``: 1 layer on the card).

    PYTHONPATH=src python -m repro_torch.faults.conformance --device cpu \\
        --reduced --out chaos_conformance.json
    PYTHONPATH=src python -m repro_torch.faults.conformance --layers 2
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

ARCH = "stablelm-1.6b"
GEN = 8
PROMPT_LENS = [5, 13, 32, 7, 21, 9, 17, 3]
ENGINE_KW = dict(n_slots=4, max_seq=64, page_size=8, prefill_chunk=16)


class _Ctx:
    """The matrix's model, prompts and where its files go."""

    def __init__(self, device, reduced, overrides, tmp_root):
        from repro_torch.configs import registry
        from repro_torch.models import transformer as T
        cfg = registry.get(ARCH)
        kw = dict(overrides)
        self.cfg = cfg.reduced(**kw) if reduced else cfg.replace(**kw)
        self.params = T.init(self.cfg, seed=0, device=device)
        rng = np.random.RandomState(0)
        self.prompts = {i: rng.randint(1, self.cfg.vocab, size=n).tolist()
                        for i, n in enumerate(PROMPT_LENS)}
        self.tmp_root = tmp_root
        self.engines = []           # (engine, its counters when restored)

    def tmpdir(self):
        return tempfile.TemporaryDirectory(dir=self.tmp_root)


def _scfg(sampled: bool):
    from repro_torch.serve.engine import SampleConfig
    return (SampleConfig(temperature=0.7, seed=11) if sampled
            else SampleConfig())


def _engine(ctx, scfg, **kw):
    from repro_torch.serve.engine import ContinuousEngine
    eng = ContinuousEngine(ctx.cfg, ctx.params, scfg=scfg, **ENGINE_KW, **kw)
    ctx.engines.append((eng, None))
    return eng


def _separate(eng) -> bool:
    return eng.spec is not None and not eng.spec.self_draft


def restored_at(eng) -> Tuple[int, int]:
    """An engine's counters as :func:`engine_work` takes them as ``since``
    (read right after ``ContinuousEngine.from_snapshot``)."""
    return eng.decode_steps, eng.spec.draft_steps if _separate(eng) else 0


def engine_work(eng, prompt_lens, since=None) -> Dict[str, int]:
    """What ``eng`` dispatched, from its telemetry: ``paged_steps`` of the
    target (a chunk per ``prefill_chunk`` positions of each fresh prefill and
    each recompute-restore, one a decode step, ``k + 1`` a speculative
    round), ``draft_steps`` (a separate drafter's) and ``sampler_calls``
    (one a fresh prefill, one a decode step, ``k + 1`` a round, and as many
    again for a separate drafter). ``prompt_lens``: request id → prompt
    length; ``since``: :func:`restored_at` of an engine restored from a
    snapshot, whose counters start from the snapshot's."""
    c = eng.prefill_chunk
    decode0, draft0 = since or (0, 0)
    chunks = (sum(-(-prompt_lens[r] // c) for r in eng.first_token_step)
              + sum(-(-n // c) for n in eng.restore_positions))
    decode = (eng.decode_steps - decode0) * (
        1 if eng.spec is None else eng.spec.k + 1)
    separate = _separate(eng)
    return dict(paged_steps=chunks + decode,
                draft_steps=eng.spec.draft_steps - draft0 if separate else 0,
                sampler_calls=len(eng.first_token_step)
                + decode * (2 if separate else 1))


def _submit_all(eng, ctx, ids=None, **kw):
    for i in (ids if ids is not None else sorted(ctx.prompts)):
        eng.submit(ctx.prompts[i], req_id=i, max_new_tokens=GEN, **kw)


def _tok_sha(results: Dict[int, np.ndarray]) -> Dict[str, str]:
    return {str(r): hashlib.sha256(
        np.asarray(t, np.int32).tobytes()).hexdigest()[:16]
        for r, t in sorted(results.items())}


def _bitwise(base, got, ids) -> List[str]:
    """Mismatching request ids (empty = conformant)."""
    return [str(i) for i in ids if i not in got or not np.array_equal(
        np.asarray(base[i]), np.asarray(got[i]))]


def _drained(eng) -> bool:
    """Zero-leak invariant: pool fully free, no quarantine, scheduler idle."""
    return (eng.cache.free_pages == eng.cache.layout.n_pages
            and not eng._quarantine and eng.sched.idle)


def _cell(name, plan, inj, ok, results, detail):
    return {"cell": name, "ok": bool(ok),
            "plan": plan.key() if plan is not None else None,
            "n_faults": len(plan) if plan is not None else 0,
            "faults_landed": len(inj.history) if inj is not None else 0,
            "history_digest": (inj.history_digest() if inj is not None
                               else None),
            "tokens_sha256": _tok_sha(results), "detail": detail}


# --------------------------------------------------------------------- cells
def cell_unarmed_noop(ctx, base, sampled):
    """An armed empty plan: bitwise the unarmed run, nothing lands."""
    from repro_torch.faults import FaultPlan, Injector
    plan = FaultPlan(name="empty")
    inj = Injector(plan)
    eng = _engine(ctx, _scfg(sampled), faults=inj)
    _submit_all(eng, ctx)
    got = eng.run()
    bad = _bitwise(base, got, sorted(base))
    ok = not bad and not inj.history and _drained(eng)
    return _cell("unarmed_noop", plan, inj, ok, got,
                 {"mismatched": bad, "landed": len(inj.history)})


def _serve_fault_cell(ctx, base, sampled, name, plan):
    from repro_torch.faults import Injector
    inj = Injector(plan)
    eng = _engine(ctx, _scfg(sampled), faults=inj)
    _submit_all(eng, ctx)
    got = eng.run()
    bad = _bitwise(base, got, sorted(base))
    ok = not bad and _drained(eng)
    return _cell(name, plan, inj, ok, got,
                 {"mismatched": bad, "preemptions": eng.preemptions,
                  "decode_steps": eng.decode_steps})


def cell_pool_exhaustion(ctx, base, sampled):
    from repro_torch.faults import Fault, FaultPlan
    plan = FaultPlan(name="pool-squeeze", faults=(
        Fault(2, "pool_exhaust", arg=24, duration=3),
        Fault(6, "pool_exhaust", arg=16, duration=2),
        Fault(11, "pool_exhaust", arg=28, duration=4)))
    return _serve_fault_cell(ctx, base, sampled, "pool_exhaustion", plan)


def cell_slot_revocation(ctx, base, sampled):
    from repro_torch.faults import Fault, FaultPlan
    plan = FaultPlan(name="revoke-storm", faults=(
        Fault(1, "revoke_slot", arg=2), Fault(4, "revoke_slot", arg=1),
        Fault(7, "revoke_slot", arg=3), Fault(12, "revoke_slot", arg=1)))
    return _serve_fault_cell(ctx, base, sampled, "slot_revocation", plan)


def cell_decode_stall(ctx, base, sampled):
    from repro_torch.faults import Fault, FaultPlan
    plan = FaultPlan(name="stalls", faults=(
        Fault(3, "decode_stall", arg=3), Fault(9, "decode_stall", arg=2)))
    return _serve_fault_cell(ctx, base, sampled, "decode_stall", plan)


def cell_deadlines(ctx, base, sampled):
    """Two identical runs under a stall and deadlines: the cancelled sets
    match exactly, the survivors are bitwise the fault-free run's."""
    from repro_torch.faults import Fault, FaultPlan, Injector
    plan = FaultPlan(name="stall-vs-deadline",
                     faults=(Fault(2, "decode_stall", arg=6),))
    runs = []
    for _ in range(2):
        inj = Injector(plan)
        eng = _engine(ctx, _scfg(sampled), faults=inj)
        for i in sorted(base):
            eng.submit(ctx.prompts[i], req_id=i, max_new_tokens=GEN,
                       deadline_steps=6 if i >= 6 else None)
        runs.append((eng.run(), sorted(eng.cancelled), eng, inj))
    (got, cancelled, eng, inj), (got2, cancelled2, _, _) = runs
    survivors = [i for i in sorted(base) if i not in cancelled]
    bad = _bitwise(base, got, survivors)
    ok = (not bad and cancelled == cancelled2 and _drained(eng)
          and sorted(got) == sorted(got2)
          and not _bitwise(got, got2, sorted(got)))
    return _cell("deadlines", plan, inj, ok, got,
                 {"mismatched": bad, "cancelled": list(map(str, cancelled)),
                  "replay_cancelled_match": cancelled == cancelled2})


def cell_load_shedding(ctx, base, sampled):
    """Bounded queue: the shed set replays identically; admitted bitwise."""
    from repro_torch.serve.engine import QueueFull
    shed_sets, results = [], []
    for _ in range(2):
        eng = _engine(ctx, _scfg(sampled), max_queue_depth=4)
        shed = []
        for i in sorted(base):
            try:
                eng.submit(ctx.prompts[i], req_id=i, max_new_tokens=GEN)
            except QueueFull:
                shed.append(i)
        shed_sets.append(shed)
        results.append(eng.run())
    got = results[0]
    admitted = sorted(got)
    bad = _bitwise(base, got, admitted)
    ok = (not bad and shed_sets[0] == shed_sets[1]
          and sorted(results[1]) == admitted
          and not _bitwise(got, results[1], admitted)
          and len(shed_sets[0]) + len(admitted) == len(base))
    return _cell("load_shedding", None, None, ok, got,
                 {"mismatched": bad, "shed": list(map(str, shed_sets[0]))})


def cell_engine_crash_restore(ctx, base, sampled):
    """Crash mid-run → restore from the latest snapshot → bitwise finish;
    and a crash before the first snapshot (a fresh engine, everything
    submitted again: bitwise too, because the replay is deterministic)."""
    from repro_torch.faults import EngineCrash, Fault, FaultPlan, Injector
    from repro_torch.serve.engine import ContinuousEngine
    records = {}
    for crash_at, snap_every, tag in ((7, 3, "restored"), (1, 50, "fallback")):
        plan = FaultPlan(name=f"crash@{crash_at}", faults=(
            Fault(crash_at, "crash"), Fault(4, "revoke_slot", arg=1)))
        inj = Injector(plan)
        with ctx.tmpdir() as d:
            eng = _engine(ctx, _scfg(sampled), faults=inj,
                          snapshot_dir=d, snapshot_every=snap_every)
            _submit_all(eng, ctx)
            crashes = restored = 0
            while True:
                try:
                    got = eng.run()
                    break
                except EngineCrash:
                    crashes += 1
                    if os.listdir(d):
                        eng = ContinuousEngine.from_snapshot(
                            d, ctx.cfg, ctx.params, faults=inj)
                        ctx.engines.append((eng, restored_at(eng)))
                        restored += 1
                    else:               # crashed before any snapshot landed
                        eng = _engine(ctx, _scfg(sampled), faults=inj)
                        _submit_all(eng, ctx)
        bad = _bitwise(base, got, sorted(base))
        records[tag] = dict(bad=bad, crashes=crashes, restored=restored,
                            drained=_drained(eng), got=got, plan=plan, inj=inj)
    r, fb = records["restored"], records["fallback"]
    ok = (not r["bad"] and r["crashes"] == 1 and r["restored"] == 1
          and r["drained"] and not fb["bad"] and fb["crashes"] == 1
          and fb["restored"] == 0)
    keys = ("bad", "crashes", "restored")
    return _cell("engine_crash_restore", r["plan"], r["inj"], ok, r["got"],
                 {"restored": {k: r[k] for k in keys},
                  "fallback": {k: fb[k] for k in keys}})


def cell_ckpt_io_retry(ctx, base, sampled):
    """Transient injected IO errors against the bounded retry: the saves
    land, restore digest-identical, and no torn tmp dir survives; exhausted
    retries raise the injected error and publish nothing."""
    from repro_torch.ckpt import checkpoint as C
    from repro_torch.faults import (Fault, FaultPlan, InjectedIOError,
                                    Injector, armed_checkpoint)
    from repro_torch.models.module import set_path, tree_paths
    from repro_torch.verify import digest as D
    params = ctx.params
    want = D.tree_digest(params)
    plan = FaultPlan(name="flaky-io", faults=(
        Fault(10, "ckpt_io", arg=1), Fault(20, "ckpt_io", arg=2)))
    inj = Injector(plan)
    detail = {}
    with ctx.tmpdir() as d:
        with armed_checkpoint(inj):
            C.save(d, 10, params)
            C.save(d, 20, params)
        zeros: Dict = {}
        for path, leaf in tree_paths(params):
            set_path(zeros, path, torch.zeros_like(leaf))
        ok = True
        for step in (10, 20):
            got = D.tree_digest(C.restore(d, step, zeros))
            detail[f"step{step}_digest_ok"] = got == want
            ok = ok and got == want
        detail["landed_attempts"] = [e["attempt"] for e in inj.history]
        detail["no_torn_tmp"] = not any(
            n.startswith(".tmp") for n in os.listdir(d))
        ok = (ok and detail["no_torn_tmp"]
              and detail["landed_attempts"] == [0, 0, 1])
        plan2 = FaultPlan(name="dead-io", faults=(
            Fault(30, "ckpt_io", arg=C.IO_RETRIES + 5),))
        try:
            with armed_checkpoint(Injector(plan2)):
                C.save(d, 30, params)
            detail["exhausted_raises"] = False
        except InjectedIOError:
            detail["exhausted_raises"] = True
        detail["exhausted_unpublished"] = 30 not in C.available_steps(d)
        ok = (ok and detail["exhausted_raises"]
              and detail["exhausted_unpublished"])
    return _cell("ckpt_io_retry", plan, inj, ok, {}, detail)


def cell_spec_preempt(ctx, base, sampled):
    """``spec_k=4`` self-draft with slot revocations between rounds: the
    restores recompute through the speculative path, and every completed
    request is bitwise the fault-free non-speculative run's."""
    from repro_torch.faults import Fault, FaultPlan, Injector
    plan = FaultPlan(name="spec-revoke", faults=(
        Fault(1, "revoke_slot", arg=2), Fault(3, "revoke_slot", arg=1),
        Fault(5, "revoke_slot", arg=3), Fault(8, "revoke_slot", arg=1)))
    inj = Injector(plan)
    eng = _engine(ctx, _scfg(sampled), faults=inj, spec_k=4)
    _submit_all(eng, ctx)
    got = eng.run()
    bad = _bitwise(base, got, sorted(base))
    ok = not bad and _drained(eng)
    return _cell("spec_preempt", plan, inj, ok, got,
                 {"mismatched": bad, "preemptions": eng.preemptions,
                  "spec_rounds": eng.spec.rounds,
                  "spec_acceptance": eng.spec.acceptance_rate()})


def cell_seeded_mix(ctx, base, sampled, seed):
    from repro_torch.faults import FaultPlan
    plan = FaultPlan.seeded(seed, steps=40, rate=0.35,
                            name=f"mix-seed{seed}")
    return _serve_fault_cell(ctx, base, sampled, f"seeded_mix_{seed}", plan)


CELLS = {
    "unarmed_noop": cell_unarmed_noop,
    "pool_exhaustion": cell_pool_exhaustion,
    "slot_revocation": cell_slot_revocation,
    "decode_stall": cell_decode_stall,
    "deadlines": cell_deadlines,
    "load_shedding": cell_load_shedding,
    "engine_crash_restore": cell_engine_crash_restore,
    "ckpt_io_retry": cell_ckpt_io_retry,
    "spec_preempt": cell_spec_preempt,
    "seeded_mix_1": lambda c, b, s: cell_seeded_mix(c, b, s, 1),
    "seeded_mix_2": lambda c, b, s: cell_seeded_mix(c, b, s, 2),
}


def run_matrix(out: Optional[str] = None, cells: Optional[List[str]] = None,
               sampled: bool = True, *, device=None, reduced: bool = True,
               overrides: Tuple[Tuple[str, object], ...] = (),
               tmp_root: Optional[str] = None) -> Dict:
    """Run the matrix on ``device`` (the card unless ``"cpu"``) over the
    reduced StableLM, or its published widths with ``reduced=False``, each
    with ``overrides``; snapshots and checkpoints go under ``tmp_root``
    (the system's temporary directory by default). Optionally write the
    JSON artifact to ``out``."""
    device = resolve_device(device)
    ctx = _Ctx(device, reduced, overrides, tmp_root)
    eng = _engine(ctx, _scfg(sampled))
    _submit_all(eng, ctx)
    base = eng.run()
    report = {
        "format": 1,
        "config": {"arch": ARCH, "reduced": reduced, "gen": GEN,
                   "overrides": [list(o) for o in overrides],
                   "device": str(device), "prompt_lens": PROMPT_LENS,
                   "sampled": sampled, **ENGINE_KW},
        "baseline_tokens_sha256": _tok_sha(base),
        "cells": [],
    }
    for name in (cells if cells is not None else sorted(CELLS)):
        report["cells"].append(CELLS[name](ctx, base, sampled))
    report["ok"] = all(c["ok"] for c in report["cells"])
    lens = {i: len(p) for i, p in ctx.prompts.items()}
    work = [engine_work(e, lens, since) for e, since in ctx.engines]
    report["work"] = {k: sum(w[k] for w in work) for k in work[0]}
    report["work"]["engines"] = len(work)
    if out:
        with open(out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="chaos_conformance.json")
    p.add_argument("--cells", nargs="*", default=None,
                   help="subset of cells (default: all)")
    p.add_argument("--greedy", action="store_true",
                   help="greedy sampling instead of temperature=0.7")
    p.add_argument("--device", default=None,
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--reduced", action="store_true",
                   help="the reference's reduced widths (default: the "
                        "published ones)")
    p.add_argument("--layers", type=int, default=None,
                   help="cut the model to this many layers")
    args = p.parse_args(argv)
    overrides = (("n_layers", args.layers),) if args.layers else ()
    report = run_matrix(out=args.out, cells=args.cells,
                        sampled=not args.greedy, device=args.device,
                        reduced=args.reduced, overrides=overrides)
    for c in report["cells"]:
        print(f"  {'PASS' if c['ok'] else 'FAIL'}  {c['cell']:24s} "
              f"plan={c['plan']}  landed={c['faults_landed']}")
    print(("chaos conformance: OK" if report["ok"]
           else "chaos conformance: FAILED") + f" -> {args.out}")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
