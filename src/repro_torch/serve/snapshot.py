"""Engine snapshot and restore: a crashed engine resumes every stream bitwise.

Port of ``repro.serve.snapshot``, in its format. A snapshot is the whole
deterministic state of a :class:`~repro_torch.serve.engine.ContinuousEngine`
at an engine-step boundary:

  * the KV pools (``pools/...``), plus a separate drafter's pools
    (``draft_pools/...``): the only device state;
  * one host blob (``host``): scheduler queues, page tables and the free
    heap, each slot's decode state (emitted tokens and their logprobs; the
    sampler's keys are ``(seed, request_id, token_index)``, so the tokens
    are the state), deadlines, preempted prefixes, quarantined pages, the
    speculative telemetry and every counter faults and deadlines key to, as
    canonical JSON in a uint8 leaf (``SNAPSHOT_FORMAT = 2``).

Both go through :func:`repro_torch.ckpt.checkpoint.save`, the manifest-v2
path: every leaf has its sha256 digest, writes are tmp + rename, and a torn
snapshot is never published. A pool's ``(k, v)`` pair is stored under the
keys ``.../attn/0`` and ``.../attn/1``, the reference's key paths; bf16
pools are stored as their fp32 upcast. :func:`load_engine_snapshot`
verifies every leaf's digest against the manifest; :func:`restore_engine`
casts each pool leaf to the engine's own pool dtype, verifies its digest
and copies it onto the engine's device. Directories are ``step_<k>/``
with ``<k>`` the engine step.

Across the packages the compatibility is one-way and partial: the port's
:func:`load_engine_snapshot` reads a snapshot the reference wrote (manifest,
host blob and pool leaves, every digest verified), but
:func:`restore_engine` refuses it, because ``cfg_key`` hashes
``repr(cfg)`` and the two packages' ``ModelConfig`` reprs differ (the port
has fewer fields, and ``attention_impl`` is ``"torch"``/``"cuda"``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as C
from repro_torch.models.module import tree_paths
from repro_torch.serve.scheduler import Request
from repro_torch.verify import digest as D

SNAPSHOT_FORMAT = 2        # v2: the spec block in the host blob and the
#                            optional drafter pools


def _cfg_key(cfg) -> str:
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


def _pool_tree(pools) -> Dict:
    """The pools with each ``(k, v)`` pair as ``{"0": k, "1": v}``: the
    reference's leaf paths, in a tree ``checkpoint.save`` walks."""
    return {name: {kind: {str(i): t for i, t in enumerate(pair)}
                   for kind, pair in block.items()}
            for name, block in pools.items()}


def _host_state(eng) -> Dict:
    """The engine's host state as a JSON-able dict (Python floats
    round-trip bitwise through JSON)."""
    sched = eng.sched
    return {
        "format": SNAPSHOT_FORMAT,
        "cfg_key": _cfg_key(eng.cfg),
        "geometry": {
            "n_slots": eng.cache.layout.n_slots,
            "max_seq": eng.max_seq,
            "page_size": eng.cache.layout.page_size,
            "n_pages": eng.cache.layout.n_pages,
            "prefill_chunk": eng.prefill_chunk,
            "max_queue_depth": eng.max_queue_depth,
            "snapshot_every": eng.snapshot_every,
        },
        "scfg": dataclasses.asdict(eng.scfg),
        "engine_steps": eng.engine_steps,
        "decode_steps": eng.decode_steps,
        "preemptions": eng.preemptions,
        "next_id": eng._next_id,
        "stall_until": eng._stall_until,
        "pending": [[r.id, list(r.tokens), r.max_new_tokens]
                    for _, r in sorted(sched.pending.items())],
        "active": [[slot, st.req.id, list(st.req.tokens),
                    st.req.max_new_tokens, list(st.produced),
                    list(st.logprobs), bool(st.done)]
                   for slot, st in sorted(eng._slots.items())],
        "results": {str(rid): list(toks)
                    for rid, toks in eng.results.items()},
        "result_logprobs": {str(rid): np.asarray(lp, np.float32).tolist()
                            for rid, lp in eng.result_logprobs.items()},
        "rejected": {str(rid): why for rid, why in eng.rejected.items()},
        "cancelled": {str(rid): np.asarray(t, np.int32).tolist()
                      for rid, t in eng.cancelled.items()},
        "deadline": {str(rid): d for rid, d in eng._deadline.items()},
        "resume": {str(rid): [list(p), list(lp)]
                   for rid, (p, lp) in eng._resume.items()},
        "quarantine": [[release, list(pages)]
                       for release, pages in eng._quarantine],
        "page_table": eng.cache.page_table.tolist(),
        "pages_held": eng.cache.pages_held.tolist(),
        "free_pages": sorted(eng.cache._free),
        "spec": None if eng.spec is None else {
            "k": eng.spec.k,
            "self_draft": eng.spec.self_draft,
            "draft_cfg_key": (None if eng.spec.self_draft
                              else _cfg_key(eng.spec.dcfg)),
            "rounds": eng.spec.rounds,
            "drafted": eng.spec.drafted,
            "accepted": eng.spec.accepted,
            "truncated": eng.spec.truncated,
            "draft_steps": eng.spec.draft_steps,
        },
    }


def save_engine_snapshot(eng, directory: str) -> int:
    """Write the snapshot of the current engine step; returns that step."""
    blob = json.dumps(_host_state(eng), sort_keys=True,
                      separators=(",", ":")).encode()
    tree = {"host": torch.frombuffer(bytearray(blob), dtype=torch.uint8),
            "pools": _pool_tree(eng.cache.pools)}
    if eng.spec is not None and not eng.spec.self_draft:
        tree["draft_pools"] = _pool_tree(eng.spec.pools)
    step = eng.engine_steps
    C.save(directory, step, tree, keep_last=3)
    eng.tracker.log("serve_snapshot", {"engine_step": step,
                                       "directory": directory}, step=step)
    return step


def _as_saved(arr: np.ndarray, dtype: str):
    """A stored leaf in its original dtype (bf16 through torch)."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr).to(torch.bfloat16)
    return arr.astype(np.dtype(dtype), copy=False)


def load_engine_snapshot(directory: str, step: Optional[int] = None, *,
                         verify_pools: bool = True):
    """Read one snapshot and verify its leaves' digests against the
    manifest: the host blob always, the pools unless ``verify_pools`` is
    off (:func:`restore_engine` verifies each pool leaf as it casts it).
    Returns ``(host_state, raw_arrays, manifest)``: ``raw_arrays`` holds
    the npz contents by manifest key, pools still in their storage dtype."""
    if step is None:
        step = C.latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no engine snapshot under {directory}")
    manifest = C.read_manifest(directory, step)
    with np.load(os.path.join(directory, f"step_{step}",
                              "arrays.npz")) as data:
        raw = {k: data[k] for k in manifest["arrays"]}
    if D.leaf_digest(raw["host"]) != manifest["arrays"]["host"]["digest"]:
        raise ValueError(f"snapshot host-state digest mismatch at step "
                         f"{step} — corrupted snapshot")
    for key, entry in manifest["arrays"].items():
        if key == "host" or not verify_pools:
            continue
        if D.leaf_digest(_as_saved(raw[key], entry["dtype"])) != \
                entry["digest"]:
            raise ValueError(f"snapshot digest mismatch for '{key}' at step "
                             f"{step} — corrupted snapshot")
    state = json.loads(raw["host"].tobytes().decode())
    if state.get("format") != SNAPSHOT_FORMAT:
        raise ValueError(f"snapshot format {state.get('format')} != "
                         f"{SNAPSHOT_FORMAT}")
    return state, raw, manifest


def _restore_pools(pools, raw, manifest, prefix: str) -> None:
    """Copy each stored leaf into the engine's own pool leaf, cast to that
    leaf's dtype and digest-verified first."""
    for path, leaf in tree_paths(_pool_tree(pools)):
        key = f"{prefix}/{path}"
        arr = raw[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"snapshot leaf '{key}' is {arr.shape}, the "
                             f"engine's pool {tuple(leaf.shape)}")
        host = torch.from_numpy(arr).to(leaf.dtype)
        if D.leaf_digest(host) != manifest["arrays"][key]["digest"]:
            raise ValueError(f"snapshot digest mismatch for '{key}' — "
                             "corrupted or lossy round trip")
        leaf.copy_(host)


def restore_engine(directory: str, cfg, params, *, step: Optional[int] = None,
                   faults=None, tracker=None, mesh=None, draft_cfg=None,
                   draft_params=None):
    """Rebuild a :class:`ContinuousEngine` from a snapshot on the params'
    device, ready to ``run()``. Geometry and sampling config come from the
    snapshot; the caller gives what was never stored (params, an injector,
    a separate drafter's params). The speculative state (k, drafter pools,
    telemetry) restores with the rest, so the rounds replay bitwise."""
    from repro_torch.serve.engine import (ContinuousEngine, SampleConfig,
                                          _Active)

    state, raw, manifest = load_engine_snapshot(directory, step,
                                                verify_pools=False)
    if state["cfg_key"] != _cfg_key(cfg):
        raise ValueError(
            "snapshot was taken under a different model config "
            f"({state['cfg_key']} != {_cfg_key(cfg)}) — params/cfg must match "
            "the crashed engine's")
    g = state["geometry"]
    spec_state = state.get("spec")
    spec_kw = {}
    if spec_state is not None:
        spec_kw["spec_k"] = spec_state["k"]
        if not spec_state["self_draft"]:
            if draft_params is None:
                raise ValueError(
                    "snapshot was taken with a separate drafter: pass "
                    "draft_params (and draft_cfg if one was used) to restore")
            dcfg = draft_cfg or cfg
            if _cfg_key(dcfg) != spec_state["draft_cfg_key"]:
                raise ValueError(
                    "snapshot drafter config mismatch "
                    f"({spec_state['draft_cfg_key']} != {_cfg_key(dcfg)})")
            spec_kw["draft_cfg"] = draft_cfg
            spec_kw["draft_params"] = draft_params
    eng = ContinuousEngine(
        cfg, params, n_slots=g["n_slots"], max_seq=g["max_seq"],
        page_size=g["page_size"], n_pages=g["n_pages"],
        prefill_chunk=g["prefill_chunk"], scfg=SampleConfig(**state["scfg"]),
        tracker=tracker, mesh=mesh, faults=faults,
        max_queue_depth=g["max_queue_depth"], snapshot_dir=directory,
        snapshot_every=g["snapshot_every"], **spec_kw)

    _restore_pools(eng.cache.pools, raw, manifest, "pools")
    if spec_state is not None:
        eng.spec.rounds = spec_state["rounds"]
        eng.spec.drafted = spec_state["drafted"]
        eng.spec.accepted = spec_state["accepted"]
        eng.spec.truncated = spec_state["truncated"]
        eng.spec.draft_steps = spec_state["draft_steps"]
        if not spec_state["self_draft"]:
            _restore_pools(eng.spec.pools, raw, manifest, "draft_pools")

    lay = eng.cache.layout
    eng.cache.page_table = np.asarray(state["page_table"], np.int32).reshape(
        lay.n_slots, lay.max_pages_per_slot)
    eng.cache.pages_held = np.asarray(state["pages_held"], np.int32)
    eng.cache._free = list(state["free_pages"])     # sorted: a valid heap

    eng.sched.pending = {rid: Request(rid, tuple(toks), mnt)
                         for rid, toks, mnt in state["pending"]}
    eng.sched.active = {}
    eng._slots = {}
    for slot, rid, toks, mnt, produced, lps, done in state["active"]:
        req = Request(rid, tuple(toks), mnt)
        eng.sched.active[slot] = req
        eng._slots[slot] = _Active(req, list(produced), list(lps), done)
    eng.sched._free_slots = [s for s in range(lay.n_slots)
                             if s not in eng.sched.active]

    eng.results = {int(r): list(t) for r, t in state["results"].items()}
    eng.result_logprobs = {int(r): np.asarray(lp, np.float32)
                           for r, lp in state["result_logprobs"].items()}
    eng.rejected = {int(r): why for r, why in state["rejected"].items()}
    eng.cancelled = {int(r): np.asarray(t, np.int32)
                     for r, t in state["cancelled"].items()}
    eng._deadline = {int(r): d for r, d in state["deadline"].items()}
    eng._resume = {int(r): (list(p), list(lp))
                   for r, (p, lp) in state["resume"].items()}
    eng._quarantine = [(release, list(pages))
                       for release, pages in state["quarantine"]]
    eng.engine_steps = state["engine_steps"]
    eng.decode_steps = state["decode_steps"]
    eng.preemptions = state["preemptions"]
    eng._next_id = state["next_id"]
    eng._stall_until = state["stall_until"]
    eng.tracker.log("serve_snapshot_restore", {
        "engine_step": eng.engine_steps, "directory": directory})
    return eng
