"""The profiling facade the engine and the train loop thread.

Port of ``repro.obs.prof``. :class:`Profiler` is a
:class:`repro_torch.obs.span.SpanTracer` plus the repo's span-phase
vocabulary and the producer-side digest helper. One profiler per run;
producers hold it and call ``span``/``begin``/``end``/``mark`` at phase
boundaries. Everything is host-side and disarmed-free: against a
``NoopTracker`` no clock is read and no object allocated, so an unprofiled
run is a bitwise no-op (tests/test_torch_obs_engine.py holds this on the
plain, speculative and chaos serve paths).

Span phases:

  serving (``serve/engine.py``, ``serve/spec.py``):
    ``request``        submit → reap, one per request (scope ``req:<id>``);
                       closed with ``n_tokens``; ``ttft_s`` lands on the
                       prefill span.
    ``queue``          submit → slot admission; closed with ``queued_steps``
                       (deterministic engine-step wait) + wall ``dur_s``.
    ``prefill``        chunked prompt prefill incl. first sampled token;
                       closed with ``prompt_len``, ``chunks``, ``ttft_s``
                       (``restored=True`` on a preemption re-prefill).
    ``prefill_chunk``  one engine pass over one prompt chunk
                       (scope ``req:<id>/pos:<start>``).
    ``decode``         one batched decode step (scope ``step:<n>``,
                       lane ``engine``); closed with ``live_slots``,
                       ``committed``.
    ``spec_round``     one speculative draft+verify round (same scope/lane
                       as ``decode``); join ``serve_spec_round`` on ``step``
                       for ``committed``/``accepted``.
    ``spec_draft`` / ``spec_verify``  the drafter's and the target's steps
                       inside a separate-drafter round (self-draft rounds
                       emit only ``spec_round``).
    ``sharded_build``  the mesh-sharded step's build (the reference's
                       ``serve/sharded.py``; not emitted until ROADMAP A9).

  training (``launch/train.py``; all scoped ``step:<n>``):
    ``train_data``     host batch slice.
    ``train_step``     the train step, up to its metrics on the host.
    ``train_digest``   digest-chain append (tree + per-leaf sha256).
    ``train_ckpt``     checkpoint save dispatch (+ previous async join).

Span ids are sha256 of ``(run_id, scope, phase)`` — see
:mod:`repro_torch.obs.span` — so two runs of the same program agree on
every id.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.obs.span import Span, SpanTracer, span_id  # noqa: F401
from repro_torch.obs.tracker import NoopTracker, Tracker

SERVE_PHASES = ("request", "queue", "prefill", "prefill_chunk", "decode",
                "spec_round", "spec_draft", "spec_verify", "sharded_build")
TRAIN_PHASES = ("train_data", "train_step", "train_digest", "train_ckpt")


class Profiler(SpanTracer):
    """The span tracer producers thread; see module docstring for phases."""


def open_profiler(tracker: Optional[Tracker], run_id: str) -> Profiler:
    """One-liner for producers: a profiler over an optional tracker."""
    return Profiler(tracker, run_id=run_id)


def record_state_digests(state, step: int, tracker=None, chain=None,
                         leaf_hex: int = 16) -> str:
    """Digest a train state once; feed every consumer from it.

    Computes the per-leaf sha256 map
    (``repro_torch.verify.digest.tree_leaf_digests``), combines it into the
    tree digest, appends that to ``chain`` (a ``DigestChain``) when given,
    and logs a ``leaf_digests`` event carrying the tree digest plus
    ``leaf_hex``-truncated per-leaf digests when ``tracker`` is armed — the
    record :func:`repro_torch.obs.report.diff_runs` uses to name the first
    diverging *leaf path*, not just the step. Returns the full tree digest.
    """
    from repro_torch.verify import digest as D

    named = D.tree_leaf_digests(state)
    tree = D.combine_leaf_digests(named)
    if chain is not None:
        chain.append_digest(step, tree)
    if tracker is not None and not isinstance(tracker, NoopTracker):
        leaves: Dict[str, str] = {k: v[:leaf_hex] for k, v in named.items()}
        tracker.log("leaf_digests",
                    {"tree_digest": tree, "leaves": leaves}, step=step)
    return tree
