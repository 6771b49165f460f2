"""Digest-divergence alarm: the live end of the reproducibility contract.

Port of ``repro.obs.alarm``; it reads the reference's tracker files too.
``repro_torch.verify.digest.tree_fingerprint`` ships a uint32 state fingerprint in the
per-step metrics (``TrainConfig.digest_metrics``); this module turns that
stream into an *alarm*: every observed fingerprint is logged as a
``fingerprint`` event, and when a reference run is loaded (a previous
tracker JSONL, or any ``{step: fingerprint}`` map) the first mismatching step
fires a single ``fingerprint_divergence`` event and latches.

This is the in-flight analogue of ``verify.lifecycle``'s offline sha256
chains: the fingerprint is not cryptographic, but any single-bit flip in any
state leaf changes it with overwhelming probability — enough to *detect*
divergence within one step of it happening, then localize offline with the
digest chain.  HEAL (PAPERS.md) documents why heavy-traffic deployments want
exactly this signal streaming, not post-hoc.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.obs.tracker import NoopTracker, read_jsonl


class DivergenceAlarm:
    """Observe the live fingerprint stream; alarm on reference mismatch.

    With ``reference=None`` the alarm only records (a later run can use this
    run's JSONL as its reference).  ``observe`` returns True iff this step
    diverged from the reference.
    """

    def __init__(self, tracker=None, reference: Optional[Dict[int, int]] = None):
        self.tracker = tracker or NoopTracker()
        self.reference = dict(reference) if reference else None
        self.seen: Dict[int, int] = {}
        self.diverged_at: Optional[int] = None

    @classmethod
    def from_jsonl(cls, path: str, tracker=None) -> "DivergenceAlarm":
        """Reference = the ``fingerprint`` events of a previous run's JSONL."""
        ref = {int(rec["step"]): int(rec["fingerprint"])
               for rec in read_jsonl(path, event="fingerprint")}
        return cls(tracker=tracker, reference=ref)

    def observe(self, step: int, fingerprint) -> bool:
        """Record one step's uint32 fingerprint; fire on first divergence."""
        fp = int(fingerprint)
        self.seen[int(step)] = fp
        self.tracker.log("fingerprint", {"fingerprint": fp}, step=step)
        if (self.reference is not None and self.diverged_at is None
                and step in self.reference and self.reference[step] != fp):
            self.diverged_at = int(step)
            self.tracker.log("fingerprint_divergence", {
                "fingerprint": fp,
                "reference_fingerprint": self.reference[step],
            }, step=step)
            return True
        return False

    @property
    def ok(self) -> bool:
        return self.diverged_at is None
