"""Injection sites and the armed :class:`Injector` threaded through the stack.

Port of ``repro.faults.inject``. The continuous engine takes
``faults=Injector(plan)`` and consults :meth:`Injector.step_faults` once per
engine step; the checkpoint writer (``repro_torch.ckpt.checkpoint``) exposes
a module-level IO hook, ``_IO_HOOK``, that :func:`armed_checkpoint` installs
for the duration of a ``with`` block. Unarmed is a no-op by construction:
with ``faults=None`` the engine never calls into this module, and with no
hook installed the writer's path is untouched.

Every fault that lands is appended to :attr:`Injector.history` (site, step,
kind, magnitudes, landing info) and folded into a sha256 chain,
:meth:`Injector.history_digest`: the record of where each fault landed. The
chain hashes canonical JSON only, so the same landing records digest equally
in both packages.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
from typing import Dict, List, Optional

from repro_torch.faults.plan import Fault, FaultPlan


class FaultError(RuntimeError):
    """Base class for injected failures."""


class EngineCrash(FaultError):
    """Injected mid-run engine death (serve.engine site). The recovery
    contract: restore from the latest engine snapshot and every in-flight
    stream still completes bitwise."""

    def __init__(self, step: int):
        self.step = step
        super().__init__(f"injected engine crash at engine step {step}")


class InjectedIOError(OSError):
    """Injected transient checkpoint IO failure (ckpt.write site): an
    ``OSError``, so the writer's bounded retry treats it as a real one."""


class Injector:
    """Armed fault plan + the landing record.

    One injector can drive a whole crash/restore cycle: crashes are one-shot
    (:meth:`consume_crash`), so a restored engine replaying the steps before
    the crash re-applies every other fault without dying again. With a
    ``tracker`` every landed fault is also logged as a ``fault_injected``
    event."""

    def __init__(self, plan: FaultPlan, tracker=None):
        self.plan = plan
        self.tracker = tracker
        self.history: List[Dict] = []
        self._fired_crashes: set = set()

    # -------------------------------------------------------------- serve
    def step_faults(self, step: int):
        """Serve-site faults scheduled for this engine step."""
        return self.plan.at(step)

    def consume_crash(self, fault: Fault) -> bool:
        """True exactly once per crash fault (a replay after a restore
        skips it)."""
        if fault in self._fired_crashes:
            return False
        self._fired_crashes.add(fault)
        return True

    # --------------------------------------------------------------- ckpt
    def ckpt_attempt(self, step: int, attempt: int) -> None:
        """Checkpoint-write hook body: raise for the first ``arg`` attempts
        of a save the plan targets."""
        fail_n = self.plan.ckpt_failures(step)
        if attempt < fail_n:
            self.record(Fault(step, "ckpt_io", arg=fail_n), attempt=attempt)
            raise InjectedIOError(
                f"injected ckpt IO error (step={step}, attempt={attempt}, "
                f"failing first {fail_n})")

    # ------------------------------------------------------------- record
    def record(self, fault: Fault, **info) -> None:
        """Log one landed fault into the history (and the tracker, if any)."""
        entry = {"site": fault.site, "step": fault.step, "kind": fault.kind,
                 "arg": fault.arg, "duration": fault.duration, **info}
        self.history.append(entry)
        if self.tracker is not None:
            self.tracker.log("fault_injected", entry, step=fault.step)

    def history_digest(self) -> str:
        """sha256 chain over the landing record: two runs injected the same
        faults in the same places iff their digests match."""
        head = hashlib.sha256().hexdigest()
        for entry in self.history:
            h = hashlib.sha256()
            h.update(head.encode())
            h.update(json.dumps(entry, sort_keys=True,
                                separators=(",", ":")).encode())
            head = h.hexdigest()
        return head


@contextlib.contextmanager
def armed_checkpoint(injector: Optional[Injector]):
    """Install ``injector`` as the checkpoint writer's IO hook for the block.

    ``armed_checkpoint(None)`` is a no-op context. The previous hook is
    restored on exit, so nesting and exceptions leave no armed plan behind.
    An async save started inside the block consults the hook from its
    writer thread: join it before the block ends."""
    if injector is None:
        yield None
        return
    from repro_torch.ckpt import checkpoint as C

    def hook(*, step: int, attempt: int) -> None:
        injector.ckpt_attempt(step, attempt)

    old = C._IO_HOOK
    C._IO_HOOK = hook
    try:
        yield injector
    finally:
        C._IO_HOOK = old
