"""Deterministic fault injection: the port of ``repro.faults``.

  plan.py         hashable, content-addressed :class:`FaultPlan`s (a copy of
                  the reference's numpy-only module)
  inject.py       :class:`Injector` (the armed plan + landing record),
                  :func:`armed_checkpoint` and the typed fault exceptions
  conformance.py  the chaos conformance matrix: every completed request
                  bitwise equal to the fault-free run (``python -m
                  repro_torch.faults.conformance``)

The hardened layers are ``serve/engine.py`` (preemption, quarantine,
stalls, snapshot/restore) and ``ckpt/checkpoint.py`` (bounded retry).
"""
from repro_torch.faults.inject import (EngineCrash, FaultError,
                                       InjectedIOError, Injector,
                                       armed_checkpoint)
from repro_torch.faults.plan import KINDS, Fault, FaultPlan

__all__ = ["Fault", "FaultPlan", "KINDS", "Injector", "EngineCrash",
           "FaultError", "InjectedIOError", "armed_checkpoint"]
