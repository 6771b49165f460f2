"""Deterministic fault plans: *which* fault lands *where*, fixed up front.

Copy of ``repro.faults.plan`` (numpy only), kept in the port so that it
imports nothing of the JAX package. Plan keys are framework-neutral: the
same plan has the same ``key()`` and ``canonical_json()`` in both packages.

A :class:`FaultPlan` is a frozen, hashable schedule of injections keyed by
(step, site). Nothing about an armed plan consults a clock, a pid or an RNG
at injection time: the plan is built once (literally, or by
:meth:`FaultPlan.seeded` from a seed) and every fault fires at a pre-decided
engine step or checkpoint attempt, so the same plan against the same request
stream injects the same failures, bit for bit.

``key()`` is ``faultplan-v{N}|sha256(canonical JSON)[:24]``, so a plan can
name a conformance cell or a chaos artifact without ambiguity.

Fault kinds (``site`` tells which layer consumes them):

  ================  ==============  ==========================================
  kind              site            semantics (``arg`` / ``duration``)
  ================  ==============  ==========================================
  ``pool_exhaust``  serve.pool      quarantine ``arg`` KV pages for
                                    ``duration`` engine steps (preempting
                                    victims if the free pool cannot cover it)
  ``revoke_slot``   serve.slot      preempt ``arg`` active slots (highest
                                    request id first: the deterministic
                                    victim rule)
  ``decode_stall``  serve.decode    no decode progress for ``arg`` steps
                                    (deadlines keep ticking)
  ``crash``         serve.engine    raise :class:`repro_torch.faults.
                                    EngineCrash` at the step (one-shot per
                                    injector)
  ``ckpt_io``       ckpt.write      fail the first ``arg`` write attempts of
                                    the checkpoint save at step ``step``
  ================  ==============  ==========================================
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

PLAN_VERSION = 1

KINDS = ("pool_exhaust", "revoke_slot", "decode_stall", "crash", "ckpt_io")

SITES = {
    "pool_exhaust": "serve.pool",
    "revoke_slot": "serve.slot",
    "decode_stall": "serve.decode",
    "crash": "serve.engine",
    "ckpt_io": "ckpt.write",
}


@dataclasses.dataclass(frozen=True, order=True)
class Fault:
    """One scheduled injection. ``step`` is an engine step for serve sites and
    a checkpoint step for ``ckpt_io``; ``arg``/``duration`` are kind-specific
    magnitudes (see the module table)."""
    step: int
    kind: str
    arg: int = 1
    duration: int = 1

    def __post_init__(self):
        # ValueError, not assert: plans come from CLIs/JSON and must fail
        # loudly under -O too
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")
        if self.step < 0 or self.arg < 0 or self.duration < 1:
            raise ValueError(f"bad fault magnitudes: {self}")

    @property
    def site(self) -> str:
        return SITES[self.kind]

    def to_dict(self) -> Dict:
        return {"step": self.step, "kind": self.kind, "arg": self.arg,
                "duration": self.duration}

    @classmethod
    def from_dict(cls, d: Dict) -> "Fault":
        return cls(step=int(d["step"]), kind=str(d["kind"]),
                   arg=int(d.get("arg", 1)), duration=int(d.get("duration", 1)))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable, sorted, content-addressed schedule of :class:`Fault`s."""
    faults: Tuple[Fault, ...] = ()
    name: str = ""

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(sorted(self.faults)))

    # ------------------------------------------------------------ addressing
    def canonical_json(self) -> str:
        return json.dumps(
            {"plan_version": PLAN_VERSION, "name": self.name,
             "faults": [f.to_dict() for f in self.faults]},
            sort_keys=True, separators=(",", ":"))

    def key(self) -> str:
        """Content address: two plans injecting the same faults share a key
        (``name`` is a display label, not content), and any fault edit — or a
        PLAN_VERSION bump — changes it, the same contract as
        ``tune.cache.make_key``."""
        content = json.dumps(
            {"plan_version": PLAN_VERSION,
             "faults": [f.to_dict() for f in self.faults]},
            sort_keys=True, separators=(",", ":"))
        digest = hashlib.sha256(content.encode()).hexdigest()
        return f"faultplan-v{PLAN_VERSION}|{digest[:24]}"

    def to_json(self) -> str:
        return self.canonical_json()

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        obj = json.loads(text)
        if obj.get("plan_version") != PLAN_VERSION:
            raise ValueError(
                f"fault plan version {obj.get('plan_version')} != "
                f"{PLAN_VERSION}; regenerate the plan")
        return cls(faults=tuple(Fault.from_dict(d) for d in obj["faults"]),
                   name=obj.get("name", ""))

    # --------------------------------------------------------------- queries
    def at(self, step: int) -> Tuple[Fault, ...]:
        """Serve-site faults scheduled for engine step ``step`` (sorted)."""
        return tuple(f for f in self.faults
                     if f.step == step and f.kind != "ckpt_io")

    def ckpt_failures(self, step: int) -> int:
        """How many consecutive write attempts of the checkpoint save at
        ``step`` should fail (0 = none)."""
        return max((f.arg for f in self.faults
                    if f.kind == "ckpt_io" and f.step == step), default=0)

    @property
    def horizon(self) -> int:
        """Last scheduled step (plans are finite by construction)."""
        return max((f.step for f in self.faults), default=-1)

    def __len__(self) -> int:
        return len(self.faults)

    # ------------------------------------------------------------ generators
    @classmethod
    def seeded(cls, seed: int, *, steps: int,
               kinds: Sequence[str] = ("pool_exhaust", "revoke_slot",
                                       "decode_stall"),
               rate: float = 0.15, max_pages: int = 4, max_stall: int = 3,
               max_duration: int = 4, crash_at: Optional[int] = None,
               name: str = "") -> "FaultPlan":
        """Deterministic random plan over ``steps`` engine steps.

        Each step independently draws one fault with probability ``rate``
        from ``kinds`` (uniform), with magnitudes drawn from the given
        bounds — all from ``np.random.RandomState(seed)``, so the plan is a
        pure function of its arguments.  ``crash_at`` adds a single one-shot
        engine crash (crashes are never drawn randomly: a crash needs a
        snapshot/restore harness around the engine, so it is always an
        explicit choice).
        """
        for k in kinds:
            if k not in KINDS or k in ("crash", "ckpt_io"):
                raise ValueError(f"seeded() draws from serve fault kinds, "
                                 f"got {k!r}")
        rng = np.random.RandomState(seed)
        faults = []
        for step in range(steps):
            if rng.rand() >= rate:
                continue
            kind = kinds[rng.randint(len(kinds))]
            if kind == "pool_exhaust":
                faults.append(Fault(step, kind,
                                    arg=int(rng.randint(1, max_pages + 1)),
                                    duration=int(rng.randint(
                                        1, max_duration + 1))))
            elif kind == "revoke_slot":
                faults.append(Fault(step, kind, arg=1))
            elif kind == "decode_stall":
                faults.append(Fault(step, kind,
                                    arg=int(rng.randint(1, max_stall + 1))))
        if crash_at is not None:
            faults.append(Fault(int(crash_at), "crash"))
        return cls(faults=tuple(faults), name=name or f"seeded-{seed}")

    @classmethod
    def seeded_ckpt(cls, seed: int, *, steps: int, every: int,
                    rate: float = 0.5, max_failures: int = 2,
                    name: str = "") -> "FaultPlan":
        """Transient checkpoint-IO faults for a training run that saves every
        ``every`` steps: each save draws ``1..max_failures`` failing attempts
        with probability ``rate``.  ``max_failures`` must stay within the
        writer's retry budget for the run to complete (the bounded-retry
        contract — exceed it and the save legitimately fails)."""
        rng = np.random.RandomState(seed)
        faults = []
        for step in range(every, steps + 1, every):
            if rng.rand() < rate:
                faults.append(Fault(step, "ckpt_io",
                                    arg=int(rng.randint(1, max_failures + 1))))
        return cls(faults=tuple(faults), name=name or f"seeded-ckpt-{seed}")
