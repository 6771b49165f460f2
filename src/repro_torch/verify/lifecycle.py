"""Training-lifecycle drivers returning digest chains (the conformance layer).

Port of ``repro.verify.lifecycle``. Each driver runs the real
``train/step.py`` under a small config and returns a
:class:`repro_torch.verify.digest.DigestChain` with one record per
completed optimizer step:

* :func:`run_straight`          — N uninterrupted steps;
* :func:`run_with_crash_resume` — k steps → async checkpoint → simulated crash
  (state and step function dropped) → fresh build → restore → N−k steps.

The contract: both chains are bitwise identical, per ``MATRIX`` cell
(microbatching, int8 grad compression with error feedback in the state,
remat policy ``dots``, GQA, bf16 optimizer state). ``EXTRA`` holds two cells
the reference's matrix lacks: Adafactor, and packed documents
(:class:`~repro_torch.data.pipeline.PackedDocs`, segment-masked attention on
the plain path).

Not ported: the ``moe`` cell (waits for ``models/moe.py``, ROADMAP A8), the
``elastic`` scenario (re-sharding onto another mesh, ``dist/sharding.py``,
ROADMAP A9) and the ``train_serve_parity`` cell (the continuous engine,
ROADMAP A5); each raises ``NotImplementedError``.

Every driver takes ``device=`` (the card by default; ``"cpu"`` runs the
plain path). Runnable as a module:

    PYTHONPATH=src python -m repro_torch.verify.lifecycle --cells base,int8 \
        --device cpu [--out conformance.json]
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import checkpoint as C
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, PackedDocs, make_source
from repro_torch.train import optimizer as O
from repro_torch.train import step as S
from repro_torch.verify.digest import DigestChain, batch_digest


@dataclasses.dataclass(frozen=True)
class LifecycleConfig:
    arch: str = "stablelm-1.6b"
    steps: int = 5
    batch: int = 4
    seq: int = 16
    seed: int = 0
    microbatches: int = 1
    grad_compression: Optional[str] = None
    remat: bool = False
    remat_policy: str = "none"
    opt_state_dtype: str = "float32"
    overrides: Tuple[Tuple[str, object], ...] = ()   # ModelConfig kw
    opt: str = "adamw"
    packed: bool = False          # PackedDocs batches (segment ids, positions)
    reduced: bool = True          # ModelConfig.reduced(**overrides); False:
                                  # the published widths, replace(**overrides)

    def model_config(self):
        cfg = registry.get(self.arch)
        kw = dict(self.overrides)
        cfg = cfg.reduced(**kw) if self.reduced else cfg.replace(**kw)
        return cfg.replace(packed_inputs=True) if self.packed else cfg

    def train_config(self) -> S.TrainConfig:
        return S.TrainConfig(
            opt=O.OptConfig(name=self.opt, total_steps=self.steps,
                            state_dtype=self.opt_state_dtype),
            microbatches=self.microbatches, remat=self.remat,
            remat_policy=self.remat_policy,
            grad_compression=self.grad_compression, seed=self.seed)

    def data_config(self, host_index: int = 0, host_count: int = 1):
        return DataConfig(seed=self.seed, batch=self.batch, seq=self.seq,
                          vocab=self.model_config().vocab,
                          host_index=host_index, host_count=host_count)

    def source(self, device, host_index: int = 0, host_count: int = 1):
        dc = self.data_config(host_index, host_count)
        return (PackedDocs(dc, device=device) if self.packed
                else make_source(dc, device))


def _build(lc: LifecycleConfig):
    cfg, tcfg = lc.model_config(), lc.train_config()
    return cfg, tcfg, S.make_train_step(cfg, tcfg)


def _deterministic(fn):
    """Run ``fn`` under ``torch.use_deterministic_algorithms`` (restored
    after), as the train launcher runs its steps."""
    def run(*args, **kw):
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            return fn(*args, **kw)
        finally:
            torch.use_deterministic_algorithms(was)
    run.__name__, run.__doc__ = fn.__name__, fn.__doc__
    return run


# ----------------------------------------------------------------- scenarios
@_deterministic
def run_straight(lc: LifecycleConfig, device=None) -> DigestChain:
    """N uninterrupted steps; digests the full state per step."""
    device = resolve_device(device)
    cfg, tcfg, step_fn = _build(lc)
    state = S.init_state(cfg, tcfg, seed=lc.seed, device=device)
    data = lc.source(device)
    chain = DigestChain()
    for step in range(lc.steps):
        state, _ = step_fn(state, data.batch(step))
        chain.append(step + 1, state)
    return chain


@_deterministic
def run_with_crash_resume(lc: LifecycleConfig, ckpt_dir: str, crash_at: int,
                          device=None) -> DigestChain:
    """k steps → async save → crash (everything dropped) → restore → N−k."""
    device = resolve_device(device)
    cfg, tcfg, step_fn = _build(lc)
    state = S.init_state(cfg, tcfg, seed=lc.seed, device=device)
    data = lc.source(device)
    chain = DigestChain()
    for step in range(crash_at):
        state, _ = step_fn(state, data.batch(step))
        chain.append(step + 1, state)
    C.save(ckpt_dir, crash_at, state, async_=True).join()
    del state, step_fn, data                # ---- simulated hard crash ----

    cfg, tcfg, step_fn = _build(lc)         # fresh everything
    target = S.init_state(cfg, tcfg, seed=lc.seed, device=device)
    k = C.latest_step(ckpt_dir)
    if k != crash_at:
        raise AssertionError(f"latest checkpoint {k}, saved {crash_at}")
    state = C.restore(ckpt_dir, k, target)
    del target
    data = lc.source(device)                # stateless sampler: no replay
    for step in range(k, lc.steps):
        state, _ = step_fn(state, data.batch(step))
        chain.append(step + 1, state)
    return chain


def run_elastic_reshard(*args, **kw) -> DigestChain:
    raise NotImplementedError(
        "the elastic scenario (restore re-sharded onto another mesh) waits "
        "for dist/sharding.py (ROADMAP A9)")


def stream_chain(lc: LifecycleConfig, *, host_count: int = 1,
                 device="cpu") -> DigestChain:
    """Token-stream digest chain: one global-batch digest per step (host
    slices concatenated)."""
    chain = DigestChain()
    hosts = [lc.source(device, i, host_count) for i in range(host_count)]
    for step in range(lc.steps):
        slices = [h.batch(step) for h in hosts]
        glued = {k: torch.cat([s[k] for s in slices]) for k in slices[0]}
        chain.append_digest(step, batch_digest(glued))
    return chain


# ------------------------------------------------------------------- matrix
MATRIX: Dict[str, LifecycleConfig] = {
    "base":    LifecycleConfig(),
    "mb4":     LifecycleConfig(microbatches=4),
    "int8":    LifecycleConfig(grad_compression="int8"),
    "remat":   LifecycleConfig(remat=True, remat_policy="dots"),
    "gqa":     LifecycleConfig(overrides=(("n_kv_heads", 2),)),
    "bf16opt": LifecycleConfig(opt_state_dtype="bfloat16"),
}
# cells the reference's matrix lacks, run by the same drivers
EXTRA: Dict[str, LifecycleConfig] = {
    "adafactor": LifecycleConfig(opt="adafactor"),
    "packed":    LifecycleConfig(packed=True, seq=64),   # min_doc 16 <= seq/2
}
_UNPORTED = {
    "moe": "the moe cell waits for models/moe.py (ROADMAP A8)",
    "train_serve_parity": "the train_serve_parity cell waits for the "
                          "continuous engine (ROADMAP A5)",
}
SCENARIOS = ("straight", "resume")


def cell_config(name: str) -> LifecycleConfig:
    if name in _UNPORTED:
        raise NotImplementedError(_UNPORTED[name])
    if name in MATRIX:
        return MATRIX[name]
    if name in EXTRA:
        return EXTRA[name]
    raise KeyError(f"unknown lifecycle cell {name!r}; one of "
                   f"{sorted(MATRIX) + sorted(EXTRA)}")


def run_cell(name: str, *, crash_at: int = 2, scenarios=SCENARIOS,
             device=None, lc: Optional[LifecycleConfig] = None,
             tmp_root: Optional[str] = None) -> Dict:
    """Run one cell (``lc``, by default the named cell's config) through the
    scenarios; returns a report with chain records and a ``conformant``
    verdict. The resume scenario's checkpoint goes to a temporary directory
    under ``tmp_root`` (the system's default when None), removed after."""
    lc = lc or cell_config(name)
    if "elastic" in scenarios:
        run_elastic_reshard()               # raises: not ported
    unknown = set(scenarios) - set(SCENARIOS)
    if unknown:
        raise ValueError(f"unknown scenarios {sorted(unknown)}; "
                         f"{SCENARIOS} are ported")
    device = resolve_device(device)
    chains: Dict[str, DigestChain] = {}
    if "straight" in scenarios:
        chains["straight"] = run_straight(lc, device=device)
    if "resume" in scenarios:
        with tempfile.TemporaryDirectory(dir=tmp_root) as d:
            chains["resume"] = run_with_crash_resume(
                lc, os.path.join(d, "resume"), crash_at, device=device)
    heads = {k: c.head for k, c in chains.items()}
    ref = next(iter(chains.values()))
    divergences = {k: c.first_divergence(ref) for k, c in chains.items()}
    return {
        "cell": name,
        "config": dataclasses.asdict(lc),
        "heads": heads,
        "records": {k: c.records for k, c in chains.items()},
        "stream_head": stream_chain(lc).head,
        "conformant": len(set(heads.values())) == 1,
        "first_divergence": {k: v for k, v in divergences.items()
                             if v is not None},
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", default=",".join(MATRIX),
                    help="comma-separated cell names (MATRIX, EXTRA)")
    ap.add_argument("--scenarios", default=",".join(SCENARIOS))
    ap.add_argument("--crash-at", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--out", default=None,
                    help="write the conformance JSON here")
    args = ap.parse_args(argv)
    # cuBLAS reads this at its first handle: deterministic GEMMs on the card
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    scenarios = tuple(args.scenarios.split(","))
    reports = [run_cell(c, crash_at=args.crash_at, scenarios=scenarios,
                        device=args.device)
               for c in args.cells.split(",")]
    ok = all(r["conformant"] for r in reports)
    doc = {"device": str(resolve_device(args.device)), "conformant": ok,
           "cells": reports}
    if args.out:
        with open(args.out, "w") as f:
            f.write(json.dumps(doc, indent=2))
    for r in reports:
        status = "OK " if r["conformant"] else "FAIL"
        print(f"[{status}] {r['cell']}: " +
              " ".join(f"{k}={v[:12]}" for k, v in r["heads"].items()))
    print("conformant" if ok else "NON-CONFORMANT")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
