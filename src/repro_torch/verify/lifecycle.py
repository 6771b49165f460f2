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
remat policy ``dots``, GQA, mixture-of-experts (Phi-3.5-MoE: fp32 router,
capacity drops, the aux loss in the objective), bf16 optimizer state).
``EXTRA`` holds two cells the reference's matrix lacks: Adafactor, and
packed documents (:class:`~repro_torch.data.pipeline.PackedDocs`,
segment-masked attention on the plain path).

The ``train_serve_parity`` cell (:func:`run_train_serve_parity`) is not a
chain: per arch of ``PARITY_ARCHS`` it digests the canonical training
forward's logits and the continuous engine's captured prefill logits over the
same prompts; it is conformant iff the two digests are equal for every arch.

Not ported: the ``elastic`` scenario (re-sharding onto another mesh,
``dist/sharding.py``, ROADMAP A9) raises ``NotImplementedError``; so do
arches whose model families wait for ROADMAP A8 (``registry.get``). The
parity cell over an MoE, Mamba or xLSTM arch raises the paged engine's
refusal, as the reference's does.

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

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt import checkpoint as C
from repro_torch.configs import registry
from repro_torch.data.pipeline import DataConfig, PackedDocs, make_source
from repro_torch.train import optimizer as O
from repro_torch.train import step as S
from repro_torch.verify.digest import (DigestChain, batch_digest,
                                       combine_leaf_digests, leaf_digest)


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
    "moe":     LifecycleConfig(arch="phi3.5-moe-42b-a6.6b"),
    "bf16opt": LifecycleConfig(opt_state_dtype="bfloat16"),
}
# cells the reference's matrix lacks, run by the same drivers
EXTRA: Dict[str, LifecycleConfig] = {
    "adafactor": LifecycleConfig(opt="adafactor"),
    "packed":    LifecycleConfig(packed=True, seq=64),   # min_doc 16 <= seq/2
}
SCENARIOS = ("straight", "resume")

PARITY_ARCHS = ("stablelm-1.6b", "qwen1.5-110b", "mistral-nemo-12b")
PARITY_PROMPT_LENS = (5, 13, 32, 7)
_PARITY_PAGE = 8


def run_train_serve_parity(archs=PARITY_ARCHS, page_size: int = _PARITY_PAGE,
                           device=None, reduced: bool = True,
                           overrides: Tuple[Tuple[str, object], ...] = ()
                           ) -> Dict:
    """Train≡serve logits parity as a conformance cell (the reference's
    ``run_train_serve_parity``).

    For each arch (``reduced`` widths, or the published ones, with
    ``overrides``): the canonical training forward
    (``canonical_reductions=page_size``) over a fixed prompt set, and the
    paged ``ContinuousEngine`` with ``capture_prefill_logits`` over the same
    prompts (chunked prefill at the same page size). Each prompt's fp32
    logits are digested with :func:`repro_torch.verify.digest.leaf_digest`;
    the cell is conformant iff every arch's train and serve digests match.
    Weights come from ``T.init(seed=0)`` on ``device``."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ContinuousEngine

    device = resolve_device(device)
    heads: Dict[str, str] = {}
    records: Dict[str, Dict[str, Dict[str, str]]] = {}
    for arch in archs:
        cfg = registry.get(arch)
        kw = dict(overrides)
        cfg = cfg.reduced(**kw) if reduced else cfg.replace(**kw)
        params = T.init(cfg, seed=0, device=device)
        rng = np.random.RandomState(0)
        prompts = [rng.randint(1, cfg.vocab, size=n).tolist()
                   for n in PARITY_PROMPT_LENS]
        eng = ContinuousEngine(cfg, params, n_slots=2, max_seq=64,
                               page_size=page_size, prefill_chunk=16,
                               capture_prefill_logits=True)
        for i, p in enumerate(prompts):
            eng.submit(p, req_id=i, max_new_tokens=1)
        eng.run()
        pcfg = cfg.replace(canonical_reductions=page_size)
        train_d, serve_d = {}, {}
        for i, p in enumerate(prompts):
            toks = torch.tensor([p], dtype=torch.int64, device=device)
            logits = T.forward(params, {"tokens": toks}, pcfg)[0][0, :len(p)]
            train_d[f"req{i}"] = leaf_digest(logits.float())
            serve_d[f"req{i}"] = leaf_digest(
                eng.prefill_logits[i].astype(np.float32))
        heads[f"{arch}/train"] = combine_leaf_digests(train_d)
        heads[f"{arch}/serve"] = combine_leaf_digests(serve_d)
        records[arch] = {"train": train_d, "serve": serve_d}
        del params, eng
    conformant = all(heads[f"{a}/train"] == heads[f"{a}/serve"]
                     for a in archs)
    return {
        "cell": "train_serve_parity",
        "config": {"archs": list(archs), "page_size": page_size,
                   "prompt_lens": list(PARITY_PROMPT_LENS),
                   "reduced": reduced, "overrides": [list(o)
                                                     for o in overrides]},
        "heads": heads,
        "records": records,
        "conformant": conformant,
        "first_divergence": {} if conformant else {
            a: [r for r in records[a]["train"]
                if records[a]["train"][r] != records[a]["serve"][r]]
            for a in archs
            if heads[f"{a}/train"] != heads[f"{a}/serve"]},
    }


def cell_config(name: str) -> LifecycleConfig:
    if name == "train_serve_parity":
        raise ValueError("train_serve_parity is not a chain cell: run it with "
                         "run_train_serve_parity (or run_cell)")
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
    under ``tmp_root`` (the system's default when None), removed after.
    ``train_serve_parity`` runs :func:`run_train_serve_parity` instead."""
    if name == "train_serve_parity":
        return run_train_serve_parity(device=device)
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
                    help="comma-separated cell names (MATRIX, EXTRA, "
                         "train_serve_parity)")
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
