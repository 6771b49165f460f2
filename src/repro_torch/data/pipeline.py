"""Deterministic, stateless training data.

Port of ``repro.data.pipeline``'s synthetic source. ``batch(step)`` is a
pure function of (seed, step): a restart at step k reproduces the exact
token stream without replaying k steps. Each step draws one constant-size
**global** batch and a host takes its contiguous slice, so any host split
concatenates back to the same global batch (the reference's v2 contract).

The port's stream is its own: the reference keys ``jax.random`` threefry by
``fold_in(seed, step)``, the port seeds a CPU ``torch.Generator`` from a
sha256 of (seed, step). The token *values* therefore differ between the
packages; tests that compare the packages feed both the reference's batches.
Tokens are drawn on the CPU, whatever the device, so the stream does not
depend on it, then moved to ``device``. The memmap corpus (``path=``) is not
ported yet.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional

import torch

DATA_STREAM_VERSION = 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq: int = 128
    vocab: int = 32_000
    path: Optional[str] = None        # memmap corpus; None = synthetic
    host_index: int = 0
    host_count: int = 1


def step_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded from (seed, step) alone."""
    digest = hashlib.sha256(f"repro_torch.data|{seed}|{step}".encode()).digest()
    return torch.Generator().manual_seed(int.from_bytes(digest[:8], "little")
                                         >> 1)


class SyntheticLM:
    def __init__(self, cfg: DataConfig, device="cpu"):
        if cfg.batch % cfg.host_count:
            raise ValueError(f"batch {cfg.batch} does not split over "
                             f"{cfg.host_count} hosts")
        self.cfg = cfg
        self.device = torch.device(device)

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        c = self.cfg
        per_host = c.batch // c.host_count
        toks = torch.randint(0, c.vocab, (c.batch, c.seq + 1),
                             generator=step_generator(c.seed, step),
                             dtype=torch.int64)
        h0 = c.host_index * per_host
        toks = toks[h0:h0 + per_host].to(self.device)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def make_source(cfg: DataConfig, device="cpu"):
    if cfg.path:
        raise NotImplementedError(
            "the memmap corpus (DataConfig.path) is not ported yet (ROADMAP "
            "queue A, data); the synthetic source is")
    return SyntheticLM(cfg, device)
