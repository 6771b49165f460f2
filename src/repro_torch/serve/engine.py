"""Static-batch serving engine.

Counterpart of the static ``Engine`` of ``repro.serve.engine``: one padded
batch in, prefill (the causal DASH forward when ``attention_impl="cuda"``),
then lockstep one-token decode over the KV caches. The continuous engine
comes with its own slice (ROADMAP queue A).

Sampling semantics are the reference's: greedy is argmax over the raw
logits (lowest id on ties); sampled applies temperature then an exact-k
top-k. Seeded sampling draws from a ``torch.Generator`` seeded from
``SampleConfig.seed``, so its numbers are reproducible within the port but
not equal to ``jax.random``'s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """Pinned sampling semantics: ``temperature == 0`` is greedy; ``top_k``
    keeps exactly k tokens, ties at the k-th logit broken toward the lowest
    token id (see :func:`_transform_logits`)."""
    temperature: float = 0.0      # 0 = greedy
    top_k: int = 0                # 0 = no truncation
    seed: int = 0
    eos_id: Optional[int] = None


def _transform_logits(logits, scfg: SampleConfig):
    """Temperature/top-k transform over the last (vocab) axis.

    top-k keeps **exactly k** tokens: a stable descending sort puts equal
    logits in ascending id order, so the keep-set breaks ties toward the
    lowest token id (the reference's ``lax.top_k`` index set)."""
    logits = logits / scfg.temperature
    if scfg.top_k:
        idx = torch.sort(logits, dim=-1, descending=True, stable=True).indices
        keep = torch.zeros_like(logits, dtype=torch.bool)
        keep.scatter_(-1, idx[..., :scfg.top_k], True)
        logits = torch.where(keep, logits, torch.full_like(logits, -1e30))
    return logits


def _sample(logits, scfg: SampleConfig, gen: torch.Generator):
    """logits: (B, 1, V) → tokens (B, 1) int32. Deterministic given ``gen``."""
    logits = logits[:, 0].float()
    if scfg.temperature == 0.0:
        return torch.argmax(logits, -1)[:, None].to(torch.int32)
    probs = torch.softmax(_transform_logits(logits, scfg), dim=-1)
    return torch.multinomial(probs, 1, generator=gen).to(torch.int32)


class Engine:
    """Static-batch engine. One padded batch in, lockstep decode."""

    def __init__(self, cfg, params, max_seq: int,
                 scfg: SampleConfig = SampleConfig()):
        self.cfg, self.params, self.max_seq, self.scfg = cfg, params, max_seq, scfg
        self.last_decode_steps = 0        # poll-every-step reference count
        self.dispatched_decode_steps = 0  # decodes actually dispatched

    @torch.inference_mode()
    def generate(self, batch, n_tokens: int):
        """batch: dict with 'tokens' (B, S_prompt) on the params' device.
        Returns (B, n_tokens) int32, deterministic for a fixed seed.

        ``last_decode_steps`` afterwards is a pure function of the emitted
        stream — the decode count a poll-every-step loop would execute — so
        it is the same whether or not the all-EOS fast path fired;
        ``dispatched_decode_steps`` counts the decodes this call actually
        dispatched (≤ 7 more, up to the next poll boundary)."""
        tokens = batch["tokens"]
        prompt_len = tokens.shape[1]
        if prompt_len + n_tokens - 1 > self.max_seq:
            raise ValueError(f"{prompt_len} prompt + {n_tokens} new tokens "
                             f"exceed max_seq={self.max_seq}")
        logits, caches = T.prefill_step(self.params, batch, self.cfg,
                                        max_seq=self.max_seq)
        gen = torch.Generator(device=tokens.device).manual_seed(self.scfg.seed)
        tok = _sample(logits, self.scfg, gen)
        out = [tok]
        done = torch.zeros((tok.shape[0], 1), dtype=torch.bool,
                           device=tok.device)
        self.dispatched_decode_steps = 0
        for i in range(1, n_tokens):
            if self.scfg.eos_id is not None:
                done = done | (tok == self.scfg.eos_id)
                # the all-done probe waits for the device, so amortize it:
                # poll every 8 steps instead of at every dispatch
                if i % 8 == 0 and bool(done.all()):
                    # every row finished: the remaining tokens are forced to
                    # eos anyway — emit them host-side and skip the decodes
                    out.append(torch.full((tok.shape[0], n_tokens - i),
                                          self.scfg.eos_id, dtype=torch.int32,
                                          device=tok.device))
                    break
            logits, caches = T.decode_step(self.params, caches, tok,
                                           prompt_len + i - 1, self.cfg)
            self.dispatched_decode_steps += 1
            nxt = _sample(logits, self.scfg, gen)
            if self.scfg.eos_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, self.scfg.eos_id),
                                  nxt)
            out.append(nxt)
            tok = nxt
        gen_tokens = torch.cat(out, dim=1)
        # stream-pure accounting: the poll-every-step loop stops decoding at
        # the max over rows of the first-eos index (n_tokens-1 if a row never
        # emits eos) — recomputed from the stream, not from the dispatches
        if self.scfg.eos_id is None:
            self.last_decode_steps = n_tokens - 1
        else:
            g = gen_tokens.cpu().numpy()
            is_eos = g == self.scfg.eos_id
            first = np.where(is_eos.any(axis=1), is_eos.argmax(axis=1),
                             n_tokens - 1)
            self.last_decode_steps = int(first.max()) if first.size else 0
        return gen_tokens
