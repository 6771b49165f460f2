"""Verified speculative decoding for the continuous engine.

Port of ``repro.serve.spec``. Draft and verify with **exact acceptance**: a
drafter proposes ``k`` tokens per live slot, the target scores them, and a
draft is accepted iff it equals the token the plain engine would have
sampled there: the keyed sample of ``(seed, request_id, token_index)`` over
the target's logits, drawn by the plain path's own sampler
(:func:`repro_torch.serve.engine._sample_rows`). Acceptance is a comparison,
not a probabilistic correction, so the committed tokens and logprobs are
bitwise those of ``spec_k=0``, greedy and sampled alike.

The verify pass is the reference's sequence of ``(n_slots, 1)`` paged
steps, ``k + 1`` a round, each followed by the keyed sampler: the decode
shape the engine's bitwise contract is proven on. The round's positions,
write targets and page table go to the device in one host→device copy;
each step's sampled token tensor feeds the next step on the device, and the
host waits for the device once, at the round's end. A wide
``(n_slots, k + 1)`` verify and a CUDA graph of the round are left to
performance work (ROADMAP, queue B).

Self-draft (``draft_params is None``): drafter and target are one model,
so the self-feeding steps are draft and verify at once; acceptance is 1.0
and a round costs ``k + 1`` model steps for up to ``k + 1`` tokens. A
separate drafter runs its own self-feeding steps over its own KV pools (the
same page table, the same write targets), chunk-prefilled at admission and
after a restore; then the target verifies teacher-forced.

Cache discipline under rejection: a rejected round leaves stale K/V beyond
the accepted length, in the target's and the drafter's pools. No rollback
is needed: the next round starts at the first uncommitted position, and
every step writes its position's K/V before it attends
(``models/layers.py``: the pool write, then ``paged_attention``), in
ascending position, so each stale entry is overwritten before any query
reads it. The per-slot clamp ``k_s = min(k, max_new - produced - 1)`` keeps
every real write at or below ``prompt_len + max_new - 2``, inside the
admission's reservation; steps past ``k_s`` re-read position ``p0 + k_s``
and write to the trash page at distinct offsets.

Observation, as in the reference: a separate drafter's round emits a
``spec_draft`` and a ``spec_verify`` span (host time: their steps are
queued on the device, and the round waits for it once, at its end), and
every round a ``serve_spec_round`` event with its committed, accepted and
evaluated counts; the engine wraps the round in its ``spec_round`` span.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.serve.engine import _sample_rows, _to_device, paged


class Speculator:
    """Per-engine speculative state: the drafter, its KV pools, the round
    and the acceptance telemetry (``rounds``, ``drafted``, ``accepted``,
    ``truncated``: proposals never evaluated because the stream ended
    first, ``draft_steps``: drafter model steps).

    ``draft_params is None`` self-drafts (shared pools). A separate drafter
    must be paged-servable and share the target's vocabulary."""

    def __init__(self, eng, k: int, draft_cfg=None, draft_params=None):
        if k < 1:
            raise ValueError(f"spec_k must be >= 1, got {k}")
        self.k = int(k)
        self.self_draft = draft_params is None
        self.dcfg = eng.cfg if self.self_draft else (draft_cfg or eng.cfg)
        self.dparams = eng.params if self.self_draft else draft_params
        self.pools = None           # self-draft: the target's pools
        if not self.self_draft:
            if not T.supports_paged(self.dcfg):
                raise ValueError("drafter must be a paged-servable "
                                 "(decoder-only, attention-only) config")
            if self.dcfg.vocab != eng.cfg.vocab:
                raise ValueError(
                    f"drafter vocab {self.dcfg.vocab} != target vocab "
                    f"{eng.cfg.vocab}: speculative acceptance compares token "
                    "ids, so drafter and target must share a vocabulary")
            lay = eng.cache.layout
            self.pools = T.init_paged_cache(self.dcfg, lay.n_pages + 1,
                                            lay.page_size, eng.device)
        self.rounds = 0
        self.drafted = 0
        self.accepted = 0
        self.truncated = 0
        self.draft_steps = 0

    def acceptance_rate(self) -> float:
        """Accepted / evaluated proposals (1.0 for self-draft)."""
        evaluated = self.drafted - self.truncated
        return self.accepted / evaluated if evaluated else 1.0

    def prefill(self, eng, slot: int, tokens: np.ndarray) -> None:
        """Chunk-prefill the drafter's K/V for ``tokens`` into ``slot``'s
        pages with the engine's chunks and write targets (a separate
        drafter only), so its state after a recompute-restore is the one it
        would have had."""
        if self.self_draft:
            return
        for chunk in eng.chunks(slot, tokens):
            paged(self.dparams, self.pools, self.dcfg, eng.device, *chunk)
            self.draft_steps += 1

    def round(self, eng, live: List[int]) -> None:
        """One speculative round over the live slots: draft k, verify k+1,
        commit the accepted prefix and one corrected or bonus token."""
        lay = eng.cache.layout
        n, k = lay.n_slots, self.k
        S = k + 1
        tok0 = np.zeros((n, 1), np.int32)
        pos = np.zeros((S, n), np.int32)
        wp = np.full((S, n), lay.trash_page, np.int32)
        wo = np.tile(np.arange(n, dtype=np.int32) % lay.page_size, (S, 1))
        rids = np.zeros(n, np.int64)
        steps0 = np.zeros(n, np.int64)
        k_s: Dict[int, int] = {}
        for s in live:
            st = eng._slots[s]
            m = len(st.produced)
            ks = min(k, st.req.max_new_tokens - m - 1)      # per-slot clamp
            k_s[s] = ks
            p0 = st.next_pos
            lay.check_spec_write(len(st.req.tokens), st.req.max_new_tokens,
                                 p0 + ks)
            tok0[s, 0] = st.produced[-1]
            # pad steps (l > ks) re-read position p0 + ks and write to the
            # trash page: outputs the commit loop never reads
            pos[:, s] = p0 + np.minimum(np.arange(S), ks)
            real = np.arange(ks + 1)
            pages, offs = eng.cache.write_targets(
                s, p0 + real, np.ones(ks + 1, bool))
            wp[real, s], wo[real, s] = pages, offs
            rids[s] = st.req.id
            steps0[s] = m
        dev = _to_device(eng.device, tok0, pos, eng.cache.page_table, wp, wo)
        tok0_d = dev[0]
        if self.self_draft:
            toks, lps = self._steps(eng, eng.params, eng.cache.pools, eng.cfg,
                                    [tok0_d], dev, rids, steps0)
            drafts = toks[:, :k]
        else:
            with eng.prof.span("spec_draft", scope=f"step:{eng.engine_steps}",
                               lane="engine", k=k):
                dtoks, _ = self._steps(eng, self.dparams, self.pools,
                                       self.dcfg, [tok0_d], dev, rids, steps0)
            self.draft_steps += S
            feed = [tok0_d] + [dtoks[:, l:l + 1] for l in range(k)]
            with eng.prof.span("spec_verify", scope=f"step:{eng.engine_steps}",
                               lane="engine", k=k):
                toks, lps = self._steps(eng, eng.params, eng.cache.pools,
                                        eng.cfg, feed, dev, rids, steps0)
            drafts = dtoks[:, :k]
        toks, lps, drafts = (t.cpu().numpy() for t in (toks, lps, drafts))
        eng.decode_steps += 1           # one verify dispatch a round

        # exact acceptance: commit while the draft is the plain-path sample
        committed = matched = evaluated = 0
        for s in live:
            st = eng._slots[s]
            ks = k_s[s]
            for l in range(ks + 1):
                st.produced.append(int(toks[s, l]))
                st.logprobs.append(float(lps[s, l]))
                committed += 1
                eng._finish_check(st)
                if st.done:
                    break
                if l < ks:
                    evaluated += 1
                    if int(drafts[s, l]) != int(toks[s, l]):
                        break
                    matched += 1
            self.drafted += ks
        self.rounds += 1
        self.accepted += matched
        self.truncated += sum(k_s.values()) - evaluated
        eng.tracker.log("serve_spec_round", {
            "live_slots": len(live), "k": k, "committed": committed,
            "accepted": matched, "evaluated": evaluated},
            step=eng.engine_steps)

    def _steps(self, eng, params, pools, cfg, feed, dev, rids, steps0):
        """``k + 1`` paged ``(n_slots, 1)`` steps, each sampled with the
        engine's keyed sampler at token index ``steps0 + l``. ``feed`` holds
        the first step's input only (self-feeding: step ``l`` takes step
        ``l - 1``'s sample) or every step's (teacher-forced). Returns
        (tokens, logprobs), ``(n_slots, k + 1)`` on the device."""
        _, pos, table, wp, wo = dev
        cur, toks, lps = feed[0], [], []
        for l in range(self.k + 1):
            if len(feed) > 1:
                cur = feed[l]
            logits, _ = T.paged_step(params, pools, cur, pos[l][:, None],
                                     table, wp[l], wo[l], cfg)
            cur, lp = _sample_rows(logits[:, 0], rids, steps0 + l, eng.scfg)
            toks.append(cur)
            lps.append(lp)
            cur = cur[:, None]
        return torch.stack(toks, 1), torch.stack(lps, 1)
