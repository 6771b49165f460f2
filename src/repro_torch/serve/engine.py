"""Serving engines: the static-batch baseline and batch-invariant continuous
batching.

Counterpart of ``repro.serve.engine``. ``Engine`` takes one padded batch,
prefills it (the causal DASH forward when ``attention_impl="cuda"``) and
decodes in lockstep over the KV caches. ``ContinuousEngine`` is the
deterministic serving engine:

  * **paged KV** (:mod:`repro_torch.serve.kv_cache`): per-request page tables
    over a fixed pool; physical placement never reaches the math;
  * **deterministic scheduling** (:mod:`repro_torch.serve.scheduler`): FCFS
    by request id, lowest free slot and pages first;
  * **chunked prefill**: each prompt alone, in fixed-size ``(1, chunk)``
    steps;
  * **in-flight batched decode**: one token per live slot a step over a
    fixed ``(n_slots, 1)`` shape; idle rows carry garbage never read;
  * **per-request sampling keys**: a sampled row draws from a generator
    seeded by a fixed integer mix of ``(seed, request_id, token_index)``
    (:func:`_row_seed`), never from a generator the batch shares.

Contract (the reference's): for fixed (params, prompt, seed, sampling
config), a request's tokens and logprobs are bitwise the same whatever it is
co-batched with, the slot count, the arrival order, the prefill chunk and
page placement. It rests on ``transformer.paged_step``: every reduction on
the serve path is row-invariant (the paged attention, the M-invariant GEMM,
the row norm; the sampler's row log-softmax), on the card and on the CPU.

Sampling semantics are the reference's: greedy is argmax over the raw
logits (lowest id on ties) and reports ``log_softmax(raw)[tok]``; sampled
applies temperature then an exact-k top-k and reports
``log_softmax(transformed)[tok]``. Seeded numbers come from
``torch.Generator``, so they are reproducible within the port but not equal
to ``jax.random``'s.

The contract survives faults (the reference's robustness layer): with
``faults=`` an armed :class:`repro_torch.faults.Injector`, the engine
absorbs KV-pool exhaustion, slot revocation and decode stalls by
deterministic preemption (the victim is the active request with the highest
id; its pages are freed and it is later restored by a chunked-prefill
*recompute* of its generated prefix, its sampled tokens kept, never drawn
again); ``max_queue_depth`` sheds by (request id, queue state);
``deadline_steps`` cancels in engine steps, never wall time; and
``snapshot_dir``/``snapshot_every`` persist the whole engine state
(:mod:`repro_torch.serve.snapshot`) so that a crashed engine resumes every
stream bitwise. ``spec_k >= 1`` drafts and verifies with exact acceptance
(:mod:`repro_torch.serve.spec`): tokens and logprobs stay bitwise those of
``spec_k=0``.

Observation (the reference's ``tracker=`` and ``run_id=``): every
``serve_*`` event and every ``request``/``queue``/``prefill``/
``prefill_chunk``/``decode``/``spec_round`` span the reference emits, with
the same ids and payloads (:mod:`repro_torch.obs.prof`). The tracker only
sees host integers the step has already computed: it adds no device sync,
and swapping it for a ``NoopTracker`` changes no token or logprob.

Not ported, and raising with its ROADMAP item: mesh-sharded serving (A9).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import rows
from repro_torch.models import transformer as T
from repro_torch.obs.prof import Profiler
from repro_torch.obs.tracker import NoopTracker
from repro_torch.serve.kv_cache import PagedKVCache, PagedLayout
from repro_torch.serve.scheduler import FCFSScheduler, Request


class QueueFull(RuntimeError):
    """Deterministic load shedding: the bounded queue rejected a request
    (a pure function of request id and queue state). Carries
    ``(req_id, depth)``; the engine records it in ``rejected``."""

    def __init__(self, req_id: int, depth: int):
        self.req_id, self.depth = req_id, depth
        super().__init__(
            f"request {req_id} shed: queue depth is at the "
            f"max_queue_depth={depth} bound")


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


# --------------------------------------------------------------------------- #
# continuous batching
# --------------------------------------------------------------------------- #
_MASK64 = (1 << 64) - 1


def _row_seed(seed: int, request_id: int, token_index: int) -> int:
    """The seed of one sampled row: a fixed integer mix (splitmix64's
    finaliser) of ``(seed, request_id, token_index)``, below 2**63."""
    x = (seed * 0x9E3779B97F4A7C15 + request_id * 0xBF58476D1CE4E5B9
         + token_index * 0x94D049BB133111EB + 0x632BE59BD9B4E019) & _MASK64
    x ^= x >> 30
    x = (x * 0xBF58476D1CE4E5B9) & _MASK64
    x ^= x >> 27
    x = (x * 0x94D049BB133111EB) & _MASK64
    x ^= x >> 31
    return x & ((1 << 63) - 1)


def _sample_rows(logits, req_ids, steps, scfg: SampleConfig):
    """The continuous engine's keyed row sampler: ``(B, V)`` logits →
    (tokens (B,) int64, logprobs (B,) fp32), each row a function of its own
    logits and ``(seed, request_id, token_index)``.

    Greedy: the argmax of the raw logits (lowest id on ties) and
    ``log_softmax(raw)[tok]``, both from the row log-softmax
    (``kernels/rows.py``). Sampled: the transformed logits (temperature, then
    exact-k top-k) plus Gumbel noise drawn per row from
    ``torch.Generator(device).manual_seed(_row_seed(...))``, argmax'd; the
    logprob is ``log_softmax(transformed)[tok]``."""
    logits = logits.to(torch.float32).contiguous()
    if scfg.temperature == 0.0:
        lp_all, tok = rows.log_softmax_argmax(logits)
    else:
        tl = _transform_logits(logits, scfg).contiguous()
        lp_all, _ = rows.log_softmax_argmax(tl)
        noise = []
        for rid, t in zip(req_ids, steps):
            gen = torch.Generator(device=logits.device).manual_seed(
                _row_seed(scfg.seed, int(rid), int(t)))
            noise.append(torch.rand(logits.shape[-1], generator=gen,
                                    device=logits.device))
        gumbel = -torch.log(-torch.log(torch.stack(noise)))
        tok = torch.argmax(tl + gumbel, dim=-1)
    lp = torch.gather(lp_all, 1, tok[:, None])[:, 0]
    return tok, lp


@dataclasses.dataclass
class _Active:
    """Host-side per-slot decode state."""
    req: Request
    produced: List[int]
    logprobs: List[float] = dataclasses.field(default_factory=list)
    done: bool = False

    @property
    def next_pos(self) -> int:
        # position of the last sampled (not yet KV-written) token
        return len(self.req.tokens) + len(self.produced) - 1


_UNPORTED = {
    "mesh": "mesh-sharded serving (serve/sharded.py) waits for ROADMAP A9",
}


def _to_device(device, *arrays):
    """The int32 numpy ``arrays`` on ``device`` in one host→device copy, as
    contiguous views of one buffer."""
    flat = np.concatenate([np.asarray(a, np.int32).reshape(-1)
                           for a in arrays])
    buf = torch.from_numpy(flat).to(device)
    out, at = [], 0
    for a in arrays:
        n = int(np.prod(np.shape(a)))
        out.append(buf[at:at + n].view(np.shape(a)))
        at += n
    return out


def paged(params, pools, cfg, device, toks, pos, table, wp, wo):
    """One ``transformer.paged_step`` over host int arrays (copied to
    ``device`` in one transfer); the pools are updated in place. Returns
    the logits."""
    toks, pos, table, wp, wo = _to_device(device, toks, pos, table, wp, wo)
    return T.paged_step(params, pools, toks, pos, table, wp, wo, cfg)[0]


class ContinuousEngine:
    """Continuous-batching deterministic engine over paged KV slots.

    The pools live on the params' device. ``capture_prefill_logits`` keeps
    each request's per-position prefill logits in ``prefill_logits[req_id]``
    (the train≡serve parity cell); ``max_queue_depth`` bounds pending
    requests (``submit`` beyond it raises :class:`QueueFull`).

    Robustness knobs (all off by default, and the default path is the same
    with or without them): ``faults``, an armed
    :class:`repro_torch.faults.Injector` whose plan the engine consumes at
    each engine step; ``snapshot_dir`` + ``snapshot_every``, a full engine
    snapshot every N engine steps (:meth:`from_snapshot` resumes after a
    crash). ``spec_k >= 1`` runs speculative rounds
    (:class:`repro_torch.serve.spec.Speculator`); ``draft_params`` (with an
    optional ``draft_cfg`` of the same vocabulary) selects a separate
    drafter, else the target drafts for itself. ``tracker`` (any object
    with ``log``) receives the reference's events and spans, with span ids
    from ``run_id`` (default ``"serve"``).

    Besides the reference's telemetry (``decode_steps``, ``engine_steps``,
    ``preemptions``), the engine keeps host records that end in a device
    sync anyway: ``run_s`` (the last :meth:`run`), ``decode_s`` (each decode
    step or speculative round, sampler included), ``snapshot_s`` (each
    snapshot save), ``restore_positions`` (the positions each
    recompute-restore ran through the prefill) and, per request,
    ``first_token_step`` and ``ttft_s`` (submit → first token on the host)."""

    def __init__(self, cfg, params, *, n_slots: int = 4, max_seq: int = 128,
                 page_size: int = 16, n_pages: Optional[int] = None,
                 prefill_chunk: int = 32, scfg: SampleConfig = SampleConfig(),
                 tracker=None, mesh=None, capture_prefill_logits: bool = False,
                 faults=None, max_queue_depth: Optional[int] = None,
                 snapshot_dir: Optional[str] = None,
                 snapshot_every: Optional[int] = None,
                 spec_k: int = 0, draft_cfg=None, draft_params=None,
                 run_id: Optional[str] = None):
        if mesh is not None:
            raise NotImplementedError(f"ContinuousEngine(mesh=...): "
                                      f"{_UNPORTED['mesh']}")
        if not T.supports_paged(cfg):
            raise NotImplementedError(T.paged_refusal(cfg))
        if max_seq % page_size or prefill_chunk < 1:
            raise ValueError(f"max_seq={max_seq} must be a multiple of "
                             f"page_size={page_size}, prefill_chunk >= 1")
        self.cfg, self.params, self.scfg = cfg, params, scfg
        # observation only: every tracker call logs host values the step
        # already holds, so the tracker can never change a token
        self.tracker = tracker if tracker is not None else NoopTracker()
        # deterministic-identity spans over the same tracker; against a
        # NoopTracker every profiler call returns before reading a clock
        self.prof = Profiler(self.tracker, run_id=run_id or "serve")
        self._req_spans: Dict[int, object] = {}     # req_id -> request span
        self._queue_spans: Dict[int, object] = {}   # req_id -> queue span
        self._submit_step: Dict[int, int] = {}      # req_id -> submit step
        self.device = params["embed"]["tok"].device
        self.prefill_chunk = prefill_chunk
        self.max_seq = max_seq
        mpps = max_seq // page_size
        layout = PagedLayout(page_size=page_size,
                             n_pages=n_pages or n_slots * mpps,
                             n_slots=n_slots, max_pages_per_slot=mpps)
        self.cache = PagedKVCache(cfg, layout, self.device)
        self.sched = FCFSScheduler(n_slots)
        self._slots: Dict[int, _Active] = {}
        self.results: Dict[int, List[int]] = {}
        self.result_logprobs: Dict[int, np.ndarray] = {}
        self.prefill_logits: Dict[int, np.ndarray] = {}
        self._capture = capture_prefill_logits
        self._next_id = 0
        self.decode_steps = 0
        # ----- robustness state (inert until a knob or a fault uses it)
        self.faults = faults
        self.max_queue_depth = max_queue_depth
        self.snapshot_dir, self.snapshot_every = snapshot_dir, snapshot_every
        self.engine_steps = 0               # the deterministic clock
        self.preemptions = 0
        self.rejected: Dict[int, str] = {}          # req_id -> shed reason
        self.cancelled: Dict[int, np.ndarray] = {}  # req_id -> partial tokens
        self._deadline: Dict[int, int] = {}         # req_id -> absolute step
        # req_id -> (produced, logprobs) of a preempted request awaiting its
        # recompute-restore
        self._resume: Dict[int, Tuple[List[int], List[float]]] = {}
        self._stall_until = 0               # no decode before this step
        self._quarantine: List[Tuple[int, List[int]]] = []  # (release, pages)
        # host-clock records (each ends in the step's device sync)
        self.run_s: Optional[float] = None
        self.decode_s: List[float] = []
        self.snapshot_s: List[float] = []
        self.restore_positions: List[int] = []
        self.first_token_step: Dict[int, int] = {}
        self.ttft_s: Dict[int, float] = {}
        self._submit_t: Dict[int, float] = {}

        self.spec = None
        if spec_k:
            from repro_torch.serve.spec import Speculator
            self.spec = Speculator(self, spec_k, draft_cfg=draft_cfg,
                                   draft_params=draft_params)
        elif draft_params is not None or draft_cfg is not None:
            raise ValueError("draft_cfg/draft_params require spec_k >= 1")

    # ------------------------------------------------------------ request API
    def submit(self, tokens, *, req_id: Optional[int] = None,
               max_new_tokens: int = 16,
               deadline_steps: Optional[int] = None) -> int:
        """Queue a request; lower ids are served first (FCFS by id).

        Validates the whole worst case up front (positions against
        ``max_seq``, pages against the pool) with a ``ValueError`` naming the
        limit. ``deadline_steps``: cancel the request if it has not finished
        within that many engine steps from now (a deterministic deadline)."""
        if req_id is None:
            req_id = self._next_id
        tokens = tuple(int(t) for t in np.asarray(tokens).reshape(-1))
        if (req_id in self.results or req_id in self.cancelled
                or req_id in self.rejected or any(
                    st.req.id == req_id for st in self._slots.values())):
            raise ValueError(f"request id {req_id} was already served")
        total = len(tokens) + max_new_tokens
        if total > self.max_seq:
            raise ValueError(
                f"request {req_id} needs {total} positions "
                f"({len(tokens)} prompt + {max_new_tokens} new); "
                f"slot capacity is max_seq={self.max_seq}")
        need = self.cache.layout.pages_for(total)
        if need > self.cache.layout.n_pages:
            raise ValueError(
                f"request {req_id} needs {need} pages (worst case) but the "
                f"pool only has n_pages={self.cache.layout.n_pages}; raise "
                f"n_pages or shrink the request")
        if deadline_steps is not None and deadline_steps <= 0:
            raise ValueError(f"deadline_steps must be > 0, got "
                             f"{deadline_steps}")
        if (self.max_queue_depth is not None
                and len(self.sched.pending) >= self.max_queue_depth):
            self.rejected[req_id] = "queue_full"
            self._next_id = max(self._next_id, req_id + 1)
            shed = {"request_id": req_id,
                    "queue_depth": self.max_queue_depth}
            if self.prof.armed:
                shed["at_s"] = round(self.prof.now(), 9)
            self.tracker.log("serve_shed", shed)
            raise QueueFull(req_id, self.max_queue_depth)
        self.sched.submit(Request(req_id, tokens, max_new_tokens))
        if deadline_steps is not None:
            self._deadline[req_id] = self.engine_steps + deadline_steps
        self._next_id = max(self._next_id, req_id + 1)
        self._submit_t[req_id] = time.perf_counter()
        # spans open only past validation: a shed or invalid request gets
        # none (its serve_shed mark is the record)
        rs = self.prof.begin("request", scope=f"req:{req_id}",
                             lane=f"req{req_id}", prompt_len=len(tokens))
        if rs is not None:
            self._req_spans[req_id] = rs
            self._queue_spans[req_id] = self.prof.begin(
                "queue", scope=f"req:{req_id}", parent=rs, lane=f"req{req_id}")
            self._submit_step[req_id] = self.engine_steps
        self.tracker.log("serve_submit", {
            "request_id": req_id, "prompt_len": len(tokens),
            "max_new_tokens": max_new_tokens})
        return req_id

    def run(self) -> Dict[int, np.ndarray]:
        """Drive steps until every submitted request finished; return the
        completed requests' tokens (shed ones are in ``rejected``,
        deadline-cancelled ones in ``cancelled``). Pages an injected
        exhaustion still holds are released when the stream drains, so a
        drained engine has its whole pool back."""
        t0 = time.perf_counter()
        while not self.sched.idle:
            self.step()
        self._release_quarantine(self.engine_steps, force=True)
        self.run_s = time.perf_counter() - t0
        return {rid: np.asarray(toks, np.int32)
                for rid, toks in self.results.items()}

    # ---------------------------------------------------------------- engine
    def _admission_check(self):
        """Capacity predicate for one admission round; counts the pages that
        earlier admissions of the same round claimed."""
        reserved = 0

        def fits(req: Request) -> bool:
            nonlocal reserved
            need = self.cache.layout.pages_for(
                len(req.tokens) + req.max_new_tokens)
            if need + reserved > self.cache.free_pages:
                return False
            reserved += need
            return True

        return fits

    def _step(self, toks, pos, table, wp, wo):
        return paged(self.params, self.cache.pools, self.cfg, self.device,
                     toks, pos, table, wp, wo)

    def chunks(self, slot: int, tokens: np.ndarray):
        """The fixed-size ``(1, chunk)`` steps that write ``tokens``' K/V
        into ``slot``'s pages: per chunk (tokens, positions, page table,
        write pages, write offsets) as host arrays. Fresh prefill, the
        recompute-restore and a separate drafter's prefill all run these."""
        plen, c = len(tokens), self.prefill_chunk
        table = self.cache.page_table[[slot]]
        for start in range(0, plen, c):
            pos = np.arange(start, start + c, dtype=np.int32)
            valid = pos < plen
            toks = np.where(valid, tokens[np.minimum(pos, plen - 1)], 0)
            wp, wo = self.cache.write_targets(slot, pos, valid)
            yield toks[None], pos[None], table, wp, wo

    def _chunked_prefill(self, slot: int, tokens: np.ndarray,
                         rows_out: Optional[list] = None,
                         scope: Optional[str] = None):
        """Run ``tokens`` through the paged step chunk by chunk; returns the
        last chunk's logits. ``scope`` (e.g. ``"req:3"``) keys a
        ``prefill_chunk`` span a chunk."""
        plen, c = len(tokens), self.prefill_chunk
        logits = None
        for i, chunk in enumerate(self.chunks(slot, tokens)):
            span = (self.prof.begin("prefill_chunk",
                                    scope=f"{scope}/pos:{i * c}",
                                    lane=f"slot{slot}")
                    if scope is not None else None)
            logits = self._step(*chunk)
            if rows_out is not None:    # valid rows only, fp32 (bitwise)
                rows_out.append(logits[0, :min(c, plen - i * c)].cpu()
                                .numpy())
            self.prof.end(span, n_valid=min(c, plen - i * c))
        return logits

    def _prefill(self, slot: int, req: Request) -> None:
        """Chunked prefill of one request; samples its first token.

        For a preempted request (``_resume`` holds its generated prefix)
        this is the restore: recompute K/V over ``prompt + produced[:-1]``,
        every position the decode loop had written, and keep the tokens
        and logprobs as they were. Nothing is sampled again, so the
        continuation is bitwise that of a request never preempted."""
        lay = self.cache.layout
        self.cache.alloc(slot, lay.pages_for(len(req.tokens)
                                             + req.max_new_tokens))
        plen, c = len(req.tokens), self.prefill_chunk
        self.prof.end(self._queue_spans.pop(req.id, None), slot=slot,
                      queued_steps=self.engine_steps - self._submit_step.get(
                          req.id, self.engine_steps))
        rspan = self._req_spans.get(req.id)
        resume = self._resume.pop(req.id, None)
        if resume is not None:
            produced, lps = resume
            prefix = np.asarray(list(req.tokens) + list(produced[:-1]),
                                np.int32)
            ps = self.prof.begin("prefill", scope=f"req:{req.id}/restore",
                                 parent=rspan, lane=f"slot{slot}",
                                 step=self.engine_steps)
            self._chunked_prefill(slot, prefix, scope=f"req:{req.id}/restore")
            if self.spec is not None:
                self.spec.prefill(self, slot, prefix)
            self.restore_positions.append(len(prefix))
            self._slots[slot] = st = _Active(req, list(produced), list(lps))
            self.prof.end(ps, prompt_len=len(prefix), restored=True,
                          tokens_kept=len(produced))
            self.tracker.log("serve_restore", {
                "request_id": req.id, "slot": slot,
                "recomputed_positions": len(prefix),
                "tokens_kept": len(produced)})
            self._finish_check(st)
            return
        ps = self.prof.begin("prefill", scope=f"req:{req.id}", parent=rspan,
                             lane=f"slot{slot}", step=self.engine_steps)
        rows_out = [] if self._capture else None
        prompt = np.asarray(req.tokens, np.int32)
        logits = self._chunked_prefill(slot, prompt, rows_out,
                                       scope=f"req:{req.id}")
        if self.spec is not None:
            self.spec.prefill(self, slot, prompt)
        if self._capture:
            self.prefill_logits[req.id] = np.concatenate(rows_out, axis=0)
        tok, lp = _sample_rows(logits[:, (plen - 1) % c], [req.id], [0],
                               self.scfg)
        first, first_lp = int(tok[0]), float(lp[0])
        self.first_token_step[req.id] = self.engine_steps
        self.ttft_s[req.id] = time.perf_counter() - self._submit_t.get(
            req.id, time.perf_counter())
        self._slots[slot] = st = _Active(req, [first], [first_lp])
        if ps is not None:    # TTFT: submit (request-span begin) → first token
            ttft = (self.prof.now() - rspan.begin_s if rspan is not None
                    else None)
            self.prof.end(ps, prompt_len=plen, chunks=-(-plen // c),
                          **({"ttft_s": round(ttft, 9)}
                             if ttft is not None else {}))
        self.tracker.log("serve_prefill", {
            "request_id": req.id, "slot": slot, "prompt_len": plen,
            "chunks": -(-plen // c)})
        self._finish_check(st)

    def _finish_check(self, st: _Active) -> None:
        last = st.produced[-1]
        if ((self.scfg.eos_id is not None and last == self.scfg.eos_id)
                or len(st.produced) >= st.req.max_new_tokens):
            st.done = True

    # ------------------------------------------------------ fault machinery
    def _victim(self) -> Optional[int]:
        """The preemption victim: the active slot holding the highest
        request id (the youngest stream loses), or None."""
        if not self._slots:
            return None
        return max(self._slots, key=lambda s: self._slots[s].req.id)

    def _preempt(self, slot: int, reason: str) -> None:
        """Evict one active request: free its pages now, keep its generated
        prefix, and queue it again for recompute-restore (``_prefill``)."""
        st = self._slots.pop(slot)
        self._resume[st.req.id] = (list(st.produced), list(st.logprobs))
        self.cache.free_slot(slot)
        self.sched.release(slot)
        self.sched.submit(st.req)       # back in FCFS at its original id
        self.preemptions += 1
        data = {"request_id": st.req.id, "slot": slot, "reason": reason,
                "tokens_kept": len(st.produced)}
        if self.prof.armed:             # timeline instant + a fresh queue
            data["at_s"] = round(self.prof.now(), 9)   # span for the re-wait
            self._submit_step[st.req.id] = self.engine_steps
            self._queue_spans[st.req.id] = self.prof.begin(
                "queue", scope=f"req:{st.req.id}/preempt{self.preemptions}",
                parent=self._req_spans.get(st.req.id),
                lane=f"req{st.req.id}")
        self.tracker.log("serve_preempt", data, step=self.engine_steps)

    def _apply_faults(self, step_idx: int) -> None:
        """Consume this step's scheduled faults. May raise ``EngineCrash``."""
        from repro_torch.faults import EngineCrash
        for f in self.faults.step_faults(step_idx):
            if f.kind == "crash":
                if self.faults.consume_crash(f):
                    self.faults.record(f, engine_step=step_idx)
                    raise EngineCrash(step_idx)
            elif f.kind == "decode_stall":
                self._stall_until = max(self._stall_until, step_idx + f.arg)
                self.faults.record(f, engine_step=step_idx,
                                   stalled_until=self._stall_until)
            elif f.kind == "revoke_slot":
                revoked = []
                for _ in range(max(1, f.arg)):
                    victim = self._victim()
                    if victim is None:
                        break
                    revoked.append(self._slots[victim].req.id)
                    self._preempt(victim, reason="slot_revoked")
                self.faults.record(f, engine_step=step_idx, victims=revoked)
            elif f.kind == "pool_exhaust":
                want = min(f.arg, self.cache.layout.n_pages)
                evicted = []
                while self.cache.free_pages < want:
                    victim = self._victim()
                    if victim is None:
                        break
                    evicted.append(self._slots[victim].req.id)
                    self._preempt(victim, reason="pool_exhausted")
                pages = self.cache.quarantine(min(want,
                                                  self.cache.free_pages))
                if pages:
                    self._quarantine.append((step_idx + f.duration, pages))
                self.faults.record(f, engine_step=step_idx, pages=len(pages),
                                   victims=evicted)

    def _release_quarantine(self, step_idx: int, force: bool = False) -> None:
        keep = []
        for release, pages in self._quarantine:
            if force or release <= step_idx:
                self.cache.release_quarantine(pages)
            else:
                keep.append((release, pages))
        self._quarantine = keep

    def _cancel_expired(self, step_idx: int) -> None:
        """Cancel every request whose step deadline has passed: pending ones
        leave the queue, active ones free their slot and pages now; the
        tokens produced so far (a preempted request's too) go to
        ``cancelled``, never ``results``."""
        if not self._deadline:
            return
        for rid in sorted(self.sched.pending):
            if self._deadline.get(rid, step_idx + 1) <= step_idx:
                del self.sched.pending[rid]
                produced, _ = self._resume.pop(rid, ([], []))
                self.cancelled[rid] = np.asarray(produced, np.int32)
                del self._deadline[rid]
                self.prof.end(self._queue_spans.pop(rid, None),
                              cancelled=True)
                self.prof.end(self._req_spans.pop(rid, None),
                              cancelled=True, n_tokens=len(produced))
                self.tracker.log("serve_cancel", {
                    "request_id": rid, "where": "pending",
                    "tokens_kept": len(produced)}, step=step_idx)
        for slot in sorted(self._slots):
            rid = self._slots[slot].req.id
            if self._deadline.get(rid, step_idx + 1) <= step_idx:
                st = self._slots.pop(slot)
                self.cancelled[rid] = np.asarray(st.produced, np.int32)
                self.cache.free_slot(slot)
                self.sched.release(slot)
                del self._deadline[rid]
                self.prof.end(self._req_spans.pop(rid, None),
                              cancelled=True, n_tokens=len(st.produced))
                self.tracker.log("serve_cancel", {
                    "request_id": rid, "where": "active",
                    "tokens_kept": len(st.produced)}, step=step_idx)

    def _decode(self, live: List[int]) -> None:
        """One batched ``(n_slots, 1)`` decode step over the live slots."""
        lay = self.cache.layout
        n = lay.n_slots
        toks = np.zeros((n, 1), np.int32)
        pos = np.zeros((n, 1), np.int32)
        wp = np.full(n, lay.trash_page, np.int32)
        wo = np.arange(n, dtype=np.int32) % lay.page_size
        rids = np.zeros(n, np.int64)
        steps = np.zeros(n, np.int64)
        for s in live:
            st = self._slots[s]
            toks[s, 0] = st.produced[-1]
            pos[s, 0] = st.next_pos
            wp[s], wo[s] = (a[0] for a in self.cache.write_targets(
                s, np.asarray([st.next_pos]), np.asarray([True])))
            rids[s] = st.req.id
            steps[s] = len(st.produced)
        logits = self._step(toks, pos, self.cache.page_table, wp, wo)
        self.decode_steps += 1
        nxt, lps = _sample_rows(logits[:, 0], rids, steps, self.scfg)
        nxt, lps = nxt.cpu().numpy(), lps.cpu().numpy()
        for s in live:
            st = self._slots[s]
            st.produced.append(int(nxt[s]))
            st.logprobs.append(float(lps[s]))
            self._finish_check(st)

    def step(self) -> None:
        """One engine step: faults → quarantine release → deadline sweep →
        admit + prefill → one batched decode step (or one speculative round)
        over the live slots → reap → snapshot. ``engine_steps`` is the
        deterministic clock every fault, deadline and snapshot keys to."""
        step_idx = self.engine_steps
        if self.faults is not None:
            self._apply_faults(step_idx)            # may raise EngineCrash
        self._release_quarantine(step_idx)
        self._cancel_expired(step_idx)
        for slot, req in self.sched.admit(self._admission_check()):
            self._prefill(slot, req)

        live = ([] if step_idx < self._stall_until
                else [s for s, st in self._slots.items() if not st.done])
        if live:
            t0 = time.perf_counter()
            if self.spec is not None:
                span = self.prof.begin("spec_round", scope=f"step:{step_idx}",
                                       lane="engine", step=step_idx)
                self.spec.round(self, live)
                self.prof.end(span, live_slots=len(live))
            else:
                span = self.prof.begin("decode", scope=f"step:{step_idx}",
                                       lane="engine", step=step_idx)
                self._decode(live)
                self.prof.end(span, live_slots=len(live),
                              committed=len(live))
                self.tracker.log("serve_decode", {"live_slots": len(live)},
                                 step=self.decode_steps)
            self.decode_s.append(time.perf_counter() - t0)

        for s in [s for s, st in self._slots.items() if st.done]:
            st = self._slots.pop(s)
            self.results[st.req.id] = st.produced
            self.result_logprobs[st.req.id] = np.asarray(st.logprobs,
                                                         np.float32)
            self._deadline.pop(st.req.id, None)
            self.cache.free_slot(s)
            self.sched.release(s)
            self.prof.end(self._req_spans.pop(st.req.id, None),
                          n_tokens=len(st.produced), slot=s)
            self._submit_step.pop(st.req.id, None)
            self.tracker.log("serve_done", {
                "request_id": st.req.id, "slot": s,
                "n_tokens": len(st.produced),
                "decode_steps": self.decode_steps})
        self.engine_steps = step_idx + 1
        if (self.snapshot_dir is not None and self.snapshot_every
                and self.engine_steps % self.snapshot_every == 0):
            self.save_snapshot()

    # ------------------------------------------------------ snapshot/restore
    def save_snapshot(self, directory: Optional[str] = None) -> int:
        """Persist the whole engine state (scheduler, page tables, per-slot
        decode state, emitted tokens, KV pools) at the current engine step
        (:mod:`repro_torch.serve.snapshot`). Returns the snapshot's step."""
        from repro_torch.serve import snapshot as SN
        t0 = time.perf_counter()
        step = SN.save_engine_snapshot(self, directory or self.snapshot_dir)
        self.snapshot_s.append(time.perf_counter() - t0)
        return step

    @classmethod
    def from_snapshot(cls, directory: str, cfg, params, *,
                      step: Optional[int] = None, faults=None, tracker=None,
                      mesh=None, draft_cfg=None,
                      draft_params=None) -> "ContinuousEngine":
        """Rebuild an engine from a snapshot (the latest by default) on the
        params' device, ready to :meth:`run`: every stream in flight
        finishes bitwise as in an uncrashed run. A snapshot taken with a
        separate drafter needs ``draft_params`` (and ``draft_cfg`` if one
        was given): params are never stored, the drafter's pools are."""
        from repro_torch.serve import snapshot as SN
        return SN.restore_engine(directory, cfg, params, step=step,
                                 faults=faults, tracker=tracker, mesh=mesh,
                                 draft_cfg=draft_cfg,
                                 draft_params=draft_params)
