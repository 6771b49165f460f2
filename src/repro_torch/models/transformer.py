"""Model assembly for decoder-only LMs of ``attn``, ``attn_moe``, ``mamba``,
``mamba_moe``, ``mlstm`` and ``slstm`` blocks.

Counterpart of ``repro.models.transformer``. Parameters keep the reference's
tree: per pattern position ``b{i}_{kind}`` a stack of ``(n_repeats, ...)``
leaves, walked here by a Python loop over the repeats (the reference scans).
An ``attn`` block is attention then an MLP; an ``attn_moe`` block has the
mixture-of-experts FFN (``models/moe.py``, ``cfg.moe_impl``) in place of the
MLP, plus a shared MLP on the same normed input when
``cfg.n_shared_experts`` (Llama-4). A ``mamba`` block is the selective SSM
(``models/mamba.py``) then an MLP, ``mamba_moe`` the SSM then the
mixture-of-experts FFN (Jamba). An ``mlstm`` or ``slstm`` block is a norm
then the xLSTM mixer (``models/xlstm.py``), with no second norm and no MLP
(xLSTM-350M). The blocks' aux losses are summed in fp32 in
pattern-then-repeat order, as the reference's scan carry sums them.

Entry modes:
  forward:      full-sequence logits (train/prefill), each layer optionally
                recomputed in the backward (``remat``: the counterpart of
                ``jax.checkpoint`` on the scan body, with the reference's
                ``remat_policy``);
  loss_fn:      next-token cross-entropy over ``forward``;
  prefill_step: prompt processing that also fills the caches (KV for
                attention, the conv and SSM states for Mamba, the
                recurrent states for xLSTM: mLSTM runs its recurrence over
                the prompt here, its parallel form in ``forward``);
  decode_step:  one-token step over the caches (updated in place);
  paged_step:   the continuous engine's step over paged KV pools (a prefill
                chunk or a batched one-token decode), always under the
                canonical reduction scope (``dist/fold.py``); attention-only
                patterns, as in the reference (MoE capacity routing couples
                the rows of a batch; SSM and xLSTM states are unpaged).
Other block kinds (cross-attention) and learned position embeddings raise
``NotImplementedError``.

``cfg.canonical_reductions = N`` runs ``forward`` in serve-canonical mode:
the paged attention walk over N-token pages and the canonical folds, so its
logits are bitwise the engine's chunked prefill at ``page_size=N``. That
mode serves the train≡serve parity cell only: it runs without a gradient,
and a gradient through it raises.

Remat policies (``REMAT_POLICIES``), each a ``torch.utils.checkpoint`` of
one layer: ``"none"`` recomputes everything; ``"dots"`` and ``"names"`` run a
selective-checkpoint policy over the dispatched ops — ``"dots"`` saves every
matrix product's output (the reference's ``dots_saveable``), ``"names"`` only
the tensors the reference tags with ``checkpoint_name``: ``attn_out`` (the
residual after attention), ``ffn_in`` (the MLP's normed input) and
``ssm_out`` (the residual after a Mamba mixer). A policy decides what is
*kept*; the backward still re-runs the layer's Python code, and a saved op
returns its kept output instead of computing again. The DASH forward is a
``torch.autograd.Function`` whose kernel launch is no dispatched op, so it is
recomputed under every policy: with ``remat`` a train step launches the
attention forward twice a layer for ``"none"``, ``"dots"`` and ``"names"``
alike (once without remat), the backward kernels once. The selective scan
(``kernels/scan.py``) is such a Function too: its forward twice a Mamba
layer, its backward and fold once. So are the xLSTM kernels
(``kernels/mlstm.py``, ``kernels/slstm.py``): the mLSTM parallel form's
forward twice a mLSTM layer and its backward once (three passes), the
sLSTM's forward twice a sLSTM layer and its backward once. The mLSTM
recurrence has no backward (no training path runs it): a gradient through
it raises.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import resolve_device
from repro_torch.dist import fold
from repro_torch.models import layers as L
from repro_torch.models import mamba as MB
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as X
from repro_torch.models.module import init_tree, stacked, tree_paths

F32 = torch.float32


BLOCK_KINDS = ("attn", "attn_moe", "mamba", "mamba_moe", "mlstm", "slstm")
XLSTM_KINDS = ("mlstm", "slstm")
POS_EMBEDS = ("rope", "none")


def check_supported(cfg) -> None:
    """Raise for a block pattern or position embedding this port does not
    cover yet."""
    if any(k not in BLOCK_KINDS for k in cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.name}: block pattern {cfg.block_pattern} is not ported yet "
            f"(ROADMAP A8, 'Other model families')")
    if cfg.pos_embed not in POS_EMBEDS:
        raise NotImplementedError(
            f"{cfg.name}: pos_embed={cfg.pos_embed!r} is not ported yet "
            f"(ROADMAP A8: learned position embeddings come with Whisper)")


def _block_defs(cfg, kind: str):
    if kind in XLSTM_KINDS:
        mixer = X.mlstm_defs(cfg) if kind == "mlstm" else X.slstm_defs(cfg)
        return {"ln1": L.norm_defs(cfg), kind: mixer}
    if kind.startswith("mamba"):
        d = {"ln1": L.norm_defs(cfg), "mamba": MB.mamba_defs(cfg),
             "ln2": L.norm_defs(cfg)}
    else:
        d = {"ln1": L.norm_defs(cfg), "attn": L.attn_defs(cfg),
             "ln2": L.norm_defs(cfg)}
    if kind.endswith("_moe"):
        d["moe"] = MOE.moe_defs(cfg)
        if cfg.n_shared_experts and kind == "attn_moe":
            d["shared_mlp"] = L.mlp_defs(cfg)
    else:
        d["mlp"] = L.mlp_defs(cfg)
    return d


def param_defs(cfg):
    check_supported(cfg)
    n_rep, rem = divmod(cfg.n_layers, len(cfg.block_pattern))
    if rem:
        raise ValueError(f"n_layers={cfg.n_layers} is not a multiple of the "
                         f"pattern {cfg.block_pattern}")
    return {
        "embed": L.embed_defs(cfg),
        "ln_f": L.norm_defs(cfg),
        "blocks": {f"b{i}_{kind}": stacked(_block_defs(cfg, kind), n_rep)
                   for i, kind in enumerate(cfg.block_pattern)},
        "lm_head": L.lm_head_defs(cfg),
    }


def init(cfg, seed: int = 0, device=None):
    """Random parameters from ``torch.Generator(device).manual_seed(seed)``
    with the reference's distributions, on ``device`` (the card by default)."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return init_tree(param_defs(cfg), gen, cfg.dtype, device)


def _blocks(params):
    """(key ``b{i}_{kind}``, stacked params) in pattern order."""
    blocks = params["blocks"]
    return [(k, blocks[k])
            for k in sorted(blocks, key=lambda s: int(s.split("_")[0][1:]))]


def _unstack(stacked_p):
    """Per-layer views of a stacked tree, as ``{key: [layer 0, ...]}`` with
    nested dicts kept. ``unbind`` (not indexing per layer) so that the
    backward stacks the layers' grads once instead of adding one zero-padded
    full-stack grad per layer."""
    return {k: (_unstack(v) if isinstance(v, dict) else v.unbind(0))
            for k, v in stacked_p.items()}


def _layer(unstacked, i):
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in unstacked.items()}


# the matrix products as they reach the dispatcher (``torch.matmul`` lowers
# to these; the reference's "dots" saves every dot_general)
_DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                      torch.ops.aten.addmm.default,
                      torch.ops.aten.baddbmm.default})
_NAMES = ("attn_out", "ffn_in", "ssm_out")


class _Policy:
    """A selective-checkpoint policy over the ops of one remat'd layer.

    ``"dots"`` saves the output of every matrix product; ``"names"`` saves
    the copy :meth:`name` makes of a tagged tensor and nothing else."""

    def __init__(self, kind: str):
        self.kind = kind
        self._tagging = False

    def name(self, x, tag: str):
        """``checkpoint_name``: under ``"names"`` a copy whose output the
        policy keeps, else ``x`` itself."""
        if self.kind != "names" or tag not in _NAMES:
            return x
        self._tagging = True
        try:
            return x.clone()
        finally:
            self._tagging = False

    def __call__(self, ctx, op, *args, **kwargs):
        keep = (op in _DOT_OPS if self.kind == "dots"
                else self._tagging and op is torch.ops.aten.clone.default)
        return (CheckpointPolicy.MUST_SAVE if keep
                else CheckpointPolicy.PREFER_RECOMPUTE)

    def contexts(self):
        return create_selective_checkpoint_contexts(self)


REMAT_POLICIES = ("none", "dots", "names")


def _identity_name(x, tag):
    return x


def _apply_block(p, x, cfg, *, positions, cache=None, cache_pos=None,
                 segment_ids=None, name=_identity_name, paged=None):
    """One block of any kind in ``BLOCK_KINDS`` (told apart by its
    parameters). ``cache``: the layer's (k, v) cache for attention, its
    (conv_state, ssm_state) for Mamba, its (C, n, m) for mLSTM and (c, n,
    h, m) for sLSTM, each updated in place. Returns (x, aux): the MoE's aux
    loss, or None for a block without one."""
    for kind, apply in (("mlstm", X.apply_mlstm), ("slstm", X.apply_slstm)):
        if kind in p:
            h, new_state = apply(p[kind], L.apply_norm(p["ln1"], x, cfg), cfg,
                                 state=cache)
            if cache is not None:
                for leaf, new in zip(cache, new_state):
                    leaf.copy_(new)
            return x + h, None
    if "mamba" in p:
        h, new_state = MB.apply_mamba(p["mamba"],
                                      L.apply_norm(p["ln1"], x, cfg), cfg,
                                      state=cache)
        if cache is not None:
            cache[0].copy_(new_state[0])
            cache[1].copy_(new_state[1])
        x = name(x + h, "ssm_out")
        y_in = L.apply_norm(p["ln2"], x, cfg)
    else:
        h, _ = L.attention_block(p["attn"], L.apply_norm(p["ln1"], x, cfg),
                                 cfg, positions=positions, cache=cache,
                                 cache_pos=cache_pos, segment_ids=segment_ids,
                                 paged=paged)
        x = name(x + h, "attn_out")
        y_in = name(L.apply_norm(p["ln2"], x, cfg), "ffn_in")
    if "moe" not in p:
        return x + L.apply_mlp(p["mlp"], y_in, cfg), None
    y, aux = MOE.apply(p["moe"], y_in, cfg)
    if "shared_mlp" in p:
        y = y + L.apply_mlp(p["shared_mlp"], y_in, cfg)
    return x + y, aux


def _remat_layer(p, x, cfg, *, positions, segment_ids, remat_policy):
    """One layer under ``torch.utils.checkpoint`` (non-reentrant) with the
    policy ``remat_policy``; returns what :func:`_apply_block` returns."""
    policy = _Policy(remat_policy)
    selective = {} if remat_policy == "none" else dict(
        context_fn=policy.contexts)
    return checkpoint(
        lambda x_: _apply_block(p, x_, cfg, positions=positions,
                                segment_ids=segment_ids, name=policy.name),
        x, use_reentrant=False, **selective)


def _apply_stack(params, x, cfg, *, positions, caches=None, cache_pos=None,
                 remat=False, remat_policy="none", segment_ids=None,
                 paged=None):
    """The blocks in pattern order, each stack's repeats in order. Returns
    (x, aux): the fp32 sum of the blocks' aux losses in that order (None
    without an MoE block)."""
    aux_total = None
    for key, stacked_p in _blocks(params):
        n_rep = stacked_p["ln1"]["scale"].shape[0]
        layers = _unstack(stacked_p)
        for i in range(n_rep):
            p = _layer(layers, i)
            if remat:
                x, aux = _remat_layer(p, x, cfg, positions=positions,
                                      segment_ids=segment_ids,
                                      remat_policy=remat_policy)
            else:
                cache = None
                if caches is not None:
                    leaves = next(iter(caches[key].values()))
                    cache = tuple(leaf[i] for leaf in leaves)
                x, aux = _apply_block(p, x, cfg, positions=positions,
                                      cache=cache, cache_pos=cache_pos,
                                      segment_ids=segment_ids, paged=paged)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
    return x, aux_total


def forward(params, batch, cfg, *, remat=False, remat_policy="none"):
    """Train/prefill forward → (logits, aux_loss). batch['tokens']: (B, S);
    optional batch['positions'] (B, S) (default ``arange``) and
    batch['segment_ids'] (B, S), a packed batch's document ids: attention
    across documents is masked out (on the plain path, as in the reference).

    ``remat=True`` runs each layer under ``torch.utils.checkpoint`` (non-
    reentrant) with ``remat_policy`` (one of ``REMAT_POLICIES``, see the
    module docstring): the backward recomputes the layer, attention forward
    included, except the outputs the policy keeps.

    ``cfg.canonical_reductions = N`` runs the serve-canonical mode (module
    docstring) under ``torch.no_grad``; it raises if a gradient is asked
    for (parameters that require one, or ``remat``).
    """
    check_supported(cfg)
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy={remat_policy!r}; one of "
                         f"{REMAT_POLICIES}")
    if cfg.canonical_reductions:
        wants_grad = torch.is_grad_enabled() and any(
            t.requires_grad for _, t in tree_paths(params))
        if remat or wants_grad:
            raise NotImplementedError(
                "the canonical forward (canonical_reductions) serves the "
                "train≡serve parity cell only and has no gradient")
        with fold.canonical_scope(page_size=cfg.canonical_reductions), \
                torch.no_grad():
            return _forward_body(params, batch, cfg, remat=False,
                                 remat_policy=remat_policy)
    return _forward_body(params, batch, cfg, remat=remat,
                         remat_policy=remat_policy)


def _forward_body(params, batch, cfg, *, remat, remat_policy):
    tokens = batch["tokens"]
    x = L.apply_embed(params["embed"], tokens, cfg)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x, aux = _apply_stack(params, x, cfg, positions=positions, remat=remat,
                          remat_policy=remat_policy,
                          segment_ids=batch.get("segment_ids"))
    x = L.apply_norm(params["ln_f"], x, cfg)
    logits = L.apply_lm_head(params["lm_head"], x, cfg)
    if aux is None:
        aux = torch.zeros((), dtype=F32, device=x.device)
    return logits, aux


def loss_fn(params, batch, cfg, *, remat=False, remat_policy="none"):
    """Next-token CE (+ aux). batch: tokens (B,S), labels (B,S) with -100 pad.

    ``gold`` is a compare-select-sum over the vocab axis, as in the
    reference: its backward is a select, where a gather's would be a
    scatter-add.
    """
    logits, aux = forward(params, batch, cfg, remat=remat,
                          remat_policy=remat_policy)
    labels = batch["labels"]
    logits = logits.to(F32)
    viota = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.where(viota == labels[..., None].clamp_min(0), logits,
                       torch.zeros((), dtype=F32, device=logits.device)
                       ).sum(-1)
    lse = torch.logsumexp(logits, dim=-1)
    mask = (labels >= 0).to(F32)
    ce = torch.sum((lse - gold) * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return ce + cfg.moe_aux_weight * aux, {"ce": ce, "aux": aux}


def init_cache(cfg, batch_size: int, max_seq: int, device):
    """Caches per pattern position, as the reference's: an ``attn*`` block
    {"attn": (k, v)}, each (n_repeats, B, max_seq, Hk, D) in cfg.dtype; a
    ``mamba*`` block {"mamba": (conv_state (n_repeats, B, k-1, Din) in
    cfg.dtype, ssm_state (n_repeats, B, Din, N) fp32)}, all zeros; an
    ``mlstm`` block {"mlstm": (C (n_repeats, B, H, hd, hd), n (n_repeats, B,
    H, hd), m (n_repeats, B, H))}, all zeros; an ``slstm`` block {"slstm":
    (c, n, h, m)}, each (n_repeats, B, H, hd), m at -1e30 and the others
    zeros (the xLSTM states fp32)."""
    check_supported(cfg)
    n_rep = cfg.n_layers // len(cfg.block_pattern)
    d_in, _, d_state, k_conv = MB.mamba_dims(cfg)
    caches = {}
    init_state = {"mlstm": X.mlstm_init_state, "slstm": X.slstm_init_state}
    for i, kind in enumerate(cfg.block_pattern):
        if kind in XLSTM_KINDS:
            caches[f"b{i}_{kind}"] = {kind: tuple(
                leaf.expand((n_rep,) + leaf.shape).clone()
                for leaf in init_state[kind](cfg, batch_size, device))}
        elif kind.startswith("mamba"):
            caches[f"b{i}_{kind}"] = {"mamba": (
                torch.zeros((n_rep, batch_size, k_conv - 1, d_in),
                            dtype=cfg.dtype, device=device),
                torch.zeros((n_rep, batch_size, d_in, d_state), dtype=F32,
                            device=device))}
        else:
            shape = (n_rep, batch_size, max_seq, cfg.n_kv_heads,
                     cfg.head_dim)
            caches[f"b{i}_{kind}"] = {"attn": (
                torch.zeros(shape, dtype=cfg.dtype, device=device),
                torch.zeros(shape, dtype=cfg.dtype, device=device))}
    return caches


def prefill_step(params, batch, cfg, *, max_seq=None):
    """Prompt processing that also fills the caches.
    Returns (last-token logits (B,1,V), caches)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    x = L.apply_embed(params["embed"], tokens, cfg)
    b, s = tokens.shape
    caches = init_cache(cfg, b, max_seq or s, x.device)
    positions = torch.arange(s, device=x.device)[None, :]
    x, _ = _apply_stack(params, x, cfg, positions=positions, caches=caches,
                        cache_pos=0)
    x = L.apply_norm(params["ln_f"], x[:, -1:], cfg)
    return L.apply_lm_head(params["lm_head"], x, cfg), caches


def supports_paged(cfg) -> bool:
    """True iff the paged serving path covers this config: an attention-only
    block pattern (the reference's rule; the port has no frontends)."""
    return all(k == "attn" for k in cfg.block_pattern)


def paged_refusal(cfg) -> str:
    """Why the paged path refuses ``cfg`` (the reference's reason)."""
    bad = [k for k in cfg.block_pattern if k != "attn"]
    return (f"paged serving supports attention-only patterns; got {bad} "
            f"(SSM states are unpaged; MoE capacity routing is "
            f"batch-coupled)")


def init_paged_cache(cfg, n_pages: int, page_size: int, device):
    """Paged KV pools per pattern position: ``{"attn": (k_pages, v_pages)}``,
    each (n_repeats, n_pages, page_size, Hk, D) in cfg.dtype from
    ``torch.zeros`` (never ``torch.empty``: under deterministic algorithms
    that fills NaN, and a stale page must hold finite values).

    Serving over pages is attention-only: MoE capacity routing is
    batch-dependent by construction (token dropping couples rows), which
    would break the batch-invariance contract."""
    if not supports_paged(cfg):
        raise NotImplementedError(paged_refusal(cfg))
    n_rep = cfg.n_layers // len(cfg.block_pattern)
    shape = (n_rep, n_pages, page_size, cfg.n_kv_heads, cfg.head_dim)
    return {f"b{i}_attn": {"attn": (
        torch.zeros(shape, dtype=cfg.dtype, device=device),
        torch.zeros(shape, dtype=cfg.dtype, device=device))}
        for i in range(len(cfg.block_pattern))}


def paged_step(params, caches, tokens, positions, page_table, write_pages,
               write_offsets, cfg):
    """One paged serving step: a prefill chunk or a batched one-token decode.

    tokens / positions: (B, L) token ids and absolute positions (L=1 for the
    cross-slot decode; B=1, L=chunk for chunked prefill). page_table:
    (B, max_pages) int32 physical page per logical page. write_pages /
    write_offsets: (B·L,) token-major targets for the fresh K/V (the engine
    points pad tokens and idle slots at its trash page). Returns (logits
    (B, L, V) fp32, caches), the pools updated in place. Every op is
    row-independent and the KV reduction order is fixed, so a row's logits
    are a function of its own (params, tokens, positions, page history).
    Always runs under :func:`repro_torch.dist.fold.canonical_scope`.
    """
    check_supported(cfg)
    with fold.canonical_scope(), torch.no_grad():
        x = L.apply_embed(params["embed"], tokens, cfg)
        paged = dict(page_table=page_table, write_pages=write_pages,
                     write_offsets=write_offsets)
        x, _ = _apply_stack(params, x, cfg, positions=positions,
                            caches=caches, cache_pos=0, paged=paged)
        x = L.apply_norm(params["ln_f"], x, cfg)
        return L.apply_lm_head(params["lm_head"], x, cfg), caches


def decode_step(params, caches, tokens, cache_pos: int, cfg):
    """One decode step. tokens: (B, 1); cache_pos: index into the cache.
    Returns (logits (B,1,V), caches) — the caches are updated in place."""
    x = L.apply_embed(params["embed"], tokens, cfg)
    positions = torch.full((tokens.shape[0], 1), cache_pos, dtype=torch.int64,
                           device=x.device)
    x, _ = _apply_stack(params, x, cfg, positions=positions, caches=caches,
                        cache_pos=cache_pos)
    x = L.apply_norm(params["ln_f"], x, cfg)
    return L.apply_lm_head(params["lm_head"], x, cfg), caches
