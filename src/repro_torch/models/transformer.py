"""Model assembly for decoder-only LMs with ``("attn",)`` block patterns.

Counterpart of ``repro.models.transformer``. Parameters keep the reference's
tree: per pattern position ``b{i}_{kind}`` a stack of ``(n_repeats, ...)``
leaves, walked here by a Python loop over the repeats (the reference scans).

Entry modes:
  forward:      full-sequence logits (train/prefill), each layer optionally
                recomputed in the backward (``remat``: the counterpart of
                ``jax.checkpoint`` on the scan body);
  loss_fn:      next-token cross-entropy over ``forward``;
  prefill_step: prompt processing that also fills the KV caches;
  decode_step:  one-token step over the caches (updated in place).
Other block patterns (MoE, SSM, xLSTM) raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.module import init_tree, stacked

F32 = torch.float32


def check_supported(cfg) -> None:
    """Raise for a block pattern this port does not cover yet."""
    if any(k != "attn" for k in cfg.block_pattern):
        raise NotImplementedError(
            f"{cfg.name}: block pattern {cfg.block_pattern} is not ported yet "
            f"(ROADMAP queue A, 'Other model families')")


def _block_defs(cfg):
    return {"ln1": L.norm_defs(cfg), "attn": L.attn_defs(cfg),
            "ln2": L.norm_defs(cfg), "mlp": L.mlp_defs(cfg)}


def param_defs(cfg):
    check_supported(cfg)
    n_rep, rem = divmod(cfg.n_layers, len(cfg.block_pattern))
    if rem:
        raise ValueError(f"n_layers={cfg.n_layers} is not a multiple of the "
                         f"pattern {cfg.block_pattern}")
    return {
        "embed": L.embed_defs(cfg),
        "ln_f": L.norm_defs(cfg),
        "blocks": {f"b{i}_{kind}": stacked(_block_defs(cfg), n_rep)
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
    """(key, stacked params) in pattern order."""
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


def _apply_block(p, x, cfg, *, positions, cache=None, cache_pos=None,
                 segment_ids=None):
    h, _ = L.attention_block(p["attn"], L.apply_norm(p["ln1"], x, cfg), cfg,
                             positions=positions, cache=cache,
                             cache_pos=cache_pos, segment_ids=segment_ids)
    x = x + h
    return x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], x, cfg), cfg)


def _apply_stack(params, x, cfg, *, positions, caches=None, cache_pos=None,
                 remat=False, segment_ids=None):
    for key, stacked_p in _blocks(params):
        n_rep = stacked_p["ln1"]["scale"].shape[0]
        layers = _unstack(stacked_p)
        for i in range(n_rep):
            p = _layer(layers, i)
            if remat:
                # recompute everything in the backward (remat_policy "none")
                x = checkpoint(
                    lambda x_, p_=p: _apply_block(p_, x_, cfg,
                                                  positions=positions,
                                                  segment_ids=segment_ids),
                    x, use_reentrant=False)
                continue
            cache = None
            if caches is not None:
                k_all, v_all = caches[key]["attn"]
                cache = (k_all[i], v_all[i])
            x = _apply_block(p, x, cfg, positions=positions, cache=cache,
                             cache_pos=cache_pos, segment_ids=segment_ids)
    return x


def forward(params, batch, cfg, *, remat=False, remat_policy="none"):
    """Train/prefill forward → (logits, aux_loss). batch['tokens']: (B, S);
    optional batch['positions'] (B, S) (default ``arange``) and
    batch['segment_ids'] (B, S), a packed batch's document ids: attention
    across documents is masked out (on the plain path, as in the reference).

    ``remat=True`` runs each layer under ``torch.utils.checkpoint`` (non-
    reentrant): the backward recomputes the layer, attention forward
    included. Only ``remat_policy="none"`` (recompute everything) is ported.
    """
    check_supported(cfg)
    if remat and remat_policy != "none":
        raise NotImplementedError(
            f"remat_policy={remat_policy!r} is not ported yet (ROADMAP queue "
            f"A, dense train step); 'none' is")
    tokens = batch["tokens"]
    x = L.apply_embed(params["embed"], tokens, cfg)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = _apply_stack(params, x, cfg, positions=positions, remat=remat,
                     segment_ids=batch.get("segment_ids"))
    x = L.apply_norm(params["ln_f"], x, cfg)
    logits = L.apply_lm_head(params["lm_head"], x, cfg)
    return logits, torch.zeros((), dtype=F32, device=x.device)


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
    """KV caches per pattern position: {"attn": (k, v)}, each
    (n_repeats, B, max_seq, Hk, D) in cfg.dtype."""
    check_supported(cfg)
    n_rep = cfg.n_layers // len(cfg.block_pattern)
    shape = (n_rep, batch_size, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {f"b{i}_{kind}": {"attn": (
        torch.zeros(shape, dtype=cfg.dtype, device=device),
        torch.zeros(shape, dtype=cfg.dtype, device=device))}
        for i, kind in enumerate(cfg.block_pattern)}


def prefill_step(params, batch, cfg, *, max_seq=None):
    """Prompt processing that also fills the caches.
    Returns (last-token logits (B,1,V), caches)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    x = L.apply_embed(params["embed"], tokens, cfg)
    b, s = tokens.shape
    caches = init_cache(cfg, b, max_seq or s, x.device)
    positions = torch.arange(s, device=x.device)[None, :]
    x = _apply_stack(params, x, cfg, positions=positions, caches=caches,
                     cache_pos=0)
    x = L.apply_norm(params["ln_f"], x[:, -1:], cfg)
    return L.apply_lm_head(params["lm_head"], x, cfg), caches


def decode_step(params, caches, tokens, cache_pos: int, cfg):
    """One decode step. tokens: (B, 1); cache_pos: index into the cache.
    Returns (logits (B,1,V), caches) — the caches are updated in place."""
    x = L.apply_embed(params["embed"], tokens, cfg)
    positions = torch.full((tokens.shape[0], 1), cache_pos, dtype=torch.int64,
                           device=x.device)
    x = _apply_stack(params, x, cfg, positions=positions, caches=caches,
                     cache_pos=cache_pos)
    x = L.apply_norm(params["ln_f"], x, cfg)
    return L.apply_lm_head(params["lm_head"], x, cfg), caches
