"""Model assembly for decoder-only LMs with ``("attn",)`` block patterns.

Counterpart of ``repro.models.transformer``. Parameters keep the reference's
tree: per pattern position ``b{i}_{kind}`` a stack of ``(n_repeats, ...)``
leaves, walked here by a Python loop over the repeats (the reference scans).

Entry modes:
  forward:      full-sequence logits (train/prefill);
  prefill_step: prompt processing that also fills the KV caches;
  decode_step:  one-token step over the caches (updated in place).
Other block patterns (MoE, SSM, xLSTM) raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

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


def _layer(stacked_p, i):
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in stacked_p.items()}


def _apply_block(p, x, cfg, *, positions, cache=None, cache_pos=None):
    h, _ = L.attention_block(p["attn"], L.apply_norm(p["ln1"], x, cfg), cfg,
                             positions=positions, cache=cache,
                             cache_pos=cache_pos)
    x = x + h
    return x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], x, cfg), cfg)


def _apply_stack(params, x, cfg, *, positions, caches=None, cache_pos=None):
    for key, stacked_p in _blocks(params):
        n_rep = stacked_p["ln1"]["scale"].shape[0]
        for i in range(n_rep):
            cache = None
            if caches is not None:
                k_all, v_all = caches[key]["attn"]
                cache = (k_all[i], v_all[i])
            x = _apply_block(_layer(stacked_p, i), x, cfg, positions=positions,
                             cache=cache, cache_pos=cache_pos)
    return x


def forward(params, batch, cfg):
    """Train/prefill forward → (logits, aux_loss). batch['tokens']: (B, S)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    x = L.apply_embed(params["embed"], tokens, cfg)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = _apply_stack(params, x, cfg, positions=positions)
    x = L.apply_norm(params["ln_f"], x, cfg)
    logits = L.apply_lm_head(params["lm_head"], x, cfg)
    return logits, torch.zeros((), dtype=F32, device=x.device)


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
