"""Transformer building blocks for decoder-only models: norms, RoPE, GQA
attention (train/prefill + cached decode), MLP (SiLU, GeGLU, GELU, squared
ReLU), embeddings.

Counterpart of ``repro.models.layers`` over plain parameter dicts in the same
layout. Matrix products compute in fp32 (:func:`dot`, like the reference's
``preferred_element_type=f32``) and cast where the reference casts. GQA is
native: K/V tensors and caches keep ``n_kv_heads`` heads. The KV cache and
the paged pools are updated in place (the reference returns new ones).

Inside :func:`repro_torch.dist.fold.canonical_scope` (the paged serving step
and the canonical forward) every reduction takes a form whose bits a row
cannot see the batch through: :func:`dot` runs the M-invariant GEMM kernel,
:func:`apply_norm` the row-norm kernel, ``wo`` and ``w_down`` the canonical
virtual-shard fold, attention the paged walk of ``kernels/decode.py``, and
SiLU and GELU are written out elementwise (``F.silu`` on the CPU picks its
formula by the element's place in the tensor).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.dist import fold
from repro_torch.kernels import gemm, rows
from repro_torch.kernels.decode import paged_attention
from repro_torch.kernels.ops import attention as attention_op
from repro_torch.masks.spec import SlidingWindow
from repro_torch.models.module import ParamDef as PD

F32 = torch.float32


def dot(x, w, out_dtype=None):
    """x @ w in fp32 (bf16 products are exact in fp32); cast if asked. Under
    the canonical scope: the M-invariant GEMM (``kernels/gemm.py``)."""
    if fold.active():
        return gemm.matmul(x.contiguous(), w, out_dtype=out_dtype)
    y = torch.matmul(x.to(F32), w.to(F32))
    return y if out_dtype is None else y.to(out_dtype)


# ----------------------------------------------------------------- norms
def norm_defs(cfg):
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return {"scale": PD((d,), "ones", F32), "bias": PD((d,), "zeros", F32)}
    return {"scale": PD((d,), "ones", F32)}


def apply_norm(p, x, cfg, eps=1e-5):
    if fold.active():
        return rows.norm(x.contiguous(), p["scale"], p.get("bias"), eps)
    xf = x.to(F32)
    if "bias" in p:  # layernorm
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:            # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


# ----------------------------------------------------------------- RoPE
def rope(x, positions, theta: float, pct: float = 1.0):
    """Rotary embedding on the leading `pct` fraction of head_dim
    (non-interleaved halves). x: (..., S, H, D); positions: (..., S) int."""
    d = x.shape[-1]
    dr = int(d * pct)
    if dr == 0:
        return x
    dr -= dr % 2
    xr, xp = x[..., :dr], x[..., dr:]
    half = dr // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device) / half)
    ang = positions.to(F32)[..., None, None] * freqs        # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = xr[..., :half], xr[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([out.to(x.dtype), xp], -1)


# ----------------------------------------------------------------- attention
def attn_defs(cfg):
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": PD((d, h * hd)),
        "wk": PD((d, hk * hd)),
        "wv": PD((d, hk * hd)),
        "wo": PD((h * hd, d), "scaled"),
    }
    if cfg.qkv_bias:
        p["bq"] = PD((h * hd,), "zeros")
        p["bk"] = PD((hk * hd,), "zeros")
        p["bv"] = PD((hk * hd,), "zeros")
    return p


def _project_qkv(p, x, cfg, positions):
    hd = cfg.head_dim
    q, k, v = dot(x, p["wq"]), dot(x, p["wk"]), dot(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    h, hk = q.shape[-1] // hd, k.shape[-1] // hd
    q = q.reshape(x.shape[:-1] + (h, hd)).to(cfg.dtype)
    k = k.reshape(x.shape[:-1] + (hk, hd)).to(cfg.dtype)
    v = v.reshape(x.shape[:-1] + (hk, hd)).to(cfg.dtype)
    if cfg.rope_pct > 0:
        q = rope(q, positions, cfg.rope_theta, cfg.rope_pct)
        k = rope(k, positions, cfg.rope_theta, cfg.rope_pct)
    return q, k, v


def _sdpa_full(q, k, v, cfg, causal, window=None, segment_ids=None):
    """(B,S,H,D)x(B,S,Hk,D) -> (B,S,H,D); dispatches to the configured impl.

    ``window`` (tokens) lowers as a :class:`repro_torch.masks.spec.
    SlidingWindow` spec with ``causal=False`` (the spec subsumes causality):
    on the cuda impl that runs the block-sparse forward, skipping every
    out-of-window tile, and the mask's compiled backward schedule.
    ``segment_ids`` (B, S) is the dynamic packed-document mask: it always
    runs the plain path (see :func:`repro_torch.kernels.ops.attention`)."""
    mask = None
    if window:
        if not causal:
            raise ValueError("sliding windows assume causal self-attention")
        mask = SlidingWindow(int(window))
        causal = False
    out = attention_op(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       causal=causal, impl=cfg.attention_impl,
                       schedule=cfg.dash_schedule, chunk_q=cfg.attn_chunk_q,
                       mask=mask, segment_ids=segment_ids)
    return out.transpose(1, 2).to(q.dtype)


def _sdpa_decode(q, k_cache, v_cache, valid_len, window=None):
    """One-step decode: q (B,1,H,D); caches (B,S,Hk,D); attends to
    [0, valid_len), or to the last ``window`` of it — the SlidingWindow
    spec's (q - w, q] at q = valid_len - 1."""
    b, _, h, hd = q.shape
    s, hk = k_cache.shape[1], k_cache.shape[2]
    g = h // hk
    qg = q.reshape(b, 1, hk, g, hd)
    scores = torch.einsum("bokgd,bskd->bkgs", qg.to(F32),
                          k_cache.to(F32)) / math.sqrt(hd)
    pos = torch.arange(s, device=q.device)
    visible = pos < valid_len
    if window:
        visible = visible & (pos >= valid_len - window)
    scores = torch.where(visible, scores, torch.full_like(scores, -1e30))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v_cache.to(F32))
    return out.reshape(b, 1, h, hd).to(q.dtype)


def _canonical_paged_sdpa(q, k, v, cfg, window=None, segment_ids=None):
    """Training-side attention computed with the serve kernel: fresh K/V laid
    out as trivially paged pools (logical page ``j`` of row ``b`` is pool page
    ``b·n_pg + j``) and reduced by the same fixed-order page walk
    (:func:`repro_torch.kernels.decode.paged_attention`) the engine runs, at
    the canonical scope's page size — so the canonical forward is bitwise the
    engine's chunked prefill at that page size (the reference's
    ``_canonical_paged_sdpa``). Causality is over the row index (RoPE
    positions restart per document in packed batches); ``segment_ids`` mask
    everything across documents."""
    b, s, hk, hd = k.shape
    ps = fold.scope_pages() or 16
    n_pg = -(-s // ps)
    pad = n_pg * ps - s

    def pool(t):   # (B, S, Hk, D) -> (B·n_pg, ps, Hk, D); pad rows masked
        return F.pad(t, (0, 0, 0, 0, 0, pad)).reshape(b * n_pg, ps, hk,
                                                      hd).contiguous()

    dev = q.device
    table = (torch.arange(b, dtype=torch.int32, device=dev)[:, None] * n_pg
             + torch.arange(n_pg, dtype=torch.int32, device=dev)[None, :])
    qpos = torch.arange(s, dtype=torch.int32, device=dev)[None, :].expand(
        b, s).contiguous()
    q_seg = kv_seg = None
    if segment_ids is not None:
        q_seg = segment_ids.to(torch.int32).contiguous()
        kv_seg = F.pad(q_seg, (0, pad), value=-1).reshape(b * n_pg,
                                                          ps).contiguous()
    return paged_attention(q.contiguous(), pool(k), pool(v), table, qpos,
                           window=window or None, q_segments=q_seg,
                           kv_segments=kv_seg)


def attention_block(p, x, cfg, *, positions=None, cache=None, cache_pos=None,
                    window=None, segment_ids=None, paged=None):
    """Causal GQA self-attention. Modes:
      train/prefill: cache=None → full causal attention (under the canonical
                     scope: the serve kernel's page walk,
                     :func:`_canonical_paged_sdpa`).
      cache:         cache=(k, v) (B,S_max,Hk,D), cache_pos int — the fresh
                     K/V are written at ``cache_pos`` in place; a multi-token
                     x (prefill) attends over its own K/V, a one-token x
                     (decode) over the cache up to ``cache_pos``.
      paged:         cache=(k_pages, v_pages) pools (P, page_size, Hk, D),
                     ``paged`` a dict with ``page_table`` (B, max_pages) and
                     ``write_pages``/``write_offsets`` (B·L,) token-major
                     targets: the fresh K/V are written into the pools in
                     place (``index_put_``; duplicates only ever land on the
                     masked trash page), then the batch-invariant page walk
                     runs (chunked prefill and batched decode alike).
      window:        optional sliding-window size in tokens (defaults to
                     ``cfg.attn_window``), honored on train/prefill (as a
                     SlidingWindow spec) and on cached decode (the last
                     ``window`` positions), so windowed training and
                     generation see the same distribution.
      segment_ids:   optional (B, S) packed-document ids (train/prefill);
                     cross-document attention is masked out.
    Returns (y, cache).
    """
    if window is None and cfg.attn_window:
        window = cfg.attn_window
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    if paged is not None:
        k_pages, v_pages = cache
        idx = (paged["write_pages"].to(torch.int64),
               paged["write_offsets"].to(torch.int64))
        k_pages.index_put_(idx, k.reshape((-1,) + k.shape[2:]).to(
            k_pages.dtype))
        v_pages.index_put_(idx, v.reshape((-1,) + v.shape[2:]).to(
            v_pages.dtype))
        out = paged_attention(q.contiguous(), k_pages, v_pages,
                              paged["page_table"],
                              positions.to(torch.int32).contiguous(),
                              window=window or None)
        out = out.reshape(x.shape[:-1] + (out.shape[-2] * out.shape[-1],))
        # canonical fold, one virtual shard a head
        return fold.canonical_row_dot(out, p["wo"], cfg.head_dim,
                                      out_dtype=x.dtype), cache
    if cache is None and fold.active():
        out = _canonical_paged_sdpa(q, k, v, cfg, window=window,
                                    segment_ids=segment_ids)
    elif cache is None:
        out = _sdpa_full(q, k, v, cfg, causal=True, window=window,
                         segment_ids=segment_ids)
    else:
        k_cache, v_cache = cache
        n = x.shape[1]
        k_cache[:, cache_pos:cache_pos + n] = k.to(k_cache.dtype)
        v_cache[:, cache_pos:cache_pos + n] = v.to(v_cache.dtype)
        if n > 1:   # prefill-fill: full attention over the fresh k/v
            out = _sdpa_full(q, k, v, cfg, causal=True, window=window)
        else:
            out = _sdpa_decode(q, k_cache, v_cache, cache_pos + 1,
                               window=window)
    out = out.reshape(out.shape[:-2] + (out.shape[-2] * out.shape[-1],))
    if fold.active():
        return fold.canonical_row_dot(out, p["wo"], cfg.head_dim,
                                      out_dtype=x.dtype), cache
    return dot(out, p["wo"], out_dtype=x.dtype), cache


# ----------------------------------------------------------------- MLP
def mlp_defs(cfg):
    d, f = cfg.d_model, cfg.d_ff
    p = {"w_up": PD((d, f)), "w_down": PD((f, d), "scaled")}
    if cfg.activation in ("silu", "geglu"):
        p["w_gate"] = PD((d, f))
    return p


def _silu(x):
    """SiLU; under the canonical scope written ``x · sigmoid(x)``, whose bits
    do not depend on the element's place in the tensor."""
    return x * torch.sigmoid(x) if fold.active() else F.silu(x)


def _gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation; under the
    canonical scope written out elementwise, as :func:`_silu` is."""
    if not fold.active():
        return F.gelu(x, approximate="tanh")
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x))))


def activate(h_gate, h_up, activation: str):
    """The MLP's hidden activation (the reference's ``apply_mlp`` and
    ``moe._act``): gated for silu/geglu, on ``h_up`` alone otherwise."""
    if activation == "silu":
        return _silu(h_gate) * h_up
    if activation == "geglu":
        return _gelu(h_gate) * h_up
    if activation == "gelu":
        return _gelu(h_up)
    if activation == "relu2":           # Nemotron-4's squared ReLU
        return torch.relu(h_up).square()
    raise ValueError(activation)


def apply_mlp(p, x, cfg):
    """The MLP: SiLU / GeGLU gated, GELU or squared ReLU (``relu2``)."""
    up = dot(x, p["w_up"])
    gate = dot(x, p["w_gate"]) if "w_gate" in p else None
    h = activate(gate, up, cfg.activation).to(x.dtype)
    if not fold.active():
        return dot(h, p["w_down"], out_dtype=x.dtype)
    # canonical grid for the down-projection: V = n_heads virtual shards
    width, rem = divmod(cfg.d_ff, cfg.n_heads)
    if rem:
        raise ValueError(f"canonical reductions need n_heads | d_ff; got "
                         f"d_ff={cfg.d_ff}, n_heads={cfg.n_heads}")
    return fold.canonical_row_dot(h, p["w_down"], width, out_dtype=x.dtype)


# ----------------------------------------------------------------- embeddings
def embed_defs(cfg):
    return {"tok": PD((cfg.padded_vocab, cfg.d_model))}


# one-hot transient budget for the deterministic embedding backward:
# block = ~2^25 fp32 elements (~128 MB) regardless of vocab size
_EMBED_BWD_ELEMS = 1 << 25


class _DetEmbedLookup(torch.autograd.Function):
    """Embedding lookup with a deterministic backward (the reference's
    ``_det_embed_lookup``).

    dtable = scatter-add(dy at tokens) ≡ one_hot(tokens)ᵀ @ dy. The indexing
    backward PyTorch would take accumulates duplicate tokens with atomics on
    the card, in an order that changes from run to run; the product's
    reduction order is fixed. fp32 accumulation. The token axis runs in
    fixed-size blocks, ascending, so the one-hot transient stays ~128 MB at
    full vocab; block padding uses index == vocab, whose one-hot row is all
    zero.
    """

    @staticmethod
    def forward(ctx, table, tokens):
        ctx.save_for_backward(tokens)
        ctx.vocab = table.shape[0]
        return table[tokens]

    @staticmethod
    def backward(ctx, dy):
        (tokens,) = ctx.saved_tensors
        vocab = ctx.vocab
        flat_tok = tokens.reshape(-1)
        flat_dy = dy.reshape(-1, dy.shape[-1]).to(F32)
        t = flat_tok.shape[0]
        block = min(t, max(64, _EMBED_BWD_ELEMS // vocab))
        n_blocks = -(-t // block)
        ids = torch.arange(vocab, device=dy.device)

        def block_grad(tok_blk, dy_blk):
            onehot = (tok_blk[:, None] == ids[None, :]).to(F32)
            return torch.matmul(onehot.t(), dy_blk)

        if n_blocks == 1:
            dtable = block_grad(flat_tok, flat_dy)
        else:
            pad = n_blocks * block - t
            if pad:
                flat_tok = torch.cat([flat_tok, flat_tok.new_full((pad,),
                                                                  vocab)])
                flat_dy = torch.cat([flat_dy,
                                     flat_dy.new_zeros((pad, dy.shape[-1]))])
            dtable = torch.zeros((vocab, dy.shape[-1]), dtype=F32,
                                 device=dy.device)
            for i in range(n_blocks):
                blk = slice(i * block, (i + 1) * block)
                dtable = dtable + block_grad(flat_tok[blk], flat_dy[blk])
        return dtable.to(dy.dtype), None


def apply_embed(p, tokens, cfg):
    table = p["tok"].to(cfg.dtype)
    if cfg.det_embed_grad:
        return _DetEmbedLookup.apply(table, tokens)
    return table[tokens]


def lm_head_defs(cfg):
    return {"w": PD((cfg.d_model, cfg.padded_vocab))}


def apply_lm_head(p, x, cfg):
    return dot(x, p["w"])
