"""Config dataclass: model architecture + runtime knobs.

The port's counterpart of ``repro.configs.base.ModelConfig``, holding the
fields of the features the port implements so far (decoder-only attention
stacks); fields for other families arrive with them. Two changes from the
reference: ``dtype`` is a torch dtype, and ``attention_impl`` names the port's
implementations — ``"torch"`` (plain PyTorch attention, counterpart of
``"xla"``) and ``"cuda"`` (the hand-written DASH kernels, counterpart of
``"pallas"``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim_: Optional[int] = None
    # attention / norm / act
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_pct: float = 1.0
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    activation: str = "silu"
    attention_impl: str = "torch"  # torch | cuda (DASH kernels)
    dash_schedule: str = "symmetric_shift_or_shift"
    attn_chunk_q: int = 1024       # q-chunked attention above this seq
    attn_window: int = 0           # sliding-window size in tokens (0 = full);
                                   # lowers as masks.SlidingWindow on both impls
    packed_inputs: bool = False    # batches carry segment_ids/positions from
                                   # the deterministic sequence packer
                                   # (data.pipeline.pack_documents): attention
                                   # is segment-masked, RoPE restarts per doc
    # structure
    block_pattern: Tuple[str, ...] = ("attn",)
    # numerics
    dtype_name: str = "bfloat16"
    vocab_pad: int = 2048                   # pad vocab to multiple of tp*128
    det_embed_grad: bool = True    # embedding bwd as pinned one-hot matmul
    moe_aux_weight: float = 0.01   # weight of the (MoE) aux loss in loss_fn

    @property
    def head_dim(self) -> int:
        return self.head_dim_ or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return -(-self.vocab // self.vocab_pad) * self.vocab_pad

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype_name)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, **kw) -> "ModelConfig":
        """Smoke-test scale: one pattern repeat, tiny widths, same structure
        (the reference's ``reduced()`` on these fields)."""
        kvr = max(1, self.n_heads // max(1, self.n_kv_heads))  # keep GQA ratio
        small = dict(
            n_layers=len(self.block_pattern),
            d_model=128, n_heads=4, n_kv_heads=max(1, 4 // kvr), head_dim_=32,
            d_ff=256 if self.d_ff else 0, vocab=512, vocab_pad=128,
        )
        small.update(kw)
        return self.replace(**small)
