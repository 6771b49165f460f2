"""phi3.5-moe-42b-a6.6b [moe] — hf:microsoft/Phi-3.5-MoE-instruct (hf tier).
32L d=4096 32H (GQA kv=8) ff=6400 vocab=32064; 16 experts top-2.

The reference's sharding hint (``shard_kv``) belongs to the distributed
slice (ROADMAP A9) and is left out here."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
    vocab=32_064, n_experts=16, top_k=2,
    block_pattern=("attn_moe",),
)
