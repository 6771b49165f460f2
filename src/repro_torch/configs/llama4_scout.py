"""llama4-scout-17b-a16e [moe] — hf:meta-llama/Llama-4-Scout-17B-16E (unverified).
48L d=5120 40H (GQA kv=8) ff=8192 vocab=202048; 16 experts top-1 + shared expert.
Text backbone only (early-fusion multimodality is out of scope).

The reference's sharding hints (``shard_heads``, ``shard_kv``,
``attn_seq_shard``) belong to the distributed slice (ROADMAP A9) and are
left out here."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202_048, n_experts=16, top_k=1, n_shared_experts=1,
    renorm_topk=False, rope_theta=500_000.0,
    block_pattern=("attn_moe",),
)
