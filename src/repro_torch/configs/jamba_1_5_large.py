"""jamba-1.5-large-398b [hybrid] — arXiv:2403.19887 (hf tier).
72L d=8192 64H (GQA kv=8) ff=24576 vocab=65536; Mamba+attention 1:7 interleave
(attention at position 4 of each 8-layer period), MoE (16e top-2) every other
layer; attention layers use no positional encoding (NoPE).

The reference's sharding hint (``shard_kv``) and ``max_seq`` belong to
slices the port has not taken yet and are left out here."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=24_576,
    vocab=65_536, n_experts=16, top_k=2, pos_embed="none", rope_pct=0.0,
    block_pattern=("mamba", "mamba_moe", "mamba", "mamba_moe",
                   "attn", "mamba_moe", "mamba", "mamba_moe"),
    ssm_state_dim=16,
)
