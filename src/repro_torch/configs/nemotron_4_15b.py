"""nemotron-4-15b [dense] — arXiv:2402.16819 (unverified tier).
32L d=6144 48H (GQA kv=8) ff=24576 vocab=256000; squared-ReLU, partial rotary.

The reference's sharding hint (``shard_kv``) belongs to the distributed
slice (ROADMAP A9) and is left out here."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense",
    n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=24_576,
    vocab=256_000, norm="layernorm", activation="relu2", rope_pct=0.5,
)
