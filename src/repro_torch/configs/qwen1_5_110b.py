"""qwen1.5-110b [dense] — hf:Qwen/Qwen1.5-110B family (hf tier; QKV bias).
80L d=8192 64H (GQA kv=8) ff=49152 vocab=152064; head_dim 128 (d/H)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=49_152,
    vocab=152_064, qkv_bias=True, rope_theta=1_000_000.0,
)
