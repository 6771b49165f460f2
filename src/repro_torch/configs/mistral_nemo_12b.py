"""mistral-nemo-12b [dense] — hf:mistralai/Mistral-Nemo-Base-2407 (hf tier).
40L d=5120 32H (GQA kv=8) ff=14336 vocab=131072; head_dim=128 (not d/H)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_ff=14_336,
    vocab=131_072, head_dim_=128, rope_theta=1_000_000.0,
)
