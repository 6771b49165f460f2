"""The paper's own benchmark configuration (§4.1): one layer, hidden 2048, 32
heads of 64 (the paper also runs 16 heads of 128 at the same hidden size),
ff 5632, vocab 32000; RMSNorm, SiLU, RoPE. Total tokens 16384, seqs
512..16k."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dash-paper", family="dense",
    n_layers=1, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab=32_000, head_dim_=64,
)
