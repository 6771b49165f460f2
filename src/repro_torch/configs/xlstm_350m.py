"""xlstm-350m [ssm] — arXiv:2405.04517 (unverified tier).
24L d=1024 4H ff=0 vocab=50304; mLSTM:sLSTM 7:1 block interleave.

The reference's sharding hints (``shard_heads``, ``shard_kv``) and
``max_seq`` belong to slices the port has not taken yet and are left out
here."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50_304, pos_embed="none", rope_pct=0.0,
    block_pattern=("mlstm",) * 7 + ("slstm",),
)
