"""xlstm-350m — 24L d_model=1024 4H, mLSTM + sLSTM blocks at 7:1,
vocab=50304 (d_ff=0: blocks define their own projections).
[arXiv:2405.04517; unverified]
Copied from ``repro.configs.xlstm_350m``."""
from repro_torch.configs.base import ModelConfig, ParamConfig, SSMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="xlstm",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    max_seq_len=4096,
    tie_embeddings=False,
    xlstm_m_per_s=7,
    ssm=SSMConfig(chunk=128),
    param=ParamConfig(mode="sltrain", rank=256, delta=0.03, alpha=8.0),
)

SMOKE = ModelConfig(
    name="xlstm-smoke",
    family="xlstm",
    n_layers=4,          # 2 supers of (1 mLSTM + 1 sLSTM)
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=512,
    vocab_pad_multiple=16,
    max_seq_len=128,
    tie_embeddings=False,
    xlstm_m_per_s=1,
    ssm=SSMConfig(chunk=32),
    param=ParamConfig(mode="sltrain", rank=8, delta=0.05, alpha=8.0),
)
