"""llama3-405b — 126L d_model=16384 128H (GQA kv=8, head_dim=128)
d_ff=53248 vocab=128256. [arXiv:2407.21783; unverified]
Copied from ``repro.configs.llama3_405b``."""
from repro_torch.configs.base import ModelConfig, ParamConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="llama",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    head_dim=128,
    d_ff=53248,
    vocab_size=128256,
    max_seq_len=8192,
    rope_theta=500_000.0,
    tie_embeddings=False,
    param=ParamConfig(mode="sltrain", rank=4096, delta=0.03, alpha=8.0),
)

SMOKE = ModelConfig(
    name="llama3-smoke",
    family="llama",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab_size=512,
    vocab_pad_multiple=16,
    max_seq_len=128,
    tie_embeddings=False,
    param=ParamConfig(mode="sltrain", rank=8, delta=0.05, alpha=8.0),
)
