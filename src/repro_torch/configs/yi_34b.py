"""yi-34b — 60L d_model=7168 56H (GQA kv=8, head_dim=128) d_ff=20480
vocab=64000, llama-arch GQA. [arXiv:2403.04652; hf]
Copied from ``repro.configs.yi_34b``."""
from repro_torch.configs.base import ModelConfig, ParamConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="llama",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    max_seq_len=4096,
    rope_theta=5_000_000.0,
    tie_embeddings=False,
    param=ParamConfig(mode="sltrain", rank=1792, delta=0.03, alpha=8.0),
)

SMOKE = ModelConfig(
    name="yi-smoke",
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
