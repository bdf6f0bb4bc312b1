"""qwen2.5-32b — 64L d_model=5120 40H (GQA kv=8, head_dim=128) d_ff=27648
vocab=152064, QKV bias. [hf:Qwen/Qwen2.5 family; hf]
Copied from ``repro.configs.qwen2_5_32b``."""
from repro_torch.configs.base import ModelConfig, ParamConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="llama",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=27648,
    vocab_size=152064,
    max_seq_len=32768,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=False,
    param=ParamConfig(mode="sltrain", rank=1280, delta=0.03, alpha=8.0),
)

SMOKE = ModelConfig(
    name="qwen2.5-smoke",
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
    qkv_bias=True,
    tie_embeddings=False,
    param=ParamConfig(mode="sltrain", rank=8, delta=0.05, alpha=8.0),
)
