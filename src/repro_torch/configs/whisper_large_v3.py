"""whisper-large-v3 — enc-dec, 32+32L d_model=1280 20H (MHA kv=20,
head_dim=64) d_ff=5120 vocab=51866; conv frontend is a STUB providing
precomputed frame embeddings (1500 frames). Decoder position table is
extended to the assigned 32k shapes (DESIGN §5). [arXiv:2212.04356;
unverified]
Copied from ``repro.configs.whisper_large_v3``."""
from repro_torch.configs.base import ModelConfig, ParamConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="whisper",
    n_layers=32,
    encoder_layers=32,
    encoder_seq=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    max_seq_len=32768,
    qkv_bias=True,
    tie_embeddings=True,
    param=ParamConfig(mode="sltrain", rank=320, delta=0.03, alpha=8.0),
)

SMOKE = ModelConfig(
    name="whisper-smoke",
    family="whisper",
    n_layers=2,
    encoder_layers=2,
    encoder_seq=16,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=160,
    vocab_size=512,
    vocab_pad_multiple=16,
    max_seq_len=128,
    qkv_bias=True,
    tie_embeddings=True,
    param=ParamConfig(mode="sltrain", rank=8, delta=0.05, alpha=8.0),
)
