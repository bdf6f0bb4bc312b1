"""paligemma-3b — gemma backbone: 18L d_model=2048 8H (MQA kv=1,
head_dim=256) d_ff=16384 vocab=257216; SigLIP frontend is a STUB providing
precomputed patch embeddings (DESIGN §5). [arXiv:2407.07726; hf]
Copied from ``repro.configs.paligemma_3b``."""
from repro_torch.configs.base import ModelConfig, ParamConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    max_seq_len=8192,
    tie_embeddings=True,
    n_patches=256,
    param=ParamConfig(mode="sltrain", rank=512, delta=0.03, alpha=8.0),
)

SMOKE = ModelConfig(
    name="paligemma-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=160,
    vocab_size=512,
    vocab_pad_multiple=16,
    max_seq_len=128,
    tie_embeddings=True,
    n_patches=8,
    param=ParamConfig(mode="sltrain", rank=8, delta=0.05, alpha=8.0),
)
