"""zamba2-7b — 81L d_model=3584, Mamba2 blocks + ONE weight-shared attention
block (32H MHA) invoked every 6 layers with per-invocation low-rank
adapters; d_ff=14336, vocab=32000, ssm_state=64. [arXiv:2411.15242;
unverified]
Copied from ``repro.configs.zamba2_7b``."""
from repro_torch.configs.base import ModelConfig, ParamConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="mamba_hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    max_seq_len=4096,
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=64, conv_width=4, head_dim=64, expand=2, chunk=128),
    hybrid_attn_every=6,
    param=ParamConfig(mode="sltrain", rank=896, delta=0.03, alpha=8.0),
)

SMOKE = ModelConfig(
    name="zamba2-smoke",
    family="mamba_hybrid",
    n_layers=5,          # 2 supers of 2 + 1 tail
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=160,
    vocab_size=512,
    vocab_pad_multiple=16,
    max_seq_len=128,
    tie_embeddings=True,
    ssm=SSMConfig(state_dim=16, conv_width=4, head_dim=16, expand=2, chunk=32),
    hybrid_attn_every=2,
    param=ParamConfig(mode="sltrain", rank=8, delta=0.05, alpha=8.0),
)
