"""qwen3-moe-235b-a22b — 94L d_model=4096 64H (GQA kv=4, head_dim=128)
d_ff(expert)=1536, vocab=151936, MoE 128 experts top-8, QK-norm.
[hf:Qwen/Qwen3-30B-A3B family scaling; hf]
Copied from ``repro.configs.qwen3_moe_235b``."""
from repro_torch.configs.base import ModelConfig, MoEConfig, ParamConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=0,
    vocab_size=151936,
    max_seq_len=32768,
    rope_theta=1_000_000.0,
    qk_norm=True,
    tie_embeddings=False,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=1536),
    param=ParamConfig(mode="sltrain", rank=1024, delta=0.03, alpha=8.0),
)

SMOKE = ModelConfig(
    name="qwen3-moe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=0,
    vocab_size=512,
    vocab_pad_multiple=16,
    max_seq_len=128,
    qk_norm=True,
    tie_embeddings=False,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32),
    param=ParamConfig(mode="sltrain", rank=8, delta=0.05, alpha=8.0),
)
