"""deepseek-moe-16b — 28L d_model=2048 16H (MHA kv=16) d_ff(expert)=1408,
vocab=102400, 64 routed experts top-6 + 2 shared, first layer dense
(fine-grained expert segmentation). [arXiv:2401.06066; hf]
Copied from ``repro.configs.deepseek_moe_16b``."""
from repro_torch.configs.base import ModelConfig, MoEConfig, ParamConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=102400,
    max_seq_len=4096,
    tie_embeddings=False,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared_experts=2, d_ff_expert=1408,
                  first_k_dense=1, d_ff_dense=10944),
    param=ParamConfig(mode="sltrain", rank=512, delta=0.03, alpha=8.0),
)

SMOKE = ModelConfig(
    name="deepseek-moe-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=0,
    vocab_size=512,
    vocab_pad_multiple=16,
    max_seq_len=128,
    tie_embeddings=False,
    moe=MoEConfig(n_experts=8, top_k=2, n_shared_experts=1, d_ff_expert=32,
                  first_k_dense=1, d_ff_dense=128),
    param=ParamConfig(mode="sltrain", rank=8, delta=0.05, alpha=8.0),
)
