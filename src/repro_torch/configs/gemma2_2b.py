"""gemma2-2b — 26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216
vocab=256000; local+global alternating attention, attn/final logit softcaps,
pre+post RMSNorms with (1+w) scaling. [arXiv:2408.00118; hf]
Copied from ``repro.configs.gemma2_2b``."""
from repro_torch.configs.base import ModelConfig, ParamConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="gemma2",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    max_seq_len=8192,
    sliding_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    use_post_norms=True,
    query_pre_attn_scalar=256.0,
    attn_pattern=("local", "global"),
    tie_embeddings=True,
    param=ParamConfig(mode="sltrain", rank=576, delta=0.03, alpha=8.0),
)

SMOKE = ModelConfig(
    name="gemma2-smoke",
    family="gemma2",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab_size=512,
    vocab_pad_multiple=16,
    max_seq_len=128,
    sliding_window=32,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    use_post_norms=True,
    attn_pattern=("local", "global"),
    tie_embeddings=True,
    param=ParamConfig(mode="sltrain", rank=8, delta=0.05, alpha=8.0),
)
