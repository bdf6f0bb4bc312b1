"""The paper's own LLaMA pretraining configs (60M–7B) with the paper's
SLTrain hyperparameters (§5.1): fixed support δ=0.03 (0.05 for 7B),
LoRA-init factors, α per model size. Copied from
``repro.configs.llama_paper``."""
import dataclasses

from repro_torch.configs.base import ModelConfig, ParamConfig


def _mk(name, n_layers, d_model, d_ff, n_heads, rank, alpha, delta=0.03):
    return ModelConfig(
        name=name,
        family="llama",
        n_layers=n_layers,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_heads,
        d_ff=d_ff,
        vocab_size=32000,
        vocab_pad_multiple=256,
        max_seq_len=256,
        tie_embeddings=False,
        param=ParamConfig(mode="sltrain", rank=rank, delta=delta, alpha=alpha),
    )


def smoke(cfg: ModelConfig) -> ModelConfig:
    """The tiny test variant every paper config ships as ``SMOKE``."""
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke", n_layers=2, d_model=64, d_ff=160,
        n_heads=4, n_kv_heads=4, vocab_size=512, vocab_pad_multiple=16,
        max_seq_len=128,
        param=dataclasses.replace(cfg.param, rank=8, delta=0.05))


LLAMA_60M = _mk("llama-60m", 8, 512, 1376, 8, rank=128, alpha=32.0)
LLAMA_130M = _mk("llama-130m", 12, 768, 2048, 12, rank=256, alpha=16.0)
LLAMA_350M = _mk("llama-350m", 24, 1024, 2736, 16, rank=256, alpha=16.0)
LLAMA_1B = _mk("llama-1b", 24, 2048, 5461, 32, rank=512, alpha=8.0)
LLAMA_7B = _mk("llama-7b", 32, 4096, 11008, 32, rank=1024, alpha=8.0, delta=0.05)

BY_SIZE = {"60m": LLAMA_60M, "130m": LLAMA_130M, "350m": LLAMA_350M,
           "1b": LLAMA_1B, "7b": LLAMA_7B}
