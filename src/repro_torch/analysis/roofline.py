"""Model FLOPs (6·N·D) and training MFU, ported from
``repro.analysis.roofline`` (``param_count_active``, ``model_flops``,
``train_mfu``; the HLO-based roofline of the reference is not ported).

``PEAK_FLOPS`` is the NVIDIA H100 SXM's dense bf16 tensor-core rate from
NVIDIA's data sheet (989 TFLOP/s at the full 700 W power limit), not a
measurement; a card set below 700 W runs slower under load.
"""
from __future__ import annotations

from typing import Tuple

PEAK_FLOPS = 989e12        # bf16 FLOP/s per card (H100 SXM data sheet)


def param_count_active(cfg) -> Tuple[float, float]:
    """(total_params, active_params) analytic estimate for 6·N·D: the dense
    model's matrix sizes, as the reference counts them, for the llama,
    gemma2 and vlm families (gemma2's post-norms and biases are not
    counted, as the reference counts neither). The MoE and SSM counts wait
    for their families (ROADMAP queue A items 9b and 9)."""
    if cfg.family not in ("llama", "gemma2", "vlm") or cfg.moe.n_experts \
            or not cfg.d_ff:
        raise NotImplementedError(
            f"param_count_active: {cfg.name} (family {cfg.family!r}) is not "
            "ported yet (ROADMAP queue A item 9b: MoE; item 9: the SSM and "
            "encoder families)")
    d, L, V = cfg.d_model, cfg.n_layers, cfg.padded_vocab
    hd = cfg.resolved_head_dim
    attn = d * (cfg.n_heads * hd) + 2 * d * (cfg.n_kv_heads * hd) \
        + (cfg.n_heads * hd) * d
    ffn = 3 * d * cfg.d_ff
    total = L * (attn + ffn) + (V * d if cfg.tie_embeddings else 2 * V * d)
    return float(total), float(total)


def model_flops(cfg, n_tokens: int, kind: str = "train") -> float:
    """6·N·D for training; 2·N·D for one forward (prefill/decode)."""
    _, active = param_count_active(cfg)
    mult = 6.0 if kind == "train" else 2.0
    return mult * active * n_tokens


def train_mfu(cfg, n_tokens: int, dt_s: float, chips: int = 1) -> float:
    """Model FLOPs utilisation of one training step: the 6·N·D model
    FLOPs delivered per second as a fraction of the cards' peak
    (``PEAK_FLOPS`` each). The trainer publishes it as ``train.mfu``."""
    if dt_s <= 0:
        return 0.0
    return model_flops(cfg, n_tokens, "train") / dt_s / (chips * PEAK_FLOPS)
