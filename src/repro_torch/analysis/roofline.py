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
    """(total_params, active_params) analytic estimate for 6·N·D, counted
    exactly as the reference counts it: per layer the attention's four
    projections and a gated MLP of ``d_ff`` (8·d² where ``d_ff`` is 0,
    the reference's "ssm-ish fallback"), plus the embedding and an untied
    head. With experts, the active count takes the top-k routed and the
    shared experts of each MoE layer and the dense prefix's MLPs. gemma2's
    post-norms and biases are not counted. For the zamba2 hybrid every
    layer counts as an attention + MLP block, for xLSTM as an attention
    block + 8·d², for whisper the decoder's layers only: the reference's
    analytic count, not the models' true parameter counts."""
    d, L, V = cfg.d_model, cfg.n_layers, cfg.padded_vocab
    hd = cfg.resolved_head_dim
    attn = d * (cfg.n_heads * hd) + 2 * d * (cfg.n_kv_heads * hd) \
        + (cfg.n_heads * hd) * d
    m = cfg.moe
    if m.n_experts > 0:
        expert = 3 * d * (m.d_ff_expert or cfg.d_ff)
        ffn_total = (m.n_experts + m.n_shared_experts) * expert
        ffn_active = (m.top_k + m.n_shared_experts) * expert
        dense_extra = m.first_k_dense * 3 * d * (m.d_ff_dense or cfg.d_ff)
        n_moe_layers = L - m.first_k_dense
        total = L * attn + n_moe_layers * ffn_total + dense_extra + 2 * V * d
        active = L * attn + n_moe_layers * ffn_active + dense_extra \
            + 2 * V * d
        return float(total), float(active)
    ffn = 3 * d * cfg.d_ff if cfg.d_ff else 8 * d * d   # ssm-ish fallback
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
