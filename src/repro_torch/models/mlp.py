"""Dense gated feed-forward block (SwiGLU), ported from
``repro.models.mlp``. The MoE block is not ported yet (ROADMAP queue A
item 9)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Builder, apply_linear, silu


def init_mlp(b: Builder, cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    params, consts = {}, {}
    for name, di, do in (("gate", d, f), ("up", d, f), ("down", f, d)):
        p, c = b.linear(name, di, do)
        params[name] = p
        if c:
            consts[name] = c
    return params, consts


def apply_mlp(cfg: ModelConfig, params, consts, x):
    lin = lambda n, t: apply_linear(cfg, params[n], consts.get(n, {}), t)
    return lin("down", silu(lin("gate", x)) * lin("up", x))
