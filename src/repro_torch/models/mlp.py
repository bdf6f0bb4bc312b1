"""Dense feed-forward blocks (SwiGLU, GeGLU, plain), ported from
``repro.models.mlp``. The MoE block is not ported yet (ROADMAP queue A
item 9b)."""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Builder, apply_linear, gelu, silu

_ACTS = {"silu": silu, "gelu": gelu}


def init_mlp(b: Builder, cfg: ModelConfig, d_ff: int = 0,
             gated: bool = True):
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    params, consts = {}, {}
    names = (("gate", d, f), ("up", d, f), ("down", f, d)) if gated else \
            (("up", d, f), ("down", f, d))
    for name, di, do in names:
        p, c = b.linear(name, di, do)
        params[name] = p
        if c:
            consts[name] = c
    return params, consts


def apply_mlp(cfg: ModelConfig, params, consts, x, act: str = "silu"):
    """down(act(gate(x)) * up(x)), or down(act(up(x))) without a gate;
    ``act`` "silu" (SwiGLU) or "gelu" (GeGLU, the gemma families)."""
    lin = lambda n, t: apply_linear(cfg, params[n], consts.get(n, {}), t)
    a = _ACTS[act]
    if "gate" in params:
        return lin("down", a(lin("gate", x)) * lin("up", x))
    return lin("down", a(lin("up", x)))
