"""Feed-forward blocks, ported from ``repro.models.mlp``: the dense gated
MLP (SwiGLU, GeGLU, plain) and the top-k MoE block with shared experts
(deepseek and qwen3 style) and capacity-based dispatch.

The MoE block keeps the reference's routing bit for bit in f32: softmax
of the router logits in f32, top-k with the lower expert index first on
ties (a stable descending sort), renormalized gates, the capacity
``int(max(1, cf·Ng·k/E))`` capped at Ng·k, each (token, k) slot's rank in
its expert's queue from a stable sort by expert id, overflowing slots
dropped (gate 0). The experts run as one stack: in exec_mode fused every
expert linear of a layer is one grouped ``sl_matmul`` launch
(``kernels/ops.sl_linear_grouped``), in exec_mode sparse one grouped
``sparse_matmul`` launch (``ops.sl_decode_grouped``, or
``ops.sl_sparse_linear_grouped`` where a gradient is wanted) and in
exec_mode quant one grouped ``quant_sparse_matmul`` launch
(``ops.sl_quant_decode_grouped``): the reference's Pallas calls batched
under its vmap. exec_mode dense loops over the stack, each expert's slice
through ``apply_linear``. The combine is deterministic: each token sums
its k weighted expert outputs in f32 in k order, where the reference
scatter-adds them (its order is XLA's), so the two agree to f32
rounding, not bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (Builder, apply_linear, gelu, silu,
                                       stack_layers, unstack)

_ACTS = {"silu": silu, "gelu": gelu}


# ---------------------------------------------------------------------------
# Dense gated MLP
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def init_moe(b: Builder, cfg: ModelConfig):
    """The router (full rank: ``adapted=False``), the experts' gated MLPs
    stacked on a leading axis at ``expert{e}``, and the shared experts as
    one gated MLP of ``d_ff_expert · n_shared_experts`` at ``shared``, in
    the reference's Builder order."""
    m = cfg.moe
    d, fe = cfg.d_model, m.d_ff_expert
    params, consts = {}, {}
    params["router"], _ = b.linear("router", d, m.n_experts, adapted=False)
    params["experts"], cexp = stack_layers(
        b, lambda be: init_mlp(be, cfg, d_ff=fe, gated=True), m.n_experts,
        "expert")
    if cexp:
        consts["experts"] = cexp
    if m.n_shared_experts:
        params["shared"], csh = init_mlp(
            b.sub("shared"), cfg, d_ff=fe * m.n_shared_experts, gated=True)
        if csh:
            consts["shared"] = csh
    return params, consts


def _expert_linear(cfg: ModelConfig, p, c, x):
    """x (E, M, d_in) through the stack of E linears ``p``/``c`` (leaves
    with a leading expert axis) → (E, M, d_out): one grouped launch of
    the kernels in exec_mode fused, sparse and quant (what each mode's
    single linear checks, ``core.sltrain.sl_matmul`` checks here), else
    each expert's slice through ``apply_linear``."""
    pc = cfg.param
    mode = pc.exec_mode
    if pc.mode == "sltrain" and mode != "dense" and "B" in p:
        from repro_torch.core import sltrain
        from repro_torch.kernels import ops
        scale = pc.alpha / p["B"].shape[-1]
        needs_grad = sltrain.check_exec_consts(mode, x, p, c)
        if mode == "quant":
            return ops.sl_quant_decode_grouped(
                x, p["B"], p["A"], c["qv_t"], c["rows_q"], c["cols_q"],
                c["qscale"], scale)
        if mode == "sparse" and not needs_grad:
            return ops.sl_decode_grouped(
                x, p["B"], p["A"],
                ops._gather_tiles_grouped(p["v"], c["perm"]), c["rows_t"],
                c["cols_t"], scale)
        linear = ops.sl_linear_grouped if mode == "fused" else \
            ops.sl_sparse_linear_grouped
        return linear(x, p["B"], p["A"], p["v"], c["rows_t"], c["cols_t"],
                      c["perm"], scale, rows_tT=c.get("rows_tT"),
                      cols_tT=c.get("cols_tT"))
    n = x.shape[0]
    cs = unstack(c, n) if c else [{}] * n
    return torch.stack([apply_linear(cfg, pe, ce, xe) for pe, ce, xe in
                        zip(unstack(p, n), cs, x)])


def _expert_mlp(cfg: ModelConfig, p, c, x):
    """The experts' SwiGLU over their stack: x (E, M, d) → (E, M, d)."""
    lin = lambda n, t: _expert_linear(cfg, p[n], c.get(n, {}), t)
    return lin("down", silu(lin("gate", x)) * lin("up", x))


def route(cfg: ModelConfig, probs, capacity_factor: float = 1.25):
    """The reference's capacity dispatch for router probabilities ``probs``
    (G, Ng, E) f32: (gate_vals (G, Ng, k) f32, renormalized and 0 where
    dropped; expert_ids (G, Ng, k); slot (G, Ng, k), the slot's place in
    its expert's queue or ``cap`` where dropped; keep; cap)."""
    m = cfg.moe
    g, ng, _ = probs.shape
    k = m.top_k
    # top-k, the lower index first on ties (jax.lax.top_k's order)
    srt, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_ids = srt[..., :k], ids[..., :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    cap = int(max(1, capacity_factor * ng * k / m.n_experts))
    cap = min(cap, ng * k)
    # each (token, k) slot's position in its expert's queue: a stable sort
    # by expert id, the rank inside each run of equal ids
    nk = ng * k
    flat_e = expert_ids.reshape(g, nk)
    order = torch.argsort(flat_e, dim=1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    idx = torch.arange(nk, device=probs.device).expand(g, nk)
    is_new = torch.cat([torch.ones((g, 1), dtype=torch.bool,
                                   device=probs.device),
                        sorted_e[:, 1:] != sorted_e[:, :-1]], dim=1)
    start = torch.cummax(torch.where(is_new, idx, 0), dim=1).values
    pos = torch.empty_like(flat_e).scatter_(1, order, idx - start)
    pos = pos.reshape(g, ng, k)
    keep = pos < cap
    gate_vals = torch.where(keep, gate_vals, torch.zeros_like(gate_vals))
    slot = torch.where(keep, pos, torch.full_like(pos, cap))
    return gate_vals, expert_ids, slot, keep, cap


def apply_moe(cfg: ModelConfig, params, consts, x,
              capacity_factor: float = 1.25):
    """Group-local top-k dispatch with capacity (the reference's
    ``apply_moe``): x (B, S, d) → (y (B, S, d), aux f32). The tokens split
    into ``cfg.moe_groups`` groups (one when the count does not divide);
    each expert takes at most ``cap`` of a group's (token, k) slots in
    token order, the rest are dropped. aux is the Switch load-balancing
    loss, E · Σ_e mean(probs)_e · (top-1 share)_e."""
    m = cfg.moe
    bsz, seq, d = x.shape
    n = bsz * seq
    g = max(1, cfg.moe_groups)
    if n % g:
        g = 1
    ng = n // g
    n_exp = m.n_experts
    dev = x.device
    xg = x.reshape(g, ng, d)
    logits = apply_linear(cfg, params["router"], {}, xg, adapted=False)
    probs = torch.softmax(logits.float(), dim=-1)                # (G,Ng,E)
    gate_vals, expert_ids, slot, keep, cap = route(cfg, probs,
                                                   capacity_factor)

    # the (G, E, cap) token of each expert's slot; the pad row ng (zeros)
    # where a slot is empty. Dropped (token, k) pairs all write the trash
    # slot cap, which is cut off.
    tok = torch.arange(ng, device=dev).view(1, ng, 1).expand_as(slot)
    gather_idx = torch.full((g, n_exp * (cap + 1)), ng, dtype=torch.long,
                            device=dev)
    gather_idx.scatter_(1, (expert_ids * (cap + 1) + slot).reshape(g, -1),
                        tok.reshape(g, -1))
    gather_idx = gather_idx.view(g, n_exp, cap + 1)[:, :, :cap]
    xg_pad = torch.cat([xg, torch.zeros((g, 1, d), dtype=x.dtype,
                                        device=dev)], dim=1)
    g_iota = torch.arange(g, device=dev).view(g, 1, 1)
    xe = xg_pad[g_iota, gather_idx]                          # (G,E,cap,d)

    xe_t = xe.transpose(0, 1).reshape(n_exp, g * cap, d).contiguous()
    ye_t = _expert_mlp(cfg, params["experts"], consts.get("experts", {}),
                       xe_t)
    ye = ye_t.reshape(n_exp, g, cap, d).transpose(0, 1)      # (G,E,cap,d)

    # combine: each token's k slots, weighted in f32, summed in k order
    got = ye[g_iota, expert_ids, slot.clamp(max=cap - 1)].float()
    got = got * gate_vals[..., None]
    got = torch.where(keep[..., None], got, torch.zeros_like(got))
    y = got[:, :, 0]
    for j in range(1, m.top_k):
        y = y + got[:, :, j]
    y = y.to(x.dtype)
    if m.n_shared_experts:
        y = y + apply_mlp(cfg, params["shared"], consts.get("shared", {}),
                          xg)

    # the Switch aux loss, the top-1 counts by comparison (exact)
    frac_prob = probs.mean(dim=(0, 1))
    top1 = expert_ids[..., 0].reshape(-1, 1)
    counts = (top1 == torch.arange(n_exp, device=dev)).sum(
        0, dtype=torch.float32)
    aux = n_exp * torch.sum(frac_prob * (counts / (g * ng)))
    return y.reshape(bsz, seq, d), aux
