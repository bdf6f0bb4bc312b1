"""xLSTM: mLSTM (matrix memory, chunkwise parallel) and sLSTM (scalar
memory, recurrent) blocks at ratio ``xlstm_m_per_s`` : 1, ported from
``repro.models.xlstm``.

The mLSTM trains in the chunked linear-attention form (the same segsum as
the SSD scan, dense f32 einsums inside a chunk, a loop over the chunks'
states), with the normalizer carried as an extra value channel (the
values augmented with the input gate) and divided out as max(|den|, 1).
Gating is the stabilized sigmoid variant (log-space decays), as in the
reference. The sLSTM is a loop over time steps with the exponential
gating stabilizer ``m``, which starts at 0, as the reference's
``slstm_init_state`` starts it.

Parameters keep the reference's tree (``supers/mlstm/*`` stacked
(n_super, m_per_s, ...), ``supers/slstm/*`` (n_super, ...)); the Builder
paths are the reference's (``/supers/sb{i}/m{j}/qkv``,
``/supers/sb{i}/s/wx``), so the supports match it. Every linear runs
through ``apply_linear`` in the config's exec mode; the recurrences are
plain PyTorch, as in the reference they are XLA.

Serving keeps the contiguous cache only, as the reference (no
``prefill_step``): per mLSTM block the (b, h, hd, hd + 1) state ``C``, per
sLSTM block {h, c, n, m} (b, heads, d / heads), all f32. A decode step
writes the new states into the cache in place and returns it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models.common import (Builder, apply_linear,
                                       contiguous_only, init_model,
                                       remat_wrap, rms_norm, silu,
                                       stack_layers, unstack)
from repro_torch.models.mamba2 import _prev_states, _segsum, softplus


def log_sigmoid(x):
    """-softplus(-x), as ``jax.nn.log_sigmoid`` writes it."""
    return -softplus(-x)


# ---------------------------------------------------------------------------
# mLSTM cell, chunkwise parallel
# ---------------------------------------------------------------------------

def mlstm_chunked(q, k, v, i_gate, f_gate, chunk: int):
    """q, k, v (b, s, h, p); i_gate, f_gate (b, s, h) raw logits. Returns
    y (b, s, h, p) in q's dtype and the final (C, n) state (b, h, p,
    p + 1) in f32."""
    b, s_orig, h, p = q.shape
    f32 = torch.float32
    a_log = log_sigmoid(f_gate)                        # per-step log decay
    i_val = torch.sigmoid(i_gate)
    # the values augmented with a ones channel: the normalizer rides along
    v_aug = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1) \
        * i_val[..., None]                                          # (b,s,h,p+1)

    chunk = min(chunk, s_orig)
    pad = (-s_orig) % chunk
    if pad:
        p4 = (0, 0, 0, 0, 0, pad)
        q = torch.nn.functional.pad(q, p4)
        k = torch.nn.functional.pad(k, p4)
        v_aug = torch.nn.functional.pad(v_aug, p4)
        a_log = torch.nn.functional.pad(a_log, (0, 0, 0, pad))
    s = s_orig + pad
    nc = s // chunk
    qc = q.reshape(b, nc, chunk, h, p).to(f32)
    kc = k.reshape(b, nc, chunk, h, p).to(f32)
    vc = v_aug.reshape(b, nc, chunk, h, p + 1).to(f32)
    ac = a_log.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)        # (b,h,c,l)

    a_cum = torch.cumsum(ac, dim=-1)
    L = torch.exp(_segsum(ac)).to(f32)                              # (b,h,c,l,l)
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", qc, kc, L, vc)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)
    states = torch.einsum("bclhn,bhcl,bclhp->bchnp", kc, decay_states, vc)
    prev, final = _prev_states(states, torch.exp(a_cum[..., -1]))
    y_off = torch.einsum("bclhn,bchnp,bhcl->bclhp", qc, prev,
                         torch.exp(a_cum))
    y_full = (y_diag + y_off).reshape(b, s, h, p + 1)[:, :s_orig]
    num, den = y_full[..., :p], y_full[..., p]
    y = num / torch.clamp_min(den.abs(), 1.0)[..., None]
    return y.to(q.dtype), final


def mlstm_step(state, q_t, k_t, v_t, i_t, f_t):
    """One token. state (b, h, p, p + 1) f32; q_t, k_t, v_t (b, h, p);
    gates (b, h). Returns (y (b, h, p) in q_t's dtype, the new state)."""
    f32 = torch.float32
    dec = torch.exp(log_sigmoid(f_t))[..., None, None]
    ival = torch.sigmoid(i_t)[..., None]
    v_aug = torch.cat([v_t, torch.ones_like(v_t[..., :1])], dim=-1) * ival
    upd = torch.einsum("bhn,bhp->bhnp", k_t.to(f32), v_aug.to(f32))
    new = state * dec + upd
    y_full = torch.einsum("bhn,bhnp->bhp", q_t.to(f32), new)
    num, den = y_full[..., :-1], y_full[..., -1]
    y = num / torch.clamp_min(den.abs(), 1.0)[..., None]
    return y.to(q_t.dtype), new


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def init_mlstm_block(b: Builder, cfg: ModelConfig):
    d = cfg.d_model
    d_inner = 2 * d
    h = cfg.n_heads
    params, consts = {}, {}
    params["ln"] = b.tensor("ln", (d,), "ones")
    for name, di, do in (("up", d, 2 * d_inner), ("qkv", d_inner, 3 * d_inner),
                         ("down", d_inner, d)):
        params[name], c = b.linear(name, di, do)
        if c:
            consts[name] = c
    params["gates"] = {"w": b.tensor("gates_w", (d_inner, 2 * h), "normal",
                                     fan_in=d_inner),
                       "b": b.tensor("gates_b", (2 * h,), "zeros",
                                     dtype=torch.float32)}
    params["out_norm"] = b.tensor("out_norm", (d_inner,), "ones")
    return params, consts


def apply_mlstm_block(cfg: ModelConfig, p, c, x, *, cache=None):
    """One mLSTM block with its residual: (x', new cache or None).
    ``k / sqrt(hd)`` promotes a bf16 k to f32, as the reference's division
    by a numpy scalar does."""
    d_inner = 2 * cfg.d_model
    h = cfg.n_heads
    hd = d_inner // h
    lin = lambda n, t: apply_linear(cfg, p[n], c.get(n, {}), t)
    res = x
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    xm, z = lin("up", xn).chunk(2, dim=-1)
    q, k, v = lin("qkv", xm).chunk(3, dim=-1)
    split = lambda t: t.reshape(*t.shape[:-1], h, hd)
    q, k, v = split(q), split(k.float() / math.sqrt(hd)), split(v)
    gates = (xm @ p["gates"]["w"].to(xm.dtype)).float() + p["gates"]["b"]
    i_gate, f_gate = gates.chunk(2, dim=-1)                         # (b,s,h)
    if cache is None:
        y, _ = mlstm_chunked(q, k, v, i_gate, f_gate, cfg.ssm.chunk)
        new_cache = None
    else:
        y_t, new_state = mlstm_step(cache["C"], q[:, 0], k[:, 0], v[:, 0],
                                    i_gate[:, 0], f_gate[:, 0])
        y = y_t[:, None]
        new_cache = {"C": new_state}
    y = y.reshape(*y.shape[:-2], d_inner)
    y = rms_norm(y, p["out_norm"], cfg.norm_eps) * silu(z)
    return res + lin("down", y), new_cache


def slstm_ffn_width(cfg: ModelConfig) -> int:
    """The sLSTM block's gated FFN width: 4/3 · d rounded up to 64."""
    return ((int(cfg.d_model * 4 / 3) + 63) // 64) * 64


def init_slstm_block(b: Builder, cfg: ModelConfig):
    d = cfg.d_model
    h = cfg.n_heads
    hd = d // h
    params, consts = {}, {}
    params["ln"] = b.tensor("ln", (d,), "ones")
    params["wx"], c = b.linear("wx", d, 4 * d)    # i, f, z, o pre-activations
    if c:
        consts["wx"] = c
    # block-diagonal recurrent weights, (4, h, hd, hd)
    params["R"] = b.tensor("R", (4, h, hd, hd), "normal", fan_in=hd)
    params["bias"] = b.tensor("bias", (4 * d,), "zeros", dtype=torch.float32)
    f = slstm_ffn_width(cfg)
    for name, di, do in (("gate", d, f), ("up", d, f), ("down", f, d)):
        params[f"ffn_{name}"], c = b.linear(f"ffn_{name}", di, do)
        if c:
            consts[f"ffn_{name}"] = c
    params["ln_ffn"] = b.tensor("ln_ffn", (d,), "ones")
    return params, consts


def _slstm_scan(cfg: ModelConfig, p, xg, state):
    """xg (b, s, 4d) pre-activations; state {h, c, n, m} of (b, heads,
    hd). Returns (ys (b, s, heads, hd) f32, the final state)."""
    heads = cfg.n_heads
    hd = cfg.d_model // heads
    R = p["R"].float()
    st = state
    ys = []
    for x_t in xg.float().unbind(1):                        # (b, 4d) a step
        rec = torch.einsum("bhd,khde->kbhe", st["h"], R)    # (4, b, h, hd)
        x4 = x_t.reshape(-1, 4, heads, hd).transpose(0, 1)
        it, ft, zt, ot = (x4 + rec).float().unbind(0)
        m_new = torch.maximum(ft + st["m"], it)
        i = torch.exp(it - m_new)
        f = torch.exp(ft + st["m"] - m_new)
        c_new = f * st["c"] + i * torch.tanh(zt)
        n_new = f * st["n"] + i
        h_new = torch.sigmoid(ot) * c_new / torch.clamp_min(n_new, 1.0)
        st = {"h": h_new, "c": c_new, "n": n_new, "m": m_new}
        ys.append(h_new)
    return torch.stack(ys, dim=1), st


def slstm_init_state(cfg: ModelConfig, batch: int, device):
    """Zeros {h, c, n, m} (batch, heads, d / heads) f32; ``m`` starts at 0,
    as the reference's does."""
    shape = (batch, cfg.n_heads, cfg.d_model // cfg.n_heads)
    return {k: torch.zeros(shape, dtype=torch.float32, device=device)
            for k in ("h", "c", "n", "m")}


def apply_slstm_block(cfg: ModelConfig, p, c, x, *, cache=None):
    """One sLSTM block (the recurrence, then the gated FFN, each with its
    residual): (x', new cache or None)."""
    lin = lambda n, t: apply_linear(cfg, p[n], c.get(n, {}), t)
    res = x
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    xg = lin("wx", xn).float() + p["bias"]
    state = cache["s"] if cache is not None else \
        slstm_init_state(cfg, x.shape[0], x.device)
    ys, new_state = _slstm_scan(cfg, p, xg, state)
    x = res + ys.reshape(x.shape).to(x.dtype)
    hn = rms_norm(x, p["ln_ffn"], cfg.norm_eps)
    down = lin("ffn_down", silu(lin("ffn_gate", hn)) * lin("ffn_up", hn))
    return x + down, ({"s": new_state} if cache is not None else None)


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

def _xlstm_counts(cfg: ModelConfig):
    """(blocks a super block, super blocks)."""
    per = cfg.xlstm_m_per_s + 1
    if cfg.n_layers % per:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of the super block's {per}")
    return per, cfg.n_layers // per


def _build_xlstm(cfg: ModelConfig, b: Builder):
    _, n_super = _xlstm_counts(cfg)
    d = cfg.d_model
    params, consts = {}, {}
    params["embed"] = b.tensor("embed", (cfg.padded_vocab, d), "normal",
                               fan_in=d)

    def super_block(bb: Builder):
        mp, mc = stack_layers(bb, lambda b2: init_mlstm_block(b2, cfg),
                              cfg.xlstm_m_per_s, "m")
        sp, sc = init_slstm_block(bb.sub("s"), cfg)
        out_c = {}
        if mc:
            out_c["mlstm"] = mc
        if sc:
            out_c["slstm"] = sc
        return {"mlstm": mp, "slstm": sp}, out_c

    params["supers"], cs = stack_layers(b.sub("supers"), super_block, n_super,
                                        "sb")
    if cs:
        consts["supers"] = cs
    params["ln_f"] = b.tensor("ln_f", (d,), "ones")
    params["lm_head"] = b.tensor("lm_head", (d, cfg.padded_vocab), "normal",
                                 fan_in=d)
    return params, consts


def init_xlstm(cfg: ModelConfig, seed: int = 0, *, device="cuda",
               workers: Optional[int] = None, obs=None):
    """(params, consts) on ``device``, supports bit for bit the
    reference's ``init_xlstm(cfg, key, seed)``; values from a
    ``torch.Generator`` seeded with ``seed`` (``common.init_model``)."""
    _xlstm_counts(cfg)
    return init_model(cfg, seed, lambda b: _build_xlstm(cfg, b),
                      device=device, workers=workers, obs=obs)


def _supers(cfg, params, consts):
    _, n_super = _xlstm_counts(cfg)
    return list(zip(unstack(params["supers"], n_super),
                    unstack(consts.get("supers", {}), n_super)))


def _mlstms(cfg, p, c):
    m = cfg.xlstm_m_per_s
    return list(zip(unstack(p["mlstm"], m), unstack(c.get("mlstm", {}), m)))


def _head(cfg, params, h):
    h = rms_norm(h, params["ln_f"], cfg.norm_eps)
    return h @ params["lm_head"].to(h.dtype)


def apply_xlstm(cfg: ModelConfig, params, consts, tokens, *,
                remat: str = "none"):
    """tokens (B, S) → (logits (B, S, V), 0.0): each super block (its
    mLSTM blocks, then its sLSTM block) under the ``remat`` policy."""
    h = params["embed"][tokens.long()]

    def super_body(p, c, x):
        for mp, mc in _mlstms(cfg, p, c):
            x, _ = apply_mlstm_block(cfg, mp, mc, x)
        x, _ = apply_slstm_block(cfg, p["slstm"], c.get("slstm", {}), x)
        return x

    step = remat_wrap(super_body, remat)
    for p, c in _supers(cfg, params, consts):
        h = step(p, c, h)
    return _head(cfg, params, h), 0.0


def init_xlstm_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                     paged: bool = False, device="cuda", **_):
    """Zeros, all f32: ``supers.mlstm.C`` (n_super, m_per_s, B, h, hd,
    hd + 1) and ``supers.slstm.s`` {h, c, n, m} (n_super, B, heads, d /
    heads). ``max_len`` sizes nothing: the states do not grow."""
    contiguous_only(paged)
    device = resolve(device)
    _, n_super = _xlstm_counts(cfg)
    h = cfg.n_heads
    hd = 2 * cfg.d_model // h
    f32 = torch.float32
    slstm = {k: v.unsqueeze(0).repeat(n_super, 1, 1, 1)
             for k, v in slstm_init_state(cfg, batch, device).items()}
    return {"supers": {
        "mlstm": {"C": torch.zeros((n_super, cfg.xlstm_m_per_s, batch, h, hd,
                                    hd + 1), dtype=f32, device=device)},
        "slstm": {"s": slstm},
    }}


def xlstm_decode_step(cfg: ModelConfig, params, consts, tokens, cache,
                      index, *, block_table=None):
    """One decode step: tokens (B, 1) through every block's recurrence
    (``index`` is not read: the states carry the position). Returns
    (logits, cache), the cache updated in place."""
    contiguous_only(block_table)
    h = params["embed"][tokens.long()]
    sc = cache["supers"]
    for i, (p, c) in enumerate(_supers(cfg, params, consts)):
        for j, (mp, mc) in enumerate(_mlstms(cfg, p, c)):
            C = sc["mlstm"]["C"][i, j]
            h, new = apply_mlstm_block(cfg, mp, mc, h, cache={"C": C})
            C.copy_(new["C"])
        s = {k: v[i] for k, v in sc["slstm"]["s"].items()}
        h, new = apply_slstm_block(cfg, p["slstm"], c.get("slstm", {}), h,
                                   cache={"s": s})
        for k, v in new["s"].items():
            s[k].copy_(v)
    return _head(cfg, params, h), cache
