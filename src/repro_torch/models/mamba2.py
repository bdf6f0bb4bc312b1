"""Mamba2 (SSD) mixer and the zamba2-style hybrid model, ported from
``repro.models.mamba2``.

The SSD scan is the chunked matmul formulation (Mamba-2 paper §6): the
intra-chunk work is dense einsums in f32 and the inter-chunk recurrence a
short loop over the chunks' states, which emits each chunk's *previous*
state as the reference's ``lax.scan`` does. ``_segsum`` keeps the
reference's formulation (differences of cumsums, -inf above the
diagonal, ``exp`` after the mask), so its backward never meets 0 · inf.

zamba2 hybrid: runs of ``hybrid_attn_every`` Mamba blocks (a super block),
each followed by an invocation of ONE weight-shared attention + MLP block
that reads concat(hidden, embeddings) through the shared ``in_proj`` plus
the super block's own low-rank adapter (B zero-initialized, A Kaiming);
the layers past the last whole super block form a tail of Mamba blocks.

Parameters keep the reference's tree: ``supers/mamba/*`` stacked (n_super,
per, ...), ``supers/adapter/{B, A}`` (n_super, ...), ``tail/*`` (tail, ...),
``shared/*`` unstacked. The Builder paths differ from the tree's keys as
in the reference (``/supers/s{i}/m{j}/in_proj``, ``/supers/s{i}/adB``,
``/tail/m{i}``, ``/shared_attn/in_proj``), and the supports follow the
paths. Every linear runs through ``apply_linear`` in the config's exec
mode; the SSD itself is plain PyTorch, as in the reference it is XLA.

Serving keeps the contiguous cache only, as the reference (no
``prefill_step``): ``conv`` (b, cw-1, conv_dim) in the config's dtype and
``ssm`` (b, h, p, n) in f32 per Mamba block, and the shared block's k/v
rows per invocation. A decode step writes the new states into the cache
in place and returns it.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import attention, mlp
from repro_torch.models.common import (DTYPES, Builder, apply_linear,
                                       contiguous_only, init_model,
                                       remat_wrap, rms_norm, silu,
                                       stack_layers, unstack)


def softplus(x):
    """log(1 + eˣ) as ``jax.nn.softplus`` writes it (``logaddexp(x, 0)``):
    max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


# ---------------------------------------------------------------------------
# SSD core
# ---------------------------------------------------------------------------

def _segsum(x):
    """x (..., l) → (..., l, l) with out[i, j] = sum_{k=j+1..i} x_k, -inf
    above the diagonal."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    ss = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return torch.where(mask, ss, torch.full_like(ss, float("-inf")))


def _prev_states(states, decay):
    """The inter-chunk recurrence: states (b, c, ...) and per-chunk decay
    (b, h, c) → (each chunk's incoming state (b, c, ...), final state),
    the state after chunk c being state · decay[c] + states[c]."""
    st = torch.zeros_like(states[:, 0])
    prev = []
    for c in range(states.shape[1]):
        prev.append(st)
        st = st * decay[:, :, c, None, None] + states[:, c]
    return torch.stack(prev, dim=1), st


def ssd(x, a_log, B, C, chunk: int):
    """Chunked state-space dual scan. x (b, s, h, p): inputs already gated
    by dt; a_log (b, s, h): log decay per step (dt · A ≤ 0, f32); B, C
    (b, s, n): shared across heads (one group). Returns y (b, s, h, p) in
    x's dtype and the final state (b, h, p, n) in f32."""
    b, s_orig, h, p = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    chunk = min(chunk, s_orig)
    pad = (-s_orig) % chunk
    if pad:
        # zero x/B/C contribute nothing; a_log = 0 decays by 1
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        a_log = torch.nn.functional.pad(a_log, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    s = s_orig + pad
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p).to(f32)
    ac = a_log.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)        # (b,h,c,l)
    Bc = B.reshape(b, nc, chunk, n).to(f32)
    Cc = C.reshape(b, nc, chunk, n).to(f32)

    a_cum = torch.cumsum(ac, dim=-1)                                # (b,h,c,l)
    L = torch.exp(_segsum(ac))                                      # (b,h,c,l,l)
    y_diag = torch.einsum("bcln,bcsn,bhcls,bcshp->bclhp", Cc, Bc, L, xc)
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)               # (b,h,c,l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay_states, xc)
    prev_states, final = _prev_states(states, torch.exp(a_cum[..., -1]))
    y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, prev_states,
                         torch.exp(a_cum))
    y = (y_diag + y_off).reshape(b, s, h, p).to(x.dtype)
    return y[:, :s_orig], final


def ssd_step(state, x_t, a_log_t, B_t, C_t):
    """One token of the recurrence. state (b, h, p, n) f32; x_t (b, h, p);
    a_log_t (b, h); B_t, C_t (b, n). Returns (y (b, h, p) in x_t's dtype,
    the new state)."""
    f32 = torch.float32
    dec = torch.exp(a_log_t)[..., None, None]
    upd = torch.einsum("bhp,bn->bhpn", x_t.to(f32), B_t.to(f32))
    new = state * dec + upd
    y = torch.einsum("bhpn,bn->bhp", new, C_t.to(f32))
    return y.to(x_t.dtype), new


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def _dims(cfg: ModelConfig):
    sc = cfg.ssm
    d_inner = sc.expand * cfg.d_model
    return d_inner, d_inner // sc.head_dim, sc.state_dim, sc.conv_width


def init_mamba_block(b: Builder, cfg: ModelConfig):
    d = cfg.d_model
    d_inner, h, n, cw = _dims(cfg)
    conv_dim = d_inner + 2 * n
    f32 = torch.float32
    params, consts = {}, {}
    params["ln"] = b.tensor("ln", (d,), "ones")
    params["in_proj"], c = b.linear("in_proj", d, 2 * d_inner + 2 * n + h)
    if c:
        consts["in_proj"] = c
    params["conv_w"] = b.tensor("conv_w", (cw, conv_dim), "normal", fan_in=cw)
    params["conv_b"] = b.tensor("conv_b", (conv_dim,), "zeros")
    params["A_log"] = b.tensor("A_log", (h,), "ones", dtype=f32)
    params["dt_bias"] = b.tensor("dt_bias", (h,), "zeros", dtype=f32)
    params["D"] = b.tensor("D", (h,), "ones", dtype=f32)
    params["out_norm"] = b.tensor("out_norm", (d_inner,), "ones")
    params["out_proj"], c = b.linear("out_proj", d_inner, d)
    if c:
        consts["out_proj"] = c
    return params, consts


def _conv1d(x, w, bias, state=None):
    """Causal depthwise conv. x (b, s, c); w (cw, c). The shifted products
    are summed in order i = 0..cw-1, then the bias is added, as the
    reference sums them. With ``state`` (b, cw-1, c) it streams and
    returns (y, new_state); else (y, None)."""
    cw = w.shape[0]
    if state is None:
        pad = torch.nn.functional.pad(x, (0, 0, cw - 1, 0))
    else:
        pad = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = pad[:, 0:s] * w[0][None, None]
    for i in range(1, cw):
        y = y + pad[:, i:i + s] * w[i][None, None]
    y = y + bias[None, None]
    return y, (pad[:, -(cw - 1):] if state is not None else None)


def apply_mamba_block(cfg: ModelConfig, p, c, x, *, cache=None):
    """One Mamba2 block with its residual: (x', new cache). ``cache``
    {"conv", "ssm"} runs one decode token (x (b, 1, d)) through the
    recurrence; without it the chunked SSD runs over the sequence."""
    d_inner, h, n, cw = _dims(cfg)
    hd = cfg.ssm.head_dim
    f32 = torch.float32
    res = x
    xn = rms_norm(x, p["ln"], cfg.norm_eps)
    zxbcdt = apply_linear(cfg, p["in_proj"], c.get("in_proj", {}), xn)
    z, xbc, dt = torch.split(zxbcdt, [d_inner, d_inner + 2 * n, h], dim=-1)
    conv_state = cache["conv"] if cache is not None else None
    xbc, new_conv = _conv1d(xbc, p["conv_w"], p["conv_b"], conv_state)
    xbc = silu(xbc)
    xs, B, C = torch.split(xbc, [d_inner, n, n], dim=-1)
    dt = softplus(dt.to(f32) + p["dt_bias"])                        # (b,s,h)
    a_log = dt * -torch.exp(p["A_log"])                             # (b,s,h)
    xh = xs.reshape(*xs.shape[:-1], h, hd)
    xh_dt = xh.to(f32) * dt[..., None]

    if cache is None:
        y, _ = ssd(xh_dt.to(x.dtype), a_log, B, C, cfg.ssm.chunk)
        new_cache = None
    else:
        y_t, new_ssm = ssd_step(cache["ssm"], xh_dt[:, 0], a_log[:, 0],
                                B[:, 0], C[:, 0])
        y = y_t[:, None]
        new_cache = {"conv": new_conv.to(cache["conv"].dtype),
                     "ssm": new_ssm}
    y = y + (p["D"][None, None, :, None] * xh.to(f32)).to(y.dtype)
    y = y.reshape(*y.shape[:-2], d_inner)
    y = rms_norm(y * silu(z).to(y.dtype), p["out_norm"], cfg.norm_eps)
    out = apply_linear(cfg, p["out_proj"], c.get("out_proj", {}),
                       y.to(x.dtype))
    return res + out.to(res.dtype), new_cache


# ---------------------------------------------------------------------------
# zamba2 hybrid model
# ---------------------------------------------------------------------------

def _hybrid_counts(cfg: ModelConfig):
    """(Mamba blocks a super block, super blocks, tail blocks)."""
    per = cfg.hybrid_attn_every
    n_super = cfg.n_layers // per
    return per, n_super, cfg.n_layers - n_super * per


def adapter_rank(cfg: ModelConfig) -> int:
    """The rank of each super block's adapter on the shared in_proj."""
    return max(8, cfg.param.rank // 2)


def _build_hybrid(cfg: ModelConfig, b: Builder):
    per, n_super, tail = _hybrid_counts(cfg)
    d = cfg.d_model
    params, consts = {}, {}
    params["embed"] = b.tensor("embed", (cfg.padded_vocab, d), "normal",
                               fan_in=d)

    def super_block(bb: Builder):
        ps, cs = stack_layers(bb, lambda b2: init_mamba_block(b2, cfg), per,
                              "m")
        out_p = {"mamba": ps}
        out_c = {"mamba": cs} if cs else {}
        r = adapter_rank(cfg)
        out_p["adapter"] = {
            "B": bb.tensor("adB", (2 * d, r), "zeros"),
            "A": bb.tensor("adA", (r, d), "kaiming", fan_in=2 * d),
        }
        return out_p, out_c

    params["supers"], cs = stack_layers(b.sub("supers"), super_block, n_super,
                                        "s")
    if cs:
        consts["supers"] = cs
    if tail:
        params["tail"], ct = stack_layers(
            b.sub("tail"), lambda b2: init_mamba_block(b2, cfg), tail, "m")
        if ct:
            consts["tail"] = ct

    # ONE shared attention + MLP block, its weights reused at every
    # invocation
    sb = b.sub("shared_attn")
    shared, shared_c = {}, {}
    shared["in_proj"], c = sb.linear("in_proj", 2 * d, d)
    if c:
        shared_c["in_proj"] = c
    shared["ln"] = sb.tensor("ln", (2 * d,), "ones")
    shared["attn"], c = attention.init_attention(sb.sub("attn"), cfg)
    if c:
        shared_c["attn"] = c
    shared["ln_mlp"] = sb.tensor("ln_mlp", (d,), "ones")
    shared["mlp"], c = mlp.init_mlp(sb.sub("mlp"), cfg)
    if c:
        shared_c["mlp"] = c
    params["shared"] = shared
    if shared_c:
        consts["shared"] = shared_c
    params["ln_f"] = b.tensor("ln_f", (d,), "ones")
    if not cfg.tie_embeddings:
        params["lm_head"] = b.tensor("lm_head", (d, cfg.padded_vocab),
                                     "normal", fan_in=d)
    return params, consts


def init_hybrid(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                workers: Optional[int] = None, obs=None):
    """(params, consts) on ``device``, supports bit for bit the
    reference's ``init_hybrid(cfg, key, seed)``; values from a
    ``torch.Generator`` seeded with ``seed`` (``common.init_model``)."""
    return init_model(cfg, seed, lambda b: _build_hybrid(cfg, b),
                      device=device, workers=workers, obs=obs)


def _apply_shared(cfg, shared, shared_c, adapter, x, h0, *, cache=None,
                  cache_index=None):
    """One invocation of the shared block: rms_norm(concat(x, h0)) through
    the shared in_proj plus this super block's adapter (catn·B)·A, then
    causal attention (rope) and the gated MLP, each with its residual."""
    cat = torch.cat([x, h0], dim=-1)
    catn = rms_norm(cat, shared["ln"], cfg.norm_eps)
    inp = apply_linear(cfg, shared["in_proj"], shared_c.get("in_proj", {}),
                       catn)
    inp = inp + ((catn @ adapter["B"]) @ adapter["A"]).to(inp.dtype)
    a, _ = attention.apply_attention(
        cfg, shared["attn"], shared_c.get("attn", {}), inp, cache=cache,
        cache_index=cache_index)
    x = x + a
    m = mlp.apply_mlp(cfg, shared["mlp"], shared_c.get("mlp", {}),
                      rms_norm(x, shared["ln_mlp"], cfg.norm_eps))
    return x + m


def _embed(params, tokens):
    return params["embed"][tokens.long()]


def _head(cfg, params, h):
    h = rms_norm(h, params["ln_f"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w.to(h.dtype)


def _stacked(params, consts, key, n):
    """The per-layer (params, consts) views of stack ``key``."""
    return list(zip(unstack(params[key], n), unstack(consts.get(key, {}), n)))


def apply_hybrid(cfg: ModelConfig, params, consts, tokens, *,
                 remat: str = "none"):
    """tokens (B, S) → (logits (B, S, V), 0.0): each super block (its
    Mamba blocks, then the shared block with its adapter) under the
    ``remat`` policy, then the tail."""
    per, n_super, tail = _hybrid_counts(cfg)
    h = _embed(params, tokens)
    h0 = h
    shared, shared_c = params["shared"], consts.get("shared", {})

    def super_body(p, c, x):
        for mp, mc in zip(unstack(p["mamba"], per),
                          unstack(c.get("mamba", {}), per)):
            x, _ = apply_mamba_block(cfg, mp, mc, x)
        return _apply_shared(cfg, shared, shared_c, p["adapter"], x, h0)

    step = remat_wrap(super_body, remat)
    for p, c in _stacked(params, consts, "supers", n_super):
        h = step(p, c, h)
    if tail:
        for mp, mc in _stacked(params, consts, "tail", tail):
            h, _ = apply_mamba_block(cfg, mp, mc, h)
    return _head(cfg, params, h), 0.0


def init_hybrid_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                      paged: bool = False, device="cuda", **_):
    """Zeros: ``supers.mamba`` {"conv" (n_super, per, B, cw-1, conv_dim)
    in the config's dtype, "ssm" (n_super, per, B, h, p, n) f32},
    ``supers.attn`` {"k", "v"} (n_super, B, max_len, Hkv, hd), and
    ``tail`` like ``supers.mamba`` for the tail blocks."""
    contiguous_only(paged)
    device = resolve(device)
    d_inner, h, n, cw = _dims(cfg)
    per, n_super, tail = _hybrid_counts(cfg)
    dt = DTYPES[cfg.dtype]

    def mk(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def mamba(lead):
        return {"conv": mk(lead + (batch, cw - 1, d_inner + 2 * n)),
                "ssm": mk(lead + (batch, h, cfg.ssm.head_dim, n),
                          torch.float32)}
    kv = (n_super, batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    cache = {"supers": {"mamba": mamba((n_super, per)),
                        "attn": {"k": mk(kv), "v": mk(kv)}}}
    if tail:
        cache["tail"] = mamba((tail,))
    return cache


def _mamba_cached(cfg, p, c, x, mcache):
    """A decode token through one Mamba block, its states written into
    the cache views ``mcache`` in place."""
    x, new = apply_mamba_block(cfg, p, c, x, cache=mcache)
    mcache["conv"].copy_(new["conv"])
    mcache["ssm"].copy_(new["ssm"])
    return x


def hybrid_decode_step(cfg: ModelConfig, params, consts, tokens, cache,
                       index, *, block_table=None):
    """One decode step on the contiguous cache: tokens (B, 1), ``index``
    the shared write position of the shared block's k/v. Returns (logits,
    cache), the cache updated in place."""
    contiguous_only(block_table)
    per, n_super, tail = _hybrid_counts(cfg)
    h = _embed(params, tokens)
    h0 = h
    shared, shared_c = params["shared"], consts.get("shared", {})
    sc = cache["supers"]
    for i, (p, c) in enumerate(_stacked(params, consts, "supers", n_super)):
        for j, (mp, mc) in enumerate(zip(unstack(p["mamba"], per),
                                         unstack(c.get("mamba", {}), per))):
            h = _mamba_cached(cfg, mp, mc, h,
                              {k: v[i, j] for k, v in sc["mamba"].items()})
        h = _apply_shared(cfg, shared, shared_c, p["adapter"], h, h0,
                          cache={k: v[i] for k, v in sc["attn"].items()},
                          cache_index=index)
    if tail:
        for i, (mp, mc) in enumerate(_stacked(params, consts, "tail", tail)):
            h = _mamba_cached(cfg, mp, mc, h,
                              {k: v[i] for k, v in cache["tail"].items()})
    return _head(cfg, params, h), cache
