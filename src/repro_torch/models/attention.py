"""Causal GQA attention with RoPE over the paged or the contiguous KV
cache, ported from ``repro.models.attention``: qkv bias (qwen2.5), the
``query_pre_attn_scalar`` scale, the attention-logit softcap and sliding
windows (gemma2), and QK-norm (qwen3: an RMS norm of each head's q and k,
after the heads are split and before rope, on every path); and for the
whisper family no rope, a non-causal encoder attention and a
cross-attention whose k and v come from the encoder's output.

Scores follow the reference's order everywhere: q · scale in f32, the
product with k in f32, the softcap, then the causal and window masks.

How a paged read runs is ``cfg.attn_kernel``:

==========  ===============================================================
"gather"    gather the (B, view_len, Hkv, hd) per-slot view
            (``kv.gather_view``, null-block rows zeroed because 0 · NaN is
            NaN) and run the plain f32 ``_attend`` over it.
"paged"     decode (one query per slot at per-slot positions) runs the
            ``paged_attention`` kernel and per-slot suffix prefill the
            ``paged_prefill`` kernel, both reading the pools in place;
            other shapes fall back to "gather".
==========  ===============================================================

Prefill without per-slot offsets (all rows start at 0) attends its own
just-computed k/v through ``_attend``, as the reference does (XLA there,
with no Pallas kernel).

The contiguous cache (no block table; one (max_len, Hkv, hd) row per
slot) is read by ``_attend`` over the whole row, as the reference reads it
outside any Pallas kernel. Its writes keep the reference's index rules: a
scalar index is a ``dynamic_update_slice`` (a negative start wraps once,
then the start is clamped so the update fits), a (B,) vector an
``.at[rows, cols].set`` (a negative column wraps once, a column still out
of range is dropped).

On a serving mesh (``serve.engine.ServeEngine(mesh=...)``) whose
``dist.sharding.ServingLayout`` says the cache holds a rank's share of
the kv heads (``dist.sharding.cache_specs``), rank m of TP model ranks
writes and attends kv heads [m·Hkv/TP, (m+1)·Hkv/TP) and their q heads
[m·H/TP, (m+1)·H/TP), whole GQA groups since q head h reads kv head h //
(H/Hkv), then all-gathers the output heads in order before ``wo``. A
q/k/v projection held as the rank's column slice computes just those
heads; one held whole is sliced. Where the cache holds every head (Hkv
not divisible by TP) each rank attends them all.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding as dist_sharding
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.common import (Builder, apply_linear, rms_norm,
                                       rope, softcap)
from repro_torch.serve import kv as kv_lib

NEG_INF = -1e30


def init_attention(b: Builder, cfg: ModelConfig, cross: bool = False):
    """The q, k, v, o linears (with qkv bias where the config has it) and
    the QK-norm weights. ``cross`` (whisper's cross-attention) builds the
    same linears, as the reference's does: only the call differs, which
    projects k and v from its ``kv_source``."""
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    params, consts = {}, {}
    for name, d_in, d_out, bias in (
            ("wq", d, nh * hd, cfg.qkv_bias), ("wk", d, nkv * hd, cfg.qkv_bias),
            ("wv", d, nkv * hd, cfg.qkv_bias), ("wo", nh * hd, d, False)):
        p, c = b.linear(name, d_in, d_out, bias=bias)
        params[name] = p
        if c:
            consts[name] = c
    if cfg.qk_norm:
        params["q_norm"] = b.tensor("q_norm", (hd,), "ones")
        params["k_norm"] = b.tensor("k_norm", (hd,), "ones")
    return params, consts


def _scale(cfg: ModelConfig) -> float:
    return (cfg.query_pre_attn_scalar or cfg.resolved_head_dim) ** -0.5


def _attend(cfg: ModelConfig, q, k, v, q_pos, k_pos, window: int = 0,
            causal: bool = True):
    """Plain softmax attention in f32. q (B,Sq,H,hd); k,v (B,Sk,Hkv,hd);
    q_pos (Sq,) or per-slot (B,Sq); k_pos (Sk,). ``causal``: a key is seen
    by a query at or after it; and with ``window`` > 0 by one fewer than
    ``window`` positions after it. Without either every key is seen (the
    whisper encoder and cross-attention) and no mask is formed."""
    bsz, sq, nh, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(bsz, sq, nkv, nh // nkv, hd)
    # the reference's sequence-parallel layout hints (identity here:
    # dist.sharding.constrain)
    sp = cfg.seq_shard_activations and sq > 1
    if sp:
        batch = dist_sharding.BATCH_AXES
        qg = dist_sharding.constrain(qg, batch, "model", None, None, None)
        k = dist_sharding.constrain(k, batch, None, None, None)
        v = dist_sharding.constrain(v, batch, None, None, None)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float() * _scale(cfg),
                     k.float())
    s = softcap(s, cfg.attn_logit_softcap)
    qp = q_pos if q_pos.dim() == 2 else q_pos[None]
    lag = qp[:, :, None] - k_pos[None, None, :]             # (B|1, Sq, Sk)
    mask = lag >= 0 if causal else None
    if window > 0:
        mask = lag < window if mask is None else mask & (lag < window)
    if mask is not None:
        s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float()).to(q.dtype)
    return o.reshape(bsz, sq, nh * hd)


def _live_view(pool, table):
    """Gathered per-slot view with null-block rows zeroed: the mask gives
    them weight 0, but garbage in unallocated pages must not ride the
    p @ v product (0 · NaN = NaN)."""
    view = kv_lib.gather_view(pool, table)
    live = torch.repeat_interleave(table != 0, pool.shape[1], dim=1)
    return torch.where(live[:, :, None, None], view, torch.zeros_like(view))


def _contiguous(cfg: ModelConfig, cache, q, k, v, q_pos, idx, per_slot,
                prefill, window):
    """Write k/v into the contiguous cache rows {"k", "v"} (B, max_len,
    Hkv, hd) in place, then attend: a scalar-index prefill its local k/v,
    everything else the whole row, masked by q_pos >= k_pos (unwritten
    positions at or below q_pos are zeros with logit 0, as in the
    reference)."""
    ck, cv = cache["k"], cache["v"]
    bsz, sq = k.shape[:2]
    max_len = ck.shape[1]
    if per_slot:
        cols = torch.where(q_pos < 0, q_pos + max_len, q_pos)
        keep = (cols >= 0) & (cols < max_len)
        rows = torch.arange(bsz, device=cols.device)[:, None].expand_as(cols)
        for c, new in ((ck, k), (cv, v)):
            c[rows[keep], cols[keep]] = new[keep].to(c.dtype)
    else:
        start = int(idx) + (max_len if int(idx) < 0 else 0)
        start = min(max(start, 0), max_len - sq)
        ck[:, start:start + sq] = k.to(ck.dtype)
        cv[:, start:start + sq] = v.to(cv.dtype)
        if prefill:
            return _attend(cfg, q, k, v, q_pos, q_pos, window)
    k_pos = torch.arange(max_len, device=q.device)
    return _attend(cfg, q, ck, cv, q_pos, k_pos, window)


def apply_attention(cfg: ModelConfig, params, consts, x, *,
                    window: int = 0, cache: Optional[dict] = None,
                    cache_index=None, block_table=None,
                    prefill: bool = False, causal: bool = True,
                    kv_source=None):
    """Causal self-attention, over the last ``window`` positions when it is
    > 0 (a local layer); returns (y, cache).

    ``causal=False`` attends every key (the whisper encoder, without a
    cache). ``kv_source`` (B, Sk, d) makes it a cross-attention: k and v
    are projected from it, every key is seen, the cache is neither read
    nor written and is returned as it came. Rope rotates q and k except
    in the whisper family and in a cross-attention, as in the reference.

    Without a cache: attention over the input itself (the forward of
    ``apply_lm``). With a cache and no ``block_table``: the contiguous
    rows of one layer (see the module docstring). With a paged cache
    {"k", "v"} (pools of one layer) and
    ``block_table`` (B, blocks_per_slot): k/v are scattered through the
    table (in place) at ``cache_index`` — a scalar or a (B,) per-slot
    position vector — and the read runs as ``cfg.attn_kernel`` says (see
    the module docstring). ``prefill=True`` with a scalar index attends
    the local k/v; with a (B,) index it is per-slot suffix prefill over
    the slot's prior pages and the chunk."""
    hd = cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    lin = lambda n, t: apply_linear(cfg, params[n], consts.get(n, {}), t)
    bsz, sq = x.shape[0], x.shape[1]

    kv_in = x if kv_source is None else kv_source
    lay = dist_sharding.serving_layout()
    if lay is not None and (lay.heads is None or kv_source is not None):
        lay = None                      # every head on every rank

    def heads(n, t, n_heads):
        # (B, S, heads, hd); on a serving mesh whose cache holds this
        # rank's kv heads, its share of them (a projection held as the
        # rank's head columns gives just those)
        y = lin(n, t).reshape(t.shape[0], t.shape[1], -1, hd)
        if lay is None or "tp_heads" in consts.get(n, {}):
            return y
        return y[:, :, lay.head_range(n_heads)]
    q = heads("wq", x, nh)
    k = heads("wk", kv_in, nkv)
    v = heads("wv", kv_in, nkv)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)

    idx = 0 if cache_index is None else cache_index
    per_slot = torch.is_tensor(idx) and idx.dim() == 1
    steps = torch.arange(sq, dtype=torch.int64, device=x.device)
    if per_slot:
        q_pos = idx.long()[:, None] + steps[None]               # (B, Sq)
    else:
        q_pos = steps + int(idx)                                # (Sq,)
    if kv_source is not None:
        k_pos = torch.arange(k.shape[1], device=x.device)
        return lin("wo", _attend(cfg, q, k, v, q_pos, k_pos, window,
                                 causal)), cache
    if cfg.family != "whisper":
        rpos = q_pos if per_slot else q_pos[None]
        q = rope(q, rpos, cfg.rope_theta)
        k = rope(k, rpos, cfg.rope_theta)

    if cache is None:
        return lin("wo", _attend(cfg, q, k, v, q_pos, q_pos, window,
                                 causal)), None
    o = _cached(cfg, cache, q, k, v, q_pos, idx, per_slot, block_table,
                prefill, window)
    if lay is not None:
        o = dist_sharding.gather_last(o, lay.mesh)     # the heads, in order
    return lin("wo", o), cache


def _cached(cfg: ModelConfig, cache, q, k, v, q_pos, idx, per_slot,
            block_table, prefill: bool, window: int):
    """Write k/v into the cache and attend over it as the module docstring
    says: (B, Sq, H·hd) for the heads of q, k and v."""
    bsz, sq, nh, hd = q.shape
    if block_table is None:
        return _contiguous(cfg, cache, q, k, v, q_pos, idx, per_slot,
                           prefill, window)
    positions = q_pos if per_slot else q_pos[None].expand(bsz, sq)
    ck = kv_lib.scatter(cache["k"], block_table, positions, k)
    cv = kv_lib.scatter(cache["v"], block_table, positions, v)
    paged = cfg.attn_kernel == "paged"
    kern = dict(scale=_scale(cfg), softcap=cfg.attn_logit_softcap,
                window=window)
    if not prefill:
        if paged and sq == 1 and per_slot:
            o = kernel_ops.paged_attention(q[:, 0], ck, cv, block_table, idx,
                                           **kern)
            return o.reshape(bsz, 1, nh * hd)
        k, v = _live_view(ck, block_table), _live_view(cv, block_table)
        k_pos = torch.arange(k.shape[1], device=q.device)
    elif per_slot:
        if paged:
            o = kernel_ops.paged_prefill_attention(q, ck, cv, block_table,
                                                   idx, **kern)
            return o.reshape(bsz, sq, nh * hd)
        k, v = _live_view(ck, block_table), _live_view(cv, block_table)
        k_pos = torch.arange(k.shape[1], device=q.device)
    else:
        k_pos = q_pos                  # attend local k/v, not the pools
    return _attend(cfg, q, k, v, q_pos, k_pos, window)
