"""Causal multi-head attention with RoPE over the paged KV cache, ported
from ``repro.models.attention`` for the llama family (GQA-ready; the
gemma2/qwen3 extras — sliding windows, logit softcap, QK-norm, qkv bias —
wait for ROADMAP queue A item 9).

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
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.common import Builder, apply_linear, rope
from repro_torch.serve import kv as kv_lib

NEG_INF = -1e30


def init_attention(b: Builder, cfg: ModelConfig):
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    params, consts = {}, {}
    for name, d_in, d_out in (("wq", d, nh * hd), ("wk", d, nkv * hd),
                              ("wv", d, nkv * hd), ("wo", nh * hd, d)):
        p, c = b.linear(name, d_in, d_out)
        params[name] = p
        if c:
            consts[name] = c
    return params, consts


def _scale(cfg: ModelConfig) -> float:
    return cfg.resolved_head_dim ** -0.5


def _attend(cfg: ModelConfig, q, k, v, q_pos, k_pos):
    """Plain causal softmax attention in f32. q (B,Sq,H,hd); k,v
    (B,Sk,Hkv,hd); q_pos (Sq,) or per-slot (B,Sq); k_pos (Sk,)."""
    bsz, sq, nh, hd = q.shape
    nkv = k.shape[2]
    qg = q.reshape(bsz, sq, nkv, nh // nkv, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float() * _scale(cfg),
                     k.float())
    qp = q_pos if q_pos.dim() == 2 else q_pos[None]
    mask = qp[:, :, None] >= k_pos[None, None, :]           # (B|1, Sq, Sk)
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


def apply_attention(cfg: ModelConfig, params, consts, x, *,
                    cache: Optional[dict] = None, cache_index=None,
                    block_table=None, prefill: bool = False):
    """Causal self-attention; returns (y, cache).

    Without a cache: attention over the input itself (the forward of
    ``apply_lm``). With a paged cache {"k", "v"} (pools of one layer) and
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

    q = lin("wq", x).reshape(bsz, sq, nh, hd)
    k = lin("wk", x).reshape(bsz, sq, nkv, hd)
    v = lin("wv", x).reshape(bsz, sq, nkv, hd)

    idx = 0 if cache_index is None else cache_index
    per_slot = torch.is_tensor(idx) and idx.dim() == 1
    steps = torch.arange(sq, dtype=torch.int64, device=x.device)
    if per_slot:
        q_pos = idx.long()[:, None] + steps[None]               # (B, Sq)
    else:
        q_pos = steps + int(idx)                                # (Sq,)
    rpos = q_pos if per_slot else q_pos[None]
    q = rope(q, rpos, cfg.rope_theta)
    k = rope(k, rpos, cfg.rope_theta)

    if cache is None:
        return lin("wo", _attend(cfg, q, k, v, q_pos, q_pos)), None
    if block_table is None:
        raise NotImplementedError(
            "the contiguous KV cache is not ported yet (ROADMAP queue A item "
            "6: the paged=False engine path); pass a block_table")

    positions = q_pos if per_slot else q_pos[None].expand(bsz, sq)
    ck = kv_lib.scatter(cache["k"], block_table, positions, k)
    cv = kv_lib.scatter(cache["v"], block_table, positions, v)
    paged = cfg.attn_kernel == "paged"
    if not prefill:
        if paged and sq == 1 and per_slot:
            o = kernel_ops.paged_attention(q[:, 0], ck, cv, block_table, idx,
                                           scale=_scale(cfg))
            return lin("wo", o.reshape(bsz, 1, nh * hd)), cache
        k, v = _live_view(ck, block_table), _live_view(cv, block_table)
        k_pos = torch.arange(k.shape[1], device=x.device)
    elif per_slot:
        if paged:
            o = kernel_ops.paged_prefill_attention(q, ck, cv, block_table,
                                                   idx, scale=_scale(cfg))
            return lin("wo", o.reshape(bsz, sq, nh * hd)), cache
        k, v = _live_view(ck, block_table), _live_view(cv, block_table)
        k_pos = torch.arange(k.shape[1], device=x.device)
    else:
        k_pos = q_pos                  # attend local k/v, not the pools
    return lin("wo", _attend(cfg, q, k, v, q_pos, k_pos)), cache
