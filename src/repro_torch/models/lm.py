"""Decoder-only LM of the llama, gemma2, vlm and MoE families with its
KV-cache serving steps (the paged and the contiguous cache), ported from
``repro.models.lm``.

Parameters keep the reference's scan layout: the layers are stacked in
*pattern periods* on a leading axis, ``params["layers"]["k{j}"]`` holding
the period's j-th block of each kind (``attn_pattern``: the llama
families' one global block, gemma2's ("local", "global") pair), so a
reference checkpoint maps onto them leaf for leaf. The MoE family's
blocks hold an MoE feed-forward (``mlp.apply_moe``) and return its aux
loss; its ``first_k_dense`` dense blocks (deepseek) sit before the
periods in their own stack ``params["dense_layers"]`` (Builder path
``/dense/dl{i}``, cache entry ``"dense_layers"``). The forward walks the
dense prefix, then the periods, in Python loops over views of the stacks;
the per-layer train step drives its segments (``embed_apply``,
``dense_apply``, ``period_apply``, ``head_apply``) one block or period at
a time.

The gemma conventions (families gemma2 and vlm): norms scale by (1 + w)
and start at zero under ``use_post_norms`` (and ``ln_f`` always), the
token embedding is scaled by √d_model rounded to the weight's dtype, the
MLP is GeGLU, and the final logits are softcapped in f32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.dist import sharding as dist_sharding
from repro_torch.models import attention, mlp
from repro_torch.models.common import (DTYPES, Builder, init_model,
                                       remat_wrap, rms_norm, softcap,
                                       stack_layers, unstack)
from repro_torch.models.common import support_specs as common_support_specs
from repro_torch.serve.kv import PagedLayout

_GEMMA = ("gemma2", "vlm")
_LM_FAMILIES = ("llama", "moe") + _GEMMA


def _check_family(cfg: ModelConfig) -> None:
    """This module runs the llama, gemma2, vlm and MoE families (the
    others have their own modules, reached through ``registry.get_api``)."""
    if cfg.family not in _LM_FAMILIES:
        raise ValueError(
            f"{cfg.name} (family {cfg.family!r}) is not a decoder-only lm "
            "family: run it through registry.get_api(cfg)")


def _n_dense(cfg: ModelConfig) -> int:
    """The dense blocks before the periods: ``first_k_dense`` with
    experts, else none."""
    return cfg.moe.first_k_dense if cfg.moe.n_experts > 0 else 0


def _pattern(cfg: ModelConfig):
    """The kinds of one period's blocks, as the reference's ``_pattern``;
    the layers after the dense prefix fill whole periods."""
    pat = cfg.attn_pattern or ("global",)
    if (cfg.n_layers - _n_dense(cfg)) % len(pat):
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} not "
                         f"divisible by pattern {pat}")
    return pat


def _n_periods(cfg: ModelConfig) -> int:
    return (cfg.n_layers - _n_dense(cfg)) // len(_pattern(cfg))


def _window_for(cfg: ModelConfig, kind: str) -> int:
    return cfg.sliding_window if kind == "local" else 0


def _norm(cfg: ModelConfig, x, w):
    return rms_norm(x, w, cfg.norm_eps, plus_one=cfg.family in _GEMMA)


def _init_block(b: Builder, cfg: ModelConfig, use_moe: bool,
                d_ff_dense: int = 0):
    params, consts = {}, {}
    norm_init = "zeros" if cfg.use_post_norms else "ones"
    params["ln_attn"] = b.tensor("ln_attn", (cfg.d_model,), norm_init)
    params["attn"], c = attention.init_attention(b.sub("attn"), cfg)
    if c:
        consts["attn"] = c
    params["ln_mlp"] = b.tensor("ln_mlp", (cfg.d_model,), norm_init)
    if cfg.use_post_norms:
        params["ln_attn_post"] = b.tensor("ln_attn_post", (cfg.d_model,),
                                          "zeros")
        params["ln_mlp_post"] = b.tensor("ln_mlp_post", (cfg.d_model,),
                                         "zeros")
    if use_moe:
        params["moe"], c = mlp.init_moe(b.sub("moe"), cfg)
        if c:
            consts["moe"] = c
    else:
        params["mlp"], c = mlp.init_mlp(b.sub("mlp"), cfg,
                                        d_ff=d_ff_dense or cfg.d_ff)
        if c:
            consts["mlp"] = c
    return params, consts


def _apply_block(cfg: ModelConfig, p, c, x, *, window: int, **cache_kw):
    """One block: (x', cache, aux), aux the MoE block's load-balancing
    loss (an f32 tensor) or 0.0 for a dense block."""
    a, cache = attention.apply_attention(cfg, p["attn"], c.get("attn", {}),
                                         _norm(cfg, x, p["ln_attn"]),
                                         window=window, **cache_kw)
    if cfg.use_post_norms:
        a = _norm(cfg, a, p["ln_attn_post"])
    x = x + a
    h = _norm(cfg, x, p["ln_mlp"])
    aux = 0.0
    if "moe" in p:
        m, aux = mlp.apply_moe(cfg, p["moe"], c.get("moe", {}), h)
    else:
        m = mlp.apply_mlp(cfg, p["mlp"], c.get("mlp", {}), h,
                          act="gelu" if cfg.family in _GEMMA else "silu")
    if cfg.use_post_norms:
        m = _norm(cfg, m, p["ln_mlp_post"])
    return x + m, cache, aux


def _build_lm(cfg: ModelConfig, b: Builder):
    """The model's (params, consts), built by ``b`` in the reference's
    Builder order."""
    params, consts = {}, {}
    params["embed"] = b.tensor("embed", (cfg.padded_vocab, cfg.d_model),
                               "normal", fan_in=cfg.d_model)
    use_moe = cfg.moe.n_experts > 0
    pat = _pattern(cfg)
    n_dense = _n_dense(cfg)
    if n_dense:
        params["dense_layers"], cd = stack_layers(
            b.sub("dense"), lambda bb: _init_block(bb, cfg, False,
                                                   cfg.moe.d_ff_dense),
            n_dense, "dl")
        if cd:
            consts["dense_layers"] = cd

    def init_period(bb: Builder):
        ps, cs = {}, {}
        for j in range(len(pat)):
            ps[f"k{j}"], c = _init_block(bb.sub(f"k{j}"), cfg, use_moe)
            if c:
                cs[f"k{j}"] = c
        return ps, cs

    params["layers"], cl = stack_layers(b.sub("blocks"), init_period,
                                        _n_periods(cfg), "p")
    if cl:
        consts["layers"] = cl
    params["ln_f"] = b.tensor("ln_f", (cfg.d_model,),
                              "zeros" if cfg.family in _GEMMA else "ones")
    if not cfg.tie_embeddings:
        params["lm_head"] = b.tensor("lm_head", (cfg.d_model,
                                                 cfg.padded_vocab),
                                     "normal", fan_in=cfg.d_model)
    return params, consts


def init_lm(cfg: ModelConfig, seed: int = 0, *, device="cuda",
            workers: Optional[int] = None, obs=None):
    """(params, consts) on ``device``. Supports match the reference's
    ``init_lm(cfg, key, seed)`` bit for bit (same Builder paths, e.g.
    ``/blocks/p{i}/k0/attn/wq``); values come from a ``torch.Generator``
    seeded with ``seed``. The supports are sampled first, by ``workers``
    processes (None: ``core.support.default_workers``, one process below
    llama_350m's size; 1: this process), which changes no bit
    (``models.common.init_model``, which also records the init's time
    and worker count on ``obs``)."""
    _check_family(cfg)
    return init_model(cfg, seed, lambda b: _build_lm(cfg, b), device=device,
                      workers=workers, obs=obs)


def support_specs(cfg: ModelConfig, seed: int = 0) -> list:
    """The support specs ``init_lm(cfg, seed)`` samples, in order: for a
    caller that samples them ahead (``core.support.sample_ahead``)."""
    _check_family(cfg)
    return [s for _, s in common_support_specs(
        cfg, seed, lambda b: _build_lm(cfg, b))]


def embed_apply(cfg: ModelConfig, params, tokens, patch_embeds=None):
    """The model's input segment: the token embedding (scaled by √d_model
    in the weight's dtype for the gemma families), and for the vlm family
    ``patch_embeds`` (B, n_patches, d) in place of the first n_patches
    positions. Takes only the params it reads ({"embed": leaf}), so the
    per-layer sweep can differentiate it against exactly that leaf."""
    h = params["embed"][tokens.long()]
    if cfg.family in _GEMMA:
        h = h * torch.tensor(math.sqrt(cfg.d_model), dtype=h.dtype,
                             device=h.device)
    if patch_embeds is not None:
        h = torch.cat([patch_embeds.to(h.dtype),
                       h[:, patch_embeds.shape[1]:]], dim=1)
    return h


def period_apply(cfg: ModelConfig, p, c, x):
    """One period of the stack, its blocks in pattern order, each local
    block over the sliding window: (params {"k0": ...}, consts, x) → (x',
    aux). The per-layer backward sweep differentiates this exact function,
    so the train forward and the sweep's recompute cannot drift. aux sums
    the period's MoE aux losses (an f32 tensor); it is 0.0 for the
    families without experts."""
    aux = 0.0
    for j, kind in enumerate(_pattern(cfg)):
        x, _, a = _apply_block(cfg, p[f"k{j}"], c.get(f"k{j}", {}), x,
                               window=_window_for(cfg, kind))
        aux = aux + a
    return _sp_constraint(cfg, x), aux


def _sp_constraint(cfg: ModelConfig, h):
    """The reference's sequence-parallel residual constraint: its layout
    hint to XLA, the identity here (``dist.sharding.constrain``); the
    port's mesh path refuses ``seq_shard_activations`` (ROADMAP queue A
    item 10b)."""
    if not cfg.seq_shard_activations:
        return h
    return dist_sharding.constrain(h, dist_sharding.BATCH_AXES,
                                   dist_sharding.MODEL_AXIS, None)


def dense_apply(cfg: ModelConfig, p, c, x):
    """One block of the MoE family's dense prefix (global attention, a
    dense MLP of ``d_ff_dense``): (params, consts, x) → (x', aux 0.0)."""
    x, _, aux = _apply_block(cfg, p, c, x, window=0)
    return x, aux


def head_apply(cfg: ModelConfig, params, h):
    """Final norm and unembed (the final softcap in f32 where the config
    has one). ``params`` needs only the head leaves: {"ln_f", "lm_head"}
    (untied) or {"ln_f", "embed"} (tied)."""
    h = _norm(cfg, h, params["ln_f"])
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = h @ w.to(h.dtype)
    if cfg.final_logit_softcap > 0:
        logits = softcap(logits.float(), cfg.final_logit_softcap)
    return logits


def _stack(params, consts, group: str):
    """The per-block (params, consts) views of one stacked group
    (``"layers"``: its periods; ``"dense_layers"``: the dense prefix), in
    order; none where the model has no such group."""
    if group not in params:
        return []
    n = params[group]["ln_attn"].shape[0] if group == "dense_layers" else \
        params[group]["k0"]["ln_attn"].shape[0]
    return list(zip(unstack(params[group], n),
                    unstack(consts.get(group, {}), n)))


def _walk(cfg: ModelConfig, params, consts, h, *, remat: str = "none",
          saves=None):
    """The dense prefix, then the period stack, as ``apply_lm`` and
    ``forward_saving_boundaries`` both run them. Returns (h, aux of the
    dense blocks, aux of the periods), each aux a list a block or period;
    ``saves`` ({"dense_layers": [], "layers": []}) receives each block's
    and period's input."""
    _check_family(cfg)
    auxes = {}
    for group, fn in (("dense_layers", dense_apply),
                      ("layers", period_apply)):
        step = remat_wrap(lambda p, c, x, fn=fn: fn(cfg, p, c, x), remat)
        auxes[group] = []
        for p, c in _stack(params, consts, group):
            if saves is not None:
                saves[group].append(dist_sharding.constrain_boundary(
                    h, seq_sharded=cfg.seq_shard_activations))
            h, a = step(p, c, h)
            auxes[group].append(a)
    return h, auxes["dense_layers"], auxes["layers"]


def _aux_stack(auxes, device):
    """The per-block aux losses as an f32 (n,) tensor."""
    return torch.stack([torch.as_tensor(a, dtype=torch.float32,
                                        device=device) for a in auxes]) \
        if auxes else torch.zeros(0, dtype=torch.float32, device=device)


def apply_lm(cfg: ModelConfig, params, consts, tokens, *, patch_embeds=None,
             remat: str = "none"):
    """tokens (B, S) → (logits (B, S, V), aux): the plain causal forward,
    differentiable in the params (the train step's forward), each block
    and period under the ``remat`` policy (``models.common.remat_wrap``).
    aux is the sum of the MoE blocks' aux losses (the dense prefix's,
    then the periods'), an f32 tensor; 0.0 for the families without
    experts. For the vlm family ``patch_embeds`` (B, n_patches, d) replace
    the first n_patches positions."""
    h = embed_apply(cfg, params, tokens, patch_embeds)
    h, aux_d, aux_p = _walk(cfg, params, consts, h, remat=remat)
    aux = 0.0
    if cfg.moe.n_experts > 0:
        aux = _aux_stack(aux_d, h.device).sum() + \
            _aux_stack(aux_p, h.device).sum()
    return head_apply(cfg, params, h), aux


def forward_saving_boundaries(cfg: ModelConfig, params, consts, tokens, *,
                              patch_embeds=None):
    """The same forward as :func:`apply_lm` up to the final norm, run
    without autograd, keeping each period's input: the roots the per-layer
    backward sweep (``train/perlayer.py``) re-runs one period at a time
    from. The saved boundaries are the only activations kept across
    periods.

    Returns a dict, as the reference's (the inputs as lists where the
    reference stacks them):
      dense_xs  — the dense prefix blocks' (B, S, d) inputs, the
                  embedding's output first (None without a prefix),
      xs        — the periods' (B, S, d) inputs,
      h_top     — the last period's output (the head's input),
      aux_dense — (n_dense,) f32 aux losses of the prefix (None without),
      aux       — (n_periods,) f32 aux losses of the periods (zeros for
                  the families without experts).
    """
    with torch.no_grad():
        h0 = embed_apply(cfg, params, tokens, patch_embeds)
        saves = {"dense_layers": [], "layers": []}
        h_top, aux_d, aux_p = _walk(cfg, params, consts, h0, saves=saves)
    dense = "dense_layers" in params
    return {"dense_xs": saves["dense_layers"] if dense else None,
            "xs": saves["layers"], "h_top": h_top,
            "aux_dense": _aux_stack(aux_d, h0.device) if dense else None,
            "aux": _aux_stack(aux_p, h0.device)}


# ---------------------------------------------------------------------------
# Serving (KV cache)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               paged: bool = False, block_len: int = 16, n_blocks: int = 0,
               device="cuda"):
    """KV cache {"layers": {"k{j}": {"k", "v"}}}, zeros, one pair of
    stacks per kind of the pattern (a local and a global one for gemma2),
    each on a leading axis of the periods, and {"dense_layers": {"k",
    "v"}} on a leading axis of the MoE family's dense prefix. Contiguous
    (the default):
    leaves (n_periods, batch, max_len, Hkv, hd), one row per slot.
    ``paged=True``: block pools (n_periods, n_blocks, block_len, Hkv, hd)
    shared by every slot through a block table; ``n_blocks`` defaults to
    full capacity plus the null block."""
    _check_family(cfg)
    device = resolve(device)
    pat = _pattern(cfg)
    if paged:
        layout = PagedLayout.plan(batch, max_len, block_len, n_blocks)
        lead = (layout.n_blocks, layout.block_len)
    else:
        lead = (batch, max_len)
    tail = (*lead, cfg.n_kv_heads, cfg.resolved_head_dim)
    dt = DTYPES[cfg.dtype]

    def kv(n):
        return {"k": torch.zeros((n, *tail), dtype=dt, device=device),
                "v": torch.zeros((n, *tail), dtype=dt, device=device)}
    cache = {"layers": {f"k{j}": kv(_n_periods(cfg))
                        for j in range(len(pat))}}
    if _n_dense(cfg):
        cache["dense_layers"] = kv(_n_dense(cfg))
    return cache


def _cached_forward(cfg: ModelConfig, params, consts, tokens, cache, index,
                    block_table, prefill: bool):
    """The walk shared by decode_step and prefill_step: embed, the dense
    prefix's blocks over their cache, then each period's blocks over their
    kind's cache (views of the stacks, updated in place), each local
    block over the window, final norm and unembed. Returns (logits,
    cache)."""
    _check_family(cfg)
    pat = _pattern(cfg)
    lay = dist_sharding.serving_layout()
    rows = None if lay is None else lay.slots
    if rows is not None:
        # a serving mesh's contiguous cache holds this rank's slots: run
        # their rows, then all-gather the logits over the batch axes
        tokens = tokens[rows]
        if torch.is_tensor(index) and index.dim() == 1:
            index = index[rows]
    h = embed_apply(cfg, params, tokens)
    kw = dict(cache_index=index, block_table=block_table, prefill=prefill)
    for i, (p, c) in enumerate(_stack(params, consts, "dense_layers")):
        kv = cache["dense_layers"]
        h, _, _ = _apply_block(cfg, p, c, h, window=0,
                               cache={"k": kv["k"][i], "v": kv["v"][i]},
                               **kw)
    pools = cache["layers"]
    for i, (p, c) in enumerate(_stack(params, consts, "layers")):
        for j, kind in enumerate(pat):
            kv = pools[f"k{j}"]
            h, _, _ = _apply_block(cfg, p[f"k{j}"], c.get(f"k{j}", {}), h,
                                   window=_window_for(cfg, kind),
                                   cache={"k": kv["k"][i], "v": kv["v"][i]},
                                   **kw)
    logits = head_apply(cfg, params, h)
    if rows is not None:
        logits = dist_sharding.gather_leaf(
            logits, (lay.slot_axes,) + (None,) * (logits.dim() - 1),
            lay.mesh)
    return logits, cache


def decode_step(cfg: ModelConfig, params, consts, tokens, cache, index, *,
                block_table=None):
    """One decode step. tokens (B, 1); index a scalar position shared by
    the batch or a (B,) per-slot vector; ``block_table`` (B,
    blocks_per_slot) addresses the paged pools, and without it the cache
    is the contiguous one. Returns (logits, cache)."""
    return _cached_forward(cfg, params, consts, tokens, cache, index,
                           block_table, prefill=False)


def prefill_step(cfg: ModelConfig, params, consts, tokens, cache, *,
                 block_table=None, offsets=None):
    """Batched prefill of (B, S) prompts, writing K/V for their positions.
    Without ``offsets`` every row starts at position 0 and attends its own
    tokens (on the contiguous cache every row is written, so the whole
    batch must be fresh); ``offsets`` (B,) switches to chunked suffix
    prefill at
    offsets[s] + [0, S), attending the slot's prior pages in place (the
    shared-prefix path). Returns (logits (B, S, V), cache)."""
    index = 0 if offsets is None else offsets.to(torch.int32)
    return _cached_forward(cfg, params, consts, tokens, cache, index,
                           block_table, prefill=True)
