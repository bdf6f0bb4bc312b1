"""Decoder-only LM of the llama family with the paged KV-cache serving
steps, ported from ``repro.models.lm``.

Parameters keep the reference's scan layout: per-layer leaves stacked on a
leading axis under ``params["layers"]["k0"]`` (the reference's one-kind
layer pattern of the llama family), so a reference checkpoint maps onto
them leaf for leaf. The forward walks the layers in a Python loop over
views of the stacks; the per-layer train step drives its segments
(``embed_apply``, ``period_apply``, ``head_apply``) one at a time.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import attention, mlp
from repro_torch.models.common import (DTYPES, Builder, presample,
                                       remat_wrap, rms_norm, stack_layers,
                                       unstack)
from repro_torch.serve.kv import PagedLayout


def _check_family(cfg: ModelConfig) -> None:
    """The port runs the llama family as the paper configs use it; the
    other families and the llama variants' extras (qwen2.5's qkv bias,
    gemma2's windows and softcaps, qwen3's QK-norm, MoE) raise."""
    extras = (cfg.moe.n_experts or cfg.use_post_norms or cfg.attn_pattern
              or cfg.qkv_bias or cfg.qk_norm or cfg.attn_logit_softcap
              or cfg.final_logit_softcap or cfg.query_pre_attn_scalar)
    if cfg.family != "llama" or extras:
        raise NotImplementedError(
            f"{cfg.name} (family {cfg.family!r}) is not ported yet (ROADMAP "
            "queue A item 9: the other model families); the port runs the "
            "llama family of the paper configs")


def _init_block(b: Builder, cfg: ModelConfig):
    params, consts = {}, {}
    params["ln_attn"] = b.tensor("ln_attn", (cfg.d_model,), "ones")
    params["attn"], c = attention.init_attention(b.sub("attn"), cfg)
    if c:
        consts["attn"] = c
    params["ln_mlp"] = b.tensor("ln_mlp", (cfg.d_model,), "ones")
    params["mlp"], c = mlp.init_mlp(b.sub("mlp"), cfg)
    if c:
        consts["mlp"] = c
    return params, consts


def _apply_block(cfg: ModelConfig, p, c, x, **cache_kw):
    h = rms_norm(x, p["ln_attn"], cfg.norm_eps)
    a, cache = attention.apply_attention(cfg, p["attn"], c.get("attn", {}),
                                         h, **cache_kw)
    x = x + a
    h = rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    return x + mlp.apply_mlp(cfg, p["mlp"], c.get("mlp", {}), h), cache


def _build_lm(cfg: ModelConfig, b: Builder):
    """The model's (params, consts), built by ``b`` in the reference's
    Builder order."""
    params, consts = {}, {}
    params["embed"] = b.tensor("embed", (cfg.padded_vocab, cfg.d_model),
                               "normal", fan_in=cfg.d_model)

    def init_period(bb: Builder):
        p, c = _init_block(bb.sub("k0"), cfg)
        return {"k0": p}, ({"k0": c} if c else {})

    params["layers"], cl = stack_layers(b.sub("blocks"), init_period,
                                        cfg.n_layers, "p")
    if cl:
        consts["layers"] = cl
    params["ln_f"] = b.tensor("ln_f", (cfg.d_model,), "ones")
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
    (``models.common.presample``). With ``obs`` (a metrics Registry) the
    init's wall time, to the card's last draw, and the worker count land
    on its gauges ``init.seconds`` and ``init.sampling_workers``."""
    _check_family(cfg)
    device = resolve(device)
    t0 = time.perf_counter()
    plan, n_workers = presample(cfg, seed, lambda b: _build_lm(cfg, b),
                                workers)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = _build_lm(cfg, Builder(cfg, gen, device, seed=seed, plan=plan))
    if obs is not None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        obs.gauge("init.seconds", "wall seconds of the last model init"
                  ).set(time.perf_counter() - t0)
        obs.gauge("init.sampling_workers", "processes that sampled its "
                  "SLTrain supports (0: none to sample)").set(n_workers)
    return out


def embed_apply(cfg: ModelConfig, params, tokens, patch_embeds=None):
    """The model's input segment: the token embedding. Takes only the
    params it reads ({"embed": leaf}), so the per-layer sweep can
    differentiate it against exactly that leaf. (Patch embeddings are the
    vlm family's, not ported: ROADMAP queue A item 9.)"""
    if patch_embeds is not None:
        raise NotImplementedError(
            "patch embeddings (the vlm family) are not ported yet (ROADMAP "
            "queue A item 9: the other model families)")
    return params["embed"][tokens.long()]


def period_apply(cfg: ModelConfig, p, c, x):
    """One layer of the stack (the llama pattern's one-block period):
    (params {"k0": ...}, consts, x) → (x', aux). The per-layer backward
    sweep differentiates this exact function, so the train forward and
    the sweep's recompute cannot drift. The llama family has no auxiliary
    loss: aux is 0.0."""
    x, _ = _apply_block(cfg, p["k0"], c.get("k0", {}), x)
    return x, 0.0


def head_apply(cfg: ModelConfig, params, h):
    """Final norm and unembed. ``params`` needs only the head leaves:
    {"ln_f", "lm_head"} (untied) or {"ln_f", "embed"} (tied)."""
    h = rms_norm(h, params["ln_f"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ w.to(h.dtype)


def _layers(cfg: ModelConfig, params, consts):
    """The per-layer (params, consts) views of the stacks, in order."""
    n = params["layers"]["k0"]["ln_attn"].shape[0]
    return zip(unstack(params["layers"], n),
               unstack(consts.get("layers", {}), n))


def _walk(cfg: ModelConfig, params, consts, h, *, remat: str = "none",
          saves=None):
    """The layer stack, as ``apply_lm`` and ``forward_saving_boundaries``
    both run it; ``saves`` (a list) receives each layer's input."""
    _check_family(cfg)
    step = remat_wrap(lambda p, c, x: period_apply(cfg, p, c, x), remat)
    for p, c in _layers(cfg, params, consts):
        if saves is not None:
            saves.append(h)
        h, _ = step(p, c, h)
    return h


def apply_lm(cfg: ModelConfig, params, consts, tokens, *,
             remat: str = "none"):
    """tokens (B, S) → (logits (B, S, V), aux 0.0): the plain causal
    forward, differentiable in the params (the train step's forward),
    each layer under the ``remat`` policy (``models.common.remat_wrap``)."""
    h = embed_apply(cfg, params, tokens)
    h = _walk(cfg, params, consts, h, remat=remat)
    return head_apply(cfg, params, h), 0.0


def forward_saving_boundaries(cfg: ModelConfig, params, consts, tokens, *,
                              patch_embeds=None):
    """The same forward as :func:`apply_lm` up to the final norm, run
    without autograd, keeping each layer's input: the roots the per-layer
    backward sweep (``train/perlayer.py``) re-runs one layer at a time
    from. The saved boundaries are the only activations kept across
    layers.

    Returns a dict, as the reference's for the llama family (``xs`` a list
    where the reference stacks the inputs):
      xs    — the n layers' (B, S, d) inputs, the embedding's output first,
      h_top — the last layer's output (the head's input),
      aux   — (n_layers,) f32 zeros (the llama family has no aux loss).
    """
    with torch.no_grad():
        h0 = embed_apply(cfg, params, tokens, patch_embeds)
        xs = []
        h_top = _walk(cfg, params, consts, h0, saves=xs)
    return {"xs": xs, "h_top": h_top,
            "aux": torch.zeros(len(xs), dtype=torch.float32,
                               device=h0.device)}


def _forward(cfg: ModelConfig, params, consts, tokens, caches, **cache_kw):
    """Embed, the layers over their paged caches (one {"k", "v"} pool
    pair per layer), final norm and unembed: the serving steps' forward."""
    _check_family(cfg)
    h = embed_apply(cfg, params, tokens)
    for i, (p, c) in enumerate(_layers(cfg, params, consts)):
        h, _ = _apply_block(cfg, p["k0"], c.get("k0", {}), h,
                            cache=caches[i], **cache_kw)
    return head_apply(cfg, params, h)


# ---------------------------------------------------------------------------
# Serving (paged KV cache)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               paged: bool = False, block_len: int = 16, n_blocks: int = 0,
               device="cuda"):
    """Block-paged KV cache: {"layers": {"k0": {"k", "v"}}} with pools
    (n_layers, n_blocks, block_len, Hkv, hd) shared by every slot through a
    block table; ``n_blocks`` defaults to full capacity plus the null
    block. The contiguous layout (``paged=False``) is not ported yet."""
    if not paged:
        raise NotImplementedError(
            "the contiguous KV cache is not ported yet (ROADMAP queue A "
            "item 6: the paged=False engine path); pass paged=True")
    device = resolve(device)
    layout = PagedLayout.plan(batch, max_len, block_len, n_blocks)
    shape = (cfg.n_layers, layout.n_blocks, layout.block_len,
             cfg.n_kv_heads, cfg.resolved_head_dim)
    dt = DTYPES[cfg.dtype]
    return {"layers": {"k0": {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device)}}}


def _cached_forward(cfg: ModelConfig, params, consts, tokens, cache, index,
                    block_table, prefill: bool):
    """The layer walk shared by decode_step and prefill_step. The cache's
    pools are updated in place (views of each layer's pools); returns
    (logits, cache)."""
    pools = cache["layers"]["k0"]
    caches = [{"k": pools["k"][i], "v": pools["v"][i]}
              for i in range(pools["k"].shape[0])]
    logits = _forward(cfg, params, consts, tokens, caches,
                      cache_index=index, block_table=block_table,
                      prefill=prefill)
    return logits, cache


def decode_step(cfg: ModelConfig, params, consts, tokens, cache, index, *,
                block_table=None):
    """One decode step. tokens (B, 1); index a scalar position shared by
    the batch or a (B,) per-slot vector; ``block_table`` (B,
    blocks_per_slot) addresses the paged pools. Returns (logits, cache)."""
    return _cached_forward(cfg, params, consts, tokens, cache, index,
                           block_table, prefill=False)


def prefill_step(cfg: ModelConfig, params, consts, tokens, cache, *,
                 block_table=None, offsets=None):
    """Batched prefill of (B, S) prompts, writing K/V for their positions.
    Without ``offsets`` every row starts at position 0 and attends its own
    tokens; ``offsets`` (B,) switches to chunked suffix prefill at
    offsets[s] + [0, S), attending the slot's prior pages in place (the
    shared-prefix path). Returns (logits (B, S, V), cache)."""
    index = 0 if offsets is None else offsets.to(torch.int32)
    return _cached_forward(cfg, params, consts, tokens, cache, index,
                           block_table, prefill=True)
