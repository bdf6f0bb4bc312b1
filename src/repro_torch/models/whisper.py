"""Whisper-style encoder-decoder transformer, ported from
``repro.models.whisper``.

The audio front end is a stub, as in the reference: the caller gives
precomputed frame embeddings (B, encoder_seq, d_model). The backbone:
LayerNorm with bias, learned positions, the ungated GELU MLP (tanh
approximation), attention with qkv bias and no rope; the encoder attends
every frame, the decoder attends causally over its own tokens (the
contiguous cache when serving) and then, in every layer, every frame of
the encoder's output through a cross-attention whose k and v are
projected from that output at each call.

Parameters keep the reference's tree (``enc/*`` (encoder_layers, ...),
``dec/*`` (n_layers, ...), ``ln1/{w, b}`` ...); the Builder paths are the
reference's (``/enc/e{i}/attn/wq``, ``/dec/d{i}/xattn/wk``, the norms at
``ln1_w``), so the supports match it.

Serving keeps the reference's semantics: the cache holds the decoder's
self-attention k/v rows and ``enc_out`` (B, encoder_seq, d_model), which
``init_whisper_cache`` leaves at zero and only
``whisper_prefill_cache`` fills by running the encoder; the engine never
runs it (ROADMAP queue C, reference behaviour 9). There is no
``prefill_step``, so only the contiguous cache serves.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.models import attention, mlp
from repro_torch.models.common import (DTYPES, Builder, contiguous_only,
                                       init_model, layer_norm, remat_wrap,
                                       stack_layers, unstack)


def _ln(b: Builder, name: str, d: int):
    return {"w": b.tensor(f"{name}_w", (d,), "ones"),
            "b": b.tensor(f"{name}_b", (d,), "zeros")}


def _apply_ln(p, x, eps):
    return layer_norm(x, p["w"], p["b"], eps)


def _init_enc_block(b: Builder, cfg: ModelConfig):
    params, consts = {}, {}
    params["ln1"] = _ln(b, "ln1", cfg.d_model)
    params["attn"], c = attention.init_attention(b.sub("attn"), cfg)
    if c:
        consts["attn"] = c
    params["ln2"] = _ln(b, "ln2", cfg.d_model)
    params["mlp"], c = mlp.init_mlp(b.sub("mlp"), cfg, gated=False)
    if c:
        consts["mlp"] = c
    return params, consts


def _init_dec_block(b: Builder, cfg: ModelConfig):
    params, consts = _init_enc_block(b, cfg)
    params["ln_x"] = _ln(b, "ln_x", cfg.d_model)
    params["xattn"], c = attention.init_attention(b.sub("xattn"), cfg,
                                                  cross=True)
    if c:
        consts["xattn"] = c
    return params, consts


def _build_whisper(cfg: ModelConfig, b: Builder):
    d = cfg.d_model
    params, consts = {}, {}
    params["enc_pos"] = b.tensor("enc_pos", (cfg.encoder_seq, d), "normal",
                                 fan_in=d)
    params["enc"], ce = stack_layers(
        b.sub("enc"), lambda bb: _init_enc_block(bb, cfg),
        cfg.encoder_layers, "e")
    if ce:
        consts["enc"] = ce
    params["enc_ln"] = _ln(b, "enc_ln", d)
    params["embed"] = b.tensor("embed", (cfg.padded_vocab, d), "normal",
                               fan_in=d)
    params["dec_pos"] = b.tensor("dec_pos", (cfg.max_seq_len, d), "normal",
                                 fan_in=d)
    params["dec"], cd = stack_layers(
        b.sub("dec"), lambda bb: _init_dec_block(bb, cfg), cfg.n_layers, "d")
    if cd:
        consts["dec"] = cd
    params["dec_ln"] = _ln(b, "dec_ln", d)
    return params, consts


def init_whisper(cfg: ModelConfig, seed: int = 0, *, device="cuda",
                 workers: Optional[int] = None, obs=None):
    """(params, consts) on ``device``, supports bit for bit the
    reference's ``init_whisper(cfg, key, seed)``; values from a
    ``torch.Generator`` seeded with ``seed`` (``common.init_model``)."""
    return init_model(cfg, seed, lambda b: _build_whisper(cfg, b),
                      device=device, workers=workers, obs=obs)


def _layers(params, consts, key):
    n = params[key]["ln1"]["w"].shape[0]
    return list(zip(unstack(params[key], n), unstack(consts.get(key, {}), n)))


def encode(cfg: ModelConfig, params, consts, frames):
    """frames (B, encoder_seq, d_model) stub embeddings → the encoder's
    output, in frames' dtype."""
    h = frames + params["enc_pos"][None].to(frames.dtype)
    for p, c in _layers(params, consts, "enc"):
        a, _ = attention.apply_attention(
            cfg, p["attn"], c.get("attn", {}),
            _apply_ln(p["ln1"], h, cfg.norm_eps), causal=False)
        h = h + a
        m = mlp.apply_mlp(cfg, p["mlp"], c.get("mlp", {}),
                          _apply_ln(p["ln2"], h, cfg.norm_eps), act="gelu")
        h = h + m
    return _apply_ln(params["enc_ln"], h, cfg.norm_eps)


def _dec_block(cfg: ModelConfig, p, c, x, enc_out, *, cache=None,
               cache_index=None):
    """One decoder block: causal self-attention (over ``cache``'s rows when
    given), the cross-attention over ``enc_out``, the GELU MLP."""
    a, _ = attention.apply_attention(
        cfg, p["attn"], c.get("attn", {}), _apply_ln(p["ln1"], x, cfg.norm_eps),
        cache=cache, cache_index=cache_index)
    x = x + a
    xa, _ = attention.apply_attention(
        cfg, p["xattn"], c.get("xattn", {}),
        _apply_ln(p["ln_x"], x, cfg.norm_eps), causal=False,
        kv_source=enc_out)
    x = x + xa
    m = mlp.apply_mlp(cfg, p["mlp"], c.get("mlp", {}),
                      _apply_ln(p["ln2"], x, cfg.norm_eps), act="gelu")
    return x + m


def _head(cfg, params, h):
    h = _apply_ln(params["dec_ln"], h, cfg.norm_eps)
    return h @ params["embed"].T.to(h.dtype)


def apply_whisper(cfg: ModelConfig, params, consts, tokens, frames, *,
                  remat: str = "none"):
    """The teacher-forced training forward: tokens (B, S) and frames (B,
    encoder_seq, d) → (logits (B, S, V), 0.0); each decoder block under
    the ``remat`` policy."""
    enc_out = encode(cfg, params, consts, frames)
    s = tokens.shape[1]
    h = params["embed"][tokens.long()] \
        + params["dec_pos"][:s][None].to(DTYPES[cfg.dtype])
    step = remat_wrap(lambda p, c, x: _dec_block(cfg, p, c, x, enc_out),
                      remat)
    for p, c in _layers(params, consts, "dec"):
        h = step(p, c, h)
    return _head(cfg, params, h), 0.0


def init_whisper_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                       paged: bool = False, device="cuda", **_):
    """Zeros in the config's dtype: ``self`` {"k", "v"} (n_layers, B,
    max_len, Hkv, hd) and ``enc_out`` (B, encoder_seq, d_model)."""
    contiguous_only(paged)
    device = resolve(device)
    dt = DTYPES[cfg.dtype]
    kv = (cfg.n_layers, batch, max_len, cfg.n_kv_heads,
          cfg.resolved_head_dim)
    return {"self": {"k": torch.zeros(kv, dtype=dt, device=device),
                     "v": torch.zeros(kv, dtype=dt, device=device)},
            "enc_out": torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                                   dtype=dt, device=device)}


def whisper_prefill_cache(cfg: ModelConfig, params, consts, frames,
                          batch: int, max_len: int, *, device="cuda"):
    """A fresh cache whose ``enc_out`` is the encoder's output on
    ``frames`` (run once), in the config's dtype."""
    cache = init_whisper_cache(cfg, batch, max_len, device=device)
    cache["enc_out"] = encode(cfg, params, consts, frames).to(
        DTYPES[cfg.dtype])
    return cache


def whisper_decode_step(cfg: ModelConfig, params, consts, tokens, cache,
                        index, *, block_table=None):
    """One decode step on the contiguous cache: tokens (B, 1) at the shared
    position ``index`` (its learned position row clamped into the table,
    as ``lax.dynamic_slice`` clamps). Returns (logits, cache), the self
    k/v rows written in place."""
    contiguous_only(block_table)
    h = params["embed"][tokens.long()]
    row = min(max(int(index), 0), params["dec_pos"].shape[0] - 1)
    h = h + params["dec_pos"][row:row + 1][None].to(h.dtype)
    enc_out = cache["enc_out"]
    kv = cache["self"]
    for i, (p, c) in enumerate(_layers(params, consts, "dec")):
        h = _dec_block(cfg, p, c, h, enc_out,
                       cache={"k": kv["k"][i], "v": kv["v"][i]},
                       cache_index=index)
    return _head(cfg, params, h), cache
