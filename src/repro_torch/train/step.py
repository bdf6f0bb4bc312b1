"""Serve-step builders, ported from ``repro.train.step``: one batched
decode step and one batched (suffix-)prefill, each ending in a greedy
argmax over the real vocabulary in f32. The training steps arrive with the
training slice (ROADMAP queue A item 3)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import ModelApi


def _greedy(logits, vocab_size: int):
    return torch.argmax(logits[..., :vocab_size].float(), dim=-1).to(
        torch.int32)


def make_serve_step(cfg: ModelConfig, api: ModelApi):
    """serve_step(params, consts, tokens, cache, index, block_table=None)
    -> (next_tokens (B, 1) int32, logits, cache). ``index`` is a scalar or
    a (B,) per-slot position vector; ``block_table`` addresses the paged
    pools."""
    def serve_step(params, consts, tokens, cache, index, block_table=None):
        logits, cache = api.decode_step(cfg, params, consts, tokens, cache,
                                        index, block_table=block_table)
        return _greedy(logits[:, -1], cfg.vocab_size)[:, None], logits, cache
    return serve_step


def make_prefill_step(cfg: ModelConfig, api: ModelApi):
    """prefill_step(params, consts, tokens, cache, lengths,
    block_table=None, offsets=None) -> (first_tokens (B, 1) int32, logits,
    cache): a batch of prompts (B, S) runs through one forward that writes
    their K/V, and each row's first output token is sampled from
    logits[s, lengths[s] - 1]. ``offsets`` switches to chunked suffix
    prefill (``lengths`` are then suffix lengths)."""
    def prefill_step(params, consts, tokens, cache, lengths, block_table=None,
                     offsets=None):
        logits, cache = api.prefill_step(cfg, params, consts, tokens, cache,
                                         block_table=block_table,
                                         offsets=offsets)
        rows = torch.arange(tokens.shape[0], device=logits.device)
        last_idx = (lengths.long() - 1).clamp(0, tokens.shape[1] - 1)
        nxt = _greedy(logits[rows, last_idx], cfg.vocab_size)
        return nxt[:, None], logits, cache
    return prefill_step
