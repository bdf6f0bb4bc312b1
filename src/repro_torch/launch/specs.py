"""Input stand-ins, ported from ``repro.launch.specs``: meta-device
batches (shapes without storage, the reference's ShapeDtypeStructs) and
concrete random batches. The modality frontends are stubs, as in the
reference: whisper gets frame embeddings, paligemma patch embeddings."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.models.common import DTYPES


def _generator(gen, seed: int, device) -> torch.Generator:
    if gen is not None:
        return gen
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def input_specs(cfg: ModelConfig, batch: int, seq: int,
                abstract: bool = True, gen=None, device="cpu"):
    """A training or prefill batch for ``cfg``: {"tokens" (batch, seq)
    int32} plus whisper's "frames" (batch, encoder_seq, d_model) or the
    vlm's "patches" (batch, min(n_patches, seq), d_model) in the model's
    dtype. ``abstract`` gives meta tensors; else tokens uniform over the
    vocabulary and embeddings N(0, 0.02²), drawn from ``gen`` (default:
    seeded 0 for tokens, 1 for embeddings, as the reference's keys)."""
    dt = DTYPES[cfg.dtype]

    def tok(shape):
        if abstract:
            return torch.empty(shape, dtype=torch.int32, device="meta")
        g = _generator(gen, 0, device)
        return torch.randint(0, cfg.vocab_size, shape, generator=g,
                             device=device, dtype=torch.int32)

    def emb(shape):
        if abstract:
            return torch.empty(shape, dtype=dt, device="meta")
        g = _generator(gen, 1, device)
        return (torch.randn(shape, generator=g, device=device) * 0.02).to(dt)

    out = {"tokens": tok((batch, seq))}
    if cfg.family == "whisper":
        out["frames"] = emb((batch, cfg.encoder_seq, cfg.d_model))
    elif cfg.family == "vlm":
        out["patches"] = emb((batch, min(cfg.n_patches, seq), cfg.d_model))
    return out


def decode_inputs(cfg: ModelConfig, batch: int, cache_len: int,
                  abstract: bool = True, gen=None, device="cpu"):
    """(tokens (batch, 1) int32, index ()) for one decode step against a
    cache of ``cache_len``: meta tensors, or random tokens at index
    cache_len - 1."""
    if abstract:
        return (torch.empty((batch, 1), dtype=torch.int32, device="meta"),
                torch.empty((), dtype=torch.int32, device="meta"))
    g = _generator(gen, 2, device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, 1), generator=g,
                           device=device, dtype=torch.int32)
    return tokens, torch.tensor(cache_len - 1, dtype=torch.int32,
                                device=device)


def cell_batch(cfg: ModelConfig, cell: ShapeCell, abstract: bool = True):
    """The batch of a train or prefill shape cell (None for the decode
    cells, which use :func:`decode_inputs` and a cache)."""
    if cell.kind in ("train", "prefill"):
        return input_specs(cfg, cell.global_batch, cell.seq_len, abstract)
    return None
