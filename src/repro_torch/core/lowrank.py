"""Low-rank linear baseline (paper baseline [24]): W = (alpha/r)·B·A, the
port of ``repro.core.lowrank``.

Both factors are random at init (pretraining from scratch, not LoRA
adaptation: a zero B would make W identically 0 with no signal), drawn
from the Builder's ``torch.Generator``: the reference's laws, not its
``jax.random`` bits.
"""
from __future__ import annotations

import math

import torch


def uniform(gen: torch.Generator, shape, lim: float, dtype, device):
    """U(-lim, lim) drawn in f32 from ``gen``, then cast to ``dtype``."""
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return ((u * 2.0 - 1.0) * lim).to(dtype)


def init_params(gen: torch.Generator, d_in: int, d_out: int, rank: int,
                dtype=torch.bfloat16, device="cuda"):
    """{"B": (d_in, rank), "A": (rank, d_out)}, both U(±sqrt(6/d_in))."""
    lim = math.sqrt(6.0 / d_in)
    return {"B": uniform(gen, (d_in, rank), lim, dtype, device),
            "A": uniform(gen, (rank, d_out), lim, dtype, device)}


def in_dtype(scale: float, dtype) -> float:
    """``scale`` rounded to ``dtype``, as a Python float: multiplying by
    it rounds once, as the reference's ``* jnp.asarray(scale, x.dtype)``
    does, with no tensor made on the device."""
    return float(torch.tensor(scale, dtype=dtype))


def lr_matmul(x, params, scale: float):
    """((x·B)·A)·scale, the scale in x's dtype: the d_in × d_out product
    is never formed."""
    return ((x @ params["B"]) @ params["A"]) * in_dtype(scale, x.dtype)
