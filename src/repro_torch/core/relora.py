"""ReLoRA baseline (paper baseline [32]): W = W0 + (alpha/r)·B·A with a
periodic merge and restart, the port of ``repro.core.relora``.

W0 is dense: ReLoRA is not parameter efficient, which is the paper's
point. As in the reference, W0 is an ordinary trainable leaf (its
forward has no stop-gradient, so the optimizer keeps moments for it and
updates it every step); the merge resets only B's and A's moments
(``train/trainer.py``). Values come from a ``torch.Generator``: the
reference's laws, not its ``jax.random`` bits.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.lowrank import in_dtype, uniform


def init_params(gen: torch.Generator, d_in: int, d_out: int, rank: int,
                dtype=torch.bfloat16, device="cuda"):
    """{"W0": N(0, 1)·sqrt(2/(d_in + d_out)), "B": 0, "A":
    U(±sqrt(6/d_in))}."""
    std = math.sqrt(2.0 / (d_in + d_out))
    w0 = torch.randn((d_in, d_out), generator=gen, device=device,
                     dtype=torch.float32) * std
    return {"W0": w0.to(dtype),
            "B": torch.zeros((d_in, rank), dtype=dtype, device=device),
            "A": uniform(gen, (rank, d_out), math.sqrt(6.0 / d_in), dtype,
                         device)}


def rl_matmul(x, params, scale: float):
    """x·W0 + ((x·B)·A)·scale, the scale in x's dtype."""
    y = x @ params["W0"]
    return y + ((x @ params["B"]) @ params["A"]) * in_dtype(scale, x.dtype)


def merge(params, gen: torch.Generator, scale: float):
    """Merge the adaptor into W0 and restart the factors (a ReLoRA period
    end): W0 += (scale·B·A in f32) cast to W0's dtype, B = 0, A redrawn
    U(±sqrt(6/d_in)) from ``gen``. Works on leaves stacked on leading
    layer axes. The caller also resets B's and A's optimizer moments."""
    B, A, W0 = params["B"], params["A"], params["W0"]
    BA = torch.matmul(B.float(), A.float()) * scale
    return {"W0": W0 + BA.to(W0.dtype),
            "B": torch.zeros_like(B),
            "A": uniform(gen, A.shape, math.sqrt(6.0 / B.shape[-2]), A.dtype,
                         A.device)}
