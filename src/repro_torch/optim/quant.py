"""Blockwise 8-bit state quantization, ported from ``repro.optim.quant``:
a symmetric linear code for the signed first moment and a shifted
non-negative linear code for the second moment, one f32 scale per block
of ``block`` elements. The ``adam8bit`` kernel (``kernels/adam8bit.py``)
runs the same codec fused with the update; this is the plain path.

The reference writes the scales as ``max / 127.0`` and ``max / 255.0``.
It runs them compiled (inside the jitted train step and the Pallas
kernel), and XLA rewrites a division by a constant into a multiplication
by the constant's f32 reciprocal, so what the reference computes is
``max * f32(1/127)``. The port computes exactly that, and its codes and
scales equal the compiled reference's bit for bit.
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import numpy as np
import torch

# the f32 reciprocals XLA multiplies by in place of "/ 127.0", "/ 255.0"
INV_127 = float(np.float32(1.0 / 127.0))
INV_255 = float(np.float32(1.0 / 255.0))


def quantize_blockwise(x, block: int = 256, signed: bool = True):
    """x: any-shape float → (codes int8 (n_blocks, block), scales f32
    (n_blocks,), orig_len). The last block is zero-padded."""
    flat = x.reshape(-1).float()
    n = flat.numel()
    pad = (-n) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    if signed:
        scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) * INV_127
        codes = torch.round(blocks / torch.clamp(scale, min=1e-12))
    else:
        scale = torch.amax(blocks, dim=1, keepdim=True) * INV_255
        codes = torch.round(blocks / torch.clamp(scale, min=1e-12)) - 128.0
    return codes.to(torch.int8), scale[:, 0], n


def dequantize_blockwise(codes, scales, n, shape, signed: bool = True):
    """The f32 values of ``codes`` (n_blocks, block), cut to the first
    ``n`` and shaped as ``shape``. The unsigned code is floored at half a
    quantization step: a zero-quantized second moment would make the Adam
    update m / (sqrt(0) + eps) explode."""
    blocks = codes.float()
    if not signed:
        blocks = torch.clamp(blocks + 128.0, min=0.5)
    flat = (blocks * scales[:, None]).reshape(-1)[:n]
    return flat.reshape(shape)
