"""Quantized tile-CSR layout for the ``exec_mode="quant"`` decode path,
the port of ``repro.quant.layout``.

The bf16 sparse-decode kernel reads, per nonzero, an f32 tile value (4 B)
plus int32 local row and col indices (8 B): 12·δ B per cell. This layout
stores:

* ``qv_t``    int8  (nkt, nnt, cap) — quantized codes in tile order
* ``rows_q``  int16 (nkt, nnt, cap) — tile-local row index (< 128)
* ``cols_q``  int16 (nkt, nnt, cap) — tile-local col index (< 128)
* ``qscale``  f32   (nnt, TILE)     — per-output-channel scales, blocked
                                      by column tile

that is 1 + 2 + 2 = 5 B per nonzero plus a d_out-sized f32 scale vector.
The geometry is ``support.tile_cap`` / ``kernels.ops.prepare_tile_consts``
exactly, as for the fused consts. Everything here is host numpy, as in
the reference, so codes and scales are bit for bit the reference's on the
same inputs; :func:`build_quant_consts` returns CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import support as support_lib
from repro_torch.kernels import ops

TILE = support_lib.TILE

# bytes per nonzero read by each sparse decode path (the modeled HBM
# accounting):
#   bf16 tile-CSR: f32 value + int32 row + int32 col
#   int8 layout:   int8 code + int16 row + int16 col
BYTES_PER_NNZ_BF16 = 4 + 4 + 4
BYTES_PER_NNZ_INT8 = 1 + 2 + 2


def channel_scales(W: np.ndarray, *, clip_percentile: float | None = None
                   ) -> np.ndarray:
    """Symmetric per-output-channel int8 scales for a dense-equivalent
    (d_in, d_out) weight: absmax over each column / 127, optionally
    clipped to the ``clip_percentile``-th percentile of the column's
    |values|. Returns (d_out,) f32, floored away from zero so all-zero
    channels still divide cleanly."""
    absW = np.abs(np.asarray(W, np.float32))
    if clip_percentile is not None:
        amax = np.percentile(absW, clip_percentile, axis=0)
    else:
        amax = absW.max(axis=0)
    return (np.maximum(amax, 1e-8) / 127.0).astype(np.float32)


def quantize_values(v: np.ndarray, cols: np.ndarray, scales: np.ndarray
                    ) -> np.ndarray:
    """Flat COO sparse values → int8 codes against their column's scale.
    Codes clip to ±127 (symmetric; -128 unused so negation round-trips)."""
    q = np.round(np.asarray(v, np.float32) / scales[np.asarray(cols)])
    return np.clip(q, -127, 127).astype(np.int8)


def dequantize_values(qv: np.ndarray, cols: np.ndarray, scales: np.ndarray
                      ) -> np.ndarray:
    """Inverse of :func:`quantize_values` (f32)."""
    return qv.astype(np.float32) * scales[np.asarray(cols)]


def build_quant_consts(rows: np.ndarray, cols: np.ndarray, qv: np.ndarray,
                       scales: np.ndarray, d_in: int, d_out: int,
                       delta: float, support_kind: str) -> dict:
    """COO support + int8 codes + (d_out,) scales → the quantized tile-CSR
    consts {qv_t, rows_q, cols_q, qscale} at the ``support.tile_cap``
    capacity, as CPU tensors. Padding slots carry qv == 0 at local (0, 0)
    and contribute exactly 0 through the kernel; padded columns past
    d_out get scale 1.0 (never referenced)."""
    cap = support_lib.tile_cap(d_in, d_out, delta, support_kind)
    tiles = ops.prepare_tile_consts(np.asarray(rows), np.asarray(cols),
                                    d_in, d_out, pad=cap)
    perm = tiles["perm"].numpy()
    qv_flat = np.asarray(qv, np.int8).reshape(-1)
    qv_t = np.where(perm >= 0, qv_flat[np.maximum(perm, 0)], 0
                    ).astype(np.int8)
    nnt = perm.shape[1]
    sc = np.ones(nnt * TILE, np.float32)
    sc[:d_out] = np.asarray(scales, np.float32)
    return {"qv_t": torch.from_numpy(qv_t),
            "rows_q": tiles["rows_t"].to(torch.int16),
            "cols_q": tiles["cols_t"].to(torch.int16),
            "qscale": torch.from_numpy(sc.reshape(nnt, TILE))}


def sparse_decode_bytes(d_in: int, d_out: int, delta: float,
                        support_kind: str = "row_balanced", *,
                        quant: bool) -> int:
    """Modeled HBM bytes one decode step reads for the sparse term of one
    (d_in, d_out) matrix: the per-nonzero payload plus, for the quant
    layout, the per-channel f32 scale vector. Excludes the low-rank
    factors (the same bytes on both paths) and tile-cap padding (both
    layouts pad alike)."""
    nnz = support_lib.nnz_for(d_in, d_out, delta, support_kind)
    if quant:
        return nnz * BYTES_PER_NNZ_INT8 + d_out * 4
    return nnz * BYTES_PER_NNZ_BF16
