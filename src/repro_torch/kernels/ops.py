"""Wrappers around the kernels, as ``repro.kernels.ops`` has them: the
tile-CSR support preparation, the flat-``v`` tile gather, the SLTrain
linear of ``exec_mode="fused"`` (forward only) and the paged-attention
calls with the GQA regroup.

Dispatch follows the tensors: on the CPU each kernel wrapper runs its
plain PyTorch version, on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import support as support_lib
from repro_torch.kernels import paged_attention as pa_kernel
from repro_torch.kernels import sl_matmul as sl_kernel


# ---------------------------------------------------------------------------
# Tile-CSR support preparation (init time, host numpy)
# ---------------------------------------------------------------------------

def _tile_index_arrays(rows: np.ndarray, cols: np.ndarray, d_in: int,
                       d_out: int, tile_r: int, tile_c: int,
                       pad: int | None):
    """Pad dims to tile multiples, bucket the support and shape the index
    arrays: numpy (rows_t, cols_t, perm), each (K/tile_r, N/tile_c, E)
    int32."""
    kp = ((d_in + tile_r - 1) // tile_r) * tile_r
    np_ = ((d_out + tile_c - 1) // tile_c) * tile_c
    perm, local, counts, pad = support_lib.tile_layout(
        rows, cols, kp, np_, tile_r, tile_c, pad=pad)
    nkt, nnt = kp // tile_r, np_ // tile_c
    rt = local[:, 0].reshape(nkt, nnt, pad).astype(np.int32)
    ct = local[:, 1].reshape(nkt, nnt, pad).astype(np.int32)
    return rt, ct, perm.reshape(nkt, nnt, pad)


def prepare_tile_consts(rows: np.ndarray, cols: np.ndarray, d_in: int,
                        d_out: int, *, pad: int,
                        tile_r: int = support_lib.TILE,
                        tile_c: int = support_lib.TILE) -> dict:
    """Tile-CSR index consts for ``exec_mode="fused"``: {rows_t, cols_t,
    perm}, each int32 (K/tile_r, N/tile_c, pad), as CPU tensors. No values
    are baked in: the trainable ``v`` stays flat and is gathered into tile
    order through ``perm`` at each call. Raises ``ValueError`` when the
    sampled support exceeds the capacity ``pad`` (callers re-sample)."""
    rt, ct, perm = _tile_index_arrays(rows, cols, d_in, d_out, tile_r,
                                      tile_c, pad)
    return {"rows_t": torch.from_numpy(rt), "cols_t": torch.from_numpy(ct),
            "perm": torch.from_numpy(np.ascontiguousarray(perm))}


# ---------------------------------------------------------------------------
# The fused SLTrain linear (forward)
# ---------------------------------------------------------------------------

def _gather_tiles(v, perm):
    """Flat trainable v → f32 tile values through the layout permutation;
    padding slots (perm == -1) get exactly 0."""
    vf = v.reshape(-1).float()
    safe = perm.clamp(0, vf.shape[0] - 1).long()
    return torch.where(perm >= 0, vf[safe], torch.zeros((), device=vf.device))


def sl_matmul(x, B, A, v_t, rows_t, cols_t, scale: float):
    """y = x @ (scale·B·A ⊕ V) for x (..., K) of any leading shape and
    logical (unpadded) K and N. The reference pads x, B and A to tile
    multiples here; the CUDA kernel masks the ragged edge itself, so the
    port passes the logical shapes and copies nothing but a
    non-contiguous x."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = A.shape[-1]
    y = sl_kernel.sl_matmul(x.reshape(-1, k).contiguous(), B.contiguous(),
                            A.contiguous(), v_t, rows_t, cols_t, scale)
    return y.reshape(*lead, n)


def sl_linear(x, B, A, v, rows_t, cols_t, perm, scale: float):
    """y = x @ (scale·B·A ⊕ V) with the trainable ``v`` in its flat layout
    (row-balanced (d_in, k) or COO (nnz,)), gathered into tile order
    through ``perm`` for the kernel. Forward only: the backward kernels
    arrive with the training slice."""
    return sl_matmul(x, B, A, _gather_tiles(v, perm), rows_t, cols_t, scale)


# ---------------------------------------------------------------------------
# Paged attention (serve path)
# ---------------------------------------------------------------------------

def paged_attention(q, k_pool, v_pool, block_table, positions, *,
                    scale: float, softcap: float = 0.0, window: int = 0):
    """Decode attention over the paged pools. q (n_slots, H, hd), one
    query token per slot; GQA regroups q to (n_slots, Hkv, H/Hkv, hd) so
    each kv head's blocks serve its whole query group. Returns (n_slots,
    H, hd) in q.dtype."""
    n_slots, n_heads, hd = q.shape
    n_kv = k_pool.shape[2]
    if n_heads % n_kv:
        raise ValueError(f"paged_attention: {n_heads} heads not a multiple "
                         f"of {n_kv} kv heads")
    q4 = q.reshape(n_slots, n_kv, n_heads // n_kv, hd).contiguous()
    out = pa_kernel.paged_attention(
        q4, k_pool, v_pool, block_table.to(torch.int32).contiguous(),
        positions.to(torch.int32).contiguous(), scale=scale,
        softcap=softcap, window=window)
    return out.reshape(n_slots, n_heads, hd)


def paged_prefill_attention(q, k_pool, v_pool, block_table, offsets, *,
                            scale: float, softcap: float = 0.0,
                            window: int = 0):
    """Chunked-prefill attention over the paged pools. q (n_slots, sq, H,
    hd), each slot's suffix chunk at positions offsets[s] + [0, sq), its
    K/V already scattered into the pools. Returns (n_slots, sq, H, hd) in
    q.dtype."""
    n_slots, sq, n_heads, hd = q.shape
    n_kv = k_pool.shape[2]
    if n_heads % n_kv:
        raise ValueError(f"paged_prefill: {n_heads} heads not a multiple "
                         f"of {n_kv} kv heads")
    q5 = q.reshape(n_slots, sq, n_kv, n_heads // n_kv, hd).contiguous()
    out = pa_kernel.paged_prefill(
        q5, k_pool, v_pool, block_table.to(torch.int32).contiguous(),
        offsets.to(torch.int32).contiguous(), scale=scale, softcap=softcap,
        window=window)
    return out.reshape(n_slots, sq, n_heads, hd)
