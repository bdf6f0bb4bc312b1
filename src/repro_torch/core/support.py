"""Fixed random sparse support for SLTrain (paper §3.2, §3.3), a copy of
``repro.core.support`` that must stay bit-identical to it
(tests/test_torch_support.py holds the two together).

The support I is sampled once at init on the host (numpy), keyed by an
integer seed, and never learned:

  * ``sample_support`` — (rows, cols) int32, iid-uniform (paper) or
    row-balanced (each row gets exactly k = round(delta*d_out) entries).
  * ``nnz_for`` / ``tile_cap`` — deterministic sizes from the shape.
  * ``tile_layout`` — the tile-CSR layout the ``sl_matmul`` kernel reads:
    entries bucketed by 128×128 tile, padded to a uniform per-tile
    capacity with entries at local (0, 0) whose value is 0.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# Kernel tile edge: the sl_matmul kernel densifies W one TILE×TILE tile
# at a time.
TILE = 128

# Above this many elements the row-balanced sampler draws its random keys
# in row blocks instead of one (d_in, d_out) matrix (same PRNG stream, so
# both branches give identical supports). Module-level so tests can
# shrink it to exercise the blocked branch on small shapes.
DENSE_KEYS_ELEMS = 1 << 26


def nnz_for(d_in: int, d_out: int, delta: float, kind: str = "row_balanced") -> int:
    """Number of nonzeros; deterministic function of the shape and delta."""
    if kind == "row_balanced":
        k = max(1, int(round(delta * d_out)))
        return d_in * k
    return max(1, int(round(delta * d_in * d_out)))


def tile_cap(d_in: int, d_out: int, delta: float,
             kind: str = "row_balanced", tile_r: int = TILE,
             tile_c: int = TILE) -> int:
    """Deterministic per-tile capacity for the tile-CSR layout: mean
    entries per tile plus an 8·sqrt(mean) + 16 tail margin, clamped to the
    per-tile maximum and rounded up to a multiple of 8. Init re-samples
    the support in the rare case a tile overflows it."""
    rows_in_tile = min(tile_r, d_in)
    cols_in_tile = min(tile_c, d_out)
    if kind == "row_balanced":
        k = max(1, int(round(delta * d_out)))
        mean = rows_in_tile * k * (cols_in_tile / d_out)
        hard = rows_in_tile * min(k, cols_in_tile)
    else:
        nnz = nnz_for(d_in, d_out, delta, kind)
        mean = nnz * (rows_in_tile * cols_in_tile) / (d_in * d_out)
        hard = rows_in_tile * cols_in_tile
    cap = int(np.ceil(mean + 8.0 * np.sqrt(mean) + 16.0))
    cap = min(cap, int(hard))
    return max(8, ((cap + 7) // 8) * 8)


def _row_balanced_cols(rng: np.random.Generator, d_in: int, d_out: int,
                       k: int) -> np.ndarray:
    """Per-row k-subset sampling via argpartition of random keys, in row
    blocks above DENSE_KEYS_ELEMS (PCG64 fills C-order from one stream, so
    the blocked draw reproduces the full-matrix draw bit for bit)."""
    block = d_in if d_in * d_out <= DENSE_KEYS_ELEMS else \
        max(1, DENSE_KEYS_ELEMS // d_out)
    out = np.empty((d_in, k), dtype=np.int32)
    for i0 in range(0, d_in, block):
        b = min(block, d_in - i0)
        keys = rng.random((b, d_out), dtype=np.float32)
        if k >= d_out:          # degenerate: every column is in the support
            out[i0:i0 + b] = np.arange(d_out, dtype=np.int32)
        else:
            out[i0:i0 + b] = np.argpartition(keys, k, axis=1)[:, :k]
    return out


def sample_support(
    seed: int, d_in: int, d_out: int, delta: float, kind: str = "row_balanced"
) -> Tuple[np.ndarray, np.ndarray]:
    """Sample the fixed support. Returns (rows, cols) int32, row-major sorted."""
    rng = np.random.default_rng(np.uint64(seed))
    if kind == "row_balanced":
        k = max(1, int(round(delta * d_out)))
        cols = _row_balanced_cols(rng, d_in, d_out, k)
        cols.sort(axis=1)
        rows = np.repeat(np.arange(d_in, dtype=np.int32), k)
        return rows, cols.reshape(-1)
    nnz = nnz_for(d_in, d_out, delta, kind)
    total = d_in * d_out
    flat = rng.choice(total, size=nnz, replace=False)
    flat.sort()
    rows = (flat // d_out).astype(np.int32)
    cols = (flat % d_out).astype(np.int32)
    return rows, cols


def tile_layout(
    rows: np.ndarray,
    cols: np.ndarray,
    d_in: int,
    d_out: int,
    tile_r: int = TILE,
    tile_c: int = TILE,
    pad: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Bucket support entries by (row-tile, col-tile).

    Returns (perm, local_rc, tile_counts, pad_per_tile):
      * perm        int32[n_tiles * pad] — index into the original (rows,
                    cols, values) arrays, -1 for padding slots,
      * local_rc    int32[n_tiles * pad, 2] — (row, col) local to the
                    tile; padding slots point at (0, 0),
      * tile_counts int32[nt_r, nt_c] — real entries per tile,
      * pad_per_tile — the uniform per-tile capacity: the realized max
                    rounded up to a multiple of 8, or ``pad`` when given
                    (raises ``ValueError`` when the realized max exceeds
                    it, so callers can re-sample).
    """
    nt_r = (d_in + tile_r - 1) // tile_r
    nt_c = (d_out + tile_c - 1) // tile_c
    t_id = (rows // tile_r).astype(np.int64) * nt_c + (cols // tile_c)
    order = np.argsort(t_id, kind="stable")
    t_sorted = t_id[order]
    counts = np.bincount(t_sorted, minlength=nt_r * nt_c).astype(np.int32)
    max_count = int(counts.max()) if counts.size else 0
    if pad is None:
        pad = max(8, ((max_count + 7) // 8) * 8)
    elif max_count > pad:
        raise ValueError(
            f"tile_layout: realized per-tile max {max_count} exceeds the "
            f"requested capacity {pad} — re-sample the support")
    n_tiles = nt_r * nt_c
    perm = np.full((n_tiles, pad), -1, dtype=np.int32)
    local = np.zeros((n_tiles, pad, 2), dtype=np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for t in range(n_tiles):
        c = counts[t]
        if c == 0:
            continue
        idx = order[starts[t] : starts[t] + c]
        perm[t, :c] = idx
        local[t, :c, 0] = rows[idx] % tile_r
        local[t, :c, 1] = cols[idx] % tile_c
    return perm.reshape(-1), local.reshape(-1, 2), counts.reshape(nt_r, nt_c), pad
