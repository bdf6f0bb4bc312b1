"""SLTrain linear layer: W = (alpha/r)·B·A ⊕_I V (paper §3.2), the port
of ``repro.core.sltrain`` for the serving path (forward only).

Two support layouts, as in the reference: ``row_balanced`` (each row holds
exactly k = round(δ·d_out) entries; ``cols``/``v`` are (d_in, k) with
implicit rows) and ``iid`` (the paper's uniform sampling, flat COO).

Execution modes ported here:

* ``dense`` — densify W on the fly, then one matmul.
* ``fused`` — the hand-written ``sl_matmul`` kernel densifies W one
  128×128 tile at a time on chip and consumes it at once; W never reaches
  device memory. Needs the int32 tile consts {rows_t, cols_t, perm} that
  ``init_params(..., exec_mode="fused")`` emits at the deterministic
  ``support.tile_cap`` capacity.

``sparse`` and ``quant`` raise ``NotImplementedError`` until their slice
lands (ROADMAP queue A item 7).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import support as support_lib
from repro_torch.device import resolve

# Seed stride of the host-side re-sample when a sampled support exceeds
# the deterministic tile_cap bound; the reference's value, so both
# packages re-derive the same final support.
_RESAMPLE_STRIDE = 0x9E3779B1
_RESAMPLE_ATTEMPTS = 16


def prepare_fused_consts(rows, cols, d_in: int, d_out: int, delta: float,
                         support_kind: str, seed: int):
    """Tile consts {rows_t, cols_t, perm} at the ``support.tile_cap``
    capacity. Returns (rows, cols, consts): a support that busts the bound
    is re-sampled with a deterministically bumped seed."""
    from repro_torch.kernels import ops
    cap = support_lib.tile_cap(d_in, d_out, delta, support_kind)
    for attempt in range(_RESAMPLE_ATTEMPTS):
        try:
            tiles = ops.prepare_tile_consts(rows, cols, d_in, d_out, pad=cap)
            return rows, cols, tiles
        except ValueError:
            rows, cols = support_lib.sample_support(
                seed + (attempt + 1) * _RESAMPLE_STRIDE, d_in, d_out, delta,
                support_kind)
    raise ValueError(
        f"fused tile capacity {cap} too small for ({d_in}, {d_out}, "
        f"delta={delta}, {support_kind}) after {_RESAMPLE_ATTEMPTS} "
        "re-samples — support.tile_cap bound is broken for this shape")


def init_params(gen: torch.Generator, d_in: int, d_out: int, rank: int,
                delta: float, dtype=torch.bfloat16,
                support_kind: str = "row_balanced", seed: int = 0,
                exec_mode: str = "dense", device="cuda"):
    """(params, consts) with the reference's support, shapes and init
    laws (paper §3.3): Kaiming-uniform A, zero B, v ~ U[±1/sqrt(d_in)].
    Values come from ``gen`` (on ``device``); the support from the numpy
    sampler keyed by ``seed``, bit-identical to the reference."""
    device = resolve(device)
    lim_a = math.sqrt(6.0 / d_in)
    lim_v = 1.0 / math.sqrt(d_in)
    rows, cols = support_lib.sample_support(seed, d_in, d_out, delta,
                                            support_kind)
    tiles = None
    if exec_mode == "fused":
        rows, cols, tiles = prepare_fused_consts(
            rows, cols, d_in, d_out, delta, support_kind, seed)
    if support_kind == "row_balanced":
        k = cols.shape[0] // d_in
        v_shape = (d_in, k)
        consts = {"cols": torch.from_numpy(cols.reshape(d_in, k))}
    else:
        v_shape = (cols.shape[0],)
        consts = {"rows": torch.from_numpy(rows),
                  "cols": torch.from_numpy(cols)}
    if tiles is not None:
        consts.update(tiles)
    consts = {k: t.to(device) for k, t in consts.items()}

    def uniform(shape, lim):
        u = torch.rand(shape, generator=gen, device=device,
                       dtype=torch.float32)
        return ((u * 2.0 - 1.0) * lim).to(dtype)

    params = {
        "B": torch.zeros((d_in, rank), dtype=dtype, device=device),
        "A": uniform((rank, d_out), lim_a),
        "v": uniform(v_shape, lim_v),
    }
    return params, consts


# ---------------------------------------------------------------------------
# Densify
# ---------------------------------------------------------------------------

def _lowrank_dense(B, A, scale: float):
    return (scale * (B.float() @ A.float())).to(B.dtype)


def densify_rb(B, A, v, cols, scale: float):
    """Row-balanced densify: scale·B·A in f32, rounded to B.dtype, plus v
    at (implicit row, cols)."""
    W = _lowrank_dense(B, A, scale)
    rows = torch.arange(W.shape[0], device=W.device)[:, None].expand(
        cols.shape)
    return W.index_put_((rows, cols.long()), v.to(W.dtype), accumulate=True)


def densify_coo(B, A, v, rows, cols, scale: float):
    W = _lowrank_dense(B, A, scale)
    return W.index_put_((rows.long(), cols.long()), v.to(W.dtype),
                        accumulate=True)


def materialize(params, consts, scale: float):
    """Densified W (for export and tests)."""
    if "rows" not in consts:
        return densify_rb(params["B"], params["A"], params["v"],
                          consts["cols"], scale)
    return densify_coo(params["B"], params["A"], params["v"],
                       consts["rows"], consts["cols"], scale)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def sl_matmul(x, params, consts, scale: float, exec_mode: str = "dense"):
    """Apply one SLTrain linear (forward). params = {B, A, v}; consts =
    {cols[, rows][, rows_t, cols_t, perm]}."""
    if exec_mode in ("sparse", "quant"):
        raise NotImplementedError(
            f"exec_mode={exec_mode!r} is not ported yet (ROADMAP queue A "
            "item 7: sparse and int8 decode)")
    if exec_mode == "fused":
        if "perm" not in consts:
            raise ValueError(
                "exec_mode='fused' needs tile consts {rows_t, cols_t, perm} "
                "— init the layer with exec_mode='fused'")
        from repro_torch.kernels import ops
        return ops.sl_linear(x, params["B"], params["A"], params["v"],
                             consts["rows_t"], consts["cols_t"],
                             consts["perm"], scale)
    if exec_mode != "dense":
        raise ValueError(f"unknown exec_mode {exec_mode!r}")
    return x @ materialize(params, consts, scale)

