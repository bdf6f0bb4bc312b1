"""Wrappers around the kernels, as ``repro.kernels.ops`` has them: the
tile-CSR support preparation, the flat-``v`` tile gather, the SLTrain
linear of ``exec_mode="fused"`` (a ``torch.autograd.Function`` whose
forward and dx run ``sl_matmul`` and whose dV runs ``sddmm``; and its
grouped form over an MoE layer's stacked experts, one launch of each
kernel for all of them), the 8-bit
Adam step on a list of leaves in one launch and on one leaf of any
shape, the paged-attention calls with the
GQA regroup, the factored decode of ``exec_mode="sparse"`` and
``"quant"`` (the low-rank term as f32 matmuls, the sparse term through
the ``sparse_matmul`` or ``quant_sparse_matmul`` kernel), and the
trainable sparse linear (a ``torch.autograd.Function`` whose forward and
dx run ``sparse_matmul`` and whose dV runs ``sddmm``); on a mesh, the
fused and the sparse linear's tensor-parallel island (each rank's column
tiles forward and backward, the reference's ``_fused_grads_dist``); the
decode and the
trainable sparse linear also over an MoE layer's stacked experts, one
grouped launch of each kernel for all of them.

Dispatch follows the tensors: on the CPU each kernel wrapper runs its
plain PyTorch version, on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import support as support_lib
from repro_torch.dist import compat
from repro_torch.dist import sharding as dist_sharding
from repro_torch.kernels import adam8bit as adam8bit_kernel
from repro_torch.kernels import paged_attention as pa_kernel
from repro_torch.kernels import sddmm as sddmm_kernel
from repro_torch.kernels import sl_matmul as sl_kernel
from repro_torch.kernels import sparse_decode as sd_kernel


# ---------------------------------------------------------------------------
# Tile-CSR support preparation (init time, host numpy)
# ---------------------------------------------------------------------------

def prepare_tile_consts(rows: np.ndarray, cols: np.ndarray, d_in: int,
                        d_out: int, *, pad: int,
                        tile_r: int = support_lib.TILE,
                        tile_c: int = support_lib.TILE) -> dict:
    """Tile-CSR index consts for ``exec_mode="fused"``: {rows_t, cols_t,
    perm}, each int32 (K/tile_r, N/tile_c, pad), as CPU tensors. No values
    are baked in: the trainable ``v`` stays flat and is gathered into tile
    order through ``perm`` at each call. Raises ``ValueError`` when the
    sampled support exceeds the capacity ``pad`` (callers re-sample)."""
    arrays = support_lib.tile_index_arrays(rows, cols, d_in, d_out, pad,
                                           tile_r, tile_c)
    return {k: torch.from_numpy(a)
            for k, a in zip(support_lib.TILE_CONSTS, arrays)}


def transpose_tiles(t):
    """A tile array (..., nkt, nnt, cap) with its two tile axes swapped,
    contiguous: the layout of Wᵀ's tiles."""
    return t.transpose(-3, -2).contiguous()


def add_transposed_tiles(consts):
    """Give every fused linear in a consts tree the tile consts of Wᵀ that
    the backward's dx call takes: ``rows_tT`` (Wᵀ's local rows, i.e. the
    transposed ``cols_t``) and ``cols_tT`` (the transposed ``rows_t``).
    The trainer calls this once on the consts of init, so the transposes
    are built once per layer, not per step; it works on single layers and
    on stacked (L, nkt, nnt, cap) arrays alike. Returns a new tree; the
    arrays it shares are not copied. (Init's consts stay the reference's
    tree, leaf for leaf.)"""
    if not isinstance(consts, dict):
        return consts
    out = {k: add_transposed_tiles(v) for k, v in consts.items()}
    if "rows_t" in out and "rows_tT" not in out:
        out["rows_tT"] = transpose_tiles(out["cols_t"])
        out["cols_tT"] = transpose_tiles(out["rows_t"])
    return out


# ---------------------------------------------------------------------------
# The fused SLTrain linear: sl_matmul forward and dx, sddmm dV
# ---------------------------------------------------------------------------

def _gather_tiles(v, perm):
    """Flat trainable v → f32 tile values through the layout permutation;
    padding slots (perm == -1) get exactly 0."""
    return _gather_tiles_grouped(v[None], perm[None])[0]


def _scatter_tiles(dv_t, perm, numel: int):
    """f32 tile grads → flat f32 grad of v through ``perm``."""
    return _scatter_tiles_grouped(dv_t[None], perm[None], numel)[0]


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


def sddmm(x, dy, rows_t, cols_t):
    """dv tiles (K/128, N/128, cap) f32 for the support (rows_t, cols_t);
    x (..., K), dy (..., N). dy is cast to x's dtype first, as the
    reference does (``ops.py:130``); products and sums stay f32."""
    k = x.shape[-1]
    n = dy.shape[-1]
    return sddmm_kernel.sddmm(x.reshape(-1, k).contiguous(),
                              dy.reshape(-1, n).to(x.dtype).contiguous(),
                              rows_t, cols_t)


def _lowrank_grads(xf, dyf, B, A, scale: float):
    """(dB, dA, dy·Aᵀ in f32) of the low-rank term for x (M, K), dy (M,
    N), or of each expert's for a stack x (E, M, K), dy (E, M, N) (batched
    products: XLA's batched dots under the reference's vmap). The products
    take f32 operands and give f32 results, as the reference's
    ``preferred_element_type=f32`` does: a bf16 product returning bf16
    would round the token contraction through bf16."""
    f32 = torch.float32
    xB = xf.to(f32) @ B.to(f32)                                  # (M, r)
    dA = (scale * (xB.mT @ dyf.to(f32))).to(A.dtype)
    dyA = dyf.to(f32) @ A.to(f32).mT                             # (M, r)
    dB = (scale * (xf.to(f32).mT @ dyA)).to(B.dtype)
    return dB, dA, dyA


def _fused_grads(x, B, A, v_t, rows_t, cols_t, rows_tT, cols_tT,
                 scale: float, dy):
    """Backward of the fused linear: (dx, dB, dA, dv_t f32), the local path
    of the reference's ``_fused_grads``.

    dB and dA come from :func:`_lowrank_grads` in f32. (PyTorch's f32
    matmul keeps full f32 on the card unless TF32 is turned on, which the
    port never does.) dV is the ``sddmm`` kernel's f32 output; dx is
    ``sl_matmul`` on the transposed factors and Wᵀ's tile consts, with
    v_t's tile axes swapped."""
    k = x.shape[-1]
    n = dy.shape[-1]
    dy = dy.to(x.dtype)
    xf = x.reshape(-1, k)
    dyf = dy.reshape(-1, n)
    dB, dA, _ = _lowrank_grads(xf, dyf, B, A, scale)
    dv_t = sddmm(xf, dyf, rows_t, cols_t)
    dx = sl_matmul(dyf, A.T.contiguous(), B.T.contiguous(),
                   transpose_tiles(v_t), rows_tT, cols_tT, scale)
    return dx.reshape(x.shape).to(x.dtype), dB, dA, dv_t


class _SLLinear(torch.autograd.Function):
    """y = x @ (scale·B·A ⊕ V) with the flat trainable ``v``. Residuals are
    factored-sized (x, B, A, the f32 tile values): the dense W is never
    saved, only ever built one 128×128 tile at a time inside the
    kernels."""

    @staticmethod
    def forward(ctx, x, B, A, v, rows_t, cols_t, perm, rows_tT, cols_tT,
                scale):
        v_t = _gather_tiles(v, perm)
        ctx.save_for_backward(x, B, A, v, v_t, rows_t, cols_t, perm,
                              rows_tT, cols_tT)
        ctx.scale = scale
        return sl_matmul(x, B, A, v_t, rows_t, cols_t, scale)

    @staticmethod
    def backward(ctx, dy):
        x, B, A, v, v_t, rows_t, cols_t, perm, rows_tT, cols_tT = \
            ctx.saved_tensors
        _need_transposed_tiles(rows_tT, "sl_linear")
        dx, dB, dA, dv_t = _fused_grads(x, B, A, v_t, rows_t, cols_t,
                                        rows_tT, cols_tT, ctx.scale, dy)
        dv = _scatter_tiles(dv_t, perm, v.numel())
        return (dx, dB, dA, dv.reshape(v.shape).to(v.dtype), None, None,
                None, None, None, None)


def sl_linear(x, B, A, v, rows_t, cols_t, perm, scale: float, *,
              rows_tT=None, cols_tT=None):
    """y = x @ (scale·B·A ⊕ V) with the trainable ``v`` in its flat layout
    (row-balanced (d_in, k) or COO (nnz,)), gathered into tile order
    through ``perm`` for the kernel; differentiable in x, B, A and v.
    ``rows_tT``/``cols_tT`` are Wᵀ's tile consts for the dx call
    (:func:`add_transposed_tiles` builds them once per layer); the
    backward raises without them, and a forward-only caller never needs
    them. On a mesh where the TP island engages
    (``dist.sharding.island_mesh``) it runs :class:`_SLLinearTP`."""
    loc = _tp_local(x, A, rows_t, cols_t, perm, rows_tT, cols_tT)
    if loc is not None:
        return _SLLinearTP.apply(x, B, A, v, loc, scale)
    return _SLLinear.apply(x, B, A, v, rows_t, cols_t, perm, rows_tT,
                           cols_tT, scale)


# ---------------------------------------------------------------------------
# Tensor parallelism: the fused and sparse linears on a rank's column tiles
# ---------------------------------------------------------------------------

class _Local:
    """One rank's column slice of a tiled linear on a mesh whose model
    axis has TP ranks: its d_out columns ``cols`` of A and, in ``t``, its
    column tiles of the tile consts (..., nkt, nnt/TP, cap) and of Wᵀ's
    (..., nnt/TP, nkt, cap), any leading dims a layer stack's. Tile-CSR
    indices are local to their 128×128 tile, so the sliced consts address
    this rank's columns with no index arithmetic; ``perm`` still indexes
    the whole flat ``v``, which every rank holds in full. A training
    island cuts one for each call (:func:`_tp_local`); a serving mesh cuts
    one at engine construction (:func:`serving_columns`), with the tiles'
    values already gathered (``v_t``) or quant's int8 tiles, and rebuilds
    the holder around them in each dispatch (:func:`sl_linear_columns`).
    :meth:`forward` is the one forward of both."""

    def __init__(self, mesh, A, tiles):
        """A holder of this rank's slice: A's columns and the tiles
        (cut by :meth:`cut`)."""
        dl, m = A.shape[-1], mesh.coords["model"]
        self.mesh, self.A, self.t = mesh, A, tiles
        self.d_out = dl * mesh.shape["model"]
        self.cols = slice(m * dl, (m + 1) * dl)

    @classmethod
    def cut(cls, mesh, A, consts, keys, v=None):
        """This rank's slice of the full ``A`` and of ``consts``' tile
        leaves ``keys`` (and Wᵀ's ``rows_tT``/``cols_tT`` where present);
        with ``v``, the f32 values of this rank's tiles gathered from the
        whole ``v`` through its ``perm`` tiles, which then are dropped."""
        tp, m = mesh.shape["model"], mesh.coords["model"]
        nl = consts[keys[0]].shape[-2] // tp
        dl = A.shape[-1] // tp
        tiles = slice(m * nl, (m + 1) * nl)
        t = {k: consts[k][..., tiles, :].contiguous() for k in keys}
        for k in ("rows_tT", "cols_tT"):
            if consts.get(k) is not None:
                t[k] = consts[k][..., tiles, :, :].contiguous()
        if v is not None:
            perm = t.pop("perm")
            n = int(np.prod(perm.shape[:-3]))
            t["v_t"] = _gather_tiles_grouped(
                v.reshape(n, -1), perm.reshape(n, *perm.shape[-3:])).reshape(
                perm.shape)
        return cls(mesh, A[..., m * dl:(m + 1) * dl].contiguous(), t)

    def forward(self, x, B, scale: float, exec_mode: str, v_t=None,
                gather: bool = True):
        """y = x @ W on this rank's columns: exec_mode fused runs
        ``sl_matmul``, sparse the factored decode (``sparse_matmul``),
        quant its int8 form (``quant_sparse_matmul``); ``v_t`` the tile
        values where the slice does not hold them. Then the output
        columns are all-gathered, unless ``gather`` is False (the caller
        reads this rank's columns alone)."""
        t = self.t
        if exec_mode == "quant":
            y = sl_quant_decode(x, B, self.A, *(t[k] for k in _QUANT_TILES),
                                scale)
        else:
            v_t = t["v_t"] if v_t is None else v_t
            fn = sl_decode if exec_mode == "sparse" else sl_matmul
            y = fn(x, B, self.A, v_t, t["rows_t"], t["cols_t"], scale)
        return self.gather_out(y) if gather else y

    def gather_out(self, y):
        """(..., d_out) from each rank's (..., d_out/TP) columns."""
        return dist_sharding.gather_last(y, self.mesh)

    def psum(self, t):
        """f32 ``t`` summed over the model ranks (in place)."""
        compat.all_reduce(t, self.mesh.group("model"))
        return t

    def full_dA(self, dA_loc):
        """dA of the full (r, d_out) leaf holding this rank's columns; the
        other columns are zero, and only this rank's are read
        (``dist.sharding.reduce_grad`` keeps its model chunk of A)."""
        out = torch.zeros(dA_loc.shape[:-1] + (self.d_out,),
                          dtype=dA_loc.dtype, device=dA_loc.device)
        out[..., self.cols] = dA_loc
        return out

    def dv(self, dv_t, v):
        """The flat ``v``'s gradient from this rank's tile grads, summed
        over the model ranks (each holds the support entries of its own
        columns)."""
        dv = _scatter_tiles(dv_t, self.t["perm"], v.numel())
        return self.psum(dv).reshape(v.shape).to(v.dtype)


def _tp_lowrank_grads(xf, dyf, B, A_loc, scale: float, loc: _Local):
    """(dB summed over the model ranks, this rank's dA columns, the
    partial dy·Aᵀ in f32): the reference island's dA = scale·(x·B)ᵀ·dy_loc
    and dB = psum_model(scale·xᵀ·(dy_loc·A_locᵀ)), summed in f32."""
    f32 = torch.float32
    xB = xf.to(f32) @ B.to(f32)
    dA = scale * (xB.T @ dyf.to(f32))
    dyA = dyf.to(f32) @ A_loc.to(f32).T
    dB = loc.psum(scale * (xf.to(f32).T @ dyA))
    return dB.to(B.dtype), dA.to(A_loc.dtype), dyA


def _tp_dy(dy, x, loc: _Local):
    """This rank's columns of the replicated dy, (M, d_out/TP) in x's
    dtype."""
    return dy[..., loc.cols].reshape(-1, loc.A.shape[-1]).to(
        x.dtype).contiguous()


class _SLLinearTP(torch.autograd.Function):
    """The fused linear on a mesh (:func:`sl_linear` where
    ``dist.sharding.island_mesh`` engages): the forward runs ``sl_matmul``
    on this rank's column tiles and all-gathers the output columns; the
    backward is :func:`_fused_grads_dist`."""

    @staticmethod
    def forward(ctx, x, B, A, v, loc, scale):
        v_t = _gather_tiles(v, loc.t["perm"])
        ctx.save_for_backward(x, B, v, v_t)
        ctx.loc, ctx.scale = loc, scale
        return loc.forward(x, B, scale, "fused", v_t)

    @staticmethod
    def backward(ctx, dy):
        x, B, v, v_t = ctx.saved_tensors
        _need_transposed_tiles(ctx.loc.t.get("rows_tT"), "sl_linear")
        dx, dB, dA, dv = _fused_grads_dist(x, B, v, v_t, ctx.scale, dy,
                                           ctx.loc)
        return dx, dB, dA, dv, None, None


def _fused_grads_dist(x, B, v, v_t, scale: float, dy, loc: _Local):
    """The reference's ``_fused_grads_dist`` on this rank's slice ``loc``:
    (dx, dB, dA of the full leaf (this rank's columns), dv) from the
    local columns of the replicated dy. dV by ``sddmm`` on the local
    tiles, dx by ``sl_matmul`` on Wᵀ's local tiles, each summed over the
    model ranks in f32 (dx, dB, dv), as the reference psums them."""
    xf = x.reshape(-1, x.shape[-1])
    dyf = _tp_dy(dy, x, loc)
    dB, dA, _ = _tp_lowrank_grads(xf, dyf, B, loc.A, scale, loc)
    t = loc.t
    dv_t = sddmm(xf, dyf, t["rows_t"], t["cols_t"])
    dx = sl_matmul(dyf, loc.A.T.contiguous(), B.T.contiguous(),
                   transpose_tiles(v_t), t["rows_tT"], t["cols_tT"], scale)
    dx = loc.psum(dx.float()).to(x.dtype).reshape(x.shape)
    return dx, dB, loc.full_dA(dA), loc.dv(dv_t, v)


class _SLSparseTP(torch.autograd.Function):
    """The trainable sparse linear on a mesh (:func:`sl_sparse_linear`
    where the island engages): :func:`sl_decode` on this rank's column
    tiles and A's columns, the output columns all-gathered; the backward
    keeps the local slice of the replicated dy: dV by ``sddmm`` on the
    local tiles, dx = scale·(dy·Aᵀ)·Bᵀ + dy·Sᵀ (``sparse_matmul`` over Wᵀ's
    local tiles) summed over the model ranks in f32, dB summed, dA this
    rank's columns."""

    @staticmethod
    def forward(ctx, x, B, A, v, loc, scale):
        v_t = _gather_tiles(v, loc.t["perm"])
        ctx.save_for_backward(x, B, v, v_t)
        ctx.loc, ctx.scale = loc, scale
        return loc.forward(x, B, scale, "sparse", v_t)

    @staticmethod
    def backward(ctx, dy):
        x, B, v, v_t = ctx.saved_tensors
        loc, scale = ctx.loc, ctx.scale
        t = loc.t
        _need_transposed_tiles(t.get("rows_tT"), "the sparse linear's")
        k = x.shape[-1]
        xf = x.reshape(-1, k)
        dyf = _tp_dy(dy, x, loc)
        dB, dA, dyA = _tp_lowrank_grads(xf, dyf, B, loc.A, scale, loc)
        dv_t = sddmm(xf, dyf, t["rows_t"], t["cols_t"])
        dx = scale * (dyA @ B.to(torch.float32).T) + sd_kernel.sparse_matmul(
            dyf, transpose_tiles(v_t), t["rows_tT"], t["cols_tT"], k,
            torch.float32)
        dx = loc.psum(dx).to(x.dtype).reshape(x.shape)
        return dx, dB, loc.full_dA(dA), loc.dv(dv_t, v), None, None


def _tp_local(x, A, rows_t, cols_t, perm, rows_tT, cols_tT):
    """This rank's :class:`_Local` slice where the TP island engages for
    this call (``dist.sharding.island_mesh``), else None."""
    mesh = dist_sharding.island_mesh(x, A.shape[-1], nnt=rows_t.shape[1])
    if mesh is None:
        return None
    return _Local.cut(mesh, A, {"rows_t": rows_t, "cols_t": cols_t,
                                "perm": perm, "rows_tT": rows_tT,
                                "cols_tT": cols_tT}, _TILES)


# ---------------------------------------------------------------------------
# Serving on a mesh: the decode linears on a rank's column tiles
# ---------------------------------------------------------------------------

_TILES = ("rows_t", "cols_t", "perm")
_QUANT_TILES = ("qv_t", "rows_q", "cols_q", "qscale")


def serving_columns(p, c, mesh, exec_mode: str, batch: int, *,
                    local: bool = False):
    """(params, consts) of one SLTrain linear (leaves with any leading
    stack dims) as a serving mesh's rank holds it, built once at engine
    construction. Where the island engages
    (``dist.sharding.island_engages`` at the global ``batch``): B whole,
    this rank's :class:`_Local` slice (A's columns; exec_mode fused and
    sparse the f32 values of its column tiles, gathered from the whole
    ``v`` once, here, and ``rows_t``/``cols_t``; quant the int8 codes,
    their int16 indices and the tiles' rows of ``qscale``) with its tiles
    under consts ``"tp"``, or ``"tp_heads"`` where ``local`` (the
    attention's q/k/v projection on a mesh whose cache shards the heads:
    its columns are this rank's heads, kept local, the bias cut to them;
    elsewhere the bias stays whole, added after the all-gather).
    Elsewhere the leaves as they are."""
    keys = _QUANT_TILES if exec_mode == "quant" else _TILES
    if keys[0] not in c:
        return p, c
    if not dist_sharding.island_engages(mesh, p["B"].shape[-2],
                                        p["A"].shape[-1], batch,
                                        nnt=c[keys[0]].shape[-2]):
        return p, c
    loc = _Local.cut(mesh, p["A"], {k: c[k] for k in keys}, keys,
                     v=None if exec_mode == "quant" else p["v"])
    out = {"B": p["B"], "A": loc.A}
    if "bias" in p:
        out["bias"] = p["bias"][..., loc.cols].contiguous() if local \
            else p["bias"]
    return out, {"tp_heads" if local else "tp": loc.t}


def sl_linear_columns(x, B, A, tiles, scale: float, exec_mode: str, *,
                      gather: bool = True):
    """y = x @ W of a linear a serving mesh holds as this rank's column
    slice (:func:`serving_columns`), through :meth:`_Local.forward` under
    the ambient mesh; ``gather`` False keeps this rank's columns.
    Forward only."""
    mesh = dist_sharding.ambient_mesh()
    if mesh is None:
        raise ValueError("a linear held as a rank's column slice runs under "
                         "its serving mesh (dist.sharding.use_mesh)")
    if torch.is_grad_enabled() and (x.requires_grad or B.requires_grad):
        raise ValueError("a serving mesh's column slices are forward-only: "
                         "train on a mesh through the Trainer")
    return _Local(mesh, A, tiles).forward(x, B, scale, exec_mode,
                                          gather=gather)


# ---------------------------------------------------------------------------
# The fused linear over a stack of experts: grouped sl_matmul and sddmm
# ---------------------------------------------------------------------------

def _gather_tiles_grouped(v, perm):
    """:func:`_gather_tiles` of each expert: v (E, ...) flat per expert,
    perm (E, nkt, nnt, cap) → f32 (E, nkt, nnt, cap); padding slots
    (perm == -1) get exactly 0."""
    n_exp = perm.shape[0]
    vf = v.reshape(n_exp, -1).float()
    safe = perm.reshape(n_exp, -1).clamp(0, vf.shape[1] - 1).long()
    vals = torch.gather(vf, 1, safe).reshape(perm.shape)
    return torch.where(perm >= 0, vals, torch.zeros((), device=vf.device))


def _scatter_tiles_grouped(dv_t, perm, per_expert: int):
    """:func:`_scatter_tiles` of each expert: f32 (E, per_expert) grads of
    the flat v stack. Every valid perm entry appears exactly once an
    expert (the tile-layout invariant), so a plain scatter is exact and no
    accumulating one is needed: the result is the same on every run.
    Padding slots all write one spare column past the end, which is
    dropped."""
    n_exp = perm.shape[0]
    idx = torch.where(perm >= 0, perm, per_expert).reshape(n_exp, -1).long()
    flat = torch.zeros((n_exp, per_expert + 1), dtype=torch.float32,
                       device=dv_t.device)
    flat.scatter_(1, idx, dv_t.reshape(n_exp, -1))
    return flat[:, :per_expert]


class _SLLinearGrouped(torch.autograd.Function):
    """y[e] = x[e] @ (scale·B[e]·A[e] ⊕ V[e]) for a stack of E fused
    linears of one shape (an MoE layer's experts): the forward is one
    grouped ``sl_matmul`` launch, dx one grouped ``sl_matmul`` on the
    transposed factors and Wᵀ's tiles, dV one grouped ``sddmm``, dB and dA
    batched f32 products. Residuals are factored-sized, as
    :class:`_SLLinear`'s."""

    @staticmethod
    def forward(ctx, x, B, A, v, rows_t, cols_t, perm, rows_tT, cols_tT,
                scale):
        v_t = _gather_tiles_grouped(v, perm)
        ctx.save_for_backward(x, B, A, v, v_t, rows_t, cols_t, perm,
                              rows_tT, cols_tT)
        ctx.scale = scale
        return sl_kernel.sl_matmul_grouped(x, B, A, v_t, rows_t, cols_t,
                                           scale)

    @staticmethod
    def backward(ctx, dy):
        x, B, A, v, v_t, rows_t, cols_t, perm, rows_tT, cols_tT = \
            ctx.saved_tensors
        _need_transposed_tiles(rows_tT, "sl_linear_grouped")
        scale = ctx.scale
        dy = dy.to(x.dtype).contiguous()
        dB, dA, _ = _lowrank_grads(x, dy, B, A, scale)
        dv_t = sddmm_kernel.sddmm_grouped(x, dy, rows_t, cols_t)
        dx = sl_kernel.sl_matmul_grouped(
            dy, A.transpose(1, 2).contiguous(), B.transpose(1, 2).contiguous(),
            transpose_tiles(v_t), rows_tT, cols_tT, scale)
        dv = _scatter_tiles_grouped(dv_t, perm, v[0].numel())
        return (dx.to(x.dtype), dB, dA, dv.reshape(v.shape).to(v.dtype),
                None, None, None, None, None, None)


def sl_linear_grouped(x, B, A, v, rows_t, cols_t, perm, scale: float, *,
                      rows_tT=None, cols_tT=None):
    """:func:`sl_linear` over a stack of E experts' linears of one shape:
    x (E, M, K), B (E, K, r), A (E, r, N), the flat v stack (E, ...), the
    tile consts (E, nkt, nnt, cap) and, for the backward, Wᵀ's (E, nnt,
    nkt, cap) (:func:`add_transposed_tiles` builds them on stacked consts
    too); differentiable in x, B, A and v. Returns (E, M, N)."""
    return _SLLinearGrouped.apply(x.contiguous(), B.contiguous(),
                                  A.contiguous(), v, rows_t, cols_t, perm,
                                  rows_tT, cols_tT, scale)


# ---------------------------------------------------------------------------
# 8-bit Adam (leaves and layer slices of any shape)
# ---------------------------------------------------------------------------

def adam8bit_scalars(*, lr, b1, b2, bc1, bc2, eps, wd, omb1=None, omb2=None,
                     device):
    """The kernel's (10,) f32 scalars [lr, b1, b2, 1-b1, 1-b2, bc1, bc2,
    eps, wd, 0] on ``device``; ``lr``/``bc1``/``bc2`` may be device
    tensors (the optimizer's step-dependent values, read without a host
    sync). ``omb1``/``omb2`` default to ``1 - b1``/``1 - b2`` computed in
    Python double, then rounded to f32, as the reference's wrapper does:
    an f32 ``1 - b2`` would lose about half the bits of the ~1e-3
    difference."""
    if omb1 is None:
        omb1 = 1.0 - b1
    if omb2 is None:
        omb2 = 1.0 - b2
    vals = (lr, b1, b2, omb1, omb2, bc1, bc2, eps, wd, 0.0)
    if not any(isinstance(x, torch.Tensor) for x in vals):
        return torch.tensor(vals, dtype=torch.float32, device=device)
    return torch.stack([torch.as_tensor(x, dtype=torch.float32,
                                        device=device).reshape(())
                        for x in vals])


def adam8bit_group_update(items, *, scalars, clip=None):
    """One fused 8-bit Adam step on several leaves or layer slices at
    once, written in place: ``items`` are (p, g, m_codes, m_scales,
    v_codes, v_scales, decay) with p contiguous (any shape, f32 or bf16),
    g of p's size (f32 or bf16, read as it is), the moments' codes and
    scales of ceil(p.numel() / 256) blocks, and ``decay`` whether
    ``scalars[8]``'s weight decay applies. ``clip`` (an f32 device scalar
    or None) multiplies every gradient first. On the card: one launch of
    the ``adam8bit`` kernel for the whole list (up to its segment limit);
    a ragged tail is read in place, nothing is padded or copied."""
    adam8bit_kernel.adam8bit_group(
        [adam8bit_kernel.Segment(p, g.contiguous(), *rest)
         for p, g, *rest in items], scalars, clip)


def adam8bit_update(p, g, m_codes, m_scales, v_codes, v_scales, *,
                    lr=None, b1=None, b2=None, bc1=None, bc2=None, eps=None,
                    wd=None, q: int = 256, omb1=None, omb2=None,
                    scalars=None, inplace: bool = False):
    """One fused 8-bit Adam step on a leaf of any shape: p (any shape, f32
    or bf16) and its gradient g (the same size, f32 or bf16), the moments'
    codes (n_q, q) int8 and scales (n_q,) f32. The step's scalars come
    one by one, as the reference takes them, or prebuilt by
    :func:`adam8bit_scalars` as ``scalars``. The one-segment case of
    :func:`adam8bit_group_update` (no clip, weight decay from the
    scalars).

    Returns (new_p (p's shape), m_codes, m_scales, v_codes, v_scales).
    With ``inplace`` the new values are written into p and the given
    codes and scales (which keep their storage), and those are
    returned."""
    if q != adam8bit_kernel.Q:
        raise ValueError(f"adam8bit: q_block {q}; the kernel takes "
                         f"{adam8bit_kernel.Q}-element blocks")
    if scalars is None:
        scalars = adam8bit_scalars(lr=lr, b1=b1, b2=b2, bc1=bc1, bc2=bc2,
                                   eps=eps, wd=wd, omb1=omb1, omb2=omb2,
                                   device=p.device)
    state = (m_codes, m_scales, v_codes, v_scales)
    if inplace:
        pw = p.contiguous()
    else:
        state = tuple(t.clone() for t in state)
        pw = p.clone(memory_format=torch.contiguous_format)
    adam8bit_group_update([(pw, g, *state, True)], scalars=scalars)
    if inplace and pw is not p:
        p.copy_(pw)
    return (p if inplace else pw, *state)


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


# ---------------------------------------------------------------------------
# Factored decode (the sparse-only kernels + the low-rank term)
# ---------------------------------------------------------------------------

def _lowrank_f32(xf, B, A, scale: float):
    """(x·B)·A·scale with f32 operands and results: bf16 intermediate
    roundings would drift from the densified path. x (M, K), or a stack
    (E, M, K) with B (E, K, r) and A (E, r, N): batched products."""
    f32 = torch.float32
    return ((xf.to(f32) @ B.to(f32)) @ A.to(f32)) * scale


def sl_decode(x, B, A, v_t, rows_t, cols_t, scale: float):
    """SLTrain linear without densifying W, ``exec_mode="sparse"``:
    (x·B)·A·scale in f32 plus x·S from the ``sparse_matmul`` kernel (S as
    f32 tile-CSR) with an f32 output, summed in f32 and rounded once to
    x.dtype, as the reference's sparse mode (``_sl_matmul_sparse``) does.
    (The reference's Pallas wrapper ``ops.sl_decode``, which no model path
    of the reference calls, rounds the kernel's term to x.dtype first.)
    x (..., K) of any leading shape; K and N need no padding."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = A.shape[-1]
    xf = x.reshape(-1, k).contiguous()
    y_sp = sd_kernel.sparse_matmul(xf, v_t, rows_t, cols_t, n, torch.float32)
    y = _lowrank_f32(xf, B, A, scale) + y_sp
    return y.to(x.dtype).reshape(*lead, n)


def sl_quant_decode(x, B, A, qv_t, rows_q, cols_q, qscale, scale: float):
    """Quantized SLTrain linear, ``exec_mode="quant"``: (x·B)·A·scale in
    f32 (B and A the error-folded factors of quant.calibrate) plus
    x·dequant(S) from the ``quant_sparse_matmul`` kernel (int8 codes,
    int16 tile-local indices, per-channel f32 scales), summed in f32 and
    rounded to x.dtype."""
    lead = x.shape[:-1]
    k = x.shape[-1]
    n = A.shape[-1]
    xf = x.reshape(-1, k).contiguous()
    y_sp = sd_kernel.quant_sparse_matmul(xf, qv_t, rows_q, cols_q, qscale, n)
    y = _lowrank_f32(xf, B, A, scale) + y_sp.to(torch.float32)
    return y.to(x.dtype).reshape(*lead, n)


def sl_decode_grouped(x, B, A, v_t, rows_t, cols_t, scale: float):
    """:func:`sl_decode` over a stack of E experts' linears of one shape
    (an MoE layer's, under the reference's vmap): x (E, M, K), B (E, K,
    r), A (E, r, N), the f32 tile values and their int32 indices (E, nkt,
    nnt, cap). The low-rank term is batched f32 products, the sparse term
    one ``sparse_matmul_grouped`` launch with an f32 output; summed in f32
    and rounded once to x.dtype. Returns (E, M, N)."""
    x = x.contiguous()
    y_sp = sd_kernel.sparse_matmul_grouped(x, v_t, rows_t, cols_t,
                                           A.shape[-1], torch.float32)
    return (_lowrank_f32(x, B, A, scale) + y_sp).to(x.dtype)


def sl_quant_decode_grouped(x, B, A, qv_t, rows_q, cols_q, qscale,
                            scale: float):
    """:func:`sl_quant_decode` over a stack of E experts' linears of one
    shape: x (E, M, K), B (E, K, r), A (E, r, N), the int8 layout (E, nkt,
    nnt, cap) and qscale (E, nnt, 128). The low-rank term is batched f32
    products, the sparse term one ``quant_sparse_matmul_grouped`` launch;
    summed in f32 and rounded to x.dtype. Returns (E, M, N)."""
    x = x.contiguous()
    y_sp = sd_kernel.quant_sparse_matmul_grouped(x, qv_t, rows_q, cols_q,
                                                 qscale, A.shape[-1])
    return (_lowrank_f32(x, B, A, scale) + y_sp.to(torch.float32)).to(
        x.dtype)


# ---------------------------------------------------------------------------
# The trainable sparse linear: sparse_matmul forward and dx, sddmm dV
# ---------------------------------------------------------------------------

def _need_transposed_tiles(rows_tT, what: str) -> None:
    if rows_tT is None:
        raise ValueError(
            f"{what} backward needs Wᵀ's tile consts (rows_tT, cols_tT): "
            "build them once per layer with "
            "kernels.ops.add_transposed_tiles")


class _SLSparse(torch.autograd.Function):
    """y = (x·B)·A·scale + x·S of ``exec_mode="sparse"`` (:func:`sl_decode`),
    differentiable in x, B, A and the flat ``v``: the function and (by
    the reference's autodiff) the gradient of ``_sl_matmul_sparse``,
    which accumulates in f32 end to end and rounds once. dB and dA as the
    fused linear's (:func:`_lowrank_grads`); dV from the ``sddmm`` kernel at the
    tile consts, put back through ``perm``; dx = scale·(dy·Aᵀ)·Bᵀ in f32
    plus dy·Sᵀ from the ``sparse_matmul`` kernel over Wᵀ's tiles, returned
    in f32 so that the sum is rounded to x.dtype once. Residuals are x,
    the factors and the f32 tile values; W is never formed."""

    @staticmethod
    def forward(ctx, x, B, A, v, rows_t, cols_t, perm, rows_tT, cols_tT,
                scale):
        v_t = _gather_tiles(v, perm)
        ctx.save_for_backward(x, B, A, v, v_t, rows_t, cols_t, perm,
                              rows_tT, cols_tT)
        ctx.scale = scale
        return sl_decode(x, B, A, v_t, rows_t, cols_t, scale)

    @staticmethod
    def backward(ctx, dy):
        x, B, A, v, v_t, rows_t, cols_t, perm, rows_tT, cols_tT = \
            ctx.saved_tensors
        _need_transposed_tiles(rows_tT, "the sparse linear's")
        scale = ctx.scale
        k = x.shape[-1]
        dyf = dy.reshape(-1, dy.shape[-1]).to(x.dtype).contiguous()
        xf = x.reshape(-1, k)
        dB, dA, dyA = _lowrank_grads(xf, dyf, B, A, scale)
        dv_t = sddmm(xf, dyf, rows_t, cols_t)
        dx_sp = sd_kernel.sparse_matmul(dyf, transpose_tiles(v_t), rows_tT,
                                        cols_tT, k, torch.float32)
        dx = scale * (dyA @ B.to(torch.float32).T) + dx_sp
        dv = _scatter_tiles(dv_t, perm, v.numel())
        return (dx.to(x.dtype).reshape(x.shape), dB, dA,
                dv.reshape(v.shape).to(v.dtype), None, None, None, None,
                None, None)


def sl_sparse_linear(x, B, A, v, rows_t, cols_t, perm, scale: float, *,
                     rows_tT=None, cols_tT=None):
    """The trainable ``exec_mode="sparse"`` linear: y = (x·B)·A·scale + x·S
    with the flat ``v`` gathered into tile order through ``perm``,
    differentiable in x, B, A and v. ``rows_tT``/``cols_tT`` are Wᵀ's tile
    consts for dx (:func:`add_transposed_tiles`); the backward raises
    without them. On a mesh where the TP island engages it runs
    :class:`_SLSparseTP`."""
    loc = _tp_local(x, A, rows_t, cols_t, perm, rows_tT, cols_tT)
    if loc is not None:
        return _SLSparseTP.apply(x, B, A, v, loc, scale)
    return _SLSparse.apply(x, B, A, v, rows_t, cols_t, perm, rows_tT,
                           cols_tT, scale)


class _SLSparseGrouped(torch.autograd.Function):
    """:class:`_SLSparse` over a stack of E experts' linears of one shape:
    the forward is :func:`sl_decode_grouped` (one ``sparse_matmul_grouped``
    launch), dx one ``sparse_matmul_grouped`` launch over Wᵀ's tiles plus
    batched f32 products, dV one ``sddmm_grouped`` launch, dB and dA
    batched f32 products."""

    @staticmethod
    def forward(ctx, x, B, A, v, rows_t, cols_t, perm, rows_tT, cols_tT,
                scale):
        v_t = _gather_tiles_grouped(v, perm)
        ctx.save_for_backward(x, B, A, v, v_t, rows_t, cols_t, perm,
                              rows_tT, cols_tT)
        ctx.scale = scale
        return sl_decode_grouped(x, B, A, v_t, rows_t, cols_t, scale)

    @staticmethod
    def backward(ctx, dy):
        x, B, A, v, v_t, rows_t, cols_t, perm, rows_tT, cols_tT = \
            ctx.saved_tensors
        _need_transposed_tiles(rows_tT, "the grouped sparse linear's")
        scale = ctx.scale
        dy = dy.to(x.dtype).contiguous()
        dB, dA, dyA = _lowrank_grads(x, dy, B, A, scale)
        dv_t = sddmm_kernel.sddmm_grouped(x, dy, rows_t, cols_t)
        dx_sp = sd_kernel.sparse_matmul_grouped(
            dy, transpose_tiles(v_t), rows_tT, cols_tT, x.shape[-1],
            torch.float32)
        dx = scale * (dyA @ B.to(torch.float32).mT) + dx_sp
        dv = _scatter_tiles_grouped(dv_t, perm, v[0].numel())
        return (dx.to(x.dtype), dB, dA, dv.reshape(v.shape).to(v.dtype),
                None, None, None, None, None, None)


def sl_sparse_linear_grouped(x, B, A, v, rows_t, cols_t, perm, scale: float,
                             *, rows_tT=None, cols_tT=None):
    """:func:`sl_sparse_linear` over a stack of E experts' linears of one
    shape (shapes as :func:`sl_linear_grouped`'s); differentiable in x, B,
    A and v. Returns (E, M, N)."""
    return _SLSparseGrouped.apply(x.contiguous(), B, A, v, rows_t, cols_t,
                                  perm, rows_tT, cols_tT, scale)
