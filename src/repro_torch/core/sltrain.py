"""SLTrain linear layer: W = (alpha/r)·B·A ⊕_I V (paper §3.2), the port
of ``repro.core.sltrain``.

Two support layouts, as in the reference: ``row_balanced`` (each row holds
exactly k = round(δ·d_out) entries; ``cols``/``v`` are (d_in, k) with
implicit rows) and ``iid`` (the paper's uniform sampling, flat COO).

Execution modes ported here:

* ``dense`` — densify W on the fly, then one matmul; a
  ``torch.autograd.Function`` whose backward is the paper's eq. (2): G =
  xᵀ·dy formed in f32, dB = scale·G·Aᵀ, dA = scale·Bᵀ·G, dV = G at the
  support, dx = dy·Wᵀ with W recomputed, never saved.
* ``fused`` — the hand-written ``sl_matmul`` kernel densifies W one
  128×128 tile at a time on chip and consumes it at once, forward and dx;
  the ``sddmm`` kernel forms dV (``kernels/ops.sl_linear``). W never
  reaches device memory. Needs the int32 tile consts {rows_t, cols_t,
  perm} that ``init_params(..., exec_mode="fused")`` emits at the
  deterministic ``support.tile_cap`` capacity; the trainer adds Wᵀ's
  {rows_tT, cols_tT} for dx once (``kernels.ops.add_transposed_tiles``).

* ``sparse`` — the factored path: (x·B)·A·scale in f32 plus x·S from
  the hand-written ``sparse_matmul`` kernel over the same tile consts as
  ``fused`` (``init_params(..., exec_mode="sparse")`` emits them too); W
  is never formed (``kernels/ops.sl_decode``); the kernel's term stays
  f32 and the sum is rounded once. The reference's sparse mode runs the
  same math as an XLA scatter (``_sl_matmul_sparse``) and trains through
  its autodiff; here a call that needs a gradient goes through
  ``kernels/ops.sl_sparse_linear``, whose dx runs
  ``sparse_matmul`` over Wᵀ's tiles and whose dV runs ``sddmm``.
* ``quant`` — the int8 decode of a calibrated quant artifact
  (``repro_torch.quant``): the same low-rank term plus x·dequant(S) from
  the ``quant_sparse_matmul`` kernel (``kernels/ops.sl_quant_decode``).
  Forward-only, as in the reference: int8 codes are not trainable.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import support as support_lib
from repro_torch.core.lowrank import uniform
from repro_torch.device import resolve

# exec modes whose kernels read the tile consts {rows_t, cols_t, perm}
TILED_MODES = ("fused", "sparse", "quant")


def support_spec(d_in: int, d_out: int, delta: float, support_kind: str,
                 seed: int, exec_mode: str) -> tuple:
    """The ``support.final_support`` arguments of one linear: its seed
    and shape, and the ``support.tile_cap`` capacity where ``exec_mode``
    needs tile consts (None otherwise)."""
    cap = support_lib.tile_cap(d_in, d_out, delta, support_kind) \
        if exec_mode in TILED_MODES else None
    return seed, d_in, d_out, delta, support_kind, cap


def init_params(gen: torch.Generator, d_in: int, d_out: int, rank: int,
                delta: float, dtype=torch.bfloat16,
                support_kind: str = "row_balanced", seed: int = 0,
                exec_mode: str = "dense", device="cuda", support=None):
    """(params, consts) with the reference's support, shapes and init
    laws (paper §3.3): Kaiming-uniform A, zero B, v ~ U[±1/sqrt(d_in)].
    Values come from ``gen`` (on ``device``); the support from the numpy
    sampler keyed by ``seed``, bit-identical to the reference, or, given
    as ``support``, from ``support.final_support(*support_spec(...))``
    already run (the Builder samples every linear's in a pool first).
    ``exec_mode`` "fused", "sparse" and "quant" add the tile consts
    {rows_t, cols_t, perm} that their kernels read, at the deterministic
    ``support.tile_cap`` capacity (a support that busts it is re-sampled
    with a bumped seed, as the reference does; the reference's sparse
    mode emits only the support: its XLA path reads it directly)."""
    device = resolve(device)
    lim_a = math.sqrt(6.0 / d_in)
    lim_v = 1.0 / math.sqrt(d_in)
    if support is None:
        support = support_lib.final_support(*support_spec(
            d_in, d_out, delta, support_kind, seed, exec_mode))
    rows, cols, tiles = support
    if support_kind == "row_balanced":
        k = cols.shape[0] // d_in
        v_shape = (d_in, k)
        consts = {"cols": torch.from_numpy(cols.reshape(d_in, k))}
    else:
        v_shape = (cols.shape[0],)
        consts = {"rows": torch.from_numpy(rows),
                  "cols": torch.from_numpy(cols)}
    if tiles is not None:
        consts.update(zip(support_lib.TILE_CONSTS, map(torch.from_numpy,
                                                       tiles)))
    consts = {k: t.to(device) for k, t in consts.items()}

    params = {
        "B": torch.zeros((d_in, rank), dtype=dtype, device=device),
        "A": uniform(gen, (rank, d_out), lim_a, dtype, device),
        "v": uniform(gen, v_shape, lim_v, dtype, device),
    }
    return params, consts


def abstract_params(d_in: int, d_out: int, rank: int, delta: float,
                    dtype=torch.bfloat16, support_kind: str = "row_balanced",
                    exec_mode: str = "dense"):
    """Meta-tensor twin of :func:`init_params` (shapes and dtypes, no
    support sampled), as the reference's ``abstract_params``; the tile
    consts' shapes are exact at the deterministic ``support.tile_cap``."""
    nnz = support_lib.nnz_for(d_in, d_out, delta, support_kind)
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    params = {"B": meta((d_in, rank), dtype), "A": meta((rank, d_out), dtype)}
    if support_kind == "row_balanced":
        params["v"] = meta((d_in, nnz // d_in), dtype)
        consts = {"cols": meta((d_in, nnz // d_in), torch.int32)}
    else:
        params["v"] = meta((nnz,), dtype)
        consts = {"rows": meta((nnz,), torch.int32),
                  "cols": meta((nnz,), torch.int32)}
    if exec_mode in TILED_MODES:
        tile = support_lib.TILE
        shape = (-(-d_in // tile), -(-d_out // tile),
                 support_lib.tile_cap(d_in, d_out, delta, support_kind))
        consts.update({k: meta(shape, torch.int32)
                       for k in support_lib.TILE_CONSTS})
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
# Dense-mode matmul with the paper's eq.-(2) backward
# ---------------------------------------------------------------------------

def _grads_from_G(xf, dyf, B, A, scale: float):
    """(G f32, dB, dA) from the token contraction G = xᵀ·dy, taken with f32
    operands so it accumulates in f32 (the reference's
    ``preferred_element_type=f32``), never rounded through bf16."""
    f32 = torch.float32
    G = xf.to(f32).T @ dyf.to(f32)
    dB = (scale * (G @ A.to(f32).T)).to(B.dtype)
    dA = (scale * (B.to(f32).T @ G)).to(A.dtype)
    return G, dB, dA


def _grads_distributed(x, dy, B, A, v, cols, scale: float, mesh):
    """The reference's distributed eq. (2) (``_grads_distributed``) on a
    mesh where ``dist.sharding.island_mesh`` engages: each rank forms only
    its local G slice xᵀ·dy_loc (d_in × d_out/TP, its d_out columns of the
    replicated dy), and the r- and k-sized results are summed over the
    model ranks instead of the d_in × d_out G: dB = psum(scale·G_loc·A_locᵀ),
    dA = scale·Bᵀ·G_loc (this rank's columns of the full leaf, zero
    elsewhere, which ``dist.sharding.reduce_grad`` never reads), dV = G at
    the support entries whose column is this rank's, psum'd. ``cols`` is
    read whole (replicated, as the reference's island in_specs have it).
    The sums over the batch ranks follow in the train step."""
    from repro_torch.dist import compat
    f32 = torch.float32
    tp, m = mesh.shape["model"], mesh.coords["model"]
    d_in, d_out = x.shape[-1], dy.shape[-1]
    dl = d_out // tp
    own = slice(m * dl, (m + 1) * dl)
    xl = x.reshape(-1, d_in).to(f32)
    dyl = dy.reshape(-1, d_out)[:, own].to(f32)
    G = xl.T @ dyl
    group = mesh.group("model")
    dB = scale * (G @ A[:, own].to(f32).T)
    compat.all_reduce(dB, group)
    dA = torch.zeros(A.shape, dtype=f32, device=A.device)
    dA[:, own] = scale * (B.to(f32).T @ G)
    cl = cols.long() - m * dl
    ok = (cl >= 0) & (cl < dl)
    dv = torch.where(ok, G.gather(1, cl.clamp(0, dl - 1)),
                     torch.zeros((), dtype=f32, device=G.device))
    compat.all_reduce(dv, group)
    return dB.to(B.dtype), dA.to(A.dtype), dv.to(v.dtype)


class _DenseRB(torch.autograd.Function):
    """Row-balanced dense mode: y = x @ densify_rb(...). Residuals are the
    factored params and x (Alg. 1): the backward recomputes W. On a mesh
    where ``dist.sharding.island_mesh`` engages, dB, dA and dV come from
    :func:`_grads_distributed`; dx is the full dy·Wᵀ on every rank, as the
    reference's."""

    @staticmethod
    def forward(ctx, x, B, A, v, cols, scale):
        ctx.save_for_backward(x, B, A, v, cols)
        ctx.scale = scale
        return x @ densify_rb(B, A, v, cols, scale)

    @staticmethod
    def backward(ctx, dy):
        x, B, A, v, cols = ctx.saved_tensors
        scale = ctx.scale
        dy = dy.to(x.dtype)
        xf = x.reshape(-1, x.shape[-1])
        dyf = dy.reshape(-1, dy.shape[-1])
        from repro_torch.dist import sharding as dist_sharding
        mesh = dist_sharding.island_mesh(x, dy.shape[-1])
        if mesh is not None:
            dB, dA, dv = _grads_distributed(x, dy, B, A, v, cols, scale, mesh)
        else:
            G, dB, dA = _grads_from_G(xf, dyf, B, A, scale)
            dv = G.gather(1, cols.long()).to(v.dtype)
            del G
        W = densify_rb(B, A, v, cols, scale)
        dx = (dyf @ W.T).reshape(x.shape).to(x.dtype)
        return dx, dB, dA, dv, None, None


class _DenseCOO(torch.autograd.Function):
    """COO (iid support) dense mode, as :class:`_DenseRB`. Like the
    reference's COO backward it takes dy as it comes."""

    @staticmethod
    def forward(ctx, x, B, A, v, rows, cols, scale):
        ctx.save_for_backward(x, B, A, v, rows, cols)
        ctx.scale = scale
        return x @ densify_coo(B, A, v, rows, cols, scale)

    @staticmethod
    def backward(ctx, dy):
        x, B, A, v, rows, cols = ctx.saved_tensors
        scale = ctx.scale
        xf = x.reshape(-1, x.shape[-1])
        dyf = dy.reshape(-1, dy.shape[-1])
        G, dB, dA = _grads_from_G(xf, dyf, B, A, scale)
        dv = G[rows.long(), cols.long()].to(v.dtype)
        W = densify_coo(B, A, v, rows, cols, scale)
        dx = (dyf @ W.T).reshape(x.shape).to(x.dtype)
        return dx, dB, dA, dv, None, None, None


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def sl_matmul(x, params, consts, scale: float, exec_mode: str = "dense"):
    """Apply one SLTrain linear, differentiable in x and the params.
    params = {B, A, v}; consts = {cols[, rows][, rows_t, cols_t, perm,
    rows_tT, cols_tT][, qv_t, rows_q, cols_q, qscale]}, or on a serving
    mesh {tp: this rank's column tiles} (its output columns all-gathered)
    or {tp_heads: ...} (its columns kept local: ``kernels.ops.
    serving_columns``). Mode "quant" and a rank's column slice are
    forward-only."""
    tiles = consts.get("tp", consts.get("tp_heads"))
    if tiles is not None:
        from repro_torch.kernels import ops
        return ops.sl_linear_columns(x, params["B"], params["A"], tiles,
                                     scale, exec_mode, gather="tp" in consts)
    if exec_mode in ("sparse", "quant"):
        return _decode(x, params, consts, scale, exec_mode)
    if exec_mode == "fused":
        check_exec_consts(exec_mode, x, params, consts)
        from repro_torch.kernels import ops
        return ops.sl_linear(x, params["B"], params["A"], params["v"],
                             consts["rows_t"], consts["cols_t"],
                             consts["perm"], scale,
                             rows_tT=consts.get("rows_tT"),
                             cols_tT=consts.get("cols_tT"))
    if exec_mode != "dense":
        raise ValueError(f"unknown exec_mode {exec_mode!r}")
    if "rows" not in consts:
        return _DenseRB.apply(x, params["B"], params["A"], params["v"],
                              consts["cols"], scale)
    return _DenseCOO.apply(x, params["B"], params["A"], params["v"],
                           consts["rows"], consts["cols"], scale)


def check_exec_consts(exec_mode: str, x, params, consts) -> bool:
    """Raise where the consts lack what exec_mode "fused", "sparse" or
    "quant" reads, or where a gradient is wanted of the serve-only quant
    mode; returns whether a gradient is wanted (of x or a param). Shared
    by the single linear and an MoE layer's grouped expert stack."""
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *params.values()))
    if exec_mode == "quant":
        if needs_grad:
            raise ValueError(
                "exec_mode='quant' is serve-only: int8 codes are not "
                "trainable — train with dense, fused or sparse")
        if "qv_t" not in consts:
            raise ValueError(
                "exec_mode='quant' needs quantized consts {qv_t, rows_q, "
                "cols_q, qscale} — run repro_torch.quant.calibrate on the "
                "trained checkpoint and serve the exported artifact")
    elif "perm" not in consts:
        init = "'sparse' or 'fused'" if exec_mode == "sparse" else "'fused'"
        raise ValueError(
            f"exec_mode={exec_mode!r} needs tile consts {{rows_t, cols_t, "
            f"perm}} — init the layer with exec_mode={init}")
    return needs_grad


def _decode(x, params, consts, scale: float, exec_mode: str):
    """The factored path of exec_mode "sparse" (trainable) / "quant"
    (forward-only)."""
    from repro_torch.kernels import ops
    needs_grad = check_exec_consts(exec_mode, x, params, consts)
    if exec_mode == "quant":
        return ops.sl_quant_decode(x, params["B"], params["A"],
                                   consts["qv_t"], consts["rows_q"],
                                   consts["cols_q"], consts["qscale"], scale)
    if needs_grad:
        return ops.sl_sparse_linear(x, params["B"], params["A"], params["v"],
                                    consts["rows_t"], consts["cols_t"],
                                    consts["perm"], scale,
                                    rows_tT=consts.get("rows_tT"),
                                    cols_tT=consts.get("cols_tT"))
    return ops.sl_decode(x, params["B"], params["A"],
                         ops._gather_tiles(params["v"], consts["perm"]),
                         consts["rows_t"], consts["cols_t"], scale)
