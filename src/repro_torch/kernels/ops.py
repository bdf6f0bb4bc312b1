"""Wrappers around the kernels, as ``repro.kernels.ops`` has them: the
tile-CSR support preparation, the flat-``v`` tile gather, the SLTrain
linear of ``exec_mode="fused"`` (a ``torch.autograd.Function`` whose
forward and dx run ``sl_matmul`` and whose dV runs ``sddmm``), the 8-bit
Adam step on a list of leaves in one launch and on one leaf of any
shape, the paged-attention calls with the
GQA regroup, the factored decode of ``exec_mode="sparse"`` and
``"quant"`` (the low-rank term as f32 matmuls, the sparse term through
the ``sparse_matmul`` or ``quant_sparse_matmul`` kernel), and the
trainable sparse linear (a ``torch.autograd.Function`` whose forward and
dx run ``sparse_matmul`` and whose dV runs ``sddmm``).

Dispatch follows the tensors: on the CPU each kernel wrapper runs its
plain PyTorch version, on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import support as support_lib
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
    vf = v.reshape(-1).float()
    safe = perm.clamp(0, vf.shape[0] - 1).long()
    return torch.where(perm >= 0, vf[safe], torch.zeros((), device=vf.device))


def _scatter_tiles(dv_t, perm, numel: int):
    """f32 tile grads → flat f32 grad of v through ``perm``. Every valid
    perm entry appears exactly once (the tile-layout invariant), so a
    plain indexed assignment is exact and no accumulating scatter is
    needed: the result is the same on every run. Padding slots all write
    one spare element past the end, which is dropped."""
    idx = torch.where(perm >= 0, perm, numel).reshape(-1).long()
    flat = torch.zeros(numel + 1, dtype=torch.float32, device=dv_t.device)
    flat[idx] = dv_t.reshape(-1)
    return flat[:numel]


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
    N). The products take f32 operands and give f32 results, as the
    reference's ``preferred_element_type=f32`` does: a bf16 product
    returning bf16 would round the token contraction through bf16."""
    f32 = torch.float32
    xB = xf.to(f32) @ B.to(f32)                                  # (M, r)
    dA = (scale * (xB.T @ dyf.to(f32))).to(A.dtype)
    dyA = dyf.to(f32) @ A.to(f32).T                              # (M, r)
    dB = (scale * (xf.to(f32).T @ dyA)).to(B.dtype)
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
    them."""
    return _SLLinear.apply(x, B, A, v, rows_t, cols_t, perm, rows_tT,
                           cols_tT, scale)


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
    roundings would drift from the densified path."""
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
    without them."""
    return _SLSparse.apply(x, B, A, v, rows_t, cols_t, perm, rows_tT,
                           cols_tT, scale)
