"""Plain PyTorch versions of the port's kernels.

Each one computes what its CUDA kernel computes, with the same rounding
points, and is what a kernel wrapper runs for a tensor on the CPU. The
CUDA kernels are held against these on the card (chip_smoke.py,
tests/test_torch_kernels.py) and these against the JAX kernels on the CPU.
Signatures and layouts follow ``repro.kernels.ref``, except that
:func:`sl_matmul_ref` and :func:`sddmm_ref` take the tile-CSR inputs
their kernels take and :func:`adam8bit_ref` takes ``n_valid`` as an
integer. :func:`sparse_matmul_ref` and :func:`quant_sparse_matmul_ref`
are the tile-level plain versions of the two sparse-decode kernels (the
reference has none: it holds them through :func:`sl_decode_ref` and
:func:`sl_quant_decode_ref`, which take flat COO inputs as its do).
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30  # the mask fill of the reference attention


def _tile_coords(rows_t, cols_t):
    """Global (row, col) of every tile-CSR slot: tile origin + local."""
    nkt, nnt, _ = rows_t.shape
    kt = torch.arange(nkt, device=rows_t.device).view(nkt, 1, 1) * 128
    nt = torch.arange(nnt, device=rows_t.device).view(1, nnt, 1) * 128
    return rows_t.long() + kt, cols_t.long() + nt


def densify_tiles(B, A, v_t, rows_t, cols_t, scale: float, dtype):
    """W = scale·B·A ⊕ V as one dense f32 product rounded once to
    ``dtype``, with V given in tile-CSR form. Returns the (K/128·128,
    N/128·128) padded W: exactly the tiles the kernel builds on chip."""
    nkt, nnt, _ = rows_t.shape
    k, r = B.shape
    n = A.shape[1]
    Bp = torch.zeros(nkt * 128, r, dtype=torch.float32, device=B.device)
    Bp[:k] = B.float()
    Ap = torch.zeros(r, nnt * 128, dtype=torch.float32, device=A.device)
    Ap[:, :n] = A.float()
    W = (Bp @ Ap) * scale
    # padding slots sit at local (0, 0) with v = 0, so a plain add of
    # every slot is exact; index_put_ with accumulate sums duplicates
    rows, cols = _tile_coords(rows_t, cols_t)
    W.index_put_((rows.reshape(-1), cols.reshape(-1)),
                 v_t.float().reshape(-1), accumulate=True)
    return W.to(dtype)


def sl_matmul_ref(x, B, A, v_t, rows_t, cols_t, scale: float):
    """y = x @ (scale·B·A ⊕ V) for x (M, K), B (K, r), A (r, N) and V as
    tile-CSR (K/128, N/128, cap) arrays: W is built in f32, rounded to
    x.dtype, then multiplied with f32 accumulation; output in x.dtype."""
    k = x.shape[-1]
    n = A.shape[1]
    W = densify_tiles(B, A, v_t, rows_t, cols_t, scale, x.dtype)
    return (x.float() @ W[:k, :n].float()).to(x.dtype)


def sddmm_ref(x, dy, rows_t, cols_t):
    """dv_t (K/128, N/128, cap) f32 for x (M, K), dy (M, N): G = xᵀ·dy in
    f32 (products of the inputs exact in f32, sums in f32) gathered at
    every slot's tile origin + local (row, col). Padding slots sit at
    local (0, 0) and get G there, as the kernel's do."""
    G = x.float().T @ dy.float()
    rows, cols = _tile_coords(rows_t, cols_t)
    return G[rows, cols]


def _tile_dense(vals_t, rows_t, cols_t):
    """The f32 (K/128·128, N/128·128) matrix of a tile-CSR array: every
    slot's value added at its tile origin + local (row, col). Padding
    slots sit at local (0, 0) with value 0, so they add exactly 0."""
    nkt, nnt, _ = rows_t.shape
    S = torch.zeros(nkt * 128, nnt * 128, dtype=torch.float32,
                    device=vals_t.device)
    rows, cols = _tile_coords(rows_t, cols_t)
    S.index_put_((rows.reshape(-1), cols.reshape(-1)),
                 vals_t.float().reshape(-1), accumulate=True)
    return S


def sparse_matmul_ref(x, v_t, rows_t, cols_t, n: int):
    """y = x @ S for x (M, K) and S (K, n) as f32 tile-CSR (K/128, n/128,
    cap) arrays: f32 products and sums, one rounding to x.dtype."""
    k = x.shape[-1]
    S = _tile_dense(v_t, rows_t, cols_t)
    return (x.float() @ S[:k, :n]).to(x.dtype)


def quant_sparse_matmul_ref(x, qv_t, rows_q, cols_q, qscale, n: int):
    """y = x @ dequant(S) for the int8 tile-CSR layout: the tile of codes,
    its columns times the per-output-channel scales ``qscale`` (n/128,
    128), then f32 products and sums, one rounding to x.dtype."""
    k = x.shape[-1]
    S = _tile_dense(qv_t, rows_q, cols_q) * qscale.reshape(1, -1)
    return (x.float() @ S[:k, :n]).to(x.dtype)


def _densify_coo(B, A, rows, cols, v, scale: float):
    W = (B.float() @ A.float()) * scale
    return W.index_put_((rows.long(), cols.long()), v.float(),
                        accumulate=True)


def sl_decode_ref(x, B, A, rows, cols, v, scale: float):
    """The factored decode path's oracle: W = scale·B·A ⊕ V densified in
    f32 from flat COO (rows, cols, v), then x @ W in f32, rounded to
    x.dtype."""
    W = _densify_coo(B, A, rows, cols, v, scale)
    return (x.float() @ W).to(x.dtype)


def sl_quant_decode_ref(x, B, A, rows, cols, qv, ch_scales, scale: float):
    """The quantized decode path's oracle: dequantize the flat COO int8
    codes ``qv`` against the (d_out,) per-output-channel scales, densify in
    f32 and multiply in f32, rounded to x.dtype."""
    v = qv.float() * ch_scales.float()[cols.long()]
    W = _densify_coo(B, A, rows, cols, v, scale)
    return (x.float() @ W).to(x.dtype)


# the f32 reciprocals of the 8-bit codec's scales (optim/quant.py)
INV_127 = float(np.float32(1.0 / 127.0))
INV_255 = float(np.float32(1.0 / 255.0))


def adam8bit_ref(p, g, m_codes, m_scales, v_codes, v_scales, scalars,
                 n_valid=None):
    """One blockwise 8-bit Adam step on (n_q, Q) blocks, as the
    ``adam8bit`` kernel computes it: p (f32 or bf16), g f32, codes int8,
    scales f32 (n_q,), ``scalars`` f32 (10,) = [lr, b1, b2, 1-b1, 1-b2,
    bc1, bc2, eps, wd, 0] and ``n_valid`` the count of real elements (None
    = all). Lanes at flat index ≥ n_valid get g = m = v = 0 exactly.
    Every operation is one IEEE f32 operation in the order the reference
    writes it (``repro/kernels/ref.py:21``), no fused multiply-add, and the
    scales multiply by the f32 reciprocal of 127 and 255 as the compiled
    reference does. The scalars stay tensors, so on the card every
    division is a true division (a CPU scalar would turn it into a
    multiplication by the reciprocal). Returns (new_p, m_codes, m_scales,
    v_codes, v_scales)."""
    lr, b1, b2, omb1, omb2, bc1, bc2, eps, wd = [scalars[i]
                                                 for i in range(9)]
    g = g.float()
    pf = p.float()
    m = m_codes.float() * m_scales[:, None]
    v = torch.clamp(v_codes.float() + 128.0, min=0.5) * v_scales[:, None]
    if n_valid is not None:
        idx = torch.arange(p.numel(), device=p.device).reshape(p.shape)
        valid = idx < n_valid
        zero = torch.zeros((), device=p.device)
        g = torch.where(valid, g, zero)
        m = torch.where(valid, m, zero)
        v = torch.where(valid, v, zero)
    m = b1 * m + omb1 * g
    v = b2 * v + omb2 * g * g
    u = (m / bc1) / (torch.sqrt(v / bc2) + eps) + wd * pf
    new_p = (pf - lr * u).to(p.dtype)
    ms = torch.amax(torch.abs(m), dim=1) * INV_127
    mc = torch.round(m / torch.clamp(ms, min=1e-12)[:, None])
    vs = torch.amax(v, dim=1) * INV_255
    vc = torch.round(v / torch.clamp(vs, min=1e-12)[:, None]) - 128.0
    return new_p, mc.to(torch.int8), ms, vc.to(torch.int8), vs


def adam8bit_segment_ref(p, g, m_codes, m_scales, v_codes, v_scales,
                         scalars, clip=None, *, decay: bool = True):
    """One segment of the grouped ``adam8bit`` launch: p (n elements, any
    shape, f32 or bf16) and g (n elements, f32 or bf16), padded with zeros
    to (n_q, Q) blocks; g is multiplied by ``clip`` in f32 first (the
    optimizer's ``g.float() * scale``), and weight decay ``scalars[8]``
    applies only with ``decay``. Returns (new_p in p's shape, then the
    codes and scales in their given shapes)."""
    n = p.numel()
    q = m_codes.numel() // m_scales.numel()
    pad = (-n) % q

    def blocks(a, dtype):
        return torch.nn.functional.pad(a.reshape(-1).to(dtype),
                                       (0, pad)).reshape(-1, q)

    gf = g.float()
    if clip is not None:
        gf = gf * clip
    if not decay:
        scalars = scalars.clone()
        scalars[8] = 0.0
    new_p, mc, ms, vc, vs = adam8bit_ref(
        blocks(p, p.dtype), blocks(gf, torch.float32),
        m_codes.reshape(-1, q), m_scales.reshape(-1),
        v_codes.reshape(-1, q), v_scales.reshape(-1), scalars, n)
    return (new_p.reshape(-1)[:n].reshape(p.shape),
            mc.reshape(m_codes.shape), ms.reshape(m_scales.shape),
            vc.reshape(v_codes.shape), vs.reshape(v_scales.shape))


def paged_attention_ref(q, k_pool, v_pool, block_table, positions, *,
                        scale: float, softcap: float = 0.0, window: int = 0):
    """Decode attention over the paged pools, dense and in f32.

    q: (n_slots, Hkv, group, hd); pools (n_blocks, block_len, Hkv, hd);
    block_table (n_slots, blocks_per_slot) int32; positions (n_slots,).
    Null blocks (table entry 0) and keys past the slot's position are
    masked, masked probabilities are exactly 0, masked v rows are zeroed
    (0 · NaN is NaN), and a slot with nothing valid outputs 0."""
    n_slots, n_kv, group, hd = q.shape
    block_len = k_pool.shape[1]
    table = block_table.long()
    k = k_pool[table].reshape(n_slots, -1, n_kv, hd).float()
    v = v_pool[table].reshape(n_slots, -1, n_kv, hd).float()
    view_len = k.shape[1]
    kpos = torch.arange(view_len, device=q.device)
    pos = positions.long()
    valid = (kpos[None, :] <= pos[:, None]) & \
        torch.repeat_interleave(block_table != 0, block_len, dim=1)
    if window > 0:
        valid &= (pos[:, None] - kpos[None, :]) < window
    s = torch.einsum("shgd,slhd->shgl", q.float() * scale, k)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    vm = valid[:, None, None, :]
    s = torch.where(vm, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vm, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    v = torch.where(valid[:, :, None, None], v, torch.zeros_like(v))
    o = torch.einsum("shgl,slhd->shgd", p, v)
    o = o / torch.where(l > 0, l, torch.ones_like(l))
    return torch.where(l > 0, o, torch.zeros_like(o)).to(q.dtype)


def paged_prefill_ref(q, k_pool, v_pool, block_table, offsets, *,
                      scale: float, softcap: float = 0.0, window: int = 0):
    """Chunked suffix prefill over the paged pools, dense and in f32.

    q: (n_slots, sq, Hkv, group, hd), query i of slot s at absolute
    position offsets[s] + i, attending key positions ≤ its own (prior
    pages and the chunk, already scattered into the pools). Null blocks
    are masked; v columns no query of the slot attends are zeroed; rows
    with nothing valid output exact zeros."""
    n_slots, sq, n_kv, group, hd = q.shape
    block_len = k_pool.shape[1]
    table = block_table.long()
    k = k_pool[table].reshape(n_slots, -1, n_kv, hd).float()
    v = v_pool[table].reshape(n_slots, -1, n_kv, hd).float()
    view_len = k.shape[1]
    kpos = torch.arange(view_len, device=q.device)
    qpos = offsets.long()[:, None] + torch.arange(sq, device=q.device)[None]
    valid = (kpos[None, None, :] <= qpos[:, :, None]) & \
        torch.repeat_interleave(block_table != 0, block_len, dim=1)[:, None]
    if window > 0:
        valid &= (qpos[:, :, None] - kpos[None, None, :]) < window
    s = torch.einsum("sqhgd,slhd->sqhgl", q.float() * scale, k)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    mask = valid[:, :, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    vmask = valid.any(dim=1)                                  # (S, l)
    v = torch.where(vmask[:, :, None, None], v, torch.zeros_like(v))
    o = torch.einsum("sqhgl,slhd->sqhgd", p, v)
    o = o / torch.where(l > 0, l, torch.ones_like(l))
    return torch.where(l > 0, o, torch.zeros_like(o)).to(q.dtype)
