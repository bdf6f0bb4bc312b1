"""The port's kernels (src/repro_torch/kernels) and the fused linear's
autograd Function against the reference's Pallas kernels and custom VJP.

On the CPU each kernel wrapper runs its plain PyTorch version; those are
held here against the JAX kernels run through ``repro.kernels.ops`` in
interpret mode, on the same numpy-seeded inputs: non-128 dims, f32 and
bf16, GQA, softcap, sliding windows, a NaN-poisoned null block and idle
slots. The CUDA kernels themselves are held against the plain versions
on the card by tests/test_torch_gpu.py and chip_smoke.py.

Tolerances (atol = rtol): f32 1e-4 (the same math, sums in another
order); bf16 2e-2 (bf16 rounding of W tiles and outputs can tip one ulp
where the sums' order differs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import support as jsupport
from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa_kernel
from repro_torch.kernels import sddmm as sddmm_kernel
from repro_torch.kernels import sl_matmul as sl_kernel

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

TOL = {"float32": 1e-4, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])


def _j(a, dtype):
    return jnp.asarray(a, jnp.float32).astype(JDT[dtype])


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])


def _f32(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# sl_matmul
# ---------------------------------------------------------------------------

SL_CASES = [
    # (M, K, N, r, delta) — ragged K and N, one and several row blocks
    (5, 200, 300, 16, 0.05),
    (130, 256, 136, 8, 0.05),
    (1, 136, 520, 32, 0.03),
]


def _sl_inputs(m, k, n, r, delta, seed):
    rng = np.random.default_rng(seed)
    rows, cols = jsupport.sample_support(seed, k, n, delta)
    x = rng.standard_normal((m, k)).astype(np.float32)
    B = rng.uniform(-1, 1, (k, r)).astype(np.float32)
    A = rng.uniform(-1, 1, (r, n)).astype(np.float32) * np.sqrt(6.0 / k)
    v = rng.uniform(-1, 1, rows.shape[0]).astype(np.float32) / np.sqrt(k)
    return rows, cols, x, B, A, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SL_CASES)
def test_sl_matmul_plain_matches_reference_kernel(case, dtype):
    m, k, n, r, delta = case
    rows, cols, x, B, A, v = _sl_inputs(m, k, n, r, delta, seed=k + n)
    scale = 32.0 / r
    jv_t, jrt, jct, jperm = jops.prepare_tiles(rows, cols, v, k, n)
    want = jops.sl_matmul(_j(x, dtype), _j(B, dtype), _j(A, dtype), jv_t,
                          jrt, jct, scale, interpret=True)
    tiles = ops.prepare_tile_consts(rows, cols, k, n, pad=jrt.shape[-1])
    np.testing.assert_array_equal(tiles["rows_t"].numpy(), np.asarray(jrt))
    np.testing.assert_array_equal(tiles["cols_t"].numpy(), np.asarray(jct))
    v_t = ops._gather_tiles(torch.from_numpy(v), tiles["perm"])
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(jv_t))
    before = sl_kernel.sl_matmul.launches
    got = ops.sl_matmul(_t(x, dtype), _t(B, dtype), _t(A, dtype), v_t,
                        tiles["rows_t"], tiles["cols_t"], scale)
    assert got.dtype == TDT[dtype] and got.shape == (m, n)
    assert sl_kernel.sl_matmul.launches == before   # CPU: plain version
    _close(_f32(got), want, dtype)


PLAN_CASES = [
    # (M, K, N, r, dtype, variant, partial, w_t, x_pad, b_pad, a_pad):
    # llama_1b training (M = 2048) forward and dx in bf16 allocate no f32
    # (nkt, M, N) partial, only the bf16 Wᵀ (nnt·128, nkt·128) and the
    # padded copies of d_ff = 5461-wide operands
    (2048, 2048, 5461, 512, torch.bfloat16, "two_stage", None,
     (43 * 128, 16 * 128), None, None, (512, 5464)),
    (2048, 5461, 2048, 512, torch.bfloat16, "two_stage", None,
     (16 * 128, 43 * 128), (2048, 5464), None, None),
    (2048, 2048, 2048, 512, torch.bfloat16, "two_stage", None,
     (16 * 128, 16 * 128), None, None, None),
    # a decode batch and the prefill buckets, up to the crossover: one
    # pass with the small f32 partials; one row past it: two stages
    (4, 2048, 5461, 512, torch.bfloat16, "single_pass", (16, 4, 5461),
     None, None, None, (512, 5464)),
    (sl_kernel.SMALL_M_MAX, 5461, 2048, 512, torch.bfloat16, "single_pass",
     (43, sl_kernel.SMALL_M_MAX, 2048), None,
     (sl_kernel.SMALL_M_MAX, 5464), None, None),
    (sl_kernel.SMALL_M_MAX + 1, 200, 300, 12, torch.bfloat16, "two_stage",
     None, (384, 256), None, (200, 16), (12, 304)),
    # f32 keeps the CUDA-core kernels with their f32 partials, unpadded
    (4, 2048, 5461, 512, torch.float32, "f32", (16, 4, 5461), None, None,
     None, None),
    (2048, 5461, 2048, 512, torch.float32, "f32", (43, 2048, 2048), None,
     None, None, None),
]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_sl_matmul_plan(case):
    m, k, n, r, dtype, *want = case
    assert tuple(sl_kernel.plan(m, k, n, r, dtype)) == tuple(want)


def test_sl_matmul_plan_two_stage_scratch_is_small():
    """At llama_1b's training shape the bf16 scratch is the 22.5 MB W,
    against 716 MB of f32 partials; moving the crossover to 0 sends even
    a decode batch through the two stages."""
    two = sl_kernel.plan(2048, 2048, 5461, 512, torch.bfloat16)
    f32 = sl_kernel.plan(2048, 2048, 5461, 512, torch.float32)
    assert np.prod(two.w_t) * 2 == 22_544_384
    assert np.prod(f32.partial) * 4 == 715_784_192
    assert sl_kernel.plan(4, 2048, 5461, 512, torch.bfloat16,
                          small_m_max=0).variant == "two_stage"


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_sl_matmul_launch_refuses_non_cuda_tensors(device):
    """The entry points that take a plan launch the kernel or raise: they
    never run the plain version, and never hand host memory to the
    kernel."""
    p = sl_kernel.plan(4, 200, 300, 12, torch.bfloat16)
    x, B, A = (torch.zeros(s, dtype=torch.bfloat16, device=device)
               for s in ((4, 200), (200, 12), (12, 300)))
    consts = [torch.zeros((2, 3, 4), dtype=dt, device=device)
              for dt in (torch.float32, torch.int32, torch.int32)]
    with pytest.raises(ValueError, match="unsupported device"):
        sl_kernel.launch(p, x, B, A, *consts, 1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        sl_kernel.pad_operands(p, x, B, A)


def test_sl_linear_gathers_flat_v_like_reference():
    m, k, n, r, delta = 4, 200, 300, 16, 0.05
    rows, cols, x, B, A, v = _sl_inputs(m, k, n, r, delta, seed=7)
    cap = jsupport.tile_cap(k, n, delta)
    jt = jops.prepare_tile_consts(rows, cols, k, n, pad=cap)
    vv = v.reshape(k, -1)                       # row-balanced (d_in, k)
    want = jops.sl_linear(jnp.asarray(x), jnp.asarray(B), jnp.asarray(A),
                          jnp.asarray(vv), jt["rows_t"], jt["cols_t"],
                          jt["perm"], 2.0)
    tt = ops.prepare_tile_consts(rows, cols, k, n, pad=cap)
    got = ops.sl_linear(torch.from_numpy(x), torch.from_numpy(B),
                        torch.from_numpy(A), torch.from_numpy(vv),
                        tt["rows_t"], tt["cols_t"], tt["perm"], 2.0)
    _close(got.numpy(), want, "float32")


def test_sl_matmul_sums_colliding_padding_slots():
    """Padding slots and a real entry share local (0, 0): the plain
    version must add every slot (padding carries 0)."""
    k, n, r = 128, 128, 4
    rows = np.array([0, 0, 5], np.int32)
    cols = np.array([0, 7, 3], np.int32)
    v = np.array([2.0, -1.0, 0.5], np.float32)
    tiles = ops.prepare_tile_consts(rows, cols, k, n, pad=8)
    v_t = ops._gather_tiles(torch.from_numpy(v), tiles["perm"])
    W = ref.densify_tiles(torch.zeros(k, r), torch.zeros(r, n), v_t,
                          tiles["rows_t"], tiles["cols_t"], 1.0,
                          torch.float32)
    want = np.zeros((k, n), np.float32)
    want[rows, cols] = v
    np.testing.assert_array_equal(W.numpy(), want)


# ---------------------------------------------------------------------------
# sddmm and the fused linear's backward
# ---------------------------------------------------------------------------

SDDMM_CASES = [
    # (M, K, N, delta) — ragged K/N, one token block and several; M no
    # multiple of the bf16 kernel's 64-token chunk with K and N no
    # multiple of 8 (both operands padded on the card) or of 128
    (7, 200, 300, 0.05),
    (300, 136, 520, 0.03),
    (130, 256, 136, 0.05),
    (97, 333, 261, 0.05),
    (65, 1000, 136, 0.05),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SDDMM_CASES)
def test_sddmm_plain_matches_reference_kernel(case, dtype):
    """Every slot, padding slots (G at the tile's local (0, 0)) included."""
    m, k, n, delta = case
    rng = np.random.default_rng(m + k)
    rows, cols = jsupport.sample_support(k * 3 + n, k, n, delta)
    cap = jsupport.tile_cap(k, n, delta)
    jt = jops.prepare_tile_consts(rows, cols, k, n, pad=cap)
    x = rng.standard_normal((m, k)).astype(np.float32)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    want = jops.sddmm(_j(x, dtype), jnp.asarray(dy), jt["rows_t"],
                      jt["cols_t"], interpret=True)
    tt = ops.prepare_tile_consts(rows, cols, k, n, pad=cap)
    before = sddmm_kernel.sddmm.launches
    got = ops.sddmm(_t(x, dtype), torch.from_numpy(dy), tt["rows_t"],
                    tt["cols_t"])
    assert sddmm_kernel.sddmm.launches == before        # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
    # sums over tokens in f32 in another order; bf16 inputs are rounded
    # identically on both sides (dy cast to x's dtype first)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["row_balanced", "iid"])
def test_sl_linear_vjp_matches_reference(kind, dtype):
    """y, dx, dB, dA and dv of the autograd Function against ``jax.vjp``
    of the reference's custom-VJP ``sl_linear`` (Pallas in interpret
    mode)."""
    m, k, n, r, delta = 6, 200, 150, 8, 0.05
    rows, cols, x, B, A, v = _sl_inputs(m, k, n, r, delta, seed=5)
    if kind == "iid":
        rows, cols = jsupport.sample_support(9, k, n, delta, "iid")
        v = np.random.default_rng(9).uniform(-1, 1, rows.shape[0]).astype(
            np.float32) / np.sqrt(k)
    else:
        v = v.reshape(k, -1)
    cap = jsupport.tile_cap(k, n, delta, kind)
    jt = jops.prepare_tile_consts(rows, cols, k, n, pad=cap)
    dy = np.random.default_rng(6).standard_normal((m, n)).astype(np.float32)
    y, vjp = jax.vjp(
        lambda x_, B_, A_, v_: jops.sl_linear(
            x_, B_, A_, v_, jt["rows_t"], jt["cols_t"], jt["perm"], 2.0),
        _j(x, dtype), _j(B, dtype), _j(A, dtype), _j(v, dtype))
    want = (y,) + vjp(_j(dy, dtype))
    tt = ops.add_transposed_tiles(ops.prepare_tile_consts(rows, cols, k, n,
                                                          pad=cap))
    leaves = [_t(a, dtype).requires_grad_(True) for a in (x, B, A, v)]
    ty = ops.sl_linear(*leaves, tt["rows_t"], tt["cols_t"], tt["perm"], 2.0,
                       rows_tT=tt["rows_tT"], cols_tT=tt["cols_tT"])
    got = (ty,) + torch.autograd.grad(ty, leaves, _t(dy, dtype))
    for name, g, w in zip(("y", "dx", "dB", "dA", "dv"), got, want):
        assert g.dtype == TDT[dtype] and g.shape == w.shape, name
        w = np.asarray(w.astype(jnp.float32))
        tol = TOL[dtype] * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(_f32(g.detach()), w, atol=tol,
                                   rtol=TOL[dtype], err_msg=name)


def test_transposed_tiles_address_w_transpose():
    """Wᵀ's tile consts densify to exactly the transpose of W."""
    k, n, r = 200, 300, 4
    rows, cols, _, B, A, v = _sl_inputs(3, k, n, r, 0.05, seed=4)
    tt = ops.add_transposed_tiles(ops.prepare_tile_consts(
        rows, cols, k, n, pad=jsupport.tile_cap(k, n, 0.05)))
    v_t = ops._gather_tiles(torch.from_numpy(v), tt["perm"])
    B_, A_ = torch.from_numpy(B), torch.from_numpy(A)
    W = ref.densify_tiles(B_, A_, v_t, tt["rows_t"], tt["cols_t"], 1.5,
                          torch.float32)[:k, :n]
    WT = ref.densify_tiles(A_.T, B_.T, ops.transpose_tiles(v_t),
                           tt["rows_tT"], tt["cols_tT"], 1.5,
                           torch.float32)[:n, :k]
    assert torch.equal(WT, W.T)


def test_sl_linear_backward_needs_transposed_tiles():
    """The backward never rebuilds Wᵀ's tile consts per step: without the
    ones built at init it raises; forward-only callers need none."""
    k, n, r = 200, 300, 4
    rows, cols, x, B, A, v = _sl_inputs(3, k, n, r, 0.05, seed=4)
    tt = ops.prepare_tile_consts(rows, cols, k, n,
                                 pad=jsupport.tile_cap(k, n, 0.05))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, B, A, v)]
    y = ops.sl_linear(*leaves, tt["rows_t"], tt["cols_t"], tt["perm"], 1.5)
    assert y.shape == (3, n)
    with pytest.raises(ValueError, match="add_transposed_tiles"):
        y.sum().backward()


def test_scatter_tiles_writes_each_support_entry_once():
    k, n = 200, 300
    rows, cols, *_ = _sl_inputs(1, k, n, 4, 0.05, seed=8)
    tt = ops.prepare_tile_consts(rows, cols, k, n,
                                 pad=jsupport.tile_cap(k, n, 0.05))
    dv_t = torch.randn(tt["perm"].shape)
    flat = ops._scatter_tiles(dv_t, tt["perm"], rows.shape[0])
    assert torch.equal(ops._gather_tiles(flat, tt["perm"]),
                       torch.where(tt["perm"] >= 0, dv_t, 0.0))


# ---------------------------------------------------------------------------
# paged attention: decode and chunked prefill
# ---------------------------------------------------------------------------

def _pools(rng, n_slots, bps, block_len, n_kv, hd, last_pos):
    """Random pools, a block table covering each slot's last position
    (< 0: idle slot, all-null row) and a NaN-poisoned null block."""
    n_blocks = 1 + n_slots * bps
    kp = rng.standard_normal((n_blocks, block_len, n_kv, hd)).astype(
        np.float32)
    vp = rng.standard_normal((n_blocks, block_len, n_kv, hd)).astype(
        np.float32)
    kp[0] = np.nan
    vp[0] = np.nan
    table = np.zeros((n_slots, bps), np.int32)
    nid = 1
    for s, p in enumerate(last_pos):
        if p < 0:
            continue
        for j in range(p // block_len + 1):
            table[s, j] = nid
            nid += 1
    return kp, vp, table


ATTN_CASES = [
    # (block_len, n_kv, n_heads, hd, positions, softcap, window)
    (8, 2, 4, 16, [19, 7, 5, -1], 0.0, 0),       # GQA group 2, idle slot
    (8, 4, 4, 8, [0, 8, 23, 15], 0.0, 0),        # MHA, block boundaries
    (16, 1, 4, 32, [40, 3, -1], 30.0, 0),        # group 4, softcap
    (4, 2, 8, 16, [13, 2, 9], 0.0, 6),           # sliding window
    (8, 2, 2, 64, [31, 17, 24, 5], 20.0, 10),    # softcap and window
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_paged_attention_plain_matches_reference_kernel(case, dtype):
    block_len, n_kv, n_heads, hd, positions, cap, win = case
    rng = np.random.default_rng(len(positions) * 31 + hd)
    n_slots = len(positions)
    bps = max(positions) // block_len + 2
    kp, vp, table = _pools(rng, n_slots, bps, block_len, n_kv, hd,
                           positions)
    pos = np.maximum(np.asarray(positions, np.int32), 0)
    q = rng.standard_normal((n_slots, n_heads, hd)).astype(np.float32)
    kw = dict(scale=hd ** -0.5, softcap=cap, window=win)
    want = jops.paged_attention(_j(q, dtype), _j(kp, dtype), _j(vp, dtype),
                                jnp.asarray(table), jnp.asarray(pos),
                                interpret=True, **kw)
    before = pa_kernel.paged_attention.launches
    got = ops.paged_attention(_t(q, dtype), _t(kp, dtype), _t(vp, dtype),
                              torch.from_numpy(table), torch.from_numpy(pos),
                              **kw)
    assert pa_kernel.paged_attention.launches == before
    assert got.dtype == TDT[dtype]
    got = _f32(got)
    assert np.isfinite(got).all()
    for s, p in enumerate(positions):
        if p < 0:
            assert (got[s] == 0).all()                  # idle: exact zeros
    _close(got, want, dtype)


PREFILL_CASES = [
    # (block_len, n_kv, n_heads, hd, sq, offsets, lengths, softcap, window)
    (8, 2, 4, 16, 8, [0, 8, 16, 0], [8, 5, 3, 0], 0.0, 0),
    (4, 1, 4, 32, 6, [4, 0, 12], [6, 6, 2], 25.0, 0),
    (8, 4, 4, 8, 8, [16, 8], [8, 4], 0.0, 5),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PREFILL_CASES)
def test_paged_prefill_plain_matches_reference_kernel(case, dtype):
    block_len, n_kv, n_heads, hd, sq, offsets, lengths, cap, win = case
    rng = np.random.default_rng(sq * 13 + hd)
    n_slots = len(offsets)
    last = [o + l - 1 if l > 0 else -1 for o, l in zip(offsets, lengths)]
    bps = (max(offsets) + sq) // block_len + 1
    kp, vp, table = _pools(rng, n_slots, bps, block_len, n_kv, hd, last)
    offs = np.asarray(offsets, np.int32)
    q = rng.standard_normal((n_slots, sq, n_heads, hd)).astype(np.float32)
    kw = dict(scale=hd ** -0.5, softcap=cap, window=win)
    want = jops.paged_prefill_attention(
        _j(q, dtype), _j(kp, dtype), _j(vp, dtype), jnp.asarray(table),
        jnp.asarray(offs), interpret=True, **kw)
    before = pa_kernel.paged_prefill.launches
    got = ops.paged_prefill_attention(
        _t(q, dtype), _t(kp, dtype), _t(vp, dtype), torch.from_numpy(table),
        torch.from_numpy(offs), **kw)
    assert pa_kernel.paged_prefill.launches == before
    got = _f32(got)
    assert np.isfinite(got).all()
    for s, l in enumerate(lengths):
        if l == 0:
            assert (got[s] == 0).all()                  # idle: exact zeros
    _close(got, want, dtype)


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card never falls back
    to the plain version."""
    meta = torch.empty((2, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sl_kernel.sl_matmul(meta, meta, meta, meta, meta, meta, 1.0)
    q = torch.empty((1, 1, 1, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        pa_kernel.paged_attention(q, q, q, q, q, scale=1.0)
    with pytest.raises(ValueError, match="unsupported device"):
        pa_kernel.paged_prefill(q[None], q, q, q, q, scale=1.0)


@pytest.mark.parametrize("sq, group, hd, want", [
    # llama_1b's suffix buckets: one warp per 16 rows; at sq 8 the m16
    # tile's second half is masked
    (8, 1, 64, (1, 1, 8)), (16, 1, 64, (1, 1, 0)), (32, 1, 64, (2, 1, 0)),
    # a GQA group shares its K/V stages: all 128 rows in one block
    (32, 4, 64, (8, 1, 0)), (6, 4, 32, (2, 1, 8)), (1, 1, 16, (1, 1, 15)),
    # more rows than 8 warps hold take more blocks
    (64, 4, 128, (8, 2, 0)), (33, 4, 64, (8, 2, 124))])
def test_paged_prefill_plan(sq, group, hd, want):
    p = pa_kernel.prefill_plan(sq, group, hd)
    assert tuple(p) == want
    rows = sq * group
    assert p.warps * pa_kernel.TC_ROWS_PER_WARP * p.row_blocks == \
        rows + p.masked_rows
    assert p.masked_rows < pa_kernel.TC_ROWS_PER_WARP * p.warps


@pytest.mark.parametrize("sq, group, hd, want", [
    # above head_dim 128 a pair of warps shares each 16 rows: gemma2's
    # prefill (group 2) at each suffix bucket, paligemma's MQA (group 8:
    # 256 rows, 4 blocks of 64), and a head_dim of 9 chunks
    (8, 2, 256, (2, 1, 0)), (32, 2, 256, (8, 1, 0)),
    (32, 8, 256, (8, 4, 0)), (16, 2, 144, (4, 1, 0)), (5, 1, 160, (2, 1, 11)),
    (40, 2, 256, (8, 2, 48))])
def test_paged_prefill_plan_pairs_warps_above_head_dim_128(sq, group, hd,
                                                           want):
    p = pa_kernel.prefill_plan(sq, group, hd)
    assert tuple(p) == want
    assert pa_kernel.prefill_warps_per_tile(hd) == 2
    tiles = p.warps // 2
    assert tiles * pa_kernel.TC_ROWS_PER_WARP * p.row_blocks == \
        sq * group + p.masked_rows
    assert p.masked_rows < pa_kernel.TC_ROWS_PER_WARP * tiles


@pytest.mark.parametrize("hd", [8, 24, 100, 136, 264, 272, 512])
def test_paged_prefill_plan_refuses_head_dims_off_the_mma_path(hd):
    """bf16 prefill has only the tensor-core kernels: a head_dim that is
    not a multiple of 16 up to 256 raises instead of falling back."""
    with pytest.raises(ValueError, match="head_dim"):
        pa_kernel.prefill_plan(8, 1, hd)


@pytest.mark.parametrize("m, k, n, dtype, want", [
    # f32 samples on the CUDA cores and reads both operands as they are
    (2048, 2048, 5461, torch.float32, ("f32", None, None)),
    # bf16: an operand whose rows are no multiple of 8 elements is padded
    # (llama_1b's d_ff = 5461: dy of gate/up, x of down)
    (2048, 2048, 5461, torch.bfloat16, ("tensor_core", None, (2048, 5464))),
    (2048, 5461, 2048, torch.bfloat16, ("tensor_core", (2048, 5464), None)),
    (2048, 2048, 2048, torch.bfloat16, ("tensor_core", None, None)),
    (97, 333, 261, torch.bfloat16, ("tensor_core", (97, 336), (97, 264))),
    (65, 1000, 136, torch.bfloat16, ("tensor_core", None, None))])
def test_sddmm_plan(m, k, n, dtype, want):
    assert tuple(sddmm_kernel.plan(m, k, n, dtype)) == want


def test_sddmm_wrapper_refuses_other_devices():
    meta = torch.empty((2, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sddmm_kernel.sddmm(meta, meta, meta, meta)


@pytest.mark.parametrize("args, want", [
    # llama_1b's decode: MHA 32 heads and GQA 8 kv heads x group 4, hd 64;
    # the engine's 128-key table, a 59-key and a 1023-key context. Short
    # contexts stay in one split (32 keys a warp); long ones split until
    # about 2 blocks an SM (132 SMs) or one 32-key chunk a warp
    ((4, 32, 1, 64, 128), (4, 1, 1, 1)),
    ((4, 32, 1, 64, 59), (2, 1, 1, 1)),
    ((4, 8, 4, 64, 59), (2, 4, 1, 1)),
    ((4, 32, 1, 64, 1023), (4, 1, 1, 3)),
    ((4, 8, 4, 64, 1023), (4, 4, 1, 8)),
    # a group past 8 rows takes more blocks; hd 256 fits 3 warps' buffers
    ((1, 2, 12, 64, 256), (4, 8, 2, 2)),
    ((2, 1, 8, 256, 384), (3, 8, 1, 4))])
def test_paged_attention_decode_plan(args, want):
    p = pa_kernel.decode_plan(*args)
    assert tuple(p) == want
    n_slots, n_kv, group, hd, keys = args
    assert p.rows * p.row_blocks >= group
    assert pa_kernel.decode_smem_bytes(p.warps, p.rows, hd) <= \
        pa_kernel.DECODE_SMEM_MAX
    most = pa_kernel.decode_most_splits(keys)
    assert p.splits <= most == -(-keys // pa_kernel.DECODE_KEYS_PER_WARP)
    for s in (1, most):
        assert pa_kernel.decode_plan(*args, splits=s) == p._replace(
            splits=s)


@pytest.mark.parametrize("args", [
    dict(hd=12), dict(hd=264), dict(hd=0), dict(keys=0), dict(group=0),
    dict(splits=0), dict(keys=1023, splits=33), dict(keys=59, splits=3)])
def test_paged_attention_decode_plan_refusals(args):
    """The bf16 decode has one kernel: a head_dim off its 16-byte rows, an
    empty decode or a forced split count outside 1 .. one per 32 keys
    raises instead of falling back."""
    kw = dict(n_slots=4, n_kv=32, group=1, hd=64, keys=128)
    kw.update(args)
    with pytest.raises(ValueError):
        pa_kernel.decode_plan(**kw)


def test_decode_launch_refuses_cpu_tensors():
    q = torch.zeros((1, 1, 1, 64), dtype=torch.bfloat16)
    pool = torch.zeros((2, 16, 1, 64), dtype=torch.bfloat16)
    tbl = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="unsupported device"):
        pa_kernel.decode_launch(pa_kernel.decode_plan(1, 1, 1, 64, 16), q,
                                pool, pool, tbl, tbl[:, 0], scale=1.0)
