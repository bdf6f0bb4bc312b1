"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``gpu`` and skips (inside a fixture)
without a CUDA device. The file imports neither jax nor the reference, so
it also runs where only the port's dependencies are installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances (atol = rtol), as in chip_smoke.py: f32 1e-4, bf16 2e-2. The
``adam8bit`` kernel runs the same IEEE operations as its plain version and
is held to it bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import support
from repro_torch.kernels import adam8bit as adam8bit_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa_kernel
from repro_torch.kernels import sddmm as sddmm_kernel
from repro_torch.kernels import sl_matmul as sl_kernel
from repro_torch.kernels import sparse_decode as sd_kernel
from repro_torch.quant import layout

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.testing.assert_close(got.float().cpu(), want.float().cpu(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _rand(rng, shape, dtype, device, lim=None):
    a = rng.uniform(-lim, lim, shape) if lim else rng.standard_normal(shape)
    return torch.from_numpy(a.astype(np.float32)).to(device=device,
                                                      dtype=dtype)


def _sl_args(rng, m, k, n, r, delta, dtype, dev, transposed=False):
    """x, B, A, v_t, rows_t, cols_t, scale for one linear at (m, k, n); with
    ``transposed`` the dx call's operands instead: dy (m, n), Aᵀ, Bᵀ and
    Wᵀ's tile consts (the transposed support is no longer row-balanced)."""
    rows, cols = support.sample_support(k + n, k, n, delta)
    tiles = ops.add_transposed_tiles(ops.prepare_tile_consts(
        rows, cols, k, n, pad=support.tile_cap(k, n, delta)))
    tiles = {name: t.to(dev) for name, t in tiles.items()}
    v = _rand(rng, rows.shape, torch.float32, dev, k ** -0.5)
    v_t = ops._gather_tiles(v, tiles["perm"])
    B = _rand(rng, (k, r), dtype, dev, 1.0)
    A = _rand(rng, (r, n), dtype, dev, (6.0 / k) ** 0.5)
    if transposed:
        return (_rand(rng, (m, n), dtype, dev), A.T.contiguous(),
                B.T.contiguous(), ops.transpose_tiles(v_t), tiles["rows_tT"],
                tiles["cols_tT"], 8.0 / r)
    return (_rand(rng, (m, k), dtype, dev), B, A, v_t, tiles["rows_t"],
            tiles["cols_t"], 8.0 / r)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [
    # (M, K, N, r, delta, transposed): ragged dims, several row blocks,
    # llama_1b decode (M = 4 slots) and prefill (M = 4 slots x bucket 8,
    # 16, 32), which select each row-block variant of the kernel; then
    # llama_1b training (M = 8 x 256 tokens), the forward and the dx call
    # on the transposed factors and support
    (5, 200, 300, 16, 0.05, False), (130, 256, 136, 8, 0.05, False),
    (1, 136, 520, 32, 0.03, False), (4, 2048, 5461, 512, 0.03, False),
    (32, 2048, 5461, 512, 0.03, False), (64, 5461, 2048, 512, 0.03, False),
    (128, 5461, 2048, 512, 0.03, False),
    (2048, 2048, 5461, 512, 0.03, False), (2048, 5461, 2048, 512, 0.03, True),
    (300, 200, 300, 16, 0.05, True), (2048, 2048, 2048, 512, 0.03, True),
    # bf16 two-stage with a rank that is no multiple of 16 (and rows of A
    # no multiple of 8); M on each side of the crossover of the bf16
    # variants; a llama_7b-width linear
    (256, 200, 300, 8, 0.05, False),
    (sl_kernel.SMALL_M_MAX, 2048, 5461, 512, 0.03, False),
    (sl_kernel.SMALL_M_MAX + 1, 2048, 5461, 512, 0.03, False),
    (256, 4096, 11008, 1024, 0.05, False),
    # llama_7b training (M = 8 x 256 tokens, rank 1024, δ 0.05): the MLP's
    # two forward shapes and the dx call of each
    (2048, 4096, 11008, 1024, 0.05, False),
    (2048, 4096, 11008, 1024, 0.05, True),
    (2048, 11008, 4096, 1024, 0.05, False),
    (2048, 11008, 4096, 1024, 0.05, True)])
def test_sl_matmul_kernel_matches_plain(cuda, case, dtype):
    m, k, n, r, delta, transposed = case
    args = _sl_args(np.random.default_rng(k + n), m, k, n, r, delta, dtype,
                    cuda, transposed)
    before = sl_kernel.sl_matmul.launches
    got = sl_kernel.sl_matmul(*args)
    torch.cuda.synchronize()
    assert sl_kernel.sl_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, k if transposed else n)
    _close(got, ref.sl_matmul_ref(*args), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    # (M, K, N, r, delta, transposed): the single pass at decode rows and
    # the two stages at training rows, forward and dx
    (4, 2048, 5461, 512, 0.03, False), (2048, 5461, 2048, 512, 0.03, False),
    (2048, 2048, 5461, 512, 0.03, True)])
def test_sl_matmul_bf16_rerun_gives_same_bits(cuda, case):
    """Two calls on the same bf16 inputs give the same bits: every f32 sum
    runs in a fixed order and no float atomic touches device memory."""
    m, k, n, r, delta, transposed = case
    args = _sl_args(np.random.default_rng(m + k), m, k, n, r, delta,
                    torch.bfloat16, cuda, transposed)
    first = sl_kernel.sl_matmul(*args)
    second = sl_kernel.sl_matmul(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [4, 64, sl_kernel.SMALL_M_MAX])
def test_sl_matmul_bf16_variants_match_plain(cuda, m):
    """Below the crossover the two-stage variant, forced, agrees with the
    plain version as the single pass does."""
    args = _sl_args(np.random.default_rng(m), m, 2048, 5461, 512, 0.03,
                    torch.bfloat16, cuda)
    want = ref.sl_matmul_ref(*args)
    for small_m_max in (sl_kernel.SMALL_M_MAX, 0):
        p = sl_kernel.plan(m, 2048, 5461, 512, torch.bfloat16, small_m_max)
        _close(sl_kernel.launch(p, *args), want, torch.bfloat16)


def _sddmm_args(m, k, n, delta, dtype, dev):
    rng = np.random.default_rng(m + n)
    rows, cols = support.sample_support(k * 3 + n, k, n, delta)
    tiles = ops.prepare_tile_consts(rows, cols, k, n,
                                    pad=support.tile_cap(k, n, delta))
    return (_rand(rng, (m, k), dtype, dev), _rand(rng, (m, n), dtype, dev),
            tiles["rows_t"].to(dev), tiles["cols_t"].to(dev))


# llama_1b's training shapes: M = 8 x 256 tokens, the three projections;
# then llama_7b's (δ 0.05; 11008 = 86 x 128, so no operand is padded)
SDDMM_TRAIN_CASES = [(2048, 2048, 5461, 0.03), (2048, 5461, 2048, 0.03),
                     (2048, 2048, 2048, 0.03), (2048, 4096, 11008, 0.05),
                     (2048, 4096, 4096, 0.05)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [
    # (M, K, N, delta): ragged K/N, M below, at and past a 32-row chunk;
    # M no multiple of the bf16 kernel's 64-token chunk with K and N no
    # multiple of 8 (both operands padded) or of 128; llama_1b training
    # shapes
    (5, 200, 300, 0.05), (33, 136, 520, 0.03), (300, 256, 136, 0.05),
    (97, 333, 261, 0.05), (65, 1000, 136, 0.05)] + SDDMM_TRAIN_CASES)
def test_sddmm_kernel_matches_plain(cuda, case, dtype):
    m, k, n, delta = case
    x, dy, rt, ct = _sddmm_args(m, k, n, delta, dtype, cuda)
    before = sddmm_kernel.sddmm.launches
    got = sddmm_kernel.sddmm(x, dy, rt, ct)
    torch.cuda.synchronize()
    assert sddmm_kernel.sddmm.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == rt.shape
    # f32 sums over up to 2048 tokens in another order: the error grows
    # like sqrt(M) ulp of the partial sums' size
    torch.testing.assert_close(got.cpu(), ref.sddmm_ref(x, dy, rt, ct).cpu(),
                               atol=1e-3, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("case", SDDMM_TRAIN_CASES + [(97, 333, 261, 0.05)])
def test_sddmm_bf16_rerun_gives_same_bits(cuda, case):
    """The tensor-core kernel sums each G tile in one block in a fixed
    order, with no atomics: reruns give the same bits, and the padded
    copies leave the inputs as they were."""
    x, dy, rt, ct = _sddmm_args(*case, torch.bfloat16, cuda)
    x0, dy0 = x.clone(), dy.clone()
    got = sddmm_kernel.sddmm(x, dy, rt, ct)
    for _ in range(2):
        assert torch.equal(got, sddmm_kernel.sddmm(x, dy, rt, ct))
    torch.cuda.synchronize()
    assert torch.equal(x, x0) and torch.equal(dy, dy0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
def test_sl_linear_backward_on_card_matches_cpu(cuda, dtype):
    """The fused linear's forward and backward (sl_matmul, sddmm, sl_matmul
    on the transposed support) on the card against the same call on the
    CPU, where every kernel wrapper runs its plain version."""
    m, k, n, r, delta = 300, 200, 520, 16, 0.05
    rng = np.random.default_rng(1)
    rows, cols = support.sample_support(3, k, n, delta)
    tiles = ops.add_transposed_tiles(ops.prepare_tile_consts(
        rows, cols, k, n, pad=support.tile_cap(k, n, delta)))
    host = [_rand(rng, shape, dtype, "cpu", lim) for shape, lim in (
        ((m, k), None), ((k, r), 1.0), ((r, n), 0.2),
        ((k, rows.shape[0] // k), 0.1))]
    dy = _rand(rng, (m, n), dtype, "cpu")
    out = {}
    for dev in ("cpu", cuda):
        leaves = [t.to(dev).requires_grad_(True) for t in host]
        t = {name: c.to(dev) for name, c in tiles.items()}
        y = ops.sl_linear(*leaves, t["rows_t"], t["cols_t"], t["perm"], 0.5,
                          rows_tT=t["rows_tT"], cols_tT=t["cols_tT"])
        out[str(dev)] = [y] + list(torch.autograd.grad(y, leaves,
                                                       dy.to(dev)))
    for name, g, w in zip(("y", "dx", "dB", "dA", "dv"), out["cuda"],
                          out["cpu"]):
        assert g.dtype == w.dtype, name
        scale = max(1.0, float(w.detach().float().abs().max()))
        torch.testing.assert_close(g.detach().float().cpu(),
                                   w.detach().float(),
                                   atol=TOL[dtype] * scale, rtol=TOL[dtype])


def _pools(rng, n_slots, bps, block_len, n_kv, hd, last_pos, dtype, dev):
    n_blocks = 1 + n_slots * bps
    kp = _rand(rng, (n_blocks, block_len, n_kv, hd), dtype, dev)
    vp = _rand(rng, (n_blocks, block_len, n_kv, hd), dtype, dev)
    kp[0] = float("nan")              # the null block must never leak
    vp[0] = float("nan")
    table = np.zeros((n_slots, bps), np.int32)
    nid = 1
    for s, p in enumerate(last_pos):
        for j in range(p // block_len + 1 if p >= 0 else 0):
            table[s, j] = nid
            nid += 1
    return kp, vp, torch.from_numpy(table).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [
    # (block_len, n_kv, group, hd, positions, softcap, window)
    (8, 2, 2, 16, [19, 7, 5, -1], 0.0, 0),
    (16, 32, 1, 64, [40, 49, 58, -1], 0.0, 0),
    (16, 8, 4, 64, [40, 3, 77], 50.0, 0),
    (4, 2, 4, 16, [13, 2, 9], 0.0, 6),
    (64, 1, 8, 256, [300, 17], 20.0, 100),
    # a 1023-key context (the bf16 decode splits it across blocks)
    (16, 32, 1, 64, [1023, 517, 1000, -1], 0.0, 0),
    # llama_7b's engine (32 heads at head_dim 128) and a 1023-key context
    (16, 32, 1, 128, [40, 49, 58, -1], 0.0, 0),
    (16, 32, 1, 128, [1023, 517, 1000, -1], 0.0, 0)])
def test_paged_attention_kernel_matches_plain(cuda, case, dtype):
    block_len, n_kv, group, hd, positions, cap, win = case
    rng = np.random.default_rng(5)
    n_slots = len(positions)
    bps = max(positions) // block_len + 2
    kp, vp, table = _pools(rng, n_slots, bps, block_len, n_kv, hd,
                           positions, dtype, cuda)
    pos = torch.tensor([max(p, 0) for p in positions], dtype=torch.int32,
                       device=cuda)
    q = _rand(rng, (n_slots, n_kv, group, hd), dtype, cuda)
    kw = dict(scale=hd ** -0.5, softcap=cap, window=win)
    before = pa_kernel.paged_attention.launches
    got = pa_kernel.paged_attention(q, kp, vp, table, pos, **kw)
    torch.cuda.synchronize()
    assert pa_kernel.paged_attention.launches == before + 1
    assert torch.isfinite(got.float()).all()
    for s, p in enumerate(positions):
        if p < 0:
            assert (got[s] == 0).all()
    _close(got, ref.paged_attention_ref(q, kp, vp, table, pos, **kw), dtype)


# the bf16 decode's cases: those above, llama_1b's engine at GQA group 4,
# and 1023-key contexts at 32 heads and at GQA group 4
DECODE_CASES = [
    (8, 2, 2, 16, [19, 7, 5, -1], 0.0, 0),
    (16, 32, 1, 64, [40, 49, 58, -1], 0.0, 0),
    (16, 8, 4, 64, [40, 3, 77], 50.0, 0),
    (4, 2, 4, 16, [13, 2, 9], 0.0, 6),
    (64, 1, 8, 256, [300, 17], 20.0, 100),
    (16, 8, 4, 64, [40, 49, 58, -1], 0.0, 24),
    (16, 32, 1, 64, [1023, 517, 1000, -1], 0.0, 0),
    (16, 8, 4, 64, [1023, 517, 1000, -1], 30.0, 0)]


def _decode_case(case, dev, seed=5):
    block_len, n_kv, group, hd, positions, cap, win = case
    rng = np.random.default_rng(seed)
    n_slots = len(positions)
    bps = max(positions) // block_len + 2
    kp, vp, table = _pools(rng, n_slots, bps, block_len, n_kv, hd,
                           positions, torch.bfloat16, dev)
    pos = torch.tensor([max(p, 0) for p in positions], dtype=torch.int32,
                       device=dev)
    q = _rand(rng, (n_slots, n_kv, group, hd), torch.bfloat16, dev)
    return q, kp, vp, table, pos, dict(scale=hd ** -0.5, softcap=cap,
                                       window=win)


def _decode_plans(q, kp, table):
    """The plan of the shapes, and the same with 1, 2 and the most splits
    (those the keys allow)."""
    n_slots, n_kv, group, hd = q.shape
    keys = table.shape[1] * kp.shape[1]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    plan = pa_kernel.decode_plan(n_slots, n_kv, group, hd, keys, sms)
    most = pa_kernel.decode_most_splits(keys)
    return [plan] + [plan._replace(splits=s) for s in sorted({1, 2, most})
                     if s <= most and s != plan.splits]


@pytest.mark.gpu
@pytest.mark.parametrize("case", DECODE_CASES)
def test_paged_attention_bf16_decode_at_each_split(cuda, case):
    """The bf16 decode at the plan's split count and at 1, 2 and the most
    splits: within the bf16 tolerance of the plain version, idle slots
    exactly zero, and a rerun gives the same bits."""
    q, kp, vp, table, pos, kw = _decode_case(case, cuda)
    want = ref.paged_attention_ref(q, kp, vp, table, pos, **kw)
    for plan in _decode_plans(q, kp, table):
        before = pa_kernel.paged_attention.launches
        got = pa_kernel.decode_launch(plan, q, kp, vp, table, pos, **kw)
        torch.cuda.synchronize()
        assert pa_kernel.paged_attention.launches == before + 1
        assert torch.isfinite(got.float()).all(), plan
        for s, p in enumerate(case[4]):
            if p < 0:
                assert (got[s] == 0).all(), plan
        _close(got, want, torch.bfloat16)
        for _ in range(2):
            assert torch.equal(got, pa_kernel.decode_launch(
                plan, q, kp, vp, table, pos, **kw)), plan


@pytest.mark.gpu
def test_paged_attention_bf16_decode_null_pages_never_leak(cuda):
    """Null entries inside a slot's live range (NaN pages behind them, as
    in the null block), inside and outside a window, at every split
    count: the output stays finite and equal to the plain version's, and
    a slot whose pages are all null is zero."""
    for win in (0, 300):
        case = (16, 8, 4, 64, [1023, 517, 1000, 600], 0.0, win)
        q, kp, vp, table, pos, kw = _decode_case(case, cuda)
        table[0, 3] = 0                 # holes early in the context
        table[0, 40] = 0
        table[1, 32] = 0                # the page of the slot's position
        table[2] = 0                    # nothing at all
        kp[table[3, 20]] = float("nan")     # a stale page, then freed
        vp[table[3, 20]] = float("nan")
        table[3, 20] = 0
        want = ref.paged_attention_ref(q, kp, vp, table, pos, **kw)
        for plan in _decode_plans(q, kp, table):
            got = pa_kernel.decode_launch(plan, q, kp, vp, table, pos, **kw)
            torch.cuda.synchronize()
            assert torch.isfinite(got.float()).all(), plan
            assert (got[2] == 0).all(), plan
            _close(got, want, torch.bfloat16)


def _prefill_case(case, dtype, dev, seed=6):
    """q, pools, table, offsets and the kwargs of one prefill case; slots
    of length 0 get no pages (idle)."""
    block_len, n_kv, group, hd, sq, offsets, lengths, cap, win = case
    rng = np.random.default_rng(seed)
    n_slots = len(offsets)
    last = [o + l - 1 if l > 0 else -1 for o, l in zip(offsets, lengths)]
    bps = (max(offsets) + sq) // block_len + 1
    kp, vp, table = _pools(rng, n_slots, bps, block_len, n_kv, hd, last,
                           dtype, dev)
    offs = torch.tensor(offsets, dtype=torch.int32, device=dev)
    q = _rand(rng, (n_slots, sq, n_kv, group, hd), dtype, dev)
    return q, kp, vp, table, offs, dict(scale=hd ** -0.5, softcap=cap,
                                        window=win)


# (block_len, n_kv, group, hd, sq, offsets, lengths, softcap, window)
PREFILL_CASES = [
    (8, 2, 2, 16, 8, [0, 8, 16, 0], [8, 5, 3, 0], 0.0, 0),
    (16, 32, 1, 64, 8, [0, 16, 0, 16], [8, 5, 3, 0], 0.0, 0),
    (16, 32, 1, 64, 32, [0, 16, 0, 16], [24, 8, 3, 0], 0.0, 0),
    (16, 8, 4, 64, 32, [16, 0], [20, 32], 30.0, 12),
    (4, 1, 4, 32, 6, [4, 0, 12], [6, 6, 2], 25.0, 0),
    # llama_1b's engine: 4 slots (the last idle), 32 heads, hd 64, at each
    # suffix bucket; GQA group 4, softcap, window as chip_smoke.py's cases
    (16, 32, 1, 64, 8, [0, 16, 0, 0], [8, 8, 8, 0], 0.0, 0),
    (16, 32, 1, 64, 16, [0, 16, 0, 0], [16, 16, 16, 0], 0.0, 0),
    (16, 32, 1, 64, 32, [0, 16, 0, 0], [32, 32, 32, 0], 0.0, 0),
    (16, 8, 4, 64, 32, [0, 16, 0, 0], [32, 32, 32, 0], 0.0, 0),
    (16, 32, 1, 64, 16, [0, 16, 0, 0], [16, 16, 16, 0], 50.0, 0),
    (16, 8, 4, 64, 16, [0, 16, 0, 0], [16, 16, 16, 0], 0.0, 24),
    # several 64-key stages, a window that starts mid-page, and more rows
    # than one block holds (64 x 4 = 256: two row blocks)
    (16, 4, 2, 64, 16, [120, 200, 0], [16, 10, 16], 0.0, 0),
    (16, 4, 2, 128, 16, [150, 37], [16, 16], 0.0, 40),
    (16, 2, 4, 64, 64, [70, 0], [64, 50], 0.0, 0),
    # llama_7b's engine: 32 heads at head_dim 128, each suffix bucket
    (16, 32, 1, 128, 8, [0, 16, 0, 0], [8, 8, 8, 0], 0.0, 0),
    (16, 32, 1, 128, 16, [0, 16, 0, 0], [16, 16, 16, 0], 0.0, 0),
    (16, 32, 1, 128, 32, [0, 16, 0, 0], [32, 32, 32, 0], 0.0, 0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", PREFILL_CASES)
def test_paged_prefill_kernel_matches_plain(cuda, case, dtype):
    q, kp, vp, table, offs, kw = _prefill_case(case, dtype, cuda)
    lengths = case[6]
    before = pa_kernel.paged_prefill.launches
    got = pa_kernel.paged_prefill(q, kp, vp, table, offs, **kw)
    torch.cuda.synchronize()
    assert pa_kernel.paged_prefill.launches == before + 1
    assert torch.isfinite(got.float()).all()
    for s, l in enumerate(lengths):
        if l == 0:
            assert (got[s] == 0).all()
    _close(got, ref.paged_prefill_ref(q, kp, vp, table, offs, **kw), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("case", PREFILL_CASES[6:9] + PREFILL_CASES[-6:])
def test_paged_prefill_bf16_rerun_gives_same_bits(cuda, case):
    q, kp, vp, table, offs, kw = _prefill_case(case, torch.bfloat16, cuda)
    got = pa_kernel.paged_prefill(q, kp, vp, table, offs, **kw)
    for _ in range(3):
        assert torch.equal(got, pa_kernel.paged_prefill(q, kp, vp, table,
                                                        offs, **kw))


@pytest.mark.gpu
def test_paged_prefill_bf16_null_pages_never_leak(cuda):
    """Null entries inside a slot's live range (NaN pages behind them, as
    in the null block) are masked: the output stays finite and equal to
    the plain version's, and a slot whose pages are all null is zero."""
    case = (16, 8, 4, 64, 32, [40, 16, 0], [32, 32, 32], 0.0, 0)
    q, kp, vp, table, offs, kw = _prefill_case(case, torch.bfloat16, cuda)
    table[0, 1] = 0                 # a hole before the chunk
    table[1, 2] = 0                 # a hole inside the chunk
    table[2] = 0                    # nothing at all
    got = pa_kernel.paged_prefill(q, kp, vp, table, offs, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert (got[2] == 0).all()
    _close(got, ref.paged_prefill_ref(q, kp, vp, table, offs, **kw),
           torch.bfloat16)


def _adam8bit_state(rng, n, dtype, dev):
    """p (padded to whole 256-blocks), f32 g, and 8-bit moments quantized
    from random values, on ``dev``."""
    from repro_torch.optim import quant
    nq = -(-n // 256)
    p = torch.zeros(nq * 256)
    p[:n] = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    g = torch.zeros(nq * 256)
    g[:n] = torch.from_numpy((rng.standard_normal(n) * 1e-2).astype(
        np.float32))
    m = torch.from_numpy((rng.standard_normal(n) * 1e-3).astype(np.float32))
    v = torch.from_numpy((np.abs(rng.standard_normal(n)) * 1e-5).astype(
        np.float32))
    mc, ms, _ = quant.quantize_blockwise(m, 256, True)
    vc, vs, _ = quant.quantize_blockwise(v, 256, False)
    return [t.to(dev) for t in (p.to(dtype).reshape(nq, 256),
                                g.reshape(nq, 256), mc, ms, vc, vs)]


@pytest.mark.gpu
@pytest.mark.parametrize("inplace", [False, True], ids=["out", "inplace"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [256, 2048, 64 * 256 + 3, 333121])
def test_adam8bit_kernel_matches_plain_bitwise(cuda, n, dtype, inplace):
    """Three steps, each from the previous step's outputs: parameters,
    codes and scales equal the plain version's bit for bit, the padded
    tail included (n = 64·256 + 3; 333,121 is one layer of llama_1b's
    mlp/down/v)."""
    rng = np.random.default_rng(n)
    args = _adam8bit_state(rng, n, dtype, cuda)
    want = [t.clone() for t in args]
    for step in range(1, 4):
        scalars = ops.adam8bit_scalars(
            lr=1e-3, b1=0.9, b2=0.999, bc1=1 - 0.9 ** step,
            bc2=1 - 0.999 ** step, eps=1e-8, wd=0.1 if step % 2 else 0.0,
            device=cuda)
        before = adam8bit_kernel.adam8bit_update.launches
        out = adam8bit_kernel.adam8bit_update(*args, scalars, n,
                                              inplace=inplace)
        assert adam8bit_kernel.adam8bit_update.launches == before + 1
        if inplace:
            assert all(a is b for a, b in zip(out, args[:1] + args[2:]))
        want_out = ref.adam8bit_ref(*want, scalars, n)
        torch.cuda.synchronize()
        for name, a, b in zip(("p", "m_codes", "m_scales", "v_codes",
                               "v_scales"), out, want_out):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.equal(a, b), f"step {step}: {name}"
        tail = out[1].reshape(-1)[n:], out[3].reshape(-1)[n:]
        assert (tail[0] == 0).all() and (tail[1] == -128).all()
        args = [out[0], args[1]] + list(out[1:])
        want = [want_out[0], want[1]] + list(want_out[1:])


@pytest.mark.gpu
def test_adam8bit_leaf_update_on_card_matches_cpu(cuda):
    """The leaf wrapper (padding, layer-slice views, in place) on the card
    against the same call on the CPU: the same IEEE operations, so equal
    bit for bit."""
    rng = np.random.default_rng(0)
    p = torch.from_numpy(rng.standard_normal((3, 5, 61)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((3, 5, 61)).astype(np.float32))
    from repro_torch.optim import quant
    mc, ms, _ = quant.quantize_blockwise(p * 1e-3, 256, True)
    vc, vs, _ = quant.quantize_blockwise(p * p * 1e-5, 256, False)
    kw = dict(lr=1e-3, b1=0.9, b2=0.999, bc1=0.19, bc2=0.002, eps=1e-8,
              wd=0.1)
    res = {}
    for dev in ("cpu", cuda):
        t = [x.to(dev).clone() for x in (p, g, mc, ms, vc, vs)]
        for dtype in DTYPES:
            out = ops.adam8bit_update(t[0].to(dtype), *t[1:], **kw)
            res[(str(dev), dtype)] = [x.cpu() for x in out]
    for dtype in DTYPES:
        for a, b in zip(res[("cuda", dtype)], res[("cpu", dtype)]):
            assert torch.equal(a, b)


def _llama_1b_layer_sizes():
    """{leaf: elements} of one layer's slices of llama_1b (d_model 2048,
    d_ff 5461, rank 512, δ 0.03, row-balanced), as the per-layer step
    groups them; mlp/down/v (333,121 a layer) is no whole number of
    256-blocks, so the step updates its 24 layers as one deferred leaf."""
    d, f, r = 2048, 5461, 512
    sizes = {"ln_attn": d, "ln_mlp": d}
    for name, (a, b) in {"wq": (d, d), "wk": (d, d), "wv": (d, d),
                         "wo": (d, d), "gate": (d, f), "up": (d, f),
                         "down": (f, d)}.items():
        sizes[f"{name}/A"] = r * b
        sizes[f"{name}/B"] = a * r
        sizes[f"{name}/v"] = support.nnz_for(a, b, 0.03)
    sizes["down/v"] *= 24
    return sizes


def _llama_7b_layer_sizes():
    """{leaf: elements} of one layer's slices of llama_7b (d_model 4096,
    d_ff 11008, rank 1024, δ 0.05): all 23 are whole 256-blocks, so the
    per-layer step defers none."""
    d, f, r = 4096, 11008, 1024
    sizes = {"ln_attn": d, "ln_mlp": d}
    for name, (a, b) in {"wq": (d, d), "wk": (d, d), "wv": (d, d),
                         "wo": (d, d), "gate": (d, f), "up": (d, f),
                         "down": (f, d)}.items():
        sizes[f"{name}/A"] = r * b
        sizes[f"{name}/B"] = a * r
        sizes[f"{name}/v"] = support.nnz_for(a, b, 0.05)
    assert all(n % 256 == 0 for n in sizes.values())
    return sizes


LAYER_SIZES = {"llama_1b": _llama_1b_layer_sizes,
               "llama_7b": _llama_7b_layer_sizes}


def _segments(rng, sizes, p_dtype, dev):
    """A segment per size: p in ``p_dtype``, g in p's dtype except the
    deferred leaf's f32 accumulator, moments quantized from random
    values, weight decay on all but the norms."""
    from repro_torch.optim import quant
    segs = []
    for name, n in sizes.items():
        p = _rand(rng, (n,), p_dtype, dev)
        g_dtype = torch.float32 if n % 256 else p_dtype
        g = _rand(rng, (n,), g_dtype, dev, 1e-2)
        mc, ms, _ = quant.quantize_blockwise(
            _rand(rng, (n,), torch.float32, dev, 1e-3), 256, True)
        vc, vs, _ = quant.quantize_blockwise(
            _rand(rng, (n,), torch.float32, dev, 1e-2) ** 2, 256, False)
        segs.append(adam8bit_kernel.Segment(p, g, mc, ms, vc, vs,
                                            not name.startswith("ln")))
    return segs


@pytest.mark.gpu
@pytest.mark.parametrize("arch", sorted(LAYER_SIZES))
@pytest.mark.parametrize("dtype", DTYPES)
def test_adam8bit_group_launch_matches_per_leaf_and_plain(cuda, dtype, arch):
    """One grouped call over a whole layer's segments (llama_1b: 22 slices
    and the ragged deferred leaf; llama_7b: 23 slices; bf16 or f32
    parameters, their gradients in the trainer's dtypes, clip scale 0.37),
    one launch per pair of p and g dtypes, is bit for bit the per-leaf
    kernel on each segment's padded f32 blocks and the plain version,
    segment by segment, over three chained steps."""
    rng = np.random.default_rng(11)
    segs = _segments(rng, LAYER_SIZES[arch](), dtype, cuda)
    leaf = [[t.clone() for t in s[:6]] for s in segs]
    plain = [[t.clone() for t in s[:6]] for s in segs]
    clip = torch.tensor(0.37, device=cuda)
    for step in range(1, 4):
        scalars = ops.adam8bit_scalars(
            lr=1e-3, b1=0.9, b2=0.999, bc1=1 - 0.9 ** step,
            bc2=1 - 0.999 ** step, eps=1e-8, wd=0.1, device=cuda)
        before = adam8bit_kernel.adam8bit_update.launches
        adam8bit_kernel.adam8bit_group(segs, scalars, clip)
        assert adam8bit_kernel.adam8bit_update.launches == before + len(
            {(s.p.dtype, s.g.dtype) for s in segs})
        for s, lf, pl in zip(segs, leaf, plain):
            n = s.p.numel()
            nq = -(-n // 256)
            pb = torch.zeros(nq * 256, dtype=dtype, device=cuda)
            pb[:n] = lf[0]
            gb = torch.zeros(nq * 256, device=cuda)
            gb[:n] = lf[1].float() * clip
            sc = scalars if s.decay else torch.cat(
                [scalars[:8], torch.zeros(2, device=cuda)])
            out = adam8bit_kernel.adam8bit_update(
                pb.reshape(nq, 256), gb.reshape(nq, 256), *lf[2:], sc, n)
            lf[0] = out[0].reshape(-1)[:n]
            lf[2:] = out[1:]
            want = ref.adam8bit_segment_ref(*pl, scalars, clip,
                                            decay=s.decay)
            pl[0] = want[0]
            pl[2:] = list(want[1:])
        torch.cuda.synchronize()
        for i, (s, lf, pl) in enumerate(zip(segs, leaf, plain)):
            for name, a, b, c in zip(("p", "m_codes", "m_scales",
                                      "v_codes", "v_scales"),
                                     [s.p] + list(s[2:6]), [lf[0]] + lf[2:],
                                     [pl[0]] + pl[2:]):
                assert torch.equal(a, b), f"step {step} segment {i} {name}"
                assert torch.equal(a, c), f"step {step} segment {i} {name}"


@pytest.mark.gpu
def test_perlayer_grouped_dispatch_on_card_matches_per_leaf(cuda):
    """Three per-layer 8-bit steps on the card (llama_60m smoke, bf16,
    fused): one ``adam8bit`` launch a group against one a leaf, equal bit
    for bit (losses, params, 8-bit state), with the launch counts of each
    dispatch."""
    import dataclasses
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.pipeline import SyntheticC4
    from repro_torch.models import registry
    from repro_torch.models.common import tree_leaves, tree_map
    from repro_torch.optim import optimizers
    from repro_torch.train import perlayer
    cfg = registry.get_smoke_config("llama_60m")
    cfg = dataclasses.replace(cfg, dtype="bfloat16", param=dataclasses.replace(
        cfg.param, exec_mode="fused"))
    api = registry.get_api(cfg)
    params, consts = api.init(cfg, seed=0, device=cuda)
    consts = ops.add_transposed_tiles(consts)
    opt = optimizers.make(OptimizerConfig(
        name="adam8bit", lr=1e-3, warmup_steps=1, total_steps=3,
        weight_decay=0.1))
    data = SyntheticC4(cfg.vocab_size, 32, 4, seed=0)
    batches = [{"tokens": torch.from_numpy(data.next_batch()["tokens"]).to(
        cuda)} for _ in range(3)]
    runs = []
    for o in (opt, dataclasses.replace(opt, update_group_fused=None)):
        p = tree_map(torch.clone, params)
        st = o.init(p)
        fn = perlayer.make_perlayer_train_step(cfg, api, o)
        before = adam8bit_kernel.adam8bit_update.launches
        losses = []
        for b in batches:
            p, st, m = fn(p, st, consts, b)
            losses.append(float(m["loss"]))
        runs.append((losses, p, st,
                     adam8bit_kernel.adam8bit_update.launches - before))
    (gl, gp, gs, gn), (ll, lp, ls, ln) = runs
    assert gl == ll and all(np.isfinite(gl))
    for (path, a), (_, b) in zip([*tree_leaves(gp), *tree_leaves(gs)],
                                 [*tree_leaves(lp), *tree_leaves(ls)]):
        assert torch.equal(a, b), path
    sliced = [opt.stack_state(opt.leaf_state(gs, ("layers",) + tuple(
        path.split("/"))), leaf, cfg.n_layers) is not None
        for path, leaf in tree_leaves(gp["layers"])]
    n_other = len(list(tree_leaves(gp))) - len(sliced)
    assert gn == 3 * (1 + cfg.n_layers + int(not all(sliced)) + 1)
    assert ln == 3 * (n_other + sum(cfg.n_layers if s else 1
                                    for s in sliced))


def _decode_args(rng, m, k, n, delta, dtype, dev):
    """x (m, k) and one support in both sparse-decode layouts: (v_t,
    rows_t, cols_t) for sparse_matmul and (qv_t, rows_q, cols_q, qscale)
    for quant_sparse_matmul."""
    rows, cols = support.sample_support(3 * k + n, k, n, delta)
    tiles = ops.prepare_tile_consts(rows, cols, k, n,
                                    pad=support.tile_cap(k, n, delta))
    v = rng.uniform(-1, 1, rows.shape).astype(np.float32) * k ** -0.5
    v_t = ops._gather_tiles(torch.from_numpy(v), tiles["perm"])
    qv = rng.integers(-127, 128, rows.shape).astype(np.int8)
    sc = rng.uniform(1e-3, 1e-2, n).astype(np.float32)
    q = layout.build_quant_consts(rows, cols, qv, sc, k, n, delta,
                                  "row_balanced")
    return (_rand(rng, (m, k), dtype, dev),
            [t.to(dev) for t in (v_t, tiles["rows_t"], tiles["cols_t"])],
            [q[key].to(dev) for key in ("qv_t", "rows_q", "cols_q",
                                        "qscale")])


# (M, K, N, delta): ragged dims, several row blocks, and llama_1b's decode
# (M = 4 slots) and prefill (4 slots x bucket 8, 16, 32) rows
SPARSE_CASES = [
    (5, 200, 300, 0.05), (1, 136, 520, 0.03), (130, 256, 136, 0.05),
    (4, 2048, 5461, 0.03), (32, 2048, 5461, 0.03), (64, 5461, 2048, 0.03),
    (128, 2048, 2048, 0.03)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SPARSE_CASES)
def test_sparse_decode_kernels_match_plain(cuda, case, dtype):
    m, k, n, delta = case
    x, sp, qp = _decode_args(np.random.default_rng(k + n), m, k, n, delta,
                             dtype, cuda)
    for fn, plain, args in (
            (sd_kernel.sparse_matmul, ref.sparse_matmul_ref, sp),
            (sd_kernel.quant_sparse_matmul, ref.quant_sparse_matmul_ref,
             qp)):
        before = fn.launches
        got = fn(x, *args, n)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.dtype == dtype and got.shape == (m, n)
        _close(got, plain(x, *args, n), dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("split", ["one", "planned"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SPARSE_CASES)
def test_sparse_matmul_kernel_matches_plain_at_each_split(cuda, case, dtype,
                                                          split):
    m, k, n, delta = case
    x, sp, _ = _decode_args(np.random.default_rng(k + n), m, k, n, delta,
                            dtype, cuda)
    p = sd_kernel.plan(m, k, n, splits=1 if split == "one" else None)
    before = sd_kernel.sparse_matmul.launches
    got = sd_kernel.launch(p, x, *sp, n)
    torch.cuda.synchronize()
    assert sd_kernel.sparse_matmul.launches == before + 1
    _close(got, ref.sparse_matmul_ref(x, *sp, n), dtype)


def _forced_splits(m, k, n):
    """1, 2, the plan's and the most (one per k-tile), without repeats."""
    nkt = -(-k // 128)
    return sorted({1, min(2, nkt), sd_kernel.plan(m, k, n).splits, nkt})


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SPARSE_CASES)
def test_quant_sparse_matmul_kernel_matches_plain_at_each_split(cuda, case,
                                                                dtype):
    """Each split count gives the plain version's result within TOL and
    the same bits on a rerun; the dequantized values keep their bits, so
    only the order of the k sum changes."""
    m, k, n, delta = case
    x, _, qp = _decode_args(np.random.default_rng(k + n), m, k, n, delta,
                            dtype, cuda)
    want = ref.quant_sparse_matmul_ref(x, *qp, n)
    for splits in _forced_splits(m, k, n):
        p = sd_kernel.plan(m, k, n, splits=splits)
        before = sd_kernel.quant_sparse_matmul.launches
        got = sd_kernel.quant_launch(p, x, *qp, n)
        torch.cuda.synchronize()
        assert sd_kernel.quant_sparse_matmul.launches == before + 1
        _close(got, want, dtype)
        assert torch.equal(got, sd_kernel.quant_launch(p, x, *qp, n))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [(4, 2048, 5461, 0.03),
                                  (32, 5461, 2048, 0.03),
                                  (130, 256, 136, 0.05)])
def test_quant_sparse_matmul_rerun_gives_same_bits(cuda, case, dtype):
    """As for sparse_matmul: the split sum adds the partials in split
    order, and the counters are left at zero."""
    m, k, n, delta = case
    x, _, qp = _decode_args(np.random.default_rng(k + n), m, k, n, delta,
                            dtype, cuda)
    assert sd_kernel.plan(m, k, n).splits > 1
    got = sd_kernel.quant_sparse_matmul(x, *qp, n)
    for _ in range(3):
        assert torch.equal(got, sd_kernel.quant_sparse_matmul(x, *qp, n))
    torch.cuda.synchronize()
    assert all(int(c.abs().sum()) == 0
               for c in sd_kernel._counters.values())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [(4, 2048, 5461, 0.03),
                                  (32, 5461, 2048, 0.03),
                                  (130, 256, 136, 0.05)])
def test_sparse_matmul_rerun_gives_same_bits(cuda, case, dtype):
    """The split sum adds the partials in split order: reruns give the
    same bits, and the counters are left at zero for the next launch."""
    m, k, n, delta = case
    x, sp, _ = _decode_args(np.random.default_rng(k + n), m, k, n, delta,
                            dtype, cuda)
    assert sd_kernel.plan(m, k, n).splits > 1
    got = sd_kernel.sparse_matmul(x, *sp, n)
    for _ in range(3):
        assert torch.equal(got, sd_kernel.sparse_matmul(x, *sp, n))
    torch.cuda.synchronize()
    assert all(int(c.abs().sum()) == 0
               for c in sd_kernel._counters.values())


# the sparse-mode training shapes of llama_1b (M = 8 x 256 tokens): the
# forward x·S and the dx call dy·Sᵀ over Wᵀ's tiles
SPARSE_TRAIN_CASES = [(2048, 2048, 5461, 0.03), (2048, 5461, 2048, 0.03)]


@pytest.mark.gpu
@pytest.mark.parametrize("out", ["x dtype", "f32"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SPARSE_TRAIN_CASES)
def test_sparse_matmul_training_rows_match_plain(cuda, case, dtype, out):
    """At training rows, in x's dtype and with the f32 output that the
    sparse linear adds to its f32 low-rank term before its one rounding,
    within the tolerance of y's dtype (an f32 y rounded through bf16
    would miss it); a rerun gives the same bits."""
    m, k, n, delta = case
    x, sp, _ = _decode_args(np.random.default_rng(k + n), m, k, n, delta,
                            dtype, cuda)
    out_dtype = torch.float32 if out == "f32" else None
    got = sd_kernel.sparse_matmul(x, *sp, n, out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == (out_dtype or dtype)
    _close(got, ref.sparse_matmul_ref(x, *sp, n, out_dtype), got.dtype)
    assert torch.equal(got, sd_kernel.sparse_matmul(x, *sp, n, out_dtype))


def _sparse_linear_grads(dev, host, tiles, dy, scale=0.5):
    """y and (dx, dB, dA, dv) of the trainable sparse linear on ``dev``."""
    leaves = [t.to(dev).requires_grad_(True) for t in host]
    t = {name: c.to(dev) for name, c in tiles.items()}
    y = ops.sl_sparse_linear(*leaves, t["rows_t"], t["cols_t"], t["perm"],
                             scale, rows_tT=t["rows_tT"],
                             cols_tT=t["cols_tT"])
    return [y] + list(torch.autograd.grad(y, leaves, dy.to(dev)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [(300, 200, 520, 16, 0.05),
                                  (2048, 2048, 5461, 512, 0.03)])
def test_sparse_linear_backward_on_card_matches_cpu(cuda, case, dtype):
    """The sparse linear's forward and backward on the card (sparse_matmul
    forward, sparse_matmul over Wᵀ's tiles for dx, sddmm for dV) against
    the same call on the CPU, where every kernel wrapper runs its plain
    version; each kernel launches once a call, and a rerun on the card
    gives the same bits."""
    m, k, n, r, delta = case
    rng = np.random.default_rng(2)
    rows, cols = support.sample_support(5, k, n, delta)
    tiles = ops.add_transposed_tiles(ops.prepare_tile_consts(
        rows, cols, k, n, pad=support.tile_cap(k, n, delta)))
    host = [_rand(rng, shape, dtype, "cpu", lim) for shape, lim in (
        ((m, k), None), ((k, r), 1.0), ((r, n), (6.0 / k) ** 0.5),
        ((k, rows.shape[0] // k), k ** -0.5))]
    dy = _rand(rng, (m, n), dtype, "cpu")
    want = _sparse_linear_grads("cpu", host, tiles, dy)
    sp0, sd0 = sd_kernel.sparse_matmul.launches, sddmm_kernel.sddmm.launches
    got = _sparse_linear_grads(cuda, host, tiles, dy)
    torch.cuda.synchronize()
    assert sd_kernel.sparse_matmul.launches == sp0 + 2
    assert sddmm_kernel.sddmm.launches == sd0 + 1
    for name, g, w in zip(("y", "dx", "dB", "dA", "dv"), got, want):
        assert g.dtype == w.dtype, name
        scale = max(1.0, float(w.detach().float().abs().max()))
        torch.testing.assert_close(g.detach().float().cpu(),
                                   w.detach().float(),
                                   atol=TOL[dtype] * scale, rtol=TOL[dtype])
    for name, g, g2 in zip(("y", "dx", "dB", "dA", "dv"), got,
                           _sparse_linear_grads(cuda, host, tiles, dy)):
        assert torch.equal(g, g2), name


@pytest.mark.gpu
def test_quant_fallback_engine_launches_sparse_matmul_only(cuda):
    """A quant engine without int8 consts, with ``quant_fallback``, serves
    through sparse_matmul and never launches quant_sparse_matmul; its
    tokens equal a sparse engine's."""
    import dataclasses
    import warnings

    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeEngine
    cfg = registry.get_smoke_config("llama_60m")
    cfg = dataclasses.replace(cfg, param=dataclasses.replace(
        cfg.param, exec_mode="quant"))
    params, consts = registry.get_api(cfg).init(cfg, 0, device=cuda)
    kw = dict(n_slots=2, max_len=32, paged=True, block_len=8, device=cuda)
    prompts = [[5, 9, 11], [7, 3, 200, 31, 8]]
    outs = {}
    for mode in ("quant", "sparse"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            eng = ServeEngine(cfg, params, consts, exec_mode=mode,
                              quant_fallback=True, **kw)
        assert eng.quant_fell_back == (mode == "quant")
        assert any("degraded" in str(w.message) for w in caught) == \
            (mode == "quant")
        q0 = sd_kernel.quant_sparse_matmul.launches
        s0 = sd_kernel.sparse_matmul.launches
        reqs = [eng.submit(p, max_new_tokens=4) for p in prompts]
        eng.run_until_drained()
        torch.cuda.synchronize()
        assert sd_kernel.quant_sparse_matmul.launches == q0
        assert sd_kernel.sparse_matmul.launches > s0
        outs[mode] = [r.out for r in reqs]
    assert outs["quant"] == outs["sparse"]


@pytest.mark.gpu
def test_sparse_decode_kernels_sum_colliding_padding_slots(cuda):
    """Padding slots share local (0, 0) with a real entry; the kernels add
    them all (padding carries 0)."""
    rows = np.array([0, 0, 5], np.int32)
    cols = np.array([0, 7, 3], np.int32)
    tiles = ops.prepare_tile_consts(rows, cols, 128, 128, pad=8)
    v_t = ops._gather_tiles(torch.tensor([2.0, -1.0, 0.5]),
                            tiles["perm"]).to(cuda)
    x = torch.eye(128, device=cuda)[:6]
    y = sd_kernel.sparse_matmul(x, v_t, tiles["rows_t"].to(cuda),
                                tiles["cols_t"].to(cuda), 128)
    assert (y[0, 0].item(), y[0, 7].item(), y[5, 3].item()) == \
        (2.0, -1.0, 0.5)
    assert float(y.abs().sum()) == 3.5
    q = layout.build_quant_consts(rows, cols, np.array([3, -4, 5], np.int8),
                                  np.full(128, 0.5, np.float32), 128, 128,
                                  0.05, "iid")
    y = sd_kernel.quant_sparse_matmul(
        x, *[q[k].to(cuda) for k in ("qv_t", "rows_q", "cols_q", "qscale")],
        128)
    assert (y[0, 0].item(), y[0, 7].item(), y[5, 3].item()) == \
        (1.5, -2.0, 2.5)


@pytest.mark.gpu
def test_wrappers_refuse_bad_inputs(cuda):
    """The wrappers check before they launch: a wrong dtype, shape or
    layout raises instead of reaching the kernel."""
    x = torch.zeros((4, 256), device=cuda)
    B = torch.zeros((256, 8), device=cuda)
    A = torch.zeros((8, 256), device=cuda)
    t = torch.zeros((2, 2, 8), dtype=torch.int32, device=cuda)
    v = torch.zeros((2, 2, 8), device=cuda)
    with pytest.raises(TypeError):
        sl_kernel.sl_matmul(x.half(), B, A, v, t, t, 1.0)
    with pytest.raises(ValueError):
        sl_kernel.sl_matmul(x, B, A, v, t[:1], t, 1.0)
    with pytest.raises(ValueError):
        sl_kernel.sl_matmul(x.t(), B, A, v, t, t, 1.0)
    q = torch.zeros((2, 1, 1, 512), device=cuda)
    pool = torch.zeros((3, 16, 1, 512), device=cuda)
    tbl = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        pa_kernel.paged_attention(q, pool, pool, tbl, tbl[:, 0], scale=1.0)
    # the bf16 prefill takes a head_dim that is a multiple of 16 up to 128
    for hd in (24, 256):
        qp = torch.zeros((2, 4, 1, 1, hd), dtype=torch.bfloat16,
                         device=cuda)
        pp = torch.zeros((3, 16, 1, hd), dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="head_dim"):
            pa_kernel.paged_prefill(qp, pp, pp, tbl, tbl[:, 0], scale=1.0)
    # adam8bit: a wrong code dtype, mismatched block counts, a misaligned p
    p = torch.zeros((2, 256), device=cuda)
    codes = torch.zeros((2, 256), dtype=torch.int8, device=cuda)
    sc = torch.zeros(2, device=cuda)
    s10 = torch.zeros(10, device=cuda)
    with pytest.raises(TypeError, match="m_codes"):
        adam8bit_kernel.adam8bit_update(p, p, codes.float(), sc, codes, sc,
                                        s10, 512)
    with pytest.raises(ValueError, match="v_scales"):
        adam8bit_kernel.adam8bit_update(p, p, codes, sc, codes, sc[:1], s10,
                                        512)
    with pytest.raises(ValueError, match="n_valid"):
        adam8bit_kernel.adam8bit_update(p, p, codes, sc, codes, sc, s10, 100)
    odd = torch.zeros(2 * 256 + 1, device=cuda)[1:].reshape(2, 256)
    with pytest.raises(ValueError, match="aligned"):
        adam8bit_kernel.adam8bit_update(odd, p, codes, sc, codes, sc, s10,
                                        512)
    # sparse decode: a wrong x dtype, index dtype or scale shape
    x, sp, qp = _decode_args(np.random.default_rng(0), 4, 256, 256, 0.05,
                             torch.float32, cuda)
    with pytest.raises(TypeError):
        sd_kernel.sparse_matmul(x.half(), *sp, 256)
    with pytest.raises(ValueError, match="rows_t"):
        sd_kernel.sparse_matmul(x, sp[0], sp[1].long(), sp[2], 256)
    with pytest.raises(ValueError, match="qscale"):
        sd_kernel.quant_sparse_matmul(x, *qp[:3], qp[3][:1], 256)
    with pytest.raises(ValueError, match="rows_q"):
        sd_kernel.quant_sparse_matmul(x, qp[0], qp[1].int(), *qp[2:], 256)
    # the sparse-decode launches: a plan for other shapes
    with pytest.raises(ValueError, match="plan"):
        sd_kernel.launch(sd_kernel.plan(8, 256, 256), x, *sp, 256)
    with pytest.raises(ValueError, match="plan"):
        sd_kernel.quant_launch(sd_kernel.plan(8, 256, 256), x, *qp, 256)
    # sddmm: mismatched dtypes, a non-contiguous dy
    xs = torch.zeros((64, 256), dtype=torch.bfloat16, device=cuda)
    st = torch.zeros((2, 2, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        sddmm_kernel.sddmm(xs, xs.float(), st, st)
    with pytest.raises(ValueError, match="contiguous"):
        sddmm_kernel.sddmm(xs, xs.t().contiguous().t(), st, st)
