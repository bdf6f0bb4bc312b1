"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``gpu`` and skips (inside a fixture)
without a CUDA device. The file imports neither jax nor the reference, so
it also runs where only the port's dependencies are installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py

Tolerances (atol = rtol), as in chip_smoke.py: f32 1e-4, bf16 2e-2.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import support
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as pa_kernel
from repro_torch.kernels import sl_matmul as sl_kernel

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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [
    # (M, K, N, r, delta): ragged dims, several row blocks, llama_1b decode
    # (M = 4 slots) and prefill (M = 4 slots x bucket 8, 16, 32), which
    # select each row-block variant of the kernel
    (5, 200, 300, 16, 0.05), (130, 256, 136, 8, 0.05),
    (1, 136, 520, 32, 0.03), (4, 2048, 5461, 512, 0.03),
    (32, 2048, 5461, 512, 0.03), (64, 5461, 2048, 512, 0.03),
    (128, 5461, 2048, 512, 0.03)])
def test_sl_matmul_kernel_matches_plain(cuda, case, dtype):
    m, k, n, r, delta = case
    rng = np.random.default_rng(k + n)
    rows, cols = support.sample_support(k + n, k, n, delta)
    tiles = ops.prepare_tile_consts(rows, cols, k, n,
                                    pad=support.tile_cap(k, n, delta))
    tiles = {name: t.to(cuda) for name, t in tiles.items()}
    v = _rand(rng, rows.shape, torch.float32, cuda, k ** -0.5)
    args = (_rand(rng, (m, k), dtype, cuda), _rand(rng, (k, r), dtype, cuda,
                                                   1.0),
            _rand(rng, (r, n), dtype, cuda, (6.0 / k) ** 0.5),
            ops._gather_tiles(v, tiles["perm"]), tiles["rows_t"],
            tiles["cols_t"], 8.0 / r)
    before = sl_kernel.sl_matmul.launches
    got = sl_kernel.sl_matmul(*args)
    torch.cuda.synchronize()
    assert sl_kernel.sl_matmul.launches == before + 1
    assert got.dtype == dtype and got.shape == (m, n)
    _close(got, ref.sl_matmul_ref(*args), dtype)


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
    (64, 1, 8, 256, [300, 17], 20.0, 100)])
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [
    # (block_len, n_kv, group, hd, sq, offsets, lengths, softcap, window)
    (8, 2, 2, 16, 8, [0, 8, 16, 0], [8, 5, 3, 0], 0.0, 0),
    (16, 32, 1, 64, 8, [0, 16, 0, 16], [8, 5, 3, 0], 0.0, 0),
    (16, 32, 1, 64, 32, [0, 16, 0, 16], [24, 8, 3, 0], 0.0, 0),
    (16, 8, 4, 64, 32, [16, 0], [20, 32], 30.0, 12),
    (4, 1, 4, 32, 6, [4, 0, 12], [6, 6, 2], 25.0, 0)])
def test_paged_prefill_kernel_matches_plain(cuda, case, dtype):
    block_len, n_kv, group, hd, sq, offsets, lengths, cap, win = case
    rng = np.random.default_rng(6)
    n_slots = len(offsets)
    last = [o + l - 1 if l > 0 else -1 for o, l in zip(offsets, lengths)]
    bps = (max(offsets) + sq) // block_len + 1
    kp, vp, table = _pools(rng, n_slots, bps, block_len, n_kv, hd, last,
                           dtype, cuda)
    offs = torch.tensor(offsets, dtype=torch.int32, device=cuda)
    q = _rand(rng, (n_slots, sq, n_kv, group, hd), dtype, cuda)
    kw = dict(scale=hd ** -0.5, softcap=cap, window=win)
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
