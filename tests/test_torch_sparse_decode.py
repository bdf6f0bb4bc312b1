"""The port's sparse and int8 decode against the reference on the CPU:

* the tile-level plain versions of ``sparse_matmul`` and
  ``quant_sparse_matmul`` against the reference's Pallas kernels
  (``repro.kernels.sparse_decode``, interpret mode);
* ``ops.sl_decode`` and ``ops.sl_quant_decode`` against the reference's
  ``ops.*`` (Pallas, interpret mode) and against the port's COO oracles
  ``ref.sl_decode_ref`` / ``ref.sl_quant_decode_ref``, at the shapes of the
  reference's quant kernel test (a single tile, several, ragged K and N,
  d_out < d_in) and at one row;
* sparse-mode init emits the reference's support and the fused tile
  consts; sparse and quant are forward-only; training refuses them;
* the model forward (logits) in exec_mode sparse and quant, and the paged
  engine's greedy tokens in both modes, against the reference on the
  reference's tiny GQA config (2 layers, d_model 64, d_ff 160, rank 8,
  δ 0.05) with a non-zero B.

Tolerances: f32 |got − want| ≤ 1e-5·(|want| + max|want|) — the same f32
math with sums in another order (the reference's interpret-mode kernels
add one f32 product per k-tile); bf16 within one bf16 ulp of the
reference's ops, the ulp taken at the larger of the output and the
decode's two f32 addends, (x·B)·A·scale and x·S (the kernel term's
rounding to bf16 and the final one can tip where the f32 sums differ in
their last bits, and where the addends cancel such a difference is large
next to the sum itself). The COO oracles round
once where the decode, like the reference's, rounds the kernel's term
before adding the low-rank one, so they are held in f32 only: in bf16
the two differ by more than an ulp of the sum wherever the terms cancel.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import ParamConfig as JParamConfig
from repro.core import sltrain as jsltrain
from repro.core import support as jsupport
from repro.kernels import ops as jops
from repro.kernels import sparse_decode as jsd
from repro.models import registry as jregistry
from repro.quant import calibrate as jcalibrate
from repro.quant import layout as jlayout
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.ckpt.checkpoint import load_quant_artifact
from repro_torch.ckpt.convert import from_jax_numpy
from repro_torch.configs.base import ModelConfig, OptimizerConfig, ParamConfig
from repro_torch.core import sltrain
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sparse_decode as sd_kernel
from repro_torch.models import registry
from repro_torch.optim import optimizers
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import perlayer
from repro_torch.train import step as step_lib

RTOL = 1e-5
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (M, K, N, r, delta): the reference quant test's shapes at its M = 5
# (tests/test_quant.py:44: one tile, several, ragged K and N, d_out <
# d_in), and one decode row
SHAPES = [
    (5, 128, 128, 16, 0.03), (5, 256, 384, 16, 0.03),
    (5, 130, 250, 8, 0.05), (5, 384, 128, 8, 0.05),
    (1, 256, 384, 16, 0.05)]


def _bf16_ulp(t):
    """One bf16 ulp at the magnitude of ``t`` (8 significant bits)."""
    e = torch.floor(torch.log2(t.abs().clamp(min=2.0 ** -126)))
    return torch.exp2(e - 7)


def assert_close(got, want, dtype, terms=None):
    """f32: within RTOL of the output's scale. bf16: within one bf16 ulp of
    the larger of |want| and ``terms`` (the magnitudes of the decode's two
    f32 addends, where the output is their sum)."""
    got = got.float() if isinstance(got, torch.Tensor) else \
        torch.tensor(np.asarray(got, np.float32))
    want = torch.tensor(np.asarray(want, np.float32))
    assert got.shape == want.shape, (got.shape, want.shape)
    err = (got - want).abs()
    if dtype == "float32":
        bound = RTOL * (want.abs() + want.abs().max())
    else:
        mag = want.abs() if terms is None else torch.maximum(want.abs(),
                                                             terms)
        bound = _bf16_ulp(mag)
    assert bool((err <= bound).all()), \
        f"max abs err {err.max():.3e}, worst err/bound {(err / bound).max():.2f}"


def _terms(x, B, A, S, scale):
    """max(|(x·B)·A·scale|, |x·S|) in f32 — the decode's two addends."""
    x = torch.from_numpy(x)
    lr = ((x @ torch.from_numpy(B)) @ torch.from_numpy(A)) * scale
    return torch.maximum(lr.abs(), (x @ S).abs())


def _linear(m, k, n, r, delta, seed):
    """x, B, A and a row-balanced support with values, numpy f32."""
    rng = np.random.default_rng(seed)
    rows, cols = jsupport.sample_support(seed + 1, k, n, delta)
    x = rng.standard_normal((m, k)).astype(np.float32)
    B = (rng.standard_normal((k, r)) * 0.05).astype(np.float32)
    A = (rng.standard_normal((r, n)) * 0.05).astype(np.float32)
    v = (rng.standard_normal(rows.shape[0]) * 0.05).astype(np.float32)
    return x, B, A, rows, cols, v


def _quantized(B, A, rows, cols, v, scale):
    """The reference's per-channel int8 codes, scales and quant consts for
    one linear (numpy)."""
    W = scale * (B @ A)
    W[rows, cols] += v
    sc = jlayout.channel_scales(W)
    qv = jlayout.quantize_values(v, cols, sc)
    return qv, sc


def _t(a, dtype="float32"):
    return torch.from_numpy(np.asarray(a, np.float32)).to(TDT[dtype])


def _j(a, dtype="float32"):
    return jnp.asarray(np.asarray(a, np.float32)).astype(JDT[dtype])


def _tiles(rows, cols, k, n, pad):
    return ops.prepare_tile_consts(rows, cols, k, n, pad=pad)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SHAPES[:4])
def test_kernel_plain_versions_match_reference_kernels(case, dtype):
    """The tile-level plain versions (what the wrappers run on the CPU)
    against the reference's Pallas kernels on x padded as its ops pad
    it."""
    m, k, n, r, delta = case
    x, B, A, rows, cols, v = _linear(m, k, n, r, delta, seed=k + n)
    jv_t, jrt, jct, _ = jops.prepare_tiles(rows, cols, v, k, n)
    xp = np.zeros((-(-m // 8) * 8, -(-k // 128) * 128), np.float32)
    xp[:m, :k] = x
    want = jsd.sparse_matmul(_j(xp, dtype), jv_t, jrt, jct,
                             interpret=True)[:m, :n]
    tiles = _tiles(rows, cols, k, n, jrt.shape[-1])
    v_t = ops._gather_tiles(torch.from_numpy(v), tiles["perm"])
    before = sd_kernel.sparse_matmul.launches
    got = sd_kernel.sparse_matmul(_t(x, dtype), v_t, tiles["rows_t"],
                                  tiles["cols_t"], n)
    assert sd_kernel.sparse_matmul.launches == before   # CPU: plain version
    assert got.dtype == TDT[dtype] and got.shape == (m, n)
    assert_close(got, want, dtype)

    qv, sc = _quantized(B, A, rows, cols, v, 2.0)
    jq = jlayout.build_quant_consts(rows, cols, qv, sc, k, n, delta,
                                    "row_balanced")
    want = jsd.quant_sparse_matmul(_j(xp, dtype), jq["qv_t"], jq["rows_q"],
                                   jq["cols_q"], jq["qscale"],
                                   interpret=True)[:m, :n]
    q = {key: torch.from_numpy(np.array(a)) for key, a in jq.items()}
    before = sd_kernel.quant_sparse_matmul.launches
    got = sd_kernel.quant_sparse_matmul(_t(x, dtype), q["qv_t"],
                                        q["rows_q"], q["cols_q"],
                                        q["qscale"], n)
    assert sd_kernel.quant_sparse_matmul.launches == before
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SHAPES)
def test_sl_decode_matches_reference_ops_and_oracle(case, dtype):
    m, k, n, r, delta = case
    x, B, A, rows, cols, v = _linear(m, k, n, r, delta, seed=3 * k + n)
    scale = 16.0 / r
    jv_t, jrt, jct, _ = jops.prepare_tiles(rows, cols, v, k, n)
    want = jops.sl_decode(_j(x, dtype), _j(B, dtype), _j(A, dtype), jv_t,
                          jrt, jct, scale, interpret=True)
    tiles = _tiles(rows, cols, k, n, jrt.shape[-1])
    v_t = ops._gather_tiles(torch.from_numpy(v), tiles["perm"])
    xt, Bt, At = _t(x, dtype), _t(B, dtype), _t(A, dtype)
    got = ops.sl_decode(xt, Bt, At, v_t, tiles["rows_t"], tiles["cols_t"],
                        scale)
    assert got.dtype == TDT[dtype] and got.shape == (m, n)
    S = torch.zeros(k, n)
    S[rows, cols] = torch.from_numpy(v)
    assert_close(got, want, dtype, _terms(x, B, A, S, scale))
    if dtype == "float32":
        oracle = ref.sl_decode_ref(xt, Bt, At, torch.from_numpy(rows),
                                   torch.from_numpy(cols),
                                   torch.from_numpy(v), scale)
        assert_close(got, oracle.numpy(), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SHAPES)
def test_sl_quant_decode_matches_reference_ops_and_oracle(case, dtype):
    m, k, n, r, delta = case
    x, B, A, rows, cols, v = _linear(m, k, n, r, delta, seed=5 * k + n)
    scale = 16.0 / r
    qv, sc = _quantized(B, A, rows, cols, v, scale)
    jq = jlayout.build_quant_consts(rows, cols, qv, sc, k, n, delta,
                                    "row_balanced")
    want = jops.sl_quant_decode(_j(x, dtype), _j(B, dtype), _j(A, dtype),
                                jq["qv_t"], jq["rows_q"], jq["cols_q"],
                                jq["qscale"], scale, interpret=True)
    q = {key: torch.from_numpy(np.array(a)) for key, a in jq.items()}
    xt, Bt, At = _t(x, dtype), _t(B, dtype), _t(A, dtype)
    got = ops.sl_quant_decode(xt, Bt, At, q["qv_t"], q["rows_q"],
                              q["cols_q"], q["qscale"], scale)
    assert got.dtype == TDT[dtype] and got.shape == (m, n)
    S = torch.zeros(k, n)
    S[rows, cols] = torch.from_numpy(jlayout.dequantize_values(qv, cols, sc))
    assert_close(got, want, dtype, _terms(x, B, A, S, scale))
    if dtype == "float32":
        oracle = ref.sl_quant_decode_ref(
            xt, Bt, At, torch.from_numpy(rows), torch.from_numpy(cols),
            torch.from_numpy(qv), torch.from_numpy(sc), scale)
        assert_close(got, oracle.numpy(), dtype)


def test_sparse_matmul_sums_colliding_padding_slots():
    """Padding slots share local (0, 0) with a real entry: the plain
    version adds every slot (padding carries 0) in both layouts."""
    rows = np.array([0, 0, 5], np.int32)
    cols = np.array([0, 7, 3], np.int32)
    tiles = _tiles(rows, cols, 128, 128, 8)
    v_t = ops._gather_tiles(torch.tensor([2.0, -1.0, 0.5]), tiles["perm"])
    x = torch.eye(128)[:6]
    y = sd_kernel.sparse_matmul(x, v_t, tiles["rows_t"], tiles["cols_t"],
                                128)
    assert (y[0, 0], y[0, 7], y[5, 3]) == (2.0, -1.0, 0.5)
    assert float(y.abs().sum()) == 3.5
    qv = torch.tensor([3, -4, 5], dtype=torch.int8)
    qv_t = torch.where(tiles["perm"] >= 0, qv[tiles["perm"].clamp(0).long()],
                       torch.zeros((), dtype=torch.int8))
    qscale = torch.full((1, 128), 0.5)
    y = sd_kernel.quant_sparse_matmul(
        x, qv_t, tiles["rows_t"].to(torch.int16),
        tiles["cols_t"].to(torch.int16), qscale, 128)
    assert (y[0, 0], y[0, 7], y[5, 3]) == (1.5, -2.0, 2.5)


def test_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on a card never falls back
    to the plain version."""
    meta = torch.empty((2, 128), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sd_kernel.sparse_matmul(meta, meta, meta, meta, 128)
    with pytest.raises(ValueError, match="unsupported device"):
        sd_kernel.quant_sparse_matmul(meta, meta, meta, meta, meta, 128)


# ---------------------------------------------------------------------------
# sparse_matmul's split of K (the kernel's grid, from the shapes alone)
# ---------------------------------------------------------------------------

# llama_1b's three projection shapes (d_model 2048, d_ff 5461)
LLAMA_1B_SHAPES = [(2048, 2048), (2048, 5461), (5461, 2048)]


@pytest.mark.parametrize("m", [1, 4, 5, 32, 64, 128, 130, 2048])
@pytest.mark.parametrize("k, n", LLAMA_1B_SHAPES + [(200, 300), (128, 128)])
def test_sparse_matmul_plan_covers_each_k_tile_once(m, k, n):
    """The splits of an n-tile partition its k-tiles: each one is summed
    by exactly one split, and no split is empty."""
    p = sd_kernel.plan(m, k, n)
    nkt = -(-k // 128)
    spans = [sd_kernel.k_tiles(p, nkt, z) for z in range(p.splits)]
    assert [kt for span in spans for kt in span] == list(range(nkt))
    assert all(len(span) >= 1 for span in spans)
    for splits in range(1, nkt + 1):
        forced = sd_kernel.plan(m, k, n, splits=splits)
        spans = [sd_kernel.k_tiles(forced, nkt, z) for z in range(splits)]
        assert sorted(kt for span in spans for kt in span) == \
            list(range(nkt))


@pytest.mark.parametrize("m", [4, 32, 64, 128])
@pytest.mark.parametrize("k, n", LLAMA_1B_SHAPES)
def test_sparse_matmul_plan_fills_the_card_at_engine_rows(m, k, n):
    """At every row count the engine gives the kernel, the grid reaches
    two blocks per SM of the H100 (132 SMs) or one split per k-tile, with
    the fewest splits that do; the f32 partials are splits x M x N x 4
    bytes and there is one counter per (row block, n-tile)."""
    p = sd_kernel.plan(m, k, n)
    nkt, nnt = -(-k // 128), -(-n // 128)
    target = sd_kernel.BLOCKS_PER_SM * sd_kernel.SMS
    assert p.blocks >= target or p.splits == nkt
    assert p.splits == 1 or p.blocks - nnt * p.row_blocks < target
    assert p.rows_per_block == (4 if m <= 4 else 32)
    assert p.row_blocks == -(-m // p.rows_per_block)
    assert p.splits > 1
    assert p.partial == (p.splits, m, n)
    assert p.partial_bytes == p.splits * m * n * 4
    assert p.counters == nnt * p.row_blocks


def test_sparse_matmul_plan_at_llama_1b_decode():
    """The decode batch of 4 rows at 2048 -> 5461: 7 splits of the 16
    k-tiles over 43 n-tiles (301 blocks, against 43 unsplit), 0.61 MB of
    partials; at 128 rows the row blocks already give 172 blocks, so 2
    splits; and on a card with twice the SMs, twice the splits."""
    p = sd_kernel.plan(4, 2048, 5461)
    assert (p.splits, p.blocks, p.partial_bytes) == (7, 301, 611_632)
    assert sd_kernel.plan(128, 2048, 5461).splits == 2
    assert sd_kernel.plan(4, 2048, 5461, sms=264).splits == 13
    assert sd_kernel.plan(4, 2048, 2048).splits == 16         # = nkt


@pytest.mark.parametrize("m, k, n", [(2048, 2048, 5461), (2048, 5461, 2048),
                                     (1024, 2048, 2048), (4, 128, 128)])
def test_sparse_matmul_plan_one_split_when_the_grid_is_full(m, k, n):
    """Where the row blocks and n-tiles already fill the card (or K is a
    single k-tile) there is one split and no scratch: each block writes y
    from its own chain, as the unsplit kernel did."""
    p = sd_kernel.plan(m, k, n)
    assert (p.splits, p.partial, p.partial_bytes, p.counters) == \
        (1, None, 0, 0)


def test_sparse_matmul_plan_refuses_bad_splits():
    with pytest.raises(ValueError, match="splits"):
        sd_kernel.plan(4, 2048, 5461, splits=0)
    with pytest.raises(ValueError, match="splits"):
        sd_kernel.plan(4, 2048, 5461, splits=17)


@pytest.mark.parametrize("m", [4, 32, 64, 128])
@pytest.mark.parametrize("k, n", LLAMA_1B_SHAPES)
def test_quant_sparse_matmul_runs_sparse_matmuls_plan(m, k, n, monkeypatch):
    """Both wrappers hand the split kernel the same plan at every engine
    shape: the plan of the shapes and the card's SM count."""
    seen = []
    monkeypatch.setattr(sd_kernel, "_sms", lambda x: sd_kernel.SMS)
    monkeypatch.setattr(sd_kernel, "_check_sparse", lambda *a: None)
    monkeypatch.setattr(sd_kernel, "_check_quant", lambda *a: None)
    monkeypatch.setattr(sd_kernel, "_run",
                        lambda p, wrapper, *a: seen.append((p, wrapper)))
    x = torch.empty((m, k), device="meta")
    sd_kernel.sparse_matmul(x, None, None, None, n)
    sd_kernel.quant_sparse_matmul(x, None, None, None, None, n)
    assert seen == [(sd_kernel.plan(m, k, n), sd_kernel.sparse_matmul),
                    (sd_kernel.plan(m, k, n),
                     sd_kernel.quant_sparse_matmul)]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_quant_launch_refuses_non_cuda_tensors(device):
    """quant_launch(plan, ...) launches the kernel or raises, as launch
    does: it never runs the plain version."""
    x = torch.zeros((4, 256), device=device)
    consts = [torch.zeros((2, 2, 8), dtype=dt, device=device)
              for dt in (torch.int8, torch.int16, torch.int16)]
    qscale = torch.zeros((2, 128), device=device)
    with pytest.raises(ValueError, match="unsupported device"):
        sd_kernel.quant_launch(sd_kernel.plan(4, 256, 256), x, *consts,
                               qscale, 256)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_sparse_matmul_launch_refuses_non_cuda_tensors(device):
    """launch(plan, ...) launches the kernel or raises: it never runs the
    plain version and never hands host memory to the kernel."""
    x = torch.zeros((4, 256), device=device)
    consts = [torch.zeros((2, 2, 8), dtype=dt, device=device)
              for dt in (torch.float32, torch.int32, torch.int32)]
    with pytest.raises(ValueError, match="unsupported device"):
        sd_kernel.launch(sd_kernel.plan(4, 256, 256), x, *consts, 256)


# ---------------------------------------------------------------------------
# the SLTrain linear in sparse / quant mode
# ---------------------------------------------------------------------------

def test_sparse_init_emits_reference_support_and_fused_tile_consts():
    d_in, d_out, r, delta = 130, 250, 8, 0.05
    _, jc = jsltrain.init_params(jax.random.PRNGKey(0), d_in, d_out, r,
                                 delta, seed=11, exec_mode="sparse")
    _, jf = jsltrain.init_params(jax.random.PRNGKey(0), d_in, d_out, r,
                                 delta, seed=11, exec_mode="fused")
    _, tc = sltrain.init_params(torch.Generator(), d_in, d_out, r, delta,
                                seed=11, exec_mode="sparse", device="cpu")
    assert set(jc) <= set(tc) and set(tc) == set(jf)
    for key in tc:
        want = jc[key] if key in jc else jf[key]
        np.testing.assert_array_equal(tc[key].numpy(), np.asarray(want))


def test_sparse_and_quant_are_forward_only():
    d_in, d_out, r, delta = 64, 96, 8, 0.05
    p, c = sltrain.init_params(torch.Generator().manual_seed(0), d_in,
                               d_out, r, delta, dtype=torch.float32, seed=3,
                               exec_mode="sparse", device="cpu")
    p["B"] = _t(np.random.default_rng(1).uniform(-1, 1, (d_in, r)))
    x = _t(np.random.default_rng(2).standard_normal((2, d_in)))
    y = sltrain.sl_matmul(x, p, c, 1.0, "sparse")
    want = sltrain.sl_matmul(x, p, c, 1.0, "dense")
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 7b"):
        sltrain.sl_matmul(x.requires_grad_(), p, c, 1.0, "sparse")
    with pytest.raises(ValueError, match="needs quantized consts"):
        sltrain.sl_matmul(x.detach(), p, c, 1.0, "quant")
    cfg = registry.get_smoke_config("llama_60m")
    api = registry.get_api(cfg)
    opt = optimizers.make(OptimizerConfig())
    for mode, err in (("sparse", NotImplementedError), ("quant", ValueError)):
        c2 = dataclasses.replace(cfg, param=dataclasses.replace(
            cfg.param, exec_mode=mode))
        with pytest.raises(err, match="item 7b" if mode == "sparse"
                           else "serve-only"):
            step_lib.make_train_step(c2, api, opt)
        with pytest.raises(err):
            perlayer.make_perlayer_train_step(c2, api, opt)


# ---------------------------------------------------------------------------
# the model and the engine on the reference's tiny GQA config, f32
# ---------------------------------------------------------------------------

def _cfgs(n_kv_heads, exec_mode):
    kw = dict(name=f"quant-gqa{n_kv_heads}", family="llama", n_layers=2,
              d_model=64, n_heads=4, n_kv_heads=n_kv_heads, d_ff=160,
              vocab_size=256, vocab_pad_multiple=16, max_seq_len=64,
              dtype="float32")
    pk = dict(mode="sltrain", rank=8, delta=0.05, alpha=16.0,
              exec_mode=exec_mode)
    return (JModelConfig(**kw, param=JParamConfig(**pk)),
            ModelConfig(**kw, param=ParamConfig(**pk)))


@functools.lru_cache(maxsize=None)
def _weights(n_kv_heads):
    """The reference's init (fused, so the support and the tile consts
    both exist) with B drawn U(−1, 1), as numpy trees, and its int8
    calibration."""
    jcfg, _ = _cfgs(n_kv_heads, "fused")
    params, consts = jregistry.get_api(jcfg).init(
        jcfg, jax.random.PRNGKey(0), seed=0)
    rng = np.random.default_rng(1)

    def fill_b(path, leaf):
        if str(path[-1].key) == "B":
            return rng.uniform(-1, 1, leaf.shape).astype(np.float32)
        return np.asarray(leaf)

    params = jax.tree_util.tree_map_with_path(fill_b, params)
    consts = jax.tree.map(np.asarray, consts)
    qp, qc, stats = jcalibrate.calibrate_model(jcfg, params, consts)
    return params, consts, jax.tree.map(np.asarray, qp), \
        jax.tree.map(np.asarray, qc), stats


@pytest.mark.parametrize("n_kv", [4, 2, 1])
def test_model_forward_matches_reference_sparse_and_quant(n_kv):
    params, consts, qp, qc, _ = _weights(n_kv)
    tok = np.random.default_rng(2).integers(3, 256, size=(2, 16))
    for mode, (p, c) in (("sparse", (params, consts)), ("quant", (qp, qc))):
        jcfg, cfg = _cfgs(n_kv, mode)
        jl, _ = jregistry.get_api(jcfg).apply(
            jcfg, jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, c),
            {"tokens": jnp.asarray(tok, jnp.int32)})
        tp, tc = from_jax_numpy(p, c, device="cpu")
        tl, _ = registry.get_api(cfg).apply(
            cfg, tp, tc, {"tokens": torch.from_numpy(tok)})
        assert tl.shape == jl.shape and torch.isfinite(tl).all()
        assert_close(tl, jl, "float32")


def _serve(engine, prompts, new_tokens=4):
    reqs = [engine.submit(p, max_new_tokens=new_tokens) for p in prompts]
    engine.run_until_drained()
    assert all(r.status == "done" for r in reqs)
    return [r.out for r in reqs]


def test_engine_greedy_tokens_match_reference_sparse_and_quant(tmp_path):
    """The paged engine, ``sparse_decode=True`` on the reference's weights
    and ``exec_mode="quant"`` on one quant artifact that the reference
    wrote and both packages load, gives the reference engine's greedy
    tokens."""
    params, consts, qp, qc, stats = _weights(2)
    art = str(tmp_path / "artifact")
    jckpt.save_quant_artifact(art, qp, qc, extra=stats)
    jqp, jqc, _ = jckpt.load_quant_artifact(art)
    tqp, tqc, _ = load_quant_artifact(art, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, 256, size=int(n)).tolist()
               for n in rng.integers(3, 9, size=3)]
    jcfg, cfg = _cfgs(2, "fused")
    kw = dict(n_slots=2, max_len=32, paged=True, block_len=8)
    jeng = JaxEngine(jcfg, jax.tree.map(jnp.asarray, params),
                     jax.tree.map(jnp.asarray, consts), sparse_decode=True,
                     **kw)
    teng = ServeEngine(cfg, *from_jax_numpy(params, consts, device="cpu"),
                       sparse_decode=True, device="cpu", **kw)
    assert teng.cfg.param.exec_mode == "sparse"
    assert _serve(teng, prompts) == _serve(jeng, prompts)
    jeng = JaxEngine(jcfg, jqp, jqc, exec_mode="quant", **kw)
    teng = ServeEngine(cfg, tqp, tqc, exec_mode="quant", device="cpu", **kw)
    assert _serve(teng, prompts) == _serve(jeng, prompts)
