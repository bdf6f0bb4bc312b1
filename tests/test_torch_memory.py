"""The port's 8-bit optimizer and memory estimator against the reference
on the CPU: the blockwise codec, the ``adam8bit`` kernel's plain version
and its leaf wrapper (against the reference's Pallas kernel in interpret
mode), the 8-bit optimizer's slice API, ``stack_state``'s alignment rules
and the Appendix-F memory estimates.

Inputs are made from a numpy seed and fed to both packages. The reference
runs compiled (``jax.jit``), as its train step runs it. Tolerances:

* the codec's codes and scales are bitwise equal (the same IEEE
  operations: XLA turns the reference's ``/ 127.0`` into a multiplication
  by the f32 reciprocal, and the port multiplies by that reciprocal);
* the update's codes are bitwise equal, its scales agree to 1e-6
  relative and its parameters to 2e-5 absolute: the port rounds every
  product and sum on its own (as the CUDA kernel does), while XLA on the
  CPU contracts some products and sums into fused multiply-adds, so the
  f32 moments differ in their last bit here and there (a code flips only
  when that bit tips a rounding of m / scale, which these inputs do not
  reach).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.core import memory as jmemory
from repro.kernels import ops as jops
from repro.optim import optimizers as joptim
from repro.optim import quant as jquant
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core import memory
from repro_torch.kernels import adam8bit as adam8bit_kernel
from repro_torch.kernels import ops, ref
from repro_torch.optim import optimizers, quant

SIZES = [255, 256, 257, 64 * 256 + 3]


def _np(t):
    return t.detach().numpy()


# ---------------------------------------------------------------------------
# The blockwise codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("signed", [True, False], ids=["signed", "unsigned"])
@pytest.mark.parametrize("n", SIZES)
def test_quantize_blockwise_matches_reference(n, signed):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 1, n)).astype(
        np.float32)
    if not signed:
        x = np.abs(x)
    jc, js = jax.jit(lambda a: jquant.quantize_blockwise(a, 256, signed)[:2])(
        x)
    tc, ts, tn = quant.quantize_blockwise(torch.from_numpy(x), 256, signed)
    assert tn == n and tc.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    jd = jax.jit(lambda c, s: jquant.dequantize_blockwise(
        c, s, n, (n,), signed))(jc, js)
    td = quant.dequantize_blockwise(tc, ts, n, (n,), signed)
    np.testing.assert_array_equal(_np(td), np.asarray(jd))


# ---------------------------------------------------------------------------
# The adam8bit kernel's plain version and its leaf wrapper
# ---------------------------------------------------------------------------

def _adam8bit_inputs(n, seed):
    """A parameter of n elements (plus its zero padding), a gradient, and
    moments quantized from random f32 values by the reference."""
    rng = np.random.default_rng(seed)
    nq = -(-n // 256)
    p = rng.standard_normal(n).astype(np.float32)
    g = (rng.standard_normal(n) * 0.01).astype(np.float32)
    m = (rng.standard_normal(n) * 1e-3).astype(np.float32)
    v = (np.abs(rng.standard_normal(n)) * 1e-5).astype(np.float32)
    q = jax.jit(lambda a, s: jquant.quantize_blockwise(a, 256, s)[:2],
                static_argnums=1)
    mc, ms = (np.asarray(a) for a in q(m, True))
    vc, vs = (np.asarray(a) for a in q(v, False))
    assert mc.shape == (nq, 256)
    return p, g, mc, ms, vc, vs


STEP = dict(lr=1e-3, b1=0.9, b2=0.999, bc1=0.271, bc2=0.002997, eps=1e-8)


def _check_update(got, want, n):
    """Codes bitwise, scales to 1e-6 relative, params to 2e-5 absolute."""
    new_p, mc, ms, vc, vs = got
    wp, wmc, wms, wvc, wvs = (np.asarray(a) for a in want)
    np.testing.assert_allclose(_np(new_p).reshape(-1)[:n],
                               wp.reshape(-1)[:n], rtol=0, atol=2e-5)
    np.testing.assert_array_equal(_np(mc), wmc)
    np.testing.assert_array_equal(_np(vc), wvc)
    np.testing.assert_allclose(_np(ms), wms, rtol=1e-6, atol=0)
    np.testing.assert_allclose(_np(vs), wvs, rtol=1e-6, atol=0)


@pytest.mark.parametrize("wd", [0.0, 0.1])
@pytest.mark.parametrize("n", SIZES)
def test_adam8bit_matches_reference_kernel(n, wd):
    """ops.adam8bit_update on a leaf of n elements and the kernel's plain
    version on its padded blocks, against the reference's wrapper around
    its Pallas kernel (interpret mode)."""
    p, g, mc, ms, vc, vs = _adam8bit_inputs(n, seed=n + int(wd * 10))
    want = jops.adam8bit_update(p, g, mc, ms, vc, vs, wd=wd, q=256,
                                interpret=True, **STEP)
    t = lambda a: torch.from_numpy(np.array(a))
    got = ops.adam8bit_update(t(p), t(g), t(mc), t(ms), t(vc), t(vs), wd=wd,
                              q=256, **STEP)
    assert got[0].shape == (n,)
    _check_update(got, want, n)

    # the plain version on the padded blocks, as the kernel takes them
    pad = (-n) % 256
    pb = t(np.pad(p, (0, pad)).reshape(-1, 256))
    gb = t(np.pad(g, (0, pad)).reshape(-1, 256))
    scalars = ops.adam8bit_scalars(wd=wd, device="cpu", **STEP)
    blocks = ref.adam8bit_ref(pb, gb, t(mc), t(ms), t(vc), t(vs), scalars, n)
    _check_update(blocks, want, n)
    # the tail lanes carry no state: m and v are exactly 0 there
    mcb, vcb = _np(blocks[1]).reshape(-1), _np(blocks[3]).reshape(-1)
    assert (mcb[n:] == 0).all() and (vcb[n:] == -128).all()


def test_adam8bit_scalars_keep_one_minus_beta_in_double():
    s = ops.adam8bit_scalars(wd=0.1, device="cpu", **STEP)
    want = np.array([1e-3, 0.9, 0.999, 1.0 - 0.9, 1.0 - 0.999, 0.271,
                     0.002997, 1e-8, 0.1, 0.0], np.float32)
    np.testing.assert_array_equal(_np(s), want)
    # an f32 "1 - b2" would lose about half the bits of the difference
    assert np.float32(1.0) - np.float32(0.999) != want[4]


def test_adam8bit_inplace_writes_the_given_tensors():
    """inplace=True updates p (a layer slice view here) and the given
    codes and scales, with the out-of-place result's values."""
    p, g, mc, ms, vc, vs = _adam8bit_inputs(2 * 512, seed=3)
    t = lambda a: torch.from_numpy(np.array(a))
    stacked = t(p).reshape(2, 512)
    codes = t(mc).reshape(2, 2, 256)
    want = ops.adam8bit_update(stacked[1], t(g)[512:], codes[1], t(ms)[2:],
                               t(vc)[2:], t(vs)[2:], wd=0.1, **STEP)
    m_s, v_c, v_s = t(ms), t(vc), t(vs)
    view = stacked[1]
    out = ops.adam8bit_update(view, t(g)[512:], codes[1], m_s[2:], v_c[2:],
                              v_s[2:], wd=0.1, inplace=True, **STEP)
    assert out[0] is view and out[1].data_ptr() == codes[1].data_ptr()
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    assert torch.equal(stacked[1], want[0])
    assert torch.equal(stacked[0], t(p).reshape(2, 512)[0])
    assert torch.equal(codes[0], t(mc).reshape(2, 2, 256)[0])


def test_adam8bit_wrapper_refuses_other_devices():
    meta = torch.empty((1, 256), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        adam8bit_kernel.adam8bit_update(meta, meta, meta, meta[0], meta,
                                        meta[0], meta[0, :10], 256)
    with pytest.raises(ValueError, match="256-element blocks"):
        ops.adam8bit_update(torch.zeros(8), torch.zeros(8),
                            torch.zeros((1, 128), dtype=torch.int8),
                            torch.zeros(1), torch.zeros((1, 128),
                                                        dtype=torch.int8),
                            torch.zeros(1), q=128, wd=0.0, **STEP)


# ---------------------------------------------------------------------------
# The 8-bit optimizer's slice API
# ---------------------------------------------------------------------------

def _opt_pair(name, **kw):
    okw = dict(name=name, lr=1e-2, warmup_steps=2, total_steps=10,
               grad_clip=1.0, **kw)
    return joptim.make(JOptimizerConfig(**okw)), \
        optimizers.make(OptimizerConfig(**okw))


@pytest.mark.parametrize("name", ["adamw", "adam8bit"])
def test_update_slice_matches_reference(name):
    """One layer's slice of a stacked (3, 512) leaf, with the stacked
    leaf's rank as ``full_ndim`` (weight decay applies to a (512,) slice of
    an (L, d) leaf, as in global mode), and a whole 1-D leaf of 300
    elements (no decay, a padded block); the 8-bit fused dispatch agrees
    with the plain path bit for bit."""
    jopt, topt = _opt_pair(name, weight_decay=0.1)
    rng = np.random.default_rng(7)
    params = {"norm": rng.standard_normal((3, 512)).astype(np.float32),
              "bias": rng.standard_normal((300,)).astype(np.float32)}
    grads = {k: (rng.standard_normal(v.shape) * 5).astype(np.float32)
             for k, v in params.items()}
    js = jopt.init(jax.tree.map(jnp.asarray, params))
    ts = topt.init({k: torch.from_numpy(v) for k, v in params.items()})
    gnorm = np.float32(12.5)
    jctx, _ = jopt.prepare(js, jnp.float32(gnorm))
    tctx, _ = topt.prepare(ts, torch.tensor(gnorm))
    for k in ("scale", "bc1", "bc2", "lr"):
        np.testing.assert_allclose(float(tctx[k]), float(jctx[k]), rtol=1e-6)
    jst = jopt.stack_state(jopt.leaf_state(js, ("norm",)),
                           jnp.asarray(params["norm"]), 3)
    tst = topt.stack_state(topt.leaf_state(ts, ("norm",)),
                           torch.from_numpy(params["norm"]), 3)
    cases = [
        (params["norm"][1], grads["norm"][1], jax.tree.map(lambda a: a[1],
                                                           jst),
         _map(lambda a: a[1], tst), 2),
        (params["bias"], grads["bias"], jopt.leaf_state(js, ("bias",)),
         topt.leaf_state(ts, ("bias",)), None)]
    for p, g, jl, tl, full_ndim in cases:
        jp, jnl = jax.jit(lambda p_, g_, l_: jopt.update_slice(
            jctx, p_, g_, l_, full_ndim=full_ndim))(p, g, jl)
        tp, tnl = topt.update_slice(tctx, torch.from_numpy(p),
                                    torch.from_numpy(g), tl,
                                    full_ndim=full_ndim)
        np.testing.assert_allclose(_np(tp), np.asarray(jp), rtol=0,
                                   atol=2e-6)
        want = jax.tree.leaves(jnl)
        got = list(_flat(tnl).values())
        assert len(got) == len(want)
        for a, b in zip(got, want):
            if a.dtype == torch.int8:
                np.testing.assert_array_equal(_np(a), np.asarray(b))
            else:
                np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                           atol=1e-12)
        if name == "adam8bit":
            # in place: on copies, which it updates and returns
            p_in, ls_in = torch.from_numpy(p.copy()), _map(torch.clone, tl)
            fp, fnl = topt.update_slice_fused(
                tctx, p_in, torch.from_numpy(g), ls_in, full_ndim=full_ndim)
            assert fp is p_in and torch.equal(fp, tp)
            for a, b, c in zip(_flat(fnl).values(), got,
                               _flat(ls_in).values()):
                assert a is c and torch.equal(a, b)
    # the decay reached the (512,) slice: without full_ndim it would not
    p1, g1 = (torch.from_numpy(params["norm"][1]),
              torch.from_numpy(grads["norm"][1]))
    tl1 = _map(lambda a: a[1], tst)
    assert not torch.equal(topt.update_slice(tctx, p1, g1, tl1)[0],
                           topt.update_slice(tctx, p1, g1, tl1,
                                             full_ndim=2)[0])


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_adam8bit_stack_state_alignment_rules():
    """The reference's rules: a leaf slices along its layer axis exactly
    when each layer's slice is a whole number of 256-blocks; llama_1b's
    ``mlp/down/v`` (24, 5461, 61) is the one that does not."""
    opt = optimizers.make(OptimizerConfig(name="adam8bit"))
    jopt = joptim.make(JOptimizerConfig(name="adam8bit"))
    shapes = {"ok": (4, 8, 32), "bad": (4, 24), "norm": (24, 2048),
              "down_v": (24, 5461, 61), "gate_v": (2, 2048, 164)}
    tp = {k: torch.zeros(s) for k, s in shapes.items()}
    jp = {k: jnp.zeros(s) for k, s in shapes.items()}
    ts, js = opt.init(tp), jopt.init(jp)
    for k, s in shapes.items():
        n = s[0]
        got = opt.stack_state(opt.leaf_state(ts, (k,)), tp[k], n)
        want = jopt.stack_state(jopt.leaf_state(js, (k,)), jp[k], n)
        assert (got is None) == (want is None), k
        if want is not None:
            assert tuple(got["mu"]["codes"].shape) == \
                want["mu"]["codes"].shape
            assert tuple(got["nu"]["scales"].shape) == \
                want["nu"]["scales"].shape
            back = opt.unstack_state(got, tp[k], n)
            assert back["mu"]["codes"].data_ptr() == \
                ts["mu"][k]["codes"].data_ptr()
    assert opt.stack_state(opt.leaf_state(ts, ("down_v",)), tp["down_v"],
                           24) is None


# ---------------------------------------------------------------------------
# Memory estimates (Appendix F)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", sorted(memory.PAPER_LLAMA))
def test_training_estimate_matches_reference(size):
    assert memory.PAPER_LLAMA == jmemory.PAPER_LLAMA
    cfg = dict(memory.PAPER_LLAMA[size])
    rank = cfg.pop("rank")
    inv, jinv = memory.llama_inventory(**cfg), jmemory.llama_inventory(**cfg)
    assert [vars(m) for m in inv] == [vars(m) for m in jinv]
    for method in ("full", "lowrank", "relora", "galore", "sltrain"):
        assert memory.estimate(inv, method, rank=rank).as_dict() == \
            jmemory.estimate(jinv, method, rank=rank).as_dict()
    for opt in ("adamw", "adam8bit", "galore_adamw"):
        for mode in ("global", "per_layer"):
            for kw in (dict(index_bytes=4, fused_opt=True),
                       dict(moment_bytes=4)):
                got = memory.training_estimate(
                    inv, "sltrain", optimizer=opt, update_mode=mode,
                    rank=rank, **kw)
                want = jmemory.training_estimate(
                    jinv, "sltrain", optimizer=opt, update_mode=mode,
                    rank=rank, **kw)
                assert got.as_dict() == want.as_dict()
    assert memory.paper_table8(size) == jmemory.paper_table8(size)


def test_paper_f_reduction_reproduces_73_percent():
    r32 = memory.paper_f_reduction("7b", index_bytes=4)
    r64 = memory.paper_f_reduction("7b", index_bytes=8)
    assert r32 == jmemory.paper_f_reduction("7b", index_bytes=4)
    assert r64 == jmemory.paper_f_reduction("7b", index_bytes=8)
    assert round(100 * r32["reduction"], 1) == 73.6
    assert round(100 * r64["reduction"], 1) == 71.2
    assert r32["resident_ratio"] < 0.05


# ---------------------------------------------------------------------------
# The grouped 8-bit update (one launch over several segments)
# ---------------------------------------------------------------------------

# (elements, p dtype, g dtype, decay): whole blocks and ragged tails, f32
# and bf16 parameters, bf16 gradients (the bf16 trainer's) and f32 ones
# (a deferred leaf's accumulator), weight decay on and off
GROUP_SEGMENTS = [(512, torch.float32, torch.float32, True),
                  (300, torch.bfloat16, torch.bfloat16, False),
                  (64 * 256 + 3, torch.float32, torch.bfloat16, True),
                  (256, torch.bfloat16, torch.float32, True),
                  (5, torch.bfloat16, torch.bfloat16, True)]


def _segment_state(n, p_dtype, g_dtype, seed):
    rng = np.random.default_rng(seed)
    p, g, mc, ms, vc, vs = _adam8bit_inputs(n, seed)
    g = (rng.standard_normal(n) * 5).astype(np.float32)
    t = lambda a, dt=None: torch.from_numpy(np.array(a)).to(dt) \
        if dt else torch.from_numpy(np.array(a))
    return [t(p, p_dtype), t(g, g_dtype), t(mc), t(ms), t(vc), t(vs)]


@pytest.mark.parametrize("clip", [1.0, 0.37])
def test_adam8bit_group_matches_per_leaf_updates(clip):
    """The grouped update's plain path over mixed segments, in place, is
    bit for bit the per-leaf ``ops.adam8bit_update`` of each segment with
    its gradient clipped first (``g.float() * clip``) and the weight decay
    of the scalars where the segment decays, 0 where it does not."""
    scalars = ops.adam8bit_scalars(wd=0.1, device="cpu", **STEP)
    clip_t = torch.tensor(clip, dtype=torch.float32)
    segs = [_segment_state(n, pd, gd, seed=i)
            for i, (n, pd, gd, _) in enumerate(GROUP_SEGMENTS)]
    want = []
    for (n, pd, gd, decay), s in zip(GROUP_SEGMENTS, segs):
        kw = dict(STEP, wd=0.1 if decay else 0.0)
        want.append(ops.adam8bit_update(s[0], s[1].float() * clip_t,
                                        *s[2:], **kw))
    ptrs = [[t.data_ptr() for t in s] for s in segs]
    ops.adam8bit_group_update(
        [(*s, decay) for s, (*_, decay) in zip(segs, GROUP_SEGMENTS)],
        scalars=scalars, clip=clip_t)
    for s, w, pt in zip(segs, want, ptrs):
        assert [t.data_ptr() for t in s] == pt          # in place
        for a, b in zip([s[0]] + s[2:], w):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_adam8bit_group_decay_and_clip_take_effect():
    """The segment's decay flag and the clip scale both change the result
    (so the test above compares something)."""
    scalars = ops.adam8bit_scalars(wd=0.1, device="cpu", **STEP)
    base = _segment_state(512, torch.float32, torch.float32, seed=9)
    outs = []
    for decay, clip in ((True, None), (False, None), (True, 0.5)):
        s = [t.clone() for t in base]
        ops.adam8bit_group_update(
            [(*s, decay)], scalars=scalars,
            clip=None if clip is None else torch.tensor(clip))
        outs.append(s[0])
    assert not torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])


def test_adam8bit_group_refuses_other_devices():
    meta = torch.empty(256, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        adam8bit_kernel.adam8bit_group(
            [adam8bit_kernel.Segment(meta, meta, meta, meta[:1], meta,
                                     meta[:1], True)], meta[:10])
