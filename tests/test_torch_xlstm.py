"""The port's xLSTM family (``repro_torch.models.xlstm``) against the
reference on the CPU, on the SMOKE config of ``xlstm_350m`` (4 layers: 2
super blocks of 1 mLSTM and 1 sLSTM block) in f32, the reference under
``jax.jit``, from one reference init carried over with
``from_jax_numpy`` (``tests/_torch_parity.py`` says how its weights are
drawn):

* ``mlstm_chunked``, ``mlstm_step`` and ``_slstm_scan`` on seeded inputs,
  sequences a multiple of ``chunk`` and not;
* the forward logits in exec_mode dense, fused and sparse;
* 6 decode steps: logits and every state of the cache;
* the gradients of one train step in each exec mode, leaf for leaf, and
  3-step trajectories of global AdamW (sparse) and 8-bit AdamW (fused);
* the contiguous engine's tokens in exec_mode dense, fused, sparse and
  quant (one artifact the reference calibrated, loaded by each package;
  the port's own calibration's ``max_abs_err`` within 1e-7 of the
  reference's);
* the supports and tile consts of the port's own init bit for bit, the
  collecting pass over the full config at the reference's Builder paths
  with one full-width ``qkv`` support, the config hashes and the
  analytic 6·N·D counts (the reference's 8·d² fallback for d_ff = 0);
* the refusals the reference makes and the launchers.

Tolerances: 1e-4 absolute and relative on logits, caches, states and
gradients (f32, sums in another order: ``torch.einsum`` contracts
the 4-operand einsums in another order than XLA); the loss 2e-5
absolute; trajectories as ``tests/_torch_parity.py`` holds them
(step 1 5e-5 relative, later steps 1e-3, as ``chip_smoke.py``
gates its training pairs).
"""
import jax
import numpy as np
import pytest
import torch

import _torch_parity as tp_
from repro.core import support as jsupport
from repro.models import common as jcommon
from repro.models import xlstm as jxlstm
from repro_torch.models import registry, xlstm

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

ARCH = "xlstm_350m"


@pytest.mark.parametrize("s, chunk", [(64, 32), (40, 16), (7, 32)])
def test_mlstm_chunked_and_step_match_reference(s, chunk):
    rng = np.random.default_rng(s)
    b, h, p = 2, 4, 8
    q, k, v = (rng.standard_normal((b, s, h, p)).astype(np.float32)
               for _ in range(3))
    ig, fg = (rng.standard_normal((b, s, h)).astype(np.float32) * 2
              for _ in range(2))
    wy, wf = jax.jit(lambda *t: jxlstm.mlstm_chunked(*t, chunk))(
        q, k, v, ig, fg)
    gy, gf = xlstm.mlstm_chunked(*map(torch.from_numpy, (q, k, v, ig, fg)),
                                 chunk)
    tp_.close(gy, wy)
    tp_.close(gf, wf)
    st, jst = gf, wf
    step = jax.jit(jxlstm.mlstm_step)
    for _ in range(3):
        args = [rng.standard_normal(sh).astype(np.float32)
                for sh in ((b, h, p),) * 3 + ((b, h),) * 2]
        wy_t, jst = step(jst, *args)
        gy_t, st = xlstm.mlstm_step(st, *map(torch.from_numpy, args))
        tp_.close(gy_t, wy_t)
        tp_.close(st, jst)


@pytest.mark.parametrize("from_zero", [True, False])
def test_slstm_scan_matches_reference(from_zero):
    """The sLSTM recurrence over 9 steps, from the zero state (m = 0, as
    the reference starts it) and from a seeded one."""
    jparams, _, tparams, _ = tp_.weights(ARCH)
    _, cfg = tp_.cfgs(ARCH)
    rng = np.random.default_rng(4)
    d, heads = cfg.d_model, cfg.n_heads
    xg = rng.standard_normal((2, 9, 4 * d)).astype(np.float32)
    shape = (2, heads, d // heads)
    state = {k: np.zeros(shape, np.float32) if from_zero else
             rng.standard_normal(shape).astype(np.float32) * (
                 0.3 if k != "n" else 1)
             for k in ("h", "c", "n", "m")}
    if not from_zero:
        state["n"] = np.abs(state["n"]) + 1
    jp = jax.tree.map(lambda t: t[0], jparams["supers"]["slstm"])
    tp = {"R": tparams["supers"]["slstm"]["R"][0]}
    wy, ws = jax.jit(lambda p, x, s: jxlstm._slstm_scan(cfg, p, x, s))(
        jp, xg, state)
    gy, gs = xlstm._slstm_scan(cfg, tp, torch.from_numpy(xg),
                               {k: torch.from_numpy(v)
                                for k, v in state.items()})
    tp_.close(gy, wy)
    tp_.same_tree(gs, ws)
    if from_zero:
        got = xlstm.slstm_init_state(cfg, 2, "cpu")
        assert all(float(t.abs().max()) == 0 for t in got.values())


@pytest.mark.parametrize("exec_mode", ["dense", "fused", "sparse"])
def test_forward_matches_reference(exec_mode):
    tp_.forward_matches_reference(ARCH, exec_mode)


def test_decode_matches_reference():
    """6 decode steps on the contiguous cache: logits and every state (the
    mLSTM's C, the sLSTM's h, c, n, m) after each."""
    jparams, jconsts, tparams, tconsts = tp_.weights(ARCH)
    jcfg, cfg = tp_.cfgs(ARCH, "fused")
    jcache = jxlstm.init_xlstm_cache(jcfg, 3, 16)
    cache = xlstm.init_xlstm_cache(cfg, 3, 16, device="cpu")
    tp_.same_tree(cache, jcache, exact=True)
    step = jax.jit(lambda p, c, t, k, i: jxlstm.xlstm_decode_step(
        jcfg, p, c, t, k, i))
    for i in range(6):
        toks = tp_.tokens(cfg, (3, 1), seed=i)
        wl, jcache = step(jparams, jconsts, toks, jcache, i)
        with torch.no_grad():
            gl, cache = xlstm.xlstm_decode_step(
                cfg, tparams, tconsts, torch.from_numpy(toks), cache, i)
        tp_.close(gl, wl)
        tp_.same_tree(cache, jcache)


@pytest.mark.parametrize("exec_mode", ["dense", "fused", "sparse"])
def test_train_step_gradients_match_reference(exec_mode):
    """The loss and every gradient leaf of one step: the mLSTM's factors,
    gates and norms; the sLSTM's wx, R, bias and FFN."""
    grads = tp_.gradients_match_reference(ARCH, exec_mode)
    assert float(grads["supers"]["slstm"]["R"].abs().max()) > 0


@pytest.mark.parametrize("opt, exec_mode", [("adamw", "sparse"),
                                            ("adam8bit", "fused")])
def test_trajectories_match_reference(opt, exec_mode):
    tp_.trajectory_matches_reference(ARCH, opt, exec_mode)


@pytest.mark.parametrize("exec_mode", ["dense", "fused", "sparse"])
def test_contiguous_engine_matches_reference(exec_mode):
    tp_.engine_matches_reference(ARCH, exec_mode)


def test_quant_engine_matches_reference(tmp_path):
    tp_.quant_engine_matches_reference(ARCH, tmp_path)


def test_supports_match_reference_bit_for_bit():
    _, jconsts, _, _ = tp_.weights(ARCH)
    _, cfg = tp_.cfgs(ARCH)
    _, consts = xlstm.init_xlstm(cfg, 0, device="cpu")
    tp_.same_tree(consts, jconsts, exact=True)


def test_full_width_paths_and_support():
    """The collecting pass over the full xlstm_350m config: 3 super blocks
    of 7 mLSTM blocks (3 linears each) and 1 sLSTM block (4), at the
    reference's Builder paths, and the full-width qkv support (2048 ->
    6144) equal to the reference's sampler's."""
    from repro_torch.core import support
    from repro_torch.models.common import Builder
    cfg = registry.get_config(ARCH)
    specs = []
    xlstm._build_xlstm(cfg, Builder(cfg, None, torch.device("meta"), seed=0,
                                    plan=specs))
    specs = dict(specs)
    assert len(specs) == 3 * (7 * 3 + 4)
    for path in ("/supers/sb0/m0/qkv", "/supers/sb2/m6/down",
                 "/supers/sb1/s/wx", "/supers/sb2/s/ffn_down"):
        assert specs[path][0] == 0 ^ jcommon._name_hash(path)
    seed, d_in, d_out, delta, kind, cap = specs["/supers/sb0/m0/qkv"]
    assert (d_in, d_out) == (2048, 6144)
    assert specs["/supers/sb0/s/ffn_up"][1:3] == (1024, 1408)
    rows, cols, _ = support.final_support(seed, d_in, d_out, delta, kind,
                                          cap)
    want = jsupport.sample_support(seed, d_in, d_out, delta, kind)
    np.testing.assert_array_equal(rows, want[0])
    np.testing.assert_array_equal(cols, want[1])


def test_config_hashes_and_flops_match_reference():
    tp_.configs_match_reference(ARCH)


def test_refusals_match_reference():
    tp_.refusals_match_reference(ARCH)


def test_launchers_run_the_smoke_config(capsys):
    tp_.launchers_run(ARCH, capsys)
