"""The port's zamba2 hybrid family (``repro_torch.models.mamba2``) against
the reference on the CPU, on the SMOKE config of ``zamba2_7b`` (5 layers:
2 super blocks of 2 Mamba blocks, each followed by the shared attention +
MLP block with its own adapter, and a tail of 1) in f32, the reference
under ``jax.jit``, from one reference init carried over with
``from_jax_numpy`` (``tests/_torch_parity.py`` says how its weights are
drawn):

* ``ssd`` and ``ssd_step`` on seeded inputs, sequences a multiple of
  ``chunk`` and not; the causal conv in both modes;
* the forward logits in exec_mode dense, fused and sparse (the reference
  in the same mode: fused runs its Pallas kernels in interpret mode);
* 6 decode steps on the contiguous cache: logits and every cache leaf;
* the gradients of one train step in each exec mode, leaf for leaf (the
  adapters' included: their B is drawn non-zero), and 3-step
  trajectories of global AdamW (dense) and 8-bit AdamW (fused);
* the contiguous engine's tokens in exec_mode dense, fused, sparse and
  quant (one artifact the reference calibrated, loaded by each package;
  the port's own calibration's ``max_abs_err`` within 1e-7 of the
  reference's);
* the supports and tile consts of the port's own init bit for bit, the
  collecting pass over the full config at the reference's Builder paths
  with one full-width ``in_proj`` support, the config hashes and the
  analytic 6·N·D counts;
* the refusals the reference makes (the paged engine, the per-layer
  update) and the launchers.

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
from repro.models import mamba2 as jmamba2
from repro_torch.models import mamba2, registry

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

ARCH = "zamba2_7b"


@pytest.mark.parametrize("s, chunk", [(64, 32), (40, 16), (7, 32)])
def test_ssd_and_step_match_reference(s, chunk):
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 4, 8, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = -np.abs(rng.standard_normal((b, s, h))).astype(np.float32) * 0.5
    B = rng.standard_normal((b, s, n)).astype(np.float32)
    C = rng.standard_normal((b, s, n)).astype(np.float32)
    wy, wf = jax.jit(lambda *t: jmamba2.ssd(*t, chunk))(x, a, B, C)
    gy, gf = mamba2.ssd(*map(torch.from_numpy, (x, a, B, C)), chunk)
    tp_.close(gy, wy)
    tp_.close(gf, wf)
    # the recurrence from the scan's final state, one token at a time
    st, jst = gf, wf
    step = jax.jit(jmamba2.ssd_step)
    for t in range(3):
        xt, at = rng.standard_normal((b, h, p)), -np.abs(rng.standard_normal(
            (b, h)))
        Bt, Ct = rng.standard_normal((b, n)), rng.standard_normal((b, n))
        args = [v.astype(np.float32) for v in (xt, at, Bt, Ct)]
        wy_t, jst = step(jst, *args)
        gy_t, st = mamba2.ssd_step(st, *map(torch.from_numpy, args))
        tp_.close(gy_t, wy_t)
        tp_.close(st, jst)


def test_conv1d_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    state = rng.standard_normal((2, 3, 24)).astype(np.float32)
    wy, _ = jax.jit(jmamba2._conv1d)(x, w, bias)
    gy, none = mamba2._conv1d(*map(torch.from_numpy, (x, w, bias)))
    tp_.close(gy, wy)
    assert none is None
    wy, ws = jax.jit(jmamba2._conv1d)(x[:, :1], w, bias, state)
    gy, gs = mamba2._conv1d(*map(torch.from_numpy, (x[:, :1], w, bias,
                                                    state)))
    tp_.close(gy, wy)
    tp_.close(gs, ws)


@pytest.mark.parametrize("exec_mode", ["dense", "fused", "sparse"])
def test_forward_matches_reference(exec_mode):
    tp_.forward_matches_reference(ARCH, exec_mode)


def test_decode_matches_reference():
    """6 decode steps at a shared index on the contiguous cache: logits and
    every leaf of the cache (conv and ssm states, the shared block's k/v
    rows) after each."""
    jparams, jconsts, tparams, tconsts = tp_.weights(ARCH)
    jcfg, cfg = tp_.cfgs(ARCH, "fused")
    jcache = jmamba2.init_hybrid_cache(jcfg, 3, 16)
    cache = mamba2.init_hybrid_cache(cfg, 3, 16, device="cpu")
    tp_.same_tree(cache, jcache, exact=True)
    step = jax.jit(lambda p, c, t, k, i: jmamba2.hybrid_decode_step(
        jcfg, p, c, t, k, i))
    for i in range(6):
        toks = tp_.tokens(cfg, (3, 1), seed=i)
        wl, jcache = step(jparams, jconsts, toks, jcache, i)
        with torch.no_grad():
            gl, cache = mamba2.hybrid_decode_step(
                cfg, tparams, tconsts, torch.from_numpy(toks), cache, i)
        tp_.close(gl, wl)
        tp_.same_tree(cache, jcache)


@pytest.mark.parametrize("exec_mode", ["dense", "fused", "sparse"])
def test_train_step_gradients_match_reference(exec_mode):
    """The loss and every gradient leaf of one step: the Mamba blocks'
    factors, conv, A_log, dt_bias, D; the shared block's, summed over its
    two invocations; each super block's adapter B and A."""
    grads = tp_.gradients_match_reference(ARCH, exec_mode)
    assert float(grads["supers"]["adapter"]["B"].abs().min()) > 0


@pytest.mark.parametrize("opt, exec_mode", [("adamw", "dense"),
                                            ("adam8bit", "fused")])
def test_trajectories_match_reference(opt, exec_mode):
    tp_.trajectory_matches_reference(ARCH, opt, exec_mode)


@pytest.mark.parametrize("exec_mode", ["dense", "fused", "sparse"])
def test_contiguous_engine_matches_reference(exec_mode):
    tp_.engine_matches_reference(ARCH, exec_mode)


def test_quant_engine_matches_reference(tmp_path):
    tp_.quant_engine_matches_reference(ARCH, tmp_path)


def test_supports_match_reference_bit_for_bit():
    """The port's own init (exec_mode fused) against the reference's:
    every const (cols, rows_t, cols_t, perm) of every linear, the shared
    block's and the tail's included, bit for bit."""
    _, jconsts, _, _ = tp_.weights(ARCH)
    jcfg, cfg = tp_.cfgs(ARCH)
    _, consts = mamba2.init_hybrid(cfg, 0, device="cpu")
    tp_.same_tree(consts, jconsts, exact=True)


def test_full_width_paths_and_support():
    """The collecting pass over the full zamba2_7b config: the reference's
    Builder paths (81 Mamba blocks of 2 linears and the shared block's 8),
    each seeded with crc32(path), and the full-width in_proj support (3584
    -> 14576) equal to the reference's sampler's."""
    from repro_torch.core import support
    from repro_torch.models.common import Builder
    cfg = registry.get_config(ARCH)
    specs = []
    mamba2._build_hybrid(cfg, Builder(cfg, None, torch.device("meta"),
                                      seed=0, plan=specs))
    specs = dict(specs)
    assert len(specs) == 2 * 81 + 8
    for path in ("/supers/s0/m0/in_proj", "/supers/s12/m5/out_proj",
                 "/tail/m0/in_proj", "/shared_attn/in_proj",
                 "/shared_attn/attn/wq", "/shared_attn/mlp/down"):
        assert specs[path][0] == 0 ^ jcommon._name_hash(path)
    seed, d_in, d_out, delta, kind, cap = specs["/supers/s0/m0/in_proj"]
    assert (d_in, d_out) == (3584, 14576)
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
