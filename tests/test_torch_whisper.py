"""The port's whisper family (``repro_torch.models.whisper``) against the
reference on the CPU, on the SMOKE config of ``whisper_large_v3`` (2
encoder and 2 decoder layers, 16 frames, qkv bias, tied head) in f32, the
reference under ``jax.jit``, from one reference init carried over with
``from_jax_numpy`` (``tests/_torch_parity.py`` says how its weights are
drawn; the LayerNorms' weights and biases and the qkv biases included):

* ``encode`` on seeded frames;
* the teacher-forced forward logits with seeded frames in exec_mode
  dense, fused and sparse;
* 6 decode steps from the engine's cache (``enc_out`` zero, as the
  reference's engine leaves it) and from ``whisper_prefill_cache`` on
  seeded frames: logits and the self-attention k/v rows;
* the gradients of one train step with a frames batch in each exec mode,
  leaf for leaf, and 3-step trajectories of global AdamW (fused) and
  8-bit AdamW (dense) through the train step;
* the contiguous engine's tokens in exec_mode dense, fused, sparse and
  quant (one artifact the reference calibrated, loaded by each package;
  the port's own calibration's ``max_abs_err`` within 1e-7 of the
  reference's);
* the supports and tile consts of the port's own init bit for bit, the
  collecting pass over the full config at the reference's Builder paths
  with one full-width MLP support, the config hashes and the analytic
  6·N·D counts (the reference's: the decoder's layers only);
* the refusals: the paged engine and the per-layer update as the
  reference; the Trainer up front with a ValueError naming the missing
  frames, where the reference's dies with KeyError; the launchers.

Tolerances as ``tests/test_torch_mamba2.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_parity as tp_
from repro.core import support as jsupport
from repro.models import common as jcommon
from repro.models import whisper as jwhisper
from repro_torch.models import registry, whisper

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

ARCH = "whisper_large_v3"


def test_encode_matches_reference():
    jparams, jconsts, tparams, tconsts = tp_.weights(ARCH)
    jcfg, cfg = tp_.cfgs(ARCH)
    jb, tb = tp_.batch(cfg, tp_.tokens(cfg, (3, 1)))
    want = jax.jit(lambda p, c, f: jwhisper.encode(jcfg, p, c, f))(
        jparams, jconsts, jb["frames"])
    with torch.no_grad():
        tp_.close(whisper.encode(cfg, tparams, tconsts, tb["frames"]), want)


@pytest.mark.parametrize("exec_mode", ["dense", "fused", "sparse"])
def test_forward_matches_reference(exec_mode):
    tp_.forward_matches_reference(ARCH, exec_mode)


@pytest.mark.parametrize("prefilled", [False, True])
def test_decode_matches_reference(prefilled):
    """6 decode steps: logits, the self k/v rows and enc_out after each,
    from the engine's zero enc_out or from the encoder's on seeded
    frames."""
    jparams, jconsts, tparams, tconsts = tp_.weights(ARCH)
    jcfg, cfg = tp_.cfgs(ARCH, "fused")
    if prefilled:
        jb, tb = tp_.batch(cfg, tp_.tokens(cfg, (3, 1)))
        jcache = jax.jit(lambda p, c, f: jwhisper.whisper_prefill_cache(
            jcfg, p, c, f, 3, 16))(jparams, jconsts, jb["frames"])
        with torch.no_grad():
            cache = whisper.whisper_prefill_cache(
                cfg, tparams, tconsts, tb["frames"], 3, 16, device="cpu")
        tp_.same_tree(cache, jcache)
        assert float(cache["enc_out"].abs().max()) > 0
    else:
        jcache = jwhisper.init_whisper_cache(jcfg, 3, 16)
        cache = whisper.init_whisper_cache(cfg, 3, 16, device="cpu")
        tp_.same_tree(cache, jcache, exact=True)
    step = jax.jit(lambda p, c, t, k, i: jwhisper.whisper_decode_step(
        jcfg, p, c, t, k, i))
    for i in range(6):
        toks = tp_.tokens(cfg, (3, 1), seed=i)
        wl, jcache = step(jparams, jconsts, toks, jcache, i)
        with torch.no_grad():
            gl, cache = whisper.whisper_decode_step(
                cfg, tparams, tconsts, torch.from_numpy(toks), cache, i)
        tp_.close(gl, wl)
        tp_.same_tree(cache, jcache)


@pytest.mark.parametrize("exec_mode", ["dense", "fused", "sparse"])
def test_train_step_gradients_match_reference(exec_mode):
    """The loss and every gradient leaf of one step with a frames batch:
    the encoder's (through the cross-attention's k/v), the decoder's, the
    LayerNorms' weights and biases, the qkv biases, both position
    tables."""
    grads = tp_.gradients_match_reference(ARCH, exec_mode)
    assert float(grads["enc"]["attn"]["wq"]["bias"].abs().max()) > 0
    assert float(grads["enc_pos"].abs().max()) > 0


@pytest.mark.parametrize("opt, exec_mode", [("adamw", "fused"),
                                            ("adam8bit", "dense")])
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
    _, consts = whisper.init_whisper(cfg, 0, device="cpu")
    tp_.same_tree(consts, jconsts, exact=True)


def test_full_width_paths_and_support():
    """The collecting pass over the full whisper_large_v3 config: 32
    encoder blocks of 6 linears and 32 decoder blocks of 10 (the
    cross-attention's 4 included) at the reference's Builder paths, and
    the full-width MLP support (1280 -> 5120) equal to the reference's
    sampler's."""
    from repro_torch.core import support
    from repro_torch.models.common import Builder
    cfg = registry.get_config(ARCH)
    specs = []
    whisper._build_whisper(cfg, Builder(cfg, None, torch.device("meta"),
                                        seed=0, plan=specs))
    specs = dict(specs)
    assert len(specs) == 32 * 6 + 32 * 10
    for path in ("/enc/e0/attn/wq", "/enc/e31/mlp/down", "/dec/d0/xattn/wk",
                 "/dec/d31/mlp/up"):
        assert specs[path][0] == 0 ^ jcommon._name_hash(path)
    seed, d_in, d_out, delta, kind, cap = specs["/enc/e0/mlp/up"]
    assert (d_in, d_out) == (1280, 5120)
    rows, cols, _ = support.final_support(seed, d_in, d_out, delta, kind,
                                          cap)
    want = jsupport.sample_support(seed, d_in, d_out, delta, kind)
    np.testing.assert_array_equal(rows, want[0])
    np.testing.assert_array_equal(cols, want[1])


def test_trainer_refuses_whisper_naming_frames(tmp_path):
    """The reference's Trainer feeds SyntheticC4 batches and dies with
    KeyError: 'frames' at its first step; the port's refuses at
    construction."""
    from repro.configs.base import TrainConfig as JTrainConfig
    from repro.train.trainer import Trainer as JTrainer
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.trainer import Trainer
    jcfg, cfg = tp_.cfgs(ARCH)
    kw = dict(seq_len=16, global_batch=2, steps=1, ckpt_every=0)
    jtc = JTrainConfig(model=jcfg, ckpt_dir=str(tmp_path / "j"), **kw)
    with pytest.raises(KeyError, match="frames"):
        JTrainer(jtc, log_fn=lambda *a: None).run()
    tc = TrainConfig(model=cfg, ckpt_dir=str(tmp_path / "t"), **kw)
    with pytest.raises(ValueError, match="frames"):
        Trainer(tc, device="cpu", log_fn=lambda *a: None)
    ok = dataclasses.replace(tc, model=tp_.cfgs("xlstm_350m")[1])
    Trainer(ok, device="cpu", log_fn=lambda *a: None)


def test_config_hashes_and_flops_match_reference():
    tp_.configs_match_reference(ARCH)


def test_refusals_match_reference():
    tp_.refusals_match_reference(ARCH)


def test_launchers_run_the_smoke_config(capsys):
    tp_.launchers_run(ARCH, capsys)
