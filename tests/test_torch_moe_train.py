"""Training the MoE family in the port against the reference on the CPU
(the SMOKE configs of ``deepseek_moe_16b`` and ``qwen3_moe_235b``, f32,
the reference under ``jax.jit``): 3-step trajectories of global AdamW in
exec_mode dense and of per-layer 8-bit AdamW in exec_mode fused (the
grouped kernels' plain versions; the sweep over deepseek's dense prefix,
each MoE block's backward taking the aux loss's cotangent), per-layer
against global with ``grad_accum`` 1 and 2 (as the reference's
``tests/test_perlayer.py`` holds its own), checkpoints both ways bit for
bit, and both launchers on both smoke configs.

Tolerances, as ``tests/test_torch_families.py``: losses 2e-5 absolute
(3e-5 per-layer against global, the reference's own bound), gradient
norms 1e-5 relative (2e-5 per-layer against global), parameters 1e-4
absolute after 3 steps (Adam moves an element by at most lr = 1e-3 a
step); the aux loss 1e-6.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JaxCkpt
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.models import registry as jregistry
from repro.optim import optimizers as joptim
from repro.train import perlayer as jperlayer
from repro.train import step as jstep
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt.convert import from_jax_numpy
from repro_torch.configs.base import OptimizerConfig
from repro_torch.data.pipeline import SyntheticC4
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import registry
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import optimizers
from repro_torch.train import perlayer
from repro_torch.train import step as step_lib

ARCHS = ("deepseek_moe_16b", "qwen3_moe_235b")
STEPS = 3


def _cfgs(arch, exec_mode="fused"):
    def mk(cfg):
        return dataclasses.replace(
            cfg, dtype="float32",
            param=dataclasses.replace(cfg.param, exec_mode=exec_mode))
    return (mk(jregistry.get_smoke_config(arch)),
            mk(registry.get_smoke_config(arch)))


_WEIGHTS = {}


def _weights(arch):
    """The reference's own fused init of ``arch`` (B = 0, as the other
    trajectory tests start), as jax arrays and as the port's tensors."""
    if arch not in _WEIGHTS:
        jcfg, _ = _cfgs(arch)
        params, consts = jregistry.get_api(jcfg).init(
            jcfg, jax.random.PRNGKey(0), seed=0)
        np_params = jax.tree.map(np.asarray, params)
        tp, tc = from_jax_numpy(np_params, jax.tree.map(np.asarray, consts),
                                device="cpu")
        _WEIGHTS[arch] = (params, consts, tp, ops.add_transposed_tiles(tc))
    return _WEIGHTS[arch]


def _okw(name):
    return dict(name=name, lr=1e-3, warmup_steps=1, total_steps=STEPS,
                weight_decay=0.1)


def _fns(jcfg, cfg, mode, opt, grad_accum=1):
    jopt = joptim.make(JOptimizerConfig(**_okw(opt)))
    topt = optimizers.make(OptimizerConfig(**_okw(opt)))
    japi, api = jregistry.get_api(jcfg), registry.get_api(cfg)
    if mode == "global":
        jfn = jstep.make_train_step(jcfg, japi, jopt, grad_accum=grad_accum)
        tfn = step_lib.make_train_step(cfg, api, topt, grad_accum=grad_accum)
    else:
        jfn = jperlayer.make_perlayer_train_step(jcfg, japi, jopt,
                                                 grad_accum=grad_accum)
        tfn = perlayer.make_perlayer_train_step(cfg, api, topt,
                                                grad_accum=grad_accum)
    return jax.jit(jfn), tfn, jopt, topt


# (update_mode, optimizer, exec_mode)
TRAJECTORIES = [("global", "adamw", "dense"),
                ("per_layer", "adam8bit", "fused")]


@pytest.mark.parametrize("mode, opt, exec_mode", TRAJECTORIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_trajectories_match_reference(arch, mode, opt, exec_mode):
    """Losses (the aux term included), aux, gradient norms and the final
    params of 3 steps."""
    jparams, jconsts, tparams, tconsts = _weights(arch)
    jcfg, cfg = _cfgs(arch, exec_mode)
    jfn, tfn, jopt, topt = _fns(jcfg, cfg, mode, opt)
    data = SyntheticC4(cfg.vocab_size, 24, 2, seed=0)
    jp, js = jparams, jopt.init(jparams)
    tp = tree_map(lambda t: t.clone(), tparams)
    ts = topt.init(tp)
    for _ in range(STEPS):
        toks = data.next_batch()["tokens"]
        jp, js, jm = jfn(jp, js, jconsts, {"tokens": jnp.asarray(toks)})
        tp, ts, tm = tfn(tp, ts, tconsts, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=2e-5)
        np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                                   atol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert float(tm["nonfinite"]) == float(jm["nonfinite"]) == 0.0
        assert float(tm["aux"]) > 0.5
    want = dict(tree_leaves(jax.tree.map(np.asarray, jp)))
    for path, leaf in tree_leaves(tp):
        np.testing.assert_allclose(leaf.numpy(), want[path], atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("grad_accum", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_perlayer_matches_global_and_reference(arch, grad_accum):
    """Per-layer AdamW against the port's global step (and the reference's
    per-layer step) from one init, through the dense prefix and the
    routers' aux cotangents, with 1 or 2 microbatches."""
    jparams, jconsts, tparams, tconsts = _weights(arch)
    jcfg, cfg = _cfgs(arch, "fused")
    jfn_p, tfn_p, jopt, topt = _fns(jcfg, cfg, "per_layer", "adamw",
                                    grad_accum)
    _, tfn_g, _, _ = _fns(jcfg, cfg, "global", "adamw", grad_accum)
    data = SyntheticC4(cfg.vocab_size, 16, 4, seed=3)
    jp, js = jparams, jopt.init(jparams)
    tp = tree_map(lambda t: t.clone(), tparams)
    ts = topt.init(tp)
    gp = tree_map(lambda t: t.clone(), tparams)
    gs = topt.init(gp)
    for _ in range(2):
        toks = data.next_batch()["tokens"]
        jp, js, jm = jfn_p(jp, js, jconsts, {"tokens": jnp.asarray(toks)})
        tp, ts, tm = tfn_p(tp, ts, tconsts, {"tokens": torch.from_numpy(toks)})
        gp, gs, gm = tfn_g(gp, gs, tconsts, {"tokens": torch.from_numpy(toks)})
        for m in (gm, jm):
            np.testing.assert_allclose(float(tm["loss"]), float(m["loss"]),
                                       atol=3e-5)
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(m["grad_norm"]), rtol=2e-5)
            np.testing.assert_allclose(float(tm["aux"]), float(m["aux"]),
                                       atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_crosses_packages_bit_for_bit(arch):
    """The reference's params and 8-bit AdamW state (the expert stacks,
    the router, the shared experts, the dense prefix, QK-norm) saved by
    the reference load into the port leaf for leaf, and the port's save
    loads back into the reference."""
    jcfg, cfg = _cfgs(arch)
    jparams, _, tparams, _ = _weights(arch)
    jopt = joptim.make(JOptimizerConfig(name="adam8bit"))
    jtree = {"params": jparams, "opt_state": jopt.init(jparams)}
    ttree = {"params": tparams, "opt_state": optimizers.make(
        OptimizerConfig(name="adam8bit")).init(tparams)}
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        JaxCkpt(d1).save(1, jtree, config_hash=cfg.hash())
        got, man = ckpt.CheckpointManager(d1).restore(
            ttree, config_hash=cfg.hash())
        assert man["step"] == 1
        want = {p: np.asarray(v) for p, v in tree_leaves(
            jax.tree.map(np.asarray, jtree))}
        have = {p: v.numpy() for p, v in tree_leaves(got)}
        assert sorted(have) == sorted(want)
        assert any("/moe/experts/" in p for p in have)
        for p in want:
            np.testing.assert_array_equal(have[p], want[p])
        ckpt.CheckpointManager(d2).save(2, got, config_hash=cfg.hash())
        back, _ = JaxCkpt(d2).restore(jtree, config_hash=cfg.hash())
        for p, v in tree_leaves(jax.tree.map(np.asarray, back)):
            np.testing.assert_array_equal(v, want[p])


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_the_smoke_configs(arch, capsys):
    """The train launcher (fused, per-layer 8-bit) and the serve launcher
    (paged, prefix sharing, fused) on each MoE smoke config."""
    with tempfile.TemporaryDirectory() as d:
        train_launch.main(["--arch", arch, "--smoke", "--steps", "2",
                           "--batch", "2", "--seq", "16", "--device", "cpu",
                           "--exec-mode", "fused", "--optimizer", "adam8bit",
                           "--update-mode", "per_layer", "--ckpt-dir", d])
    serve_launch.main(["--arch", arch, "--smoke", "--paged",
                       "--prefix-sharing", "--exec-mode", "fused",
                       "--requests", "3", "--slots", "2", "--max-len", "48",
                       "--new-tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step 2" in out or "step=2" in out, out[-500:]
