"""Training the MoE family in the port against the reference on the CPU
(the SMOKE configs of ``deepseek_moe_16b`` and ``qwen3_moe_235b``, f32,
the reference under ``jax.jit``): 3-step trajectories of global AdamW in
exec_mode dense and of per-layer 8-bit AdamW in exec_mode fused (the
grouped kernels' plain versions; the sweep over deepseek's dense prefix,
each MoE block's backward taking the aux loss's cotangent).
``tests/test_torch_moe_perlayer.py`` holds per-layer against global, the
checkpoints and the launchers, from this file's helpers (two files, so
that pytest-xdist's ``--dist loadfile`` can run them side by side).

Tolerances, as ``tests/test_torch_families.py``: losses 2e-5 absolute
(3e-5 per-layer against global, the reference's own bound), gradient
norms 1e-5 relative (2e-5 per-layer against global), parameters 1e-4
absolute after 3 steps (Adam moves an element by at most lr = 1e-3 a
step); the aux loss 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.models import registry as jregistry
from repro.optim import optimizers as joptim
from repro.train import perlayer as jperlayer
from repro.train import step as jstep
from repro_torch.ckpt.convert import from_jax_numpy
from repro_torch.configs.base import OptimizerConfig
from repro_torch.data.pipeline import SyntheticC4
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import optimizers
from repro_torch.train import perlayer
from repro_torch.train import step as step_lib

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

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
