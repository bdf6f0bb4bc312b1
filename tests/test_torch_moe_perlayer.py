"""Training the MoE family in the port against the reference on the CPU,
from ``tests/test_torch_moe_train.py``'s helpers (the SMOKE configs of
``deepseek_moe_16b`` and ``qwen3_moe_235b`` from the reference's own
init, f32, the reference under ``jax.jit``): per-layer against global
with ``grad_accum`` 1 and 2 (as the reference's ``tests/test_perlayer.py``
holds its own), checkpoints both ways bit for bit, and both launchers on
both smoke configs.

Tolerances, as ``tests/test_torch_moe_train.py``: losses 3e-5 absolute
per-layer against global (the reference's own bound), gradient norms
2e-5 relative, the aux loss 1e-6.
"""
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JaxCkpt
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.optim import optimizers as joptim
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs.base import OptimizerConfig
from repro_torch.data.pipeline import SyntheticC4
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import optimizers
from test_torch_moe_train import ARCHS, _cfgs, _fns, _weights

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)


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
