"""Helpers shared by the tests that hold the port's zamba2 hybrid, xLSTM
and whisper families against the reference on the CPU
(``tests/test_torch_mamba2.py``, ``test_torch_xlstm.py``,
``test_torch_whisper.py``): the SMOKE configs in f32, one reference init
per arch carried over with ``from_jax_numpy``, and the engine and
trajectory drivers.

The weights: the reference's fused init (its supports and tile consts)
with every SLTrain ``B`` drawn in ±0.5, the zamba2 adapters' ``B`` in
±0.1, every leaf the init fills with ones (norm weights, ``A_log``,
``D``) at 1 ± 0.3 and every other zero leaf (biases, ``conv_b``,
``dt_bias``, the gate biases) in ±0.3, so no path rides a zero. With B
in ±1 zamba2's five smoke layers are ill-conditioned: its hidden states
reach ~100 and the reference's own eager and jitted runs disagree in the
logits' third digit; at ±0.5 they agree to the f32 tolerance below.
"""
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import registry as jregistry
from repro_torch.ckpt.convert import from_jax_numpy
from repro_torch.kernels import ops
from repro_torch.models import registry

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

# f32 logits, caches and states: sums in another order (|logits| ~5)
TOL = 1e-4
# the contiguous engine's traffic: staggered prompt lengths on 2 slots,
# as tests/test_torch_contiguous.py serves it
PROMPTS = [[5, 9, 11], [7, 3, 2, 8, 6, 14, 30], [4, 4], [9, 2, 21, 17, 3],
           [12, 19, 7, 5, 8, 2, 3, 1, 40]]


def cfgs(arch, exec_mode="fused"):
    """(reference config, port config): the SMOKE config in f32 with
    ``exec_mode``."""
    def mk(cfg):
        return dataclasses.replace(cfg, dtype="float32", param=dataclasses
                                   .replace(cfg.param, exec_mode=exec_mode))
    return (mk(jregistry.get_smoke_config(arch)),
            mk(registry.get_smoke_config(arch)))


def _fill(rng):
    def fill(path, leaf):
        keys = [str(getattr(k, "key", k)) for k in path]
        a = np.asarray(leaf)
        if keys[-1] == "B":
            lim = 0.1 if "adapter" in keys else 0.5
            return rng.uniform(-lim, lim, a.shape).astype(np.float32)
        if keys[-1] in ("v", "embed", "enc_pos", "dec_pos") or \
                not np.issubdtype(a.dtype, np.floating):
            return a
        if (a == 1).all():
            return (1 + rng.uniform(-0.3, 0.3, a.shape)).astype(np.float32)
        if (a == 0).all():
            return rng.uniform(-0.3, 0.3, a.shape).astype(np.float32)
        return a
    return fill


_WEIGHTS = {}


def weights(arch):
    """(reference params, reference consts, port params, port consts with
    Wᵀ's tile consts), cached per arch."""
    if arch not in _WEIGHTS:
        jcfg, _ = cfgs(arch)
        params, consts = jregistry.get_api(jcfg).init(
            jcfg, jax.random.PRNGKey(0), seed=0)
        np_params = jax.tree_util.tree_map_with_path(
            _fill(np.random.default_rng(1)), params)
        tp, tc = from_jax_numpy(np_params, jax.tree.map(np.asarray, consts),
                                device="cpu")
        _WEIGHTS[arch] = (jax.tree.map(jnp.asarray, np_params), consts, tp,
                          ops.add_transposed_tiles(tc))
    return _WEIGHTS[arch]


def close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def batch(cfg, toks, seed=7):
    """({tokens}, {tokens}) for the reference and the port; whisper's carry
    the same seeded frames (B, encoder_seq, d_model)."""
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "whisper":
        fr = np.random.default_rng(seed).standard_normal(
            (toks.shape[0], cfg.encoder_seq, cfg.d_model)).astype(np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(fr), torch.from_numpy(fr)
    return jb, tb


def tokens(cfg, shape, seed=3):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, shape).astype(np.int32)


def run_engine(engine, prompts=PROMPTS, new_tokens=5):
    """Each request's (uid, status, tokens, ticks), the summary and the
    dispatch counts of one drained run."""
    reqs = [engine.submit(p, max_new_tokens=new_tokens) for p in prompts]
    stats = engine.run_until_drained()
    return ([(r.uid, r.status, r.out, r.t_admit, r.t_first, r.t_done)
             for r in reqs], stats["summary"], dict(engine.dispatches))


def same_tree(got, want, tol=TOL, exact=False):
    """Every leaf of the port's tree against the reference's (paths as
    ``tree_leaves`` names them)."""
    from repro_torch.models.common import tree_leaves
    have = dict(tree_leaves(got))
    ref = dict(tree_leaves(jax.tree.map(np.asarray, want)))
    assert sorted(have) == sorted(ref)
    for path, w in ref.items():
        g = have[path].detach()
        if exact:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=path)
        else:
            np.testing.assert_allclose(g.float().numpy(), np.asarray(
                w, np.float32), atol=tol, rtol=tol, err_msg=path)


STEPS = 3


def train_fns(jcfg, cfg, opt):
    """(jitted reference global step, port global step, reference
    optimizer, port optimizer) of ``opt`` at lr 1e-3, as
    ``tests/test_torch_moe_train.py`` builds them."""
    from repro.configs.base import OptimizerConfig as JOptimizerConfig
    from repro.optim import optimizers as joptim
    from repro.train import step as jstep
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.optim import optimizers
    from repro_torch.train import step as step_lib
    kw = dict(name=opt, lr=LR, warmup_steps=1, total_steps=STEPS,
              weight_decay=0.1)
    jopt = joptim.make(JOptimizerConfig(**kw))
    topt = optimizers.make(OptimizerConfig(**kw))
    jfn = jstep.make_train_step(jcfg, jregistry.get_api(jcfg), jopt)
    tfn = step_lib.make_train_step(cfg, registry.get_api(cfg), topt)
    return jax.jit(jfn), tfn, jopt, topt


# trajectories, as chip_smoke.py gates its training pairs: step 1 runs
# from identical params, so the loss and the gradient norm agree to f32
# sums (5e-5 relative: zamba2's smoke model amplifies rounding, and the
# reference's own eager, jitted and fused runs spread by more than 1e-5
# in its step-1 gradient norm); from step 2 on Adam divides each gradient by its
# own magnitude, so an element whose gradient is near zero (or whose
# 8-bit moment code rounds the other way) can move by up to lr in either
# run, and they agree to 1e-3 (the reference's own eager and jitted runs
# differ by ~1e-4 here)
TRAJ_TOL_STEP1, TRAJ_TOL_LATER = 5e-5, 1e-3
LR = 1e-3


def trajectory_matches_reference(arch, opt, exec_mode, seq=24):
    """Losses, gradient norms and the final params of STEPS global steps
    from one init (every element within 2·lr·(STEPS - 1), all but 0.1%
    within TOL); whisper's batches carry seeded frames."""
    from repro_torch.data.pipeline import SyntheticC4
    from repro_torch.models.common import tree_leaves, tree_map
    jparams, jconsts, tparams, tconsts = weights(arch)
    jcfg, cfg = cfgs(arch, exec_mode)
    jfn, tfn, jopt, topt = train_fns(jcfg, cfg, opt)
    data = SyntheticC4(cfg.vocab_size, seq, 2, seed=0)
    jp, js = jparams, jopt.init(jparams)
    tp = tree_map(lambda t: t.clone(), tparams)
    ts = topt.init(tp)
    for i in range(STEPS):
        jb, tb = batch(cfg, data.next_batch()["tokens"], seed=10 + i)
        jp, js, jm = jfn(jp, js, jconsts, jb)
        tp, ts, tm = tfn(tp, ts, tconsts, tb)
        tol = TRAJ_TOL_STEP1 if i == 0 else TRAJ_TOL_LATER
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                       rtol=tol, err_msg=f"{key} {i}")
        assert float(tm["nonfinite"]) == float(jm["nonfinite"]) == 0.0
    want = dict(tree_leaves(jax.tree.map(np.asarray, jp)))
    off = total = 0
    for path, leaf in tree_leaves(tp):
        diff = np.abs(leaf.numpy() - want[path])
        assert diff.max() <= 2 * LR * (STEPS - 1), path
        off += int((diff > TOL + TOL * np.abs(want[path])).sum())
        total += diff.size
    assert off <= 1e-3 * total, (off, total)


def gradients_match_reference(arch, exec_mode, seq=24):
    """The loss and every gradient leaf of one train step."""
    from repro.train import step as jstep
    from repro_torch.train import step as step_lib
    jparams, jconsts, tparams, tconsts = weights(arch)
    jcfg, cfg = cfgs(arch, exec_mode)
    jb, tb = batch(cfg, tokens(cfg, (2, seq), seed=5))
    jloss = jstep.make_loss_fn(jcfg, jregistry.get_api(jcfg))
    (wl, _), wg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jparams, jconsts, jb)
    gl, _, gg = step_lib._value_and_grad(
        step_lib.make_loss_fn(cfg, registry.get_api(cfg)), tparams, tconsts,
        tb)
    np.testing.assert_allclose(float(gl), float(wl), atol=2e-5)
    same_tree(gg, wg)
    return gg


def forward_matches_reference(arch, exec_mode, seq=40):
    jparams, jconsts, tparams, tconsts = weights(arch)
    jcfg, cfg = cfgs(arch, exec_mode)
    jb, tb = batch(cfg, tokens(cfg, (2, seq)))
    japi, api = jregistry.get_api(jcfg), registry.get_api(cfg)
    want, _ = jax.jit(lambda p, c, b: japi.apply(jcfg, p, c, b))(
        jparams, jconsts, jb)
    with torch.no_grad():
        got, aux = api.apply(cfg, tparams, tconsts, tb)
    assert aux == 0.0
    close(got, want)


def engine_matches_reference(arch, exec_mode):
    """The contiguous engine's tokens, ticks and dispatches on PROMPTS."""
    from repro.serve.engine import ServeEngine as JaxEngine
    from repro_torch.serve.engine import ServeEngine
    jparams, jconsts, tparams, tconsts = weights(arch)
    jcfg, cfg = cfgs(arch)
    kw = dict(n_slots=2, max_len=32, exec_mode=exec_mode)
    want = run_engine(JaxEngine(jcfg, jparams, jconsts, **kw))
    got = run_engine(ServeEngine(cfg, tparams, tconsts, device="cpu", **kw))
    assert got == want
    assert want[2]["prefill"] == sum(map(len, PROMPTS))


def quant_engine_matches_reference(arch, tmp_path):
    """The port's calibration against the reference's on the same params
    (matrices, codes, ``max_abs_err`` within 1e-7), then exec_mode quant
    on one artifact the reference calibrated and wrote, loaded by each
    package: the same tokens."""
    from repro.ckpt import checkpoint as jckpt
    from repro.quant import calibrate as jcalibrate
    from repro.serve.engine import ServeEngine as JaxEngine
    from repro_torch.ckpt.checkpoint import load_quant_artifact
    from repro_torch.quant import calibrate
    from repro_torch.serve.engine import ServeEngine
    jparams, jconsts, tparams, tconsts = weights(arch)
    jcfg, cfg = cfgs(arch)
    qp, qc, st = jcalibrate.calibrate_model(jcfg, jparams, jconsts)
    _, tqc0, tst = calibrate.calibrate_model(cfg, tparams, tconsts)
    assert tst["n_matrices"] == st["n_matrices"] > 0
    assert tst["nnz"] == st["nnz"]
    assert abs(tst["max_abs_err"] - st["max_abs_err"]) <= 1e-7
    from repro_torch.models.common import tree_leaves
    want_c = dict(tree_leaves(jax.tree.map(np.asarray, qc)))
    for path, leaf in tree_leaves(tqc0):
        if path.endswith("qv_t") or path.endswith("qscale"):
            np.testing.assert_array_equal(leaf.numpy(), want_c[path])
    art = str(tmp_path / "artifact")
    jckpt.save_quant_artifact(art, jax.tree.map(np.asarray, qp),
                              jax.tree.map(np.asarray, qc), extra=st)
    jqp, jqc, _ = jckpt.load_quant_artifact(art)
    tqp, tqc, _ = load_quant_artifact(art, device="cpu")
    kw = dict(n_slots=2, max_len=32, exec_mode="quant")
    want = run_engine(JaxEngine(jcfg, jqp, jqc, **kw))
    assert run_engine(ServeEngine(cfg, tqp, tqc, device="cpu", **kw)) == \
        want


def configs_match_reference(arch):
    """The config hashes and the analytic 6·N·D counts, full and SMOKE."""
    from repro.analysis import roofline as jroofline
    from repro_torch.analysis import roofline
    for get, jget in ((registry.get_config, jregistry.get_config),
                      (registry.get_smoke_config,
                       jregistry.get_smoke_config)):
        cfg, jcfg = get(arch), jget(arch)
        assert cfg.hash() == jcfg.hash()
        assert roofline.param_count_active(cfg) == \
            jroofline.param_count_active(jcfg)
        assert roofline.model_flops(cfg, 2048) == \
            jroofline.model_flops(jcfg, 2048)


def refusals_match_reference(arch):
    """A paged engine and the per-layer update raise ValueError in both
    packages: the family has no prefill_step and no per-layer API."""
    import pytest
    from repro.configs.base import OptimizerConfig as JOptimizerConfig
    from repro.optim import optimizers as joptim
    from repro.serve.engine import ServeEngine as JaxEngine
    from repro.train import perlayer as jperlayer
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.optim import optimizers
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import perlayer
    jparams, jconsts, tparams, tconsts = weights(arch)
    jcfg, cfg = cfgs(arch)
    with pytest.raises(ValueError, match="no prefill_step"):
        JaxEngine(jcfg, jparams, jconsts, paged=True)
    with pytest.raises(ValueError, match="no prefill_step"):
        ServeEngine(cfg, tparams, tconsts, paged=True, device="cpu")
    with pytest.raises(ValueError, match="does not expose one"):
        jperlayer.make_perlayer_train_step(
            jcfg, jregistry.get_api(jcfg), joptim.make(JOptimizerConfig()))
    with pytest.raises(ValueError, match="does not expose one"):
        perlayer.make_perlayer_train_step(
            cfg, registry.get_api(cfg), optimizers.make(OptimizerConfig()))
    api = registry.get_api(cfg)
    assert api.prefill_step is None and api.perlayer is None


def launchers_run(arch, capsys):
    """The serve launcher on the contiguous cache (fused), refusing
    --paged; the train launcher for 2 fused steps, and for whisper its
    refusal (the Trainer's data carries no frames)."""
    import pytest
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    argv = ["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "16", "--device", "cpu", "--exec-mode", "fused"]
    with tempfile.TemporaryDirectory() as d:
        if registry.get_smoke_config(arch).family == "whisper":
            with pytest.raises(ValueError, match="frames"):
                train_launch.main(argv + ["--ckpt-dir", d])
        else:
            train_launch.main(argv + ["--ckpt-dir", d])
    sargv = ["--arch", arch, "--smoke", "--requests", "3", "--slots", "2",
             "--max-len", "32", "--new-tokens", "3", "--device", "cpu",
             "--exec-mode", "fused"]
    serve_launch.main(sargv)
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "legacy" in out
    with pytest.raises(ValueError, match="no prefill_step"):
        serve_launch.main(sargv + ["--paged"])
