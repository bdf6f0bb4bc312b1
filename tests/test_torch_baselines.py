"""The paper's baselines in the port against the reference on the CPU:
low rank (``core/lowrank.py``), ReLoRA with its merge (``core/relora.py``,
``train/trainer.py``) and GaLore-AdamW (``optim/optimizers.py``), on the
``llama_60m`` smoke config (2 layers, d 64, rank 8) in f32, the weights
carried over from the reference's init with ``from_jax_numpy``:

* ``lr_matmul``/``rl_matmul`` and the model's logits in modes lowrank
  and relora;
* ``relora.merge``: W0 and B as the reference's (bit for bit in bf16; in
  f32 B·A's sum order may differ in the last bit), A redrawn within
  ±sqrt(6/d_in), the layer's function preserved;
* 3-step global AdamW trajectories in modes lowrank and relora; ReLoRA
  merges after step 2 (the reference's post-merge A carried over, since
  ``jax.random``'s bits are not reproduced), with B's and A's moments
  zeroed and W0's kept;
* GaLore's ``update_slice`` at a refresh step and at a non-refresh step
  from one carried-in state, and 3-step GaLore trajectories (global in
  modes dense and lowrank, per-layer in lowrank; per-layer dense is a
  case of ``tests/test_torch_perlayer.py``);
* the optimizer state trees (paths, shapes, dtypes) of every mode and
  optimizer, which pin the reference's two quirks the port keeps: GaLore
  projects only ``lm_head`` (layer leaves are stacked, so 3-D), and
  ReLoRA's W0 is trained, with moments; ReLoRA with 8-bit AdamW, which
  crashes the reference at its first merge, is refused;
* ReLoRA and GaLore checkpoints across the two packages, bit for bit;
* the launcher's ``--mode lowrank|relora`` and ``--optimizer
  galore_adamw`` on the CPU.

Tolerances, as the training slice's: f32 values computed with the same
operations in another order agree to rtol 1e-5 (atol 1e-6 at their
scale), bf16 to 2e-2; logits, after two layers of such sums, to
atol = rtol = 1e-4 as the serving slice's; a trajectory's loss and gradient norm to 1e-5
relative at step 1 and 1e-3 after it (Adam turns last-bit gradient
differences into update differences of up to lr per element), the
step-1 gradient norm to 1e-4 as in ``tests/test_torch_train.py``; params
after 3 steps to 1e-4 absolute (lr 1e-3). GaLore's P comes from an SVD
whose column signs are the solver's choice: P·Pᵀ is compared, to 1e-5.
"""
import dataclasses
import math
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JaxCkpt
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.core import lowrank as jlowrank
from repro.core import relora as jrelora
from repro.models import registry as jregistry
from repro.optim import optimizers as joptim
from repro.train import perlayer as jperlayer
from repro.train import step as jstep
from repro.train import trainer as jtrainer
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt.convert import from_jax_numpy, opt_state_from_jax_numpy
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.core import lowrank, relora
from repro_torch.data.pipeline import SyntheticC4
from repro_torch.models import common, registry
from repro_torch.models.common import tree_map
from repro_torch.optim import optimizers
from repro_torch.train import perlayer
from repro_torch.train import step as step_lib
from repro_torch.train import trainer as trainer_lib

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
STEPS = 3
GALORE_RANK = 8
TOL_STEP1, TOL_LATER = 1e-5, 1e-3
# random B and A scale every layer's gradient by alpha/r: the norm of the
# sum of squares, summed in another order, keeps 1e-4 (as
# tests/test_torch_train.py holds gradient norms)
GNORM_TOL_STEP1 = 1e-4


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, dtype, scale=1.0):
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol * scale if dtype != "float32"
                               else 1e-6 * scale)


def _leaves(tree):
    return list(common.tree_leaves(tree))


def _jleaves(tree):
    """(``/``-joined path, leaf) pairs of a reference pytree."""
    return [("/".join(str(getattr(k, "key", k)) for k in path), leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _cfgs(mode, dtype="float32", **param):
    def mk(cfg):
        return dataclasses.replace(cfg, dtype=dtype, param=dataclasses.replace(
            cfg.param, mode=mode, exec_mode="dense", **param))
    return (mk(jregistry.get_smoke_config("llama_60m")),
            mk(registry.get_smoke_config("llama_60m")))


def _carried(jcfg, seed=42):
    """The reference's init and the port's copy of it."""
    params, consts = jregistry.get_api(jcfg).init(
        jcfg, jax.random.PRNGKey(seed), seed=seed)
    tp, tc = from_jax_numpy(jax.tree.map(np.asarray, params),
                            jax.tree.map(np.asarray, consts), device="cpu")
    return params, consts, tp, tc


def _okw(name="adamw", **kw):
    return dict(name=name, lr=1e-3, warmup_steps=2, total_steps=STEPS,
                galore_rank=GALORE_RANK, **kw)


def _batches(vocab, n=STEPS, seed=0):
    data = SyntheticC4(vocab, 32, 4, seed=seed)
    return [data.next_batch()["tokens"] for _ in range(n)]


def _assert_rows(got, want):
    """(loss, grad_norm) rows: the loss to 1e-5 relative and the norm to
    1e-4 at step 1, both to 1e-3 after."""
    for i, (g, w) in enumerate(zip(got, want)):
        tols = (TOL_STEP1, GNORM_TOL_STEP1) if i == 0 else (TOL_LATER,) * 2
        for what, a, b, tol in zip(("loss", "grad_norm"), g, w, tols):
            np.testing.assert_allclose(a, b, rtol=tol, atol=0,
                                       err_msg=f"step {i + 1} {what}")


def _assert_params(tp, jp, atol=1e-4):
    tl, jl = _leaves(tp), _jleaves(jp)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, a), (_, b) in zip(tl, jl):
        np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                   rtol=0, atol=atol, err_msg=path)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _factors(rng, d_in, d_out, r, with_w0):
    p = {"B": rng.uniform(-1, 1, (d_in, r)).astype(np.float32),
         "A": rng.uniform(-0.3, 0.3, (r, d_out)).astype(np.float32)}
    if with_w0:
        p["W0"] = (rng.standard_normal((d_in, d_out)) * 0.1).astype(
            np.float32)
    return p


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["lowrank", "relora"])
def test_linear_matches_reference(mode, dtype):
    """``lr_matmul`` / ``rl_matmul`` on (batch, seq, d_in) inputs, at a
    scale that does not round exactly to bf16."""
    rng = np.random.default_rng(4)
    d_in, d_out, r, scale = 96, 160, 8, 32.0 / 6.0
    x = rng.standard_normal((2, 5, d_in)).astype(np.float32)
    p = _factors(rng, d_in, d_out, r, mode == "relora")
    jfn = {"lowrank": jlowrank.lr_matmul, "relora": jrelora.rl_matmul}[mode]
    tfn = {"lowrank": lowrank.lr_matmul, "relora": relora.rl_matmul}[mode]
    j = lambda a: jnp.asarray(a).astype(JDT[dtype])
    t = lambda a: torch.from_numpy(a).to(TDT[dtype])
    want = jax.jit(lambda x_, p_: jfn(x_, p_, scale))(
        j(x), {k: j(v) for k, v in p.items()})
    got = tfn(t(x), {k: t(v) for k, v in p.items()}, scale)
    assert got.dtype == TDT[dtype]
    want = np.asarray(want.astype(jnp.float32))
    _close(_np(got), want, dtype, scale=float(np.abs(want).max()))


@pytest.mark.parametrize("mode", ["lowrank", "relora"])
def test_logits_match_reference(mode):
    jcfg, cfg = _cfgs(mode)
    jp, jc, tp, tc = _carried(jcfg)
    if mode == "relora":
        # B = 0 at init would leave the adaptor out of the forward
        rng = np.random.default_rng(1)
        def fill(path, leaf):
            if path[-1].key != "B":
                return leaf
            return jnp.asarray(rng.uniform(-0.5, 0.5, leaf.shape),
                               leaf.dtype)
        jp = jax.tree_util.tree_map_with_path(fill, jp)
        tp = from_jax_numpy(jax.tree.map(np.asarray, jp), {}, device="cpu")[0]
    toks = _batches(cfg.vocab_size, n=1)[0]
    want, _ = jax.jit(lambda p, c, t: jregistry.get_api(jcfg).apply(
        jcfg, p, c, {"tokens": t}))(jp, jc, jnp.asarray(toks))
    got, _ = registry.get_api(cfg).apply(cfg, tp, tc,
                                         {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_init_laws_and_trees():
    """The port's own init gives the reference's leaves, shapes and
    dtypes in both modes, with the reference's laws: lowrank B and A
    U(±sqrt(6/d_in)); ReLoRA B = 0, A U(±sqrt(6/d_in)), W0 of std
    sqrt(2/(d_in + d_out))."""
    for mode in ("lowrank", "relora"):
        jcfg, cfg = _cfgs(mode, dtype="bfloat16")
        jp, _ = jregistry.get_api(jcfg).init(jcfg, jax.random.PRNGKey(0),
                                            seed=0)
        tp, _ = registry.get_api(cfg).init(cfg, seed=0, device="cpu")
        want = [(p, tuple(x.shape), str(x.dtype)) for p, x in _jleaves(jp)]
        got = [(p, tuple(x.shape), str(x.dtype).split(".")[-1])
               for p, x in _leaves(tp)]
        assert got == want
        wq = tp["layers"]["k0"]["attn"]["wq"]
        d_in, d_out = wq["A"].shape[-1], wq["B"].shape[-2]
        lim = math.sqrt(6.0 / d_in)
        # drawn in f32, then rounded to bf16 (as the reference does)
        lim = lowrank.in_dtype(lim, torch.bfloat16)
        assert float(wq["A"].float().abs().max()) <= lim
        if mode == "lowrank":
            assert float(wq["B"].float().abs().max()) <= lim
            assert float(wq["B"].float().std()) > 0.3 * lim
        else:
            assert not wq["B"].any()
            std = math.sqrt(2.0 / (d_in + d_out))
            assert abs(float(wq["W0"].float().std()) / std - 1) < 0.1


# ---------------------------------------------------------------------------
# The merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relora_merge_matches_reference(dtype):
    """Stacked (2, d_in, d_out) leaves, as the trainer merges them."""
    rng = np.random.default_rng(5)
    d_in, d_out, r, scale = 64, 160, 8, 4.0
    p = {"W0": (rng.standard_normal((2, d_in, d_out)) * 0.1).astype(
            np.float32),
         "B": rng.uniform(-1, 1, (2, d_in, r)).astype(np.float32),
         "A": rng.uniform(-0.3, 0.3, (2, r, d_out)).astype(np.float32)}
    jp = {k: jnp.asarray(v).astype(JDT[dtype]) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(TDT[dtype]) for k, v in p.items()}
    want = jax.jit(lambda p_: jrelora.merge(p_, jax.random.PRNGKey(3),
                                            scale))(jp)
    got = relora.merge(tp, torch.Generator().manual_seed(3), scale)
    w0 = np.asarray(want["W0"].astype(jnp.float32))
    if dtype == "bfloat16":
        assert np.array_equal(_np(got["W0"]), w0)
    else:
        _close(_np(got["W0"]), w0, dtype, scale=float(np.abs(w0).max()))
    assert not got["B"].any() and not np.asarray(want["B"]).any()
    for k in ("W0", "B", "A"):
        assert got[k].dtype == TDT[dtype] and got[k].shape == tp[k].shape
    lim = lowrank.in_dtype(math.sqrt(6.0 / d_in), TDT[dtype])
    assert float(got["A"].float().abs().max()) <= lim
    assert not torch.equal(got["A"][0], got["A"][1])
    # the layer's function is preserved (tests/test_optim.py's check), up
    # to the roundings of the merged W0
    x = torch.from_numpy(rng.standard_normal((5, d_in)).astype(
        np.float32)).to(TDT[dtype])
    for i in range(2):
        y1 = relora.rl_matmul(x, {k: v[i] for k, v in tp.items()}, scale)
        y2 = relora.rl_matmul(x, {k: v[i] for k, v in got.items()}, scale)
        _close(_np(y2), _np(y1), dtype, scale=float(y1.float().abs().max()))


# ---------------------------------------------------------------------------
# Trajectories (global AdamW)
# ---------------------------------------------------------------------------

def _step_fns(jcfg, cfg, okw, update_mode="global"):
    jopt = joptim.make(JOptimizerConfig(**okw))
    topt = optimizers.make(OptimizerConfig(**okw))
    if update_mode == "global":
        jfn = jstep.make_train_step(jcfg, jregistry.get_api(jcfg), jopt)
        tfn = step_lib.make_train_step(cfg, registry.get_api(cfg), topt)
    else:
        jfn = jperlayer.make_perlayer_train_step(
            jcfg, jregistry.get_api(jcfg), jopt)
        tfn = perlayer.make_perlayer_train_step(cfg, registry.get_api(cfg),
                                                topt)
    return jopt, topt, jax.jit(jfn), tfn


def _step(jfn, tfn, run, toks):
    """One step of both packages; appends (loss, grad_norm) rows."""
    jp, js, jc, tp, ts, tc, jrows, trows = run
    jp, js, jm = jfn(jp, js, jc, {"tokens": jnp.asarray(toks)})
    tp, ts, tm = tfn(tp, ts, tc, {"tokens": torch.from_numpy(toks)})
    assert float(tm["nonfinite"]) == 0.0 == float(jm["nonfinite"])
    jrows.append((float(jm["loss"]), float(jm["grad_norm"])))
    trows.append((float(tm["loss"]), float(tm["grad_norm"])))
    return [jp, js, jc, tp, ts, tc, jrows, trows]


def test_lowrank_trajectory_matches_reference():
    jcfg, cfg = _cfgs("lowrank")
    jp, jc, tp, tc = _carried(jcfg)
    jopt, topt, jfn, tfn = _step_fns(jcfg, cfg, _okw())
    run = [jp, jopt.init(jp), jc, tp, topt.init(tp), tc, [], []]
    for toks in _batches(cfg.vocab_size):
        run = _step(jfn, tfn, run, toks)
    _assert_rows(run[7], run[6])
    _assert_params(run[3], run[0])


def test_relora_trajectory_across_a_merge_matches_reference():
    """relora_period 2: both packages merge after step 2 (the port's
    merge with the reference's redrawn A carried over), then step 3."""
    jcfg, cfg = _cfgs("relora", relora_period=2)
    jp, jc, tp, tc = _carried(jcfg)
    jopt, topt, jfn, tfn = _step_fns(jcfg, cfg, _okw())
    run = [jp, jopt.init(jp), jc, tp, topt.init(tp), tc, [], []]
    batches = _batches(cfg.vocab_size)
    for toks in batches[:2]:
        run = _step(jfn, tfn, run, toks)
    jp, js, _, tp, ts, _, _, _ = run
    jm = jax.jit(jtrainer._make_relora_merge(jcfg))
    jp, js = jm(jp, js, jax.random.fold_in(jax.random.PRNGKey(42), 2))
    tp, ts = trainer_lib._make_relora_merge(cfg)(
        tp, ts, trainer_lib.relora_generator(42, 2, "cpu"))
    relora_paths = [p[:-len("/W0")] for p, _ in _leaves(tp)
                    if p.endswith("/W0")]
    assert len(relora_paths) == 7
    jA = dict(_jleaves(jp))
    for path in relora_paths:
        node = tp
        for k in path.split("/"):
            node = node[k]
        lim = math.sqrt(6.0 / node["B"].shape[-2])
        assert float(node["A"].abs().max()) <= lim
        assert not node["B"].any()
        np.testing.assert_allclose(_np(node["W0"]),
                                   np.asarray(jA[f"{path}/W0"]), rtol=0,
                                   atol=1e-4, err_msg=path)
        node["A"] = torch.from_numpy(np.array(jA[f"{path}/A"]))
    # the moment reset: B's and A's zeroed, W0's kept, in both packages
    for pkg, mu in (("port", dict(_leaves(ts["mu"]))),
                    ("reference", dict(_jleaves(js["mu"])))):
        for path in relora_paths:
            for k in ("B", "A"):
                assert not np.asarray(mu[f"{path}/{k}"]).any(), (pkg, path)
            assert np.asarray(mu[f"{path}/W0"]).any(), (pkg, path)
    run[:2], run[3:5] = [jp, js], [tp, ts]
    run = _step(jfn, tfn, run, batches[2])
    _assert_rows(run[7], run[6])
    _assert_params(run[3], run[0])


# ---------------------------------------------------------------------------
# GaLore
# ---------------------------------------------------------------------------

def _orthonormal(rng, n, r):
    return np.linalg.qr(rng.standard_normal((n, r)))[0].astype(np.float32)


@pytest.mark.parametrize("shape", [(64, 160), (160, 64)],
                         ids=["left", "right"])
@pytest.mark.parametrize("refresh", [True, False],
                         ids=["refresh", "carried"])
def test_galore_update_slice_matches_reference(refresh, shape):
    """One projected leaf's update from one carried-in state at step 5
    (a refresh: (5 - 1) % gap 4 == 0) or step 6 (P carried). At the
    refresh the carried first moment is 0: a nonzero one would be mixed
    with the new P's columns, whose signs are the solver's choice."""
    rng = np.random.default_rng(6)
    d, q = shape
    r = GALORE_RANK
    okw = _okw("galore_adamw", galore_update_proj_gap=4, weight_decay=0.1)
    okw.update(lr=1e-2, total_steps=20)
    left = d <= q
    low = (r, q) if left else (d, r)
    p = rng.standard_normal(shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    ls = {"P": _orthonormal(rng, min(d, q), r),
          "mu": (np.zeros(low) if refresh else rng.standard_normal(low)
                 * 0.1).astype(np.float32),
          "nu": (rng.uniform(0.01, 0.2, low)).astype(np.float32)}
    step = 4 if refresh else 5
    jopt = joptim.make(JOptimizerConfig(**okw))
    topt = optimizers.make(OptimizerConfig(**okw))
    jctx, _ = jopt.prepare({"step": jnp.int32(step)}, jnp.float32(3.0))
    tctx, _ = topt.prepare({"step": torch.tensor(step, dtype=torch.int32)},
                           torch.tensor(3.0))
    assert tctx["refresh"] == bool(jctx["refresh"]) == refresh
    jnew, jls = jax.jit(jopt.update_slice)(
        jctx, jnp.asarray(p), jnp.asarray(g),
        {k: jnp.asarray(v) for k, v in ls.items()})
    tnew, tls = topt.update_slice(
        tctx, torch.from_numpy(p), torch.from_numpy(g),
        {k: torch.from_numpy(v) for k, v in ls.items()})
    jls = {k: np.asarray(v) for k, v in jls.items()}
    tls = {k: v.numpy() for k, v in tls.items()}
    _close(tnew.numpy(), np.asarray(jnew), "float32",
           scale=float(np.abs(p).max()))
    np.testing.assert_allclose(tls["P"] @ tls["P"].T, jls["P"] @ jls["P"].T,
                               rtol=0, atol=1e-5)
    _close(tls["nu"], jls["nu"], "float32", scale=float(jls["nu"].max()))
    if refresh:
        # the new P's column signs, as the port's solver chose them; the
        # projected moment carries the two SVDs' difference (1e-6 in
        # P·Pᵀ) at 1e-4 of its scale
        sign = np.sign(np.sum(tls["P"] * jls["P"], axis=0))
        mu = jls["mu"] * (sign[:, None] if left else sign[None, :])
        assert not np.array_equal(tls["P"], ls["P"])
        np.testing.assert_allclose(tls["mu"], mu, rtol=0,
                                   atol=1e-4 * float(np.abs(mu).max()))
    else:
        assert np.array_equal(tls["P"], ls["P"])
        _close(tls["mu"], jls["mu"], "float32",
               scale=float(np.abs(jls["mu"]).max()))


@pytest.mark.parametrize("mode,update_mode", [
    ("dense", "global"), ("lowrank", "global"), ("lowrank", "per_layer")])
def test_galore_trajectory_matches_reference(mode, update_mode):
    """galore_update_proj_gap (200) above the step count: P is formed at
    step 1 and carried, so P's column signs cancel in every update."""
    jcfg, cfg = _cfgs(mode)
    jp, jc, tp, tc = _carried(jcfg)
    jopt, topt, jfn, tfn = _step_fns(jcfg, cfg, _okw("galore_adamw"),
                                     update_mode)
    ts = topt.init(tp)
    assert [p for p, _ in _leaves(ts["leaves"]) if p.endswith("/P")] == [
        "lm_head/P"]
    run = [jp, jopt.init(jp), jc, tp, ts, tc, [], []]
    for toks in _batches(cfg.vocab_size):
        run = _step(jfn, tfn, run, toks)
    _assert_rows(run[7], run[6])
    _assert_params(run[3], run[0])
    P_t = run[4]["leaves"]["lm_head"]["P"].numpy()
    P_j = np.asarray(run[1]["leaves"]["lm_head"]["P"])
    np.testing.assert_allclose(P_t @ P_t.T, P_j @ P_j.T, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# State trees
# ---------------------------------------------------------------------------

MODES = ("dense", "lowrank", "relora", "sltrain")
OPTS = ("adamw", "adam8bit", "galore_adamw")


@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("mode", MODES)
def test_state_trees_match_reference(mode, opt):
    """Paths, shapes and dtypes of the port's own init's optimizer state
    against the reference's. GaLore projects only lm_head in every mode;
    ReLoRA's W0 carries moments. ReLoRA with adam8bit is refused."""
    jcfg, cfg = _cfgs(mode, dtype="bfloat16")
    if mode == "relora" and opt == "adam8bit":
        with tempfile.TemporaryDirectory() as d, \
                pytest.raises(ValueError, match="zeros_like requires ndarray"):
            trainer_lib.Trainer(TrainConfig(
                model=cfg, optim=OptimizerConfig(name=opt), ckpt_dir=d),
                device="cpu")
        return
    jp, _ = jregistry.get_api(jcfg).init(jcfg, jax.random.PRNGKey(0),
                                         seed=0)
    tp, _ = registry.get_api(cfg).init(cfg, seed=0, device="cpu")
    js = joptim.make(JOptimizerConfig(**_okw(opt))).init(jp)
    ts = optimizers.make(OptimizerConfig(**_okw(opt))).init(tp)
    want = [(p, tuple(x.shape), str(x.dtype)) for p, x in _jleaves(js)]
    got = [(p, tuple(x.shape), str(x.dtype).split(".")[-1])
           for p, x in _leaves(ts)]
    assert got == want
    paths = {p: shape for p, shape, _ in got}
    if opt == "galore_adamw":
        assert [p for p in paths if p.endswith("/P")] == ["leaves/lm_head/P"]
        assert paths["leaves/lm_head/P"] == (cfg.d_model, GALORE_RANK)
    if mode == "relora" and opt == "adamw":
        assert paths["mu/layers/k0/attn/wq/W0"] == (
            cfg.n_layers, cfg.d_model, cfg.d_model)


# ---------------------------------------------------------------------------
# Checkpoints across the two packages
# ---------------------------------------------------------------------------

def _assert_tree_equal(torch_tree, jax_tree):
    tl, jl = _leaves(torch_tree), _jleaves(jax_tree)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, a), (_, b) in zip(tl, jl):
        b = np.asarray(b)
        assert str(a.dtype).split(".")[-1] == str(b.dtype), path
        if a.dtype == torch.bfloat16:
            np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                          b.view(np.int16), err_msg=path)
        else:
            np.testing.assert_array_equal(a.numpy(), b, err_msg=path)


@pytest.mark.parametrize("mode,opt", [("relora", "adamw"),
                                      ("dense", "galore_adamw"),
                                      ("lowrank", "galore_adamw")])
def test_checkpoints_cross_restore_bit_for_bit(mode, opt):
    jcfg, cfg = _cfgs(mode, dtype="bfloat16")
    jp, _, tp, _ = _carried(jcfg)
    js = joptim.make(JOptimizerConfig(**_okw(opt))).init(jp)
    bump = lambda t: t + 0.5 if t.dtype == jnp.float32 else t
    js = {**jax.tree.map(bump, {k: v for k, v in js.items() if k != "step"}),
          "step": jnp.int32(7)}
    jtree = {"params": jp, "opt_state": js}
    ttree = {"params": tp, "opt_state": opt_state_from_jax_numpy(
        jax.tree.map(np.asarray, js), device="cpu")}
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        JaxCkpt(d1).save(7, jtree, config_hash=cfg.hash())
        got, man = ckpt.CheckpointManager(d1).restore(
            tree_map(torch.zeros_like, ttree), config_hash=cfg.hash())
        assert man["step"] == 7
        _assert_tree_equal(got, jtree)
        ckpt.CheckpointManager(d2).save(7, ttree, config_hash=cfg.hash())
        back, _ = JaxCkpt(d2).restore(jtree, config_hash=cfg.hash())
        _assert_tree_equal(ttree, back)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [
    ["--mode", "lowrank"], ["--mode", "relora"],
    ["--optimizer", "galore_adamw"],
    ["--optimizer", "galore_adamw", "--update-mode", "per_layer"]],
    ids=lambda f: " ".join(f))
def test_train_launcher_baselines_run(flags, tmp_path):
    from repro_torch.launch import train
    tr = train.main(["--smoke", "--steps", "2", "--batch", "2", "--seq",
                     "16", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                     *flags])
    assert len(tr.metrics_history) == 2
    for row in tr.metrics_history:
        assert np.isfinite(row["loss"]) and row["nonfinite"] == 0.0


def test_train_launcher_refuses_relora_with_adam8bit(tmp_path):
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="ROADMAP queue C"):
        train.main(["--smoke", "--steps", "2", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path), "--mode", "relora",
                    "--optimizer", "adam8bit"])


def test_trainer_merges_every_period(tmp_path):
    """The port's Trainer merges after steps 2 and 4 of 5 (relora_period
    2): B is zero right after a merge, so after step 5 it is one Adam step
    away from zero, and the merge is logged twice."""
    _, cfg = _cfgs("relora", relora_period=2)
    logs = []
    tr = trainer_lib.Trainer(TrainConfig(
        model=cfg, optim=OptimizerConfig(**{**_okw(), "total_steps": 5}),
        global_batch=2, seq_len=16, steps=5, ckpt_every=0,
        ckpt_dir=str(tmp_path), async_ckpt=False), device="cpu",
        log_fn=logs.append)
    state = tr.run()
    assert sum("ReLoRA merge" in m for m in logs) == 2
    lr = float(tr.metrics_history[-1]["lr"])
    for path, b in _leaves(state.params):
        if path.endswith("/B"):
            assert 0 < float(b.abs().max()) <= 1.01 * lr, path


# ---------------------------------------------------------------------------
# The Table 2 comparison
# ---------------------------------------------------------------------------

def test_pretrain_comparison_config_matches_reference_example():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "pretrain_comparison.py"
    spec = importlib.util.spec_from_file_location("ref_comparison", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    from repro_torch.analysis import pretrain_comparison as cmp
    for dim in (32, 128):
        assert dataclasses.asdict(cmp.base_config(dim)) == \
            dataclasses.asdict(ref.base_config(dim))


def test_pretrain_comparison_runs_on_cpu(tmp_path):
    """The four modes at a tiny budget: one row each, finite losses, and
    the parameter counts' order the paper's gate reads."""
    from repro_torch.analysis import pretrain_comparison as cmp
    res = cmp.compare(steps=4, dim=32, batch=2, seq=16, device="cpu",
                      ckpt_root=str(tmp_path), log_fn=lambda *a: None)
    assert sorted(res) == sorted(cmp.MODES)
    for r in res.values():
        assert len(r["losses"]) == 4 and np.isfinite(r["losses"]).all()
    assert res["sltrain"]["params_M"] < res["dense"]["params_M"] < \
        res["relora"]["params_M"]
    assert len(cmp.table(res)) == 5
    assert list(tmp_path.iterdir()) == []
    bad = cmp.gate_failures({**res, "lowrank": {
        **res["lowrank"], "ppl": 0.0}})
    assert bad == ["SLTrain should beat pure low-rank (paper Table 2)"]
