"""The port's training slice against the reference on the CPU.

Inputs are made from a numpy seed (or by the reference's init, carried
over with ``from_jax_numpy``) and go through the reference function and
its port counterpart:

* SyntheticC4 batches, bit for bit (seed, cursor, skip, state round trip,
  host sharding);
* the dense exec mode's eq.-(2) backward against ``jax.vjp`` of
  ``repro.core.sltrain.sl_matmul`` (row-balanced and COO);
* cross_entropy with a padded vocab, warmup_cosine, one clipped AdamW step
  and the non-finite gate;
* a 5-step loss trajectory of the ``llama_60m`` smoke config in f32,
  exec_mode fused and dense, from the reference's params, against
  ``repro.train.step.make_train_step`` (fused: Pallas in interpret mode);
* checkpoints written by either package restored by the other bit for
  bit, the fallback past a corrupted byte and the config-drift check;
* the port Trainer's kill/resume bit-exactness.

Tolerances: f32 values that the two packages compute with the same
operations in another order (sums over tokens, tiles or leaves) agree to
rtol 1e-5 with an atol of 1e-6 at their scale; bf16 gradients to 2e-2
(one bf16 ulp where the order tips a rounding). Loss trajectories agree
to 2e-5 absolute (a few f32 ulp of a loss near 6.5; Adam turns the tiny
gradient differences into update differences of at most lr per element).
"""
import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import roofline as jroofline
from repro.ckpt.checkpoint import CheckpointManager as JaxCkpt
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.core import sltrain as jsltrain
from repro.core import support as jsupport
from repro.data.pipeline import SyntheticC4 as JaxC4
from repro.models import registry as jregistry
from repro.optim import optimizers as joptim
from repro.optim import schedule as jschedule
from repro.train import step as jstep
from repro_torch.analysis import roofline
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt.convert import from_jax_numpy, opt_state_from_jax_numpy
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.core import sltrain
from repro_torch.data.pipeline import SyntheticC4
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.optim import optimizers, schedule
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.train import step as step_lib
from repro_torch.train.trainer import Trainer

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, dtype, scale=1.0):
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol * scale if dtype != "float32"
                               else 1e-6 * scale)


# ---------------------------------------------------------------------------
# SyntheticC4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("host", [(0, 1), (1, 2)])
def test_synthetic_c4_bit_identical_to_reference(host):
    host_id, n_hosts = host
    kw = dict(seed=7, host_id=host_id, num_hosts=n_hosts)
    a, b = JaxC4(512, 24, 4, **kw), SyntheticC4(512, 24, 4, **kw)
    for _ in range(2):
        np.testing.assert_array_equal(a.next_batch()["tokens"],
                                      b.next_batch()["tokens"])
    a.skip(3)
    b.skip(3)
    assert a.state_dict() == b.state_dict()
    np.testing.assert_array_equal(a.next_batch()["tokens"],
                                  b.next_batch()["tokens"])
    c = SyntheticC4(512, 24, 4, **kw)
    c.restore(a.state_dict())
    np.testing.assert_array_equal(a.next_batch()["tokens"],
                                  c.next_batch()["tokens"])
    with pytest.raises(ValueError, match="different data seed"):
        c.restore({"seed": 8, "step": 0})


def test_synthetic_c4_shares_one_read_only_table_per_vocab_and_seed():
    """Sources of one (vocab, seed) share one transition table, computed
    once and read-only; another seed gets its own; each still gives the
    reference's batches."""
    a, b = SyntheticC4(512, 24, 4, seed=7), SyntheticC4(512, 24, 4, seed=7)
    c = SyntheticC4(512, 24, 4, seed=8)
    assert a._ids is b._ids and a._cdf is b._cdf
    assert not (a._ids.flags.writeable or a._cdf.flags.writeable)
    assert not np.array_equal(a._cdf, c._cdf)
    for src, seed in ((b, 7), (c, 8)):
        np.testing.assert_array_equal(
            src.next_batch()["tokens"],
            JaxC4(512, 24, 4, seed=seed).next_batch()["tokens"])


# ---------------------------------------------------------------------------
# Dense exec mode: eq. (2) backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["row_balanced", "iid"])
def test_dense_backward_matches_reference_vjp(kind, dtype):
    d_in, d_out, r, delta, m = 96, 160, 8, 0.05, 12
    rng = np.random.default_rng(3)
    rows, cols = jsupport.sample_support(11, d_in, d_out, delta, kind)
    x = rng.standard_normal((2, m // 2, d_in)).astype(np.float32)
    B = rng.uniform(-1, 1, (d_in, r)).astype(np.float32)
    A = rng.uniform(-0.2, 0.2, (r, d_out)).astype(np.float32)
    v = (rng.uniform(-1, 1, rows.shape[0]) * 0.1).astype(np.float32)
    dy = rng.standard_normal((2, m // 2, d_out)).astype(np.float32)
    if kind == "row_balanced":
        v = v.reshape(d_in, -1)
        jc = {"cols": jnp.asarray(cols.reshape(d_in, -1))}
        tc = {"cols": torch.from_numpy(cols.reshape(d_in, -1))}
    else:
        jc = {"rows": jnp.asarray(rows), "cols": jnp.asarray(cols)}
        tc = {"rows": torch.from_numpy(rows), "cols": torch.from_numpy(cols)}
    scale = 4.0
    j = lambda a: jnp.asarray(a).astype(JDT[dtype])
    y, vjp = jax.vjp(
        lambda x_, B_, A_, v_: jsltrain.sl_matmul(
            x_, {"B": B_, "A": A_, "v": v_}, jc, scale, "dense"),
        j(x), j(B), j(A), j(v))
    want = (y,) + vjp(j(dy))
    t = lambda a: torch.from_numpy(a).to(TDT[dtype]).requires_grad_(True)
    tx, tB, tA, tv = t(x), t(B), t(A), t(v)
    ty = sltrain.sl_matmul(tx, {"B": tB, "A": tA, "v": tv}, tc, scale,
                           "dense")
    got = (ty,) + torch.autograd.grad(
        ty, (tx, tB, tA, tv), torch.from_numpy(dy).to(TDT[dtype]))
    for name, g, w in zip(("y", "dx", "dB", "dA", "dv"), got, want):
        assert g.dtype == TDT[dtype], name
        w = np.asarray(w.astype(jnp.float32))
        _close(_np(g), w, dtype, scale=float(np.abs(w).max()))


# ---------------------------------------------------------------------------
# Loss, schedule, optimizer, gate
# ---------------------------------------------------------------------------

def test_cross_entropy_masks_padded_vocab():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 24)).astype(np.float32)
    logits[..., 20:] = 30.0           # the padded tail would dominate
    labels = rng.integers(0, 20, (2, 5)).astype(np.int32)
    want = jstep.cross_entropy(jnp.asarray(logits), jnp.asarray(labels), 20)
    got = step_lib.cross_entropy(torch.from_numpy(logits),
                                 torch.from_numpy(labels), 20)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    bf = torch.from_numpy(logits).to(torch.bfloat16)
    got_bf = step_lib.cross_entropy(bf, torch.from_numpy(labels), 20)
    want_bf = jstep.cross_entropy(jnp.asarray(logits).astype(jnp.bfloat16),
                                  jnp.asarray(labels), 20)
    np.testing.assert_allclose(got_bf.item(), float(want_bf), rtol=1e-6)


def test_warmup_cosine_matches_reference():
    kw = dict(lr=3e-3, warmup_steps=5, total_steps=40, min_lr_ratio=0.1)
    want = jschedule.warmup_cosine(JOptimizerConfig(**kw))
    got = schedule.warmup_cosine(OptimizerConfig(**kw))
    for s in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        np.testing.assert_allclose(
            float(got(torch.tensor(s, dtype=torch.int32))),
            float(want(jnp.int32(s))), rtol=1e-6)
        np.testing.assert_allclose(float(got(s)), float(want(s)), rtol=1e-6)


def _small_tree(rng):
    return {"a": {"w": rng.standard_normal((4, 6)).astype(np.float32),
                  "b": rng.standard_normal((6,)).astype(np.float32)},
            "c": rng.standard_normal((3, 2, 5)).astype(np.float32)}


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_clipped_step_matches_reference(wd):
    rng = np.random.default_rng(1)
    params, grads = _small_tree(rng), _small_tree(rng)
    grads = jax.tree.map(lambda g: g * 10.0, grads)   # norm far above clip
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=wd,
              grad_clip=1.0)
    jopt = joptim.make(JOptimizerConfig(**kw))
    jp, js = jax.tree.map(jnp.asarray, params), None
    js = jopt.init(jp)
    topt = optimizers.make(OptimizerConfig(**kw))
    tp = jax.tree.map(torch.from_numpy, params)
    ts = topt.init(tp)
    for _ in range(2):
        jp, js, jstats = jopt.update(jax.tree.map(jnp.asarray, grads), js,
                                     jp)
        tp, ts, tstats = topt.update(jax.tree.map(torch.from_numpy, grads),
                                     ts, tp)
    np.testing.assert_allclose(float(tstats["grad_norm"]),
                               float(jstats["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(tstats["lr"]), float(jstats["lr"]),
                               rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 2
    assert ts["step"].dtype == torch.int32
    for name, tt, jt in (("params", tp, jp), ("mu", ts["mu"], js["mu"]),
                         ("nu", ts["nu"], js["nu"])):
        for g, w in zip(tree_leaves(tt), jax.tree.leaves(jt)):
            np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6,
                                       atol=1e-7, err_msg=name)


def test_nonfinite_gate_keeps_old_state_bit_exact():
    rng = np.random.default_rng(2)
    new = {"w": torch.from_numpy(rng.standard_normal((3, 4)).astype(
        np.float32))}
    old = {"w": torch.from_numpy(rng.standard_normal((3, 4)).astype(
        np.float32)).to(torch.bfloat16)}
    new["w"] = new["w"].to(torch.bfloat16)
    old0 = old["w"].clone()
    good_g = {"w": torch.ones(3, 4)}
    bad_g = {"w": torch.tensor([[1.0, float("nan"), 0, 0]] * 3)}
    # the gate writes its selection into the new leaves: a fresh copy each
    fresh = lambda: {"w": new["w"].clone()}
    (kept,), flag = step_lib.nonfinite_gate(torch.tensor(1.0), bad_g,
                                            (fresh(),), (old,))
    assert float(flag) == 1.0 and torch.equal(kept["w"], old["w"])
    (took,), flag = step_lib.nonfinite_gate(torch.tensor(1.0), good_g,
                                            (fresh(),), (old,))
    assert float(flag) == 0.0 and torch.equal(took["w"], new["w"])
    (kept,), flag = step_lib.nonfinite_gate(torch.tensor(float("inf")),
                                            good_g, (fresh(),), (old,))
    assert float(flag) == 1.0 and torch.equal(kept["w"], old["w"])
    assert torch.equal(old["w"], old0)


@pytest.mark.parametrize("arch", registry.PAPER_ARCHS)
def test_model_flops_match_reference(arch):
    """6·N·D of the paper configs as the reference counts it; MFU over the
    H100's data-sheet peak in place of the reference's."""
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    assert roofline.param_count_active(cfg) == \
        jroofline.param_count_active(jcfg)
    assert roofline.model_flops(cfg, 2048) == jroofline.model_flops(jcfg, 2048)
    np.testing.assert_allclose(
        roofline.train_mfu(cfg, 2048, 0.5) * roofline.PEAK_FLOPS,
        jroofline.train_mfu(jcfg, 2048, 0.5) * jroofline.PEAK_FLOPS,
        rtol=1e-12)


def test_model_flops_llama_7b_counts_the_dense_model():
    """MFU at llama_7b counts LLaMA-7B's 6.74 B dense parameters (the
    paper's convention: 6·N·D of the full-rank model, whatever the
    parameterization trains), 32 layers of 4·4096² + 3·4096·11008 and
    an untied 32000 x 4096 embedding and head."""
    cfg = registry.get_config("llama_7b")
    layer = 4 * 4096 ** 2 + 3 * 4096 * 11008
    assert 32 * layer + 2 * 32000 * 4096 == 6_738_149_376
    assert roofline.param_count_active(cfg) == (6_738_149_376,) * 2
    assert roofline.model_flops(cfg, 8 * 256) == 6.0 * 6_738_149_376 * 2048


def test_model_flops_raise_for_unported_families():
    """The SSM and encoder families are counted now, as the reference
    counts them (its "ssm-ish" 8·d² where d_ff is 0; whisper's decoder
    only); experts on a llama config are counted too."""
    for arch in ("zamba2_7b", "xlstm_350m", "whisper_large_v3"):
        got, jcfg = registry.get_config(arch), jregistry.get_config(arch)
        assert roofline.param_count_active(got) == \
            jroofline.param_count_active(jcfg)
        assert roofline.model_flops(got, 2048) == \
            jroofline.model_flops(jcfg, 2048) > 0
    cfg, jcfg = registry.get_config("llama_60m"), \
        jregistry.get_config("llama_60m")
    for kw in (dict(family="whisper"), dict(family="mamba2", d_ff=0)):
        assert roofline.model_flops(dataclasses.replace(cfg, **kw), 2048) \
            == jroofline.model_flops(dataclasses.replace(jcfg, **kw), 2048)
    moe = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           n_experts=4))
    total, active = roofline.param_count_active(moe)
    assert active < total and roofline.model_flops(moe, 2048) > 0


# ---------------------------------------------------------------------------
# Train steps on the llama_60m smoke config, from the reference's params
# ---------------------------------------------------------------------------

def _cfgs(exec_mode, dtype="float32"):
    def mk(cfg):
        return dataclasses.replace(cfg, dtype=dtype, param=dataclasses.replace(
            cfg.param, exec_mode=exec_mode))
    return (mk(jregistry.get_smoke_config("llama_60m")),
            mk(registry.get_smoke_config("llama_60m")))


def _carried(jcfg, seed=42):
    """Reference init, carried over; returns (jax params, consts, port
    params, consts). The port's consts carry Wᵀ's tile consts for the
    fused backward's dx, as the Trainer builds them."""
    params, consts = jregistry.get_api(jcfg).init(
        jcfg, jax.random.PRNGKey(seed), seed=seed)
    tp, tc = from_jax_numpy(jax.tree.map(np.asarray, params),
                            jax.tree.map(np.asarray, consts), device="cpu")
    return params, consts, tp, ops.add_transposed_tiles(tc)


@pytest.mark.parametrize("exec_mode", ["fused", "dense"])
def test_train_trajectory_matches_reference(exec_mode):
    steps = 5
    jcfg, cfg = _cfgs(exec_mode)
    jp, jc, tp, tc = _carried(jcfg)
    okw = dict(lr=1e-3, warmup_steps=2, total_steps=steps)
    jopt = joptim.make(JOptimizerConfig(**okw))
    topt = optimizers.make(OptimizerConfig(**okw))
    jfn = jax.jit(jstep.make_train_step(jcfg, jregistry.get_api(jcfg), jopt))
    tfn = step_lib.make_train_step(cfg, registry.get_api(cfg), topt)
    js, ts = jopt.init(jp), topt.init(tp)
    data = SyntheticC4(cfg.vocab_size, 32, 4, seed=0)
    jl, tl, jg, tg = [], [], [], []
    for _ in range(steps):
        toks = data.next_batch()["tokens"]
        jp, js, jm = jfn(jp, js, jc, {"tokens": jnp.asarray(toks)})
        tp, ts, tm = tfn(tp, ts, tc, {"tokens": torch.from_numpy(toks)})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        jg.append(float(jm["grad_norm"]))
        tg.append(float(tm["grad_norm"]))
        assert float(tm["nonfinite"]) == 0.0
    np.testing.assert_allclose(tl, jl, rtol=0, atol=2e-5)
    np.testing.assert_allclose(tg, jg, rtol=1e-4)
    for g, w in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=0, atol=1e-4)


def test_fused_and_dense_grads_agree_in_port():
    """One step's gradients of the two exec modes, on the same params."""
    _, cfg_f = _cfgs("fused")
    cfg_d = dataclasses.replace(cfg_f, param=dataclasses.replace(
        cfg_f.param, exec_mode="dense"))
    jcfg, _ = _cfgs("fused")
    _, _, tp, tc = _carried(jcfg, seed=3)
    toks = torch.from_numpy(SyntheticC4(512, 32, 2, seed=1).next_batch()[
        "tokens"])
    grads = {}
    for name, cfg in (("fused", cfg_f), ("dense", cfg_d)):
        loss_fn = step_lib.make_loss_fn(cfg, registry.get_api(cfg))
        _, _, grads[name] = step_lib._value_and_grad(loss_fn, tp, tc,
                                                      {"tokens": toks})
    for a, b in zip(tree_leaves(grads["fused"]), tree_leaves(grads["dense"])):
        scale = float(b.abs().max())
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4,
                                   atol=1e-5 * max(scale, 1e-3))


def test_grad_accum_matches_one_batch_and_eval_step():
    jcfg, cfg = _cfgs("dense")
    _, _, tp, tc = _carried(jcfg, seed=5)
    toks = torch.from_numpy(SyntheticC4(512, 16, 4, seed=2).next_batch()[
        "tokens"])
    opt = optimizers.make(OptimizerConfig(lr=1e-3))
    api = registry.get_api(cfg)
    one = step_lib.make_train_step(cfg, api, opt)
    two = step_lib.make_train_step(cfg, api, opt, grad_accum=2)
    p1, _, m1 = one(tp, opt.init(tp), tc, {"tokens": toks})
    p2, _, m2 = two(tp, opt.init(tp), tc, {"tokens": toks})
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]), float(m1["grad_norm"]),
                               rtol=1e-5)
    ev = step_lib.make_eval_step(cfg, api)(tp, tc, {"tokens": toks})
    np.testing.assert_allclose(float(ev["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(ev["ppl"]), np.exp(float(ev["ce"])),
                               rtol=1e-6)


def test_chaos_scale_nan_leaves_params_bit_identical():
    jcfg, cfg = _cfgs("fused")
    _, _, tp, tc = _carried(jcfg)
    opt = optimizers.make(OptimizerConfig())
    fn = step_lib.make_train_step(cfg, registry.get_api(cfg), opt)
    toks = torch.from_numpy(SyntheticC4(512, 16, 2, seed=0).next_batch()[
        "tokens"])
    state = opt.init(tp)
    new_p, new_s, m = fn(tp, state, tc, {
        "tokens": toks, "chaos_scale": torch.tensor([1.0, float("nan")])})
    assert float(m["nonfinite"]) == 1.0
    for a, b in zip(tree_leaves(new_p) + tree_leaves(new_s),
                    tree_leaves(tp) + tree_leaves(state)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Checkpoints across the two packages
# ---------------------------------------------------------------------------

def _state_trees(dtype):
    jcfg, cfg = _cfgs("fused", dtype)
    jp, _, tp, _ = _carried(jcfg)
    js = joptim.make(JOptimizerConfig()).init(jp)
    js = {**js, "mu": jax.tree.map(lambda m: m + 0.5, js["mu"]),
          "step": jnp.int32(7)}
    ts = opt_state_from_jax_numpy(jax.tree.map(np.asarray, js),
                                  device="cpu")
    return cfg, {"params": jp, "opt_state": js}, \
        {"params": tp, "opt_state": ts}


def _assert_tree_equal(torch_tree, jax_tree):
    tl, jl = tree_leaves(torch_tree), jax.tree.leaves(jax_tree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        b = np.asarray(b)
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        if a.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                a.view(torch.int16).numpy(), b.view(np.int16))
        else:
            np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_checkpoints_cross_restore_bit_for_bit(dtype):
    cfg, jtree, ttree = _state_trees(dtype)
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        JaxCkpt(d1).save(3, jtree, config_hash=cfg.hash(),
                         extra={"data": {"seed": 1, "step": 3}})
        got, man = ckpt.CheckpointManager(d1).restore(
            ttree, config_hash=cfg.hash())
        assert man["step"] == 3 and man["extra"]["data"]["step"] == 3
        _assert_tree_equal(got, jtree)

        ckpt.CheckpointManager(d2).save(4, ttree, config_hash=cfg.hash())
        back, _ = JaxCkpt(d2).restore(jtree, config_hash=cfg.hash())
        _assert_tree_equal(ttree, back)
        assert sorted(os.listdir(os.path.join(d2, "step_00000004"))) == [
            "arrays.npz", "manifest.json"]
        with pytest.raises(ValueError, match="config hash mismatch"):
            ckpt.CheckpointManager(d2).restore(ttree, config_hash="drifted")


def test_corrupted_checkpoint_falls_back_to_older_step():
    _, _, ttree = _state_trees("bfloat16")
    with tempfile.TemporaryDirectory() as d:
        cm = ckpt.CheckpointManager(d)
        cm.save(1, ttree)
        bumped = {"params": ttree["params"], "opt_state": {
            **ttree["opt_state"], "step": ttree["opt_state"]["step"] + 1}}
        cm.save(2, bumped)
        path = os.path.join(d, "step_00000002", "arrays.npz")
        raw = bytearray(open(path, "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        open(path, "wb").write(bytes(raw))
        assert not cm.verify_step(2) and cm.verify_step(1)
        with pytest.warns(UserWarning, match="corrupt"):
            tree, man = cm.restore(ttree)
        assert man["step"] == 1
        with pytest.raises(ckpt.CheckpointCorruptError):
            cm.restore(ttree, step=2)
        # the reference reads the port's damage the same way
        with pytest.warns(UserWarning, match="corrupt"):
            _, jman = JaxCkpt(d).restore(
                jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
                    jnp.bfloat16 if t.dtype == torch.bfloat16
                    else t.numpy().dtype), ttree))
        assert jman["step"] == 1


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

def _tc(d, **kw):
    cfg = dataclasses.replace(registry.get_smoke_config("llama_60m"),
                              param=dataclasses.replace(
                                  registry.get_smoke_config(
                                      "llama_60m").param, exec_mode="fused"))
    base = dict(model=cfg, optim=OptimizerConfig(lr=1e-3, warmup_steps=2,
                                                 total_steps=6),
                global_batch=2, seq_len=16, steps=6, log_every=100,
                ckpt_every=3, ckpt_dir=d, async_ckpt=False)
    base.update(kw)
    return TrainConfig(**base)


def test_trainer_kill_resume_bit_exact():
    """Crash at step 4, relaunch: the final params equal an uninterrupted
    run's bit for bit."""
    class Boom(Exception):
        pass

    quiet = dict(log_fn=lambda *a: None, device="cpu")
    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        ref = Trainer(_tc(d1), **quiet).run()

        def bomb(step):
            if step == 4:
                raise Boom()
        with pytest.raises(Boom):
            Trainer(_tc(d2), fault_hook=bomb, **quiet).run()
        tr = Trainer(_tc(d2), **quiet)
        state = tr.run()
        assert tr.metrics_history[0]["step"] == 4    # resumed at step 3
        for a, b in zip(tree_leaves(ref.params), tree_leaves(state.params)):
            assert torch.equal(a, b)
        assert tr.obs.get("train.steps").value == 3
        assert tr.obs.get("train.loss").value == tr.metrics_history[-1][
            "loss"]
