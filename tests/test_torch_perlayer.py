"""The port's per-layer train step (``update_mode="per_layer"``) against
the reference on the CPU, on the ``llama_60m`` smoke config in f32 from
the reference's init carried over with ``from_jax_numpy``:

* 4 steps against ``repro.train.perlayer`` for AdamW (exec_mode dense),
  8-bit AdamW with the kernel dispatch (exec_mode fused: the reference's
  Pallas kernels in interpret mode, the port's plain versions; also 3
  steps on the ``llama_7b`` smoke config, alpha 8), tied
  embeddings, ``grad_accum=2`` and GaLore-AdamW (rank 8, so that
  ``lm_head`` is projected; P is formed at step 1 and carried, so its
  column signs, the SVD's choice, cancel in every update);
* against the port's own global step from the port's own init (AdamW,
  and 8-bit AdamW's kernel dispatch against its plain global update);
* remat "full" and "dots_saveable" bit-identical to "none", in both
  update modes;
* the non-finite gate, per-layer update timing, and an 8-bit per-layer
  checkpoint restored across the two packages bit for bit.

Tolerances: losses 2e-5 absolute and gradient norms 1e-5 relative (the
two packages sum the same terms in another order; the reference's own
per-layer tests hold it to global mode at the same bounds); parameters
1e-4 absolute after 4 steps (Adam's update is at most lr = 1e-3 per
element and step); 8-bit moments within one code step of their block
(a last-bit difference of an f32 moment can tip one code's rounding).
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
from repro_torch.ckpt.convert import from_jax_numpy, opt_state_from_jax_numpy
from repro_torch.configs.base import OptimizerConfig
from repro_torch.data.pipeline import SyntheticC4
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.models import common
from repro_torch.models.common import tree_map
from repro_torch.obs import metrics as obs_metrics
from repro_torch.optim import optimizers
from repro_torch.train import perlayer
from repro_torch.train import step as step_lib

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

STEPS = 4
CASES = {
    "adamw-dense": dict(opt="adamw", exec_mode="dense"),
    "adam8bit-fused": dict(opt="adam8bit", exec_mode="fused"),
    "tied-adamw": dict(opt="adamw", exec_mode="dense", tied=True),
    "grad_accum2-adam8bit": dict(opt="adam8bit", exec_mode="dense",
                                 grad_accum=2),
    "galore-dense": dict(opt="galore_adamw", exec_mode="dense"),
    # the llama_7b smoke config (alpha 8, delta 0.05), 3 steps
    "adam8bit-fused-llama_7b": dict(opt="adam8bit", exec_mode="fused",
                                    arch="llama_7b", steps=3),
}


def _cfgs(exec_mode, tied=False, arch="llama_60m"):
    def mk(cfg):
        return dataclasses.replace(
            cfg, dtype="float32", tie_embeddings=tied,
            param=dataclasses.replace(cfg.param, exec_mode=exec_mode))
    return (mk(jregistry.get_smoke_config(arch)),
            mk(registry.get_smoke_config(arch)))


def _okw(name, steps=STEPS):
    return dict(name=name, lr=1e-3, warmup_steps=2, total_steps=steps,
                weight_decay=0.1, galore_rank=8)


def _batches(vocab, n=STEPS, seed=0):
    data = SyntheticC4(vocab, 32, 4, seed=seed)
    return [data.next_batch()["tokens"] for _ in range(n)]


def _port_init(jcfg, seed=42):
    """The reference's params and consts carried over (the port's consts
    gain Wᵀ's tile consts, as the Trainer builds them)."""
    params, consts = jregistry.get_api(jcfg).init(
        jcfg, jax.random.PRNGKey(seed), seed=seed)
    tp, tc = from_jax_numpy(jax.tree.map(np.asarray, params),
                            jax.tree.map(np.asarray, consts), device="cpu")
    return (params, consts), (tp, ops.add_transposed_tiles(tc))


def _own_init(cfg, seed):
    """The port's own init (for the tests that compare the port with
    itself)."""
    params, consts = registry.get_api(cfg).init(cfg, seed=seed,
                                                 device="cpu")
    return params, ops.add_transposed_tiles(consts)


def _run_port(cfg, params, consts, fn, opt, batches):
    params = tree_map(lambda t: t.clone(), params)
    state = opt.init(params)
    rows = []
    for toks in batches:
        params, state, m = fn(params, state, consts,
                              {"tokens": torch.from_numpy(toks)})
        rows.append((float(m["loss"]), float(m["grad_norm"]),
                     float(m["nonfinite"])))
    return np.array(rows), params, state


_JAX_RUNS = {}


def _reference_run(case):
    """The reference's per-layer run of ``case`` (cached: the checkpoint
    test restores its 8-bit state)."""
    if case not in _JAX_RUNS:
        c = CASES[case]
        steps = c.get("steps", STEPS)
        jcfg, _ = _cfgs(c["exec_mode"], c.get("tied", False),
                        c.get("arch", "llama_60m"))
        (jp, jc), _ = _port_init(jcfg)
        jopt = joptim.make(JOptimizerConfig(**_okw(c["opt"], steps)))
        fn = jax.jit(jperlayer.make_perlayer_train_step(
            jcfg, jregistry.get_api(jcfg), jopt,
            grad_accum=c.get("grad_accum", 1)))
        js = jopt.init(jp)
        rows = []
        for toks in _batches(jcfg.vocab_size, steps):
            jp, js, m = fn(jp, js, jc, {"tokens": jnp.asarray(toks)})
            rows.append((float(m["loss"]), float(m["grad_norm"]),
                         float(m["nonfinite"])))
        _JAX_RUNS[case] = (np.array(rows), jp, js)
    return _JAX_RUNS[case]


def tree_leaves(tree):
    """(path, leaf) pairs in the reference's flatten order, as a list."""
    return list(common.tree_leaves(tree))


def _dequant(moment, signed):
    codes = moment["codes"].astype(np.float32)
    if not signed:
        codes = np.maximum(codes + 128.0, 0.5)
    return codes * moment["scales"][:, None]


def _assert_moments_within_one_step(tstate, jstate):
    """Every 8-bit moment within one code step (the larger of the two
    blocks' scales) of the reference's."""
    for name, signed in (("mu", True), ("nu", False)):
        tl = {k: v for k, v in tree_leaves(tstate[name])}
        jl = {"/".join(str(getattr(q, "key", q)) for q in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(
                  jstate[name])[0]}
        assert sorted(tl) == sorted(jl)
        for path in {k.rsplit("/", 1)[0] for k in tl}:
            t = {k: tl[f"{path}/{k}"].numpy() for k in ("codes", "scales")}
            j = {k: jl[f"{path}/{k}"] for k in ("codes", "scales")}
            step = np.maximum(t["scales"], j["scales"])[:, None]
            diff = np.abs(_dequant(t, signed) - _dequant(j, signed))
            assert (diff <= step * (1 + 1e-5) + 1e-30).all(), (name, path)


@pytest.mark.parametrize("case", sorted(CASES))
def test_perlayer_matches_reference(case):
    c = CASES[case]
    steps = c.get("steps", STEPS)
    jcfg, cfg = _cfgs(c["exec_mode"], c.get("tied", False),
                      c.get("arch", "llama_60m"))
    _, (tp, tc) = _port_init(jcfg)
    opt = optimizers.make(OptimizerConfig(**_okw(c["opt"], steps)))
    fn = perlayer.make_perlayer_train_step(
        cfg, registry.get_api(cfg), opt, grad_accum=c.get("grad_accum", 1))
    got, params, state = _run_port(cfg, tp, tc, fn, opt,
                                   _batches(cfg.vocab_size, steps))
    want, jp, js = _reference_run(case)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-5, atol=0)
    assert not got[:, 2].any() and not want[:, 2].any()
    tl, jl = tree_leaves(params), jax.tree.leaves(jp)
    assert len(tl) == len(jl)
    for (path, a), b in zip(tl, jl):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4, err_msg=path)
    assert int(state["step"]) == int(js["step"]) == steps
    if c["opt"] == "adam8bit":
        _assert_moments_within_one_step(state, js)


@pytest.mark.parametrize("name", ["adamw", "adam8bit"])
def test_perlayer_matches_port_global(name):
    """The port's two update modes from one init: per-layer (8-bit
    AdamW through its kernel dispatch) against the global step (8-bit
    AdamW's plain update)."""
    cfg = _cfgs("dense")[1]
    tp, tc = _own_init(cfg, seed=3)
    api = registry.get_api(cfg)
    opt = optimizers.make(OptimizerConfig(**_okw(name)))
    batches = _batches(cfg.vocab_size, seed=1)
    pl, pp, ps = _run_port(cfg, tp, tc, perlayer.make_perlayer_train_step(
        cfg, api, opt, fused_opt=True), opt, batches)
    gl, gp, gs = _run_port(cfg, tp, tc, step_lib.make_train_step(
        cfg, api, opt), opt, batches)
    np.testing.assert_allclose(pl[:, 0], gl[:, 0], rtol=0, atol=2e-5)
    np.testing.assert_allclose(pl[:, 1], gl[:, 1], rtol=1e-5, atol=0)
    for (path, a), (_, b) in zip(tree_leaves(pp), tree_leaves(gp)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-4,
                                   err_msg=path)
    if name == "adam8bit":
        np_tree = lambda s: {k: tree_map(lambda t: t.numpy(), s[k])
                             for k in ("mu", "nu")}
        _assert_moments_within_one_step(
            ps, jax.tree.map(np.asarray, np_tree(gs)))


@pytest.mark.parametrize("remat", ["full", "dots_saveable"])
@pytest.mark.parametrize("mode", ["global", "per_layer"])
def test_remat_changes_no_value(mode, remat):
    """Rematerialization recomputes the same operations on the same
    inputs: losses, norms, params and state bit-identical to "none"."""
    cfg = _cfgs("fused")[1]
    tp, tc = _own_init(cfg, seed=5)
    api = registry.get_api(cfg)
    opt = optimizers.make(OptimizerConfig(**_okw(
        "adam8bit" if mode == "per_layer" else "adamw")))
    make = perlayer.make_perlayer_train_step if mode == "per_layer" \
        else step_lib.make_train_step
    batches = _batches(cfg.vocab_size, n=2, seed=2)
    runs = [_run_port(cfg, tp, tc, make(cfg, api, opt, remat=r), opt,
                      batches) for r in ("none", remat)]
    (l0, p0, s0), (l1, p1, s1) = runs
    np.testing.assert_array_equal(l1, l0)
    for a, b in zip(tree_leaves(p1) + tree_leaves(s1),
                    tree_leaves(p0) + tree_leaves(s0)):
        assert torch.equal(a[1], b[1]), a[0]


def test_perlayer_nonfinite_gate_keeps_state_bit_identical():
    """A NaN in the loss (the reference's chaos scale) flows into every
    gradient: the update sweep is skipped and params, 8-bit state and
    step counter stay pre-step, bit for bit."""
    cfg = _cfgs("fused")[1]
    tp, tc = _own_init(cfg, seed=0)
    opt = optimizers.make(OptimizerConfig(**_okw("adam8bit")))
    fn = perlayer.make_perlayer_train_step(cfg, registry.get_api(cfg), opt)
    toks = torch.from_numpy(_batches(cfg.vocab_size, n=1)[0])
    params, state, _ = fn(tp, opt.init(tp), tc, {"tokens": toks})
    before = [t.clone() for _, t in tree_leaves(params) +
              tree_leaves(state)]
    new_p, new_s, m = fn(params, state, tc, {
        "tokens": toks, "chaos_scale": torch.tensor([1.0, float("nan")])})
    assert float(m["nonfinite"]) == 1.0
    assert not np.isfinite(float(m["loss"]))
    after = [t for _, t in tree_leaves(new_p) + tree_leaves(new_s)]
    assert len(after) == len(before)
    for a, b in zip(after, before):
        assert torch.equal(a, b)
    assert int(new_s["step"]) == 1


def test_perlayer_layer_timing_histogram():
    """With a registry the update sweep records one observation per layer
    per step, and timing changes no value."""
    cfg = _cfgs("dense")[1]
    tp, tc = _own_init(cfg, seed=0)
    api = registry.get_api(cfg)
    opt = optimizers.make(OptimizerConfig(**_okw("adamw")))
    reg = obs_metrics.Registry()
    batches = _batches(cfg.vocab_size, n=2)
    timed, _, _ = _run_port(cfg, tp, tc, perlayer.make_perlayer_train_step(
        cfg, api, opt, layer_timing=reg), opt, batches)
    plain, _, _ = _run_port(cfg, tp, tc, perlayer.make_perlayer_train_step(
        cfg, api, opt), opt, batches)
    np.testing.assert_array_equal(timed, plain)
    h = reg.histogram("train.perlayer.layer_update_ms")
    assert h.count == 2 * cfg.n_layers
    assert h.sum > 0


def test_adam8bit_perlayer_checkpoint_cross_restores_bit_for_bit():
    """The reference's 8-bit per-layer state after 4 steps, saved by the
    reference, restores in the port bit for bit (int8 codes included), and
    the port's save restores in the reference."""
    _, jp, js = _reference_run("adam8bit-fused")
    cfg = _cfgs("fused")[1]
    tree = {"params": jax.tree.map(np.asarray, jp),
            "opt_state": jax.tree.map(np.asarray, js)}
    ttree = {"params": from_jax_numpy(tree["params"], {}, device="cpu")[0],
             "opt_state": opt_state_from_jax_numpy(tree["opt_state"],
                                                   device="cpu")}
    template = tree_map(torch.zeros_like, ttree)

    def same(torch_tree, jax_tree):
        tl, jl = tree_leaves(torch_tree), jax.tree.leaves(jax_tree)
        assert len(tl) == len(jl)
        n8 = 0
        for (path, a), b in zip(tl, jl):
            b = np.asarray(b)
            assert str(a.dtype).split(".")[-1] == str(b.dtype), path
            np.testing.assert_array_equal(a.numpy(), b, err_msg=path)
            n8 += a.dtype == torch.int8
        assert n8 == 2 * len(jax.tree.leaves(jp))

    with tempfile.TemporaryDirectory() as d1, \
            tempfile.TemporaryDirectory() as d2:
        JaxCkpt(d1).save(STEPS, jax.tree.map(jnp.asarray, tree),
                         config_hash=cfg.hash())
        got, man = ckpt.CheckpointManager(d1).restore(
            template, config_hash=cfg.hash())
        assert man["step"] == STEPS
        same(got, tree)
        ckpt.CheckpointManager(d2).save(STEPS, ttree, config_hash=cfg.hash())
        back, _ = JaxCkpt(d2).restore(jax.tree.map(jnp.asarray, tree),
                                      config_hash=cfg.hash())
        same(ttree, back)


def test_perlayer_unported_options_raise():
    cfg = _cfgs("dense")[1]
    api = registry.get_api(cfg)
    opt = optimizers.make(OptimizerConfig())
    # grad_specs (the fsdp gradient placement) runs now, on the ambient
    # mesh: one sweep on the local mesh, and without one it is refused
    from repro_torch.dist import sharding
    with pytest.raises(ValueError, match="use_mesh"):
        perlayer.make_perlayer_train_step(cfg, api, opt, grad_specs={})
    mesh = sharding.make_local_mesh()
    params, consts = api.init(cfg, seed=0, device="cpu")
    state = opt.init(params)
    p_specs = sharding.param_specs(params, mesh, fsdp_axes=("data",))
    with sharding.use_mesh(mesh):
        step = perlayer.make_perlayer_train_step(
            cfg, api, opt, grad_specs=p_specs,
            state_specs=sharding.opt_state_specs(state, p_specs, mesh,
                                                 fsdp_axes=("data",)))
        toks = torch.randint(0, cfg.vocab_size, (2, 8))
        _, _, m = step(params, state, ops.add_transposed_tiles(consts),
                       {"tokens": toks})
    assert np.isfinite(float(m["loss"])) and float(m["nonfinite"]) == 0.0
    # the SSM and encoder families expose no per-layer API, and the sweep
    # refuses them as the reference's does
    for fam in ("mamba_hybrid", "xlstm", "whisper"):
        other = dataclasses.replace(cfg, family=fam)
        with pytest.raises(ValueError, match="does not expose one"):
            perlayer.make_perlayer_train_step(other, registry.get_api(other),
                                              opt)
    with pytest.raises(ValueError, match="slice API"):
        perlayer.make_perlayer_train_step(
            cfg, api, dataclasses.replace(opt, stack_state=None))


def test_perlayer_grouped_dispatch_matches_per_leaf():
    """The fused 8-bit per-layer step sends each group (the head leaves, a
    layer's slices, the deferred leaves, the embedding) through one
    ``update_group_fused`` call: its trajectory equals the per-leaf
    dispatch (``update_slice_fused`` leaf by leaf) bit for bit, losses,
    params and 8-bit state, and stays within the reference run's
    tolerances (``test_perlayer_matches_reference``)."""
    jcfg, cfg = _cfgs("fused")
    _, (tp, tc) = _port_init(jcfg)
    api = registry.get_api(cfg)
    opt = optimizers.make(OptimizerConfig(**_okw("adam8bit")))
    per_leaf = dataclasses.replace(opt, update_group_fused=None)
    calls = []
    group = ops.adam8bit_group_update

    def count(items, **kw):
        calls[-1] += 1
        return group(items, **kw)
    runs = []
    try:
        ops.adam8bit_group_update = count
        for o in (opt, per_leaf):
            calls.append(0)
            runs.append(_run_port(cfg, tp, tc,
                                  perlayer.make_perlayer_train_step(
                                      cfg, api, o), o,
                                  _batches(cfg.vocab_size)))
    finally:
        ops.adam8bit_group_update = group
    (gl, gp, gs), (ll, lp, ls) = runs
    np.testing.assert_array_equal(gl, ll)
    for (path, a), (_, b) in zip(tree_leaves(gp) + tree_leaves(gs),
                                 tree_leaves(lp) + tree_leaves(ls)):
        assert torch.equal(a, b), path
    # one call a group: head (ln_f, lm_head), each layer, the deferred
    # leaves (whose 8-bit blocks straddle layers) and the embedding
    sliced = [opt.stack_state(opt.leaf_state(gs, ("layers",) + tuple(
        path.split("/"))), leaf, cfg.n_layers) is not None
        for path, leaf in tree_leaves(gp["layers"])]
    assert calls[0] == STEPS * (1 + cfg.n_layers + int(not all(sliced)) + 1)
    n_other = len(tree_leaves(gp)) - len(sliced)
    assert calls[1] == STEPS * (n_other + sum(
        cfg.n_layers if s else 1 for s in sliced))
    want, jp, _ = _reference_run("adam8bit-fused")
    np.testing.assert_allclose(gl[:, 0], want[:, 0], rtol=0, atol=2e-5)
    np.testing.assert_allclose(gl[:, 1], want[:, 1], rtol=1e-5, atol=0)
    for (path, a), b in zip(tree_leaves(gp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4, err_msg=path)


BF16_STEPS = 8


@pytest.mark.parametrize("mode", ["global", "per_layer"])
@pytest.mark.parametrize("name", ["adamw", "adam8bit"])
def test_bf16_trajectory_matches_reference(name, mode):
    """The memory path's loss question in bf16: 8 steps at lr 3e-3 with
    one warm-up step, exec_mode dense (the reference's bf16 fused step
    does not run on the CPU), from the reference's init, against the
    reference's step of the same update mode. bf16 params round every
    update, so the two packages' last-bit differences persist: losses
    agree to 4e-3 absolute (the largest differences seen on a CPU were
    1.05e-3 with AdamW and 8.3e-4 with 8-bit AdamW, in either update
    mode, at losses near 6.5, where a bf16 ulp of a logit is 3e-2)."""
    jcfg, cfg = (dataclasses.replace(c, dtype="bfloat16")
                 for c in _cfgs("dense"))
    (jp, jc), (tp, tc) = _port_init(jcfg)
    okw = dict(name=name, lr=3e-3, warmup_steps=1, total_steps=BF16_STEPS)
    jopt = joptim.make(JOptimizerConfig(**okw))
    opt = optimizers.make(OptimizerConfig(**okw))
    jmake = jperlayer.make_perlayer_train_step if mode == "per_layer" \
        else jstep.make_train_step
    tmake = perlayer.make_perlayer_train_step if mode == "per_layer" \
        else step_lib.make_train_step
    jfn = jax.jit(jmake(jcfg, jregistry.get_api(jcfg), jopt))
    batches = _batches(cfg.vocab_size, n=BF16_STEPS)
    got, _, _ = _run_port(cfg, tp, tc, tmake(cfg, registry.get_api(cfg),
                                             opt), opt, batches)
    js, want = jopt.init(jp), []
    for toks in batches:
        jp, js, m = jfn(jp, js, jc, {"tokens": jnp.asarray(toks)})
        want.append((float(m["loss"]), float(m["nonfinite"])))
    want = np.array(want)
    assert not got[:, 2].any() and not want[:, 1].any()
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0, atol=4e-3)
