"""The gemma2, vlm and dense llama-variant families of the port against
the reference on the CPU, on the SMOKE configs of ``gemma2_2b``
(local/global windows of 32, softcaps 50/30, post-norms, GeGLU, tied
head), ``paligemma_3b`` (MQA, patch splice), ``qwen2_5_32b`` (qkv bias),
``yi_34b`` and ``llama3_405b``, in f32 from one reference init carried
over with ``from_jax_numpy``. B, the norms and the biases are drawn
non-zero (the init's zeros would hide every bug in those paths):

* forward logits in exec_mode dense and fused (the reference's Pallas
  kernels in interpret mode, the port's plain versions), the vlm family
  with numpy patch embeddings;
* prefill and per-slot decode logits and K/V on the paged and the
  contiguous cache, decoding past the window of 32;
* the paged engine's tokens with prefix sharing, tick for tick;
* 3-step trajectories from the reference's own init, global AdamW and
  per-layer 8-bit AdamW on every arch (and the other two pairings on
  gemma2; the vlm batches carry patch embeddings);
* a checkpoint of the reference's state restored by the port and back,
  bit for bit;
* gemma2's sparse supports and tile consts from the port's own init,
  bit for bit the reference's; the analytic 6·N·D counts; the registry
  and the launchers;
* the options the MoE and whisper families will call (``init_mlp``'s
  ``d_ff`` and ``gated``, the ungated ``apply_mlp``, a linear with
  ``adapted=False``), each against the reference's at one path.

Tolerances: logits and K/V 1e-4 absolute and relative (f32, sums in
another order; |logits| reach ~10 here); trajectories as
``test_torch_perlayer.py`` holds them: losses 2e-5 absolute, gradient
norms 1e-5 relative, parameters 1e-4 absolute after 3 steps (Adam moves
an element by at most lr = 1e-3 a step).
"""
import dataclasses
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import roofline as jroofline
from repro.ckpt.checkpoint import CheckpointManager as JaxCkpt
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import registry as jregistry
from repro.optim import optimizers as joptim
from repro.serve.engine import ServeEngine as JaxEngine
from repro.train import perlayer as jperlayer
from repro.train import step as jstep
from repro_torch.analysis import roofline
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.ckpt.convert import from_jax_numpy
from repro_torch.configs.base import OptimizerConfig
from repro_torch.data.pipeline import SyntheticC4
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import common, mlp, registry
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import optimizers
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import perlayer
from repro_torch.train import step as step_lib

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

ARCHS = ("gemma2_2b", "paligemma_3b", "qwen2_5_32b", "yi_34b", "llama3_405b")
TOL = 1e-4
STEPS = 3


def _cfgs(arch, exec_mode="fused", attn_kernel="paged"):
    def mk(cfg):
        return dataclasses.replace(
            cfg, dtype="float32", attn_kernel=attn_kernel,
            param=dataclasses.replace(cfg.param, exec_mode=exec_mode))
    return (mk(jregistry.get_smoke_config(arch)),
            mk(registry.get_smoke_config(arch)))


_INITS, _WEIGHTS = {}, {}


def _weights(arch, filled=True):
    """The reference's fused init of ``arch`` (tile consts and supports),
    with ``filled`` B uniform in ±1 and the norms and biases in ±0.3, as
    jax arrays and as the port's tensors (cached per arch)."""
    if arch not in _INITS:
        jcfg, _ = _cfgs(arch)
        _INITS[arch] = jregistry.get_api(jcfg).init(
            jcfg, jax.random.PRNGKey(0), seed=0)
    if (arch, filled) not in _WEIGHTS:
        params, consts = _INITS[arch]
        rng = np.random.default_rng(1)

        def fill(path, leaf):
            name = str(path[-1].key)
            if not filled:
                return np.asarray(leaf)
            if name == "B":
                return rng.uniform(-1, 1, leaf.shape).astype(np.float32)
            if name.startswith("ln") or name == "bias":
                return rng.uniform(-0.3, 0.3, leaf.shape).astype(np.float32)
            return np.asarray(leaf)

        np_params = jax.tree_util.tree_map_with_path(fill, params)
        np_consts = jax.tree.map(np.asarray, consts)
        tp, tc = from_jax_numpy(np_params, np_consts, device="cpu")
        _WEIGHTS[arch, filled] = (jax.tree.map(jnp.asarray, np_params),
                                  consts, tp, ops.add_transposed_tiles(tc))
    return _WEIGHTS[arch, filled]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _batch(cfg, toks, rng=None):
    """({tokens}, {tokens}) for the reference and the port, with the same
    seeded patch embeddings for the vlm family."""
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.family == "vlm":
        rng = rng or np.random.default_rng(7)
        pe = rng.standard_normal((toks.shape[0], cfg.n_patches,
                                  cfg.d_model)).astype(np.float32)
        jb["patches"], tb["patches"] = jnp.asarray(pe), torch.from_numpy(pe)
    return jb, tb


@pytest.mark.parametrize("exec_mode", ["dense", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, exec_mode):
    jparams, jconsts, tparams, tconsts = _weights(arch)
    jcfg, cfg = _cfgs(arch, exec_mode)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    jb, tb = _batch(cfg, toks)
    japi = jregistry.get_api(jcfg)
    jl, _ = jax.jit(lambda p, c, b: japi.apply(jcfg, p, c, b))(
        jparams, jconsts, jb)
    tl, aux = registry.get_api(cfg).apply(cfg, tparams, tconsts, tb)
    assert float(aux) == 0.0
    _close(tl, jl)
    if cfg.final_logit_softcap:
        assert float(tl.abs().max()) < cfg.final_logit_softcap
    if cfg.family == "vlm":
        # the patches replace the first n_patches positions' embeddings
        no_patch, _ = registry.get_api(cfg).apply(
            cfg, tparams, tconsts, {"tokens": tb["tokens"]})
        assert not torch.allclose(no_patch[:, 0], tl[:, 0])


@pytest.mark.parametrize("cache_kind", ["paged", "contiguous"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, cache_kind):
    """A 28-token prefill on every row, then per-slot decode steps from
    staggered positions to past 32 (gemma2's smoke window: its local
    layers mask the oldest keys), logits at each step and the K/V of
    every kind's cache at the end: the paged cache through the kernels'
    plain versions in exec_mode fused, the contiguous one in dense."""
    jparams, jconsts, tparams, tconsts = _weights(arch)
    paged = cache_kind == "paged"
    jcfg, cfg = _cfgs(arch, "fused" if paged else "dense",
                      "paged" if paged else "gather")
    japi, api = jregistry.get_api(jcfg), registry.get_api(cfg)
    n_slots, max_len, bl = 2, 48, 8
    kw = dict(paged=True, block_len=bl) if paged else {}
    jcache = japi.init_cache(jcfg, n_slots, max_len, **kw)
    cache = api.init_cache(cfg, n_slots, max_len, device="cpu", **kw)
    table = np.arange(1, 1 + n_slots * max_len // bl, dtype=np.int32
                      ).reshape(n_slots, -1)
    tbl = dict(block_table=table) if paged else {}
    jtbl = {k: jnp.asarray(v) for k, v in tbl.items()}
    ttbl = {k: torch.from_numpy(v) for k, v in tbl.items()}
    rng = np.random.default_rng(2)
    jprefill = jax.jit(functools.partial(japi.prefill_step, jcfg))
    jdecode = jax.jit(functools.partial(japi.decode_step, jcfg))

    toks = rng.integers(0, cfg.vocab_size, (n_slots, 28)).astype(np.int32)
    jl, jcache = jprefill(jparams, jconsts, jnp.asarray(toks), jcache,
                          **jtbl)
    tl, cache = api.prefill_step(cfg, tparams, tconsts,
                                 torch.from_numpy(toks), cache, **ttbl)
    _close(tl, jl)
    for step in range(7):
        pos = np.asarray([28 + step, 25 + step], np.int32)
        tok = rng.integers(0, cfg.vocab_size, (n_slots, 1)).astype(np.int32)
        jl, jcache = jdecode(jparams, jconsts, jnp.asarray(tok), jcache,
                             jnp.asarray(pos), **jtbl)
        tl, cache = api.decode_step(cfg, tparams, tconsts,
                                    torch.from_numpy(tok), cache,
                                    torch.from_numpy(pos), **ttbl)
        _close(tl, jl)
    assert sorted(cache["layers"]) == sorted(jcache["layers"])
    for kind in cache["layers"]:
        for leaf in ("k", "v"):
            _close(cache["layers"][kind][leaf], jcache["layers"][kind][leaf])


def _traffic(vocab, n=6):
    """Half the prompts open with a shared 16-token prefix, tails of 2-7
    tokens, Poisson arrivals (the launcher's traffic, fewer requests)."""
    rng = np.random.default_rng(0)
    shared = rng.integers(3, vocab, size=16).tolist()
    prompts = []
    for i in range(n):
        tail = rng.integers(3, vocab, size=int(rng.integers(2, 8))).tolist()
        prompts.append(shared + tail if i % 2 == 0 else tail)
    return prompts, np.cumsum(rng.poisson(2.0, size=n))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_with_prefix_sharing_matches_reference(arch):
    """Tokens, ticks and prefill traffic of the paged engine, the
    prefix-shared admissions through ``paged_prefill`` and decodes to
    position ~35 (past gemma2's smoke window)."""
    jparams, jconsts, tparams, tconsts = _weights(arch)
    jcfg, cfg = _cfgs(arch)
    prompts, arrivals = _traffic(cfg.vocab_size)
    kw = dict(n_slots=4, max_len=64, paged=True, block_len=16,
              prefix_sharing=True)
    runs = []
    for e in (JaxEngine(jcfg, jparams, jconsts, **kw),
              ServeEngine(cfg, tparams, tconsts, device="cpu", **kw)):
        reqs = [e.submit(p, max_new_tokens=12, arrival=int(a))
                for p, a in zip(prompts, arrivals)]
        stats = e.run_stream()
        assert not stats["exhausted"]
        runs.append(([(r.uid, r.status, r.out, r.t_first, r.t_done)
                      for r in reqs], dict(e.prefill_traffic)))
    assert runs[1] == runs[0]
    assert runs[1][1]["tokens_shared"] > 0


# (arch, update_mode, optimizer, exec_mode): every arch global AdamW
# (exec_mode dense) and per-layer 8-bit AdamW (fused: the kernel
# dispatch); gemma2 also the other two pairings
TRAJECTORIES = [(a, "global", "adamw", "dense") for a in ARCHS] + \
    [(a, "per_layer", "adam8bit", "fused") for a in ARCHS] + \
    [("gemma2_2b", "global", "adam8bit", "fused"),
     ("gemma2_2b", "per_layer", "adamw", "dense")]


def _okw(name):
    return dict(name=name, lr=1e-3, warmup_steps=1, total_steps=STEPS,
                weight_decay=0.1)


@pytest.mark.parametrize("arch, mode, opt, exec_mode", TRAJECTORIES)
def test_trajectories_match_reference(arch, mode, opt, exec_mode):
    """From the reference's own init (B = 0 and gemma's zero norms, as
    ``test_torch_perlayer.py`` starts): with B drawn, a gradient element
    that cancels to ~1e-8 in both packages (a few ulps apart) meets Adam's
    eps = 1e-8 and its first update differs by a fraction of lr."""
    jparams, jconsts, tparams, tconsts = _weights(arch, filled=False)
    jcfg, cfg = _cfgs(arch, exec_mode)
    jopt = joptim.make(JOptimizerConfig(**_okw(opt)))
    topt = optimizers.make(OptimizerConfig(**_okw(opt)))
    japi, api = jregistry.get_api(jcfg), registry.get_api(cfg)
    if mode == "global":
        jfn = jstep.make_train_step(jcfg, japi, jopt)
        tfn = step_lib.make_train_step(cfg, api, topt)
    else:
        jfn = jperlayer.make_perlayer_train_step(jcfg, japi, jopt)
        tfn = perlayer.make_perlayer_train_step(cfg, api, topt)
    jfn = jax.jit(jfn)
    data = SyntheticC4(cfg.vocab_size, 24, 2, seed=0)
    rng = np.random.default_rng(5)
    jp, js = jparams, jopt.init(jparams)
    tp = tree_map(lambda t: t.clone(), tparams)
    ts = topt.init(tp)
    for _ in range(STEPS):
        jb, tb = _batch(cfg, data.next_batch()["tokens"], rng)
        jp, js, jm = jfn(jp, js, jconsts, jb)
        tp, ts, tm = tfn(tp, ts, tconsts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   atol=2e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        assert float(tm["nonfinite"]) == float(jm["nonfinite"]) == 0.0
    want = dict(tree_leaves(jax.tree.map(np.asarray, jp)))
    for path, leaf in tree_leaves(tp):
        _close(leaf, want[path])


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_crosses_packages_bit_for_bit(arch):
    """The reference's params and 8-bit AdamW state (every k{j} stack,
    post-norms, biases, the tied embedding) saved by the reference load
    into the port leaf for leaf, and the port's save loads back into the
    reference."""
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
        for p in want:
            np.testing.assert_array_equal(have[p], want[p])
        ckpt.CheckpointManager(d2).save(2, got, config_hash=cfg.hash())
        back, _ = JaxCkpt(d2).restore(jtree, config_hash=cfg.hash())
        for p, v in tree_leaves(jax.tree.map(np.asarray, back)):
            np.testing.assert_array_equal(v, want[p])


def test_gemma2_supports_match_reference_bit_for_bit():
    """The port's own init of the gemma2 smoke config (both kinds' stacks)
    samples every support and tile const as the reference does, and
    builds the same tree of params."""
    jcfg, cfg = _cfgs("gemma2_2b")
    jp, jc = jregistry.get_api(jcfg).init(jcfg, jax.random.PRNGKey(0),
                                          seed=11)
    tp, tc = registry.get_api(cfg).init(cfg, seed=11, device="cpu")
    want = dict(tree_leaves(jax.tree.map(np.asarray, jc)))
    have = dict(tree_leaves(tc))
    assert sorted(have) == sorted(want)
    assert any("/k1/" in p for p in have)
    for p, v in want.items():
        np.testing.assert_array_equal(have[p].numpy(), v)
    jshapes = {p: v.shape for p, v in tree_leaves(jax.tree.map(np.asarray,
                                                               jp))}
    assert {p: tuple(v.shape) for p, v in tree_leaves(tp)} == jshapes
    # zero-initialized gemma norms, as the reference's
    for p, v in tree_leaves(tp):
        if p.split("/")[-1].startswith("ln"):
            assert not v.any(), p


def _fill_b(tree, rng):
    """The reference's params as numpy, with every B uniform in ±1."""
    def fill(path, leaf):
        if str(path[-1].key) == "B":
            return rng.uniform(-1, 1, leaf.shape).astype(np.float32)
        return np.asarray(leaf)
    return jax.tree_util.tree_map_with_path(fill, tree)


# (d_ff, gated, act): a d_ff of its own with a gate (the MoE experts'),
# GeGLU at the config's d_ff, and the ungated GELU block (whisper's)
MLP_OPTIONS = [(24, True, "silu"), (0, True, "gelu"), (0, False, "gelu")]


@pytest.mark.parametrize("d_ff, gated, act", MLP_OPTIONS)
def test_mlp_options_match_reference(d_ff, gated, act):
    """``init_mlp(d_ff=, gated=)`` builds the reference's tree at one path
    (supports and tile consts bit for bit, params shape for shape), and
    ``apply_mlp`` with the reference's weights gives its output, gated or
    not, in exec_mode fused."""
    jcfg, cfg = _cfgs("gemma2_2b")
    jp, jc = jmlp.init_mlp(jcommon.Builder(jcfg, jax.random.PRNGKey(0),
                                           "/mlp", seed=5), jcfg,
                           d_ff=d_ff, gated=gated)
    tp, tc = mlp.init_mlp(common.Builder(cfg, torch.Generator(), "cpu",
                                         "/mlp", seed=5), cfg,
                          d_ff=d_ff, gated=gated)
    want = dict(tree_leaves(jax.tree.map(np.asarray, jc)))
    assert sorted(dict(tree_leaves(tc))) == sorted(want)
    for path, v in tree_leaves(tc):
        np.testing.assert_array_equal(v.numpy(), want[path])
    assert {p: tuple(v.shape) for p, v in tree_leaves(tp)} == \
        {p: v.shape for p, v in tree_leaves(jax.tree.map(np.asarray, jp))}
    assert ("gate" in tp) == gated
    rng = np.random.default_rng(2)
    np_params = _fill_b(jp, rng)
    tparams, tconsts = from_jax_numpy(np_params, jax.tree.map(np.asarray, jc),
                                      device="cpu")
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want_y = jax.jit(lambda p, c, x: jmlp.apply_mlp(jcfg, p, c, x, act=act))(
        jax.tree.map(jnp.asarray, np_params), jc, jnp.asarray(x))
    _close(mlp.apply_mlp(cfg, tparams, ops.add_transposed_tiles(tconsts),
                         torch.from_numpy(x), act=act), want_y)


def test_unadapted_linear_matches_reference():
    """``Builder.linear(adapted=False)`` in SLTrain mode stays full rank,
    as the reference's (its MoE router): a ``w`` of the same shape and no
    consts; ``apply_linear(adapted=False)`` with the reference's ``w``
    gives its output."""
    jcfg, cfg = _cfgs("gemma2_2b")
    assert cfg.param.mode == "sltrain"
    d, n = cfg.d_model, 8
    jp, jc = jcommon.Builder(jcfg, jax.random.PRNGKey(0), "/moe",
                             seed=5).linear("router", d, n, adapted=False)
    tp, tc = common.Builder(cfg, torch.Generator(), "cpu", "/moe",
                            seed=5).linear("router", d, n, adapted=False)
    assert jc == {} and tc == {}
    assert set(tp) == set(jp) == {"w"} and tuple(tp["w"].shape) == (d, n)
    x = np.random.default_rng(4).standard_normal((3, d)).astype(np.float32)
    w = np.array(jp["w"])
    want = jax.jit(lambda p, x: jcommon.apply_linear(jcfg, p, {}, x,
                                                     adapted=False))(
        {"w": jnp.asarray(w)}, jnp.asarray(x))
    _close(common.apply_linear(cfg, {"w": torch.from_numpy(w)}, {},
                               torch.from_numpy(x), adapted=False), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    assert roofline.param_count_active(cfg) == \
        jroofline.param_count_active(jcfg)
    assert roofline.model_flops(cfg, 2048) == jroofline.model_flops(jcfg,
                                                                    2048)
    assert cfg.hash() == jcfg.hash()
    assert registry.get_smoke_config(arch).hash() == \
        jregistry.get_smoke_config(arch).hash()


def test_waiting_families_raise_with_their_roadmap_item():
    """The SSM and encoder archs (ROADMAP item 9) load now, and get_api
    returns their families' APIs, without prefill_step or the per-layer
    API, as the reference's; QK-norm and experts on a llama-family config
    (the MoE slice's options) init."""
    from repro_torch.models import mamba2, whisper, xlstm
    for arch, fam, mod in (("zamba2_7b", "mamba_hybrid", mamba2),
                           ("xlstm_350m", "xlstm", xlstm),
                           ("whisper_large_v3", "whisper", whisper)):
        cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
        assert cfg.family == fam and cfg.hash() == jcfg.hash()
        api, japi = registry.get_api(cfg), jregistry.get_api(jcfg)
        assert api.init.__module__ == mod.__name__
        assert (api.prefill_step, api.perlayer) == (None, None) == \
            (japi.prefill_step, japi.perlayer)
    cfg = registry.get_smoke_config("qwen2_5_32b")
    for ok in (dataclasses.replace(cfg, qk_norm=True),
               dataclasses.replace(cfg, moe=dataclasses.replace(
                   cfg.moe, n_experts=4))):
        params, _ = registry.get_api(ok).init(ok, device="cpu")
        blk = params["layers"]["k0"]
        assert ("q_norm" in blk["attn"]) == ok.qk_norm
        assert ("moe" in blk) == (ok.moe.n_experts > 0)
    with pytest.raises(ValueError, match="unknown family"):
        registry.get_api(dataclasses.replace(cfg, family="rwkv"))


@pytest.mark.parametrize("arch", ["gemma2_2b", "paligemma_3b"])
def test_launchers_run_the_smoke_configs(arch, capsys):
    with tempfile.TemporaryDirectory() as d:
        train_launch.main(["--arch", arch, "--smoke", "--steps", "2",
                           "--batch", "2", "--seq", "16", "--device", "cpu",
                           "--exec-mode", "fused", "--ckpt-dir", d])
    serve_launch.main(["--arch", arch, "--smoke", "--paged",
                       "--prefix-sharing", "--requests", "3", "--slots", "2",
                       "--max-len", "48", "--new-tokens", "4", "--device",
                       "cpu"])
    out = capsys.readouterr().out
    assert "step 2" in out or "step=2" in out, out[-500:]
