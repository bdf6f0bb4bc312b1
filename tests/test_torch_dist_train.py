"""The port's ``Trainer`` on a mesh against one process and against the
reference, on gloo worlds of spawned CPU ranks (``_torch_dist_ranks``):
the whole 12-way support matrix of ``configs/base.py`` (update_mode
global | per_layer × exec_mode dense | sparse | fused × fsdp off | on)
on ``llama_60m`` SMOKE in f32, spread over the meshes (model 2), (data 2,
model 2), (data 2, model 2) with fsdp and (model 4), plus runs at a
widened SMOKE (d_model 256, d_ff 512) where the fused and sparse linears'
TP islands engage, grad_accum 2, and int8 pod compression on (pod 2)
against the reference's per-pod gradients combined by its ``int8_psum``
under ``jax.vmap``. Each run's 3 losses and gradient norms follow
``tests/_torch_parity.py``'s step-wise gates, and its gathered params and
8-bit codes are held to the one-process run's and the reference's.
Then checkpoints across meshes (both ways, and the reference's
``arrays.npz`` onto a mesh) and the launcher's ``--multipod`` on a world
of 2 started as ``torchrun`` starts one."""
import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_ranks import run_world
from _torch_parity import _fill
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.dist import compression as jcomp
from repro.models import registry as jregistry
from repro.optim import optimizers as joptim
from repro.train import step as jstep
from repro_torch.ckpt.convert import from_jax_numpy
from repro_torch.data.pipeline import SyntheticC4
from repro_torch.models.common import tree_leaves

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, STEPS, BATCH, SEQ, SEED = 1e-3, 3, 4, 16, 42
# step 1 from identical params agrees to f32 sums; later steps to 1e-3
# (Adam moves an element whose gradient is near zero by up to lr either
# way), as tests/_torch_parity.py gates trajectories
STEP1, LATER = 5e-5, 1e-3
TOL = 1e-4
WIDE = dict(d_model=256, d_ff=512)
# 8-bit state: f32 sums in another order round a share of the codes the
# other way, and after 3 steps the trajectories have moved those
# elements apart. One-process runs of one config in exec_mode sparse and
# dense (the same math, summed in another order) differ in up to 2.54%
# of a leaf's codes here (fused and dense in up to 0.62%); a run on a
# mesh is held to 3% against the one-process run of its exec mode
CODES_SHARE = 3e-2
# int8 pod compression against the reference: the int8 sums are the
# same bits for the same per-pod gradients (tests/test_torch_dist.py),
# but the two packages' per-pod gradients differ by f32 rounding (up to
# 2.6e-5 relative here), which moves blocks' shared scales and rounds
# some codes the other way: a leaf's summed gradient moves by up to
# ~1.2e-3 of its norm, the gradient norm by 3.2e-4 at step 1. Gated at
# INT8_STEP1 at step 1 and INT8_LATER after; params within TOL for all
# but INT8_SHARE of the elements
INT8_STEP1, INT8_LATER, INT8_SHARE = 1e-3, 1e-2, 1e-2

# (id, mesh shape, axis names, exec_mode, update_mode, optimizer, fsdp,
#  wide, grad_accum)
CASES = [
    ("model2 global dense adamw", (1, 2), ("data", "model"), "dense",
     "global", "adamw", False, False, 1),
    ("model2 per_layer fused adam8bit", (1, 2), ("data", "model"), "fused",
     "per_layer", "adam8bit", False, False, 1),
    ("model2 wide global fused adamw", (1, 2), ("data", "model"), "fused",
     "global", "adamw", False, True, 1),
    ("model2 wide global sparse adam8bit", (1, 2), ("data", "model"),
     "sparse", "global", "adam8bit", False, True, 1),
    ("data2 model2 global fused adamw", (2, 2), ("data", "model"), "fused",
     "global", "adamw", False, False, 1),
    ("data2 model2 per_layer sparse adamw", (2, 2), ("data", "model"),
     "sparse", "per_layer", "adamw", False, False, 1),
    ("fsdp global dense adam8bit", (2, 2), ("data", "model"), "dense",
     "global", "adam8bit", True, False, 1),
    ("fsdp global sparse adamw", (2, 2), ("data", "model"), "sparse",
     "global", "adamw", True, False, 1),
    ("fsdp global fused adam8bit", (2, 2), ("data", "model"), "fused",
     "global", "adam8bit", True, False, 1),
    ("fsdp per_layer dense adam8bit", (2, 2), ("data", "model"), "dense",
     "per_layer", "adam8bit", True, False, 1),
    ("fsdp per_layer sparse adam8bit", (2, 2), ("data", "model"), "sparse",
     "per_layer", "adam8bit", True, False, 1),
    ("fsdp per_layer fused adamw", (2, 2), ("data", "model"), "fused",
     "per_layer", "adamw", True, False, 1),
    ("fsdp wide per_layer fused adam8bit", (2, 2), ("data", "model"),
     "fused", "per_layer", "adam8bit", True, True, 1),
    ("fsdp global fused adamw grad_accum 2", (2, 2), ("data", "model"),
     "fused", "global", "adamw", True, False, 2),
    ("fsdp per_layer fused adam8bit grad_accum 2", (2, 2),
     ("data", "model"), "fused", "per_layer", "adam8bit", True, True, 2),
    ("model4 global sparse adam8bit", (1, 4), ("data", "model"), "sparse",
     "global", "adam8bit", False, False, 1),
    ("model4 per_layer dense adamw", (1, 4), ("data", "model"), "dense",
     "per_layer", "adamw", False, False, 1),
    ("model4 wide global fused adamw", (1, 4), ("data", "model"), "fused",
     "global", "adamw", False, True, 1),
]


def _cfgs(exec_mode, wide):
    """(reference, port) llama_60m SMOKE in f32 with ``exec_mode``, at the
    widened width with ``wide``."""
    from repro_torch.models import registry

    def mk(c):
        c = dataclasses.replace(c, dtype="float32", **(WIDE if wide else {}))
        return dataclasses.replace(c, param=dataclasses.replace(
            c.param, exec_mode=exec_mode))
    return (mk(jregistry.get_smoke_config("llama_60m")),
            mk(registry.get_smoke_config("llama_60m")))


def _optim(name):
    return dict(name=name, lr=LR, warmup_steps=1, total_steps=STEPS,
                weight_decay=0.1)


def _tc(cfg, optimizer, update_mode, fsdp, grad_accum, ckpt_dir,
        compression=False, steps=STEPS):
    from repro_torch.configs.base import (OptimizerConfig, ShardingConfig,
                                          TrainConfig)
    return TrainConfig(
        model=cfg, optim=OptimizerConfig(**_optim(optimizer)),
        sharding=ShardingConfig(update_mode=update_mode, fsdp=fsdp,
                                grad_accum=grad_accum,
                                pod_grad_compression=compression),
        seed=SEED, global_batch=BATCH, seq_len=SEQ, steps=steps,
        log_every=100, ckpt_every=0, ckpt_dir=ckpt_dir, async_ckpt=False)


_INITS = {}


def _init(wide):
    """The reference's fused init (its supports and tile consts), B drawn
    in ±0.5 and zero leaves filled as tests/_torch_parity.py fills them:
    (reference params, reference consts, port params and consts as numpy
    trees)."""
    if wide not in _INITS:
        jcfg, _ = _cfgs("fused", wide)
        params, consts = jregistry.get_api(jcfg).init(
            jcfg, jax.random.PRNGKey(0), seed=0)
        np_params = jax.tree_util.tree_map_with_path(
            _fill(np.random.default_rng(1)), params)
        tp, tc = from_jax_numpy(np_params, jax.tree.map(np.asarray, consts),
                                device="cpu")
        to_np = lambda t: {k: to_np(v) for k, v in t.items()} \
            if isinstance(t, dict) else t.numpy()
        _INITS[wide] = (jax.tree.map(jnp.asarray, np_params), consts,
                        to_np(tp), to_np(tc))
    return _INITS[wide]


def _torch_tree(t):
    return {k: _torch_tree(v) for k, v in t.items()} if isinstance(t, dict) \
        else torch.from_numpy(np.array(t))


def _batches(cfg, steps=STEPS):
    data = SyntheticC4(cfg.vocab_size, SEQ, BATCH, seed=SEED)
    return [data.next_batch()["tokens"] for _ in range(steps)]


def _train(case, init, mesh, ckpt_dir, compression=False):
    """One case's Trainer run from ``init`` (the port's params and consts
    as numpy) on ``mesh`` (None: one process): (rows, the gathered params
    and 8-bit codes as numpy, or None off rank 0)."""
    from repro_torch.train.trainer import Trainer
    _, _, _, mode, um, opt, fsdp, wide, ga = case
    _, cfg = _cfgs(mode, wide)
    tr = Trainer(_tc(cfg, opt, um, fsdp, ga, ckpt_dir, compression),
                 device="cpu", mesh=mesh, log_fn=lambda *a: None)
    tr.save = lambda *a, **k: None
    state = tr.run(state=tr.state_from(_torch_tree(init[0]),
                                       _torch_tree(init[1])))
    rows = [(h["loss"], h["grad_norm"], h["nonfinite"])
            for h in tr.metrics_history]
    params, opt_state = tr.full_state(state)
    if mesh is not None and mesh.rank != 0:
        return rows, None
    codes = {p: t.numpy() for p, t in tree_leaves(opt_state)
             if p.endswith("codes")}
    return rows, ({p: t.numpy() for p, t in tree_leaves(params)}, codes)


def _world_rank(rank, world, shape, names, cases, inits, tmp):
    from repro_torch.dist import compat
    mesh = compat.make_mesh(shape, names)
    return [_train(c, inits[c[7]], mesh, os.path.join(tmp, f"ck{i}"))
            for i, c in enumerate(cases)]


def _ref_rows(wide, optimizer):
    """The reference's single-device trajectory (its jitted global step,
    exec_mode dense) from the same init and batches: rows and params."""
    jcfg, _ = _cfgs("dense", wide)
    jparams, jconsts, _, _ = _init(wide)
    jopt = joptim.make(JOptimizerConfig(**_optim(optimizer)))
    fn = jax.jit(jstep.make_train_step(jcfg, jregistry.get_api(jcfg), jopt))
    p, s = jparams, jopt.init(jparams)
    rows = []
    for toks in _batches(jcfg):
        p, s, m = fn(p, s, jconsts, {"tokens": jnp.asarray(toks)})
        rows.append((float(m["loss"]), float(m["grad_norm"]),
                     float(m["nonfinite"])))
    flat = jax.tree_util.tree_flatten_with_path(p)[0]
    return rows, {"/".join(str(k.key) for k in path): np.asarray(v)
                  for path, v in flat}


def _same_rows(got, want, what, step1=STEP1, later=LATER):
    for i, (g, w) in enumerate(zip(got, want)):
        tol = step1 if i == 0 else later
        for k, name in ((0, "loss"), (1, "grad_norm")):
            assert abs(g[k] - w[k]) <= tol * abs(w[k]), \
                (what, i + 1, name, g[k], w[k])
        assert g[2] == w[2] == 0.0, (what, i + 1)


def _same_params(got, want, what, share=1e-3):
    """Every element within 2·lr·STEPS (Adam's sign of a near-zero
    gradient), all but ``share`` of them within TOL + TOL·|w|."""
    off = total = 0
    for path, w in want.items():
        d = np.abs(got[path] - w)
        assert d.max() <= 2 * LR * STEPS, (what, path, d.max())
        off += int((d > TOL + TOL * np.abs(w)).sum())
        total += d.size
    assert off <= share * total, (what, off, total)


@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    """{case id: (mesh rows on each rank, rank 0's params and codes,
    one-process rows, params and codes)}: one world per mesh."""
    tmp = tmp_path_factory.mktemp("matrix")
    inits = {w: _init(w)[2:] for w in (False, True)}
    out = {}
    by_mesh = {}
    for c in CASES:
        by_mesh.setdefault((c[1], c[2]), []).append(c)
    for (shape, names), cases in by_mesh.items():
        res = run_world(int(np.prod(shape)), _world_rank, tmp, shape, names,
                        cases, inits, str(tmp))
        for i, c in enumerate(cases):
            one = _train(c, inits[c[7]], None, str(tmp / f"one{i}"))
            out[c[0]] = ([r[i][0] for r in res], res[0][i][1], one)
    return out


_REFS = {}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_trainer_on_mesh_matches_one_process_and_reference(case, matrix):
    """Every rank reports the same metrics; the run's losses and gradient
    norms match the one-process port run's and the reference's
    single-device trajectory step by step; its gathered params match the
    one-process run's (the same gate) and the reference's; 8-bit codes
    differ from the one-process run's in at most CODES_SHARE of a leaf's
    codes (f32 sums in another order round some codes the other way)."""
    name, _, _, mode, um, opt, fsdp, wide, ga = case
    ranks, (params, codes), (one_rows, (one_params, one_codes)) = \
        matrix[name]
    assert all(r == ranks[0] for r in ranks), name
    _same_rows(ranks[0], one_rows, name + " vs one process")
    key = (wide, opt)
    if key not in _REFS:
        _REFS[key] = _ref_rows(wide, opt)
    ref_rows, ref_params = _REFS[key]
    _same_rows(ranks[0], ref_rows, name + " vs reference")
    _same_params(params, one_params, name + " params vs one process")
    _same_params(params, ref_params, name + " params vs reference")
    for path, c in one_codes.items():
        assert (codes[path] != c).mean() <= CODES_SHARE, (name, path)


def _pod_rank(rank, world, init, tmp):
    from repro_torch.dist import compat
    mesh = compat.make_mesh((2,), ("pod",))
    return _train(("pod2", None, None, "fused", "global", "adamw", False,
                   False, 1), init, mesh, tmp, compression=True)


def test_pod_compression_matches_reference_int8(tmp_path):
    """(pod 2) with pod_grad_compression: the reference's compressed step
    shards over the pod axis alone; its per-pod gradients (jax.grad of
    the reference's loss on each pod's rows) combined by its int8_psum
    under jax.vmap, divided by n_pods, and its optimizer give the port's
    losses, gradient norms and params (the int8 sums are the same bits;
    only f32 sums differ, which the int8 grid can round a code apart: the
    INT8_* gates)."""
    jcfg, _ = _cfgs("dense", False)
    jparams, jconsts, tp, tc = _init(False)
    res = run_world(2, _pod_rank, tmp_path, (tp, tc),
                    str(tmp_path / "ck"))
    jopt = joptim.make(JOptimizerConfig(**_optim("adamw")))
    api = jregistry.get_api(jcfg)
    loss_fn = jstep.make_loss_fn(jcfg, api)
    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    @jax.jit
    def update(p, s, loss, per_pod):
        grads = jax.vmap(lambda g: jcomp.psum_tree(g, "pod"),
                         axis_name="pod")(per_pod)
        grads = jax.tree.map(lambda g: g[0] / 2, grads)
        new_p, new_s, stats = jopt.update(grads, s, p)
        return new_p, new_s, stats["grad_norm"]

    p, s = jparams, jopt.init(jparams)
    rows = []
    for toks in _batches(jcfg):
        per, losses = [], []
        for half in (toks[:BATCH // 2], toks[BATCH // 2:]):
            (loss, _), g = vg(p, jconsts, {"tokens": jnp.asarray(half)})
            per.append(g)
            losses.append(float(loss))
        stacked = jax.tree.map(lambda a, b: jnp.stack([a, b]), *per)
        p, s, gn = update(p, s, None, stacked)
        rows.append((sum(losses) / 2, float(gn), 0.0))
    flat = jax.tree_util.tree_flatten_with_path(p)[0]
    want = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in flat}
    assert res[0][0] == res[1][0]
    _same_rows(res[0][0], rows, "pod 2 int8 vs reference", INT8_STEP1,
               INT8_LATER)
    _same_params(res[0][1][0], want, "pod 2 int8 params vs reference",
                 INT8_SHARE)


# ---------------------------------------------------------------------------
# Checkpoints across meshes
# ---------------------------------------------------------------------------

def _ckpt_cfg():
    return _cfgs("fused", False)[1]


def _ckpt_rank(rank, world, shape, names, init, ckpt_dir, steps, write):
    """Train ``steps`` steps on ``shape`` (fsdp, 8-bit) from ``init`` and
    write the checkpoint, or restore the newest one: the gathered params
    and state as numpy (rank 0)."""
    from repro_torch.dist import compat
    from repro_torch.train.trainer import Trainer
    mesh = compat.make_mesh(shape, names) if shape else None
    tr = Trainer(_tc(_ckpt_cfg(), "adam8bit", "per_layer", True, 1,
                     ckpt_dir, steps=steps), device="cpu", mesh=mesh,
                 log_fn=lambda *a: None)
    if write:
        state = tr.run(state=tr.state_from(_torch_tree(init[0]),
                                           _torch_tree(init[1])))
    else:
        state = tr.restore_or_init()
    params, opt_state = tr.full_state(state)
    if mesh is not None and mesh.rank != 0:
        return None
    return state.step, {p: t.numpy() for p, t in tree_leaves(
        {"params": params, "opt_state": opt_state})}


def _ckpt(shape, names, init, ckpt_dir, write, tmp):
    if shape is None:
        return _ckpt_rank(0, 1, None, None, init, ckpt_dir, 2, write)
    return run_world(int(np.prod(shape)), _ckpt_rank, tmp, shape, names,
                     init, ckpt_dir, 2, write)[0]


@pytest.mark.parametrize("writer,reader", [
    (((2, 2), ("data", "model")), None),
    (((2, 2), ("data", "model")), ((1, 2), ("data", "model"))),
    (None, ((2, 2), ("data", "model")))],
    ids=["data2xmodel2 to one process", "data2xmodel2 to model2",
         "one process to data2xmodel2"])
def test_checkpoint_round_trips_across_meshes(writer, reader, tmp_path):
    """A checkpoint holds the gathered full leaves, written once (rank 0):
    what one mesh (fsdp, per-layer 8-bit state sharded over data) wrote,
    another mesh or one process restores bit for bit, params and
    optimizer state, and the reverse."""
    _, _, tp, tc = _init(False)
    ck = str(tmp_path / "ck")
    w = _ckpt(*(writer or (None, None)), (tp, tc), ck, True, tmp_path)
    r = _ckpt(*(reader or (None, None)), (tp, tc), ck, False, tmp_path)
    assert w[0] == r[0] == 2
    assert sorted(w[1]) == sorted(r[1])
    for k, v in w[1].items():
        np.testing.assert_array_equal(r[1][k], v, err_msg=k)


def _restore_rank(rank, world, ckpt_dir):
    return _ckpt_rank(rank, world, (1, 2), ("data", "model"), None,
                      ckpt_dir, 2, False)


def test_reference_checkpoint_restores_onto_a_mesh(tmp_path):
    """The reference's arrays.npz (its CheckpointManager, params and its
    per-layer 8-bit state) restores onto a (model 2) mesh: every gathered
    leaf equals the reference's bit for bit."""
    from repro.ckpt.checkpoint import CheckpointManager as JCkpt
    jcfg = _cfgs("fused", False)[0]
    jparams, _, _, _ = _init(False)
    jopt = joptim.make(JOptimizerConfig(**_optim("adam8bit")))
    state = jopt.init(jparams)
    ck = str(tmp_path / "ck")
    JCkpt(ck).save(2, {"params": jparams, "opt_state": state},
                   config_hash=jcfg.hash(),
                   extra={"data": SyntheticC4(jcfg.vocab_size, SEQ, BATCH,
                                              seed=SEED).state_dict()})
    step, got = run_world(2, _restore_rank, tmp_path, ck)[0]
    flat = jax.tree_util.tree_flatten_with_path(
        {"params": jparams, "opt_state": state})[0]
    want = {"/".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(v) for path, v in flat}
    assert step == 2 and sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_launcher_multipod_runs_a_world_of_two(tmp_path):
    """``python -m repro_torch.launch.train --multipod`` in two processes
    with the environment ``torchrun --nproc-per-node 2`` gives them
    (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) trains one
    step data-parallel over the world (gloo on the CPU), each rank
    reporting the same loss, and rank 0 writes the checkpoint."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE="2", OMP_NUM_THREADS="1")
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--multipod",
            "--smoke", "--steps", "1", "--batch", "2", "--seq", "8",
            "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")]
    procs = [subprocess.Popen(argv, cwd=ROOT, env=dict(
        env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    finals = [[ln for ln in out.splitlines() if ln.startswith("final step")]
              for out, _ in outs]
    assert finals[0] == finals[1] and finals[0][0].startswith("final step 1")
    assert os.listdir(tmp_path / "ck") == ["step_00000001"]
