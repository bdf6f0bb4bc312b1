"""The port's fault injection (``repro_torch.resilience.chaos``), its
wiring into the Trainer, the launchers' ``--chaos`` and
``--jax-profile-dir``, and ``Trace(profile_dir=)``, against the
reference on the llama_60m smoke config in f32:

* ``parse`` and its rejections on the reference's own cases
  (``tests/test_fault_tolerance.py``), fire-once, and the keyed draws —
  ``corrupt_batch``'s rows, ``corrupt_npz``'s offset and bytes,
  ``serve_hook``'s stalled slot — bit for bit;
* ``kill@4`` and a relaunch end bit-identical to an uninterrupted port
  run, in exec_mode dense and fused; in dense, each step's loss tracks
  the reference Trainer's chaos run from the same weights (step 1 within
  1e-5, later steps within 1e-3, relative); the reference's fused case
  fails on this tree (ROADMAP queue C), so fused is held only against the
  port's own run;
* the fault-matrix run (kill, data_corrupt, straggler, ckpt_corrupt,
  nonfinite over a relaunch with one registry) ends with the reference's
  recovery counters;
* the launchers: the serve launcher without ``--paged`` prints the
  reference launcher's tokens on one checkpoint in exec_mode dense; the
  profiler hook writes a loadable Chrome trace.
"""
import contextlib
import dataclasses
import io
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpoints
from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.configs.base import TrainConfig as JTrainConfig
from repro.launch import serve as jserve
from repro.models import registry as jregistry
from repro.obs import metrics as jmetrics
from repro.resilience import chaos as jchaos
from repro.train.trainer import Trainer as JaxTrainer
from repro_torch.ckpt.convert import from_jax_numpy
from repro_torch.configs.base import OptimizerConfig, TrainConfig
from repro_torch.kernels.ops import add_transposed_tiles
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.optim.optimizers import tree_leaves
from repro_torch.resilience import chaos
from repro_torch.train.trainer import Trainer, TrainerState

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec,seed", [
    ("kill@3,nonfinite@5,straggler@4:50", 7), ("kill@1", 0),
    (" stall@4:8 , ckpt_corrupt@2,", 3), ("data_corrupt@0", 11)])
def test_parse_matches_reference(spec, seed):
    got = chaos.ChaosEngine.parse(spec, seed=seed)
    want = jchaos.ChaosEngine.parse(spec, seed=seed)
    assert [(f.kind, f.at, f.arg) for f in got.faults] == \
        [(f.kind, f.at, f.arg) for f in want.faults]
    assert got.wants_poison == want.wants_poison
    assert got.seed == want.seed


@pytest.mark.parametrize("bad", ["frobnicate@3", "kill", "kill@x", ""])
def test_parse_rejects_the_reference_bad_specs(bad):
    with pytest.raises(ValueError) as jerr:
        jchaos.ChaosEngine.parse(bad)
    with pytest.raises(ValueError) as err:
        chaos.ChaosEngine.parse(bad)
    assert str(err.value) == str(jerr.value)


def test_faults_fire_at_most_once():
    eng = chaos.ChaosEngine.parse("nonfinite@3")
    assert eng.poison_scale(2) == 1.0
    assert np.isnan(eng.poison_scale(5))     # first opportunity at/after 3
    assert eng.poison_scale(5) == 1.0        # never again
    k = chaos.ChaosEngine.parse("kill@0")
    with pytest.raises(SystemExit) as ei:
        k.train_hook(0)
    assert ei.value.code == chaos.ChaosKill.EXIT_CODE == 43
    k.train_hook(0)                          # already fired: no-op
    reg = obs_metrics.Registry()
    s = chaos.ChaosEngine.parse("straggler@1:1,straggler@2:1")
    s.bind(reg)
    for step in range(4):
        s.straggle(step)
    assert reg.snapshot()["resilience.faults_injected{kind=straggler}"][
        "value"] == 2


@pytest.mark.parametrize("seed", [0, 5, 123])
def test_corrupt_batch_matches_reference(seed):
    rng = np.random.default_rng(seed)
    spec = "data_corrupt@2,data_corrupt@6"
    got, want = (mod.ChaosEngine.parse(spec, seed=seed)
                 for mod in (chaos, jchaos))
    for step in range(8):
        batch = {"tokens": rng.integers(0, 512, (5, 17)).astype(np.int32)}
        a, b = got.corrupt_batch(step, batch), want.corrupt_batch(step, batch)
        assert a["tokens"].dtype == b["tokens"].dtype
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        assert (a is batch) == (b is batch)


@pytest.mark.parametrize("seed", [0, 9, 2024])
def test_corrupt_npz_matches_reference(tmp_path, seed):
    src = tmp_path / "arrays.npz"
    np.savez(src, w=np.arange(4096, dtype=np.float32))
    copies = [tmp_path / "a.npz", tmp_path / "b.npz"]
    for c in copies:
        shutil.copy(src, c)
    off = chaos.corrupt_npz(str(copies[0]), seed=seed)
    joff = jchaos.corrupt_npz(str(copies[1]), seed=seed)
    assert off == joff
    assert copies[0].read_bytes() == copies[1].read_bytes() != \
        src.read_bytes()


class _FakeEngine:
    """What ``serve_hook`` reads of an engine, and a record of its
    stall_slot calls."""

    def __init__(self, paged, occupied, clock, n_slots=6):
        self.paged, self.clock, self.n_slots = paged, clock, n_slots
        self.slot_req = [object() if s in occupied else None
                         for s in range(n_slots)]

        class Sched:
            active_slots = sorted(occupied)
        self.sched = Sched
        self.stalls = []

    def stall_slot(self, slot, ticks):
        self.stalls.append((self.clock, slot, ticks))


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 3, 17])
def test_serve_hook_stalls_the_reference_slot(paged, seed):
    spec = "stall@2:5,stall@3,stall@9:2"
    occupied = [{0, 2, 3, 5}, set(), {1, 4}, {0, 1, 2, 3, 4, 5}, {5}, {2, 3}]
    runs = []
    for mod in (chaos, jchaos):
        eng = mod.ChaosEngine.parse(spec, seed=seed)
        calls = []
        for tick in range(12):
            fake = _FakeEngine(paged, occupied[tick % len(occupied)], tick)
            eng.serve_hook(fake)
            calls += fake.stalls
        runs.append(calls)
    assert runs[0] == runs[1] and len(runs[0]) == 3


# ---------------------------------------------------------------------------
# the Trainer
# ---------------------------------------------------------------------------

def _smoke(exec_mode):
    def mk(cfg):
        return dataclasses.replace(cfg, dtype="float32", param=dataclasses.
                                   replace(cfg.param, exec_mode=exec_mode))
    return (mk(jregistry.get_smoke_config("llama_60m")),
            mk(registry.get_smoke_config("llama_60m")))


def _tcs(d, exec_mode="dense", steps=6, ckpt_every=2):
    """The reference's and the port's TrainConfig of the reference's
    fault-tolerance tests."""
    jcfg, cfg = _smoke(exec_mode)
    kw = dict(global_batch=4, seq_len=32, steps=steps, log_every=100,
              ckpt_every=ckpt_every, ckpt_dir=d, async_ckpt=False)
    okw = dict(lr=1e-3, warmup_steps=2, total_steps=steps)
    return (JTrainConfig(model=jcfg, optim=JOptimizerConfig(**okw), **kw),
            TrainConfig(model=cfg, optim=OptimizerConfig(**okw), **kw))


@pytest.fixture(scope="module")
def carried():
    """The reference's init of the smoke config (exec_mode dense) as numpy
    trees; the reference Trainer draws the same from seed 42."""
    jcfg, _ = _smoke("dense")
    params, consts = jregistry.get_api(jcfg).init(
        jcfg, jax.random.PRNGKey(42), seed=42)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, consts)


class CarriedTrainer(Trainer):
    """The port's Trainer, started from the reference's weights."""

    weights = None

    def init_state(self):
        params, consts = from_jax_numpy(*self.weights, device="cpu")
        return TrainerState(params, self.optimizer.init(params),
                            add_transposed_tiles(consts), step=0)


def _quiet(**kw):
    return dict(log_fn=lambda *a: None, device="cpu", **kw)


def _kill_then_relaunch(make, tc, mod=chaos, spec="kill@4"):
    """A run killed by ``spec`` (``mod``: either package's chaos module),
    then its relaunch; returns (killed trainer, relaunched trainer, final
    state)."""
    tr = make(tc, chaos=mod.ChaosEngine.parse(spec))
    with pytest.raises(SystemExit) as ei:
        tr.run()
    assert ei.value.code == 43
    assert tr.obs.snapshot()["resilience.faults_injected{kind=kill}"][
        "value"] == 1
    tr2 = make(tc)
    return tr, tr2, tr2.run()


@pytest.mark.parametrize("exec_mode", ["dense", "fused"])
def test_kill_relaunch_bit_exact(tmp_path, exec_mode):
    """ChaosKill before step 5 (exit 43), relaunch into the same directory:
    each resumed step's loss and the final params and optimizer state are
    bit-identical to an uninterrupted run."""
    _, tc1 = _tcs(str(tmp_path / "a"), exec_mode)
    _, tc2 = _tcs(str(tmp_path / "b"), exec_mode)
    ref = Trainer(tc1, **_quiet())
    ref_state = ref.run()
    tr, tr2, state = _kill_then_relaunch(
        lambda tc, **kw: Trainer(tc, **_quiet(**kw)), tc2)
    assert [r["step"] for r in tr.metrics_history] == [1, 2, 3, 4]
    assert [r["step"] for r in tr2.metrics_history] == [5, 6]
    losses = {r["step"]: r["loss"] for r in ref.metrics_history}
    for r in tr.metrics_history + tr2.metrics_history:
        assert r["loss"] == losses[r["step"]], r
    for tree in ("params", "opt_state"):
        a, b = (tree_leaves(getattr(s, tree)) for s in (ref_state, state))
        assert len(a) == len(b) > 0
        assert all(torch.equal(x, y) for x, y in zip(a, b)), tree


def test_kill_relaunch_losses_track_reference(tmp_path, carried):
    """The dense kill@4 drill from the reference's weights: every step's
    loss (steps 1-4 before the kill, 5-6 after the relaunch) tracks the
    reference Trainer's run of the same drill."""
    jtc, _ = _tcs(str(tmp_path / "ref"))
    _, tc = _tcs(str(tmp_path / "port"))
    jtr, jtr2, _ = _kill_then_relaunch(
        lambda c, **kw: JaxTrainer(c, log_fn=lambda *a: None, **kw), jtc,
        jchaos)
    CarriedTrainer.weights = carried
    tr, tr2, _ = _kill_then_relaunch(
        lambda c, **kw: CarriedTrainer(c, **_quiet(**kw)), tc)
    want = [r["loss"] for r in jtr.metrics_history + jtr2.metrics_history]
    got = [r["loss"] for r in tr.metrics_history + tr2.metrics_history]
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3)


def _counters(reg):
    return {k: v["value"] for k, v in reg.snapshot().items()
            if k.startswith("resilience.")}


def test_fault_matrix_counters_match_reference(tmp_path, carried):
    """The reference's fault matrix: kill@3 (exit 43), then a relaunch with
    the same engine and registry, where ckpt_corrupt@4 damages the newest
    checkpoint right before nonfinite@4 forces a rollback past it. Every
    kind is counted and recovered, with the reference's counters."""
    spec = ("kill@3,data_corrupt@2,straggler@2:30,ckpt_corrupt@4,"
            "nonfinite@4")
    out = []
    CarriedTrainer.weights = carried
    for make, tc, mod, reg in (
            (JaxTrainer, _tcs(str(tmp_path / "ref"))[0], jchaos,
             jmetrics.Registry()),
            (CarriedTrainer, _tcs(str(tmp_path / "port"))[1], chaos,
             obs_metrics.Registry())):
        kw = dict(max_skips=1, obs=reg, log_fn=lambda *a: None)
        if make is CarriedTrainer:
            kw["device"] = "cpu"
        engine = mod.ChaosEngine.parse(spec, seed=0)
        with pytest.raises(SystemExit) as ei:
            make(tc, chaos=engine, **kw).run()
        assert ei.value.code == 43
        with pytest.warns(UserWarning, match="corrupt"):
            tr = make(tc, chaos=engine, **kw)
            state = tr.run()
        assert state.step == 6 and np.isfinite(tr.metrics_history[-1]["loss"])
        out.append(_counters(reg))
    assert out[1] == out[0]
    for kind in chaos.KINDS[:5]:
        assert out[1][f"resilience.faults_injected{{kind={kind}}}"] == 1
    assert out[1]["resilience.rollbacks"] >= 1


def test_straggler_is_flagged_by_the_watchdog(tmp_path):
    """A 3 s sleep lands inside step 11's timed window, and the watchdog
    flags the step by its rule (slower than 3x the median so far): smoke
    steps take tens of ms, but a loaded host slows them, so the flag is
    held to the rule on this run's own times rather than assumed (600 ms,
    the reference's, was within 3x the median under load)."""
    _, tc = _tcs(str(tmp_path), steps=12, ckpt_every=0)
    tr = Trainer(tc, chaos=chaos.ChaosEngine.parse("straggler@10:3000"),
                 **_quiet())
    tr.run()
    snap = tr.obs.snapshot()
    assert snap["resilience.faults_injected{kind=straggler}"]["value"] == 1
    dts = [r["dt"] for r in tr.metrics_history]
    assert dts[10] >= 3.0
    slow = dts[10] > tr.watchdog.factor * np.median(dts[:11])
    assert tr.watchdog.flagged == ([11] if slow else [])
    assert slow or np.median(dts[:11]) > 1.0, dts


def test_ckpt_corrupt_relaunch_falls_back_to_the_newest_intact_step(tmp_path):
    """ckpt_corrupt@5 damages step 4's checkpoint, kill@5 stops the run:
    the relaunch verifies, warns and resumes from step 2."""
    _, tc = _tcs(str(tmp_path), steps=8)
    tr = Trainer(tc, chaos=chaos.ChaosEngine.parse("ckpt_corrupt@5,kill@5"),
                 **_quiet())
    with pytest.raises(SystemExit):
        tr.run()
    snap = tr.obs.snapshot()
    assert snap["resilience.faults_injected{kind=ckpt_corrupt}"]["value"] == 1
    logs = []
    with pytest.warns(UserWarning, match="corrupt"):
        state = Trainer(tc, log_fn=logs.append, device="cpu").run()
    assert state.step == 8
    assert any("resumed from step 2" in line for line in logs), logs


# ---------------------------------------------------------------------------
# the profiler hook and the launchers
# ---------------------------------------------------------------------------

def test_trace_profile_dir_writes_a_loadable_chrome_trace(tmp_path):
    off = obs_trace.Trace(enabled=True)
    off.start()
    assert off.stop() is None
    tr = obs_trace.Trace(enabled=True, profile_dir=str(tmp_path / "prof"))
    tr.start()
    with tr.span("work"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tr.stop()
    assert path == tr.profile_path and os.path.dirname(path) == str(
        tmp_path / "prof")
    with open(path) as f:
        doc = json.load(f)
    names = {e.get("name") for e in doc["traceEvents"]}
    assert any("mm" in str(n) for n in names), sorted(map(str, names))[:20]


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def test_serve_launcher_contiguous_prints_the_reference_tokens(tmp_path):
    """Both launchers without ``--paged`` (the contiguous engine), exec_mode
    dense, on one reference checkpoint whose B is non-zero: the same
    requests and tokens."""
    jcfg = jregistry.get_smoke_config("llama_60m")
    params, _ = jregistry.get_api(jcfg).init(jcfg, jax.random.PRNGKey(0),
                                             seed=0)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map_with_path(
        lambda p, leaf: (rng.uniform(-1, 1, leaf.shape).astype(leaf.dtype)
                         if str(p[-1].key) == "B" else np.asarray(leaf)),
        params)
    ck = str(tmp_path / "ckpt")
    JaxCheckpoints(ck).save(1, {"params": params}, config_hash=jcfg.hash())
    argv = ["--arch", "llama_60m", "--smoke", "--requests", "3", "--slots",
            "2", "--max-len", "32", "--new-tokens", "5", "--ckpt-dir", ck,
            "--exec-mode", "dense"]
    want = [ln for ln in _stdout(jserve.main, argv).splitlines()
            if ln.strip().startswith("req ")]
    out = _stdout(serve.main, argv + ["--device", "cpu"])
    assert "legacy" in out and "exec_mode=dense" in out
    got = [ln for ln in out.splitlines() if ln.strip().startswith("req ")]
    assert len(want) == 3 and got == want
