"""Rules of the PyTorch port: it imports neither jax nor the reference
package, its entry points (serving and training) refuse to run without a
card unless asked for the CPU, unported options raise naming their
ROADMAP item, ``from_jax_numpy`` reads the reference's
flat checkpoint layout (bf16 as uint16 bit-views), and ``chip_smoke.py``
fails without a card or without the repository beside it."""
import ast
import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.ckpt.convert import from_jax_numpy
from repro_torch.core import sltrain
from repro_torch.models import lm, registry
from repro_torch.serve.engine import ServeEngine

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_and_nothing_of_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), \
                f"{path.relative_to(ROOT)}:{node.lineno} imports {name}"


def test_port_rules_cover_the_distribution_layer():
    """The import check above reads the distribution layer too:
    ``repro_torch/dist/`` and ``launch/{mesh,specs}.py``."""
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for f in ("dist/__init__.py", "dist/compat.py", "dist/sharding.py",
              "dist/compression.py", "launch/mesh.py", "launch/specs.py"):
        assert f"src/repro_torch/{f}" in names, f


def test_support_sampling_worker_imports_numpy_only():
    """The init's sampling workers run ``repro_torch.core.support`` in a
    fresh interpreter (``support._WORKER``): that import loads neither
    torch nor jax nor the reference."""
    from repro_torch.core import support
    code = support._WORKER.format(src=support._SRC).replace(
        "_worker()", "print(sorted({'torch', 'jax', 'jaxlib', 'repro'} & "
        "set(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _smoke():
    return registry.get_smoke_config("llama_60m")


def test_entry_points_need_a_card_unless_cpu(no_card):
    cfg = _smoke()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_lm(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_cache(cfg, 2, 32, paged=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_numpy({"w": np.zeros(2, np.float32)}, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sltrain.init_params(torch.Generator(), 64, 64, 8, 0.05)
    params, consts = lm.init_lm(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params, consts, paged=True, max_len=32)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--paged", "--requests", "1"])


def test_unported_options_raise():
    cfg = _smoke()
    params, consts = lm.init_lm(cfg, device="cpu")
    kw = dict(max_len=32, device="cpu")
    # serving on a mesh runs now (item 10b.1); MoE on a mesh is refused,
    # naming item 10b
    from repro_torch.dist import sharding
    eng = ServeEngine(cfg, params, consts, paged=True,
                      mesh=sharding.make_local_mesh(), **kw)
    assert eng.submit([5, 9], max_new_tokens=2) and \
        eng.run_until_drained()["summary"] == {"done": 1}
    with pytest.raises(NotImplementedError, match="ROADMAP queue A item 10b"):
        ServeEngine(registry.get_smoke_config("deepseek_moe_16b"), params,
                    consts, paged=True, mesh=sharding.make_local_mesh(), **kw)
    # the contiguous cache and the tick hook run now
    ticks = []
    for ok in (dict(paged=False), dict(paged=True, tick_hook=ticks.append),
               dict(paged=False, tick_hook=ticks.append)):
        eng = ServeEngine(cfg, params, consts, **kw, **ok)
        req = eng.submit([5, 9, 11], max_new_tokens=2)
        eng.run_until_drained()
        assert req.status == "done" and len(req.out) == 2
    assert ticks and all(isinstance(e, ServeEngine) for e in ticks)
    # sparse and quant decode run now, and check their consts up front
    for bad in (dict(exec_mode="sparse"), dict(sparse_decode=True),
                dict(exec_mode="quant"),
                dict(exec_mode="sparse", sparse_decode=True)):
        with pytest.raises(ValueError):
            ServeEngine(cfg, params, consts, paged=True, **kw, **bad)
    # the SSM and encoder families run now, on the contiguous cache only
    for arch in ("zamba2_7b", "xlstm_350m", "whisper_large_v3"):
        assert registry.get_config(arch).family in (
            "mamba_hybrid", "xlstm", "whisper")
    api = registry.get_api(dataclasses.replace(cfg, family="mamba_hybrid"))
    assert api.prefill_step is None and api.perlayer is None


def test_train_entry_points_need_a_card_unless_cpu(no_card, tmp_path):
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch import train
    from repro_torch.train.trainer import Trainer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(TrainConfig(model=_smoke(), ckpt_dir=str(tmp_path)))
    tr = train.main(["--smoke", "--steps", "1", "--batch", "2", "--seq",
                     "8", "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    assert tr.device.type == "cpu" and len(tr.metrics_history) == 1


@pytest.mark.parametrize("flags", [
    ["--fsdp", "--use-mesh"],
    ["--use-mesh"], ["--multipod"]],
    ids=lambda f: " ".join(f))
def test_train_launcher_unported_options_raise(flags, tmp_path, monkeypatch):
    """The mesh flags, refused until the distribution layer was ported,
    run one step: ``--use-mesh`` on the local (data 1, model 1) mesh
    (``--fsdp`` with it), ``--multipod`` on a world of one process
    started as torchrun starts one (its world of 2 is in
    tests/test_torch_dist_train.py); ``--fsdp`` alone is refused as the
    reference refuses it."""
    from repro_torch.launch import train
    if "--multipod" in flags:
        import socket
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        for k, v in (("RANK", "0"), ("LOCAL_RANK", "0"), ("WORLD_SIZE", "1"),
                     ("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(port))):
            monkeypatch.setenv(k, v)
    tr = train.main(["--smoke", "--steps", "1", "--batch", "2", "--seq",
                     "8", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                     *flags])
    assert tr.mesh is not None and tr.mesh.shape == {"data": 1, "model": 1}
    assert len(tr.metrics_history) == 1 and \
        np.isfinite(tr.metrics_history[0]["loss"])
    assert (tr._plan is not None) and tr.tc.sharding.fsdp == (
        "--fsdp" in flags)
    with pytest.raises(SystemExit):
        train.main(["--smoke", "--steps", "1", "--device", "cpu", "--fsdp",
                    "--ckpt-dir", str(tmp_path)])


@pytest.mark.parametrize("flags", [
    ["--chaos", "kill@3"], ["--jax-profile-dir", "x"]],
    ids=lambda f: " ".join(f))
def test_train_launcher_chaos_and_profile_options_now_run(flags, tmp_path):
    """``--chaos`` and ``--jax-profile-dir`` (refused until they were
    ported) run one step; a kill scheduled past the last step never fires,
    and the profile directory gets a Chrome trace."""
    from repro_torch.launch import train
    flags = [str(tmp_path / f) if f == "x" else f for f in flags]
    tr = train.main(["--smoke", "--steps", "1", "--batch", "2", "--seq",
                     "8", "--device", "cpu", "--ckpt-dir",
                     str(tmp_path / "ck"), *flags])
    assert len(tr.metrics_history) == 1
    if "--chaos" in flags:
        assert tr.chaos is not None and not tr.chaos._fired
    else:
        assert tr.trace.profile_path.startswith(str(tmp_path / "x"))
        assert os.path.getsize(tr.trace.profile_path) > 0


def test_launchers_chaos_kill_and_stall_run(tmp_path):
    """``python -m repro_torch.launch.train --chaos kill@2`` exits 43
    before step 3, and its relaunch resumes from a checkpoint (step 2's,
    or step 1's when the process died with step 2's background write in
    flight); the serve launcher's ``--chaos stall`` with a deadline on
    either cache ends with no request unfinished."""
    from repro_torch.launch import serve, train
    argv = ["--smoke", "--steps", "3", "--batch", "2", "--seq", "8",
            "--ckpt-every", "1", "--device", "cpu", "--ckpt-dir",
            str(tmp_path)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *argv, "--chaos", "kill@2"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 43, out.stderr[-2000:]
    tr = train.main(argv)
    assert [r["step"] for r in tr.metrics_history] in ([3], [2, 3])
    for paged in ([], ["--paged"]):
        eng, reqs = serve.main(
            ["--smoke", "--requests", "3", "--slots", "2", "--max-len", "32",
             "--new-tokens", "4", "--chaos", "stall@2:40",
             "--deadline-ticks", "20", "--device", "cpu", *paged])
        assert {r.status for r in reqs} <= {"done", "timed_out"}
        assert eng.obs.snapshot()[
            "resilience.faults_injected{kind=stall}"]["value"] == 1


@pytest.mark.parametrize("flags", [
    ["--optimizer", "adam8bit"], ["--update-mode", "per_layer"],
    ["--remat", "full"], ["--remat", "dots_saveable"],
    ["--update-mode", "per_layer", "--layer-timing"],
    ["--optimizer", "adam8bit", "--update-mode", "per_layer",
     "--exec-mode", "fused", "--layer-timing"],
    ["--exec-mode", "sparse"],
    ["--exec-mode", "sparse", "--update-mode", "per_layer"]],
    ids=lambda f: " ".join(f))
def test_train_launcher_memory_path_options_run(flags, tmp_path):
    """The memory path's flags (8-bit Adam, per-layer updates, remat,
    per-layer timing), and training in exec_mode sparse, run one step on
    the CPU."""
    from repro_torch.launch import train
    tr = train.main(["--smoke", "--steps", "1", "--batch", "2", "--seq",
                     "8", "--device", "cpu", "--ckpt-dir", str(tmp_path),
                     *flags])
    row = tr.metrics_history[0]
    assert len(tr.metrics_history) == 1 and np.isfinite(row["loss"])
    assert row["nonfinite"] == 0.0
    timed = "--layer-timing" in flags
    h = tr.obs.get("train.perlayer.layer_update_ms")
    assert (h is not None and h.count == tr.cfg.n_layers) == timed


def test_trainer_unported_options_raise(tmp_path):
    from repro_torch.configs.base import (OptimizerConfig, ShardingConfig,
                                          TrainConfig)
    from repro_torch.train.trainer import Trainer
    tc = TrainConfig(model=_smoke(), ckpt_dir=str(tmp_path))
    # a mesh runs now (ROADMAP queue A item 10a): one step on the local
    # mesh; on a mesh the baselines are refused, naming item 10b
    from repro_torch.dist import sharding
    one = dict(steps=1, global_batch=2, seq_len=8)
    tr = Trainer(dataclasses.replace(tc, **one, ckpt_dir=str(
        tmp_path / "mesh")), device="cpu", mesh=sharding.make_local_mesh(),
        log_fn=lambda *a: None)
    assert tr.run().step == 1 and tr._chips == 1
    with pytest.raises(NotImplementedError, match="item 10b"):
        Trainer(dataclasses.replace(tc, model=dataclasses.replace(
            _smoke(), param=dataclasses.replace(_smoke().param,
                                                mode="lowrank"))),
                device="cpu", mesh=sharding.make_local_mesh())
    # chaos= runs now: one step, the schedule bound to the registry
    from repro_torch.resilience import ChaosEngine
    tr = Trainer(dataclasses.replace(tc, steps=1, global_batch=2, seq_len=8,
                                     ckpt_dir=str(tmp_path / "chaos")),
                 device="cpu", log_fn=lambda *a: None,
                 chaos=ChaosEngine.parse("data_corrupt@0"))
    assert tr.run().step == 1
    assert tr.obs.snapshot()["resilience.bad_batches"]["value"] == 1
    # fsdp and pod compression run now; without a mesh they change
    # nothing, as in the reference
    for i, sc in enumerate((ShardingConfig(pod_grad_compression=True),
                            ShardingConfig(fsdp=True))):
        tr = Trainer(dataclasses.replace(tc, sharding=sc, **one, ckpt_dir=str(
            tmp_path / f"sc{i}")), device="cpu", log_fn=lambda *a: None)
        assert tr.run().step == 1
    # ReLoRA with 8-bit AdamW, which crashes the reference's merge
    with pytest.raises(ValueError, match="ROADMAP queue C"):
        Trainer(dataclasses.replace(
            tc, model=dataclasses.replace(_smoke(), param=dataclasses.replace(
                _smoke().param, mode="relora")),
            optim=OptimizerConfig(name="adam8bit")), device="cpu")
    # per-layer updates and remat run now; unknown names still raise
    for sc in (ShardingConfig(update_mode="per_layer"),
               ShardingConfig(update_mode="per_layer", remat="full")):
        Trainer(dataclasses.replace(tc, sharding=sc), device="cpu")
    with pytest.raises(ValueError, match="update_mode"):
        Trainer(dataclasses.replace(tc, sharding=ShardingConfig(
            update_mode="sideways")), device="cpu")
    params, consts = lm.init_lm(_smoke(), device="cpu")
    toks = torch.zeros((1, 2), dtype=torch.int64)
    with pytest.raises(ValueError, match="remat"):
        lm.apply_lm(_smoke(), params, consts, toks, remat="most")
    full, _ = lm.apply_lm(_smoke(), params, consts, toks, remat="full")
    assert torch.equal(full, lm.apply_lm(_smoke(), params, consts, toks)[0])


def test_from_jax_numpy_reads_flat_checkpoint_layout():
    """Flat "/"-joined keys as the reference's arrays.npz has them; bf16
    leaves as uint16 bit-views."""
    bf = torch.tensor([1.5, -2.0, 3.25], dtype=torch.bfloat16)
    flat = {"layers/k0/attn/wq/B": bf.view(torch.uint16).numpy(),
            "layers/k0/attn/wq/A": np.ones((2, 3), np.float32),
            "embed": np.arange(4, dtype=np.float32)}
    params, consts = from_jax_numpy(flat, {"layers/k0/attn/wq/cols":
                                           np.zeros((2, 1), np.int32)},
                                    device="cpu")
    b = params["layers"]["k0"]["attn"]["wq"]["B"]
    assert b.dtype == torch.bfloat16 and torch.equal(b, bf)
    assert params["embed"].dtype == torch.float32
    assert consts["layers"]["k0"]["attn"]["wq"]["cols"].dtype == torch.int32


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_a_card():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("arch", ["zamba2_7b", "xlstm_350m",
                                  "whisper_large_v3"])
def test_paged_engine_needs_a_prefill_step(arch):
    """A paged engine for a family without ``prefill_step`` raises
    ValueError at construction, as the reference's does
    (``repro.serve.engine``), before it builds a cache; the contiguous
    engine serves."""
    cfg = registry.get_smoke_config(arch)
    params, consts = registry.get_api(cfg).init(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="has no prefill_step"):
        ServeEngine(cfg, params, consts, paged=True, max_len=32,
                    device="cpu")
    eng = ServeEngine(cfg, params, consts, max_len=32, device="cpu")
    req = eng.submit([5, 9, 11], max_new_tokens=2)
    eng.run_until_drained()
    assert req.status == "done" and len(req.out) == 2
