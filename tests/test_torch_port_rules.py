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
    for bad in (dict(paged=False), dict(paged=True, mesh=object()),
                dict(paged=True, tick_hook=lambda e: None)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServeEngine(cfg, params, consts, **kw, **bad)
    # sparse and quant decode run now, and check their consts up front
    for bad in (dict(exec_mode="sparse"), dict(sparse_decode=True),
                dict(exec_mode="quant"),
                dict(exec_mode="sparse", sparse_decode=True)):
        with pytest.raises(ValueError):
            ServeEngine(cfg, params, consts, paged=True, **kw, **bad)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        registry.get_config("gemma2_2b")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        registry.get_api(dataclasses.replace(cfg, family="moe"))


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
    ["--use-mesh"], ["--multipod"], ["--chaos", "kill@3"],
    ["--jax-profile-dir", "x"]],
    ids=lambda f: " ".join(f))
def test_train_launcher_unported_options_raise(flags, tmp_path):
    from repro_torch.launch import train
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.main(["--smoke", "--steps", "1", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path), *flags])


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
    for kw in (dict(mesh=object()), dict(chaos=object())):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(tc, device="cpu", **kw)
    for sc in (ShardingConfig(pod_grad_compression=True),
               ShardingConfig(fsdp=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(dataclasses.replace(tc, sharding=sc), device="cpu")
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
