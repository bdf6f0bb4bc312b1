"""Training launcher, ported from ``repro.launch.train``: pick an arch (full
or smoke config) and run the fault-tolerant Trainer on the synthetic C4
pipeline, on the card unless ``--device cpu``.

Usage:
  python -m repro_torch.launch.train --arch llama_1b --exec-mode fused --steps 20
  python -m repro_torch.launch.train --arch llama_60m --smoke --steps 6 \\
      --device cpu --ckpt-dir $(mktemp -d)
  python -m repro_torch.launch.train --arch llama_1b --optimizer adam8bit \\
      --update-mode per_layer --exec-mode fused --layer-timing --steps 20
  python -m repro_torch.launch.train --arch llama_1b --exec-mode sparse \\
      --steps 20
  python -m repro_torch.launch.train --arch llama_7b --update-mode per_layer \\
      --optimizer adam8bit --exec-mode fused --steps 4
  python -m repro_torch.launch.train --arch gemma2_2b --exec-mode fused \\
      --steps 3             # also paligemma_3b, qwen2_5_32b, yi_34b, llama3_405b
  python -m repro_torch.launch.train --arch deepseek_moe_16b --smoke \
      --exec-mode fused --device cpu   # MoE; also qwen3_moe_235b
  python -m repro_torch.launch.train --arch llama_1b --mode dense   # full rank
  python -m repro_torch.launch.train --arch llama_1b --mode lowrank
  python -m repro_torch.launch.train --arch llama_1b --mode relora
  python -m repro_torch.launch.train --arch llama_1b --mode dense \\
      --optimizer galore_adamw --update-mode per_layer
  python -m repro_torch.launch.train --arch llama_60m --exec-mode fused \\
      --steps 6 --ckpt-every 3 --chaos kill@4          # exits 43 at step 4
  python -m repro_torch.launch.train --arch llama_60m --steps 6 \\
      --jax-profile-dir /tmp/prof          # a torch.profiler Chrome trace

The flags are the reference's. ``--exec-mode`` is applied to the config
before init, so ``fused`` and ``sparse`` get their tile consts (``sparse``
trains through the ``sparse_matmul`` and ``sddmm`` kernels). The
paper's baselines train too: ``--mode dense`` (full rank), ``lowrank``,
``relora`` (merging every ``relora_period`` steps) and ``--optimizer
galore_adamw`` in either update mode; ReLoRA with ``adam8bit`` is
refused (the reference's merge crashes on that state). The Trainer logs
its init's time and the processes that sampled the supports (a pool from
llama_350m's size up). ``--chaos`` injects the reference's fault matrix
(``repro_torch.resilience.chaos``, seeded with ``--seed``): an injected
kill exits 43, a preemption signal checkpoints and exits 42.
``--jax-profile-dir`` (the reference's spelling; ``--profile-dir`` too)
records a ``torch.profiler`` Chrome trace of the run into that
directory. ``--use-mesh`` (with ``--fsdp``) trains on the local mesh
through the spec engine; ``--multipod`` under ``torchrun`` trains
data-parallel over its world:

  torchrun --nproc-per-node N -m repro_torch.launch.train --multipod \
      --arch llama_1b --exec-mode fused --steps 20
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs.base import (OptimizerConfig, ShardingConfig,
                                      TrainConfig)
from repro_torch.models import registry
from repro_torch.obs import trace as obs_trace
from repro_torch.resilience.chaos import ChaosEngine
from repro_torch.train.trainer import Trainer


def build_train_config(args) -> TrainConfig:
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    if args.mode:
        cfg = dataclasses.replace(
            cfg, param=dataclasses.replace(cfg.param, mode=args.mode))
    if args.exec_mode:
        cfg = dataclasses.replace(
            cfg, param=dataclasses.replace(cfg.param, exec_mode=args.exec_mode))
    if args.delta is not None:
        cfg = dataclasses.replace(
            cfg, param=dataclasses.replace(cfg.param, delta=args.delta))
    if args.rank is not None:
        cfg = dataclasses.replace(
            cfg, param=dataclasses.replace(cfg.param, rank=args.rank))
    oc = OptimizerConfig(name=args.optimizer, lr=args.lr,
                         warmup_steps=max(1, args.steps // 10),
                         total_steps=args.steps)
    sc = ShardingConfig(remat=args.remat, grad_accum=args.grad_accum,
                        update_mode=args.update_mode, fsdp=args.fsdp)
    return TrainConfig(model=cfg, optim=oc, sharding=sc, seed=args.seed,
                       global_batch=args.batch, seq_len=args.seq,
                       steps=args.steps, log_every=args.log_every,
                       ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir)


def _mesh(args):
    """(mesh, device) of the mesh flags, as the reference's launcher
    means them: ``--use-mesh`` the local (data 1, model 1) mesh of this
    process; ``--multipod`` the process group of ``torchrun``'s
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT; NCCL on the
    cards, each rank on ``cuda:LOCAL_RANK``, gloo on the CPU), the
    reference initializing ``jax.distributed`` from its JAX_* variables,
    and a data-parallel mesh over the world (data = WORLD_SIZE, model 1)."""
    from repro_torch.dist import compat, sharding
    device = args.device
    if args.use_mesh:
        return sharding.make_local_mesh(), device
    if not args.multipod:
        return None, device
    import torch
    import torch.distributed as dist
    if device == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group("nccl" if device.startswith("cuda") else "gloo",
                            init_method="env://")
    return compat.make_mesh((dist.get_world_size(), 1),
                            ("data", "model")), device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama_60m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-friendly)")
    ap.add_argument("--mode", default=None,
                    choices=[None, "dense", "lowrank", "sltrain", "relora"])
    ap.add_argument("--exec-mode", default=None,
                    choices=[None, "dense", "sparse", "fused"],
                    help="sltrain execution mode: dense densify, sparse "
                         "factored (sparse_matmul forward and dx), fused "
                         "tile kernels (sl_matmul)")
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adam8bit", "galore_adamw"])
    ap.add_argument("--delta", type=float, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--update-mode", default="global",
                    choices=["global", "per_layer"],
                    help="per_layer = layer-wise backward sweep with "
                         "in-sweep optimizer updates (repro_torch.train."
                         "perlayer; the adam8bit kernel under --exec-mode "
                         "fused)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"),
                    help="checkpoint directory (default: repro_ckpt in the "
                         "temporary directory, /tmp unless TMPDIR says "
                         "otherwise)")
    ap.add_argument("--metrics-out", default=None,
                    help="append registry snapshot JSONL lines here (one "
                         "per log interval; repro_torch.obs.metrics)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace JSON of per-step spans "
                         "(data/dispatch/sync; repro_torch.obs.trace)")
    ap.add_argument("--layer-timing", action="store_true",
                    help="with --update-mode per_layer: record per-layer "
                         "update times (train.perlayer.layer_update_ms)")
    ap.add_argument("--jax-profile-dir", "--profile-dir", dest="profile_dir",
                    default=None,
                    help="record a torch.profiler Chrome trace of the run "
                         "into this directory (the reference's jax.profiler "
                         "hook)")
    ap.add_argument("--chaos", default=None,
                    help="fault-injection spec 'kind@step[:arg],...' "
                         "(repro_torch.resilience.chaos), e.g. 'kill@3' or "
                         "'nonfinite@5,straggler@4:50'")
    ap.add_argument("--max-rollbacks", type=int, default=2,
                    help="checkpoint rollbacks tolerated before the "
                         "trainer gives up on a persistent divergence")
    ap.add_argument("--multipod", action="store_true",
                    help="initialize the process group from torchrun's "
                         "environment and train data-parallel over its "
                         "world (the reference reads JAX_* variables)")
    ap.add_argument("--use-mesh", action="store_true",
                    help="run under the local (data 1, model 1) mesh and "
                         "place state via the repro_torch.dist.sharding "
                         "spec engine")
    ap.add_argument("--fsdp", action="store_true",
                    help="with --use-mesh: additionally shard params and "
                         "optimizer state over the data axis "
                         "(ShardingConfig.fsdp) and reduce-scatter the "
                         "gradients to that layout")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    if args.use_mesh and args.multipod:
        ap.error("--use-mesh builds the single-process local mesh and "
                 "cannot be combined with --multipod")
    if args.fsdp and not args.use_mesh:
        ap.error("--fsdp shards state via the spec engine and needs "
                 "--use-mesh (or a multipod mesh wired in code)")
    mesh, device = _mesh(args)

    chaos = ChaosEngine.parse(args.chaos, seed=args.seed) if args.chaos \
        else None
    tc = build_train_config(args)
    trace = obs_trace.Trace(enabled=bool(args.trace_out or args.profile_dir),
                            profile_dir=args.profile_dir)
    trainer = Trainer(tc, device=device, mesh=mesh, trace=trace,
                      metrics_out=args.metrics_out,
                      max_rollbacks=args.max_rollbacks,
                      layer_timing=args.layer_timing, chaos=chaos)
    trace.start()
    try:
        state = trainer.run()
    finally:
        # an injected kill (exit 43) still leaves its profile behind
        if trace.stop():
            print(f"profile: {trace.profile_path}")
    print(f"final step {state.step}: "
          f"loss={trainer.metrics_history[-1]['loss']:.4f}")
    if args.device != "cpu":
        import torch
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    if args.multipod:
        import torch.distributed as dist
        dist.destroy_process_group()
    if args.trace_out:
        n = trace.export(args.trace_out)
        print(f"trace: {n} events -> {args.trace_out}")
    return trainer


if __name__ == "__main__":
    main()
