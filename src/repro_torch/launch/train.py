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
  python -m repro_torch.launch.train --arch llama_1b --mode dense   # full rank
  python -m repro_torch.launch.train --arch llama_1b --mode lowrank
  python -m repro_torch.launch.train --arch llama_1b --mode relora
  python -m repro_torch.launch.train --arch llama_1b --mode dense \\
      --optimizer galore_adamw --update-mode per_layer

The flags are the reference's. ``--exec-mode`` is applied to the config
before init, so ``fused`` and ``sparse`` get their tile consts (``sparse``
trains through the ``sparse_matmul`` and ``sddmm`` kernels). The
paper's baselines train too: ``--mode dense`` (full rank), ``lowrank``,
``relora`` (merging every ``relora_period`` steps) and ``--optimizer
galore_adamw`` in either update mode; ReLoRA with ``adam8bit`` is
refused (the reference's merge crashes on that state). The Trainer logs
its init's time and the processes that sampled the supports (a pool from
llama_350m's size up). Options the port does not run yet raise
``NotImplementedError`` naming their ROADMAP item.
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


def _refuse_unported(args) -> None:
    """The flags the Trainer never sees; the rest (optimizer, mode, fsdp)
    it refuses itself."""
    if args.multipod or args.use_mesh:
        raise NotImplementedError(
            "--multipod and --use-mesh are not ported yet (ROADMAP queue A "
            "item 10: distribution); the port trains on one card")
    if args.chaos:
        raise NotImplementedError(
            "--chaos is not ported yet (ROADMAP queue A item 8)")
    if args.jax_profile_dir:
        raise NotImplementedError(
            "--jax-profile-dir records a jax.profiler trace; the port has "
            "no counterpart yet (ROADMAP queue A item 8: observability "
            "wiring)")


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
    ap.add_argument("--jax-profile-dir", default=None)
    ap.add_argument("--chaos", default=None,
                    help="fault-injection spec 'kind@step[:arg],...'")
    ap.add_argument("--max-rollbacks", type=int, default=2,
                    help="checkpoint rollbacks tolerated before the "
                         "trainer gives up on a persistent divergence")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--use-mesh", action="store_true")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)
    _refuse_unported(args)

    tc = build_train_config(args)
    trace = obs_trace.Trace(enabled=bool(args.trace_out))
    trainer = Trainer(tc, device=args.device, trace=trace,
                      metrics_out=args.metrics_out,
                      max_rollbacks=args.max_rollbacks,
                      layer_timing=args.layer_timing)
    state = trainer.run()
    print(f"final step {state.step}: "
          f"loss={trainer.metrics_history[-1]['loss']:.4f}")
    if args.trace_out:
        n = trace.export(args.trace_out)
        print(f"trace: {n} events -> {args.trace_out}")
    return trainer


if __name__ == "__main__":
    main()
