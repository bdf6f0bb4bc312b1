"""The paper's Table 2 comparison on the port, a copy of the reference's
``examples/pretrain_comparison.py``: pretrain one LLaMA with the four
parameterizations (full rank, SLTrain, ReLoRA, low rank) at an equal
token budget through the ``Trainer``, and check the paper's qualitative
ordering with the reference's two asserts: SLTrain's perplexity is below
low rank's, and SLTrain has fewer parameters than full rank.

The defaults are the reference's: a 2-layer LLaMA of width ``--dim``
128 (d_ff 2.5·dim, 4 heads, vocab 2048, rank dim/8, δ 0.05, α 16), 300
steps at batch 8 × seq 128, AdamW lr 3e-3 with steps/10 warm-up steps.
``--size`` 60m … 7b swaps in the paper's config at full width.
Perplexity is exp of the mean loss of the last 10 steps; s/step the
median of the Trainer's step times.

  PYTHONPATH=src python -m repro_torch.analysis.pretrain_comparison
  PYTHONPATH=src python -m repro_torch.analysis.pretrain_comparison \
      --size 60m --steps 200
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import tempfile
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      ParamConfig, TrainConfig)
from repro_torch.models import registry
from repro_torch.models.common import tree_leaves
from repro_torch.train.trainer import Trainer

MODES = ("dense", "sltrain", "relora", "lowrank")


def base_config(dim: int) -> ModelConfig:
    return ModelConfig(
        name="compare-llama",
        family="llama",
        n_layers=2, d_model=dim, n_heads=4, n_kv_heads=4,
        d_ff=int(dim * 2.5), vocab_size=2048, vocab_pad_multiple=64,
        max_seq_len=128, tie_embeddings=False,
        param=ParamConfig(rank=max(8, dim // 8), delta=0.05, alpha=16.0),
    )


def compare(*, steps: int = 300, dim: int = 128, size: Optional[str] = None,
            batch: int = 8, seq: int = 128, device="cuda",
            ckpt_root: Optional[str] = None, log_fn=print
            ) -> Dict[str, Dict[str, float]]:
    """Train each mode for ``steps`` from seed 42; returns {mode: {"loss",
    "ppl", "params_M", "s_per_step", "losses"}}. Each Trainer's final
    checkpoint goes to a directory under ``ckpt_root`` (a new temporary
    one by default), removed when the run ends."""
    results: Dict[str, Dict[str, float]] = {}
    root = tempfile.mkdtemp(prefix="cmp_", dir=ckpt_root)
    try:
        for mode in MODES:
            cfg = (registry.get_config(f"llama_{size}") if size
                   else base_config(dim))
            cfg = dataclasses.replace(
                cfg, param=dataclasses.replace(cfg.param, mode=mode))
            tc = TrainConfig(
                model=cfg,
                optim=OptimizerConfig(lr=3e-3, warmup_steps=steps // 10,
                                      total_steps=steps),
                global_batch=batch, seq_len=seq, steps=steps,
                log_every=max(50, steps // 4), ckpt_every=0,
                ckpt_dir=f"{root}/{mode}")
            log_fn(f"=== {mode} ===")
            tr = Trainer(tc, device=device, log_fn=log_fn)
            state = tr.run()
            n = sum(t.numel() for _, t in tree_leaves(state.params))
            hist = tr.metrics_history
            loss = float(np.mean([m["loss"] for m in hist[-10:]]))
            results[mode] = {
                "loss": loss, "ppl": float(np.exp(loss)),
                "params_M": n / 1e6,
                "s_per_step": float(np.median([m["dt"] for m in hist])),
                "losses": [m["loss"] for m in hist]}
            del tr, state
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return results


def table(results) -> List[str]:
    """The reference's table, sorted by perplexity."""
    lines = [f"{'method':10s} {'PPL':>9s} {'params(M)':>10s} "
             f"{'s/step':>8s}"]
    for mode, r in sorted(results.items(), key=lambda kv: kv[1]["ppl"]):
        lines.append(f"{mode:10s} {r['ppl']:9.2f} {r['params_M']:10.2f} "
                     f"{r['s_per_step']:8.3f}")
    return lines


def gate_failures(results) -> List[str]:
    """The reference's two asserts (the paper's qualitative ordering at
    equal tokens), as messages; empty when both hold."""
    bad = []
    if not results["sltrain"]["ppl"] < results["lowrank"]["ppl"]:
        bad.append("SLTrain should beat pure low-rank (paper Table 2)")
    if not results["sltrain"]["params_M"] < results["dense"]["params_M"]:
        bad.append("SLTrain should be parameter-efficient vs full-rank")
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--size", default=None,
                    help="paper size (60m/130m/350m/1b/7b) instead of --dim")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    results = compare(steps=args.steps, dim=args.dim, size=args.size,
                      batch=args.batch, seq=args.seq, device=args.device)
    print()
    print("\n".join(table(results)))
    bad = gate_failures(results)
    if bad:
        raise SystemExit("pretrain_comparison: " + "; ".join(bad))
    print("\nOK: SLTrain < Low-Rank in PPL at fewer params than Full-Rank.")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
