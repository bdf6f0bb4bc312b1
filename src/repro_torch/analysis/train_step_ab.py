"""Times the bf16 ``llama_1b`` train step, and the fused serving engine,
of several checkouts of this repo, one after another on one card, so
that two versions of the port are compared on the same machine.

    python src/repro_torch/analysis/train_step_ab.py OLD NEW NEW OLD

Each argument is the root of a checkout (``git archive <commit>`` into a
directory that ``.gitignore`` lists, or ``.``). For each, in its own
process with that checkout's ``src`` first on the path, it builds the
kernels and runs what ``chip_smoke.py`` runs in phases 7 to 9: six steps
of the ``Trainer`` with per-layer 8-bit AdamW (``layer_timing`` on) and
six with global AdamW, at batch 8 × seq 256, exec_mode fused, weights
from seed 0, then six full-rank (``param.mode="dense"``) steps with
global AdamW. It reports the median of steps 2–6, the peak of
``max_memory_allocated`` over the steps (reset before step 1 by the
Trainer's fault hook; the Trainer inits its own state), the host time spent
inside the ``sddmm`` and ``sl_matmul`` wrappers (perf_counter around each
call; the launches are asynchronous, so this is the wrapper's own work),
and one more step under ``torch.profiler`` (CPU and CUDA): its wall, the
device's busy time (union of kernel intervals) and the host ops with the
most self CPU time. Then it serves 8 prompts (2–11 tokens from
``default_rng(0)``, 16 new tokens) through a fresh bf16 exec_mode fused
paged engine (4 slots, max_len 128, block_len 16, prefix sharing) on the
same seed-0 weights, ``SERVE_RUNS`` times, and reports each run's
tokens/s (host clock around the run, ending in a sync). It uses only
what every checkout since the port's training slice has: ``Trainer``,
``TrainConfig``, ``build.build``, ``ServeEngine``.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

STEPS = 6
BATCH, SEQ = 8, 256
SERVE_RUNS = 3


def _wrap(module, name, acc):
    """Replace ``module.name`` by a wrapper that adds each call's host
    seconds to ``acc``; the wrapped function's launch count (an attribute
    it bumps through its module-level name) carries over."""
    fn = getattr(module, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            acc.append(time.perf_counter() - t0)
    timed.launches = getattr(fn, "launches", 0)
    setattr(module, name, timed)


def _busy_us(prof):
    import torch
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    busy, (s0, e0) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > e0:
            busy += e0 - s0
            s0, e0 = s, e
        else:
            e0 = max(e0, e)
    return busy + e0 - s0


def child(root: str) -> dict:
    """One checkout's numbers (runs in a process of its own)."""
    root = os.path.abspath(root)
    sys.path.insert(0, os.path.join(root, "src"))
    import dataclasses
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    if not os.path.abspath(repro_torch.__file__).startswith(root):
        raise RuntimeError(f"imported {repro_torch.__file__}, not {root}")
    from repro_torch.configs import llama_1b
    from repro_torch.configs.base import (OptimizerConfig, ShardingConfig,
                                          TrainConfig)
    from repro_torch.kernels import build
    from repro_torch.kernels import sddmm as sdk
    from repro_torch.kernels import sl_matmul as slk
    from repro_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    build.build()
    cfg = llama_1b.CONFIG
    cfg = dataclasses.replace(cfg, param=dataclasses.replace(
        cfg.param, exec_mode="fused"))
    host = {"sddmm": [], "sl_matmul": []}
    _wrap(sdk, "sddmm", host["sddmm"])
    _wrap(slk, "sl_matmul", host["sl_matmul"])
    out = {"root": root}
    full = dataclasses.replace(cfg, param=dataclasses.replace(
        cfg.param, mode="dense", exec_mode="dense"))

    def reset_peak(step):
        if step == 0:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
    for label, opt, mode, c in (
            ("per_layer adam8bit", "adam8bit", "per_layer", cfg),
            ("global adamw", "adamw", "global", cfg),
            ("full rank global adamw", "adamw", "global", full)):
        ckpt = os.path.join(root, "build", "train_step_ab_ckpt")
        shutil.rmtree(ckpt, ignore_errors=True)
        oc = OptimizerConfig(name=opt, lr=3e-3, warmup_steps=1,
                             total_steps=STEPS)
        tc = TrainConfig(model=c, optim=oc,
                         sharding=ShardingConfig(update_mode=mode), seed=0,
                         global_batch=BATCH, seq_len=SEQ, steps=STEPS,
                         log_every=1, ckpt_every=0, ckpt_dir=ckpt,
                         async_ckpt=False, keep_ckpts=1)
        tr = Trainer(tc, device=device, log_fn=lambda *a: None,
                     layer_timing=mode == "per_layer", fault_hook=reset_peak)
        for v in host.values():
            v.clear()
        state = tr.run()
        torch.cuda.synchronize()
        dts = [h["dt"] * 1e3 for h in tr.metrics_history]
        row = {"step_ms": dts, "median_ms": statistics.median(dts[1:]),
               "peak_bytes": torch.cuda.max_memory_allocated()}
        for k, v in host.items():
            row[f"{k}_calls_per_step"] = len(v) // STEPS
            row[f"{k}_host_us_median"] = statistics.median(v) * 1e6 \
                if v else 0.0
            row[f"{k}_host_ms_per_step"] = sum(v) * 1e3 / STEPS
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in tr.data.next_batch().items()}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            new_p, new_s, m = tr._train_step(state.params, state.opt_state,
                                             state.consts, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = _busy_us(prof)
        row["profiled_wall_ms"] = wall * 1e3
        row["profiled_busy_ms"] = None if busy is None else busy / 1e3
        ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
        row["top_self_cpu_ms"] = [(e.key, e.count, e.self_cpu_time_total / 1e3)
                                  for e in ops[:8]]
        out[label] = row
        # the next run's peak must not see this run's state
        del tr, state, batch, prof, new_p, new_s, m
        shutil.rmtree(ckpt, ignore_errors=True)
        torch.cuda.empty_cache()
    out["serve fused"] = serve_runs(cfg, device)
    return out


def serve_runs(cfg, device) -> dict:
    """Tokens/s of ``SERVE_RUNS`` runs of a fresh fused engine over the
    same prompts and weights."""
    import statistics

    import numpy as np
    import torch

    from repro_torch.models import registry
    from repro_torch.serve.engine import ServeEngine
    params, consts = registry.get_api(cfg).init(cfg, seed=0, device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size,
                            size=int(rng.integers(2, 12))).tolist()
               for _ in range(8)]
    rates = []
    for _ in range(SERVE_RUNS):
        eng = ServeEngine(cfg, params, consts, n_slots=4, max_len=128,
                          paged=True, block_len=16, exec_mode="fused",
                          prefix_sharing=True, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
        eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rates.append(sum(len(r.out) for r in reqs) / wall)
        del eng
    return {"tokens_per_s": rates, "median": statistics.median(rates)}


def main(argv) -> int:
    if len(argv) >= 2 and argv[0] == "--child":
        print(json.dumps(child(argv[1])))
        return 0
    if not argv:
        print(__doc__)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    results = []
    for root in argv:
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", os.path.abspath(root)],
                           capture_output=True, text=True, cwd=root,
                           timeout=600)
        if p.returncode != 0:
            print(p.stdout[-4000:], p.stderr[-4000:], sep="\n")
            return p.returncode
        res = json.loads(p.stdout.strip().splitlines()[-1])
        res["process_s"] = time.perf_counter() - t0
        results.append(res)
        print(json.dumps(res), flush=True)
    for res in results:
        for label in ("per_layer adam8bit", "global adamw",
                      "full rank global adamw"):
            r = res[label]
            print(f"{res['root']} | {label}: median {r['median_ms']:.1f} ms "
                  f"(steps {[round(x, 1) for x in r['step_ms']]}) | peak "
                  f"max_memory_allocated {r['peak_bytes']} B = "
                  f"{r['peak_bytes'] / 2**30:.3f} GiB | profiled "
                  f"wall {r['profiled_wall_ms']:.1f} ms, busy "
                  f"{r['profiled_busy_ms']} ms | host in wrappers a step: "
                  f"sddmm {r['sddmm_host_ms_per_step']:.2f} ms "
                  f"({r['sddmm_calls_per_step']} calls, median "
                  f"{r['sddmm_host_us_median']:.1f} us), sl_matmul "
                  f"{r['sl_matmul_host_ms_per_step']:.2f} ms "
                  f"({r['sl_matmul_calls_per_step']} calls, median "
                  f"{r['sl_matmul_host_us_median']:.1f} us) | {smi}")
        r = res["serve fused"]
        print(f"{res['root']} | serve fused bf16: tokens/s "
              f"{[round(x, 1) for x in r['tokens_per_s']]}, median "
              f"{r['median']:.1f} | {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
