"""Serving launcher of the port: init a paper config with seeded random
weights, or restore a training checkpoint, and serve batched requests
through the paged engine.

Usage (from the repository root, ``PYTHONPATH=src``):
  python -m repro_torch.launch.serve --arch llama_1b --paged --stream \
      --prefix-sharing --exec-mode fused
  python -m repro_torch.launch.serve --arch llama_1b --paged --sparse-decode
  python -m repro_torch.launch.serve --arch llama_7b --paged --stream \
      --prefix-sharing --exec-mode fused
  python -m repro_torch.launch.serve --arch llama_60m --smoke --paged \
      --ckpt-dir /path/to/train/ckpt --exec-mode sparse
  python -m repro_torch.launch.serve --arch llama_60m --smoke --paged \
      --quant-ckpt /path/to/artifact          # exec_mode quant
  python -m repro_torch.launch.serve --arch llama_60m --smoke --paged \
      --ckpt-dir /path/to/train/ckpt --exec-mode quant --quant-fallback
  python -m repro_torch.launch.serve --arch llama_60m --smoke --paged \
      --device cpu

``--exec-mode`` (and ``--sparse-decode``) is applied to the config before
init, so ``fused``, ``sparse`` and ``quant`` get the tile consts their
kernels (or the quant fallback) read. ``--ckpt-dir`` then restores the
params from a training checkpoint of either package (``launch.train``),
whatever exec mode it was trained in. ``--quant-ckpt`` serves a quant
artifact (``python -m repro_torch.quant.calibrate``), which carries its
own params and consts. ``--quant-fallback`` lets an exec_mode quant engine
whose consts lack the int8 codes serve through the sparse path instead,
with a warning. The reference's mesh and chaos flags are not ported yet.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.models import registry
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.engine import ServeEngine


def load_model(cfg, *, device, ckpt_dir=None, quant_ckpt=None):
    """(params, consts) to serve with ``cfg`` (its exec mode already set):
    a quant artifact's trees, or a seeded init of ``cfg`` whose params are
    then restored from the training checkpoint under ``ckpt_dir`` (either
    package's; its config may differ from ``cfg`` in the exec mode)."""
    if quant_ckpt:
        # the artifact carries both trees (error-folded B/A and the int8
        # tile-CSR consts): no init is needed
        from repro_torch.ckpt.checkpoint import load_quant_artifact
        params, consts, qman = load_quant_artifact(quant_ckpt, device=device)
        print(f"quant artifact: {quant_ckpt} "
              f"({qman['extra'].get('n_matrices', '?')} matrices)")
        return params, consts
    reg = obs_metrics.Registry()
    params, consts = registry.get_api(cfg).init(cfg, 0, device=device,
                                                obs=reg)
    print(f"init: {cfg.name} in {reg.get('init.seconds').value:.1f} s "
          f"({reg.get('init.sampling_workers').value:.0f} support sampling "
          "workers)")
    if ckpt_dir:
        from repro_torch.ckpt.checkpoint import CheckpointManager
        tree, man = CheckpointManager(ckpt_dir).restore(
            {"params": params}, allow_config_change=True)
        params = tree["params"]
        print(f"checkpoint: {ckpt_dir} (step {man['step']})")
    return params, consts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama_60m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu' "
                         "for the kernels' plain PyTorch versions")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--sparse-decode", action="store_true",
                    help="factored SLTrain decode: shorthand for "
                         "--exec-mode sparse")
    ap.add_argument("--exec-mode", default=None,
                    choices=("dense", "sparse", "fused", "quant"),
                    help="SLTrain execution mode: 'fused' runs every linear "
                         "through the sl_matmul kernel, 'sparse' through "
                         "sparse_matmul, 'quant' through quant_sparse_matmul "
                         "(requires --quant-ckpt)")
    ap.add_argument("--quant-ckpt", default=None,
                    help="serve a calibrated int8 quant artifact (python -m "
                         "repro_torch.quant.calibrate) instead of a seeded "
                         "init; defaults --exec-mode to 'quant'")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the params of a training checkpoint "
                         "(launch.train of either package) instead of a "
                         "seeded init")
    ap.add_argument("--quant-fallback", action="store_true",
                    help="with --exec-mode quant: serve through the sparse "
                         "path (warn and count serve.quant_fallback) when "
                         "the consts lack the int8 codes, instead of "
                         "refusing to start")
    ap.add_argument("--paged", action="store_true",
                    help="block-paged KV cache (the only cache the port has)")
    ap.add_argument("--block-len", type=int, default=16,
                    help="tokens per KV block")
    ap.add_argument("--attn-kernel", default=None,
                    choices=("gather", "paged"),
                    help="paged read path: 'paged' runs the paged-attention "
                         "kernels, 'gather' the gathered view (default: the "
                         "config's, 'paged')")
    ap.add_argument("--stagger", action="store_true",
                    help="submit requests one engine step apart")
    ap.add_argument("--stream", action="store_true",
                    help="continuous batching: Poisson arrival ticks, "
                         "served via run_stream")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="copy-on-write prefix sharing of block-aligned "
                         "prompt prefixes")
    ap.add_argument("--metrics-out", default=None,
                    help="append one registry snapshot JSONL line here")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome-trace JSON of engine spans and "
                         "request lifecycles")
    ap.add_argument("--deadline-ticks", type=int, default=None)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--max-queue", type=int, default=None)
    args = ap.parse_args(argv)
    if not args.paged:
        ap.error("the port serves with the paged KV cache only: pass --paged")

    if args.sparse_decode and args.exec_mode is not None:
        ap.error("pass either --sparse-decode or --exec-mode, not both")
    if args.ckpt_dir and args.quant_ckpt:
        ap.error("pass either --ckpt-dir or --quant-ckpt, not both: the "
                 "artifact carries its own params")
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    exec_mode = "sparse" if args.sparse_decode else args.exec_mode
    if args.quant_ckpt:
        exec_mode = exec_mode or "quant"
        cfg = dataclasses.replace(cfg, param=dataclasses.replace(
            cfg.param, mode="sltrain"))
    if exec_mode is not None:
        cfg = dataclasses.replace(
            cfg, param=dataclasses.replace(cfg.param, exec_mode=exec_mode))
    params, consts = load_model(cfg, device=args.device,
                                ckpt_dir=args.ckpt_dir,
                                quant_ckpt=args.quant_ckpt)
    trace = obs_trace.Trace(enabled=bool(args.trace_out))
    eng = ServeEngine(cfg, params, consts, n_slots=args.slots,
                      max_len=args.max_len, paged=True,
                      block_len=args.block_len,
                      attn_kernel=args.attn_kernel,
                      prefix_sharing=args.prefix_sharing, trace=trace,
                      max_queue=args.max_queue,
                      deadline_ticks=args.deadline_ticks,
                      deadline_ms=args.deadline_ms,
                      quant_fallback=args.quant_fallback, device=args.device)
    rng = np.random.default_rng(0)
    prompts = []
    shared = rng.integers(3, cfg.vocab_size, size=16).tolist()
    for i in range(args.requests):
        plen = int(rng.integers(2, 8))
        tail = rng.integers(3, cfg.vocab_size, size=plen).tolist()
        # with sharing on, half the prompts open with one common
        # block-alignable prefix
        prompts.append(shared + tail if args.prefix_sharing and i % 2 == 0
                       else tail)
    t0 = time.perf_counter()
    if args.stream:
        arrivals = np.cumsum(rng.poisson(2.0, size=len(prompts)))
        reqs = [eng.submit(p, max_new_tokens=args.new_tokens, arrival=int(a))
                for p, a in zip(prompts, arrivals)]
        stats = eng.run_stream()
    else:
        reqs = []
        if args.stagger:
            it = iter(prompts)
            reqs.append(eng.submit(next(it), max_new_tokens=args.new_tokens))
            for p in it:
                eng.step()
                reqs.append(eng.submit(p, max_new_tokens=args.new_tokens))
        else:
            reqs = [eng.submit(p, max_new_tokens=args.new_tokens)
                    for p in prompts]
        stats = eng.run_until_drained()
    dt = time.perf_counter() - t0
    # every request ends done/rejected/timed_out; failed only when the step
    # budget ran out, which these bounded runs never hit
    if stats["exhausted"] or any(
            r.status not in ("done", "rejected", "timed_out") for r in reqs):
        raise SystemExit(f"requests left unfinished: "
                         f"{[(r.uid, r.status) for r in reqs]}")
    degraded = args.deadline_ticks is not None or \
        args.deadline_ms is not None or args.max_queue is not None
    if not degraded and len(stats["completed"]) != len(reqs):
        raise SystemExit(f"{len(stats['completed'])} of {len(reqs)} "
                         "requests completed")
    total_toks = sum(len(r.out) for r in reqs)
    mode = f"paged/{eng.cfg.attn_kernel}" + ("/stream" if args.stream else "")
    print(f"served {len(reqs)} requests, {total_toks} tokens in {dt:.2f}s "
          f"({total_toks/dt:.1f} tok/s, {stats['decode_steps']} decode steps,"
          f" {eng.dispatches['prefill']} prefill dispatches, {mode},"
          f" exec_mode={eng.cfg.param.exec_mode}, device={eng.device})")
    if eng.quant_fell_back:
        print("  quant fallback: the consts lack the int8 codes; served "
              "through the sparse path (serve.quant_fallback = 1)")
    if args.prefix_sharing:
        pt = eng.prefill_traffic
        print(f"  prefix sharing: {pt['tokens_shared']}/{pt['tokens_total']} "
              "prompt tokens attached from resident pages")
    if args.stream:
        ht = eng.obs.histogram("serve.ttft_ticks")
        hw = eng.obs.histogram("serve.ttft_wall_ms")
        tt = sorted(r.t_first - r.arrival for r in reqs
                    if r.t_first is not None)
        if tt:
            print(f"  TTFT: p50={ht.percentile(50):.0f} ticks "
                  f"(max={tt[-1]}) | p50={hw.percentile(50):.1f}ms "
                  f"p99={hw.percentile(99):.1f}ms wall")
    if eng.timed_out or eng.rejected:
        print(f"  resilience: {stats['summary']}")
    for r in reqs[:4]:
        print(f"  req {r.uid}: prompt {r.prompt} -> {r.out}")
    if args.metrics_out:
        eng.obs.write_jsonl(args.metrics_out,
                            extra={"run": "serve", "arch": args.arch,
                                   "requests": len(reqs)})
        print(f"  metrics snapshot appended to {args.metrics_out}")
    if args.trace_out:
        n = trace.export(args.trace_out)
        print(f"  trace: {n} events -> {args.trace_out}")


if __name__ == "__main__":
    main()
