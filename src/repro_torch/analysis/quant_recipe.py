"""The quantized-serving recipe of the reference's
``benchmarks/quant_bench.py`` (``quant_rows``), on the port: train an
SLTrain model briefly, calibrate it to int8 (``repro_torch.quant``), and
serve the same prompts through a sparse engine (the ``sparse_matmul``
kernel) and a quant engine (``quant_sparse_matmul``), with the reference's
gates.

Rows:

* ``greedy_match`` — the token-level greedy match rate of the two engines
  on the same prompts; the mean and max |Δlogit| between the sparse and
  quant forwards and their eval ppl, on held-out synthetic batches.
  Gated: match rate ≥ ``MIN_MATCH_RATE`` or mean |Δlogit| ≤
  ``MAX_MEAN_ABS_DLOGIT`` (near-tied logits of a briefly trained model can
  flip a token without the distribution moving).
* ``decode_bytes`` — the modeled bytes one decode step reads for the
  sparse term over every quantized matrix (``quant.layout`` accounting:
  12 B a nonzero against 5 B plus per-channel scales). Gated: reduction ≥
  ``MIN_BYTES_REDUCTION``.

The defaults are the reference's: the ``llama_60m`` smoke config, 60
steps at batch 8 × seq 64, AdamW lr 3e-3 with max(1, steps // 10) warmup
steps, data seed 42; eval on 4 SyntheticC4 batches of 8 × 64 (seed 7);
8 requests with prompts from ``default_rng(seed)``, 16 new tokens, 4
slots, max_len 64, block_len 8. Training here runs in exec_mode fused
(the reference trains in dense: the same function), whose init emits the
tile consts the sparse engine reads.

  PYTHONPATH=src python -m repro_torch.analysis.quant_recipe [--device cpu]
  PYTHONPATH=src python -m repro_torch.analysis.quant_recipe \
      --arch llama_1b --no-smoke
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.data.pipeline import SyntheticC4
from repro_torch.device import resolve
from repro_torch.kernels.ops import add_transposed_tiles
from repro_torch.models import registry
from repro_torch.optim import optimizers
from repro_torch.quant import calibrate, layout
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import step as step_lib

Row = Dict[str, object]

# the reference's gates (benchmarks/quant_bench.py), copied: the |Δlogit|
# escape hatch of the greedy gate, pinned and not tuned per run (int8 with
# per-channel scales and the SVD fold holds the smoke model near 1e-2,
# a broken dequant path lands orders of magnitude above)
MAX_MEAN_ABS_DLOGIT = 0.05
MIN_MATCH_RATE = 0.99
MIN_BYTES_REDUCTION = 2.0


def with_exec_mode(cfg, exec_mode: str):
    return dataclasses.replace(cfg, param=dataclasses.replace(
        cfg.param, mode="sltrain", exec_mode=exec_mode))


def train(cfg, steps: int, *, device, seed: int = 0, batch: int = 8,
          seq: int = 64, lr: float = 3e-3):
    """``steps`` AdamW steps on SyntheticC4 (data seed 42) from the seeded
    init, as the reference's ``benchmarks/tables._train`` runs them.
    Returns (params, consts) with ``cfg``'s consts. A loop of its own and
    not the ``Trainer``: the reference's recipe inits from ``seed`` and
    draws its data from seed 42, where the Trainer draws both from one
    seed, and it writes no checkpoint."""
    api = registry.get_api(cfg)
    params, consts = api.init(cfg, seed=seed, device=device)
    opt = optimizers.make(OptimizerConfig(
        lr=lr, warmup_steps=max(1, steps // 10), total_steps=steps))
    state = opt.init(params)
    fn = step_lib.make_train_step(cfg, api, opt)
    tconsts = add_transposed_tiles(consts)
    data = SyntheticC4(cfg.vocab_size, seq, batch, seed=42)
    for _ in range(steps):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in data.next_batch().items()}
        params, state, _ = fn(params, state, tconsts, b)
    return params, consts


def model_sparse_bytes(cfg, qconsts) -> Dict[str, int]:
    """The modeled sparse-term decode bytes summed over every quantized
    matrix (a layer-stacked leaf counts once per slice), at the tile-padded
    shapes of its int8 layout, as the reference counts them."""
    out = {"bf16": 0, "int8": 0}

    def walk(c):
        if not isinstance(c, dict):
            return
        if "qv_t" in c:
            shape = tuple(c["qv_t"].shape)
            n = int(np.prod(shape[:-3])) if shape[:-3] else 1
            nkt, nnt, _ = shape[-3:]
            for kind in out:
                out[kind] += n * layout.sparse_decode_bytes(
                    nkt * layout.TILE, nnt * layout.TILE, cfg.param.delta,
                    cfg.param.support_kind, quant=kind == "int8")
            return
        for v in c.values():
            walk(v)

    walk(qconsts)
    return out


def prompts(vocab: int, requests: int = 8, seed: int = 0):
    """The recipe's prompts: 2–11 tokens each from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [rng.integers(3, vocab, size=int(rng.integers(2, 12))).tolist()
            for _ in range(requests)]


def serve_tokens(cfg, params, consts, prompts, *, exec_mode, new_tokens,
                 device, **kw):
    """Greedy tokens of the recipe's engine (4 slots, max_len 64,
    block_len 8) in ``exec_mode`` for ``prompts``, and the engine."""
    eng = ServeEngine(cfg, params, consts, n_slots=4, max_len=64, paged=True,
                      block_len=8, exec_mode=exec_mode, device=device, **kw)
    reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    st = eng.run_until_drained()
    if len(st["completed"]) != len(prompts) or st["exhausted"]:
        raise RuntimeError(f"{exec_mode} engine left requests unfinished: "
                           f"{[(r.uid, r.status) for r in reqs]}")
    return [r.out for r in reqs], eng


def quant_rows(cfg, params, consts, qparams, qconsts, qstats, *, device,
               requests: int = 8, new_tokens: int = 16, seed: int = 0,
               train_steps=None) -> List[Row]:
    """The recipe's two rows for a trained model (``params``, ``consts``
    with the sparse path's tile consts) and its calibration (``qparams``,
    ``qconsts``, ``qstats`` of ``quant.calibrate``), unrounded."""
    api = registry.get_api(cfg)
    cfg_sp, cfg_q = with_exec_mode(cfg, "sparse"), with_exec_mode(cfg, "quant")
    ev_sp = step_lib.make_eval_step(cfg_sp, api)
    ev_q = step_lib.make_eval_step(cfg_q, api)
    vocab = cfg.vocab_size
    data = SyntheticC4(vocab, 64, 8, seed=7)
    ces_sp, ces_q, dmean, dmax = [], [], [], 0.0
    with torch.no_grad():
        for _ in range(4):
            b = {k: torch.from_numpy(v).to(device)
                 for k, v in data.next_batch().items()}
            ces_sp.append(float(ev_sp(params, consts, b)["ce"]))
            ces_q.append(float(ev_q(qparams, qconsts, b)["ce"]))
            lg_sp, _ = api.apply(cfg_sp, params, consts, b)
            lg_q, _ = api.apply(cfg_q, qparams, qconsts, b)
            d = (lg_sp[..., :vocab].float() - lg_q[..., :vocab].float()).abs()
            dmean.append(float(d.mean()))
            dmax = max(dmax, float(d.max()))
    ppl_sp = float(np.exp(np.mean(ces_sp)))
    ppl_q = float(np.exp(np.mean(ces_q)))
    mean_dlogit = float(np.mean(dmean))

    ps = prompts(vocab, requests, seed)
    outs = {mode: serve_tokens(cfg, p, c, ps, exec_mode=mode,
                               new_tokens=new_tokens, device=device)[0]
            for mode, p, c in (("sparse", params, consts),
                               ("quant", qparams, qconsts))}
    total = sum(len(o) for o in outs["sparse"])
    matched = sum(a == b for sa, sb in zip(outs["sparse"], outs["quant"])
                  for a, b in zip(sa, sb))
    nbytes = model_sparse_bytes(cfg, qconsts)
    return [
        {"bench": "quant_serve", "row": "greedy_match",
         "match_rate": matched / total, "matched_tokens": f"{matched}/{total}",
         "mean_abs_dlogit": mean_dlogit, "max_abs_dlogit": dmax,
         "ppl_bf16": ppl_sp, "ppl_int8": ppl_q,
         "ppl_rel_delta": abs(ppl_q - ppl_sp) / ppl_sp,
         "quant_matrices": qstats["n_matrices"],
         "max_abs_w_err": qstats["max_abs_err"], "train_steps": train_steps},
        {"bench": "quant_serve", "row": "decode_bytes",
         "sparse_bytes_per_tok_bf16": nbytes["bf16"],
         "sparse_bytes_per_tok_int8": nbytes["int8"],
         "reduction_x": nbytes["bf16"] / nbytes["int8"],
         "bytes_per_nnz_bf16": layout.BYTES_PER_NNZ_BF16,
         "bytes_per_nnz_int8": layout.BYTES_PER_NNZ_INT8},
    ]


def gate_failures(rows: List[Row]) -> List[str]:
    """The reference's two gates on ``quant_rows``' rows: what failed."""
    match, nbytes = rows
    bad = []
    if not (match["match_rate"] >= MIN_MATCH_RATE
            or match["mean_abs_dlogit"] <= MAX_MEAN_ABS_DLOGIT):
        bad.append(f"greedy match {match['match_rate']} < {MIN_MATCH_RATE} "
                   f"and mean |dlogit| {match['mean_abs_dlogit']} > "
                   f"{MAX_MEAN_ABS_DLOGIT}")
    if not nbytes["reduction_x"] >= MIN_BYTES_REDUCTION:
        bad.append(f"decode bytes reduction {nbytes['reduction_x']} < "
                   f"{MIN_BYTES_REDUCTION}")
    return bad


def run(cfg, *, steps: int = 60, device="cuda", requests: int = 8,
        new_tokens: int = 16, seed: int = 0) -> List[Row]:
    """Train ``cfg`` (exec_mode fused), calibrate it and return the rows."""
    device = resolve(device)
    cfg = with_exec_mode(cfg, "fused")
    params, consts = train(cfg, steps, device=device, seed=seed)
    qp, qc, qstats = calibrate.calibrate_model(cfg, params, consts)
    return quant_rows(cfg, params, consts, qp, qc, qstats, device=device,
                      requests=requests, new_tokens=new_tokens, seed=seed,
                      train_steps=steps)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="int8 sparse serving against the sparse path on a "
                    "briefly trained SLTrain model, with the reference's "
                    "gates")
    ap.add_argument("--arch", default="llama_60m")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the arch's reduced config (default, as the "
                         "reference's recipe runs); --no-smoke for the "
                         "full config")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu' "
                         "for the kernels' plain PyTorch versions")
    args = ap.parse_args(argv)
    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    rows = run(cfg, steps=args.steps, device=args.device,
               requests=args.requests, new_tokens=args.new_tokens)
    for r in rows:
        print(",".join(f"{k}={v}" for k, v in r.items()))
    bad = gate_failures(rows)
    if bad:
        raise SystemExit("quant_recipe: gates failed: " + "; ".join(bad))
    print("quant_recipe: int8 sparse decode matches the sparse path's greedy "
          "tokens (or stays under the pinned logit bound) and cuts modeled "
          "sparse-term decode bytes >= 2x")
    return rows


if __name__ == "__main__":
    main()
