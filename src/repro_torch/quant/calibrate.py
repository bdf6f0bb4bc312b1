"""One-shot post-training quantizer for SLTrain weights (SLiM-style,
activation-free), the port of ``repro.quant.calibrate``.

Per SLTrain linear (params {B, A, v}, consts {cols[, rows]}):

1. form the dense-equivalent ``W = scale·B·A ⊕ V`` in f32,
2. compute symmetric per-output-channel int8 scales on W (optional
   absmax-clip percentile),
3. quantize the sparse values ``v`` to int8 codes against those scales,
4. fold the residual quantization error ``E = V − dequant(qv)`` into the
   low-rank factors: ``scale·B'·A'`` is the best rank-r approximation of
   ``scale·B·A + E`` (its top r singular triplets, from the eigenpairs of
   its smaller Gram matrix in float64: :func:`_fold`),
5. bake the codes into the quantized tile-CSR layout
   (:mod:`repro_torch.quant.layout`).

Steps 1–3 and 5 are host numpy, as in the reference, so codes, scales and
the layout are bit for bit the reference's on the same inputs. Step 4 and
the error statistics run with torch on the device the params live on: on
the card that is what keeps calibrating llama_1b (168 matrices of
2048×2048 and 2048×5461) short, where a host SVD of each takes seconds.
Singular pairs are unique only up to sign, so B' and A' may differ in
sign from the reference's SVD pair by pair; ``scale·B'·A'`` and the
statistics do not (they agree to the reference's own f32 rounding).

:func:`calibrate_tree` walks a model's (params, consts) trees, stacked
leaves included, and returns the quantized twin: params with B/A replaced,
consts with {qv_t, rows_q, cols_q, qscale} added per linear; everything
else passes through. A stacked linear's lead may nest (an MoE layer
stack's routed experts: layers × experts); every slice is its own matrix,
with its own support, and is quantized in the reference's order, one
slice after another (the fold too: one eigendecomposition a slice).
CLI (the checkpoint of either package, MoE configs included):

  PYTHONPATH=src python -m repro_torch.quant.calibrate --arch llama_60m \\
      --smoke --ckpt-dir /path/to/train/ckpt --out /path/to/artifact \\
      [--device cpu]
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.quant import layout as qlayout


def _is_sl_linear(p) -> bool:
    return isinstance(p, dict) and {"B", "A", "v"} <= set(p.keys())


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _flat_support(v, c: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(rows, cols, values) flat COO of one unstacked linear's support.
    Row-balanced stores implicit rows (k entries per row), in the order
    init reshaped cols to (d_in, k)."""
    if "rows" in c:
        rows = c["rows"].cpu().numpy().reshape(-1)
        cols = c["cols"].cpu().numpy().reshape(-1)
    else:
        cols2 = c["cols"].cpu().numpy()
        d_in, k = cols2.shape
        rows = np.repeat(np.arange(d_in, dtype=np.int32), k)
        cols = cols2.reshape(-1)
    return rows, cols, _host(v).reshape(-1)


def _fold(M: torch.Tensor, r: int, scale: float):
    """(B', A') in f32 with ``scale·B'·A'`` the best rank-``r``
    approximation of ``M``, split as an SVD splits it (B' = U·√(σ/scale),
    A' = √(σ/scale)·Vᵀ over the top ``r`` singular triplets). The triplets
    come from the eigenpairs of M's smaller Gram matrix in float64 (σ² = λ,
    the other side's vectors M·v/σ or Mᵀ·u/σ), not from an SVD of M: in
    float64 the squared condition number costs nothing at f32 output, and
    on the card cuSOLVER's eigensolver takes a fraction of its QR-based
    SVD's time (gesvd; its Jacobi SVD stops at a looser tolerance than the
    LAPACK SVD the reference runs)."""
    M64 = M.double()
    m, n = M64.shape
    tall = m >= n
    lam, Q = torch.linalg.eigh(M64.T @ M64 if tall else M64 @ M64.T)
    # eigh sorts ascending: the top r, largest first
    Q = Q[:, -r:].flip(-1)
    sig = torch.sqrt(torch.clamp(lam[-r:].flip(-1), min=0.0))
    root = torch.sqrt(sig / scale)
    # 1/√(σ·scale) turns M·v (or Mᵀ·u) into u·√(σ/scale); a zero σ's
    # pair adds nothing to the product, as in an SVD
    inv = torch.where(sig > 0, 1.0 / torch.sqrt(sig * scale).clamp(
        min=torch.finfo(torch.float64).tiny), torch.zeros_like(sig))
    if tall:
        B2, A2 = (M64 @ Q) * inv[None, :], root[:, None] * Q.T
    else:
        B2, A2 = Q * root[None, :], inv[:, None] * (Q.T @ M64)
    return B2.float(), A2.float()


def quantize_linear(p: dict, c: dict, *, alpha: float, delta: float,
                    support_kind: str,
                    clip_percentile: Optional[float] = None,
                    fold_error: bool = True) -> Tuple[dict, dict, dict]:
    """Quantize one unstacked SLTrain linear.

    Returns (new_params, quant_consts, stats): params keep {B, A, v}
    dtypes, shapes and device (B/A error-folded when ``fold_error``),
    quant_consts is {qv_t, rows_q, cols_q, qscale} on the params' device,
    and stats carries the max and rms |W − W_quant| of the dense
    equivalent after the fold."""
    dev = p["B"].device
    B = _host(p["B"])
    A = _host(p["A"])
    d_in, r = B.shape
    d_out = A.shape[1]
    scale = alpha / r
    rows, cols, vf = _flat_support(p["v"], c)

    BA = scale * (B @ A)
    W = BA.copy()
    W[rows, cols] += vf
    scales = qlayout.channel_scales(W, clip_percentile=clip_percentile)
    qv = qlayout.quantize_values(vf, cols, scales)
    deq = qlayout.dequantize_values(qv, cols, scales)

    idx = (torch.from_numpy(rows.astype(np.int64)).to(dev),
           torch.from_numpy(cols.astype(np.int64)).to(dev))
    if fold_error:
        # scale·B'·A' := best rank-r approximation of scale·B·A + E, so
        # the serve-time weight scale·B'·A' + dequant(qv) lands as close
        # to W as a rank-r correction can get
        M = torch.from_numpy(BA).to(dev)
        M.index_put_(idx, torch.from_numpy(vf - deq).to(dev),
                     accumulate=True)
        B2, A2 = _fold(M, r, scale)
    else:
        B2 = torch.from_numpy(B).to(dev)
        A2 = torch.from_numpy(A).to(dev)

    Wq = scale * (B2 @ A2)
    Wq.index_put_(idx, torch.from_numpy(deq).to(dev), accumulate=True)
    diff = torch.from_numpy(W).to(dev) - Wq
    stats = {"nnz": int(vf.size),
             "max_abs_err": float(diff.abs().max()),
             "rms_err": float(torch.sqrt(torch.mean(diff * diff)))}
    new_p = dict(p)
    new_p["B"] = B2.to(p["B"].dtype)
    new_p["A"] = A2.to(p["A"].dtype)
    qc = qlayout.build_quant_consts(rows, cols, qv, scales, d_in, d_out,
                                    delta, support_kind)
    return new_p, {k: t.to(dev) for k, t in qc.items()}, stats


def _quantize_stacked(p: dict, c: dict, *, alpha: float, delta: float,
                      support_kind: str,
                      clip_percentile: Optional[float],
                      fold_error: bool, stats: dict) -> Tuple[dict, dict]:
    """Quantize one linear whose leaves may carry leading stack dims (layer
    stacking prepends axes to every leaf, an expert stack one more;
    supports differ per slice): loop over the flattened lead and re-stack.
    Shapes are deterministic (tile_cap), so the stack is never ragged."""
    lead = tuple(p["B"].shape[:-2])
    if not lead:
        new_p, qc, st = quantize_linear(
            p, c, alpha=alpha, delta=delta, support_kind=support_kind,
            clip_percentile=clip_percentile, fold_error=fold_error)
        stats["n_matrices"] += 1
        stats["nnz"] += st["nnz"]
        stats["max_abs_err"] = max(stats["max_abs_err"], st["max_abs_err"])
        return new_p, {**c, **qc}
    n = int(np.prod(lead))

    def slc(t):
        return t.reshape((n,) + tuple(t.shape[len(lead):]))

    ps = {k: slc(v) for k, v in p.items()}
    cs = {k: slc(v) for k, v in c.items()}
    out_p, out_q = [], []
    for i in range(n):
        np_i, qc_i = _quantize_stacked(
            {k: v[i] for k, v in ps.items()},
            {k: v[i] for k, v in cs.items()}, alpha=alpha, delta=delta,
            support_kind=support_kind, clip_percentile=clip_percentile,
            fold_error=fold_error, stats=stats)
        out_p.append(np_i)
        out_q.append(qc_i)

    def restack(dicts):
        return {k: torch.stack([d[k] for d in dicts]).reshape(
            lead + tuple(dicts[0][k].shape)) for k in dicts[0]}

    return restack(out_p), restack(out_q)


def calibrate_tree(params, consts, *, alpha: float, delta: float,
                   support_kind: str = "row_balanced",
                   clip_percentile: Optional[float] = None,
                   fold_error: bool = True):
    """Walk a model's (params, consts) trees and quantize every SLTrain
    linear. Returns (new_params, new_consts, stats); non-linear leaves
    (embeddings, norms) and existing consts pass through untouched."""
    stats = {"n_matrices": 0, "nnz": 0, "max_abs_err": 0.0,
             "format": "sltrain-quant-v1"}

    def walk(p, c):
        if _is_sl_linear(p):
            return _quantize_stacked(
                p, c if isinstance(c, dict) else {}, alpha=alpha,
                delta=delta, support_kind=support_kind,
                clip_percentile=clip_percentile, fold_error=fold_error,
                stats=stats)
        new_p, new_c = {}, {}
        csub = c if isinstance(c, dict) else {}
        for k, v in p.items():
            if isinstance(v, dict):
                sp, sc = walk(v, csub.get(k, {}))
                new_p[k] = sp
                if sc:
                    new_c[k] = sc
            else:
                new_p[k] = v
        for k, v in csub.items():          # consts with no param sibling
            if k not in new_c:
                new_c[k] = v
        return new_p, new_c

    new_params, new_consts = walk(params, consts)
    return new_params, new_consts, stats


def calibrate_model(cfg, params, consts, **kw):
    """Config-driven wrapper: alpha/delta/support_kind from cfg.param."""
    pc = cfg.param
    if pc.mode != "sltrain":
        raise ValueError(f"quant calibration targets mode='sltrain' "
                         f"(got {pc.mode!r})")
    return calibrate_tree(params, consts, alpha=pc.alpha, delta=pc.delta,
                          support_kind=pc.support_kind, **kw)


def calibrate_checkpoint(cfg, ckpt_dir: str, out: str, *, device,
                         clip_percentile: Optional[float] = None,
                         fold_error: bool = True):
    """The CLI's path: restore the params of the training checkpoint under
    ``ckpt_dir`` (either package's) into a seeded init of ``cfg``,
    calibrate them and write the quant artifact to ``out``. Returns
    (params, consts, stats, artifact path)."""
    from repro_torch.ckpt import checkpoint as ckpt_lib
    from repro_torch.models import registry
    params, consts = registry.get_api(cfg).init(cfg, 0, device=device)
    cm = ckpt_lib.CheckpointManager(ckpt_dir)
    tree, _ = cm.restore({"params": params}, allow_config_change=True)
    qp, qc, stats = calibrate_model(cfg, tree["params"], consts,
                                    clip_percentile=clip_percentile,
                                    fold_error=fold_error)
    path = ckpt_lib.save_quant_artifact(out, qp, qc, config_hash=cfg.hash(),
                                        extra=stats)
    return qp, qc, stats, path


def main(argv=None):
    import argparse
    import dataclasses

    from repro_torch.models import registry

    ap = argparse.ArgumentParser(
        description="one-shot int8 calibration of a trained SLTrain "
                    "checkpoint (of either package) into a quant serve "
                    "artifact")
    ap.add_argument("--arch", default="llama_60m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", required=True,
                    help="trained checkpoint dir (launch.train)")
    ap.add_argument("--out", required=True,
                    help="output directory for the quant artifact")
    ap.add_argument("--clip-percentile", type=float, default=None,
                    help="absmax-clip percentile for the channel scales "
                         "(default: exact absmax)")
    ap.add_argument("--no-fold", action="store_true",
                    help="skip the SVD error fold into B/A")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu': "
                         "where the params live and the SVD fold runs")
    args = ap.parse_args(argv)

    cfg = (registry.get_smoke_config(args.arch) if args.smoke
           else registry.get_config(args.arch))
    if cfg.param.mode != "sltrain":
        cfg = dataclasses.replace(
            cfg, param=dataclasses.replace(cfg.param, mode="sltrain"))
    _, _, stats, path = calibrate_checkpoint(
        cfg, args.ckpt_dir, args.out, device=args.device,
        clip_percentile=args.clip_percentile, fold_error=not args.no_fold)
    print(f"quant artifact: {stats['n_matrices']} matrices, "
          f"{stats['nnz']} int8 codes, max |W - Wq| = "
          f"{stats['max_abs_err']:.3e} -> {path}")
    if args.device != "cpu":
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")


if __name__ == "__main__":
    main()
