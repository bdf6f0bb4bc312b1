"""On-card smoke run of the PyTorch + CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds every hand-written kernel from the sources in the checkout and
holds each one against its plain PyTorch version at the real shapes of
the ported paths (with timings; ``adam8bit`` bit for bit at every segment
size the per-layer step updates, and as one grouped launch over a whole
layer's slices, timed beside one launch a slice; the bfloat16 decode of
``paged_attention`` against its own rerun, bit for bit, at the engine's
shapes and at a 1024-key context, with its launch plan printed;
``sl_matmul`` in bfloat16 also against
its own rerun, bit for bit, with both of its variants timed at the
engine's row counts; ``sddmm`` in bfloat16 against its own rerun too,
timed beside the bf16 GEMM of xᵀ·dy with f32 output and beside its padded
operand copies; ``sparse_matmul`` and ``quant_sparse_matmul`` at the
plan's split count and at 1, 2 and the most splits, each against its own
rerun; the bfloat16 ``paged_prefill`` against its rerun, with the launch
plans printed; ``sparse_matmul`` also at the sparse-mode training
calls, M = 2048 tokens, forward and dx with f32 output, each against its
rerun). Then it drives the paths on the paper's ``llama_1b`` config at
full width and depth with random weights from a seed:

* serving: the paged engine in float32 along paths that must give the
  same greedy tokens: fused ``sl_matmul`` + paged kernels, and
  ``sparse_decode=True`` (``sparse_matmul``), each against dense densify
  + gathered attention; the model calibrated to int8 on the card, its
  quant artifact written under build/ and read back bit for bit, and
  served in exec_mode quant (``quant_sparse_matmul``) against a dense
  engine on the dequantized weights. Then each of the three paths once
  in bfloat16, timed, with every kernel's launch count read around the
  run, then profiled;
* training: 3 float32 train steps from one init and one data stream in
  pairs that must agree: exec_mode "fused" (``sl_matmul`` forward and dx,
  ``sddmm`` dV) against "dense" (densify + the eq.-(2) backward), "sparse"
  (``sparse_matmul`` forward and dx over Wᵀ's tiles, ``sddmm`` dV)
  against "dense", per-layer updates against the global step (AdamW),
  and per-layer 8-bit AdamW through the ``adam8bit`` kernel against
  global 8-bit AdamW; then the ``Trainer`` in bfloat16 for 6 steps in
  exec_mode fused and in sparse, timed, with the launch counts read
  around each run and its checkpoint written; a device-only profile of
  one more step of each;
* the paper's baselines, (a): 3 float32 steps of ``llama_1b`` at full
  width and depth, per-layer updates against the global step, for low
  rank with AdamW, ReLoRA with AdamW merging after step 2 (the Trainer's
  merge and seeded redraw in both runs, so step 3 holds the moment reset
  too) and full rank with GaLore-AdamW refreshing P at step 3; none of
  them may launch a kernel of the port;
* the memory path: the ``Trainer`` in bfloat16 with per-layer updates and
  8-bit AdamW (``adam8bit``, one launch a group of the sweep) for 6
  steps, timed, with launch counts, per-layer update times and its peak
  device memory, which must stay below the global AdamW run's, and a
  device-only profile of one more step with ``adam8bit``'s device time;
  then (b), the paper's memory table in bfloat16: full rank, low rank and
  ReLoRA with global AdamW and full rank with GaLore-AdamW (global and
  per-layer) through the ``Trainer`` for 3 steps each, beside the two
  SLTrain runs above, each row with its peak ``max_memory_allocated``
  (reset after init), the bytes of its params and optimizer state, the
  port's ``core.memory.training_estimate`` for it, its step time and the
  card's power limit; per-layer 8-bit SLTrain's peak must stay below full
  rank's, and the measured reduction is printed beside the paper's
  estimate; and, on ``llama_60m``, runs killed at
  step 4 and relaunched from their checkpoint (global AdamW, and
  per-layer 8-bit AdamW) that must end bit-identical to uninterrupted
  ones, optimizer state and 8-bit codes included;
* train, checkpoint, calibrate, serve (``analysis/quant_recipe.py``), at
  ``llama_1b``'s width on 6 of its layers (``RECIPE_LAYERS``):
  the bf16 fused ``Trainer`` for 60 steps writes a checkpoint under
  build/, the calibrate CLI's path turns it into a quant artifact on the
  card, the serve launcher's ``--ckpt-dir`` and ``--quant-ckpt`` paths
  load a sparse and a quant engine, and the recipe's rows (greedy match,
  |Δlogit|, ppl, modeled decode bytes) must pass the reference's gates;
  the same checkpoint served in exec_mode quant without int8 consts under
  ``quant_fallback`` must warn, count the fallback, launch
  ``sparse_matmul`` and never ``quant_sparse_matmul``, and give the
  sparse engine's tokens; then the recipe at its default size
  (``llama_60m`` smoke, 60 steps) with the same gates;
* (c) the paper's Table 2 comparison (``analysis/pretrain_comparison.py``):
  full rank, SLTrain, ReLoRA and low rank at an equal token budget, at the
  reference example's default size with its two asserts as gates, then
  at ``llama_60m`` for 100 steps a mode, gated on finite losses;
* ``llama_7b`` (32 layers, d_model 4096, d_ff 11008, head_dim 128, rank
  1024, delta 0.05), each phase from one init whose supports are sampled
  in worker processes: (7a) every kernel against its plain version at
  the 7B shapes, with the checks above; (7b) the f32 training pairs and
  the f32 engine's tokens at 7B width on 2 layers; (7c) the per-layer
  8-bit ``Trainer`` at full depth, 4 steps, then 3 with remat "full",
  whose peak may not exceed the first's; (7d) full-rank global AdamW at
  2, 4 and 8 layers, its peak fitted in depth and extrapolated to 32
  layers (it does not fit on the card), the per-layer 8-bit peak gated
  below it; (7e) the fused and sparse bf16 engines at full depth, timed
  and profiled.

Any failure exits non-zero. Without a CUDA device, or without the rest of
the repository beside it, it exits non-zero and prints no result.

Output: one line per phase, then a ``{"kernels": [...]}`` JSON line and,
last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

# cuBLAS needs this set before its first call to run deterministically
# (the kill/resume phase turns on torch.use_deterministic_algorithms)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
# operations/s by input type, tensor cores for bf16, CUDA cores for f32.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel vs plain version on the same inputs: |y - y_plain| <= atol +
# rtol * |y_plain|. The kernels keep the plain versions' rounding points,
# so only the order of f32 sums differs (and, in bf16, the one rounding
# of each W tile or output element that such an order can tip).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# a full L2 (50 MB) sweep before each timed launch: the serving path
# reads every weight once per step, so it finds them cold in L2
FLUSH_BYTES = 256 << 20

SL_SOURCE = "src/repro_torch/kernels/csrc/sl_matmul.cu"
PA_SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
SD_SOURCE = "src/repro_torch/kernels/csrc/sddmm.cu"
AD_SOURCE = "src/repro_torch/kernels/csrc/adam8bit.cu"
SP_SOURCE = "src/repro_torch/kernels/csrc/sparse_decode.cu"
REPLACES = {
    "sl_matmul": "src/repro/kernels/sl_matmul.py:63",
    "paged_attention": "src/repro/kernels/paged_attention.py:132",
    "paged_prefill": "src/repro/kernels/paged_attention.py:241",
    "sddmm": "src/repro/kernels/sddmm.py:47",
    "adam8bit": "src/repro/kernels/adam8bit.py:78",
    "sparse_matmul": "src/repro/kernels/sparse_decode.py:57",
    "quant_sparse_matmul": "src/repro/kernels/sparse_decode.py:109",
}
# the kernels each main path must launch
PATH_KERNELS = {
    "serve": ("sl_matmul", "paged_attention", "paged_prefill"),
    "train": ("sl_matmul", "sddmm"),
    "train_per_layer": ("sl_matmul", "sddmm", "adam8bit"),
    "serve_sparse": ("sparse_matmul", "paged_attention", "paged_prefill"),
    "serve_quant": ("quant_sparse_matmul", "paged_attention",
                    "paged_prefill"),
    "train_sparse": ("sparse_matmul", "sddmm"),
    # engines without prefix sharing prefill with the model's own
    # attention: paged_prefill serves only a suffix after shared pages
    "serve_quant_fallback": ("sparse_matmul", "paged_attention"),
    # llama_7b at full width and depth (phases 7c and 7e)
    "train_per_layer_llama_7b": ("sl_matmul", "sddmm", "adam8bit"),
    "serve_llama_7b": ("sl_matmul", "paged_attention", "paged_prefill"),
    "serve_sparse_llama_7b": ("sparse_matmul", "paged_attention",
                              "paged_prefill"),
}
# the quant recipe (train fused, calibrate, serve sparse and quant)
PATH_KERNELS["recipe_llama_1b"] = PATH_KERNELS["recipe_llama_60m"] = (
    "sl_matmul", "sddmm", "sparse_matmul", "quant_sparse_matmul",
    "paged_attention")
EXEC_PATH = {"fused": "serve", "sparse": "serve_sparse",
             "quant": "serve_quant"}
# f32 operations per element of one 8-bit Adam step, counted from
# csrc/adam8bit.cu: the clip 1, dequantize 4, the moments 7, the update
# 9, the requantize 8 (the block maxima, divisions, roundings, the shift)
ADAM8BIT_OPS = 29
# the clip scale the adam8bit checks multiply each gradient by in the
# kernel (any value below 1 that rounds: the step's clip scale)
CLIP = 0.37
# sddmm against its plain version (xᵀ·dy by cuBLAS, then the gather): the
# kernels sum each slot over tokens in another order than the GEMM (f32:
# one chain in token order; bf16: the tensor cores' 16-token steps), and
# the absolute error grows with sqrt(M) times the partial sums' ulp
SDDMM_ATOL, SDDMM_RTOL = 1e-3, 1e-4
# the quant recipe (train, checkpoint, calibrate, serve) and the quant
# fallback at llama_1b's full width on this many of its 24 layers: the
# run must end within its time limit with the llama_7b phases, and
# calibration's time grows with depth (~4.4 s a layer)
RECIPE_LAYERS = 6
# f32 train parity, fused vs dense: step 1 runs from identical parameters,
# so only the order of f32 sums differs (1e-5 relative). From step 2 on,
# Adam divides each gradient by its own magnitude: an element whose
# gradient is near zero can move by up to lr in either path, so later
# losses and norms agree only to 1e-3 relative.
TRAIN_TOL_STEP1 = 1e-5
TRAIN_TOL_LATER = 1e-3


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def arch(cfg) -> str:
    """A config's arch as the launchers name it, with its depth where a
    phase cut it ("llama_7b at 2 of 32 layers")."""
    from repro_torch.models import registry
    name = cfg.name.replace("-", "_")
    if name not in registry.PAPER_ARCHS:
        return name
    full = registry.get_config(name).n_layers
    return name if cfg.n_layers == full else \
        f"{name} at {cfg.n_layers} of {full} layers"


@functools.lru_cache(maxsize=8)
def support_tiles(seed, d_in, d_out, delta):
    """(rows, cols, CPU tile consts) of a row-balanced support at the
    fused capacity, sampled once per shape (a 4096 x 11008 support takes
    about a second on the host) and shared by every kernel case of that
    shape; callers only read them."""
    from repro_torch.core import support
    from repro_torch.kernels import ops
    rows, cols = support.sample_support(seed, d_in, d_out, delta)
    return rows, cols, ops.prepare_tile_consts(
        rows, cols, d_in, d_out, pad=support.tile_cap(d_in, d_out, delta))


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class Timer:
    """Median device time of one call, by CUDA events around each launch,
    with the L2 cache swept before every launch."""

    def __init__(self, device):
        self.flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                 device=device)

    def ms(self, fn, reps: int = 15) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


class Laps:
    """Wall time of each phase of the run and of the run so far, printed
    as the phases end (host clock; the phases end in a sync)."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def __call__(self, label: str) -> None:
        now = time.perf_counter()
        say(f"time: {label} {now - self.last:.1f} s (run so far "
            f"{now - self.start:.1f} s)")
        self.last = now


def kernel_name(mangled: str) -> str:
    """The first length-prefixed name ending in "kernel" in a mangled
    symbol ("...17sl_tc_gemm_kernelEPK..." gives "sl_tc_gemm_kernel")."""
    for i, ch in enumerate(mangled):
        if ch.isdigit() and not mangled[i + 1:i + 2].isdigit():
            j = i
            while j > 0 and mangled[j - 1].isdigit():
                j -= 1
            for k in range(j, i + 1):
                name = mangled[i + 1:i + 1 + int(mangled[k:i + 1])]
                if name.endswith("kernel"):
                    return name
    return mangled


def ptxas_report(log: str):
    """One line per kernel of an ``nvcc -Xptxas -v`` log: its name, its
    registers, its spills, and any line that warns."""
    name, spill = "?", ""
    for line in log.splitlines():
        line = line.strip()
        if "Compiling entry function" in line:
            name = kernel_name(line.split("'")[1])
        elif "spill" in line:
            spill = line
        elif "registers" in line:
            yield f"{name}: {line.split(':', 1)[-1].strip()}; {spill}"
        elif "warning" in line.lower() or "C7519" in line:
            yield f"{name}: {line}"


def bound_ms(nbytes: float, ops: float, dtype):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak for the input type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def support_bytes(nnz: int, *slots) -> int:
    """Bytes of a sparse support's real entries in tile-CSR arrays (its
    values, indices or per-entry output): nnz elements of each. The
    padding slots are layout, not work the function needs."""
    return nnz * sum(t.element_size() for t in slots)


def matmul_call(x, S, out_dtype=None):
    """The library yardstick for x·S on a pre-densified S, and its name:
    ``torch.matmul`` in x's dtype, or ``torch.mm`` with an f32 output
    for a bf16 x."""
    if out_dtype in (None, x.dtype):
        return (lambda: torch.matmul(x, S)), "torch.matmul"
    return ((lambda: torch.mm(x, S, out_dtype=out_dtype)),
            "torch.mm, out_dtype f32,")


def compare(name, got, want, dtype):
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype]
    bad = err > tol + tol * want.float().abs()
    if not torch.isfinite(got.float()).all() or bool(bad.any()):
        fail(f"{name}: kernel disagrees with its plain version: max abs "
             f"err {err.max().item():.3e}, tolerance {tol} (atol = rtol)")
    return float(err.max().item())


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def sl_case(gen, device, d_in, d_out, m, dtype, rank, delta, alpha, seed):
    """One SLTrain linear at real width: a sampled support in tile-CSR
    form, non-zero B (the paper init's B = 0 would hide the low-rank
    half), x of m rows."""
    from repro_torch.kernels import ops
    rows, _, tiles = support_tiles(seed, d_in, d_out, delta)
    r = max(4, min(rank, min(d_in, d_out) // 2))

    def u(shape, lim):
        return ((torch.rand(shape, generator=gen, device=device) * 2 - 1)
                * lim).to(dtype)
    x = torch.randn((m, d_in), generator=gen, device=device).to(dtype)
    B = u((d_in, r), 1.0)
    A = u((r, d_out), (6.0 / d_in) ** 0.5)
    v = u((rows.shape[0],), d_in ** -0.5)
    rows_t = tiles["rows_t"].to(device)
    cols_t = tiles["cols_t"].to(device)
    v_t = ops._gather_tiles(v, tiles["perm"].to(device))
    return x, B, A, v_t, rows_t, cols_t, alpha / r


def time_sl_matmul(timer, label, args, dtype):
    """One sl_matmul case: held against the plain version (and, in bf16,
    against itself on a rerun, bit for bit), timed beside it, beside
    torch.matmul on a pre-densified W, its bound and the design's own
    floor; up to the single pass's row limit also the two-stage variant
    (the crossover), and the padded operand copies where the plan makes
    them."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sl_matmul as slk
    x, B, A, v_t, rt, ct, scale = args
    got = slk.sl_matmul(*args)
    want = ref.sl_matmul_ref(*args)
    torch.cuda.synchronize()
    err = compare(f"sl_matmul {label}", got, want, dtype)
    m, d_in = x.shape
    r, d_out = A.shape
    plan = slk.plan(m, d_in, d_out, r, dtype)
    if dtype == torch.bfloat16 and not torch.equal(got,
                                                   slk.sl_matmul(*args)):
        fail(f"sl_matmul {label}: a rerun on the same inputs gave other "
             f"bits")
    W = ref.densify_tiles(B, A, v_t, rt, ct, scale, dtype)
    W = W[:d_in, :d_out].contiguous()
    t_k = timer.ms(lambda: slk.sl_matmul(*args))
    t_p = timer.ms(lambda: ref.sl_matmul_ref(*args))
    t_l = timer.ms(lambda: torch.matmul(x, W))
    # the least operations the function needs: densify W and multiply
    # (2·K·N·r + 2·M·K·N), or keep it factored, (x·B)·A plus the sparse
    # product (2·M·r·(K + N) + 2·M·nnz), whichever is fewer; nnz counts
    # the support's entries (padding slots hold 0, sampled values never)
    nnz = int((v_t != 0).sum())
    dense_ops = 2.0 * d_in * d_out * r + 2.0 * m * d_in * d_out
    ops_ = min(dense_ops, 2.0 * m * r * (d_in + d_out) + 2.0 * m * nnz)
    b, by = bound_ms(nbytes(x, B, A, got) + support_bytes(nnz, v_t, rt, ct),
                     ops_, dtype)
    # the design's own floor: it densifies W and multiplies, at the peak
    floor = dense_ops / PEAK_OPS[dtype] * 1e3
    row = dict(name="sl_matmul", shape=label, max_abs_err=err,
               tol=TOL[dtype], ms=t_k, plain_ms=t_p, library_ms=t_l,
               bound_ms=b, bound_by=by, variant=plan.variant)
    extra = ""
    if plan.variant == "single_pass":
        two = slk.plan(m, d_in, d_out, r, dtype, small_m_max=0)
        row["two_stage_ms"] = timer.ms(lambda: slk.launch(two, *args))
        extra += f", two-stage variant {row['two_stage_ms']:.4f} ms"
    pads = [name for name, shape in (
        ("x", plan.x_pad), ("B", plan.b_pad), ("A", plan.a_pad)) if shape]
    if pads:
        row["pad_ms"] = timer.ms(lambda: slk.pad_operands(plan, x, B, A))
        extra += (f", of which padded copies of {'/'.join(pads)} "
                  f"{row['pad_ms']:.4f} ms")
    say(f"kernel sl_matmul {label} ({plan.variant}): max_abs_err {err:.3e} "
        f"(tol {TOL[dtype]}) | kernel {t_k:.4f} ms{extra}, plain "
        f"{t_p:.4f} ms, torch.matmul on dense W {t_l:.4f} ms, bound "
        f"{b:.4f} ms ({by}, {ops_ / 1e9:.2f} GFLOP), design floor "
        f"{floor:.4f} ms ({dense_ops / 1e9:.2f} GFLOP)")
    return row


def dname(dtype) -> str:
    return str(dtype).split(".")[-1]


def check_sl_matmul(timer, gen, device, cfg, m_values):
    """Every row count the engine gives the kernel (a decode batch and
    each prefill bucket times the slots), so each variant of the kernel
    is held against the plain version; in bf16 both variants are timed
    at each, which places the crossover."""
    d, f = cfg.d_model, cfg.d_ff
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for (d_in, d_out) in ((d, d), (d, f), (f, d)):
            for m in m_values:
                args = sl_case(gen, device, d_in, d_out, m, dtype,
                               cfg.param.rank, cfg.param.delta,
                               cfg.param.alpha, seed=d_in * 7 + d_out)
                rows.append(time_sl_matmul(
                    timer, f"{m}x{d_in}->{d_out} {dname(dtype)}", args,
                    dtype))
    return rows


def sparse_decode_case(gen, device, d_in, d_out, delta, seed):
    """One linear's sparse term at real width in both decode layouts: the
    f32 tile-CSR of v ~ U(±1/sqrt(d_in)) on a sampled support, and its
    int8 layout (codes against per-channel absmax scales); the support's
    entry count."""
    from repro_torch.kernels import ops
    from repro_torch.quant import layout
    rows, cols, tiles = support_tiles(seed, d_in, d_out, delta)
    v = (torch.rand(rows.shape[0], generator=gen, device=device) * 2 - 1) \
        * d_in ** -0.5
    v_t = ops._gather_tiles(v, tiles["perm"].to(device))
    vh = v.cpu().numpy()
    S = np.zeros((d_in, d_out), np.float32)
    S[rows, cols] = vh
    sc = layout.channel_scales(S)
    q = layout.build_quant_consts(rows, cols,
                                  layout.quantize_values(vh, cols, sc), sc,
                                  d_in, d_out, delta, "row_balanced")
    sp = [v_t] + [tiles[k].to(device) for k in ("rows_t", "cols_t")]
    qp = [q[k].to(device) for k in ("qv_t", "rows_q", "cols_q", "qscale")]
    return sp, qp, rows.shape[0]


def check_sparse_decode(timer, gen, device, cfg, m_values):
    """sparse_matmul and quant_sparse_matmul against their plain versions
    at every (M, K, N) the llama_1b engine gives them (M: the decode batch
    and each prefill bucket times the slots) and with the output the
    engine asks for (sparse_matmul's y in f32, which the sparse linear
    adds to its f32 low-rank term before its one rounding;
    quant_sparse_matmul's in x's dtype), at the plan's split count and
    forced to 1, 2 and the most (one per k-tile) splits, each also
    against its own rerun, bit for bit, within the tolerance of y's
    dtype; timed at the plan's beside the plain version and beside one
    library call on the pre-densified S (dequantized for the int8 layout;
    ``matmul_call``), which the port never calls. The bound: x, the
    support's entries (values and indices), the scales and y moved once
    over the memory rate, or 2·M·nnz operations, the larger."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_decode as spk
    d, f = cfg.d_model, cfg.d_ff
    rows = []
    for (d_in, d_out) in ((d, d), (d, f), (f, d)):
        sp, qp, nnz = sparse_decode_case(gen, device, d_in, d_out,
                                         cfg.param.delta,
                                         seed=d_in * 7 + d_out)
        for dtype in (torch.bfloat16, torch.float32):
            for m in m_values:
                x = torch.randn((m, d_in), generator=gen,
                                device=device).to(dtype)
                label = f"{m}x{d_in}->{d_out} {dname(dtype)}"
                f32_out = " f32 out" if dtype != torch.float32 else ""
                p = spk.plan(m, d_in, d_out, torch.cuda.get_device_properties(
                    device).multi_processor_count)
                nkt = -(-d_in // 128)
                forced = sorted({1, min(2, nkt), p.splits, nkt})
                say(f"sparse_matmul, quant_sparse_matmul {label}: {p.splits} "
                    f"splits of {nkt} k-tiles, {p.blocks} blocks of "
                    f"{p.rows_per_block} rows, f32 partials "
                    f"{p.partial_bytes / 1e6:.3f} MB; checked at splits "
                    f"{forced}")
                # the sparse path's f32 y as its trailing out_dtype argument
                for name, fn, launch, plain, args, out, dense in (
                        ("sparse_matmul", spk.sparse_matmul, spk.launch,
                         ref.sparse_matmul_ref, sp, [torch.float32],
                         ref._tile_dense(*sp)),
                        ("quant_sparse_matmul", spk.quant_sparse_matmul,
                         spk.quant_launch, ref.quant_sparse_matmul_ref, qp,
                         [], ref._tile_dense(*qp[:3]) * qp[3].reshape(1, -1))):
                    lbl = label + (f32_out if out else "")
                    got = fn(x, *args, d_out, *out)
                    want = plain(x, *args, d_out, *out)
                    torch.cuda.synchronize()
                    tol = TOL[got.dtype]
                    err = compare(f"{name} {lbl}", got, want, got.dtype)
                    # the split sum adds the partials in a fixed order
                    for splits in forced:
                        fp = spk.plan(m, d_in, d_out, splits=splits)
                        a = launch(fp, x, *args, d_out, *out)
                        err = max(err, compare(
                            f"{name} {lbl} at {splits} splits", a, want,
                            got.dtype))
                        if not torch.equal(a, launch(fp, x, *args, d_out,
                                                     *out)):
                            fail(f"{name} {lbl} at {splits} splits: a "
                                 f"rerun on the same inputs gave other bits")
                    S = dense[:d_in, :d_out].to(dtype).contiguous()
                    lib, lib_name = matmul_call(x, S, *out)
                    t_k = timer.ms(lambda: fn(x, *args, d_out, *out))
                    t_p = timer.ms(lambda: plain(x, *args, d_out, *out))
                    t_l = timer.ms(lib)
                    ops_ = 2.0 * m * nnz
                    moved = (nbytes(x, got, *args[3:])
                             + support_bytes(nnz, *args[:3]))
                    b, by = bound_ms(moved, ops_, dtype)
                    rows.append(dict(name=name, shape=lbl,
                                     max_abs_err=err, tol=tol,
                                     ms=t_k, plain_ms=t_p, library_ms=t_l,
                                     bound_ms=b, bound_by=by))
                    say(f"kernel {name} {lbl}: max_abs_err {err:.3e} "
                        f"(tol {tol}) | kernel {t_k:.4f} ms, plain "
                        f"{t_p:.4f} ms, {lib_name} on dense S {t_l:.4f} "
                        f"ms, bound {b:.4f} ms ({by}, {moved / 1e6:.2f} "
                        f"MB)")
                    del S
    return rows


def sddmm_library_call(x, dy, gr, gc):
    """The yardstick for sddmm: one PyTorch call of G = xᵀ·dy on x's own
    dtype, then the gather at the slots. In bf16 the tensor cores' GEMM
    with f32 output (``torch.mm(..., out_dtype=f32)``), the function the
    kernel computes; in f32 the f32 GEMM."""
    if x.dtype == torch.float32:
        return lambda: torch.matmul(x.T, dy)[gr, gc]
    return lambda: torch.mm(x.T, dy, out_dtype=torch.float32)[gr, gc]


def time_sddmm(timer, label, x, dy, rt, ct, dtype, nnz):
    """One sddmm case against its plain version (in bf16 also against its
    own rerun, bit for bit), timed beside it, beside one library call of
    xᵀ·dy plus the gather (and, in bf16, beside the f32 GEMM of the
    upcast operands), and beside the padded operand copies where the plan
    makes them. Its bound counts 2·M·nnz operations (one multiply-add per
    support entry and token) and x, dy, the entries' indices and their f32
    dv once each; the bf16 design's own floor is the
    dense G tiles, 2·M·(nkt·128)·(nnt·128), at the bf16 peak (the f32
    kernel samples, so its floor is the bound)."""
    from repro_torch.core.support import TILE
    from repro_torch.kernels import ref
    from repro_torch.kernels import sddmm as sdk
    got = sdk.sddmm(x, dy, rt, ct)
    want = ref.sddmm_ref(x, dy, rt, ct)
    torch.cuda.synchronize()
    atol, rtol = SDDMM_ATOL, SDDMM_RTOL
    err = (got - want).abs()
    if not torch.isfinite(got).all() or bool(
            (err > atol + rtol * want.abs()).any()):
        fail(f"sddmm {label}: kernel disagrees with its plain version: max "
             f"abs err {err.max().item():.3e}, tolerance atol {atol} rtol "
             f"{rtol}")
    err = float(err.max().item())
    if dtype == torch.bfloat16 and not torch.equal(got,
                                                   sdk.sddmm(x, dy, rt, ct)):
        fail(f"sddmm {label}: a rerun on the same inputs gave other bits")
    (m, k), n = x.shape, dy.shape[1]
    nkt, nnt, _ = rt.shape
    plan = sdk.plan(m, k, n, dtype)
    gr, gc = ref._tile_coords(rt, ct)
    lib_fn = sddmm_library_call(x, dy, gr, gc)
    lib_name = ("torch.matmul f32" if dtype == torch.float32 else
                "torch.mm bf16, out_dtype f32")
    t_k = timer.ms(lambda: sdk.sddmm(x, dy, rt, ct))
    t_p = timer.ms(lambda: ref.sddmm_ref(x, dy, rt, ct))
    t_l = timer.ms(lib_fn)
    ops_ = 2.0 * m * nnz
    b, by = bound_ms(nbytes(x, dy) + support_bytes(nnz, rt, ct, got), ops_,
                     dtype)
    row = dict(name="sddmm", shape=label, max_abs_err=err, tol=atol,
               ms=t_k, plain_ms=t_p, library_ms=t_l,
               bound_ms=b, bound_by=by, variant=plan.variant)
    extra = floor = ""
    if dtype == torch.bfloat16:
        dense_ops = 2.0 * m * nkt * TILE * nnt * TILE
        floor_ms = dense_ops / PEAK_OPS[dtype] * 1e3
        floor = (f", design floor {floor_ms:.4f} ms (dense G "
                 f"tiles, {dense_ops / 1e9:.2f} GFLOP)")
        xf, dyf = x.float(), dy.float()
        row["library_f32_ms"] = timer.ms(lambda: torch.matmul(xf.T, dyf)[
            gr, gc])
        extra += (f", torch.matmul f32 of the upcast operands + gather "
                  f"{row['library_f32_ms']:.4f} ms")
        del xf, dyf
    pads = [nm for nm, shape in (("x", plan.x_pad), ("dy", plan.dy_pad))
            if shape]
    pad = ""
    if pads:
        row["pad_ms"] = timer.ms(lambda: sdk.pad_operands(plan, x, dy))
        pad = (f", of which padded copies of {'/'.join(pads)} "
               f"{row['pad_ms']:.4f} ms")
    say(f"kernel sddmm {label} ({plan.variant}): max_abs_err {err:.3e} "
        f"(atol {atol} rtol {rtol}) | kernel {t_k:.4f} ms{pad}, plain "
        f"{t_p:.4f} ms, {lib_name} + gather {t_l:.4f} ms{extra}, bound "
        f"{b:.4f} ms ({by}, {ops_ / 1e9:.2f} GFLOP){floor}")
    return row


def check_train_kernels(timer, gen, device, cfg, m):
    """The training path's kernel calls at M = batch x seq tokens, for each
    projection shape: the forward sl_matmul, the dx sl_matmul on the
    transposed factors and Wᵀ's tile consts, and sddmm."""
    from repro_torch.kernels import ops
    d, f = cfg.d_model, cfg.d_ff
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for (d_in, d_out) in ((d, d), (d, f), (f, d)):
            x, B, A, v_t, rt, ct, scale = sl_case(
                gen, device, d_in, d_out, m, dtype, cfg.param.rank,
                cfg.param.delta, cfg.param.alpha, seed=d_in * 7 + d_out)
            rows.append(time_sl_matmul(
                timer, f"{m}x{d_in}->{d_out} {dname(dtype)}",
                (x, B, A, v_t, rt, ct, scale), dtype))
            dy = torch.randn((m, d_out), generator=gen, device=device).to(
                dtype)
            rows.append(time_sl_matmul(
                timer, f"dx {m}x{d_out}->{d_in} {dname(dtype)}",
                (dy, A.T.contiguous(), B.T.contiguous(),
                 ops.transpose_tiles(v_t), ops.transpose_tiles(ct),
                 ops.transpose_tiles(rt), scale), dtype))
            rows.append(time_sddmm(
                timer, f"{m}x({d_in},{d_out}) {dname(dtype)}", x, dy, rt,
                ct, dtype, int((v_t != 0).sum())))
    return rows


def sparse_train_case(gen, device, d_in, d_out, m, dtype, delta, seed):
    """One linear of the sparse-mode training path at real width: the
    forward call (x (m, d_in), S's f32 tile-CSR, d_out) and the dx call
    (dy (m, d_out), Wᵀ's tiles, d_in), and the support's entry count."""
    from repro_torch.kernels import ops
    rows, _, tiles = support_tiles(seed, d_in, d_out, delta)
    tiles = {k: t.to(device)
             for k, t in ops.add_transposed_tiles(tiles).items()}
    v = (torch.rand(rows.shape[0], generator=gen, device=device) * 2 - 1) \
        * d_in ** -0.5
    v_t = ops._gather_tiles(v, tiles["perm"])
    x = torch.randn((m, d_in), generator=gen, device=device).to(dtype)
    dy = torch.randn((m, d_out), generator=gen, device=device).to(dtype)
    return ((x, [v_t, tiles["rows_t"], tiles["cols_t"]], d_out),
            (dy, [ops.transpose_tiles(v_t), tiles["rows_tT"],
                  tiles["cols_tT"]], d_in), rows.shape[0])


def check_sparse_train_kernels(timer, gen, device, cfg, m):
    """sparse_matmul at the sparse-mode training path's calls, M = batch x
    seq tokens, at the three projection shapes: the forward x·S and dx's
    dy·Sᵀ over Wᵀ's tiles, both with the f32 output that the sparse
    linear adds to its f32 low-rank term before its one rounding; each
    against the plain
    version, against its own rerun bit for bit, timed beside it and beside
    one library call on the pre-densified S (``matmul_call``), within the
    tolerance of y's dtype. Bound: x, the support's entries (f32 value and
    two int32 indices) and y moved once, or 2·M·nnz operations, the
    larger."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_decode as spk
    d, f = cfg.d_model, cfg.d_ff
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for (d_in, d_out) in ((d, d), (d, f), (f, d)):
            fwd, dx, nnz = sparse_train_case(
                gen, device, d_in, d_out, m, dtype, cfg.param.delta,
                seed=d_in * 7 + d_out)
            out = torch.float32
            for what, (x, sp, n) in (("", fwd), ("dx ", dx)):
                k = x.shape[1]
                label = (f"{what}{m}x{k}->{n} {dname(dtype)}"
                         + (" f32 out" if dtype != out else ""))
                got = spk.sparse_matmul(x, *sp, n, out)
                want = ref.sparse_matmul_ref(x, *sp, n, out)
                torch.cuda.synchronize()
                tol = TOL[got.dtype]
                err = compare(f"sparse_matmul {label}", got, want, got.dtype)
                if not torch.equal(got, spk.sparse_matmul(x, *sp, n, out)):
                    fail(f"sparse_matmul {label}: a rerun on the same inputs "
                         "gave other bits")
                S = ref._tile_dense(*sp)[:k, :n].to(dtype).contiguous()
                lib, lib_name = matmul_call(x, S, out)
                t_k = timer.ms(lambda: spk.sparse_matmul(x, *sp, n, out))
                t_p = timer.ms(lambda: ref.sparse_matmul_ref(x, *sp, n, out))
                t_l = timer.ms(lib)
                ops_ = 2.0 * m * nnz
                moved = nbytes(x, got) + support_bytes(nnz, *sp)
                b, by = bound_ms(moved, ops_, dtype)
                p = spk.plan(m, k, n, torch.cuda.get_device_properties(
                    device).multi_processor_count)
                rows.append(dict(name="sparse_matmul", shape=label,
                                 max_abs_err=err, tol=tol, ms=t_k,
                                 plain_ms=t_p, library_ms=t_l, bound_ms=b,
                                 bound_by=by))
                say(f"kernel sparse_matmul {label} (training; {p.splits} "
                    f"split, {p.blocks} blocks of {p.rows_per_block} rows): "
                    f"max_abs_err {err:.3e} (tol {tol}), a rerun bit "
                    f"for bit | kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
                    f"{lib_name} on dense S {t_l:.4f} ms, bound {b:.4f} ms "
                    f"({by}, {moved / 1e6:.2f} MB, {ops_ / 1e9:.2f} GFLOP)")
                del S
    return rows


def linear_shapes(cfg):
    """{name: (d_in, d_out)} of one llama layer's SLTrain linears."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    return {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
            "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d),
            "gate": (d, f), "up": (d, f), "down": (f, d)}


def layer_slices(cfg):
    """({leaf: elements} of one layer's slices that the per-layer step
    updates in the layer's group, {leaf: elements} of the whole stacked
    leaves it defers, whose slices are no whole number of 256-blocks) on
    ``cfg`` (an SLTrain llama config)."""
    from repro_torch.core import support
    d, pc = cfg.d_model, cfg.param
    per_layer = {"ln_attn": d, "ln_mlp": d}
    for name, (a, b) in linear_shapes(cfg).items():
        r = max(4, min(pc.rank, min(a, b) // 2))
        per_layer[f"{name}.A"] = r * b
        per_layer[f"{name}.B"] = a * r
        per_layer[f"{name}.v"] = support.nnz_for(a, b, pc.delta,
                                                 pc.support_kind)
    sliced = {k: n for k, n in per_layer.items() if n % 256 == 0}
    deferred = {k: cfg.n_layers * n for k, n in per_layer.items()
                if n % 256}
    return sliced, deferred


def adam8bit_sizes(cfg):
    """{label: (elements, deferred)} of every segment the per-layer step
    gives the adam8bit kernel on ``cfg``: a layer's slice of each stacked
    leaf whose slices are whole 256-blocks, the whole stacked leaf of
    each other one (the deferred leaves, whose gradient is an f32
    accumulator), and the final norm, the embedding and LM head whole."""
    sliced, deferred = layer_slices(cfg)
    names = {}
    for name, n in sliced.items():
        names.setdefault((n, False), []).append(f"{name} slice")
    for name, n in deferred.items():
        names.setdefault((n, True), []).append(f"{name} deferred")
    names.setdefault((cfg.d_model, False), []).append("ln_f")
    for name in ["embed"] + ([] if cfg.tie_embeddings else ["lm_head"]):
        names.setdefault((cfg.padded_vocab * cfg.d_model, False),
                         []).append(name)
    return {", ".join(v): k for k, v in names.items()}


def adam8bit_case(gen, device, n, dtype, g_dtype, decay):
    """A segment of n elements: p in ``dtype``, a gradient in ``g_dtype``
    and moments quantized from random values."""
    from repro_torch.kernels import adam8bit as adk
    from repro_torch.optim import quant
    p = torch.randn(n, generator=gen, device=device).to(dtype)
    g = (torch.randn(n, generator=gen, device=device) * 1e-2).to(g_dtype)
    m = torch.randn(n, generator=gen, device=device) * 1e-3
    v = torch.randn(n, generator=gen, device=device).abs() * 1e-5
    mc, ms, _ = quant.quantize_blockwise(m, 256, True)
    vc, vs, _ = quant.quantize_blockwise(v, 256, False)
    return adk.Segment(p, g, mc, ms, vc, vs, decay)


def adam8bit_scalars(device, step, wd=0.1):
    from repro_torch.kernels import ops
    return ops.adam8bit_scalars(lr=1e-3, b1=0.9, b2=0.999,
                                bc1=1 - 0.9 ** step, bc2=1 - 0.999 ** step,
                                eps=1e-8, wd=wd, device=device)


def adam8bit_steps(label, segs, clip, device, steps):
    """``steps`` chained steps of the grouped kernel on ``segs`` (one
    launch a step, in place) against the plain version of each segment
    from the same start: every parameter, code and scale must be equal
    bit for bit."""
    from repro_torch.kernels import adam8bit as adk
    from repro_torch.kernels import ref
    plain = [[t.clone() for t in s[:6]] for s in segs]
    for step in range(1, steps + 1):
        scalars = adam8bit_scalars(device, step)
        adk.adam8bit_group(segs, scalars, clip)
        for s, pl in zip(segs, plain):
            want = ref.adam8bit_segment_ref(*pl, scalars, clip,
                                            decay=s.decay)
            pl[0] = want[0]
            pl[2:] = list(want[1:])
        torch.cuda.synchronize()
        for i, (s, pl) in enumerate(zip(segs, plain)):
            for what, a, b in zip(("p", "m_codes", "m_scales", "v_codes",
                                   "v_scales"), (s.p,) + tuple(s[2:6]),
                                  [pl[0]] + pl[2:]):
                if not torch.equal(a, b):
                    err = (a.float() - b.float()).abs().max()
                    fail(f"adam8bit {label} segment {i} step {step}: {what} "
                         f"differs from the plain version (max abs err "
                         f"{err.item():.3e}; bitwise expected)")
    return scalars, plain


def adam8bit_bytes(segs):
    """What a step must move: p, g, codes and scales read once, p, codes
    and scales written once."""
    return sum(nbytes(*s[:6]) + nbytes(s.p, *s[2:6]) for s in segs)


def check_adam8bit(timer, gen, device, cfg, steps=3):
    """The adam8bit kernel against its plain version at every segment
    the llama_1b per-layer step gives it, in bf16 and f32 params, the
    gradient in the trainer's dtype (p's; f32 for a deferred leaf's
    accumulator) under a clip scale of 0.37, with weight decay 0 and 0.1:
    ``steps`` chained steps, and every parameter, code and scale must be
    equal bit for bit (the kernel runs the plain version's IEEE
    operations). Each size is timed as one launch of one segment, in
    place, as the sweep runs it; the bound counts p, g, both codes and
    scales read once and p, codes and scales written once. Then one
    grouped launch over a whole layer's slices, the same check, timed
    beside the per-leaf dispatch (one launch a slice)."""
    from repro_torch.kernels import adam8bit as adk
    from repro_torch.kernels import ref
    clip = torch.tensor(CLIP, device=device)
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for label, (n, deferred) in adam8bit_sizes(cfg).items():
            g_dtype = torch.float32 if deferred else dtype
            for decay in (False, True):
                seg = adam8bit_case(gen, device, n, dtype, g_dtype, decay)
                scalars, plain = adam8bit_steps(label, [seg], clip, device,
                                                steps)
                t_k = timer.ms(lambda: adk.adam8bit_group([seg], scalars,
                                                          clip))
                t_p = timer.ms(lambda: ref.adam8bit_segment_ref(
                    *plain[0], scalars, clip, decay=decay))
                moved = adam8bit_bytes([seg]) + nbytes(scalars, clip)
                b, by = bound_ms(moved, ADAM8BIT_OPS * n, torch.float32)
                shape = (f"{label} n={n} {dname(dtype)} g {dname(g_dtype)} "
                         f"wd {0.1 if decay else 0.0}")
                rows.append(dict(name="adam8bit", shape=shape, n=n,
                                 dtype=dtype, g_dtype=g_dtype,
                                 max_abs_err=0.0, tol=0.0, ms=t_k,
                                 plain_ms=t_p, library_ms=None, bound_ms=b,
                                 bound_by=by))
                say(f"kernel adam8bit {shape}: {steps} steps bit-identical "
                    f"to the plain version (p, codes, scales) | kernel "
                    f"{t_k:.4f} ms, plain {t_p:.4f} ms, bound {b:.4f} ms "
                    f"({by}, {moved / 1e6:.1f} MB)")
                del seg, plain
    rows.append(check_adam8bit_layer(timer, gen, device, cfg, clip, steps))
    return rows


def check_adam8bit_layer(timer, gen, device, cfg, clip, steps):
    """One grouped launch over a whole llama_1b layer's slices (bf16 p and
    g, weight decay on the matrices and off the norms), held bit for bit
    against the plain version over ``steps`` chained steps, and timed
    beside the per-leaf dispatch of the same slices (one launch each, as
    the sweep made them before) and the plain version."""
    from repro_torch.kernels import adam8bit as adk
    from repro_torch.kernels import ref
    sliced, _ = layer_slices(cfg)
    segs = [adam8bit_case(gen, device, n, torch.bfloat16, torch.bfloat16,
                          not name.startswith("ln"))
            for name, n in sliced.items()]
    label = f"layer group ({len(segs)} slices) bfloat16"
    scalars, plain = adam8bit_steps(label, segs, clip, device, steps)
    t_k = timer.ms(lambda: adk.adam8bit_group(segs, scalars, clip))
    t_leaf = timer.ms(lambda: [adk.adam8bit_group([s], scalars, clip)
                               for s in segs])
    t_p = timer.ms(lambda: [ref.adam8bit_segment_ref(
        *pl, scalars, clip, decay=s.decay) for s, pl in zip(segs, plain)])
    n = sum(s.p.numel() for s in segs)
    moved = adam8bit_bytes(segs) + nbytes(scalars, clip)
    b, by = bound_ms(moved, ADAM8BIT_OPS * n, torch.float32)
    say(f"kernel adam8bit {label}, n={n}: {steps} steps bit-identical to "
        f"the plain version, one launch a step | kernel {t_k:.4f} ms, "
        f"per-leaf launches {t_leaf:.4f} ms ({len(segs)} launches), plain "
        f"{t_p:.4f} ms, bound {b:.4f} ms ({by}, {moved / 1e6:.1f} MB)")
    return dict(name="adam8bit", shape=label, n=None, dtype=torch.bfloat16,
                max_abs_err=0.0, tol=0.0, ms=t_k, plain_ms=t_p,
                library_ms=None, bound_ms=b, bound_by=by,
                per_leaf_ms=t_leaf)


def attn_case(gen, device, dtype, *, n_slots, n_kv, group, hd, block_len,
              bps, positions):
    """Random pools and a block table covering each slot's positions;
    positions[s] < 0 marks an idle slot (all-null row, position 0). The
    null block is filled with NaN: the kernels must never let it leak."""
    n_blocks = 1 + n_slots * bps
    shape = (n_blocks, block_len, n_kv, hd)
    k_pool = torch.randn(shape, generator=gen, device=device).to(dtype)
    v_pool = torch.randn(shape, generator=gen, device=device).to(dtype)
    k_pool[0] = float("nan")
    v_pool[0] = float("nan")
    table = torch.zeros((n_slots, bps), dtype=torch.int32)
    pos = torch.zeros(n_slots, dtype=torch.int32)
    nid = 1
    for s, p in enumerate(positions):
        if p < 0:
            continue
        pos[s] = p
        for j in range(p // block_len + 1):
            table[s, j] = nid
            nid += 1
    return k_pool, v_pool, table.to(device), pos.to(device)


def live_kv_bytes(k_pool, table, last_pos):
    """Bytes of K and V in the blocks a slot can see (non-null entries up
    to the block of its last query position)."""
    bl = k_pool.shape[1]
    per_block = k_pool[0].numel() * k_pool.element_size()
    t = table.cpu()
    n = 0
    for s in range(t.shape[0]):
        for j in range(min(t.shape[1], int(last_pos[s]) // bl + 1)):
            n += int(t[s, j] != 0)
    return 2 * n * per_block, n * bl


def sdpa_on_view(q, k_pool, v_pool, table, qpos, scale):
    """One library call as a yardstick: SDPA over the gathered view."""
    n_slots, bps = table.shape
    bl = k_pool.shape[1]
    k = k_pool[table.long()].reshape(n_slots, bps * bl, *k_pool.shape[2:])
    v = v_pool[table.long()].reshape(n_slots, bps * bl, *v_pool.shape[2:])
    kpos = torch.arange(bps * bl, device=q.device)
    mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None]
    qh = q.transpose(1, 2)                      # (S, H, sq, hd)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)
    group = qh.shape[1] // kh.shape[1]
    if group > 1:
        kh = kh.repeat_interleave(group, dim=1)
        vh = vh.repeat_interleave(group, dim=1)
    kh, vh = kh.contiguous(), vh.contiguous()
    fn = torch.nn.functional.scaled_dot_product_attention
    return lambda: fn(qh, kh, vh, attn_mask=mask, scale=scale)


ATTN_CASES = (
    # (label, n_kv, group, softcap, window)
    ("32 heads", 32, 1, 0.0, 0),
    ("GQA group 4", 8, 4, 0.0, 0),
    ("softcap 50", 32, 1, 50.0, 0),
    ("window 24", 8, 4, 0.0, 24),
)
# the bf16 decode at a long context: 4 slots, 64 blocks of 16 keys each,
# positions up to 1023; (label, n_kv, group)
LONG_BPS = 64
LONG_POSITIONS = (1023, 1000, 777, 512)
LONG_CASES = (("32 heads", 32, 1), ("GQA group 4", 8, 4))


def decode_row(timer, label, q, kp, vp, tbl, pos, kw):
    """One decode case: the kernel against its plain version (and, in
    bf16, against itself on a rerun, bit for bit, with its plan printed),
    timed beside the plain version, SDPA on the gathered view and its
    bound (the live K/V pages and q, the table, the positions and the
    output, each once)."""
    from repro_torch.kernels import paged_attention as pak
    from repro_torch.kernels import ref
    dtype = q.dtype
    n_slots, n_kv, group, hd = q.shape
    got = pak.paged_attention(q, kp, vp, tbl, pos, **kw)
    want = ref.paged_attention_ref(q, kp, vp, tbl, pos, **kw)
    torch.cuda.synchronize()
    what = f"paged_attention {label} {dname(dtype)}"
    err = compare(what, got, want, dtype)
    extra = ""
    if dtype == torch.bfloat16:
        if not torch.equal(got, pak.paged_attention(q, kp, vp, tbl, pos,
                                                    **kw)):
            fail(f"{what}: a rerun on the same inputs gave other bits")
        keys = tbl.shape[1] * kp.shape[1]
        plan = pak.decode_plan(n_slots, n_kv, group, hd, keys,
                               torch.cuda.get_device_properties(
                                   q.device).multi_processor_count)
        extra = (f" | plan: {plan.warps} warps a block, {plan.rows} rows "
                 f"of the group, {plan.splits} splits, "
                 f"{n_slots * n_kv * plan.row_blocks * plan.splits} blocks; "
                 "a rerun bit-identical")
    kv_b, keys_live = live_kv_bytes(kp, tbl, pos)
    ops_ = 4.0 * n_kv * group * keys_live * hd
    b, by = bound_ms(nbytes(q, tbl, pos, got) + kv_b, ops_, dtype)
    t_k = timer.ms(lambda: pak.paged_attention(q, kp, vp, tbl, pos, **kw))
    t_p = timer.ms(lambda: ref.paged_attention_ref(q, kp, vp, tbl, pos,
                                                   **kw))
    qd = q.reshape(n_slots, 1, n_kv * group, hd)
    t_l = timer.ms(sdpa_on_view(qd, kp, vp, tbl, pos[:, None],
                                kw["scale"]))
    row = dict(name="paged_attention", shape=f"{label} {dname(dtype)}",
               max_abs_err=err, tol=TOL[dtype], ms=t_k, plain_ms=t_p,
               library_ms=t_l, bound_ms=b, bound_by=by)
    if dtype == torch.bfloat16 and plan.splits > 1:
        one = plan._replace(splits=1)
        row["one_split_ms"] = timer.ms(lambda: pak.decode_launch(
            one, q, kp, vp, tbl, pos, **kw))
        extra += f"; one split {row['one_split_ms']:.4f} ms"
    say(f"kernel {what}: max_abs_err {err:.3e} (tol {TOL[dtype]}) | kernel "
        f"{t_k:.4f} ms, plain {t_p:.4f} ms, SDPA on gathered view "
        f"{t_l:.4f} ms, bound {b:.4f} ms ({by}, {kv_b / 1e6:.2f} MB of live "
        f"K/V){extra}")
    return row


def check_attention(timer, gen, device, cfg, n_slots, block_len, bps,
                    sqs):
    """Decode at the engine's shapes and at a long context, and chunked
    prefill at every suffix bucket in ``sqs``."""
    hd = cfg.resolved_head_dim
    scale = hd ** -0.5
    rows = []
    positions = [min(bps * block_len - 1, 40 + 9 * s) for s in
                 range(n_slots - 1)] + [-1]          # last slot idle
    offsets = [16 * (s % 2) for s in range(n_slots - 1)] + [0]
    for dtype in (torch.bfloat16, torch.float32):
        for label, n_kv, group, cap, win in ATTN_CASES:
            label = f"{label}, hd {hd}"
            kw = dict(scale=scale, softcap=cap, window=win)
            kp, vp, tbl, pos = attn_case(
                gen, device, dtype, n_slots=n_slots, n_kv=n_kv, group=group,
                hd=hd, block_len=block_len, bps=bps, positions=positions)
            q = torch.randn((n_slots, n_kv, group, hd), generator=gen,
                            device=device).to(dtype)
            rows.append(decode_row(timer, label, q, kp, vp, tbl, pos, kw))
            for sq in sqs:
                rows.append(check_prefill(timer, gen, device, dtype, label,
                                          n_kv, group, hd, block_len, bps,
                                          sq, offsets, positions, kw))
    # its own generator: the later phases draw the same B as before
    long_gen = torch.Generator(device=device)
    long_gen.manual_seed(3)
    for label, n_kv, group in LONG_CASES:
        kp, vp, tbl, pos = attn_case(
            long_gen, device, torch.bfloat16, n_slots=len(LONG_POSITIONS),
            n_kv=n_kv, group=group, hd=hd, block_len=block_len, bps=LONG_BPS,
            positions=LONG_POSITIONS)
        q = torch.randn((len(LONG_POSITIONS), n_kv, group, hd),
                        generator=long_gen, device=device).to(torch.bfloat16)
        rows.append(decode_row(
            timer, f"{label}, hd {hd}, {LONG_BPS * block_len}-key context", q,
            kp, vp, tbl, pos, dict(scale=scale)))
        del kp, vp
    return rows


def check_prefill(timer, gen, device, dtype, label, n_kv, group, hd,
                  block_len, bps, sq, offsets, positions, kw):
    """Chunked suffix prefill: sq queries per slot at its offset; slots
    idle in ``positions`` get no pages (all-null rows)."""
    from repro_torch.kernels import paged_attention as pak
    from repro_torch.kernels import ref
    n_slots = len(offsets)
    offs = torch.tensor(offsets, dtype=torch.int32, device=device)
    pre_pos = [o + sq - 1 if p >= 0 else -1
               for o, p in zip(offsets, positions)]
    kp, vp, tbl, _ = attn_case(
        gen, device, dtype, n_slots=n_slots, n_kv=n_kv, group=group,
        hd=hd, block_len=block_len, bps=bps, positions=pre_pos)
    q = torch.randn((n_slots, sq, n_kv, group, hd), generator=gen,
                    device=device).to(dtype)
    got = pak.paged_prefill(q, kp, vp, tbl, offs, **kw)
    want = ref.paged_prefill_ref(q, kp, vp, tbl, offs, **kw)
    torch.cuda.synchronize()
    what = f"paged_prefill sq={sq} {label} {dtype}"
    err = compare(what, got, want, dtype)
    idle = [s for s in range(n_slots) if pre_pos[s] < 0]
    if any(bool((got[s] != 0).any()) for s in idle):
        fail(f"{what}: an idle slot's rows are not exactly zero")
    if dtype == torch.bfloat16:
        if not torch.equal(got, pak.paged_prefill(q, kp, vp, tbl, offs,
                                                  **kw)):
            fail(f"{what}: a rerun on the same inputs gave other bits")
        warps, row_blocks, _ = pak.prefill_plan(sq, group, hd)
        # 64-key stages a block walks: from the first key its rows' window
        # reaches to its last row's position
        win = kw["window"]
        stages = max(-(-(o + sq - (max(0, o - win + 1) if win else 0))
                       // pak.TC_KEYS_PER_STAGE)
                     for o, p in zip(offsets, pre_pos) if p >= 0)
        say(f"paged_prefill sq={sq} {label} bf16: warps a block {warps} "
            f"(16 query rows each), blocks {n_slots * n_kv * row_blocks}, "
            f"stages of {pak.TC_KEYS_PER_STAGE} keys up to {stages}")
    kv_b, _ = live_kv_bytes(kp, tbl, offs + sq - 1)
    ops_ = 0.0
    for s in range(n_slots):
        if pre_pos[s] < 0:
            continue
        keys = offsets[s] + (sq + 1) / 2              # mean causal span
        ops_ += 4.0 * sq * n_kv * group * keys * hd
    b, by = bound_ms(nbytes(q, tbl, offs, got) + kv_b, ops_, dtype)
    t_k = timer.ms(lambda: pak.paged_prefill(q, kp, vp, tbl, offs, **kw))
    t_p = timer.ms(lambda: ref.paged_prefill_ref(q, kp, vp, tbl, offs,
                                                 **kw))
    qpos = offs[:, None] + torch.arange(sq, device=device)[None]
    qd = q.reshape(n_slots, sq, n_kv * group, hd)
    t_l = timer.ms(sdpa_on_view(qd, kp, vp, tbl, qpos, kw["scale"]))
    say(f"kernel paged_prefill sq={sq} {label} {dtype}: max_abs_err"
        f" {err:.3e} (tol {TOL[dtype]}) | kernel {t_k:.4f} ms, plain"
        f" {t_p:.4f} ms, SDPA on gathered view {t_l:.4f} ms, bound "
        f"{b:.4f} ms ({by})")
    return dict(name="paged_prefill", shape=f"sq={sq} {label} "
                f"{str(dtype).split('.')[-1]}", max_abs_err=err,
                tol=TOL[dtype], ms=t_k, plain_ms=t_p, library_ms=t_l,
                bound_ms=b, bound_by=by)


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving engine at llama_1b
# ---------------------------------------------------------------------------

def traffic(vocab: int, n: int = 8, seed: int = 0):
    """n requests: half open with one shared 16-token prefix (a whole
    block), tails of 2-8 tokens, Poisson arrival ticks."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(3, vocab, size=16).tolist()
    prompts = []
    for i in range(n):
        tail = rng.integers(3, vocab, size=int(rng.integers(2, 9))).tolist()
        prompts.append(shared + tail if i % 2 == 0 else tail)
    return prompts, np.cumsum(rng.poisson(2.0, size=n)).tolist()


def _wrappers():
    from repro_torch.kernels import adam8bit as adk
    from repro_torch.kernels import paged_attention as pak
    from repro_torch.kernels import sddmm as sdk
    from repro_torch.kernels import sl_matmul as slk
    from repro_torch.kernels import sparse_decode as spk
    return {"sl_matmul": slk.sl_matmul, "paged_attention":
            pak.paged_attention, "paged_prefill": pak.paged_prefill,
            "sddmm": sdk.sddmm, "adam8bit": adk.adam8bit_update,
            "sparse_matmul": spk.sparse_matmul,
            "quant_sparse_matmul": spk.quant_sparse_matmul}


def launch_counts():
    return {k: fn.launches for k, fn in _wrappers().items()}


def reset_launch_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def serve(cfg, params, consts, prompts, arrivals, *, exec_mode, attn_kernel,
          n_slots, max_len, block_len, new_tokens, device,
          sparse_decode=False):
    """One engine run of the traffic through ``run_stream`` with prefix
    sharing; returns (requests, stats, engine, wall seconds). Each
    dispatch (one prefill or decode program) is bracketed by CUDA events:
    ``stats["span_s"]`` is the device time from each dispatch's start to
    its last kernel's end, summed, and ``stats["token_shapes"]`` the
    (slots, tokens per slot) of every dispatch, from which the row counts
    the kernels saw follow."""
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, params, consts, n_slots=n_slots, max_len=max_len,
                      paged=True, block_len=block_len, exec_mode=exec_mode,
                      sparse_decode=sparse_decode, attn_kernel=attn_kernel,
                      prefix_sharing=True, device=device)
    spans, shapes = [], set()

    def bracket(fn, kind):
        def run(params, consts, tokens, *args, **kwargs):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(params, consts, tokens, *args, **kwargs)
            e.record()
            spans.append((s, e))
            shapes.add((kind, tuple(tokens.shape)))
            return out
        return run
    eng._prefill_fn = bracket(eng._prefill_fn, "prefill")
    eng._decode_fn = bracket(eng._decode_fn, "decode")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=new_tokens, arrival=a)
            for p, a in zip(prompts, arrivals)]
    stats = eng.run_stream()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats["span_s"] = sum(s.elapsed_time(e) for s, e in spans) / 1e3
    stats["token_shapes"] = shapes
    bad = [(r.uid, r.status) for r in reqs if r.status != "done"]
    if bad or stats["exhausted"] or len(stats["completed"]) != len(reqs):
        fail(f"{eng.cfg.param.exec_mode}/{attn_kernel}: requests not "
             f"completed: {bad}")
    for r in reqs:
        if len(r.out) != new_tokens or not all(0 <= t < cfg.vocab_size
                                               for t in r.out):
            fail(f"request {r.uid}: bad output {r.out}")
    return reqs, stats, eng, wall


def top2_gap(cfg, params, consts, tokens, device) -> float:
    """Path B's (dense) top-2 logit gap for the next token after
    ``tokens``: a tie explains a greedy divergence, anything larger is a
    fault."""
    from repro_torch.models import lm
    dense = dataclasses.replace(cfg, param=dataclasses.replace(
        cfg.param, exec_mode="dense"))
    toks = torch.tensor([tokens], dtype=torch.int64, device=device)
    logits, _ = lm.apply_lm(dense, params, consts, toks)
    top = logits[0, -1, :cfg.vocab_size].float().topk(2).values
    return float(top[0] - top[1])


def randomize_b(params, gen):
    """B = 0 in the paper init would multiply away the low-rank half of
    every kernel: draw it U(-1, 1) instead."""
    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif k == "B":
                v.uniform_(-1.0, 1.0, generator=gen)
    walk(params)


def same_tokens(what, a_reqs, b_reqs, cfg, params, consts, device):
    """Greedy tokens of run A against run B, request by request: the only
    excuse for a difference is a top-2 gap below 1e-4 in B's dense logits
    (``params``, ``consts`` are B's weights); the rest of that request is
    then not compared. Returns (equal tokens, ties)."""
    ties, same = [], 0
    for ra, rb in zip(a_reqs, b_reqs):
        for i, (ta, tb) in enumerate(zip(ra.out, rb.out)):
            if ta == tb:
                same += 1
                continue
            gap = top2_gap(cfg, params, consts, rb.prompt + rb.out[:i],
                           device)
            if gap >= 1e-4:
                fail(f"{what}: f32 request {ra.uid} token {i}: {ta} vs {tb}, "
                     f"top-2 gap {gap:.3e} in the dense run (not a tie)")
            ties.append((ra.uid, i, gap))
            break
    return same, ties


def phase_engine_f32(cfg, params, consts, prompts, arrivals, device, **kw):
    """Phase 3: the f32 engine along path A (fused sl_matmul + paged
    kernels) and path B (dense densify + gathered attention). Returns path
    A's dispatch shapes and path B's requests."""
    reset_launch_counts()
    a_reqs, a_stats, _, a_wall = serve(cfg, params, consts, prompts,
                                       arrivals, exec_mode="fused",
                                       attn_kernel="paged", device=device,
                                       **kw)
    a_launches = launch_counts()
    reset_launch_counts()
    b_reqs, _, _, b_wall = serve(cfg, params, consts, prompts, arrivals,
                                 exec_mode="dense", attn_kernel="gather",
                                 device=device, **kw)
    b_launches = launch_counts()
    if any(b_launches.values()):
        fail(f"path B (dense/gather) launched kernels: {b_launches}")
    if not all(a_launches[k] for k in PATH_KERNELS["serve"]):
        fail(f"path A (fused/paged) missed a kernel: {a_launches}")
    same, ties = same_tokens("fused/paged vs dense/gather", a_reqs, b_reqs,
                             cfg, params, consts, device)
    total = sum(len(r.out) for r in a_reqs)
    say(f"engine f32 {arch(cfg)}: {len(a_reqs)} requests, {total} tokens; "
        f"fused/paged == dense/gather on {same}/{total} tokens"
        + (f", ties (uid, token, top-2 gap): {ties}" if ties else "")
        + f" | path A {a_wall:.2f} s launches {a_launches}, path B "
        f"{b_wall:.2f} s")
    return a_stats["token_shapes"], b_reqs


def phase_sparse_f32(cfg, params, consts, prompts, arrivals, b_reqs,
                     device, **kw):
    """The f32 engine with ``sparse_decode=True`` (the ``sparse_matmul``
    kernel + paged kernels) against path B's dense/gather tokens."""
    reset_launch_counts()
    reqs, stats, eng, wall = serve(cfg, params, consts, prompts, arrivals,
                                   exec_mode=None, sparse_decode=True,
                                   attn_kernel="paged", device=device, **kw)
    launches = launch_counts()
    if eng.cfg.param.exec_mode != "sparse":
        fail(f"sparse_decode=True ran exec_mode {eng.cfg.param.exec_mode}")
    if not all(launches[k] for k in PATH_KERNELS["serve_sparse"]) or \
            launches["sl_matmul"] or launches["quant_sparse_matmul"]:
        fail(f"sparse/paged launched the wrong kernels: {launches}")
    same, ties = same_tokens("sparse/paged vs dense/gather", reqs, b_reqs,
                             cfg, params, consts, device)
    total = sum(len(r.out) for r in reqs)
    say(f"engine f32 {arch(cfg)} sparse_decode=True: sparse/paged == "
        f"dense/gather on {same}/{total} tokens"
        + (f", ties (uid, token, top-2 gap): {ties}" if ties else "")
        + f" | {wall:.2f} s, launches {launches}")
    return stats["token_shapes"]


def dequantized(qparams, qconsts):
    """The params of a calibrated tree with every SLTrain linear's v
    replaced by dequant(qv) in v's own (COO) order: each tile slot's code
    times its column's scale, put back through the layout's ``perm``.
    Densified with the error-folded B', A', that is the weight the int8
    decode computes with."""
    from repro_torch.kernels import ops

    def one(v, qv_t, cols_q, qscale, perm):
        nnt = qscale.shape[0]
        nt = torch.arange(nnt, device=qv_t.device).view(1, nnt, 1)
        vals = qv_t.float() * qscale.reshape(-1)[cols_q.long() + 128 * nt]
        return ops._scatter_tiles(vals, perm, v.numel()).reshape(v.shape)

    def walk(p, c):
        if "qv_t" in c:
            v = p["v"]
            lead = v.shape[:-2] if "rows" not in c else v.shape[:-1]
            n = int(np.prod(lead))
            flat = [t.reshape((n,) + tuple(t.shape[len(lead):])) for t in
                    (v, c["qv_t"], c["cols_q"], c["qscale"], c["perm"])]
            out = torch.stack([one(*(t[i] for t in flat)) for i in range(n)])
            return {**p, "v": out.reshape(v.shape).to(v.dtype)}
        return {k: walk(x, c.get(k, {})) if isinstance(x, dict) else x
                for k, x in p.items()}
    return walk(qparams, qconsts)


def phase_quant_f32(cfg, params, consts, prompts, arrivals, device, **kw):
    """Calibrate llama_1b on the card, write the quant artifact under
    build/ and load it back bit for bit, then serve it in exec_mode quant
    (the ``quant_sparse_matmul`` kernel + paged kernels) against a
    dense/gather engine on the dequantized weights (B', A' and v :=
    dequant(qv)): the same greedy tokens. Returns the loaded artifact's
    trees and the quant run's dispatch shapes."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.models.common import tree_leaves
    from repro_torch.quant import calibrate
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qp, qc, st = calibrate.calibrate_model(cfg, params, consts)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    n_lin = len(linear_shapes(cfg)) * cfg.n_layers
    if st["n_matrices"] != n_lin:
        fail(f"calibrate: {st['n_matrices']} matrices, expected {n_lin}")
    say(f"calibrate {arch(cfg)} f32 on the card (host scales and codes, "
        f"torch.linalg.svd fold on the card): {t_cal:.1f} s, n_matrices "
        f"{st['n_matrices']}, {st['nnz']} int8 codes, max_abs_err "
        f"{st['max_abs_err']:.4e}")
    art = os.path.join(ROOT, "build", "chip_smoke_quant")
    t0 = time.perf_counter()
    ckpt.save_quant_artifact(art, qp, qc, config_hash=cfg.hash(), extra=st)
    t_save = time.perf_counter() - t0
    size = sum(os.path.getsize(os.path.join(art, f)) for f in os.listdir(art))
    t0 = time.perf_counter()
    lp, lc, man = ckpt.load_quant_artifact(art, device=device)
    t_load = time.perf_counter() - t0
    shutil.rmtree(art, ignore_errors=True)
    n_leaves = 0
    for saved, loaded in ((qp, lp), (qc, lc)):
        a, b = dict(tree_leaves(saved)), dict(tree_leaves(loaded))
        if a.keys() != b.keys():
            fail(f"artifact: leaves differ: {sorted(a.keys() ^ b.keys())}")
        for key in a:
            if a[key].dtype != b[key].dtype or not torch.equal(a[key],
                                                               b[key]):
                fail(f"artifact: leaf {key} did not load bit for bit")
        n_leaves += len(a)
    if man["extra"]["n_matrices"] != n_lin:
        fail(f"artifact manifest: {man['extra']}")
    say(f"quant artifact: {size / 2**30:.2f} GiB under build/, saved in "
        f"{t_save:.1f} s, loaded in {t_load:.1f} s, {n_leaves} leaves bit "
        "for bit")
    del qp, qc

    reset_launch_counts()
    q_reqs, q_stats, _, q_wall = serve(cfg, lp, lc, prompts, arrivals,
                                       exec_mode="quant",
                                       attn_kernel="paged", device=device,
                                       **kw)
    launches = launch_counts()
    if not all(launches[k] for k in PATH_KERNELS["serve_quant"]) or \
            launches["sl_matmul"] or launches["sparse_matmul"]:
        fail(f"quant/paged launched the wrong kernels: {launches}")
    dp = dequantized(lp, lc)
    reset_launch_counts()
    d_reqs, _, _, d_wall = serve(cfg, dp, lc, prompts, arrivals,
                                 exec_mode="dense", attn_kernel="gather",
                                 device=device, **kw)
    if any(launch_counts().values()):
        fail(f"dense/gather on dequantized weights launched kernels: "
             f"{launch_counts()}")
    same, ties = same_tokens("quant/paged vs dense/gather on dequantized "
                             "weights", q_reqs, d_reqs, cfg, dp, lc, device)
    total = sum(len(r.out) for r in q_reqs)
    say(f"engine f32 {arch(cfg)} exec_mode quant (loaded artifact) == "
        f"dense/gather on the dequantized weights on {same}/{total} tokens"
        + (f", ties (uid, token, top-2 gap): {ties}" if ties else "")
        + f" | quant {q_wall:.2f} s launches {launches}, dense "
        f"{d_wall:.2f} s")
    return lp, lc, q_stats["token_shapes"]


def check_forward(cfg, params, consts, device):
    """The plain forward on a small input: finite logits of the expected
    shape, fused and sparse against dense within f32 tolerance."""
    from repro_torch.models import lm
    toks = torch.arange(3, 19, device=device)[None]
    out = {}
    for mode in ("fused", "sparse", "dense"):
        c = dataclasses.replace(cfg, param=dataclasses.replace(
            cfg.param, exec_mode=mode))
        out[mode], _ = lm.apply_lm(c, params, consts, toks)
    want = (1, 16, cfg.padded_vocab)
    for mode, lg in out.items():
        if tuple(lg.shape) != want or not torch.isfinite(lg).all():
            fail(f"apply_lm {mode}: shape {tuple(lg.shape)} (want {want}) "
                 "or non-finite logits")
    scale = out["dense"].abs().max().item()
    errs = {}
    for mode in ("fused", "sparse"):
        errs[mode] = (out[mode] - out["dense"]).abs().max().item()
        if errs[mode] > 1e-3 * max(1.0, scale):
            fail(f"apply_lm {mode} vs dense: max abs err {errs[mode]:.3e} "
                 f"at logit scale {scale:.3e}")
    say(f"forward f32 {arch(cfg)}: logits {want} finite, max abs err vs dense: "
        f"fused {errs['fused']:.3e}, sparse {errs['sparse']:.3e} (tol 1e-3 x "
        f"max(1, {scale:.2f}))")


def sparse_bytes_per_step(cfg, quant: bool) -> int:
    """Modeled bytes of the sparse term one decode step reads over all
    SLTrain linears (quant.layout.sparse_decode_bytes)."""
    from repro_torch.quant import layout
    pc = cfg.param
    return cfg.n_layers * sum(
        layout.sparse_decode_bytes(a, b, pc.delta, pc.support_kind,
                                   quant=quant)
        for a, b in linear_shapes(cfg).values())


def phase_engine_bf16(cfg, params, consts, prompts, arrivals, device,
                      exec_mode="fused", path=None, **kw):
    """Phase 4: a serving path in bf16 (``exec_mode`` fused, sparse or
    quant, with the paged kernels), timed, with every kernel's launch
    count read around the run, and each kernel of ``path`` (default the
    exec mode's, ``EXEC_PATH``) required to have launched."""
    path = path or EXEC_PATH[exec_mode]
    reset_launch_counts()
    reqs, stats, eng, wall = serve(cfg, params, consts, prompts, arrivals,
                                   exec_mode=exec_mode, attn_kernel="paged",
                                   device=device, **kw)
    launches = launch_counts()
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    if missing:
        fail(f"bf16 {exec_mode} serving path never launched {missing}: "
             f"{launches}")
    kernel = PATH_KERNELS[path][0]
    tokens = sum(len(r.out) for r in reqs)
    hw = eng.obs.histogram("serve.ttft_wall_ms")
    ttft_ms = sorted((r.wall_first - r.wall_arrival) * 1e3 for r in reqs)
    ticks = sorted(r.t_first - r.arrival for r in reqs)
    span = stats["span_s"]
    steps = stats["decode_steps"] + eng.dispatches["prefill"]
    extra = ""
    if exec_mode != "fused":
        extra = (f" | modeled sparse-term bytes per step "
                 f"{sparse_bytes_per_step(cfg, exec_mode == 'quant') / 1e6:.2f}"
                 f" MB ({kernel} launches per step "
                 f"{launches[kernel] / steps:.0f})")
    say(f"engine bf16 {arch(cfg)} ({exec_mode}: {kernel} + paged kernels): "
        f"{len(stats['completed'])}/{len(reqs)} requests done, {tokens} "
        f"tokens in {wall:.3f} s = {tokens / wall:.1f} tokens/s, "
        f"{stats['decode_steps']} decode steps, "
        f"{eng.dispatches['prefill']} prefills, prefix tokens shared "
        f"{eng.prefill_traffic['tokens_shared']}/"
        f"{eng.prefill_traffic['tokens_total']} | TTFT wall ms p50 "
        f"{statistics.median(ttft_ms):.1f} max {ttft_ms[-1]:.1f} "
        f"(histogram p50 {hw.percentile(50):.1f}), ticks p50 "
        f"{statistics.median(ticks)} max {ticks[-1]} | launches {launches}"
        + extra)
    # the device runs nothing between dispatches but the copies of each
    # dispatch's few input and output integers: the wall time outside the
    # dispatch spans is idle time spent on the host's scheduling; idle
    # gaps inside a span (the host launching the next op) are not seen
    say(f"engine bf16 {exec_mode} dispatch spans, same run: {span:.3f} s of "
        f"device time from each dispatch's start to its last kernel's end, "
        f"of wall {wall:.3f} s: idle between dispatches "
        f"{100 * (1 - span / wall):.1f}% (CUDA events around each dispatch)")
    return launches, stats["token_shapes"], wall


def check_coverage(shapes, m_values, sqs, kernel="sl_matmul"):
    """Every row count the engine gave ``kernel`` and every suffix length
    it gave ``paged_prefill`` was held against the plain version (the
    kernel phases check each kernel at every M in ``m_values``, at the
    three projection shapes, in bf16 and f32)."""
    ms = {int(np.prod(s)) for _, s in shapes}
    pre = {s[1] for kind, s in shapes if kind == "prefill"}
    if not ms <= set(m_values) or not pre <= set(sqs):
        fail(f"the engine ran {kernel} at M in {sorted(ms)} and "
             f"paged_prefill at sq in {sorted(pre)}; checked only M in "
             f"{sorted(m_values)} and sq in {sorted(sqs)}")
    say(f"coverage: the engine ran {kernel} at M in {sorted(ms)} and "
        f"paged_prefill at sq in {sorted(pre)}, all checked above")


def phase_profile(cfg, params, consts, prompts, arrivals, device,
                  plain_wall, **kw):
    """Phase 5: where the time of a bf16 engine run goes — device busy
    share and the kernels by device time, from ``torch.profiler``. After
    the launch counts are read; it drives the same run once more, under a
    profiler that records device activity only (no host-side op records,
    which would slow the host and inflate the idle share). Busy and wall
    time come from this one run; ``plain_wall`` (the unprofiled run's
    wall) shows how far the profiler still slowed it."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, stats, _, wall = serve(cfg, params, consts, prompts, arrivals,
                                  device=device, **kw)
    busy = device_busy(prof)
    if busy is None:
        say("profile: the profiler recorded no device time (not measured)")
        return
    busy_us, top = busy
    say(f"profile bf16 engine run, exec_mode {kw['exec_mode']} "
        f"({stats['decode_steps']} decode steps, "
        f"device-only profiler on): wall {wall:.3f} s (unprofiled run "
        f"{plain_wall:.3f} s), device busy {busy_us / 1e6:.3f} s = "
        f"{100 * busy_us / 1e6 / wall:.1f}% (idle "
        f"{100 - 100 * busy_us / 1e6 / wall:.1f}%, same run); device time by "
        "kernel: " + "; ".join(f"{n[:48]} {pct:.1f}%" for n, pct in top))


def device_busy(prof, n_top: int = 6):
    """(busy µs, [(kernel name, % of device time)] for the top ``n_top``)
    from a profiler's device events: busy is the union of the kernels'
    intervals. None when the profiler recorded no device activity."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return None
    busy_us, spans = 0.0, sorted((e.time_range.start, e.time_range.end)
                                 for e in events)
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:                      # union of kernel intervals
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name = {}
    for e in events:
        n = e.name.replace("void ", "").replace("(anonymous namespace)::",
                                                "")
        by_name[n] = by_name.get(n, 0.0) + \
            (e.time_range.end - e.time_range.start)
    total = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n_top]
    return busy_us, [(n, 100 * t / total) for n, t in top]


# ---------------------------------------------------------------------------
# phases 6 to 9: training at llama_1b (and kill/resume at llama_60m)
# ---------------------------------------------------------------------------

class ShapeRecorder:
    """Records the (M, K, N) of every sl_matmul, sddmm and sparse_matmul
    call the trainable linears make, and the (elements, p dtype, g dtype)
    of every segment of an 8-bit Adam update, while it is active, by
    wrapping the ``kernels.ops`` functions they call and the sparse
    kernels' ``plan`` (the kernel wrappers, and their launch counts, are
    untouched)."""

    def __init__(self):
        self.shapes = {"sl_matmul": set(), "sddmm": set(),
                       "sparse_matmul": set()}
        self.adam8bit = set()

    def __enter__(self):
        from repro_torch.kernels import ops
        from repro_torch.kernels import sparse_decode as spk
        self._orig = (ops.sl_matmul, ops.sddmm, ops.adam8bit_group_update,
                      spk.plan)
        sl, sd, ad, plan = self._orig

        def ad_rec(items, **k):
            self.adam8bit.update((p.numel(), p.dtype, g.dtype)
                                 for p, g, *_ in items)
            return ad(items, **k)
        ops.adam8bit_group_update = ad_rec

        def sl_rec(x, B, A, *a, **k):
            self.shapes["sl_matmul"].add((x.numel() // x.shape[-1],
                                          x.shape[-1], A.shape[-1]))
            return sl(x, B, A, *a, **k)

        def sd_rec(x, dy, *a, **k):
            self.shapes["sddmm"].add((x.numel() // x.shape[-1], x.shape[-1],
                                      dy.shape[-1]))
            return sd(x, dy, *a, **k)

        def plan_rec(m, k, n, *a, **kw):
            self.shapes["sparse_matmul"].add((m, k, n))
            return plan(m, k, n, *a, **kw)
        ops.sl_matmul, ops.sddmm, spk.plan = sl_rec, sd_rec, plan_rec
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        from repro_torch.kernels import sparse_decode as spk
        (ops.sl_matmul, ops.sddmm, ops.adam8bit_group_update,
         spk.plan) = self._orig


def train_config(cfg, *, steps, batch, seq, ckpt_dir, ckpt_every=0, lr=3e-3,
                 optimizer="adamw", update_mode="global", **optim_kw):
    """The TrainConfig the port's launcher builds for these flags
    (``optim_kw``: further OptimizerConfig fields, e.g. GaLore's)."""
    from repro_torch.configs.base import (OptimizerConfig, ShardingConfig,
                                          TrainConfig)
    oc = OptimizerConfig(name=optimizer, lr=lr,
                         warmup_steps=max(1, steps // 10), total_steps=steps,
                         **optim_kw)
    return TrainConfig(model=cfg, optim=oc,
                       sharding=ShardingConfig(update_mode=update_mode),
                       seed=0, global_batch=batch, seq_len=seq, steps=steps,
                       log_every=1, ckpt_every=ckpt_every, ckpt_dir=ckpt_dir,
                       async_ckpt=False, keep_ckpts=1)


def train_fn(cfg, api, optimizer, update_mode):
    """The train step the Trainer builds for ``update_mode``."""
    from repro_torch.train import perlayer
    from repro_torch.train import step as step_lib
    if update_mode == "per_layer":
        return perlayer.make_perlayer_train_step(cfg, api, optimizer)
    return step_lib.make_train_step(cfg, api, optimizer)


def adam8bit_launches_per_step(optimizer, params, opt_state):
    """adam8bit launches one per-layer step makes: one for each group of
    the sweep (the head leaves, each layer's slices, the deferred leaves,
    the embedding) and each pair of p and g dtypes in it, plus one for
    every further MAX_SEGMENTS segments of a pair. A gradient has its
    parameter's dtype, except the f32 accumulator of a deferred leaf and
    of a tied embedding (which sums two cotangents in f32)."""
    from collections import Counter
    from repro_torch.kernels.adam8bit import MAX_SEGMENTS
    from repro_torch.models.common import tree_leaves
    f32 = torch.float32
    tied = "lm_head" not in params
    head, layer, deferred, embed = Counter(), Counter(), Counter(), Counter()
    n_layers = 0
    for path, leaf in tree_leaves(params):
        parts = tuple(path.split("/"))
        dt = leaf.dtype
        if parts[0] == "embed":
            embed[(dt, f32 if tied else dt)] += 1
        elif parts[0] != "layers":
            head[(dt, dt)] += 1
        else:
            n_layers = leaf.shape[0]
            st = optimizer.stack_state(optimizer.leaf_state(opt_state, parts),
                                       leaf, n_layers)
            if st is None:
                deferred[(dt, f32)] += 1
            else:
                layer[(dt, dt)] += 1
    launches = lambda c: sum(-(-k // MAX_SEGMENTS) for k in c.values())
    return launches(head) + n_layers * launches(layer) + \
        launches(deferred) + launches(embed)


def param_rel_diff(a, b):
    """The worst relative difference over param leaves: max |a - b| over
    max |b|, leaf by leaf."""
    from repro_torch.models.common import tree_leaves
    worst = 0.0
    for (_, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
        d = (x.float() - y.float()).abs().max().item()
        worst = max(worst, d / max(y.float().abs().max().item(), 1e-30))
    return worst


def phase_train_parity(cfg, device, gen, *, batch, seq, steps=3):
    """Phase 6: f32 training from one init and one SyntheticC4 stream,
    through the train steps the Trainer runs, in pairs that must agree:
    exec_mode fused (sl_matmul forward and dx, sddmm dV) against dense
    (densify + eq.-(2) backward); exec_mode sparse (sparse_matmul forward
    and dx over Wᵀ's tiles, sddmm dV) against dense; per-layer updates
    against the global
    step (AdamW, fused); and per-layer 8-bit AdamW through the adam8bit
    kernel against global 8-bit AdamW (its plain update). B is drawn at
    random, as for serving, so that step 1 covers the low-rank half of
    the forward, dx and dA too (B = 0 makes dA exactly 0). The per-layer
    steps update their params in place: each run starts from a copy."""
    from repro_torch.data.pipeline import SyntheticC4
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.models.common import tree_map
    from repro_torch.optim import optimizers
    tc = train_config(cfg, steps=steps, batch=batch, seq=seq, ckpt_dir="")
    api = registry.get_api(cfg)
    t0 = time.perf_counter()
    params, consts = api.init(cfg, seed=tc.seed, device=device)
    randomize_b(params, gen)
    consts = ops.add_transposed_tiles(consts)
    torch.cuda.synchronize()
    say(f"init {arch(cfg)} f32 for training in {time.perf_counter() - t0:.1f} s")
    data = SyntheticC4(cfg.vocab_size, seq, batch, seed=tc.seed)
    batches = [{"tokens": torch.from_numpy(data.next_batch()["tokens"]).to(
        device)} for _ in range(steps)]
    dense, sparse = (dataclasses.replace(cfg, param=dataclasses.replace(
        cfg.param, exec_mode=mode)) for mode in ("dense", "sparse"))
    # name: (config, optimizer, update mode, kernels it must launch)
    runs = {
        "fused": (cfg, "adamw", "global", ("sl_matmul", "sddmm")),
        "dense": (dense, "adamw", "global", ()),
        "sparse": (sparse, "adamw", "global", ("sparse_matmul", "sddmm")),
        "per_layer adamw": (cfg, "adamw", "per_layer",
                            ("sl_matmul", "sddmm")),
        "global adam8bit": (cfg, "adam8bit", "global",
                            ("sl_matmul", "sddmm")),
        "per_layer adam8bit": (cfg, "adam8bit", "per_layer",
                               ("sl_matmul", "sddmm", "adam8bit")),
    }
    pairs = (("fused", "dense"), ("sparse", "dense"),
             ("per_layer adamw", "fused"),
             ("per_layer adam8bit", "global adam8bit"))
    out, first = {}, {}
    for name, (c, opt_name, mode, kernels) in runs.items():
        opt = optimizers.make(dataclasses.replace(tc.optim, name=opt_name))
        fn = train_fn(c, api, opt, mode)
        p = tree_map(torch.clone, params) if mode == "per_layer" else params
        st = opt.init(p)
        want_adam = adam8bit_launches_per_step(opt, p, st) * steps \
            if "adam8bit" in kernels else 0
        reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = []
        for i, b in enumerate(batches):
            p, st, m = fn(p, st, consts, b)
            rows.append((float(m["loss"]), float(m["grad_norm"]),
                         float(m["nonfinite"])))
            if i == 0 and name in ("per_layer adamw", "fused",
                                   "per_layer adam8bit", "global adam8bit"):
                first[name] = tree_map(torch.clone, p)
        wall = time.perf_counter() - t0
        out[name] = rows
        launches = launch_counts()
        bad = [k for k in ("sl_matmul", "sddmm", "sparse_matmul",
                           "quant_sparse_matmul")
               if bool(launches[k]) != (k in kernels)]
        if bad or launches["adam8bit"] != want_adam:
            fail(f"f32 {name} training launched {launches} (expected "
                 f"{kernels}, adam8bit {want_adam})")
        del p, st
        say(f"train f32 {arch(cfg)} {name} ({opt_name}, {mode}): {steps} steps "
            f"in {wall:.2f} s, (loss, grad_norm, nonfinite) per step {rows}"
            f" | launches {launches}")
    for a_name, b_name in pairs:
        pdiff = (f", worst relative param difference after step 1 "
                 f"{param_rel_diff(first[a_name], first[b_name]):.3e}"
                 if b_name in first else "")
        check_pair(out, a_name, b_name, pdiff)


def check_pair(out, a_name, b_name, extra=""):
    """Fail unless run ``a_name``'s (loss, grad_norm, nonfinite) rows
    agree with ``b_name``'s: step 1 to TRAIN_TOL_STEP1 relative, later
    steps to TRAIN_TOL_LATER, every value finite and no step skipped."""
    for i, (f, d) in enumerate(zip(out[a_name], out[b_name])):
        tol = TRAIN_TOL_STEP1 if i == 0 else TRAIN_TOL_LATER
        for what, a, b in (("loss", f[0], d[0]), ("grad_norm", f[1], d[1])):
            rel = abs(a - b) / max(abs(b), 1e-12)
            if not (np.isfinite(a) and rel <= tol) or f[2] or d[2]:
                fail(f"f32 train step {i + 1}: {a_name} {what} {a!r} vs "
                     f"{b_name} {b!r}, relative difference {rel:.3e} > "
                     f"{tol}")
    rel = [max(abs(f[k] - d[k]) / abs(d[k]) for k in (0, 1))
           for f, d in zip(out[a_name], out[b_name])]
    say(f"train f32 parity: {a_name} vs {b_name} largest relative "
        f"difference of loss and grad norm per step "
        f"{[f'{r:.2e}' for r in rel]} (tol {TRAIN_TOL_STEP1} at step 1, "
        f"{TRAIN_TOL_LATER} after){extra}")


def phase_baseline_parity(cfg, device, *, batch, seq, steps=3):
    """Phase 6b: the paper's baselines in f32 at ``cfg``'s full width and
    depth, per-layer updates against the global step, each pair from one
    init and one SyntheticC4 stream: low rank with AdamW; ReLoRA with
    AdamW and relora_period 2, where both runs merge after step 2 with
    the Trainer's merge and its seeded redraw, so step 3 also holds the
    reset of B's and A's moments; full rank with GaLore-AdamW and
    galore_update_proj_gap 2, so step 3 refreshes P. ReLoRA's B is drawn
    U(-1, 1) (one generator seed for both runs) so that step 1 covers the
    adaptor. These paths run plain PyTorch (matmuls, cuBLAS; GaLore's SVD
    on cuSOLVER): no kernel of the port may launch. Each run inits anew
    from the seed, so only one model's state is on the card at a time."""
    from repro_torch.data.pipeline import SyntheticC4
    from repro_torch.models import registry
    from repro_torch.models.common import tree_leaves
    from repro_torch.optim import optimizers
    from repro_torch.train import trainer as trainer_lib
    data = SyntheticC4(cfg.vocab_size, seq, batch, seed=0)
    batches = [{"tokens": torch.from_numpy(data.next_batch()["tokens"]).to(
        device)} for _ in range(steps)]
    # label: (param.mode, optimizer, ParamConfig fields, optimizer fields)
    cases = {"lowrank adamw": ("lowrank", "adamw", {}, {}),
             "relora adamw": ("relora", "adamw", {"relora_period": 2}, {}),
             "dense galore_adamw": ("dense", "galore_adamw", {},
                                    {"galore_update_proj_gap": 2})}
    for label, (mode, opt_name, pkw, okw) in cases.items():
        c = dataclasses.replace(cfg, param=dataclasses.replace(
            cfg.param, mode=mode, exec_mode="dense", **pkw))
        tc = train_config(c, steps=steps, batch=batch, seq=seq, ckpt_dir="",
                          optimizer=opt_name, **okw)
        api = registry.get_api(c)
        opt = optimizers.make(tc.optim)
        merge = trainer_lib._make_relora_merge(c) if mode == "relora" \
            else None
        out, merges = {}, []
        for update_mode in ("per_layer", "global"):
            t0 = time.perf_counter()
            params, consts = api.init(c, seed=tc.seed, device=device)
            if mode == "relora":
                b_gen = torch.Generator(device=device)
                b_gen.manual_seed(4)
                randomize_b(params, b_gen)
            st = opt.init(params)
            projected = [p for p, _ in tree_leaves(st.get("leaves", {}))
                         if p.endswith("/P")]
            fn = train_fn(c, api, opt, update_mode)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            reset_launch_counts()
            t0 = time.perf_counter()
            rows = []
            for i, b in enumerate(batches):
                params, st, m = fn(params, st, consts, b)
                rows.append((float(m["loss"]), float(m["grad_norm"]),
                             float(m["nonfinite"])))
                if merge is not None and \
                        (i + 1) % c.param.relora_period == 0:
                    params, st = merge(params, st,
                                       trainer_lib.relora_generator(
                                           tc.seed, i + 1, device))
                    merges.append((update_mode, i + 1))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            if any(launches.values()):
                fail(f"f32 {label} {update_mode} launched {launches}: the "
                     "baselines run no kernel of the port")
            n = sum(t.numel() for _, t in tree_leaves(params))
            out[update_mode] = rows
            del params, st, consts
            torch.cuda.empty_cache()
            say(f"train f32 {arch(cfg)} {label} ({update_mode}): "
                f"{n / 1e6:.1f} M params, init {init_s:.1f} s, {steps} steps "
                f"in {wall:.2f} s, (loss, grad_norm, nonfinite) per step "
                f"{rows}")
        extra = f", merged after step 2 in both runs ({merges})" \
            if merges else ""
        if mode == "relora" and merges != [("per_layer", 2), ("global", 2)]:
            fail(f"f32 {label}: merges {merges}, expected one after step 2 "
                 "in each run")
        if opt_name == "galore_adamw":
            extra = (", P formed at step 1 and refreshed at step 3 (gap "
                     f"{tc.optim.galore_update_proj_gap}, rank "
                     f"{tc.optim.galore_rank}), projected leaves "
                     f"{projected}")
        check_pair(out, "per_layer", "global", extra)


class FirstStep:
    """A Trainer fault hook that, before step 1, waits for the card,
    resets the peak of ``max_memory_allocated`` and the launch counts,
    and starts the wall clock (``t0``). The Trainer inits its own state
    (``run()`` with no state), so no caller holds the initial params and
    optimizer state while the steps run, as none does when the launcher
    trains: a global step's old state is the Trainer's alone."""

    def __init__(self):
        self.t0 = None

    def __call__(self, step):
        if step == 0:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            self.t0 = time.perf_counter()


def phase_train_bf16(cfg, device, smi, *, batch, seq, steps=6):
    """Phase 7: the Trainer in bf16 in ``cfg``'s exec mode (fused, or
    sparse), as the launcher runs it: one warm-up step plus five timed,
    its final checkpoint written. Launch counts and the shapes the
    kernels saw are read around the run."""
    from repro_torch.analysis import roofline
    from repro_torch.train.trainer import Trainer
    mode = cfg.param.exec_mode
    ckpt_dir = os.path.join(ROOT, "build", f"chip_smoke_ckpt_{mode}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    tc = train_config(cfg, steps=steps, batch=batch, seq=seq,
                      ckpt_dir=ckpt_dir)
    start = FirstStep()
    tr = Trainer(tc, device=device, log_fn=lambda *a: None,
                 fault_hook=start)
    with ShapeRecorder() as rec:
        state = tr.run()
    wall = time.perf_counter() - start.t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = tr.metrics_history
    dts = [h["dt"] for h in hist]
    losses = [h["loss"] for h in hist]
    if len(hist) != steps or not all(np.isfinite(losses)) or any(
            h["nonfinite"] for h in hist):
        fail(f"bf16 {mode} training: losses {losses}")
    n_lin = 7 * cfg.n_layers
    # forward + dx of each linear on its kernel, dV on sddmm
    linear = {"fused": "sl_matmul", "sparse": "sparse_matmul"}[mode]
    want = {k: 0 for k in launches}
    want.update({linear: 2 * n_lin * steps, "sddmm": n_lin * steps})
    if launches != want:
        fail(f"bf16 {mode} training launched {launches}, expected {want} "
             f"({n_lin} linears x {steps} steps: forward + dx, dV)")
    med = statistics.median(dts[1:])
    tokens = batch * seq
    mfu = roofline.train_mfu(cfg, tokens, med)
    say(f"train bf16 {arch(cfg)} (Trainer, {mode}): {steps} steps, losses "
        f"{[round(x, 4) for x in losses]} | step ms (dispatch + sync) "
        f"{[round(d * 1e3, 1) for d in dts]}, median of steps 2-{steps} "
        f"{med * 1e3:.1f} ms = {tokens / med:.0f} tokens/s, MFU "
        f"{100 * mfu:.3f}% of {roofline.PEAK_FLOPS / 1e12:.0f} TFLOP/s "
        f"(data sheet) | launches per step: {linear} "
        f"{launches[linear] // steps}, sddmm {launches['sddmm'] // steps}"
        f" | max_memory_allocated {peak / 2**30:.2f} GiB | run wall "
        f"{wall:.1f} s incl. checkpoint of step {steps} | {smi}")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return tr, state, launches, rec.shapes, med, peak


def phase_train_profile(tr, state, device, med_s, label="train step",
                        kernels=()):
    """Phase 8: a device-only profile of one more bf16 train step of
    ``tr``: time by kernel and the idle share within that step, and the
    device time and launches of each kernel named in ``kernels``."""
    from torch.profiler import ProfilerActivity, profile
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in tr.data.next_batch().items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, m = tr._train_step(state.params, state.opt_state, state.consts,
                                 batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = device_busy(prof, n_top=8)
    if busy is None:
        say(f"profile {label}: the profiler recorded no device time "
            "(not measured)")
        return
    busy_us, top = busy
    say(f"profile bf16 {label} (device-only profiler on): wall "
        f"{wall * 1e3:.1f} ms (unprofiled median {med_s * 1e3:.1f} ms), "
        f"device busy {busy_us / 1e3:.1f} ms = "
        f"{100 * busy_us / 1e6 / wall:.1f}% (idle "
        f"{100 - 100 * busy_us / 1e6 / wall:.1f}%, same step); device time "
        "by kernel: " + "; ".join(f"{n[:48]} {pct:.1f}%" for n, pct in top))
    for key in kernels:
        ms, n = kernel_device_ms(prof, key)
        say(f"profile bf16 {label}: {key} device time {ms:.3f} ms in {n} "
            f"launches ({100 * ms / (busy_us / 1e3):.1f}% of busy)")


def kernel_device_ms(prof, key):
    """(device ms, launches) of the profiled kernels whose name holds
    ``key``."""
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and
              key in e.name]
    return (sum(e.time_range.end - e.time_range.start for e in events) / 1e3,
            len(events))


def phase_perlayer_bf16(cfg, device, smi, *, batch, seq, global_peak=None,
                        steps=6, remat="none", save=True, handoff=None):
    """Phase 9: the memory path, as ``launch.train --optimizer adam8bit
    --update-mode per_layer --exec-mode fused --layer-timing`` runs it:
    the Trainer in bf16 with per-layer updates and 8-bit AdamW through the
    adam8bit kernel, one warm-up step plus ``steps`` - 1 timed, its final
    checkpoint written unless ``save`` is false. Launch counts, the
    kernels' shapes and the peak of ``torch.cuda.max_memory_allocated``
    (reset after init) are read around the run; the peak must stay below
    ``global_peak`` where one is given. ``remat`` is the layers' policy
    (each sweep then runs each layer's forward twice); ``handoff``, a list
    holding one TrainerState, is popped and trained on instead of the
    Trainer's own init, so that, as with an init, no caller keeps the
    first step's inputs alive (a kept optimizer-state tree pins its old
    step counter)."""
    from repro_torch.analysis import roofline
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.trainer import Trainer
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_ckpt_perlayer")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    tc = train_config(cfg, steps=steps, batch=batch, seq=seq,
                      ckpt_dir=ckpt_dir, optimizer="adam8bit",
                      update_mode="per_layer")
    tc = dataclasses.replace(tc, sharding=dataclasses.replace(
        tc.sharding, remat=remat))
    start = FirstStep()
    tr = Trainer(tc, device=device, log_fn=lambda *a: None,
                 layer_timing=True, fault_hook=start)
    if not save:
        tr.save = lambda *a, **k: None
    with ShapeRecorder() as rec:
        state = tr.run(state=dataclasses.replace(handoff.pop(), step=0)
                       if handoff else None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start.t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    per_step = adam8bit_launches_per_step(tr.optimizer, state.params,
                                          state.opt_state)
    consts_b = sum(nbytes(t) for _, t in tree_leaves(state.consts))
    hist = tr.metrics_history
    dts = [h["dt"] for h in hist]
    losses = [h["loss"] for h in hist]
    if len(hist) != steps or not all(np.isfinite(losses)) or any(
            h["nonfinite"] for h in hist):
        fail(f"bf16 per-layer training: losses {losses}")
    n_lin = 7 * cfg.n_layers
    # a forward, then a forward and a backward per layer in each sweep;
    # under remat each sweep runs each layer's forward once more
    fwd = 5 if remat == "none" else 7
    want = {k: 0 for k in launches}
    want.update(sl_matmul=fwd * n_lin * steps, sddmm=2 * n_lin * steps,
                adam8bit=per_step * steps)
    if launches != want:
        fail(f"bf16 per-layer training launched {launches}, expected {want}")
    lt = tr.obs.get("train.perlayer.layer_update_ms")
    if lt is None or lt.count != cfg.n_layers * steps:
        fail("per-layer timing recorded "
             f"{None if lt is None else lt.count} layer updates, expected "
             f"{cfg.n_layers * steps}")
    med = statistics.median(dts[1:])
    tokens = batch * seq
    mfu = roofline.train_mfu(cfg, tokens, med)
    init = tr.obs.get("init.seconds")
    init = (f"init {init.value:.1f} s with "
            f"{tr.obs.get('init.sampling_workers').value:.0f} support "
            "sampling workers" if init is not None else "state passed in")
    est = memory_estimate(cfg, "sltrain", "adam8bit", "per_layer")
    nstate = state_bytes(state)
    say(f"train bf16 {arch(cfg)} (Trainer, per_layer, adam8bit, fused, remat "
        f"{remat}): {steps} steps, losses {[round(x, 4) for x in losses]} | "
        f"step ms (dispatch + sync) {[round(d * 1e3, 1) for d in dts]}, "
        f"median of steps 2-{steps} {med * 1e3:.1f} ms = {tokens / med:.0f} "
        f"tokens/s, MFU {100 * mfu:.3f}% of {roofline.PEAK_FLOPS / 1e12:.0f} "
        f"TFLOP/s (data sheet) | launches per step: sl_matmul "
        f"{launches['sl_matmul'] // steps}, sddmm "
        f"{launches['sddmm'] // steps}, adam8bit "
        f"{launches['adam8bit'] // steps} | train.perlayer.layer_update_ms "
        f"over {lt.count} layer updates: mean {lt.sum / lt.count:.2f} "
        f"(histogram bucket p50 {lt.percentile(50):.0f}) | {init} | run "
        f"wall {wall:.1f} s"
        + (f" incl. checkpoint of step {steps}" if save else
           " (final checkpoint not written)") + f" | {smi}")
    say(f"memory bf16 {arch(cfg)} per_layer + adam8bit, remat {remat}: "
        f"max_memory_allocated {peak} B = {peak / 2**30:.3f} GiB | params + "
        f"optimizer state {nstate / 2**30:.3f} GiB, training_estimate "
        f"(f32 moments, int32 indices) params + optimizer "
        f"{(est.param_bytes + est.optim_bytes) / 2**30:.3f} GiB, with grads "
        f"and transients {est.total_bytes / 2**30:.3f} GiB | the fused "
        f"linear's tile consts for W and Wᵀ, outside the trees, "
        f"{consts_b / 2**30:.3f} GiB"
        + (f" | SLTrain global AdamW {global_peak / 2**30:.2f} GiB (same "
           "script run)" if global_peak is not None else ""))
    if global_peak is not None and not peak < global_peak:
        fail(f"per-layer peak {peak / 2**30:.2f} GiB is not below the global "
             f"AdamW peak {global_peak / 2**30:.2f} GiB")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return tr, state, launches, rec.adam8bit, med, peak


def state_bytes(state) -> int:
    """Bytes of a TrainerState's params and optimizer state, leaf by leaf
    (the consts, the fixed supports, are not in either tree)."""
    from repro_torch.models.common import tree_leaves
    return sum(nbytes(t) for tree in (state.params, state.opt_state)
               for _, t in tree_leaves(tree))


# The memory table's rows: label -> (param.mode, optimizer, update mode,
# the estimator's method) for the baselines the table runs itself; the two
# SLTrain rows come from the phases above.
MEMORY_ROWS = {
    "full rank, AdamW, global": ("dense", "adamw", "global", "full"),
    "low rank, AdamW, global": ("lowrank", "adamw", "global", "lowrank"),
    "ReLoRA, AdamW, global": ("relora", "adamw", "global", "relora"),
    "full rank, GaLore-AdamW, global": ("dense", "galore_adamw", "global",
                                        "full"),
    "full rank, GaLore-AdamW, per_layer": ("dense", "galore_adamw",
                                           "per_layer", "full"),
}
# why the state bytes differ from the estimator's (paper Table 8
# conventions) where no gate holds them together
MEMORY_GAP_CAUSE = {
    "relora": "W0 is trained, with f32 moments, as in the reference "
              "(its rl_matmul has no stop-gradient); the estimator gives "
              "W0 no moments",
    "galore_adamw": "only lm_head is projected, as in the reference (its "
                    "is_proj wants 2-D leaves; layer leaves are stacked, "
                    "3-D), so every other leaf keeps full f32 moments; the "
                    "estimator projects every adapted matrix, in bf16",
    "sltrain": "the estimator counts int32 COO indices in its params; "
               "they are consts here, outside these trees",
}
# full rank and low rank: params plus f32 moments as the estimator counts
# them, less the norm weights it leaves out
MEMORY_STATE_TOL = 0.005


def memory_estimate(cfg, method, optimizer, update_mode, galore_rank=None):
    """The port's ``core.memory.training_estimate`` for one row, with
    f32 moments (``moment_bytes=4``, the reference's convention for
    measured residency) and int32 indices."""
    from repro_torch.core import memory
    pc = cfg.param
    inv = memory.llama_inventory(
        n_layers=cfg.n_layers, d_model=cfg.d_model, d_ff=cfg.d_ff,
        vocab=cfg.padded_vocab, n_heads=cfg.n_heads,
        tie_embeddings=cfg.tie_embeddings)
    return memory.training_estimate(
        inv, method, optimizer=optimizer, update_mode=update_mode,
        rank=pc.rank, delta=pc.delta, support_kind=pc.support_kind,
        index_bytes=4, moment_bytes=4, galore_rank=galore_rank,
        fused_opt=optimizer == "adam8bit")


def memory_line(cfg, label, row, est, cause, smi):
    """One row of the memory table, unrounded where it counts."""
    want = est.param_bytes + est.optim_bytes
    gap = row["state"] / want - 1
    tokens = row["tokens"]
    say(f"memory bf16 {arch(cfg)} {label}: max_memory_allocated "
        f"{row['peak']} B = {row['peak'] / 2**30:.3f} GiB | params + "
        f"optimizer state {row['state']} B = {row['state'] / 2**30:.3f} "
        f"GiB | training_estimate (f32 moments, int32 indices) params + "
        f"optimizer {want / 2**30:.3f} GiB, state gap {100 * gap:+.3f}%"
        + (f" ({cause})" if cause else "")
        + f", estimate with grads and transients {est.total_bytes / 2**30:.3f}"
        f" GiB | step ms median {row['med'] * 1e3:.1f} = "
        f"{tokens / row['med']:.0f} tokens/s | losses "
        f"{[round(x, 4) for x in row['losses']]} | {smi}")
    return gap


def memory_row(cfg, device, *, mode, optimizer, update_mode, batch, seq,
               steps=3):
    """One baseline through the Trainer in bf16 for ``steps`` steps (one
    warm-up): the peak of ``max_memory_allocated`` after a reset that
    follows init (``FirstStep``), the bytes of params and optimizer state,
    the median step time of the later steps, the losses. The Trainer's
    final checkpoint is not written: the row measures the steps."""
    from repro_torch.train.trainer import Trainer
    c = dataclasses.replace(cfg, param=dataclasses.replace(
        cfg.param, mode=mode, exec_mode="dense"))
    tc = train_config(c, steps=steps, batch=batch, seq=seq,
                      ckpt_dir=os.path.join(ROOT, "build",
                                            "chip_smoke_ckpt_memory"),
                      optimizer=optimizer, update_mode=update_mode)
    shutil.rmtree(tc.ckpt_dir, ignore_errors=True)
    tr = Trainer(tc, device=device, log_fn=lambda *a: None,
                 fault_hook=FirstStep())
    tr.save = lambda *a, **k: None
    state = tr.run()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = launch_counts()
    nstate = state_bytes(state)
    hist = tr.metrics_history
    losses = [h["loss"] for h in hist]
    if len(hist) != steps or not all(np.isfinite(losses)) or any(
            h["nonfinite"] for h in hist):
        fail(f"bf16 {mode} {optimizer} {update_mode}: losses {losses}")
    if any(launches.values()):
        fail(f"bf16 {mode} {optimizer} {update_mode} launched {launches}: "
             "the baselines run no kernel of the port")
    row = {"peak": peak, "state": nstate, "losses": losses,
           "med": statistics.median(h["dt"] for h in hist[1:]),
           "tokens": batch * seq, "galore_rank": tc.optim.galore_rank}
    del tr, state
    shutil.rmtree(tc.ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return row


def phase_memory_table(cfg, device, smi, *, batch, seq, sltrain_rows):
    """Phase 9b: the paper's memory comparison (Table 8, and its "up to
    73%" against full-rank AdamW) on the card, in bf16 on one batch shape:
    each baseline of MEMORY_ROWS through the Trainer for 3 steps, beside
    the two SLTrain rows the phases above measured (``sltrain_rows``:
    fused global AdamW and per-layer 8-bit AdamW, 6 steps each). Gates:
    every loss finite; the per-layer 8-bit SLTrain peak below the full-rank
    global AdamW peak; full rank's and low rank's params + optimizer state
    within MEMORY_STATE_TOL of the estimator's. Printed without a gate:
    the measured reduction beside ``paper_f_reduction("1b")``, and the
    other rows' state against the estimator with the gap's cause."""
    from repro_torch.core import memory
    rows = {}
    for label, (mode, opt, update_mode, method) in MEMORY_ROWS.items():
        row = memory_row(cfg, device, mode=mode, optimizer=opt,
                         update_mode=update_mode, batch=batch, seq=seq)
        est = memory_estimate(cfg, method, opt, update_mode,
                              galore_rank=row["galore_rank"])
        cause = MEMORY_GAP_CAUSE.get(mode) or MEMORY_GAP_CAUSE.get(opt)
        gap = memory_line(cfg, label, row, est, cause, smi)
        if method in ("full", "lowrank") and opt == "adamw" and \
                abs(gap) > MEMORY_STATE_TOL:
            fail(f"memory {label}: params + optimizer state "
                 f"{row['state']} B is {100 * gap:+.3f}% from the "
                 f"estimator's, beyond {100 * MEMORY_STATE_TOL}%")
        rows[label] = row
    for label, (row, opt, update_mode) in sltrain_rows.items():
        est = memory_estimate(cfg, "sltrain", opt, update_mode)
        memory_line(cfg, label, row, est, MEMORY_GAP_CAUSE["sltrain"],
                    smi)
        rows[label] = row
    full = rows["full rank, AdamW, global"]["peak"]
    lean = rows["SLTrain, 8-bit AdamW, per_layer (fused)"]["peak"]
    paper = memory.paper_f_reduction("1b", index_bytes=4)
    say(f"memory bf16 {arch(cfg)}: per-layer 8-bit SLTrain {lean / 2**30:.3f} "
        f"GiB against full-rank global AdamW {full / 2**30:.3f} GiB: "
        f"{100 * (1 - lean / full):.2f}% less measured (peaks, activations "
        f"included), beside paper_f_reduction('1b', index_bytes=4) "
        f"{100 * paper['reduction']:.1f}% ({paper['full_G']:.2f} -> "
        f"{paper['lean_G']:.2f} GB; the paper's convention: bf16 moments, "
        f"no activations) | {smi}")
    if not lean < full:
        fail(f"per-layer 8-bit SLTrain peak {lean / 2**30:.3f} GiB is not "
             f"below the full-rank global AdamW peak {full / 2**30:.3f} GiB")


def phase_comparison(device):
    """Phase 14: ``analysis/pretrain_comparison.py`` on the card: the four
    parameterizations at an equal token budget, at the reference example's
    default size (dim 128, 300 steps, batch 8 × seq 128) with its two
    asserts as gates, then at ``llama_60m`` (the paper config, full width)
    for 100 steps a mode, gated only on finite losses."""
    from repro_torch.analysis import pretrain_comparison as cmp
    root = os.path.join(ROOT, "build")
    os.makedirs(root, exist_ok=True)
    for label, kw in (("default size (dim 128)", dict(steps=300)),
                      ("llama_60m", dict(size="60m", steps=100))):
        t0 = time.perf_counter()
        res = cmp.compare(device=device, ckpt_root=root,
                          log_fn=lambda *a: None, **kw)
        wall = time.perf_counter() - t0
        for line in cmp.table(res):
            say(f"comparison {label}: {line}")
        bad = [m for m, r in res.items() if not np.isfinite(r["losses"]).all()]
        if bad:
            fail(f"comparison {label}: non-finite losses in {bad}")
        gates = ""
        if "size" not in kw:
            failed = cmp.gate_failures(res)
            if failed:
                fail(f"comparison {label}: " + "; ".join(failed))
            gates = ("; gates passed: SLTrain's ppl below low rank's, its "
                     "params below full rank's")
        say(f"comparison {label}: {kw['steps']} steps a mode, batch 8 x seq "
            f"128, final losses " + ", ".join(
                f"{m} {r['losses'][-1]:.4f}" for m, r in res.items())
            + f" | {wall:.1f} s{gates}")


def recipe_line(label, rows, extra=""):
    """Print the quant recipe's two rows, unrounded, and fail if a gate of
    the reference's does not hold."""
    from repro_torch.analysis import quant_recipe
    for r in rows:
        say(f"recipe {label}: " + ", ".join(
            f"{k}={v}" for k, v in r.items() if k != "bench"))
    say(f"recipe {label}: {extra}")
    bad = quant_recipe.gate_failures(rows)
    if bad:
        fail(f"recipe {label}: " + "; ".join(bad))
    say(f"recipe {label}: gates passed (match rate >= "
        f"{quant_recipe.MIN_MATCH_RATE} or mean |dlogit| <= "
        f"{quant_recipe.MAX_MEAN_ABS_DLOGIT}; bytes reduction >= "
        f"{quant_recipe.MIN_BYTES_REDUCTION})")


def phase_recipe_llama_1b(cfg, device, smi, *, batch, seq, steps=60):
    """The quant recipe of ``analysis/quant_recipe.py`` at llama_1b full
    width, through the launchers' code paths: the bf16 fused Trainer for
    ``steps`` steps at batch x seq (AdamW, lr 3e-3, the launcher's warmup)
    writes its checkpoint under build/; the calibrate CLI's path
    (``calibrate.calibrate_checkpoint``) turns it into a quant artifact on
    the card, timed; the serve launcher's ``--ckpt-dir`` path
    (``serve.load_model``) restores it into a sparse engine's init and its
    ``--quant-ckpt`` path loads the artifact for a quant engine; then the
    recipe's rows and the reference's gates. Returns the launch counts of
    the whole recipe and the checkpoint's directory."""
    from repro_torch.analysis import quant_recipe
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.quant import calibrate
    from repro_torch.train.trainer import Trainer
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_recipe_ckpt")
    art = os.path.join(ROOT, "build", "chip_smoke_recipe_quant")
    for d in (ckpt_dir, art):
        shutil.rmtree(d, ignore_errors=True)
    reset_launch_counts()
    tc = train_config(cfg, steps=steps, batch=batch, seq=seq,
                      ckpt_dir=ckpt_dir)
    tr = Trainer(tc, device=device, log_fn=lambda *a: None)
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    losses = [h["loss"] for h in tr.metrics_history]
    if len(losses) != steps or not all(np.isfinite(losses)):
        fail(f"recipe training: losses {losses}")
    med = statistics.median(h["dt"] for h in tr.metrics_history[1:])
    del tr
    torch.cuda.empty_cache()
    say(f"recipe {arch(cfg)}: trained {steps} bf16 steps (Trainer, fused, "
        f"batch {batch} x seq {seq}) in {t_train:.1f} s incl. the checkpoint"
        f" of step {steps}; median step {med * 1e3:.1f} ms; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} | {smi}")
    base = dataclasses.replace(cfg, param=dataclasses.replace(
        cfg.param, exec_mode="dense"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, qstats, _ = calibrate.calibrate_checkpoint(base, ckpt_dir, art,
                                                     device=device)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    say(f"recipe {arch(cfg)}: calibrate CLI path (restore, calibrate on the "
        f"card, write the artifact under build/) {t_cal:.1f} s, "
        f"{qstats['n_matrices']} matrices, {qstats['nnz']} int8 codes, "
        f"max |W - Wq| {qstats['max_abs_err']:.4e}")
    sp_cfg = quant_recipe.with_exec_mode(cfg, "sparse")
    params, consts = serve_launcher.load_model(sp_cfg, device=device,
                                               ckpt_dir=ckpt_dir)
    qparams, qconsts = serve_launcher.load_model(
        quant_recipe.with_exec_mode(cfg, "quant"), device=device,
        quant_ckpt=art)
    t0 = time.perf_counter()
    rows = quant_recipe.quant_rows(sp_cfg, params, consts, qparams, qconsts,
                                   qstats, device=device, train_steps=steps)
    torch.cuda.synchronize()
    launches = launch_counts()
    recipe_line(arch(cfg), rows, f"rows in {time.perf_counter() - t0:.1f} "
                f"s, launches over the whole recipe {launches}")
    missing = [k for k in PATH_KERNELS["recipe_llama_1b"] if not launches[k]]
    if missing:
        fail(f"recipe llama_1b never launched {missing}: {launches}")
    shutil.rmtree(art, ignore_errors=True)
    return launches, ckpt_dir


def phase_recipe_default(device, steps=60):
    """The recipe again at its default size (llama_60m smoke, 60 steps of
    the train step, exec_mode fused) through the three steps of
    ``quant_recipe.run`` (what ``python -m
    repro_torch.analysis.quant_recipe`` runs); its rows stand beside the
    reference's BENCH_quant.json (the reference's numbers, on a CPU).
    Then a witness, not gated: the same card-trained params and
    calibration through ``quant_rows`` on the CPU, where every kernel
    wrapper runs its plain version. Rows equal to the card's put a miss
    on the trained model, not on the kernels. Returns the card run's
    launch counts."""
    from repro_torch.analysis import quant_recipe
    from repro_torch.models import registry
    from repro_torch.models.common import tree_map
    from repro_torch.quant import calibrate
    reset_launch_counts()
    t0 = time.perf_counter()
    cfg = quant_recipe.with_exec_mode(registry.get_smoke_config("llama_60m"),
                                      "fused")
    params, consts = quant_recipe.train(cfg, steps, device=device)
    qp, qc, qstats = calibrate.calibrate_model(cfg, params, consts)
    rows = quant_recipe.quant_rows(cfg, params, consts, qp, qc, qstats,
                                   device=device, train_steps=steps)
    torch.cuda.synchronize()
    launches = launch_counts()
    recipe_line("llama_60m smoke", rows, f"{time.perf_counter() - t0:.1f} "
                f"s in all, launches {launches}")
    missing = [k for k in PATH_KERNELS["recipe_llama_60m"]
               if not launches[k]]
    if missing:
        fail(f"recipe llama_60m never launched {missing}: {launches}")
    host = [tree_map(lambda t: t.cpu(), t) for t in (params, consts, qp, qc)]
    t0 = time.perf_counter()
    cpu = quant_recipe.quant_rows(cfg, *host, qstats,
                                  device=torch.device("cpu"),
                                  train_steps=steps)[0]
    keys = ("matched_tokens", "mean_abs_dlogit", "max_abs_dlogit",
            "ppl_bf16", "ppl_int8")
    say("recipe llama_60m smoke, the card-trained model on the CPU (plain "
        "versions): " + ", ".join(f"{k}={cpu[k]}" for k in keys)
        + " | on the card: " + ", ".join(f"{k}={rows[0][k]}" for k in keys)
        + f" | {time.perf_counter() - t0:.1f} s")
    return launches


def phase_quant_fallback(cfg, device, ckpt_dir, new_tokens=16):
    """``quant_fallback`` on the recipe's trained checkpoint: the serve
    launcher's ``--ckpt-dir`` path under exec_mode quant (an init with the
    tile consts and no int8 codes), served with ``quant_fallback=True``,
    must warn, count ``serve.quant_fallback`` once, never launch
    quant_sparse_matmul, launch sparse_matmul, and give the sparse
    engine's tokens bit for bit on the recipe's prompts. Returns the
    fallback run's launch counts."""
    import warnings

    from repro_torch.analysis import quant_recipe
    from repro_torch.launch import serve as serve_launcher
    prompts = quant_recipe.prompts(cfg.vocab_size)
    out = {}
    for mode in ("sparse", "quant"):
        c = quant_recipe.with_exec_mode(cfg, mode)
        params, consts = serve_launcher.load_model(c, device=device,
                                                   ckpt_dir=ckpt_dir)
        reset_launch_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            toks, eng = quant_recipe.serve_tokens(
                c, params, consts, prompts, exec_mode=mode,
                new_tokens=new_tokens, device=device, quant_fallback=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        warned = [str(w.message) for w in caught
                  if "degraded" in str(w.message)]
        count = eng.obs.snapshot()["serve.quant_fallback"]["value"]
        if (mode == "quant") != (eng.quant_fell_back and bool(warned)
                                 and count == 1):
            fail(f"quant_fallback {mode}: fell back {eng.quant_fell_back}, "
                 f"warnings {warned}, serve.quant_fallback {count}")
        out[mode] = (toks, launch_counts(), wall, eng.cfg.param.exec_mode,
                     warned)
        del eng, params, consts
    (sp_tok, _, sp_wall, _, _), (fb_tok, launches, fb_wall, fb_mode,
                                 warned) = out["sparse"], out["quant"]
    if launches["quant_sparse_matmul"] or not all(
            launches[k] for k in PATH_KERNELS["serve_quant_fallback"]):
        fail(f"quant_fallback launched {launches}")
    if fb_tok != sp_tok:
        fail("quant_fallback: tokens differ from the sparse engine's")
    total = sum(len(t) for t in fb_tok)
    say(f"quant_fallback {arch(cfg)} (trained checkpoint, exec_mode quant "
        f"without int8 consts): warned {warned[0]!r}, serve.quant_fallback "
        f"1, served as exec_mode {fb_mode}; tokens == the sparse engine's on "
        f"{total}/{total} | fallback {fb_wall:.2f} s, sparse {sp_wall:.2f} "
        f"s, fallback launches {launches}")
    return launches


def check_adam8bit_coverage(seen, rows):
    """Every (elements, p dtype, g dtype) the per-layer step gave the
    adam8bit kernel was held against the plain version in the kernel
    phase."""
    checked = {(r["n"], r["dtype"], r["g_dtype"]) for r in rows
               if r["name"] == "adam8bit" and r["n"] is not None}
    if not seen or not seen <= checked:
        fail(f"the per-layer step ran adam8bit at (elements, p dtype, g "
             f"dtype) {sorted(seen, key=str)}; checked only "
             f"{sorted(checked, key=str)}")
    say(f"coverage: the per-layer step ran adam8bit at "
        f"{sorted(n for n, _, _ in seen)} elements (p, g dtypes "
        f"{sorted({(dname(p), dname(g)) for _, p, g in seen})}), all "
        "checked above")


def phase_kill_resume(device, optimizer="adamw", update_mode="global"):
    """Phase 10: the Trainer on llama_60m (full width, bf16, fused) with a
    checkpoint every 3 steps, killed at step 4 by ``fault_hook`` and
    relaunched, ends bit-identical to an uninterrupted run: every param
    leaf and every optimizer-state leaf (the 8-bit codes and scales
    included). Runs under torch.use_deterministic_algorithms: the
    embedding's backward accumulates by index, which is not deterministic
    on CUDA otherwise."""
    from repro_torch.configs import llama_60m
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.train.trainer import Trainer

    class Kill(Exception):
        pass

    def hook(step):
        if step == 4:
            raise Kill()
    cfg = dataclasses.replace(llama_60m.CONFIG, param=dataclasses.replace(
        llama_60m.CONFIG.param, exec_mode="fused"))
    root = os.path.join(ROOT, "build", "chip_smoke_resume")
    shutil.rmtree(root, ignore_errors=True)
    quiet = dict(device=device, log_fn=lambda *a: None)
    mk = lambda d: train_config(cfg, steps=6, batch=8, seq=256,
                                ckpt_dir=os.path.join(root, d), ckpt_every=3,
                                optimizer=optimizer, update_mode=update_mode)
    torch.use_deterministic_algorithms(True)
    try:
        t0 = time.perf_counter()
        ref = Trainer(mk("a"), **quiet).run()
        try:
            Trainer(mk("b"), fault_hook=hook, **quiet).run()
            fail("kill/resume: the fault hook never fired")
        except Kill:
            pass
        tr = Trainer(mk("b"), **quiet)
        got = tr.run()
        wall = time.perf_counter() - t0
    finally:
        torch.use_deterministic_algorithms(False)
    shutil.rmtree(root, ignore_errors=True)
    if tr.metrics_history[0]["step"] != 4:
        fail(f"kill/resume: relaunch did not resume at step 4 "
             f"({tr.metrics_history[0]['step']})")
    out = {}
    for what, a, b in (("param", ref.params, got.params),
                       ("optimizer-state", ref.opt_state, got.opt_state)):
        a, b = tree_leaves(a), tree_leaves(b)
        same = sum(bool(torch.equal(x, y)) for x, y in zip(a, b))
        if same != len(a) or len(a) != len(b):
            fail(f"kill/resume {optimizer} {update_mode}: {len(a) - same} "
                 f"of {len(a)} {what} leaves differ from the uninterrupted "
                 "run")
        out[what] = f"{same}/{len(a)}"
    n8 = sum(t.dtype == torch.int8 for t in tree_leaves(got.opt_state))
    say(f"kill/resume llama_60m (bf16, fused, {optimizer}, {update_mode}, "
        f"deterministic algorithms): killed at step 4, resumed from step 3, "
        f"{out['param']} param leaves and {out['optimizer-state']} "
        f"optimizer-state leaves ({n8} of them int8 codes) bit-identical to "
        f"the uninterrupted run after 6 steps ({wall:.1f} s for the three "
        "runs)")


def check_train_coverage(shapes, m, cfg, kernels=("sl_matmul", "sddmm")):
    """Every (M, K, N) the trainer gave ``kernels`` was checked in the
    kernel phases (the forward and dx calls and sddmm at the three
    projection shapes)."""
    d, f = cfg.d_model, cfg.d_ff
    checked = {(m, a, b) for a, b in ((d, d), (d, f), (f, d))}
    for k in kernels:
        seen = shapes[k]
        if not seen or not seen <= checked:
            fail(f"the trainer ran {k} at (M, K, N) in {sorted(seen)}; "
                 f"checked only {sorted(checked)}")
    say("coverage: the trainer ran " + " and ".join(
        f"{k} at {sorted(shapes[k])}" for k in kernels)
        + " (M, K, N), all checked above")


def representatives(cfg, rows, m, n_slots, bucket):
    """{kernel: the shape of its representative case} among ``rows`` (one
    config's): the training rows of sl_matmul and sddmm, the engine's
    decode and largest prefill bucket at 32 heads, the embedding's 8-bit
    step (bf16, weight decay on) and the sparse decode at 4 rows."""
    leaf_rows = [r for r in rows if r["name"] == "adam8bit"
                 and r["n"] is not None]
    embed = [r["shape"] for r in leaf_rows if r["n"] == max(
        x["n"] for x in leaf_rows) and r["dtype"] == torch.bfloat16
        and r["shape"].endswith("wd 0.1")][0]
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    decode = f"{n_slots}x{d}->{f} bfloat16"
    return {"sl_matmul": f"{m}x{d}->{f} bfloat16",
            "paged_attention": f"32 heads, hd {hd} bfloat16",
            "paged_prefill": f"sq={bucket} 32 heads, hd {hd} bfloat16",
            "sddmm": f"{m}x({d},{f}) bfloat16",
            "adam8bit": embed,
            "sparse_matmul": decode + " f32 out",
            "quant_sparse_matmul": decode}


def kernels_line(rows, by_path, representative, rows_7b, representative_7b):
    """One entry per kernel: the llama_1b representative case's times and
    bound (and, under ``at_llama_7b``, the llama_7b one's), the largest
    error over all of the kernel's cases at both configs; launches summed
    over the main paths' runs (serving fused, sparse and quant; training
    fused, sparse and per-layer; the quant recipe at llama_1b and at its
    default size; the quant fallback; llama_7b's per-layer training and
    fused and sparse serving), each path's count beside them."""
    out = []
    src = {"sl_matmul": SL_SOURCE, "paged_attention": PA_SOURCE,
           "paged_prefill": PA_SOURCE, "sddmm": SD_SOURCE,
           "adam8bit": AD_SOURCE, "sparse_matmul": SP_SOURCE,
           "quant_sparse_matmul": SP_SOURCE}
    times = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for name, shape in representative.items():
        mine = [r for r in rows if r["name"] == name]
        rep = next(r for r in mine if r["shape"] == shape)
        mine7 = [r for r in rows_7b if r["name"] == name]
        rep7 = next(r for r in mine7 if r["shape"] == representative_7b[name])
        out.append({
            "name": name, "route": "cuda", "source": src[name],
            "replaces": REPLACES[name],
            "launches": sum(n[name] for n in by_path.values()),
            "launches_by_path": {p: n[name] for p, n in by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r in mine + mine7),
            **{k: rep[k] for k in times}, "shape": shape,
            "cases": len(mine),
            **{k: rep[k] for k in ("variant", "pad_ms", "library_f32_ms")
               if k in rep},
            "at_llama_7b": {"shape": rep7["shape"], "cases": len(mine7),
                            **{k: rep7[k] for k in times}}})
    return {"kernels": out}


# ---------------------------------------------------------------------------
# phases 7a to 7e: llama_7b
# ---------------------------------------------------------------------------

# full-rank depths of the 7B memory fit (phase 7d); full depth does not
# fit on one card
DEPTHS_7B = (2, 4, 8)
# the largest residual of that fit, as a share of its point: a global
# AdamW step's peak adds one layer's params, grads, moments and the
# update's new state per layer, a line in the depth, plus f32
# temporaries of the largest leaf, whose slope changes once a stacked
# layer leaf outgrows the embedding (between 2 and 4 layers at 7B width)
FIT_RESIDUAL_TOL = 0.03


def check_kernels_7b(device, cfg, m_values, n_slots, block_len, bps,
                     buckets, m_train):
    """Phase 7a: every kernel against its plain version at the llama_7b
    shapes, with the same checks, timings and plans as at llama_1b: the
    decode and prefill row counts and the training rows of sl_matmul (and
    its dx), sddmm, sparse_matmul and quant_sparse_matmul; the paged
    kernels at head_dim 128; adam8bit at every segment of the per-layer
    step and over one layer's slices in one launch. Own generators, so no
    earlier phase's draws move."""
    timer = Timer(device)
    gens = []
    for seed in (10, 11, 12, 13, 14):
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        gens.append(g)
    rows = check_sl_matmul(timer, gens[0], device, cfg, m_values)
    rows += check_attention(timer, gens[1], device, cfg, n_slots, block_len,
                            bps, buckets)
    rows += check_sparse_decode(timer, gens[2], device, cfg, m_values)
    rows += check_train_kernels(timer, gens[0], device, cfg, m_train)
    rows += check_sparse_train_kernels(timer, gens[3], device, cfg, m_train)
    rows += check_adam8bit(timer, gens[4], device, cfg)
    del timer
    torch.cuda.empty_cache()
    return rows


def phase_parity_7b(cfg, device, *, batch, seq, n_slots, block_len,
                    max_len, buckets, m_values):
    """Phase 7b: the f32 pairs of phase 6 at llama_7b's width on 2 layers
    (fused, sparse and per-layer 8-bit against their references, 3 steps
    each, the existing tolerances), then the f32 engine's greedy tokens
    along fused + paged kernels and sparse + paged kernels against dense
    + gathered attention (head_dim 128 through ``attend``)."""
    from repro_torch.models import lm
    gen = torch.Generator(device=device)
    gen.manual_seed(20)
    cfg32 = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                                param=dataclasses.replace(
                                    cfg.param, exec_mode="fused"))
    phase_train_parity(cfg32, device, gen, batch=batch, seq=seq)
    torch.cuda.empty_cache()
    params, consts = lm.init_lm(cfg32, seed=0, device=device)
    randomize_b(params, gen)
    prompts, arrivals = traffic(cfg.vocab_size)
    kw = dict(n_slots=n_slots, max_len=max_len, block_len=block_len,
              new_tokens=16)
    check_forward(cfg32, params, consts, device)
    fused, b_reqs = phase_engine_f32(cfg32, params, consts, prompts,
                                     arrivals, device, **kw)
    sparse = phase_sparse_f32(cfg32, params, consts, prompts, arrivals,
                              b_reqs, device, **kw)
    check_coverage(fused, m_values, buckets)
    check_coverage(sparse, m_values, buckets, "sparse_matmul")
    del params, consts
    torch.cuda.empty_cache()


def phase_train_7b(cfg, device, smi, *, batch, seq):
    """Phase 7c: llama_7b at full width and depth through the Trainer in
    bf16, per-layer 8-bit SLTrain, exec_mode fused, 4 steps (one warm-up),
    from its own pooled init; then 3 steps with remat "full" on the state
    it left (no second init). No checkpoint is written. Gate: remat's peak
    is not above the first run's, in the bytes the tensors requested: the
    allocated bytes count whole cached blocks, which depend on what the
    allocator cached before (the second run starts from the first's
    cache), not on remat. Returns the first run's launch counts, the
    segments adam8bit saw and its peak (max_memory_allocated)."""
    requested = lambda: torch.cuda.memory_stats(device)[
        "requested_bytes.all.peak"]
    tr, state, launches, seen, _, peak = phase_perlayer_bf16(
        cfg, device, smi, batch=batch, seq=seq, steps=4, save=False)
    want = requested()
    handoff = [state]
    del tr, state
    _, _, _, _, _, remat_peak = phase_perlayer_bf16(
        cfg, device, smi, batch=batch, seq=seq, steps=3, remat="full",
        save=False, handoff=handoff)
    remat_want = requested()
    torch.cuda.empty_cache()
    say(f"memory bf16 {arch(cfg)} per_layer + adam8bit, peaks of the bytes "
        f"the tensors asked for (the allocator's requested_bytes): remat "
        f"full {remat_want} B = {remat_want / 2**30:.3f} GiB against remat "
        f"none {want} B ({remat_want - want:+d} B); of max_memory_allocated "
        f"(whole cached blocks): {remat_peak} B against {peak} B "
        f"({remat_peak - peak:+d} B)")
    if remat_want > want:
        fail(f"remat full's tensors peak at {remat_want} B, above remat "
             f"none's {want} B")
    return launches, seen, peak


def phase_memory_7b(cfg, device, smi, *, batch, seq, lean_peak):
    """Phase 7d: the paper's 7B memory claim. Full-rank global AdamW in
    bf16 at llama_7b's width does not fit on one card at 32 layers, so it
    runs at DEPTHS_7B (``memory_row`` with ``n_layers`` replaced), each
    row's params + state within MEMORY_STATE_TOL of the estimator's; its
    peak is fitted as a + b·L by least squares (``core.memory.depth_fit``),
    every residual within FIT_RESIDUAL_TOL of its point, and extrapolated
    to full depth. Gate: the per-layer 8-bit SLTrain peak measured at full
    depth (``lean_peak``, phase 7c) is below that extrapolation. SLTrain
    with global AdamW is printed as an estimate only."""
    from repro_torch.core import memory
    peaks = []
    for depth in DEPTHS_7B:
        c = dataclasses.replace(cfg, n_layers=depth)
        row = memory_row(c, device, mode="dense", optimizer="adamw",
                         update_mode="global", batch=batch, seq=seq)
        est = memory_estimate(c, "full", "adamw", "global")
        gap = memory_line(c, "full rank, AdamW, global", row, est, None, smi)
        if abs(gap) > MEMORY_STATE_TOL:
            fail(f"memory {arch(c)} full rank: params + optimizer state "
                 f"{row['state']} B is {100 * gap:+.3f}% from the "
                 f"estimator's, beyond {100 * MEMORY_STATE_TOL}%")
        peaks.append(row["peak"])
    fit = memory.depth_fit(DEPTHS_7B, peaks)
    for depth, y, r in zip(DEPTHS_7B, peaks, fit.residuals):
        say(f"memory fit {arch(cfg)} full rank: {depth} layers, peak {y} B, "
            f"fitted {fit.at(depth):.0f} B, residual {r:+.0f} B = "
            f"{100 * r / y:+.3f}% (tol {100 * FIT_RESIDUAL_TOL}%)")
        if abs(r) > FIT_RESIDUAL_TOL * y:
            fail(f"the full-rank peak at {depth} layers is {100 * r / y:+.2f}% "
                 f"off the fitted line, beyond {100 * FIT_RESIDUAL_TOL}%")
    full = fit.at(cfg.n_layers)
    est = memory_estimate(cfg, "full", "adamw", "global")
    card = torch.cuda.get_device_properties(device).total_memory
    say(f"memory {arch(cfg)} full rank, AdamW, global: extrapolated (not "
        f"measured) to {cfg.n_layers} layers {full / 2**30:.3f} GiB = "
        f"{fit.a / 2**30:.3f} + {fit.b / 2**30:.4f} GiB x {cfg.n_layers} "
        f"layers, beside training_estimate (f32 moments) "
        f"{est.total_bytes / 2**30:.2f} GiB with grads and transients "
        f"({(est.param_bytes + est.optim_bytes) / 2**30:.2f} GiB params + "
        f"optimizer) and the card's {card / 2**30:.2f} GiB | {smi}")
    paper = memory.paper_f_reduction("7b", index_bytes=4)
    say(f"memory bf16 {arch(cfg)}: per-layer 8-bit SLTrain "
        f"{lean_peak / 2**30:.3f} GiB measured at full depth against "
        f"full-rank global AdamW {full / 2**30:.3f} GiB extrapolated: "
        f"{100 * (1 - lean_peak / full):.2f}% less, beside "
        f"paper_f_reduction('7b', index_bytes=4) "
        f"{100 * paper['reduction']:.1f}% ({paper['full_G']:.2f} -> "
        f"{paper['lean_G']:.2f} GB; bf16 moments, no activations) | {smi}")
    if not lean_peak < full:
        fail(f"per-layer 8-bit SLTrain peak {lean_peak / 2**30:.3f} GiB is "
             f"not below the extrapolated full-rank peak "
             f"{full / 2**30:.3f} GiB")
    sl = memory_estimate(cfg, "sltrain", "adamw", "global")
    say(f"memory {arch(cfg)} SLTrain, AdamW, global: estimate only (not "
        f"run): training_estimate {sl.total_bytes / 2**30:.2f} GiB with "
        f"grads and transients, {(sl.param_bytes + sl.optim_bytes) / 2**30:.2f}"
        f" GiB params + optimizer")


def phase_serving_7b(cfg, device, *, n_slots, block_len, max_len, buckets,
                     m_values):
    """Phase 7e: llama_7b at full width and depth served in bf16 from one
    pooled init (B ~ U(-1, 1), fused tile consts, which the sparse path
    reads too): the fused and the sparse engine on the llama_1b traffic,
    timed, launch counts read around each run, then profiled. Returns each
    path's launch counts."""
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    from repro_torch.obs import metrics as obs_metrics
    gen = torch.Generator(device=device)
    gen.manual_seed(30)
    cfg16 = dataclasses.replace(cfg, param=dataclasses.replace(
        cfg.param, exec_mode="fused"))
    reg = obs_metrics.Registry()
    params, consts = lm.init_lm(cfg16, seed=0, device=device, obs=reg)
    randomize_b(params, gen)
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    say(f"init {arch(cfg16)} bf16: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, d_ff {cfg.d_ff}, head_dim {cfg.resolved_head_dim}, "
        f"rank {cfg.param.rank}, delta {cfg.param.delta}, "
        f"{n_params / 1e6:.1f} M params, consts "
        f"{sum(nbytes(t) for _, t in tree_leaves(consts)) / 2**30:.2f} GiB, "
        f"in {reg.get('init.seconds').value:.1f} s with "
        f"{reg.get('init.sampling_workers').value:.0f} support sampling "
        "workers")
    prompts, arrivals = traffic(cfg.vocab_size)
    kw = dict(n_slots=n_slots, max_len=max_len, block_len=block_len,
              new_tokens=16)
    by_path = {}
    for mode, kernel in (("fused", "sl_matmul"), ("sparse", "sparse_matmul")):
        path = f"{EXEC_PATH[mode]}_llama_7b"
        launches, shapes, wall = phase_engine_bf16(
            cfg16, params, consts, prompts, arrivals, device, exec_mode=mode,
            path=path, **kw)
        by_path[path] = launches
        check_coverage(shapes, m_values, buckets, kernel)
        phase_profile(cfg16, params, consts, prompts, arrivals, device, wall,
                      exec_mode=mode, attn_kernel="paged", **kw)
    del params, consts
    torch.cuda.empty_cache()
    return by_path


def run_7b(device, smi, *, batch, seq, n_slots, block_len, max_len, buckets,
           m_values):
    """Phases 7a to 7e on llama_7b; returns (kernel rows, launch counts
    by path, the adam8bit segments the per-layer step saw)."""
    from repro_torch.configs import llama_7b
    cfg = llama_7b.CONFIG
    t0 = time.perf_counter()
    rows = check_kernels_7b(device, cfg, m_values, n_slots, block_len,
                            max_len // block_len, buckets, batch * seq)
    say(f"phase 7a ({arch(cfg)} kernels): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_parity_7b(cfg, device, batch=batch, seq=seq, n_slots=n_slots,
                    block_len=block_len, max_len=max_len, buckets=buckets,
                    m_values=m_values)
    say(f"phase 7b ({arch(cfg)} f32 parity, 2 layers): "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    cfg16 = dataclasses.replace(cfg, param=dataclasses.replace(
        cfg.param, exec_mode="fused"))
    with ShapeRecorder() as rec:
        launches, seen, lean_peak = phase_train_7b(cfg16, device, smi,
                                                   batch=batch, seq=seq)
    check_train_coverage(rec.shapes, batch * seq, cfg)
    check_adam8bit_coverage(seen, rows)
    by_path = {"train_per_layer_llama_7b": launches}
    say(f"phase 7c ({arch(cfg)} training): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_memory_7b(cfg, device, smi, batch=batch, seq=seq,
                    lean_peak=lean_peak)
    say(f"phase 7d ({arch(cfg)} memory): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path.update(phase_serving_7b(cfg, device, n_slots=n_slots,
                                    block_len=block_len, max_len=max_len,
                                    buckets=buckets, m_values=m_values))
    say(f"phase 7e ({arch(cfg)} serving): {time.perf_counter() - t0:.1f} s")
    return rows, by_path


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def run_serving(cfg, device, gen, n_slots, block_len, max_len, buckets,
                m_values):
    """Phases 3 to 5 on the serving paths (fused, sparse, quant); returns
    each path's launch counts from its bf16 run."""
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves, tree_map
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32", param=dataclasses.replace(
        cfg.param, exec_mode="fused"))
    params, consts = lm.init_lm(cfg32, seed=0, device=device)
    randomize_b(params, gen)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    say(f"init {arch(cfg)}: {cfg.n_layers} layers, d_model {cfg.d_model}, d_ff "
        f"{cfg.d_ff}, rank {cfg.param.rank}, {n_params / 1e6:.1f} M params, "
        f"consts {sum(nbytes(t) for _, t in tree_leaves(consts)) / 2**30:.2f} "
        f"GiB, in {time.perf_counter() - t0:.1f} s")
    prompts, arrivals = traffic(cfg.vocab_size)
    kw = dict(n_slots=n_slots, max_len=max_len, block_len=block_len,
              new_tokens=16)
    check_forward(cfg32, params, consts, device)
    shapes = {"fused": set(), "sparse": set(), "quant": set()}
    fused, b_reqs = phase_engine_f32(cfg32, params, consts, prompts,
                                     arrivals, device, **kw)
    shapes["fused"] |= fused
    shapes["sparse"] |= phase_sparse_f32(cfg32, params, consts, prompts,
                                         arrivals, b_reqs, device, **kw)
    qparams, qconsts, quant = phase_quant_f32(cfg32, params, consts, prompts,
                                              arrivals, device, **kw)
    shapes["quant"] |= quant

    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    to16 = lambda tree: tree_map(lambda t: t.to(torch.bfloat16), tree)
    params16, qparams16 = to16(params), to16(qparams)
    del params, qparams
    by_path = {}
    for mode, p, c in (("fused", params16, consts),
                       ("sparse", params16, consts),
                       ("quant", qparams16, qconsts)):
        launches, s16, wall16 = phase_engine_bf16(
            cfg16, p, c, prompts, arrivals, device, exec_mode=mode, **kw)
        by_path[EXEC_PATH[mode]] = launches
        shapes[mode] |= s16
        phase_profile(cfg16, p, c, prompts, arrivals, device, wall16,
                      exec_mode=mode, attn_kernel="paged", **kw)
    for mode, kernel in (("fused", "sl_matmul"), ("sparse", "sparse_matmul"),
                         ("quant", "quant_sparse_matmul")):
        check_coverage(shapes[mode], m_values, buckets, kernel)
    return by_path


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    from repro_torch.configs import llama_1b
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    say(f"device: {name} x{torch.cuda.device_count()} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    say(smi)

    lap = Laps()
    t0 = time.perf_counter()
    build.build()
    say(f"build: {len(build.SOURCES)} kernels with nvcc in "
        f"{time.perf_counter() - t0:.1f} s (parallel, sm_90a)")
    for lib in build.SOURCES:
        for line in ptxas_report(build.build_log(lib)):
            say(f"  ptxas {lib}: {line}")

    cfg = llama_1b.CONFIG
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    timer = Timer(device)
    n_slots, block_len, max_len = 4, 16, 128
    # prefill pads each slot's suffix to a power of two, at least 8
    # (scheduler min_prefill_bucket); this traffic's suffixes fit in 32
    buckets = (8, 16, 32)
    m_values = (n_slots,) + tuple(n_slots * b for b in buckets)
    # the reference trainer's defaults: global batch 8, seq 256
    batch, seq = 8, 256
    sl_rows = check_sl_matmul(timer, gen, device, cfg, m_values)
    at_rows = check_attention(timer, gen, device, cfg, n_slots, block_len,
                              max_len // block_len, buckets)
    # its own generator: the later phases draw the same B as before
    sp_gen = torch.Generator(device=device)
    sp_gen.manual_seed(2)
    sp_rows = check_sparse_decode(timer, sp_gen, device, cfg, m_values)
    tr_rows = check_train_kernels(timer, gen, device, cfg, batch * seq)
    # its own generator: the later phases draw the same B as before
    st_gen = torch.Generator(device=device)
    st_gen.manual_seed(3)
    st_rows = check_sparse_train_kernels(timer, st_gen, device, cfg,
                                         batch * seq)
    # its own generator: the later phases draw the same B as before
    ad_gen = torch.Generator(device=device)
    ad_gen.manual_seed(1)
    ad_rows = check_adam8bit(timer, ad_gen, device, cfg)
    del timer                       # free the L2 sweep buffer
    torch.cuda.empty_cache()
    lap("build and llama_1b kernels")

    by_path = run_serving(cfg, device, gen, n_slots, block_len, max_len,
                          buckets, m_values)
    torch.cuda.empty_cache()
    lap("llama_1b serving")

    phase_train_parity(dataclasses.replace(
        cfg, dtype="float32", param=dataclasses.replace(
            cfg.param, exec_mode="fused")), device, gen, batch=batch,
        seq=seq)
    torch.cuda.empty_cache()
    phase_baseline_parity(dataclasses.replace(cfg, dtype="float32"), device,
                          batch=batch, seq=seq)
    torch.cuda.empty_cache()
    lap("llama_1b f32 training parity")
    cfg16 = dataclasses.replace(cfg, param=dataclasses.replace(
        cfg.param, exec_mode="fused"))
    tr, state, by_path["train"], shapes, med, global_peak = \
        phase_train_bf16(cfg16, device, smi, batch=batch, seq=seq)
    check_train_coverage(shapes, batch * seq, cfg)
    sltrain_rows = {"SLTrain, AdamW, global (fused)": (
        {"peak": global_peak, "state": state_bytes(state), "med": med,
         "tokens": batch * seq,
         "losses": [h["loss"] for h in tr.metrics_history]},
        "adamw", "global")}
    phase_train_profile(tr, state, device, med)
    del tr, state
    torch.cuda.empty_cache()
    cfg16s = dataclasses.replace(cfg, param=dataclasses.replace(
        cfg.param, exec_mode="sparse"))
    tr, state, by_path["train_sparse"], shapes, med, _ = phase_train_bf16(
        cfg16s, device, smi, batch=batch, seq=seq)
    check_train_coverage(shapes, batch * seq, cfg,
                         kernels=("sparse_matmul", "sddmm"))
    phase_train_profile(tr, state, device, med,
                        label="sparse-mode train step",
                        kernels=("sparse_split_kernel", "sddmm"))
    del tr, state
    torch.cuda.empty_cache()
    tr, state, by_path["train_per_layer"], seen, med, peak = \
        phase_perlayer_bf16(cfg16, device, smi, batch=batch, seq=seq,
                            global_peak=global_peak)
    check_adam8bit_coverage(seen, ad_rows)
    sltrain_rows["SLTrain, 8-bit AdamW, per_layer (fused)"] = (
        {"peak": peak, "state": state_bytes(state), "med": med,
         "tokens": batch * seq,
         "losses": [h["loss"] for h in tr.metrics_history]},
        "adam8bit", "per_layer")
    phase_train_profile(tr, state, device, med,
                        label="per-layer 8-bit train step",
                        kernels=("adam8bit",))
    del tr, state
    torch.cuda.empty_cache()
    phase_memory_table(cfg, device, smi, batch=batch, seq=seq,
                       sltrain_rows=sltrain_rows)
    lap("llama_1b bf16 training and memory table")
    phase_kill_resume(device)
    phase_kill_resume(device, optimizer="adam8bit", update_mode="per_layer")
    lap("kill/resume")
    recipe_cfg = dataclasses.replace(cfg16, n_layers=RECIPE_LAYERS)
    by_path["recipe_llama_1b"], recipe_ckpt = phase_recipe_llama_1b(
        recipe_cfg, device, smi, batch=batch, seq=seq)
    torch.cuda.empty_cache()
    by_path["serve_quant_fallback"] = phase_quant_fallback(
        recipe_cfg, device, recipe_ckpt)
    shutil.rmtree(recipe_ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    by_path["recipe_llama_60m"] = phase_recipe_default(device)
    torch.cuda.empty_cache()
    lap("quant recipe and fallback")
    phase_comparison(device)
    lap("Table 2 comparison")

    rows_7b, by_path_7b = run_7b(device, smi, batch=batch, seq=seq,
                                 n_slots=n_slots, block_len=block_len,
                                 max_len=max_len, buckets=buckets,
                                 m_values=m_values)
    by_path.update(by_path_7b)
    lap("llama_7b phases")

    from repro_torch.configs import llama_7b
    rows = sl_rows + at_rows + tr_rows + ad_rows + sp_rows + st_rows
    line = kernels_line(
        rows, by_path,
        representatives(cfg, rows, batch * seq, n_slots, buckets[-1]),
        rows_7b, representatives(llama_7b.CONFIG, rows_7b, batch * seq,
                                 n_slots, buckets[-1]))
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
