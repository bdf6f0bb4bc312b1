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
full width (serving on 2 of its 24 layers) with random weights from a
seed:

* serving: the paged engine in float32 along paths that must give the
  same greedy tokens: fused ``sl_matmul`` + paged kernels, and
  ``sparse_decode=True`` (``sparse_matmul``), each against dense densify
  + gathered attention; the model calibrated to int8 on the card, its
  quant artifact written under build/ and read back bit for bit, and
  served in exec_mode quant (``quant_sparse_matmul``) against a dense
  engine on the dequantized weights. The contiguous cache (``paged=False``,
  the reference launcher's default: prefill token by token through the
  (slots, 1) decode, one shared decode index) in float32: fused, sparse
  and quant against dense, the same tokens tick for tick, and the first
  2 requests one at a time against the paged engine, the same tokens.
  Then each of the three paths once in bfloat16 on the paged cache,
  timed, with every kernel's launch count read around the run, then
  profiled, and fused (timed under the device-only profiler) and sparse
  on the contiguous cache;
* training: 3 float32 train steps from one init and one data stream, at
  full width on 2 of the 24 layers (``PARITY_LAYERS``), in pairs that
  must agree: exec_mode "fused" (``sl_matmul`` forward and dx,
  ``sddmm`` dV) against "dense" (densify + the eq.-(2) backward), "sparse"
  (``sparse_matmul`` forward and dx over Wᵀ's tiles, ``sddmm`` dV)
  against "dense", per-layer updates against the global step (AdamW),
  and per-layer 8-bit AdamW through the ``adam8bit`` kernel against
  global 8-bit AdamW; then the ``Trainer`` in bfloat16 for 4 steps in
  exec_mode fused and in sparse, timed, with the launch counts read
  around each run and its checkpoint written; a device-only profile of
  one more step of each;
* the paper's baselines, (a): 3 float32 steps of ``llama_1b`` at full
  width on ``PARITY_LAYERS`` layers, per-layer updates against the global step, for low
  rank with AdamW, ReLoRA with AdamW merging after step 2 (the Trainer's
  merge and seeded redraw in both runs, so step 3 holds the moment reset
  too) and full rank with GaLore-AdamW refreshing P at step 3; none of
  them may launch a kernel of the port;
* the memory path: the ``Trainer`` in bfloat16 with per-layer updates and
  8-bit AdamW (``adam8bit``, one launch a group of the sweep) for 4
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
  estimate;
* chaos drills on ``llama_60m`` (bfloat16, fused;
  ``repro_torch.resilience.chaos``): ``launch.train --chaos kill@4`` in
  its own process must exit 43 and the launcher's relaunch end
  bit-identical to an uninterrupted run (global AdamW), as must a
  Trainer killed by ``chaos=kill@4`` with per-layer 8-bit AdamW (8-bit
  codes included), both under deterministic algorithms; the reference's
  fault matrix (kill, data_corrupt, straggler, ckpt_corrupt, nonfinite)
  counted and recovered; a relaunch past a corrupted newest checkpoint
  resuming from the newest intact one; ``stall@T:K`` past a deadline on
  the paged and the contiguous engine leaving no request wedged and no
  KV block in use; and the launchers' ``--jax-profile-dir``, whose
  ``torch.profiler`` traces must name ``sl_matmul``'s device kernels;
* train, checkpoint, calibrate, serve (``analysis/quant_recipe.py``), at
  ``llama_1b``'s width on 2 of its layers (``RECIPE_LAYERS``):
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
  at ``llama_60m`` for 5 steps a mode, gated on finite losses;
* ``llama_7b`` (32 layers, d_model 4096, d_ff 11008, head_dim 128, rank
  1024, delta 0.05), each phase from one init whose supports are sampled
  in worker processes: (7a) every kernel against its plain version at
  the 7B shapes, with the checks above; (7b) the f32 training pairs and
  the f32 engine's tokens at 7B width on 2 layers; (7c) the per-layer
  8-bit ``Trainer`` at full depth, 4 steps, then 3 with remat "full",
  whose peak may not exceed the first's; (7d) full-rank global AdamW at
  2, 4 and 8 layers, its peak fitted in depth and extrapolated to 32
  layers (it does not fit on the card), the per-layer 8-bit peak gated
  below it; (7e) the fused and sparse bf16 engines on
  ``SERVE_7B_LAYERS`` of the 32 layers, timed and profiled; (7f) quant
  on ``QUANT_7B_LAYERS`` of them: the recipe's train -> checkpoint ->
  calibrate (seconds a matrix) -> artifact written and read back ->
  sparse and quant engines, its rows (greedy match or mean |dlogit|
  against the sparse engine, modeled decode bytes) under the
  reference's gates, then the loaded artifact in f32: the quant
  engine's tokens against dense + gathered attention on the dequantized
  weights;
* the gemma2 family (``gemma2_2b``: 26 layers of local/global pairs,
  d_model 2304, 8 heads over 4 kv heads of 256, d_ff 9216, vocab 256000
  tied, softcaps 50/30, window 4096, rank 576) and ``paligemma_3b``:
  (g1) every kernel at the new shapes in bf16 against its plain version
  (``sl_matmul``, ``sddmm``, ``sparse_matmul``, ``quant_sparse_matmul``
  at gemma2's five projection shapes; ``adam8bit`` at every segment of
  gemma2's per-layer step, the 590 M-element tied embedding included;
  the paged kernels at head_dim 256, the prefill on the tensor cores'
  wide kernel, the decode at a 4320-key context past the window;
  paligemma's MQA at group 8; ``sl_matmul`` at paligemma's and
  qwen2.5's widest shapes); (g2) f32 at gemma2's width on 2 layers
  (``GEMMA_PARITY_LAYERS``, one local and one global): 3 train steps fused against dense, fused
  and sparse engine tokens against dense + gathered attention; the
  model calibrated on the card, the quant engine's tokens against dense
  + gathered attention on the dequantized weights, and its calibration
  in bf16 served in exec_mode quant (timed, profiled, one
  ``quant_sparse_matmul`` a linear a dispatch asserted); (g3)
  gemma2_2b in bf16 on 4 of 26 layers: the fused and sparse paged engines
  (tokens/s, busy share), a 4300-token request past the window held
  step by step against the gathered read on the same engine
  (``LONG_LOGIT_TOL``), and 3 Trainer steps of global AdamW and of
  per-layer 8-bit AdamW; (g4) paligemma_3b on 2 layers
  (``PALI_LAYERS``) with seeded patch embeddings: an f32 train step
  fused against dense, f32 engine tokens against dense, a bf16 train step
  and a bf16 engine run;
* MoE (``deepseek_moe_16b``: 64 routed experts top-6 of d_ff 1408 and 2
  shared, a dense first layer of d_ff 10944, d_model 2048, rank 512;
  ``qwen3_moe_235b``: 128 experts top-8 of d_ff 1536, d_model 4096, rank
  768, GQA group 16, QK-norm): (m1) the grouped launches over an expert
  stack in bf16, ``sl_matmul_grouped`` at deepseek's expert shapes at 1,
  15 and 240 rows an expert (decode, prefill, training; with the
  training dx) and ``sddmm_grouped`` at 240, and at qwen3's at 1 and 240,
  each bit for bit a loop of single launches and within tolerance of its
  plain version, timed beside the loop, the plain version,
  ``torch.bmm`` and its bound; ``sparse_matmul_grouped`` (f32 out) and
  ``quant_sparse_matmul_grouped`` the same way at both configs' expert
  shapes, timed at 1 and 240 rows an expert, checked untimed at every
  other row count the engine gives them; the paged kernels at qwen3's
  group 16; (m2) deepseek at full width in f32 on 2 layers
  (``MOE_PARITY_LAYERS``: the dense one and an MoE one): the forward
  fused and sparse against dense, the fused and sparse engines' tokens
  against dense and sparse's against fused, on the paged read, tick for
  tick, a first difference excused only by a routing near-tie
  (``ROUTE_MARGIN``) or a logit tie; the model calibrated on the card
  (each routed expert's slice a matrix) and the quant engine's tokens
  against the sparse engine's on the dequantized weights; (m3) that
  model and its calibration in bf16: the fused, sparse and quant engines,
  timed and profiled, their launches asserted per dispatch (one single
  launch a dense, attention or shared-expert linear, one grouped launch
  a routed-expert linear: a loop would launch 64 of them), every row
  count an expert took checked in m1, the fused tokens against dense
  under the same excuses; the Trainer on 2 layers, 3 steps of global
  AdamW and of per-layer 8-bit AdamW (step ms, MFU from active
  parameters, peak, the aux loss);
* the SSM and encoder families (``zamba2_7b``: 81 Mamba2 layers of
  d_model 3584 with one shared attention + MLP block after every 6;
  ``xlstm_350m``: 24 layers, 7 mLSTM + 1 sLSTM a super block;
  ``whisper_large_v3``: 32 + 32 layers over 1500 stub frames): (h1) the
  linears' kernels at their shapes in bf16, ``sl_matmul`` forward and dx
  and ``sddmm`` timed at the main projections (``SSM_TIMED``: zamba2's
  in_proj 3584 -> 14576 at rank 896, its out_proj and MLP; xlstm's qkv
  and FFN; whisper's MLP and qkv, and its cross-attention k at 4 x 1500
  rows), ``sparse_matmul`` and ``quant_sparse_matmul`` at decode rows,
  and every other (M, K, N) the h3 paths give these kernels checked
  against the plain versions untimed (h3 asserts the coverage); (h2) f32
  at full width on ``SSM_PARITY_CUT`` (zamba2 7 layers, xlstm 8, whisper
  2 + 2): the forward, 3 train steps and the contiguous engine's tokens,
  fused and sparse against dense, the later steps gated at the larger of
  ``TRAIN_TOL_LATER`` and ``SPREAD_FACTOR`` times the spread a 1e-7 move
  of the init makes; (h3) bf16: the contiguous engine on the 8-request
  traffic, fused (profiled) and sparse, launches asserted per dispatch
  (zamba2 on ``HYBRID_LAYERS`` = 7 of 81 layers, xlstm on
  ``XLSTM_BF16_LAYERS`` = 8 of 24, whisper on ``WHISPER_SERVE_LAYERS`` =
  2 of 32 decoder layers), and 3 train steps of global AdamW fused and sparse (the
  Trainer; whisper's train step with seeded frames at
  ``WHISPER_TRAIN_BATCH`` = 3), with step ms, the reference's MFU, the
  true parameter count and the peak;
* training on a device mesh (phase dist, ``run_dist``): ``llama_7b`` at
  full width on ``DIST_LAYERS`` = 2 layers, f32, ``DIST_STEPS`` = 3
  steps from one init, on one world of ``DIST_WORLD`` = 4 ranks, each a
  process on the one card, over the gloo backend (asked for here: NCCL
  refuses two ranks on one device; a group's ranks exchange data
  through host memory), in ``DIST_RUNS``' order: (model 2) fused; (data
  2, model 2) fsdp fused; (model 4) fused, d_ff's 86 column tiles
  unsplit beside a sharded A; (pod 4) with int8 gradient compression;
  (data 2, model 2) fsdp per-layer 8-bit fused; (model 2) dense and
  sparse: each against the one-process run on the card (``check_pair``),
  the int8 run against its plain version in one process and, at step 1,
  the uncompressed run (``INT8_TOL``); ``int8_psum`` over the world bit
  for bit against its plain version; each run's launches summed over its
  ranks (``DIST_KERNELS``), its collectives timed (``CollectiveLog``);
  then run 2's configuration in bf16 for ``DIST_BF16_STEPS`` steps, each
  rank's step ms, peak and modelled ``dist.collective_bytes``; then
  ``sl_matmul``, ``sddmm``, ``sparse_matmul`` at a TP-2 rank's local
  shapes and ``adam8bit`` on an fsdp shard against their plain versions,
  timed;
* serving on a device mesh (phase serve-mesh, in phase dist's world
  after its training runs): ``ServeEngine(mesh=)`` on each of
  ``SERVE_MESH_RUNS`` in f32, the traffic above: ``llama_7b`` (phase
  dist's init) paged fused on (model 2) and (model 4), paged sparse and
  quant (calibrated by this process while the world trains) on (model
  4), contiguous fused on (data 2, model 2), and ``qwen2_5_32b`` at full
  width on ``SERVE_MESH_QWEN_LAYERS`` = 2 layers (2 kv heads a rank,
  GQA group 5, its qkv bias drawn) paged fused on (model 4); every rank
  all-gathers each dispatch's sampled tokens and fails unless the ranks
  agree, and each run's tokens and ticks equal the one-process engine's
  on the card (a top-2 tie the only excuse); then ``llama_7b`` bf16 paged
  fused on (model 4): each rank's tokens/s and peak, its cache bytes a
  quarter of one process's pools, and each dispatch's launches asserted
  (one ``paged_attention`` a layer at decode, one ``paged_prefill`` a
  layer at prefill, on 8 local heads; 7 ``sl_matmul`` a layer, 4 of them
  on the rank's 1024 columns); then ``sl_matmul``, ``sparse_matmul`` and
  ``quant_sparse_matmul`` at decode on a rank's column tiles and
  ``paged_attention`` and ``paged_prefill`` on a rank's heads (qwen2.5's
  group 5 among them) against their plain versions, timed.

To stay inside its time limit with the gemma2, MoE, SSM, encoder and
quant phases: llama_1b's serving phases run on 2 of its 24 layers
(``SERVE_LAYERS``), the quant recipe and fallback on 2
(``RECIPE_LAYERS``) and its f32 training pairs on 2 (``PARITY_LAYERS``),
its bf16 Trainer runs take 4 steps (``TRAIN_STEPS``); llama_7b's engines
run on 2 of 32 (``SERVE_7B_LAYERS``), its quant path on 2
(``QUANT_7B_LAYERS``); gemma2_2b's f32 phase on 2 of 26
(``GEMMA_PARITY_LAYERS``), its bf16 phase on 4 (``GEMMA_BF16_LAYERS``);
deepseek_moe_16b's bf16 engines on its 2 f32
parity layers and its Trainer on 2 of 28 (``MOE_TRAIN_LAYERS``);
zamba2 in bf16 on 7 of 81 (``HYBRID_LAYERS``), xlstm on 8 of 24
(``XLSTM_BF16_LAYERS``), whisper's serving on 2 of 32 decoder layers
(``WHISPER_SERVE_LAYERS``); the Table 2 comparison at ``llama_60m`` takes
5 steps a mode; the dist phase's bf16 run takes 2 steps. Each support is
sampled once a run and reused by every
later init of its model (``core.support.keep_supports``), and the killed
launcher's process runs beside the uninterrupted run it is held against.

Any failure exits non-zero. Without a CUDA device, or without the rest of
the repository beside it, it exits non-zero and prints no result.

Output: one line per phase, then a ``{"kernels": [...]}`` JSON line and,
last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import re
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
DTYPES = (torch.bfloat16, torch.float32)
# a full L2 (50 MB) sweep before each timed launch: the serving path
# reads every weight once per step, so it finds them cold in L2
FLUSH_BYTES = 256 << 20
# a spin on the card after each sweep, before the start event (~0.3 ms at
# the H100's clocks): the host queues every launch of the timed call
# while it runs, so a call of several launches (a library call on a
# gathered view) is timed on the device alone, not at the host's pace
HOST_AHEAD_CYCLES = 1 << 19

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
    # llama_7b at full width (phase 7c at full depth, 7e on
    # SERVE_7B_LAYERS)
    "train_per_layer_llama_7b": ("sl_matmul", "sddmm", "adam8bit"),
    "serve_llama_7b": ("sl_matmul", "paged_attention", "paged_prefill"),
    "serve_sparse_llama_7b": ("sparse_matmul", "paged_attention",
                              "paged_prefill"),
    # the contiguous cache: prefill and decode at M = n_slots rows through
    # the linears' kernel; attention is plain PyTorch on the rows
    "serve_contiguous": ("sl_matmul",),
    "serve_contiguous_sparse": ("sparse_matmul",),
    "serve_contiguous_quant": ("quant_sparse_matmul",),
    # the chaos drills on llama_60m (kill/relaunch, stalls)
    "chaos_train_llama_60m": ("sl_matmul", "sddmm"),
    "chaos_train_per_layer_llama_60m": ("sl_matmul", "sddmm", "adam8bit"),
    "stall_paged_llama_60m": ("sl_matmul", "paged_attention",
                              "paged_prefill"),
    "stall_contiguous_llama_60m": ("sl_matmul",),
}
# the quant recipe (train fused, calibrate, serve sparse and quant)
PATH_KERNELS["recipe_llama_1b"] = PATH_KERNELS["recipe_llama_60m"] = \
    PATH_KERNELS["recipe_llama_7b"] = (
        "sl_matmul", "sddmm", "sparse_matmul", "quant_sparse_matmul",
        "paged_attention")
EXEC_PATH = {"fused": "serve", "sparse": "serve_sparse",
             "quant": "serve_quant"}
# the traffic's requests served one at a time on either cache (f32): the
# first opens with the shared prefix, the second does not
ALONE_REQUESTS = 2
CONTIGUOUS_PATH = {"fused": "serve_contiguous",
                   "sparse": "serve_contiguous_sparse",
                   "quant": "serve_contiguous_quant"}
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


def sddmm_atol(m: int) -> float:
    """SDDMM_ATOL, set at M = 2048 tokens, for M tokens: the partial sums
    grow as sqrt(M) and so does the number of their roundings, so the
    absolute error grows about linearly in M (on the H100 at 1280 x 1280:
    1.8e-4 at 1024 tokens, 2.5e-3 at 6000)."""
    return SDDMM_ATOL * max(1.0, m / 2048)
# the quant recipe (train, checkpoint, calibrate, serve) and the quant
# fallback at llama_1b's full width on this many of its 24 layers: the
# run must end within its time limit with the llama_7b phases, and
# calibration's time grows with depth (~4.4 s a layer); 4 until the
# quant phases at full width came
RECIPE_LAYERS = 2
# the f32 training pairs at llama_1b's full width on this many of its 24
# layers, and llama_7b's bf16 engines (phase 7e) on this many of its 32:
# depth cut to keep the script inside its time limit (every layer runs
# the same code at the same shapes); the pairs from 12 to 8 layers to pay
# for the MoE phases, both to 4 for the SSM and encoder phases, the
# engines to 2 for the quant phases, the pairs to 2 when a slower host
# took the script past its limit
PARITY_LAYERS = 2
SERVE_7B_LAYERS = 2
# llama_7b's quant path (phase 7f: train, checkpoint, calibrate, artifact,
# serve, the recipe's gates, the f32 tokens) on this many of its 32
# layers, its Trainer for this many steps: calibration takes seconds a
# 4096 x 11008 matrix, 7 of them a layer (the full depth's calibration
# and ~13 GB checkpoint run once outside the script, PERF.md)
QUANT_7B_LAYERS = 2
QUANT_7B_STEPS = 30
# llama_1b's serving phases (f32 and bf16, paged and contiguous, the
# calibration) on this many of its 24 layers: cut from full depth to pay
# for the gemma2 phases (12), the MoE phases (8), the SSM and encoder
# phases (4), then the quant phases (2)
SERVE_LAYERS = 2
# f32 train parity, fused vs dense: step 1 runs from identical parameters,
# so only the order of f32 sums differs (1e-5 relative). From step 2 on,
# Adam divides each gradient by its own magnitude: an element whose
# gradient is near zero can move by up to lr in either path, so later
# losses and norms agree only to 1e-3 relative.
TRAIN_TOL_STEP1 = 1e-5
TRAIN_TOL_LATER = 1e-3
# where a model is sensitive enough that rounding alone moves its later
# steps by more than that (xlstm_350m on 8 layers: an init moved by a
# relative 1e-7 moved its step-3 gradient norm by 3.59e-3 on an H100),
# phase h2 measures that spread in the same run and gates the later
# steps at SPREAD_FACTOR times it; step 1 keeps TRAIN_TOL_STEP1
SPREAD_FACTOR = 2.0
# bf16 Trainer runs of llama_1b (fused, sparse, per-layer 8-bit): one
# warm-up step and the rest timed (6 steps before gemma2's phases came)
TRAIN_STEPS = 4
# host memory for the supports the run keeps between inits (a full-depth
# llama_7b's take ~7 GB)
KEEP_SUPPORT_BYTES = 10 << 30
# processes that sample the full-depth llama_1b and llama_7b supports
# while nvcc builds (support.sample_ahead): with nvcc's five, the host's
# 8 cores stay busy through the build
AHEAD_1B_WORKERS = 4
AHEAD_7B_WORKERS = 3


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def arch(cfg) -> str:
    """A config's arch as the launchers name it, with its depth where a
    phase cut it ("llama_7b at 2 of 32 layers")."""
    from repro_torch.models import registry
    name = cfg.name.replace("-", "_")
    if name not in registry.PAPER_ARCHS + registry.ARCHS:
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
    with the L2 cache swept before every launch and the card kept busy
    (HOST_AHEAD_CYCLES) until the host has queued the call."""

    def __init__(self, device):
        self.flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8,
                                 device=device)

    def ms(self, fn, reps: int = 15) -> float:
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(HOST_AHEAD_CYCLES)
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
            mangled = line.split("'")[1]
            name = kernel_name(mangled)
            # a kernel templated on a bool (sl_matmul's and
            # sparse_split_kernel's kGrouped)
            for flag, tag in (("Lb1E", "<true>"), ("Lb0E", "<false>")):
                if flag in mangled:
                    name += tag
                    break
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


def check_sl_matmul(timer, gen, device, cfg, m_values, dtypes=DTYPES):
    """Every row count the engine gives the kernel (a decode batch and
    each prefill bucket times the slots), so each variant of the kernel
    is held against the plain version; in bf16 both variants are timed
    at each, which places the crossover."""
    rows = []
    for dtype in dtypes:
        for (d_in, d_out) in proj_shapes(cfg):
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


def check_sparse_decode(timer, gen, device, cfg, m_values, dtypes=DTYPES,
                        shapes=None, tag=""):
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
    over the memory rate, or 2·M·nnz operations, the larger. ``shapes``
    replaces ``cfg``'s projection shapes, ``tag`` ends each label."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_decode as spk
    rows = []
    for (d_in, d_out) in shapes or proj_shapes(cfg):
        sp, qp, nnz = sparse_decode_case(gen, device, d_in, d_out,
                                         cfg.param.delta,
                                         seed=d_in * 7 + d_out)
        for dtype in dtypes:
            for m in m_values:
                x = torch.randn((m, d_in), generator=gen,
                                device=device).to(dtype)
                label = f"{m}x{d_in}->{d_out} {dname(dtype)}{tag}"
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


def check_train_kernels(timer, gen, device, cfg, m, dtypes=DTYPES):
    """The training path's kernel calls at M = batch x seq tokens, for each
    projection shape: the forward sl_matmul, the dx sl_matmul on the
    transposed factors and Wᵀ's tile consts, and sddmm."""
    from repro_torch.kernels import ops
    rows = []
    for dtype in dtypes:
        for (d_in, d_out) in proj_shapes(cfg):
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
    rows = []
    for dtype in DTYPES:
        for (d_in, d_out) in proj_shapes(cfg):
            fwd, dx, nnz = sparse_train_case(
                gen, device, d_in, d_out, m, dtype, cfg.param.delta,
                seed=d_in * 7 + d_out)
            for what, (x, sp, n) in (("", fwd), ("dx ", dx)):
                label = (f"{what}{m}x{x.shape[1]}->{n} {dname(dtype)}"
                         + (" f32 out" if dtype != torch.float32 else ""))
                rows.append(time_sparse_train(timer, label, x, sp, n, dtype,
                                              nnz, device))
    return rows


def time_sparse_train(timer, label, x, sp, n, dtype, nnz, device):
    """One sparse_matmul call of the trainable sparse linear (f32 out):
    against the plain version and its own rerun bit for bit, timed beside
    them and one library call on the pre-densified S."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_decode as spk
    out = torch.float32
    m, k = x.shape
    got = spk.sparse_matmul(x, *sp, n, out)
    want = ref.sparse_matmul_ref(x, *sp, n, out)
    torch.cuda.synchronize()
    tol = TOL[got.dtype]
    err = compare(f"sparse_matmul {label}", got, want, got.dtype)
    if not torch.equal(got, spk.sparse_matmul(x, *sp, n, out)):
        fail(f"sparse_matmul {label}: a rerun on the same inputs gave other "
             "bits")
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
    say(f"kernel sparse_matmul {label} (training; {p.splits} split, "
        f"{p.blocks} blocks of {p.rows_per_block} rows): max_abs_err "
        f"{err:.3e} (tol {tol}), a rerun bit for bit | kernel {t_k:.4f} ms, "
        f"plain {t_p:.4f} ms, {lib_name} on dense S {t_l:.4f} ms, bound "
        f"{b:.4f} ms ({by}, {moved / 1e6:.2f} MB, {ops_ / 1e9:.2f} GFLOP)")
    return dict(name="sparse_matmul", shape=label, max_abs_err=err, tol=tol,
                ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b,
                bound_by=by)


def linear_shapes(cfg):
    """{name: (d_in, d_out)} of one layer's SLTrain linears."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    return {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
            "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d),
            "gate": (d, f), "up": (d, f), "down": (f, d)}


def proj_shapes(cfg):
    """The distinct (d_in, d_out) of one layer's linears, in order: three
    for the llama configs (d→d, d→d_ff, d_ff→d), five for gemma2's."""
    return list(dict.fromkeys(linear_shapes(cfg).values()))


def pattern_len(cfg) -> int:
    """Blocks in one period of the layer stack (2 for gemma2's local and
    global pair), the unit the per-layer sweep updates at a time."""
    return len(cfg.attn_pattern or ("global",))


def layer_slices(cfg):
    """({leaf: elements} of one period's slices that the per-layer step
    updates in the period's group, {leaf: elements} of the whole stacked
    leaves it defers, whose slices are no whole number of 256-blocks) on
    ``cfg`` (an SLTrain config; a period is one layer but for gemma2's
    pairs, whose leaves are named by kind)."""
    from repro_torch.core import support
    d, pc = cfg.d_model, cfg.param
    norms = ["ln_attn", "ln_mlp"] + (["ln_attn_post", "ln_mlp_post"]
                                     if cfg.use_post_norms else [])
    one = {n: d for n in norms}
    for name, (a, b) in linear_shapes(cfg).items():
        r = max(4, min(pc.rank, min(a, b) // 2))
        one[f"{name}.A"] = r * b
        one[f"{name}.B"] = a * r
        one[f"{name}.v"] = support.nnz_for(a, b, pc.delta,
                                           pc.support_kind)
    kinds = pattern_len(cfg)
    per_layer = one if kinds == 1 else {
        f"k{j}/{k}": n for j in range(kinds) for k, n in one.items()}
    sliced = {k: n for k, n in per_layer.items() if n % 256 == 0}
    deferred = {k: cfg.n_layers // kinds * n for k, n in per_layer.items()
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
    # a tied embedding's gradient is f32: it sums the head's and the
    # embedding's cotangents (train/perlayer.py)
    for name in ["embed"] + ([] if cfg.tie_embeddings else ["lm_head"]):
        names.setdefault((cfg.padded_vocab * cfg.d_model,
                          cfg.tie_embeddings), []).append(name)
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


def check_adam8bit(timer, gen, device, cfg, steps=3, dtypes=DTYPES):
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
    for dtype in dtypes:
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
    label = f"layer group ({len(segs)} slices) bfloat16" if \
        pattern_len(cfg) == 1 else f"period group ({len(segs)} slices) bfloat16"
    scalars, plain = adam8bit_steps(label, segs, clip, device, steps)
    t_k = timer.ms(lambda: adk.adam8bit_group(segs, scalars, clip))
    t_leaf = timer.ms(lambda: [adk.adam8bit_group([s], scalars, clip)
                               for s in segs])
    t_p = timer.ms(lambda: [ref.adam8bit_segment_ref(
        *pl, scalars, clip, decay=s.decay) for s, pl in zip(segs, plain)])
    n = sum(s.p.numel() for s in segs)
    moved = adam8bit_bytes(segs) + nbytes(scalars, clip)
    b, by = bound_ms(moved, ADAM8BIT_OPS * n, torch.float32)
    launches = -(-len(segs) // adk.MAX_SEGMENTS)
    say(f"kernel adam8bit {label}, n={n}: {steps} steps bit-identical to "
        f"the plain version, {launches} launch{'es' * (launches > 1)} a "
        f"step | kernel {t_k:.4f} ms, "
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


def live_kv_bytes(k_pool, table, last_pos, window=0):
    """Bytes of K and V in the blocks a slot can see (non-null entries up
    to the block of its last query position), and their keys; with a
    ``window``, only the keys inside it, as the kernels read them."""
    bl = k_pool.shape[1]
    per_key = k_pool[0, 0].numel() * k_pool.element_size()
    t = table.cpu()
    n = 0
    for s in range(t.shape[0]):
        last = int(last_pos[s])
        lo = max(0, last - window + 1) if window > 0 else 0
        for j in range(min(t.shape[1], last // bl + 1)):
            if t[s, j] != 0:
                n += max(0, min(bl * (j + 1), last + 1) - max(bl * j, lo)) \
                    if window > 0 else bl
    return 2 * n * per_key, n


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
    kv_b, keys_live = live_kv_bytes(kp, tbl, pos, kw.get("window", 0))
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
            "quant_sparse_matmul": spk.quant_sparse_matmul,
            "sl_matmul_grouped": slk.sl_matmul_grouped,
            "sddmm_grouped": sdk.sddmm_grouped,
            "sparse_matmul_grouped": spk.sparse_matmul_grouped,
            "quant_sparse_matmul_grouped": spk.quant_sparse_matmul_grouped}


def launch_counts():
    return {k: fn.launches for k, fn in _wrappers().items()}


def reset_launch_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def serve(cfg, params, consts, prompts, arrivals, *, exec_mode, attn_kernel,
          n_slots, max_len, block_len, new_tokens, device,
          sparse_decode=False, paged=True, route_log=None):
    """One engine run of the traffic; returns (requests, stats, engine,
    wall seconds). The paged engine runs ``run_stream`` with prefix
    sharing; the contiguous one (``paged=False``: arrivals, ``block_len``
    and ``attn_kernel`` unused) drains its queue as the reference's
    launcher does, prefilling token by token through the decode step.
    Each dispatch (one prefill or decode program) is bracketed by CUDA
    events: ``stats["span_s"]`` is the device time from each dispatch's
    start to its last kernel's end, summed, and ``stats["token_shapes"]``
    the (slots, tokens per slot) of every dispatch, from which the row
    counts the kernels saw follow. With ``route_log`` (a ``RouteLog``)
    each dispatch sets its index there, and ``stats`` gains
    ``outs_before`` (each request's output count before each dispatch)
    and ``top2_gaps`` (each dispatch's least top-2 gap of the logits it
    samples from), at a host sync a dispatch."""
    from repro_torch.serve.engine import ServeEngine
    if paged:
        eng = ServeEngine(cfg, params, consts, n_slots=n_slots,
                          max_len=max_len, paged=True, block_len=block_len,
                          exec_mode=exec_mode, sparse_decode=sparse_decode,
                          attn_kernel=attn_kernel, prefix_sharing=True,
                          device=device)
    else:
        eng = ServeEngine(cfg, params, consts, n_slots=n_slots,
                          max_len=max_len, exec_mode=exec_mode,
                          sparse_decode=sparse_decode, device=device)
    spans, shapes = [], set()
    held, outs_before, gaps = [], [], []

    def bracket(fn, kind):
        def run(params, consts, tokens, *args, **kwargs):
            if route_log is not None:
                route_log.dispatch = len(spans)
                outs_before.append([len(r.out) for r in held])
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(params, consts, tokens, *args, **kwargs)
            e.record()
            spans.append((s, e))
            shapes.add((kind, tuple(tokens.shape)))
            if route_log is not None:
                lg = out[1][..., :cfg.vocab_size].float()
                if kind == "prefill":
                    last = (args[1].long() - 1).clamp(0, lg.shape[1] - 1)
                    lg = lg[torch.arange(lg.shape[0], device=lg.device),
                            last]
                else:
                    lg = lg[:, -1]
                top = lg.topk(2, dim=-1).values
                gaps.append(float((top[:, 0] - top[:, 1]).min()))
            return out
        return run
    if paged:
        eng._prefill_fn = bracket(eng._prefill_fn, "prefill")
    eng._decode_fn = bracket(eng._decode_fn, "decode")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if paged:
        reqs = [eng.submit(p, max_new_tokens=new_tokens, arrival=a)
                for p, a in zip(prompts, arrivals)]
        held.extend(reqs)
        try:
            stats = eng.run_stream()
        except RouteDiverged as stop:
            stats = {"diverged_at": stop.args[0]}
    else:
        reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
        held.extend(reqs)
        stats = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stats["span_s"] = sum(s.elapsed_time(e) for s, e in spans) / 1e3
    stats["token_shapes"] = shapes
    stats["outs_before"], stats["top2_gaps"] = outs_before, gaps
    if "diverged_at" in stats:
        return reqs, stats, eng, wall
    bad = [(r.uid, r.status) for r in reqs if r.status != "done"]
    if bad or stats["exhausted"] or len(stats["completed"]) != len(reqs):
        fail(f"{eng.cfg.param.exec_mode}/{eng.cfg.attn_kernel}"
             f"{'' if paged else '/contiguous'}: requests not completed: "
             f"{bad}")
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
    every kernel: draw it U(-1, 1) instead. A zamba2 adapter's B (its
    (catn·B)·A has no alpha/r scale) is drawn U(±1/sqrt(2·d_model)), so
    its term is the size of the shared in_proj's, not ~20 times it."""
    def walk(tree, lim=1.0):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, v["B"].shape[-2] ** -0.5 if k == "adapter" else lim)
            elif k == "B":
                v.uniform_(-lim, lim, generator=gen)
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
    times its column's scale, put back through the layout's ``perm`` (the
    tile consts', or, in a tree calibrated from an exec_mode dense init
    that has none, rebuilt on the host from the support as
    ``quant.layout`` built the slots). Densified with the error-folded
    B', A', that is the weight the int8 decode computes with."""
    from repro_torch.core import support
    from repro_torch.kernels import ops

    def one(v, qv_t, cols_q, qscale, perm, cols, rows=None):
        nnt = qscale.shape[0]
        if perm is None:
            c = cols.cpu().numpy()
            r = rows.cpu().numpy() if rows is not None else np.repeat(
                np.arange(c.shape[0], dtype=np.int32), c.shape[1])
            nkt, _, cap = qv_t.shape
            perm = torch.from_numpy(support.tile_index_arrays(
                r, c.reshape(-1), nkt * 128, nnt * 128, cap)[2]).to(
                qv_t.device)
        nt = torch.arange(nnt, device=qv_t.device).view(1, nnt, 1)
        vals = qv_t.float() * qscale.reshape(-1)[cols_q.long() + 128 * nt]
        return ops._scatter_tiles(vals, perm, v.numel()).reshape(v.shape)

    def walk(p, c):
        if "qv_t" in c:
            v = p["v"]
            lead = v.shape[:-2] if "rows" not in c else v.shape[:-1]
            n = int(np.prod(lead))
            flat = [None if t is None else
                    t.reshape((n,) + tuple(t.shape[len(lead):])) for t in
                    (v, c["qv_t"], c["cols_q"], c["qscale"], c.get("perm"),
                     c["cols"], c.get("rows"))]
            out = torch.stack([one(*(None if t is None else t[i]
                                     for t in flat)) for i in range(n)])
            return {**p, "v": out.reshape(v.shape).to(v.dtype)}
        return {k: walk(x, c.get(k, {})) if isinstance(x, dict) else x
                for k, x in p.items()}
    return walk(qparams, qconsts)


def calibrate_on_card(cfg, params, consts, device, artifact=True):
    """Calibrate ``cfg``'s model on the card (host scales, codes and
    layout; the error fold with torch on the card), every SLTrain linear
    one matrix and every routed expert of a layer one more, timed per
    matrix; with ``artifact`` write the quant artifact under build/ and
    load it back, every leaf bit for bit. Returns the (loaded) calibrated
    params and consts."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.models.common import tree_leaves
    from repro_torch.quant import calibrate
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qp, qc, st = calibrate.calibrate_model(cfg, params, consts)
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    single, grouped = linear_counts(cfg)
    n_lin = single + grouped * cfg.moe.n_experts
    if st["n_matrices"] != n_lin:
        fail(f"calibrate: {st['n_matrices']} matrices, expected {n_lin}")
    say(f"calibrate {arch(cfg)} {cfg.dtype} on the "
        f"card (host scales and codes, float64 eigh fold on the card): "
        f"{t_cal:.1f} s, n_matrices {st['n_matrices']} ({single} single"
        + (f", {grouped} expert stacks of {cfg.moe.n_experts}"
           if grouped else "") + f"), {t_cal / n_lin:.3f} s a matrix, "
        f"{st['nnz']} int8 codes, max_abs_err {st['max_abs_err']:.4e}")
    if not artifact:
        return qp, qc
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
    return lp, lc


def quant_engine_f32(cfg, qparams, qconsts, prompts, arrivals, device,
                     **kw):
    """Serve a calibrated f32 model in exec_mode quant (the
    ``quant_sparse_matmul`` kernel + paged kernels; ``serve_quant``'s
    kernels must launch, no other linear kernel) against a dense/gather
    engine on the dequantized weights (B', A' and v := dequant(qv)): the
    same greedy tokens, a top-2 tie the only excuse. Returns the dequantized params
    and the quant run's dispatch shapes."""
    reset_launch_counts()
    q_reqs, q_stats, _, q_wall = serve(cfg, qparams, qconsts, prompts,
                                       arrivals, exec_mode="quant",
                                       attn_kernel="paged", device=device,
                                       **kw)
    launches = launch_counts()
    if not all(launches[k] for k in PATH_KERNELS["serve_quant"]) or \
            launches["sl_matmul"] or launches["sparse_matmul"]:
        fail(f"quant/paged launched the wrong kernels: {launches}")
    dp = dequantized(qparams, qconsts)
    reset_launch_counts()
    d_reqs, _, _, d_wall = serve(cfg, dp, qconsts, prompts, arrivals,
                                 exec_mode="dense", attn_kernel="gather",
                                 device=device, **kw)
    if any(launch_counts().values()):
        fail(f"dense/gather on dequantized weights launched kernels: "
             f"{launch_counts()}")
    same, ties = same_tokens("quant/paged vs dense/gather on dequantized "
                             "weights", q_reqs, d_reqs, cfg, dp, qconsts,
                             device)
    total = sum(len(r.out) for r in q_reqs)
    say(f"engine f32 {arch(cfg)} exec_mode quant == dense/gather on the "
        f"dequantized weights on {same}/{total} tokens"
        + (f", ties (uid, token, top-2 gap): {ties}" if ties else "")
        + f" | quant {q_wall:.2f} s launches {launches}, dense "
        f"{d_wall:.2f} s")
    return dp, q_stats["token_shapes"]


def phase_quant_f32(cfg, params, consts, prompts, arrivals, device, **kw):
    """Calibrate llama_1b on the card, write the quant artifact under
    build/ and load it back bit for bit (``calibrate_on_card``), then
    serve it in exec_mode quant against a dense/gather engine on the
    dequantized weights (``quant_engine_f32``). Returns the loaded
    artifact's trees, its dequantized params and the quant run's dispatch
    shapes."""
    lp, lc = calibrate_on_card(cfg, params, consts, device)
    dp, shapes = quant_engine_f32(cfg, lp, lc, prompts, arrivals, device,
                                  **kw)
    return lp, lc, dp, shapes


def dispatch_ticks(reqs):
    return [(r.t_admit, r.t_first, r.t_done) for r in reqs]


def phase_contiguous_f32(cfg, params, consts, qparams, qconsts, dq, prompts,
                         device, **kw):
    """The contiguous engine (``paged=False``, the reference launcher's
    default) in f32 on the traffic's prompts: fused (``sl_matmul``) and
    sparse (``sparse_matmul``) against dense, and quant
    (``quant_sparse_matmul``, the loaded artifact) against dense on the
    dequantized weights: the same greedy tokens (a top-2 gap below 1e-4
    the only excuse) and the same ticks. Then each of the first
    ``ALONE_REQUESTS`` requests alone: the contiguous fused engine gives
    the paged fused engine's tokens (the paged kernels against plain
    attention on the rows). Returns the
    dispatch shapes by exec mode and the launch counts of the quant
    run."""
    ckw = dict(kw, paged=False, attn_kernel=None, device=device)
    shapes, dense = {}, {}
    t0 = time.perf_counter()
    for mode, kernel, p, c in (
            ("fused", "sl_matmul", params, consts),
            ("sparse", "sparse_matmul", params, consts),
            ("quant", "quant_sparse_matmul", qparams, qconsts)):
        dense_p = dq if mode == "quant" else params
        if id(dense_p) not in dense:
            reset_launch_counts()
            dense[id(dense_p)] = serve(cfg, dense_p, c, prompts, None,
                                       exec_mode="dense", **ckw)
            if any(launch_counts().values()):
                fail(f"contiguous dense launched kernels: {launch_counts()}")
        d_reqs, _, d_eng, _ = dense[id(dense_p)]
        reset_launch_counts()
        reqs, stats, eng, wall = serve(cfg, p, c, prompts, None,
                                       exec_mode=mode, **ckw)
        launches = launch_counts()
        if not launches[kernel] or any(
                n for k, n in launches.items() if k != kernel):
            fail(f"contiguous {mode} launched {launches}, only {kernel} "
                 "expected")
        same, ties = same_tokens(f"contiguous {mode} vs dense", reqs, d_reqs,
                                 cfg, dense_p, c, device)
        if dispatch_ticks(reqs) != dispatch_ticks(d_reqs) or \
                dict(eng.dispatches) != dict(d_eng.dispatches):
            fail(f"contiguous {mode}: ticks {dispatch_ticks(reqs)} vs dense "
                 f"{dispatch_ticks(d_reqs)}")
        total = sum(len(r.out) for r in reqs)
        say(f"engine f32 {arch(cfg)} contiguous {mode} == dense"
            f"{' on the dequantized weights' if mode == 'quant' else ''} on "
            f"{same}/{total} tokens, tick for tick"
            + (f", ties (uid, token, top-2 gap): {ties}" if ties else "")
            + f" | {dict(eng.dispatches)} dispatches, {wall:.2f} s, launches "
            f"{launches}")
        shapes[mode] = stats["token_shapes"]
        if mode == "quant":
            quant_launches = launches
    del dense
    # one engine of each cache, each request submitted only once the one
    # before it finished: alone in its engine, it takes slot 0, and every
    # position it attends it wrote itself
    from repro_torch.serve.engine import ServeEngine
    alone = {}
    for paged in (False, True):
        extra = dict(paged=True, block_len=kw["block_len"],
                     attn_kernel="paged") if paged else {}
        eng = ServeEngine(cfg, params, consts, n_slots=kw["n_slots"],
                          max_len=kw["max_len"], exec_mode="fused",
                          device=device, **extra)
        alone[paged] = []
        for prompt in prompts[:ALONE_REQUESTS]:
            alone[paged].append(eng.submit(prompt,
                                           max_new_tokens=kw["new_tokens"]))
            eng.run_until_drained()
            if alone[paged][-1].status != "done":
                fail(f"request alone (paged={paged}): "
                     f"{alone[paged][-1].status}")
    same, ties = same_tokens("each request alone, contiguous vs paged",
                             alone[False], alone[True], cfg, params, consts,
                             device)
    say(f"engine f32 {arch(cfg)} one request at a time: contiguous fused == "
        f"paged fused (paged kernels) on {same}/"
        f"{ALONE_REQUESTS * kw['new_tokens']} tokens of the first "
        f"{ALONE_REQUESTS} requests" + (f", ties (uid, token, top-2 gap): {ties}" if ties
                      else "")
        + f" | phase {time.perf_counter() - t0:.1f} s")
    return shapes, quant_launches


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
                      exec_mode="fused", path=None, paged=True,
                      profiled=False, want_per_dispatch=None, **kw):
    """Phase 4: a serving path in bf16 (``exec_mode`` fused, sparse or
    quant, with the paged kernels; or, with ``paged=False``, on the
    contiguous cache), timed, with every kernel's launch count read around
    the run, and each kernel of ``path`` (default the exec mode's,
    ``EXEC_PATH`` or ``CONTIGUOUS_PATH``) required to have launched. The
    contiguous engine must prefill with one dispatch a prompt token. With
    ``profiled`` the run itself is timed under the device-only profiler,
    and its busy share reported as ``phase_profile`` does. With
    ``want_per_dispatch`` ({kernel: launches}) each count must be exactly
    that many a dispatch."""
    from torch.profiler import ProfilerActivity, profile
    path = path or (EXEC_PATH if paged else CONTIGUOUS_PATH)[exec_mode]
    reset_launch_counts()
    with (profile(activities=[ProfilerActivity.CUDA]) if profiled
          else contextlib.nullcontext()) as prof:
        reqs, stats, eng, wall = serve(cfg, params, consts, prompts,
                                       arrivals, exec_mode=exec_mode,
                                       attn_kernel="paged" if paged else None,
                                       paged=paged, device=device, **kw)
    launches = launch_counts()
    if not paged and eng.dispatches["prefill"] != sum(map(len, prompts)):
        fail(f"bf16 contiguous {exec_mode}: {eng.dispatches['prefill']} "
             f"prefill dispatches for {sum(map(len, prompts))} prompt "
             "tokens")
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
    for k, n in (want_per_dispatch or {}).items():
        if launches[k] != n * steps:
            fail(f"bf16 {exec_mode} serving launched {k} {launches[k]} "
                 f"times in {steps} dispatches, expected {n} a dispatch")
    extra = ""
    if exec_mode != "fused":
        extra = (f" | modeled sparse-term bytes per step "
                 f"{sparse_bytes_per_step(cfg, exec_mode == 'quant') / 1e6:.2f}"
                 f" MB ({kernel} launches per step "
                 f"{launches[kernel] / steps:.0f})")
    what = f"{kernel} + paged kernels" if paged else \
        f"contiguous cache, {kernel} + plain attention"
    say(f"engine bf16 {arch(cfg)} ({exec_mode}: {what}): "
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
    if profiled:
        say_busy(prof, f"bf16 engine run, exec_mode {exec_mode}"
                 f"{'' if paged else ' (contiguous)'} (timed above, "
                 f"{stats['decode_steps']} decode steps, device-only "
                 "profiler on)", wall)
    say(f"engine bf16 {exec_mode}{'' if paged else ' contiguous'} dispatch "
        f"spans, same run: {span:.3f} s of "
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
    say_busy(prof, f"bf16 engine run, exec_mode {kw['exec_mode']} "
             f"({stats['decode_steps']} decode steps, device-only profiler "
             f"on)", wall, f" (unprofiled run {plain_wall:.3f} s)")


def say_busy(prof, label, wall, extra=""):
    """Print a profiled run's device busy share and its kernels by device
    time (``device_busy``)."""
    busy = device_busy(prof)
    if busy is None:
        say("profile: the profiler recorded no device time (not measured)")
        return
    busy_us, top = busy
    say(f"profile {label}: wall {wall:.3f} s{extra}, device busy "
        f"{busy_us / 1e6:.3f} s = {100 * busy_us / 1e6 / wall:.1f}% (idle "
        f"{100 - 100 * busy_us / 1e6 / wall:.1f}%, same run); device time by "
        "kernel: " + "; ".join(f"{n[:48]} {pct:.1f}%" for n, pct in top))


def device_events(prof):
    """[(name, start µs, end µs)] of the device activity a profiler
    recorded, read from its kineto results: ``prof.events()`` builds an
    object for every event, the runtime calls' too, at tens of µs each,
    seconds for one engine run. Only durations and overlaps are used, so
    the kineto clock's other origin changes nothing."""
    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is None:
        return [(e.name, e.time_range.start, e.time_range.end)
                for e in prof.events() if e.device_type == cuda]
    return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in raw.events() if e.device_type() == cuda]


def device_busy(prof, n_top: int = 6):
    """(busy µs, [(kernel name, % of device time)] for the top ``n_top``)
    from a profiler's device events: busy is the union of the kernels'
    intervals. None when the profiler recorded no device activity."""
    events = device_events(prof)
    if not events:
        return None
    busy_us, spans = 0.0, sorted((s, e) for _, s, e in events)
    cur_s, cur_e = spans[0]
    for s, e in spans[1:]:                      # union of kernel intervals
        if s > cur_e:
            busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy_us += cur_e - cur_s
    by_name = {}
    for name, s, e in events:
        n = name.replace("void ", "").replace("(anonymous namespace)::", "")
        by_name[n] = by_name.get(n, 0.0) + (e - s)
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
    head, embed = Counter(), Counter()
    groups = {}       # a stacked group: (layers, per-layer, deferred)
    for path, leaf in tree_leaves(params):
        parts = tuple(path.split("/"))
        dt = leaf.dtype
        if parts[0] == "embed":
            embed[(dt, f32 if tied else dt)] += 1
        elif parts[0] not in ("layers", "dense_layers"):
            head[(dt, dt)] += 1
        else:
            n, layer, deferred = groups.setdefault(
                parts[0], (leaf.shape[0], Counter(), Counter()))
            st = optimizer.stack_state(optimizer.leaf_state(opt_state, parts),
                                       leaf, n)
            if st is None:
                deferred[(dt, f32)] += 1
            else:
                layer[(dt, dt)] += 1
    launches = lambda c: sum(-(-k // MAX_SEGMENTS) for k in c.values())
    return launches(head) + launches(embed) + sum(
        n * launches(layer) + launches(deferred)
        for n, layer, deferred in groups.values())


def param_rel_diff(a, b):
    """The worst relative difference over param leaves: max |a - b| over
    max |b|, leaf by leaf."""
    from repro_torch.models.common import tree_leaves
    worst = 0.0
    for (_, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
        d = (x.float() - y.float()).abs().max().item()
        worst = max(worst, d / max(y.float().abs().max().item(), 1e-30))
    return worst


def model_batch(cfg, tokens, gen):
    """A train or forward batch of ``tokens``: for whisper with seeded
    frame embeddings (B, encoder_seq, d_model) in the model's dtype."""
    b = {"tokens": tokens}
    if cfg.family == "whisper":
        from repro_torch.models.common import DTYPES
        b["frames"] = torch.randn(
            (tokens.shape[0], cfg.encoder_seq, cfg.d_model), generator=gen,
            device=tokens.device).to(DTYPES[cfg.dtype])
    return b


def phase_train_parity(cfg, device, gen, *, batch, seq, steps=3,
                       names=None, spread=False, init=None):
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
    steps update their params in place: each run starts from a copy.
    ``names`` picks a subset of the runs (the pairs among them are
    checked). With ``spread`` one more dense run starts from the init with
    every element moved by a relative 1e-7 (N(0, 1)-scaled): its
    difference from the dense run is what rounding alone does to the
    model's trajectory, and a later step's gate is the larger of
    TRAIN_TOL_LATER and twice that spread (``SPREAD_FACTOR``). ``init``
    ((params, consts) with B drawn) replaces the phase's own init."""
    from repro_torch.data.pipeline import SyntheticC4
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.models.common import tree_map
    from repro_torch.optim import optimizers
    tc = train_config(cfg, steps=steps, batch=batch, seq=seq, ckpt_dir="")
    api = registry.get_api(cfg)
    t0 = time.perf_counter()
    if init is None:
        params, consts = api.init(cfg, seed=tc.seed, device=device)
        randomize_b(params, gen)
        torch.cuda.synchronize()
        say(f"init {arch(cfg)} f32 for training in "
            f"{time.perf_counter() - t0:.1f} s")
    else:
        params, consts = init
    consts = ops.add_transposed_tiles(consts)
    data = SyntheticC4(cfg.vocab_size, seq, batch, seed=tc.seed)
    batches = [model_batch(cfg, torch.from_numpy(
        data.next_batch()["tokens"]).to(device), gen)
        for _ in range(steps)]
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
    if names is not None:
        runs = {k: v for k, v in runs.items() if k in names}
        pairs = [p for p in pairs if set(p) <= set(names)]
    if spread:
        runs["dense, init moved 1e-7"] = (dense, "adamw", "global", ())
    out, first = {}, {}
    for name, (c, opt_name, mode, kernels) in runs.items():
        opt = optimizers.make(dataclasses.replace(tc.optim, name=opt_name))
        fn = train_fn(c, api, opt, mode)
        p = tree_map(torch.clone, params) if mode == "per_layer" else params
        if name.endswith("moved 1e-7"):
            p = tree_map(lambda t: t * (1 + 1e-7 * torch.randn(
                t.shape, generator=gen, device=t.device)), params)
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
    later = None
    if spread:
        gaps = [max(abs(m[k] - d[k]) / abs(d[k]) for k in (0, 1))
                for m, d in zip(out["dense, init moved 1e-7"], out["dense"])]
        later = [max(TRAIN_TOL_LATER, SPREAD_FACTOR * g) for g in gaps]
        say(f"train f32 {arch(cfg)}: the dense run from an init moved by a "
            "relative 1e-7 differs from the dense run by "
            f"{[f'{g:.2e}' for g in gaps]} per step (loss or grad norm): "
            f"later steps gated at {[f'{t:.2e}' for t in later[1:]]}")
    for a_name, b_name in pairs:
        pdiff = (f", worst relative param difference after step 1 "
                 f"{param_rel_diff(first[a_name], first[b_name]):.3e}"
                 if b_name in first else "")
        check_pair(out, a_name, b_name, pdiff, later)


def check_pair(out, a_name, b_name, extra="", later=None,
               first=TRAIN_TOL_STEP1):
    """Fail unless run ``a_name``'s (loss, grad_norm, nonfinite) rows
    agree with ``b_name``'s: step 1 to ``first`` (TRAIN_TOL_STEP1)
    relative, later steps to TRAIN_TOL_LATER (or ``later[i]`` at step
    i + 1), every value finite and no step skipped."""
    for i, (f, d) in enumerate(zip(out[a_name], out[b_name])):
        tol = first if i == 0 else (
            later[i] if later else TRAIN_TOL_LATER)
        for what, a, b in (("loss", f[0], d[0]), ("grad_norm", f[1], d[1])):
            rel = abs(a - b) / max(abs(b), 1e-12)
            if not (np.isfinite(a) and rel <= tol) or f[2] or d[2]:
                fail(f"f32 train step {i + 1}: {a_name} {what} {a!r} vs "
                     f"{b_name} {b!r}, relative difference {rel:.3e} > "
                     f"{tol}")
    rel = [max(abs(f[k] - d[k]) / abs(d[k]) for k in (0, 1))
           for f, d in zip(out[a_name], out[b_name])]
    after = [f"{t:.2e}" for t in later[1:]] if later else TRAIN_TOL_LATER
    say(f"train f32 parity: {a_name} vs {b_name} largest relative "
        f"difference of loss and grad norm per step "
        f"{[f'{r:.2e}' for r in rel]} (tol {first} at step 1, "
        f"{after} after){extra}")


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


def phase_train_bf16(cfg, device, smi, *, batch, seq, steps=TRAIN_STEPS,
                     save=True):
    """Phase 7: the Trainer in bf16 in ``cfg``'s exec mode (fused, or
    sparse), as the launcher runs it: one warm-up step plus ``steps`` - 1
    timed, its final checkpoint written unless ``save`` is false. Launch
    counts and the shapes the kernels saw are read around the run (the
    SLTrain linears a forward calls: ``linear_counts``, or
    ``ssm_linear_calls`` for the SSM and encoder families)."""
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
    if not save:
        tr.save = lambda *a, **k: None
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
    n_lin, n_grouped = linear_counts(cfg) if cfg.family in (
        "llama", "gemma2", "vlm", "moe") else (ssm_linear_calls(cfg), 0)
    # forward + dx of each linear on its kernel, dV on sddmm; each expert
    # stack's linear the same on the grouped launches
    linear = {"fused": "sl_matmul", "sparse": "sparse_matmul"}[mode]
    want = {k: 0 for k in launches}
    want.update({linear: 2 * n_lin * steps, "sddmm": n_lin * steps})
    if n_grouped:
        want.update(sl_matmul_grouped=2 * n_grouped * steps,
                    sddmm_grouped=n_grouped * steps)
    if launches != want:
        fail(f"bf16 {mode} training launched {launches}, expected {want} "
             f"({n_lin} linears and {n_grouped} expert stacks x {steps} "
             "steps: forward + dx, dV)")
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
        + (f", sl_matmul_grouped {launches['sl_matmul_grouped'] // steps}, "
           f"sddmm_grouped {launches['sddmm_grouped'] // steps}"
           if n_grouped else "") + f" | max_memory_allocated {peak / 2**30:.2f} GiB | run wall "
        f"{wall:.1f} s" + (f" incl. checkpoint of step {steps}" if save else
                           " (final checkpoint not written)") + f" | {smi}")
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
    events = [(s, e) for name, s, e in device_events(prof) if key in name]
    return sum(e - s for s, e in events) / 1e3, len(events)


def phase_perlayer_bf16(cfg, device, smi, *, batch, seq, global_peak=None,
                        steps=TRAIN_STEPS, remat="none", save=True,
                        handoff=None):
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
    n_lin, n_grouped = linear_counts(cfg)
    # a forward, then a forward and a backward per layer in each sweep;
    # under remat each sweep runs each layer's forward once more
    fwd = 5 if remat == "none" else 7
    want = {k: 0 for k in launches}
    want.update(sl_matmul=fwd * n_lin * steps, sddmm=2 * n_lin * steps,
                adam8bit=per_step * steps)
    if n_grouped:
        want.update(sl_matmul_grouped=fwd * n_grouped * steps,
                    sddmm_grouped=2 * n_grouped * steps)
    if launches != want:
        fail(f"bf16 per-layer training launched {launches}, expected {want}")
    # one update group a period (a layer; gemma2's local/global pair) and
    # a dense-prefix block
    n_dense = cfg.moe.first_k_dense if cfg.moe.n_experts else 0
    periods = (cfg.n_layers - n_dense) // pattern_len(cfg) + n_dense
    lt = tr.obs.get("train.perlayer.layer_update_ms")
    if lt is None or lt.count != periods * steps:
        fail("per-layer timing recorded "
             f"{None if lt is None else lt.count} period updates, expected "
             f"{periods * steps}")
    med = statistics.median(dts[1:])
    tokens = batch * seq
    mfu = roofline.train_mfu(cfg, tokens, med)
    init = tr.obs.get("init.seconds")
    init = (f"init {init.value:.1f} s with "
            f"{tr.obs.get('init.sampling_workers').value:.0f} support "
            "sampling workers" if init is not None else "state passed in")
    nstate = state_bytes(state)
    say(f"train bf16 {arch(cfg)} (Trainer, per_layer, adam8bit, fused, remat "
        f"{remat}): {steps} steps, losses {[round(x, 4) for x in losses]} | "
        f"step ms (dispatch + sync) {[round(d * 1e3, 1) for d in dts]}, "
        f"median of steps 2-{steps} {med * 1e3:.1f} ms = {tokens / med:.0f} "
        f"tokens/s, MFU {100 * mfu:.3f}% of {roofline.PEAK_FLOPS / 1e12:.0f} "
        f"TFLOP/s (data sheet) | launches per step: sl_matmul "
        f"{launches['sl_matmul'] // steps}, sddmm "
        f"{launches['sddmm'] // steps}, adam8bit "
        f"{launches['adam8bit'] // steps}"
        + (f", sl_matmul_grouped {launches['sl_matmul_grouped'] // steps}, "
           f"sddmm_grouped {launches['sddmm_grouped'] // steps}"
           if n_grouped else "") + " | train.perlayer.layer_update_ms "
        f"over {lt.count} layer updates: mean {lt.sum / lt.count:.2f} "
        f"(histogram bucket p50 {lt.percentile(50):.0f}) | {init} | run "
        f"wall {wall:.1f} s"
        + (f" incl. checkpoint of step {steps}" if save else
           " (final checkpoint not written)") + f" | {smi}")
    if cfg.family == "llama":
        est = memory_estimate(cfg, "sltrain", "adam8bit", "per_layer")
        est = (f"training_estimate (f32 moments, int32 indices) params + "
               f"optimizer {(est.param_bytes + est.optim_bytes) / 2**30:.3f}"
               f" GiB, with grads and transients "
               f"{est.total_bytes / 2**30:.3f} GiB")
    else:       # core.memory's inventory is the llama layer's
        est = "training_estimate not modeled for this family"
    say(f"memory bf16 {arch(cfg)} per_layer + adam8bit, remat {remat}: "
        f"max_memory_allocated {peak} B = {peak / 2**30:.3f} GiB | params + "
        f"optimizer state {nstate / 2**30:.3f} GiB, {est} | the fused "
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
    for 5 steps a mode (cut from 100, then 10, to keep the script inside
    its time limit), gated only on finite losses."""
    from repro_torch.analysis import pretrain_comparison as cmp
    root = os.path.join(ROOT, "build")
    os.makedirs(root, exist_ok=True)
    for label, kw in (("default size (dim 128)", dict(steps=300)),
                      ("llama_60m", dict(size="60m", steps=5))):
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


def phase_recipe(cfg, device, smi, *, batch, seq, steps=60):
    """The quant recipe of ``analysis/quant_recipe.py`` at ``cfg``'s full
    width (llama_1b, llama_7b), through the launchers' code paths: the
    bf16 fused Trainer for ``steps`` steps at batch x seq (AdamW, lr
    3e-3, the launcher's warmup) writes its checkpoint under build/; the
    calibrate CLI's path (``calibrate.calibrate_checkpoint``) turns it
    into a quant artifact on the card, timed, with its size; the serve
    launcher's ``--ckpt-dir`` path (``serve.load_model``) restores it
    into a sparse engine's init and its ``--quant-ckpt`` path loads the
    artifact back for a quant engine; then the recipe's rows and the
    reference's gates. Returns the launch counts of the whole recipe, the
    checkpoint's directory and the loaded quant params and consts."""
    from repro_torch.analysis import quant_recipe
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.quant import calibrate
    from repro_torch.train.trainer import Trainer
    name = cfg.name.replace("-", "_")
    ckpt_dir = os.path.join(ROOT, "build", f"chip_smoke_recipe_ckpt_{name}")
    art = os.path.join(ROOT, "build", f"chip_smoke_recipe_quant_{name}")
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
    dir_bytes = lambda d: sum(os.path.getsize(os.path.join(r, f))
                              for r, _, fs in os.walk(d) for f in fs)
    say(f"recipe {arch(cfg)}: calibrate CLI path (restore, calibrate on the "
        f"card, write the artifact under build/) {t_cal:.1f} s, "
        f"{t_cal / qstats['n_matrices']:.3f} s a matrix, "
        f"{qstats['n_matrices']} matrices, {qstats['nnz']} int8 codes, "
        f"max |W - Wq| {qstats['max_abs_err']:.4e}; checkpoint "
        f"{dir_bytes(ckpt_dir) / 2**30:.2f} GiB, artifact "
        f"{dir_bytes(art) / 2**30:.2f} GiB")
    sp_cfg = quant_recipe.with_exec_mode(cfg, "sparse")
    params, consts = serve_launcher.load_model(sp_cfg, device=device,
                                               ckpt_dir=ckpt_dir)
    t0 = time.perf_counter()
    qparams, qconsts = serve_launcher.load_model(
        quant_recipe.with_exec_mode(cfg, "quant"), device=device,
        quant_ckpt=art)
    torch.cuda.synchronize()
    say(f"recipe {arch(cfg)}: the artifact read back by the serve "
        f"launcher's --quant-ckpt path in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rows = quant_recipe.quant_rows(sp_cfg, params, consts, qparams, qconsts,
                                   qstats, device=device, train_steps=steps)
    torch.cuda.synchronize()
    launches = launch_counts()
    recipe_line(arch(cfg), rows, f"rows in {time.perf_counter() - t0:.1f} "
                f"s, launches over the whole recipe {launches}")
    missing = [k for k in PATH_KERNELS[f"recipe_{name}"] if not launches[k]]
    if missing:
        fail(f"recipe {name} never launched {missing}: {launches}")
    shutil.rmtree(art, ignore_errors=True)
    return launches, ckpt_dir, qparams, qconsts


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


def check_train_coverage(shapes, m, cfg, kernels=("sl_matmul", "sddmm")):
    """Every (M, K, N) the trainer gave ``kernels`` was checked in the
    kernel phases (the forward and dx calls and sddmm at the three
    projection shapes)."""
    # the forward calls at each projection shape, the dx calls at its
    # transpose
    checked = {(m, a, b) for a, b in proj_shapes(cfg)} | \
        {(m, b, a) for a, b in proj_shapes(cfg)}
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


def kernels_line(rows, by_path, representative, rows_7b, representative_7b,
                 rows_g, representative_g, rows_m, representative_m,
                 rows_h, representative_h, rows_d, representative_d,
                 rows_s, representative_s):
    """One entry per kernel: the llama_1b representative case's times and
    bound (and, under ``at_llama_7b`` and ``at_gemma2_2b``, the llama_7b
    and the gemma2_2b one's), the largest error over all of the kernel's
    cases at every config; launches summed over the main paths' runs
    (serving fused, sparse and quant on the paged and the contiguous
    cache; training fused, sparse and per-layer; the chaos drills; the
    quant recipe at llama_1b and at its default size; the quant fallback;
    llama_7b's per-layer training and fused and sparse serving; gemma2_2b's
    serving, long request and training, paligemma_3b's; deepseek_moe_16b's
    serving and training; the llama_7b quant path; gemma2_2b's quant
    serving), each path's count beside them. ``sl_matmul``'s, ``sddmm``'s,
    ``sparse_matmul``'s and ``quant_sparse_matmul``'s launches count their
    grouped launches over an expert stack too (one launch a stage of all
    experts), by path under ``grouped_launches_by_path``;
    ``at_deepseek_moe_16b`` holds their grouped representative case (with
    the loop of single launches' time),
    ``at_qwen3_moe_235b`` the paged kernels' at qwen3's GQA group 16;
    ``at_ssm_families`` the linears' kernels' timed cases at zamba2_7b's,
    xlstm_350m's and whisper_large_v3's shapes (phase h1, whose untimed
    cases count in ``max_abs_err`` and ``cases``); ``at_dist`` the dist
    phase's local-shape case (llama_7b's d_ff projection on a rank of a
    TP-2 mesh; adam8bit on an fsdp shard), whose launches are the dist
    runs' (paths "dist ..."); ``at_serve_mesh`` the serve-mesh phase's
    local-shape case (llama_7b's q/k/v/o decode on a rank's column tiles
    of a TP-4 mesh; the paged kernels on its 8 heads), whose launches are
    the serve-mesh runs' (paths "serve mesh ...")."""
    out = []
    src = {"sl_matmul": SL_SOURCE, "paged_attention": PA_SOURCE,
           "paged_prefill": PA_SOURCE, "sddmm": SD_SOURCE,
           "adam8bit": AD_SOURCE, "sparse_matmul": SP_SOURCE,
           "quant_sparse_matmul": SP_SOURCE}
    times = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    grouped_of = {k: f"{k}_grouped" for k in
                  ("sl_matmul", "sddmm", "sparse_matmul",
                   "quant_sparse_matmul")}
    for name, shape in representative.items():
        g_name = grouped_of.get(name)
        n_grouped = {p: n.get(g_name, 0) for p, n in by_path.items()
                     if g_name and n.get(g_name, 0)}
        mine = [r for r in rows if r["name"] == name]
        rep = next(r for r in mine if r["shape"] == shape)
        mine7 = [r for r in rows_7b if r["name"] == name]
        rep7 = next(r for r in mine7 if r["shape"] == representative_7b[name])
        mine_g = [r for r in rows_g if r["name"] == name]
        rep_g = next(r for r in mine_g
                     if r["shape"] == representative_g[name])
        out.append({
            "name": name, "route": "cuda", "source": src[name],
            "replaces": REPLACES[name],
            "launches": sum(n[name] for n in by_path.values())
            + sum(n_grouped.values()),
            "launches_by_path": {p: n[name] for p, n in by_path.items()},
            "max_abs_err": max(r["max_abs_err"] for r in mine + mine7 + mine_g
                               + [r for r in rows_m + rows_h + rows_d + rows_s
                                  if r["name"] == name]),
            **{k: rep[k] for k in times}, "shape": shape,
            "cases": len(mine),
            **{k: rep[k] for k in ("variant", "pad_ms", "library_f32_ms")
               if k in rep},
            "at_llama_7b": {"shape": rep7["shape"], "cases": len(mine7),
                            **{k: rep7[k] for k in times}},
            "at_gemma2_2b": {"shape": rep_g["shape"], "cases": len(mine_g),
                             **{k: rep_g[k] for k in times}}})
        if name in representative_m:
            mine_m = [r for r in rows_m if r["name"] == name]
            rep_m = next(r for r in mine_m
                         if r["shape"] == representative_m[name])
            key = "at_deepseek_moe_16b" if g_name else "at_qwen3_moe_235b"
            out[-1][key] = {"shape": rep_m["shape"], "cases": len(mine_m),
                            **{k: rep_m[k] for k in times}}
            if g_name:
                out[-1][key].update(
                    loop_ms=rep_m["loop_ms"], experts=rep_m["experts"],
                    grouped_launches=sum(n_grouped.values()))
                out[-1]["grouped_launches_by_path"] = n_grouped
        if name in representative_d:
            mine_d = [r for r in rows_d if r["name"] == name]
            rep_d = next(r for r in mine_d
                         if r["shape"] == representative_d[name])
            out[-1]["at_dist"] = {"shape": rep_d["shape"],
                                  "cases": len(mine_d),
                                  **{k: rep_d[k] for k in times}}
        if name in representative_s:
            mine_s = [r for r in rows_s if r["name"] == name]
            rep_s = next(r for r in mine_s
                         if r["shape"] == representative_s[name])
            out[-1]["at_serve_mesh"] = {"shape": rep_s["shape"],
                                        "cases": len(mine_s),
                                        **{k: rep_s[k] for k in times}}
        if name in representative_h:
            mine_h = [r for r in rows_h if r["name"] == name]
            out[-1]["at_ssm_families"] = {"cases": len(mine_h), **{
                a: {"shape": sh, **{k: rep_h[k] for k in times}}
                for a, sh in representative_h[name].items()
                for rep_h in [next(r for r in mine_h if r["shape"] == sh)]}}
    return {"kernels": out}


# ---------------------------------------------------------------------------
# chaos drills and the profiler hook (llama_60m)
# ---------------------------------------------------------------------------

# the chaos drills' training: llama_60m at full width, bf16, exec_mode
# fused, the reference trainer's batch, as the launcher runs it
CHAOS_ARGV = ["--arch", "llama_60m", "--exec-mode", "fused", "--steps", "6",
              "--batch", "8", "--seq", "256", "--log-every", "100",
              "--device", "cuda"]
# the train launcher as a program (what ``python -m`` runs), in a fresh
# process with deterministic algorithms on, so its steps give the bits an
# uninterrupted run in this process gives (the embedding's backward
# accumulates by index, which is not deterministic on CUDA otherwise)
LAUNCHER = ("import runpy, torch; torch.use_deterministic_algorithms(True); "
            "runpy.run_module('repro_torch.launch.train', "
            "run_name='__main__', alter_sys=True)")
# the serve-side stall drills: a stall far longer than the deadline, so
# the stalled request must time out and release its slot (and pages)
STALL_SPEC, STALL_DEADLINE = "stall@6:100000", 400
# the reference's fault matrix (tests/test_fault_tolerance.py)
FAULT_MATRIX = ("kill@3,data_corrupt@2,straggler@2:30,ckpt_corrupt@4,"
                "nonfinite@4")


def chaos_cfg():
    from repro_torch.configs import llama_60m
    return dataclasses.replace(llama_60m.CONFIG, param=dataclasses.replace(
        llama_60m.CONFIG.param, exec_mode="fused"))


def same_checkpoints(what, a_dir, b_dir, step):
    """Every array of step ``step``'s checkpoint in ``a_dir`` and
    ``b_dir`` (params and optimizer state, 8-bit codes included) equal bit
    for bit; returns the array count."""
    load = lambda d: np.load(os.path.join(d, f"step_{step:08d}",
                                          "arrays.npz"))
    a, b = load(a_dir), load(b_dir)
    if sorted(a.files) != sorted(b.files):
        fail(f"{what}: checkpoints hold other arrays")
    differ = [k for k in a.files if a[k].dtype != b[k].dtype
              or a[k].tobytes() != b[k].tobytes()]
    if differ:
        fail(f"{what}: {len(differ)} of {len(a.files)} checkpoint arrays "
             f"differ from the uninterrupted run's, e.g. {differ[:3]}")
    return len(a.files)


def check_relaunch(what, ref_hist, hist, first_steps):
    """The relaunch began at one of ``first_steps`` and each of its losses
    equals the uninterrupted run's at that step, bit for bit."""
    first = hist[0]["step"]
    if first not in first_steps:
        fail(f"{what}: the relaunch began at step {first}")
    losses = {h["step"]: h["loss"] for h in ref_hist}
    if any(h["loss"] != losses[h["step"]] for h in hist):
        fail(f"{what}: relaunch losses {[h['loss'] for h in hist]} vs "
             f"uninterrupted {losses}")
    return first


def phase_chaos_kill_launcher(device, root):
    """``python -m repro_torch.launch.train --chaos kill@4`` on llama_60m
    (bf16, fused, global AdamW) in its own process must exit 43; its
    relaunch (the launcher again, in this process) must end bit-identical
    to an uninterrupted launcher run: the relaunch's losses and every
    param and optimizer-state array of the step-6 checkpoint. All three
    runs under deterministic algorithms. The killed run checkpoints every
    2 steps in the background: its process may die with step 4's write in
    flight, so the relaunch resumes from step 2 or 4. Returns the launch
    counts of the two runs in this process."""
    from repro_torch.launch import train as train_launcher
    a, b = (os.path.join(root, f"launcher_{x}") for x in "ab")
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    # the killed run's process starts first and runs beside the
    # uninterrupted one: they share no directory
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    killed = subprocess.Popen(
        [sys.executable, "-c", LAUNCHER, *CHAOS_ARGV, "--ckpt-dir", b,
         "--ckpt-every", "2", "--chaos", "kill@4"], cwd=ROOT, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            ref = train_launcher.main(CHAOS_ARGV + ["--ckpt-dir", a,
                                                    "--ckpt-every", "3"])
        _, err = killed.communicate(timeout=600)
        if killed.returncode != 43:
            fail(f"launch.train --chaos kill@4 exited {killed.returncode}, "
                 f"not 43: {err[-2000:]}")
        with contextlib.redirect_stdout(io.StringIO()):
            got = train_launcher.main(CHAOS_ARGV + ["--ckpt-dir", b,
                                                    "--ckpt-every", "2"])
        launches = launch_counts()
    finally:
        torch.use_deterministic_algorithms(False)
        if killed.poll() is None:
            killed.kill()
            killed.wait()
    what = "chaos kill@4 (launcher, adamw, global)"
    first = check_relaunch(what, ref.metrics_history, got.metrics_history,
                           (3, 5))
    n = same_checkpoints(what, a, b, 6)
    say(f"chaos kill@4 llama_60m (bf16, fused, adamw, global, "
        f"deterministic algorithms): launch.train --chaos kill@4 in its own "
        f"process exited 43; the launcher's relaunch resumed at step "
        f"{first}, its losses and all {n} arrays of its step-6 checkpoint "
        f"bit-identical to an uninterrupted launcher run "
        f"({time.perf_counter() - t0:.1f} s for the three runs)")
    return launches


def phase_chaos_kill_trainer(device, root, optimizer, update_mode):
    """``Trainer(chaos=kill@4)`` on llama_60m (bf16, fused, deterministic
    algorithms), checkpointing every 3 steps, must raise SystemExit(43)
    and count the kill; the relaunch resumes from step 3 and ends
    bit-identical to an uninterrupted run (losses, and every param and
    optimizer-state array of the step-6 checkpoint, 8-bit codes
    included). Returns the launch counts of the three runs."""
    from repro_torch.resilience import ChaosEngine
    from repro_torch.train.trainer import Trainer
    name = f"{optimizer}_{update_mode}"
    a, b = (os.path.join(root, f"{name}_{x}") for x in "ab")
    mk = lambda d: train_config(chaos_cfg(), steps=6, batch=8, seq=256,
                                ckpt_dir=d, ckpt_every=3, optimizer=optimizer,
                                update_mode=update_mode)
    quiet = dict(device=device, log_fn=lambda *x: None)
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        reset_launch_counts()
        ref = Trainer(mk(a), **quiet)
        ref.run()
        killed = Trainer(mk(b), chaos=ChaosEngine.parse("kill@4"), **quiet)
        try:
            killed.run()
            fail(f"chaos kill@4 {name}: the kill never fired")
        except SystemExit as e:
            if e.code != 43:
                fail(f"chaos kill@4 {name}: exit code {e.code}, not 43")
        got = Trainer(mk(b), **quiet)
        got.run()
        launches = launch_counts()
    finally:
        torch.use_deterministic_algorithms(False)
    if killed.obs.snapshot()["resilience.faults_injected{kind=kill}"][
            "value"] != 1:
        fail(f"chaos kill@4 {name}: the kill was not counted")
    what = f"chaos kill@4 ({name})"
    check_relaunch(what, ref.metrics_history, got.metrics_history, (4,))
    n = same_checkpoints(what, a, b, 6)
    say(f"chaos kill@4 llama_60m (bf16, fused, {optimizer}, {update_mode}, "
        f"deterministic algorithms): Trainer(chaos=kill@4) raised "
        f"SystemExit(43), counted; the relaunch resumed at step 4, its "
        f"losses and all {n} arrays of its step-6 checkpoint (8-bit codes "
        f"and scales included) bit-identical to the uninterrupted run "
        f"({time.perf_counter() - t0:.1f} s for the three runs)")
    return launches


def phase_fault_matrix(device, root):
    """The reference's fault matrix on llama_60m (bf16, fused): kill@3,
    then a relaunch with the same chaos engine and registry, where
    ckpt_corrupt@4 damages the newest checkpoint right before nonfinite@4
    forces a rollback past it; data_corrupt and straggler fire on the way.
    Every kind must be counted once and recovered from (the run ends at
    step 6 with a finite loss, a rollback, a skipped step and a dropped
    batch). Then ``ckpt_corrupt@5,kill@5``: the relaunch must warn and
    resume from step 2, the newest intact checkpoint."""
    import warnings
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.resilience import ChaosEngine
    from repro_torch.train.trainer import Trainer
    t0 = time.perf_counter()
    d = os.path.join(root, "matrix")
    # synchronous writes, and the reference's default of 3 kept: a
    # corrupted newest checkpoint leaves older intact ones to fall back to
    tc = dataclasses.replace(train_config(
        chaos_cfg(), steps=6, batch=8, seq=256, ckpt_dir=d, ckpt_every=2),
        keep_ckpts=3)
    reg = obs_metrics.Registry()
    engine = ChaosEngine.parse(FAULT_MATRIX, seed=0)
    kw = dict(device=device, log_fn=lambda *x: None, chaos=engine,
              max_skips=1, obs=reg)
    try:
        Trainer(tc, **kw).run()
        fail("fault matrix: kill@3 never fired")
    except SystemExit as e:
        if e.code != 43:
            fail(f"fault matrix: kill@3 exited {e.code}")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tr = Trainer(tc, **kw)
        state = tr.run()
    snap = {k: v["value"] for k, v in reg.snapshot().items()
            if k.startswith("resilience.")}
    kinds = ("kill", "data_corrupt", "straggler", "ckpt_corrupt",
             "nonfinite")
    injected = {k: snap.get(f"resilience.faults_injected{{kind={k}}}", 0)
                for k in kinds}
    if state.step != 6 or not np.isfinite(tr.metrics_history[-1]["loss"]) \
            or any(v != 1 for v in injected.values()) \
            or snap.get("resilience.rollbacks", 0) < 1 \
            or snap.get("resilience.nonfinite_steps", 0) < 1 \
            or snap.get("resilience.bad_batches", 0) < 1 \
            or not any("corrupt" in str(w.message) for w in caught):
        fail(f"fault matrix: step {state.step}, counters {snap}, warnings "
             f"{[str(w.message)[:80] for w in caught]}")
    # a corrupted newest checkpoint at a relaunch
    d2 = os.path.join(root, "corrupt")
    tc2 = dataclasses.replace(tc, ckpt_dir=d2)
    killed = Trainer(tc2, device=device, log_fn=lambda *x: None,
                     chaos=ChaosEngine.parse("ckpt_corrupt@5,kill@5"))
    try:
        killed.run()
        fail("ckpt_corrupt@5,kill@5: the kill never fired")
    except SystemExit:
        pass
    logs = []
    with warnings.catch_warnings(record=True) as caught2:
        warnings.simplefilter("always")
        relaunch = Trainer(tc2, device=device, log_fn=logs.append)
        state2 = relaunch.run()
    if killed.obs.snapshot()["resilience.faults_injected{kind=ckpt_corrupt}"][
            "value"] != 1 or state2.step != 6 or \
            not any("resumed from step 2" in line for line in logs) or \
            not any("corrupt" in str(w.message) for w in caught2):
        fail(f"ckpt_corrupt relaunch: step {state2.step}, logs {logs}")
    say(f"chaos fault matrix llama_60m (bf16, fused) '{FAULT_MATRIX}' over "
        f"a kill and a relaunch: faults_injected {injected}, rollbacks "
        f"{snap['resilience.rollbacks']:.0f}, non-finite steps skipped "
        f"{snap['resilience.nonfinite_steps']:.0f}, bad batches dropped "
        f"{snap['resilience.bad_batches']:.0f}, finished step 6 with loss "
        f"{tr.metrics_history[-1]['loss']:.4f}; ckpt_corrupt@5 then kill@5: "
        f"the relaunch warned and resumed from step 2 (newest intact) | "
        f"{time.perf_counter() - t0:.1f} s")


def phase_stall(device, *, paged):
    """``stall@T:K`` with K far past the deadline, through the engine's
    tick hook, on llama_60m (bf16, fused; the paged engine with the paged
    kernels and prefix sharing via ``run_stream``, or the contiguous one
    draining its queue): every request ends done or timed out, at least
    the stalled one times out, nothing is left queued, resident or
    stalled, and (paged) no KV block stays in use; the paged run's
    completed requests give an unstalled run's tokens. Returns the launch
    counts of the stalled run."""
    from repro_torch.models import lm
    from repro_torch.resilience import ChaosEngine
    from repro_torch.serve.engine import ServeEngine
    cfg = chaos_cfg()
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params, consts = lm.init_lm(cfg, seed=0, device=device)
    randomize_b(params, gen)
    prompts, arrivals = traffic(cfg.vocab_size)
    kw = dict(n_slots=4, max_len=128, device=device,
              deadline_ticks=STALL_DEADLINE)
    if paged:
        kw.update(paged=True, block_len=16, attn_kernel="paged",
                  prefix_sharing=True)

    def run(spec):
        chaos = ChaosEngine.parse(spec, seed=0) if spec else None
        eng = ServeEngine(cfg, params, consts, **kw,
                          tick_hook=chaos.serve_hook if chaos else None)
        if chaos:
            chaos.bind(eng.obs)
        if paged:
            reqs = [eng.submit(p, max_new_tokens=16, arrival=a)
                    for p, a in zip(prompts, arrivals)]
            stats = eng.run_stream()
        else:
            reqs = [eng.submit(p, max_new_tokens=16) for p in prompts]
            stats = eng.run_until_drained()
        torch.cuda.synchronize()
        return eng, reqs, stats

    t0 = time.perf_counter()
    reset_launch_counts()
    eng, reqs, stats = run(STALL_SPEC)
    launches = launch_counts()
    wall = time.perf_counter() - t0
    statuses = [r.status for r in reqs]
    snap = eng.obs.snapshot()
    what = "paged" if paged else "contiguous"
    if stats["exhausted"] or not set(statuses) <= {"done", "timed_out"} \
            or "timed_out" not in statuses or eng._has_work() \
            or eng._stall_until \
            or snap["resilience.faults_injected{kind=stall}"]["value"] != 1 \
            or (paged and eng.sched.blocks.blocks_in_use):
        fail(f"stall drill ({what}): statuses {statuses}, exhausted "
             f"{stats['exhausted']}, stalls {eng._stall_until}, snapshot "
             f"{ {k: v for k, v in snap.items() if 'serve.' in k} }")
    extra = ""
    if paged:
        _, plain, _ = run(None)
        differ = [r.uid for r, p in zip(reqs, plain)
                  if r.status == "done" and r.out != p.out]
        if differ:
            fail(f"stall drill (paged): requests {differ} gave other tokens "
                 "than the unstalled run")
        extra = (f"; the {statuses.count('done')} done requests' tokens "
                 "equal an unstalled run's; blocks in use 0")
    say(f"stall drill llama_60m (bf16, fused, {what} engine) {STALL_SPEC} "
        f"with deadline_ticks {STALL_DEADLINE}: statuses "
        f"{dict((s, statuses.count(s)) for s in sorted(set(statuses)))}, "
        f"deadline_exceeded {snap['serve.deadline_exceeded']['value']:.0f}, "
        f"{eng.clock} ticks, nothing queued, resident or stalled{extra} | "
        f"launches {launches} | {wall:.1f} s")
    return launches


def profile_kernel_names(path):
    """{kernel name: events} of the device kernels in a Chrome trace that
    ``torch.profiler`` exported (demangled signatures, such as "void
    (anonymous namespace)::sl_reduce_kernel<__nv_bfloat16>(...)", named
    by their first identifier ending in "kernel")."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if e.get("cat") == "kernel":
            found = re.findall(r"(\w+kernel)\b", e.get("name", ""))
            name = found[0] if found else e.get("name", "")
            out[name] = out.get(name, 0) + 1
    return out


def source_kernels(src):
    """The kernel names of a CUDA source of the repo."""
    with open(os.path.join(ROOT, src)) as f:
        text = f.read()
    return set(re.findall(r"\b(\w+kernel)\s*\(", text))


def phase_profiler(root):
    """The launchers' ``--jax-profile-dir`` on the card: a contiguous
    fused serve run of llama_60m (2 requests, 4 new tokens each) and 2
    fused training steps write Chrome traces; the serve trace must name
    an sl_matmul device kernel, the train trace sl_matmul's and
    sddmm's."""
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch import train as train_launcher
    t0 = time.perf_counter()
    quiet = io.StringIO()
    with contextlib.redirect_stdout(quiet):
        eng, reqs = serve_launcher.main([
            "--arch", "llama_60m", "--exec-mode", "fused", "--requests",
            "2", "--new-tokens", "4", "--jax-profile-dir",
            os.path.join(root, "serve")])
        tr = train_launcher.main([
            "--arch", "llama_60m", "--exec-mode", "fused", "--steps", "2",
            "--ckpt-dir", os.path.join(root, "ckpt"), "--jax-profile-dir",
            os.path.join(root, "train")])
    sl_names = source_kernels(SL_SOURCE)
    lines = []
    for what, path, want in (
            ("serve", eng.trace.profile_path, ("sl_matmul",)),
            ("train", tr.trace.profile_path, ("sl_matmul", "sddmm"))):
        names = profile_kernel_names(path)
        seen = {"sl_matmul": {n: c for n, c in names.items()
                              if n in sl_names},
                "sddmm": {n: c for n, c in names.items()
                          if n in source_kernels(SD_SOURCE)}}
        missing = [k for k in want if not seen[k]]
        if missing:
            fail(f"profiler ({what}): the trace {path} names no {missing} "
                 f"device kernel; kernels: {sorted(names)[:20]}")
        lines.append(f"{what} {os.path.getsize(path) / 2**20:.1f} MiB, "
                     f"{sum(names.values())} device kernel events, "
                     + ", ".join(f"{k} {seen[k]}" for k in want))
    if eng.cfg.param.exec_mode != "fused" or eng.paged or \
            any(r.status != "done" for r in reqs):
        fail("profiler: the serve launcher did not run the contiguous "
             "fused engine to the end")
    say("profiler (--jax-profile-dir, torch.profiler CPU + CUDA): "
        + " | ".join(lines) + f" | {time.perf_counter() - t0:.1f} s")


def phase_chaos(device):
    """The chaos drills and the profiler hook on llama_60m; returns the
    launch counts by path."""
    root = os.path.join(ROOT, "build", "chip_smoke_chaos")
    shutil.rmtree(root, ignore_errors=True)
    by_path = {
        "chaos_train_llama_60m": phase_chaos_kill_launcher(device, root),
        "chaos_train_per_layer_llama_60m": phase_chaos_kill_trainer(
            device, root, "adam8bit", "per_layer")}
    phase_fault_matrix(device, root)
    by_path["stall_paged_llama_60m"] = phase_stall(device, paged=True)
    by_path["stall_contiguous_llama_60m"] = phase_stall(device, paged=False)
    phase_profiler(root)
    shutil.rmtree(root, ignore_errors=True)
    for path, launches in by_path.items():
        missing = [k for k in PATH_KERNELS[path] if not launches[k]]
        if missing:
            fail(f"{path} never launched {missing}: {launches}")
    return by_path


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
    """Phase 7e: llama_7b at full width, on ``cfg``'s layers, served in
    bf16 from one pooled init (B ~ U(-1, 1), fused tile consts, which the sparse path
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


def phase_quant_7b(cfg, device, smi, *, batch, seq, n_slots, block_len,
                   max_len):
    """Phase 7f: quant at llama_7b's full width on QUANT_7B_LAYERS of its
    32 layers: the recipe's train -> checkpoint -> calibrate -> artifact
    -> serve path (``phase_recipe``: QUANT_7B_STEPS bf16 fused Trainer
    steps, the checkpoint under build/, the calibrate CLI's path on the
    card timed per matrix, the artifact written and read back by the
    serve launcher's ``--quant-ckpt`` path, the sparse and quant engines,
    the recipe's rows, greedy match or mean |dlogit| against the sparse
    engine and the modeled decode bytes, and the reference's gates); then
    the loaded artifact in f32: the quant engine's tokens against a dense
    engine with gathered attention on the dequantized weights
    (``quant_engine_f32``). Returns the recipe's launch counts."""
    from repro_torch.models.common import tree_map
    cfg16 = dataclasses.replace(cfg, n_layers=QUANT_7B_LAYERS,
                                param=dataclasses.replace(
                                    cfg.param, exec_mode="fused"))
    launches, ckpt_dir, qparams, qconsts = phase_recipe(
        cfg16, device, smi, batch=batch, seq=seq, steps=QUANT_7B_STEPS)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg32 = dataclasses.replace(cfg16, dtype="float32")
    qparams = tree_map(lambda t: t.float() if t.is_floating_point() else t,
                       qparams)
    prompts, arrivals = traffic(cfg.vocab_size)
    quant_engine_f32(cfg32, qparams, qconsts, prompts, arrivals, device,
                     n_slots=n_slots, max_len=max_len, block_len=block_len,
                     new_tokens=16)
    del qparams, qconsts
    torch.cuda.empty_cache()
    return launches


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
    by_path.update(phase_serving_7b(
        dataclasses.replace(cfg, n_layers=SERVE_7B_LAYERS), device,
        n_slots=n_slots, block_len=block_len, max_len=max_len,
        buckets=buckets, m_values=m_values))
    say(f"phase 7e ({arch(cfg)} serving): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    by_path["recipe_llama_7b"] = phase_quant_7b(
        cfg, device, smi, batch=batch, seq=seq, n_slots=n_slots,
        block_len=block_len, max_len=max_len)
    say(f"phase 7f ({arch(cfg)} quant, {QUANT_7B_LAYERS} layers): "
        f"{time.perf_counter() - t0:.1f} s")
    return rows, by_path


# ---------------------------------------------------------------------------
# phases g1 to g4: the gemma2 family, paligemma_3b and qwen2.5's kernel rows
# ---------------------------------------------------------------------------

# gemma2_2b's f32 parity and quant (phase g2) on this many of its 26
# layers (one local/global period; two before a slower host took the
# script past its limit) and paligemma_3b (phase g4) on this many of its 18
GEMMA_PARITY_LAYERS = 2
PALI_LAYERS = 2
# gemma2_2b in bf16 (phase g3: serving, the long request, training) on
# this many of its 26 layers (two local/global periods; four before the
# script outgrew its limit, full depth before the quant phases)
GEMMA_BF16_LAYERS = 4
# phase g3's long request: a prompt past gemma2's 4096-key window, then
# new tokens, on one slot whose table spans LONG_MAX_LEN keys
LONG_PROMPT, LONG_NEW, LONG_MAX_LEN = 4300, 16, 4320
# the long request's logits at each step, paged kernels against the
# gathered read on the same engine (bf16 at full depth; the final softcap
# bounds them at ±30): the two reads round the attention's f32 sums in
# another order before one bf16 rounding, and 26 layers carry that on
# (0.078 at worst on an H100). A gathered read that drops the local
# layers' window strays ~0.59 or more at every step there: the phase
# checks at each run that this faulty read passes the limit at each step
LONG_LOGIT_TOL = 0.25
# paligemma's vlm batch: the trainer's batch with seeded patch embeddings
PALI_BATCH, PALI_SEQ = 4, 512
PATH_KERNELS.update({
    "serve_gemma2_2b": PATH_KERNELS["serve"],
    "serve_sparse_gemma2_2b": PATH_KERNELS["serve_sparse"],
    "serve_quant_gemma2_2b": PATH_KERNELS["serve_quant"],
    "serve_long_gemma2_2b": PATH_KERNELS["serve"],
    "train_gemma2_2b": PATH_KERNELS["train"],
    "train_per_layer_gemma2_2b": PATH_KERNELS["train_per_layer"],
    # paligemma_3b at PALI_LAYERS: one bf16 train step, a bf16 engine run
    "train_paligemma_3b": PATH_KERNELS["train"],
    "serve_paligemma_3b": PATH_KERNELS["serve"],
})


def attn_label(cfg, extra=""):
    """A head_dim-256 attention case's label: its arch and shape."""
    group = cfg.n_heads // cfg.n_kv_heads
    return (f"{cfg.name.split('-')[0]} {cfg.n_kv_heads} kv heads, group "
            f"{group}, hd {cfg.resolved_head_dim}{extra}")


def check_attention_wide(timer, gen, device, cfg, n_slots, block_len, bps,
                         sqs, long_context):
    """The bf16 paged kernels at a head_dim-256 family's shapes, each
    against its plain version (and its rerun, bit for bit), timed beside
    SDPA on the gathered view without the softcap (no library call
    computes it): the decode at the engine's shapes, the prefill on the
    tensor cores (prefill_tc_wide_kernel) at each suffix bucket in
    ``sqs``, with the config's softcap and, for a local layer, its window;
    with ``long_context`` the decode at LONG_MAX_LEN keys (positions past
    the window) for a local and a global layer."""
    hd = cfg.resolved_head_dim
    n_kv, group = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    win = cfg.sliding_window if "local" in cfg.attn_pattern else 0
    kw = dict(scale=(cfg.query_pre_attn_scalar or hd) ** -0.5,
              softcap=cfg.attn_logit_softcap, window=win)
    cap = f", softcap {kw['softcap']:g}" if kw["softcap"] else ""
    tags = cap + (f", window {win}" if win else "")
    rows = []
    positions = [min(bps * block_len - 1, 40 + 9 * s) for s in
                 range(n_slots - 1)] + [-1]          # last slot idle
    offsets = [16 * (s % 2) for s in range(n_slots - 1)] + [0]
    dtype = torch.bfloat16
    kp, vp, tbl, pos = attn_case(
        gen, device, dtype, n_slots=n_slots, n_kv=n_kv, group=group, hd=hd,
        block_len=block_len, bps=bps, positions=positions)
    q = torch.randn((n_slots, n_kv, group, hd), generator=gen,
                    device=device).to(dtype)
    rows.append(decode_row(timer, attn_label(cfg, tags), q, kp, vp, tbl,
                           pos, kw))
    for sq in sqs:
        rows.append(check_prefill(timer, gen, device, dtype,
                                  attn_label(cfg, tags), n_kv, group, hd,
                                  block_len, bps, sq, offsets, positions,
                                  kw))
    if long_context:
        # two slots past the window, one at its edge, a short one (some
        # splits of its table hold no live key)
        long_pos = (LONG_MAX_LEN - 1, LONG_PROMPT - 1, cfg.sliding_window,
                    20)
        lbps = LONG_MAX_LEN // block_len
        kp, vp, tbl, pos = attn_case(
            gen, device, dtype, n_slots=len(long_pos), n_kv=n_kv,
            group=group, hd=hd, block_len=block_len, bps=lbps,
            positions=long_pos)
        q = torch.randn((len(long_pos), n_kv, group, hd), generator=gen,
                        device=device).to(dtype)
        for w in ([win, 0] if win else [0]):
            layer = f", window {w}, local" if w else ", global"
            rows.append(decode_row(
                timer, attn_label(cfg, f"{cap}{layer}, {LONG_MAX_LEN}-key "
                                  "context"),
                q, kp, vp, tbl, pos, dict(kw, window=w)))
        del kp, vp
    return rows


def check_kernels_families(device, cfgs, m_values, n_slots, block_len, bps,
                           buckets, m_train):
    """Phase g1: every kernel at the new shapes in bf16, the model's type,
    with the checks of the llama_1b phases (plain version, rerun bit for
    bit, plans, timings beside the plain version, the bound and one
    library call): ``sl_matmul`` at gemma2_2b's five projection shapes
    (ranks 576 and 512) at every engine row count and at M = ``m_train``
    with its dx, ``sddmm`` there too, ``sparse_matmul`` and
    ``quant_sparse_matmul`` at every engine row count, ``adam8bit`` at
    every segment gemma2's per-layer step updates (the 590 M-element tied
    embedding with its f32 gradient included) and over one period's
    slices; the paged kernels at head_dim 256 (gemma2: 4 kv heads, group
    2, softcap 50, window 4096, and a 4320-key context; paligemma: MQA,
    group 8); ``sl_matmul`` at paligemma's and qwen2.5's widest decode
    shapes (kernel rows only). Own generators, so no earlier phase's
    draws move."""
    g2, pali, qwen = cfgs
    timer = Timer(device)
    gens = []
    for seed in (40, 41, 42, 43, 44):
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        gens.append(g)
    bf16 = (torch.bfloat16,)
    rows = check_sl_matmul(timer, gens[0], device, g2, m_values, bf16)
    rows += check_attention_wide(timer, gens[1], device, g2, n_slots,
                                 block_len, bps, buckets, True)
    rows += check_attention_wide(timer, gens[1], device, pali, n_slots,
                                 block_len, bps, buckets, False)
    rows += check_sparse_decode(timer, gens[2], device, g2, m_values, bf16)
    rows += check_train_kernels(timer, gens[0], device, g2, m_train, bf16)
    rows += check_adam8bit(timer, gens[4], device, dataclasses.replace(
        g2, n_layers=GEMMA_BF16_LAYERS), dtypes=bf16)
    torch.cuda.empty_cache()
    for cfg, shapes in ((pali, [(pali.d_model, pali.d_ff),
                                (pali.d_model, pali.n_kv_heads
                                 * pali.resolved_head_dim)]),
                        (qwen, [(qwen.d_model, qwen.d_ff)])):
        for d_in, d_out in shapes:
            pc = cfg.param
            args = sl_case(gens[3], device, d_in, d_out, n_slots,
                           torch.bfloat16, pc.rank, pc.delta, pc.alpha,
                           seed=d_in * 7 + d_out)
            rows.append(time_sl_matmul(
                timer, f"{n_slots}x{d_in}->{d_out} bfloat16 "
                f"({cfg.name.split('-')[0]})", args, torch.bfloat16))
            del args
    del timer
    torch.cuda.empty_cache()
    return rows


def phase_parity_gemma2(cfg, device, *, batch, seq, n_slots, block_len,
                        max_len, buckets, m_values):
    """Phase g2: gemma2_2b at full width on GEMMA_PARITY_LAYERS layers
    (one local/global period) in f32: 3 train steps in exec_mode fused
    against dense (the loss and gradient-norm gaps, TRAIN_TOL_*); the
    plain forward, fused and sparse against dense; and the 8-request
    traffic on the paged engine, fused + paged kernels and sparse + paged
    kernels each giving dense + gathered attention's tokens, request by
    request (ties in the dense logits excepted). Then quant: the model
    calibrated on the card, served in exec_mode quant against dense +
    gathered attention on the dequantized weights (``quant_engine_f32``),
    and its calibration cast to bf16 served in exec_mode quant on the
    paged engine, timed under the device-only profiler, one
    ``quant_sparse_matmul`` launch a linear a dispatch (asserted). Returns
    the bf16 quant run's launch counts by path."""
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    gen = torch.Generator(device=device)
    gen.manual_seed(50)
    cfg32 = dataclasses.replace(cfg, n_layers=GEMMA_PARITY_LAYERS,
                                dtype="float32", param=dataclasses.replace(
                                    cfg.param, exec_mode="fused"))
    phase_train_parity(cfg32, device, gen, batch=batch, seq=seq,
                       names=("fused", "dense"))
    torch.cuda.empty_cache()
    params, consts = lm.init_lm(cfg32, seed=0, device=device)
    randomize_b(params, gen)
    check_forward(cfg32, params, consts, device)
    prompts, arrivals = traffic(cfg.vocab_size)
    kw = dict(n_slots=n_slots, max_len=max_len, block_len=block_len,
              new_tokens=16)
    _, b_reqs = phase_engine_f32(cfg32, params, consts, prompts, arrivals,
                                 device, **kw)
    phase_sparse_f32(cfg32, params, consts, prompts, arrivals, b_reqs,
                     device, **kw)
    qparams, qconsts = calibrate_on_card(cfg32, params, consts, device,
                                         artifact=False)
    del params, consts
    quant_engine_f32(cfg32, qparams, qconsts, prompts, arrivals, device,
                     **kw)
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    qparams = tree_map(lambda t: t.to(torch.bfloat16)
                       if t.is_floating_point() else t, qparams)
    path = "serve_quant_gemma2_2b"
    single, _ = linear_counts(cfg16)
    launches, shapes, _ = phase_engine_bf16(
        cfg16, qparams, qconsts, prompts, arrivals, device,
        exec_mode="quant", path=path, profiled=True,
        want_per_dispatch={"quant_sparse_matmul": single}, **kw)
    check_coverage(shapes, m_values, buckets, "quant_sparse_matmul")
    del qparams, qconsts
    torch.cuda.empty_cache()
    return {path: launches}


def phase_long_gemma2(cfg, params, consts, device):
    """Phase g3's long request: a LONG_PROMPT-token prompt, then LONG_NEW
    new tokens, on a one-slot paged engine with prefix sharing (so its
    prefill runs the tensor-core ``paged_prefill`` over 4300 queries, the
    local layers' windows inside it) in bf16. Every dispatch first runs
    two gathered reads (``attn_kernel="gather"``) on the same cache: one
    with the local layers' window dropped (a faulty read), then the sound
    one; then the kernels' read, which writes the cache the engine
    continues from. The kernels' logits are held to the sound read's
    within LONG_LOGIT_TOL at each step, and their greedy tokens must agree
    (a top-2 gap in the gathered logits below the difference excepted);
    the faulty read must stray past LONG_LOGIT_TOL at every step, or the
    limit could not tell a read that ignores the window. The gathered
    reads' launches are taken out of the counts: returns the counts of the
    kernels' read alone."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import step as step_lib
    eng = ServeEngine(cfg, params, consts, n_slots=1, max_len=LONG_MAX_LEN,
                      paged=True, block_len=16, prefix_sharing=True,
                      attn_kernel="paged", device=device)
    gcfg = dataclasses.replace(eng.cfg, attn_kernel="gather")
    fcfg = dataclasses.replace(gcfg, sliding_window=0)

    def steps(c):
        return {"decode": step_lib.make_serve_step(c, eng.api),
                "prefill": step_lib.make_prefill_step(c, eng.api)}
    gather, fault = steps(gcfg), steps(fcfg)
    diffs = []
    side = {k: 0 for k in launch_counts()}

    def three_reads(kind, paged_fn):
        def run(params, consts, tokens, cache, *args, **kwargs):
            before = launch_counts()
            _, f_logits, cache = fault[kind](params, consts, tokens, cache,
                                             *args, **kwargs)
            g_tok, g_logits, cache = gather[kind](params, consts, tokens,
                                                  cache, *args, **kwargs)
            for k, v in launch_counts().items():
                side[k] += v - before[k]
            p_tok, p_logits, cache = paged_fn(params, consts, tokens, cache,
                                              *args, **kwargs)
            # the logits that pick the token: the prompt's last position
            # (the prefill's lengths[0] - 1), or the decode step's one
            n = min(max(int(args[0][0]) - 1, 0), tokens.shape[1] - 1) \
                if kind == "prefill" else 0
            f, g, p = (x[0, n].float() for x in (f_logits, g_logits,
                                                 p_logits))
            top = torch.topk(g, 2).values
            diffs.append(((p - g).abs().max().item(), int(p_tok[0, 0]),
                          int(g_tok[0, 0]), (top[0] - top[1]).item(),
                          bool(torch.isfinite(p).all()),
                          (f - g).abs().max().item(), kind))
            return p_tok, p_logits, cache
        return run
    eng._prefill_fn = three_reads("prefill", eng._prefill_fn)
    eng._decode_fn = three_reads("decode", eng._decode_fn)
    rng = np.random.default_rng(7)
    prompt = rng.integers(3, cfg.vocab_size, size=LONG_PROMPT).tolist()
    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    req = eng.submit(prompt, max_new_tokens=LONG_NEW)
    stats = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v - side[k] for k, v in launch_counts().items()}
    if req.status != "done" or len(req.out) != LONG_NEW or \
            stats["exhausted"]:
        fail(f"long request: status {req.status}, {len(req.out)} tokens")
    missing = [k for k in PATH_KERNELS["serve_long_gemma2_2b"]
               if launches[k] == 0]
    if missing:
        fail(f"long request never launched {missing}: {launches}")
    # one sl_matmul a projection a layer a dispatch, each read; the
    # gathered reads launch no paged kernel, the kernels' read one a layer
    n_lin = 7 * cfg.n_layers * len(diffs)
    n_prefill = cfg.n_layers * sum(d[6] == "prefill" for d in diffs)
    want = {"sl_matmul": (n_lin, 2 * n_lin), "paged_prefill": (n_prefill, 0),
            "paged_attention": (cfg.n_layers * len(diffs) - n_prefill, 0)}
    for k, (own, gathered) in want.items():
        if launches[k] != own or side[k] != gathered:
            fail(f"long request {k} launches: {launches[k]} by the kernels' "
                 f"read (want {own}), {side[k]} by the gathered reads (want "
                 f"{gathered})")
    worst = max(d[0] for d in diffs)
    fault_least = min(d[5] for d in diffs)
    for i, (d, pt, gt, gap, finite, *_) in enumerate(diffs):
        if not finite or d > LONG_LOGIT_TOL:
            fail(f"long request step {i}: paged vs gathered logits differ "
                 f"by {d:.4f} (tol {LONG_LOGIT_TOL}), finite {finite}")
        if pt != gt and gap > d:
            fail(f"long request step {i}: token {pt} vs gathered {gt}, "
                 f"top-2 gap {gap:.4f} above the logits' difference")
    if not fault_least > LONG_LOGIT_TOL:
        fail(f"long request: a gathered read without the window strays "
             f"only {fault_least:.4f} at some step, inside the tol "
             f"{LONG_LOGIT_TOL}")
    say(f"engine bf16 {arch(cfg)} long request: prompt {LONG_PROMPT} "
        f"tokens past the {cfg.sliding_window}-key window, {LONG_NEW} new, "
        f"{len(diffs)} dispatches each read three times (gathered without "
        f"the window, gathered, then the kernels) | max |logit difference| "
        f"per step, kernels vs gathered {[round(d[0], 4) for d in diffs]}, "
        f"worst {worst:.4f} (tol {LONG_LOGIT_TOL}); gathered without the "
        f"window vs gathered {[round(d[5], 4) for d in diffs]}, least "
        f"{fault_least:.4f} | tokens equal on "
        f"{sum(d[1] == d[2] for d in diffs)}/{len(diffs)} | wall "
        f"{wall:.2f} s (three reads) | the kernels' read launched "
        f"{launches}, the gathered reads {side}")
    return launches


def run_gemma2_bf16(cfg, device, smi, *, batch, seq, n_slots, block_len,
                    max_len, buckets, m_values, rows):
    """Phase g3: gemma2_2b at full width in bf16 on GEMMA_BF16_LAYERS
    layers from one pooled
    init (B ~ U(-1, 1), fused tile consts, which the sparse path reads
    too): the fused and the sparse paged engine on the 8-request traffic,
    timed under the device-only profiler (tokens/s and busy share) with
    launch counts read around each; the long request; then the Trainer,
    3 steps of global AdamW (fused) and 3 of per-layer 8-bit AdamW, its
    own init each, no checkpoint written. Returns each path's launch
    counts."""
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    from repro_torch.obs import metrics as obs_metrics
    gen = torch.Generator(device=device)
    gen.manual_seed(60)
    cfg16 = dataclasses.replace(cfg, n_layers=GEMMA_BF16_LAYERS,
                                param=dataclasses.replace(
                                    cfg.param, exec_mode="fused"))
    reg = obs_metrics.Registry()
    params, consts = lm.init_lm(cfg16, seed=0, device=device, obs=reg)
    randomize_b(params, gen)
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    say(f"init {arch(cfg16)} bf16: {cfg16.n_layers} layers ({cfg.attn_pattern}"
        f" periods), d_model {cfg.d_model}, d_ff {cfg.d_ff}, {cfg.n_heads} "
        f"heads over {cfg.n_kv_heads} of {cfg.resolved_head_dim}, vocab "
        f"{cfg.padded_vocab} tied, rank {cfg.param.rank}, delta "
        f"{cfg.param.delta}, {n_params / 1e6:.1f} M params, consts "
        f"{sum(nbytes(t) for _, t in tree_leaves(consts)) / 2**30:.2f} GiB, "
        f"in {reg.get('init.seconds').value:.1f} s with "
        f"{reg.get('init.sampling_workers').value:.0f} support sampling "
        "workers")
    prompts, arrivals = traffic(cfg.vocab_size)
    kw = dict(n_slots=n_slots, max_len=max_len, block_len=block_len,
              new_tokens=16)
    by_path = {}
    for mode, kernel in (("fused", "sl_matmul"), ("sparse", "sparse_matmul")):
        path = f"{EXEC_PATH[mode]}_gemma2_2b"
        launches, shapes, _ = phase_engine_bf16(
            cfg16, params, consts, prompts, arrivals, device, exec_mode=mode,
            path=path, profiled=True, **kw)
        by_path[path] = launches
        check_coverage(shapes, m_values, buckets, kernel)
    by_path["serve_long_gemma2_2b"] = phase_long_gemma2(cfg16, params,
                                                        consts, device)
    del params, consts
    torch.cuda.empty_cache()
    with ShapeRecorder() as rec:
        tr, state, by_path["train_gemma2_2b"], _, _, peak = \
            phase_train_bf16(cfg16, device, smi, batch=batch, seq=seq,
                             steps=3, save=False)
    check_train_coverage(rec.shapes, batch * seq, cfg)
    del tr, state
    torch.cuda.empty_cache()
    tr, state, by_path["train_per_layer_gemma2_2b"], seen, _, _ = \
        phase_perlayer_bf16(cfg16, device, smi, batch=batch, seq=seq,
                            steps=3, save=False, global_peak=peak)
    check_adam8bit_coverage(seen, rows)
    del tr, state
    torch.cuda.empty_cache()
    return by_path


def phase_paligemma(cfg, device, *, n_slots, block_len, max_len):
    """Phase g4: paligemma_3b at full width on PALI_LAYERS layers, with
    PALI_BATCH x PALI_SEQ batches whose first n_patches positions are
    seeded patch embeddings (the stub frontend's output): one f32 train
    step in exec_mode fused against dense (loss and gradient norm within
    TRAIN_TOL_STEP1), and the f32 engine on the 8-request traffic, fused +
    paged kernels (MQA, group 8, head_dim 256) against dense + gathered
    attention, the same tokens; then the same in bf16: one fused train
    step (finite, launching ``sl_matmul`` and ``sddmm``) and the fused
    engine run (its paged kernels at group 8 in bf16). Returns the bf16
    paths' launch counts."""
    from repro_torch.data.pipeline import SyntheticC4
    from repro_torch.kernels import ops
    from repro_torch.models import lm, registry
    from repro_torch.models.common import tree_map
    from repro_torch.optim import optimizers
    from repro_torch.train import step as step_lib
    gen = torch.Generator(device=device)
    gen.manual_seed(70)
    cfg32 = dataclasses.replace(cfg, n_layers=PALI_LAYERS, dtype="float32",
                                param=dataclasses.replace(
                                    cfg.param, exec_mode="fused"))
    params, consts = lm.init_lm(cfg32, seed=0, device=device)
    randomize_b(params, gen)
    consts = ops.add_transposed_tiles(consts)
    data = SyntheticC4(cfg.vocab_size, PALI_SEQ, PALI_BATCH, seed=0)
    batch = {"tokens": torch.from_numpy(data.next_batch()["tokens"]).to(
        device), "patches": torch.randn(
        (PALI_BATCH, cfg.n_patches, cfg.d_model), generator=gen,
        device=device)}
    api = registry.get_api(cfg32)
    tc = train_config(cfg32, steps=1, batch=PALI_BATCH, seq=PALI_SEQ,
                      ckpt_dir="")
    out = {}
    for mode in ("fused", "dense"):
        c = dataclasses.replace(cfg32, param=dataclasses.replace(
            cfg32.param, exec_mode=mode))
        opt = optimizers.make(tc.optim)
        reset_launch_counts()
        _, _, m = step_lib.make_train_step(c, api, opt)(
            params, opt.init(params), consts, batch)
        out[mode] = (float(m["loss"]), float(m["grad_norm"]),
                     launch_counts())
    for i, what in ((0, "loss"), (1, "grad_norm")):
        gap = abs(out["fused"][i] - out["dense"][i]) / abs(out["dense"][i])
        if not gap <= TRAIN_TOL_STEP1:
            fail(f"paligemma f32 train step {what}: fused "
                 f"{out['fused'][i]} vs dense {out['dense'][i]} (relative "
                 f"{gap:.3e} > {TRAIN_TOL_STEP1})")
    if not (out["fused"][2]["sl_matmul"] and out["fused"][2]["sddmm"]) or \
            any(out["dense"][2].values()):
        fail(f"paligemma f32 train step launches: {out}")
    say(f"train f32 {arch(cfg32)} one step with {cfg.n_patches} patch "
        f"embeddings a row ({PALI_BATCH}x{PALI_SEQ}): fused (loss, "
        f"grad_norm) {out['fused'][:2]} vs dense {out['dense'][:2]}, "
        f"relative gaps {abs(out['fused'][0] / out['dense'][0] - 1):.3e}, "
        f"{abs(out['fused'][1] / out['dense'][1] - 1):.3e} (tol "
        f"{TRAIN_TOL_STEP1}) | fused launches {out['fused'][2]}")
    prompts, arrivals = traffic(cfg.vocab_size)
    kw = dict(n_slots=n_slots, max_len=max_len, block_len=block_len,
              new_tokens=16)
    phase_engine_f32(cfg32, params, consts, prompts, arrivals, device, **kw)

    by_path = {}
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16")
    params16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    del params
    batch16 = dict(batch, patches=batch["patches"].to(torch.bfloat16))
    opt = optimizers.make(tc.optim)
    reset_launch_counts()
    _, _, m = step_lib.make_train_step(cfg16, api, opt)(
        params16, opt.init(params16), consts, batch16)
    loss = float(m["loss"])
    by_path["train_paligemma_3b"] = launch_counts()
    if not np.isfinite(loss) or float(m["nonfinite"]):
        fail(f"paligemma bf16 train step: loss {loss}")
    say(f"train bf16 {arch(cfg16)} one fused step with patch embeddings: "
        f"loss {loss:.4f}, grad_norm {float(m['grad_norm']):.4f} | "
        f"launches {by_path['train_paligemma_3b']}")
    by_path["serve_paligemma_3b"], _, _ = phase_engine_bf16(
        cfg16, params16, consts, prompts, arrivals, device,
        exec_mode="fused", path="serve_paligemma_3b", **kw)
    del params16, consts
    torch.cuda.empty_cache()
    return by_path


def representatives_families(rows, n_slots, m, bucket):
    """{kernel: the shape of its representative case} among phase g1's
    rows: gemma2_2b's widest projection (2304 -> 9216) at training and
    decode rows, its decode at the engine's shapes and its prefill at the
    largest bucket (head_dim 256, softcap 50, window 4096), the tied
    embedding's 8-bit step."""
    def pick(name, pred):
        return next(r["shape"] for r in rows
                    if r["name"] == name and pred(r["shape"]))
    decode = f"{n_slots}x2304->9216 bfloat16"
    return {"sl_matmul": f"{m}x2304->9216 bfloat16",
            "paged_attention": pick("paged_attention", lambda s: "gemma2"
                                    in s and "context" not in s),
            "paged_prefill": pick("paged_prefill", lambda s: s.startswith(
                f"sq={bucket} gemma2")),
            "sddmm": f"{m}x(2304,9216) bfloat16",
            "adam8bit": pick("adam8bit", lambda s: s.startswith("embed")
                             and s.endswith("wd 0.1")),
            "sparse_matmul": decode + " f32 out",
            "quant_sparse_matmul": decode}


def run_families(device, smi, *, batch, seq, n_slots, block_len, max_len,
                 buckets, m_values):
    """Phases g1 to g4; returns (phase g1's kernel rows, launch counts by
    path)."""
    from repro_torch.models import registry
    cfgs = [registry.get_config(a) for a in
            ("gemma2_2b", "paligemma_3b", "qwen2_5_32b")]
    g2 = cfgs[0]
    lap = Laps()
    rows = check_kernels_families(device, cfgs, m_values, n_slots,
                                  block_len, max_len // block_len, buckets,
                                  batch * seq)
    lap(f"phase g1 ({arch(g2)}, paligemma_3b, qwen2_5_32b kernels)")
    by_path = phase_parity_gemma2(
        g2, device, batch=batch, seq=seq, n_slots=n_slots,
        block_len=block_len, max_len=max_len, buckets=buckets,
        m_values=m_values)
    lap(f"phase g2 ({arch(g2)} f32 parity and quant, {GEMMA_PARITY_LAYERS} "
        "layers)")
    by_path.update(run_gemma2_bf16(g2, device, smi, batch=batch, seq=seq,
                              n_slots=n_slots, block_len=block_len,
                              max_len=max_len, buckets=buckets,
                              m_values=m_values, rows=rows))
    lap(f"phase g3 ({arch(g2)} bf16 serving and training)")
    by_path.update(phase_paligemma(cfgs[1], device, n_slots=n_slots,
                                   block_len=block_len, max_len=max_len))
    lap(f"phase g4 (paligemma_3b, {PALI_LAYERS} layers)")
    return rows, by_path


# ---------------------------------------------------------------------------
# MoE: deepseek_moe_16b and qwen3_moe_235b (phases m1 to m3)
# ---------------------------------------------------------------------------

# m2: deepseek_moe_16b at full width in f32 on its dense first layer and
# one MoE layer, calibrated there; m3: bf16 serving (fused, sparse,
# quant) on that model and its calibration cast to bf16 (4 of 28 layers
# before the quant phases: calibrating 3 MoE layers' 576 expert matrices
# would cost the run minutes) and the Trainer on 2 (1 + 1; 4 before the
# quant phases), 3 steps each
MOE_PARITY_LAYERS = 2
MOE_TRAIN_LAYERS = 2
MOE_TRAIN_STEPS = 3
# the routing-margin excuse: two paths' routers see the same tokens
# through linears that round in another order, so a token whose k-th and
# (k+1)-th router probabilities lie closer than the paths' difference may
# take another expert, and from that dispatch on the co-batched slots'
# capacity and everything after differ. The first routing difference
# between two runs is excused when the reference run's gap between the
# k-th and (k+1)-th probability of every token whose experts differ is
# at most this: in f32 the paths' probabilities differ by ~1e-7; in bf16
# each layer's outputs differ by an ulp or so (0.4%), which after 8
# layers moves a router logit by a few hundredths and a probability of up
# to ~0.25 by up to ~1.4e-2 (the smoke config's 8 experts on the CPU's
# plain versions, fused against dense)
ROUTE_MARGIN = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# the logit-tie excuse, where tokens differ first with the routing equal:
# the reference run's least top-2 logit gap in that dispatch at most this
# (f32: the llama phases' 1e-4; bf16: one ulp of a logit of 16 to 32)
MOE_TIE = {torch.float32: 1e-4, torch.bfloat16: 0.125}
# the SLTrain linears of the deepseek_moe_16b blocks: a dense block's 7
# (4 attention, 3 MLP); an MoE block's 4 attention and 3 shared-expert
# linears single, its 3 routed-expert linears one grouped launch each
PATH_KERNELS.update({
    "serve_deepseek_moe_16b": ("sl_matmul", "sl_matmul_grouped",
                               "paged_attention", "paged_prefill"),
    "serve_sparse_deepseek_moe_16b": ("sparse_matmul", "sparse_matmul_grouped",
                                      "paged_attention", "paged_prefill"),
    "serve_quant_deepseek_moe_16b": ("quant_sparse_matmul",
                                     "quant_sparse_matmul_grouped",
                                     "paged_attention", "paged_prefill"),
    "train_deepseek_moe_16b": ("sl_matmul", "sl_matmul_grouped", "sddmm",
                               "sddmm_grouped"),
    "train_per_layer_deepseek_moe_16b": ("sl_matmul", "sl_matmul_grouped",
                                         "sddmm", "sddmm_grouped",
                                         "adam8bit"),
})


def linear_counts(cfg):
    """(single-matrix SLTrain linears, grouped expert-stack linears) one
    forward of ``cfg`` runs."""
    m = cfg.moe
    n_moe = cfg.n_layers - m.first_k_dense if m.n_experts else 0
    single = 7 * (cfg.n_layers - n_moe) + \
        (4 + 3 * bool(m.n_shared_experts)) * n_moe
    return single, 3 * n_moe


class RouteDiverged(Exception):
    """Raised by a ``RouteLog`` with ``until`` at the first MoE call that
    routes otherwise than the run it follows."""


class RouteLog:
    """While active, records every MoE block's routing (wrapping
    ``models.mlp.route``): per call, the dispatch index it ran in
    (``dispatch``, set by ``serve``), the top-k expert ids and the router
    probabilities, copied to the host (a sync per call: untimed runs
    only). With ``until`` (another run's log) it raises ``RouteDiverged``
    after recording the first call whose top-k expert sets differ from
    that run's: from there on the two runs' states differ, and nothing
    after it is compared."""

    def __init__(self, until=None):
        self.calls = []
        self.dispatch = 0
        self.until = until

    def __enter__(self):
        from repro_torch.models import mlp
        self._orig = orig = mlp.route

        def rec(cfg, probs, *a, **k):
            out = orig(cfg, probs, *a, **k)
            ids = out[1].cpu()
            self.calls.append((self.dispatch, ids,
                               probs.detach().float().cpu()))
            if self.until is not None:
                other = self.until.calls[len(self.calls) - 1][1]
                if not torch.equal(ids.sort(-1).values,
                                   other.sort(-1).values):
                    raise RouteDiverged(self.dispatch)
            return out
        mlp.route = rec
        return self

    def __exit__(self, *exc):
        from repro_torch.models import mlp
        mlp.route = self._orig


def route_divergence(a_log, b_log):
    """The first MoE call whose top-k expert sets differ between run a and
    the reference run b: (dispatch, the largest k/(k+1) probability gap in
    run b over the tokens whose sets differ, max |Δp| of that call, tokens
    that differ), or None when every call routed alike."""
    if len(a_log.calls) != len(b_log.calls) and b_log.until is None:
        fail(f"MoE runs made {len(a_log.calls)} and {len(b_log.calls)} "
             "router calls")
    for (d, ia, pa), (_, ib, pb) in zip(a_log.calls, b_log.calls):
        diff = (ia.sort(-1).values != ib.sort(-1).values).any(-1)
        if bool(diff.any()):
            k = ib.shape[-1]
            top = pb.sort(-1, descending=True).values
            gap = (top[..., k - 1] - top[..., k])[diff]
            return (d, float(gap.max()), float((pa - pb).abs().max()),
                    int(diff.sum()))
    return None


def moe_same_tokens(what, a, b, dtype):
    """Greedy tokens of run ``a`` against the reference run ``b``, each a
    (requests, stats, RouteLog) of one engine over the same traffic. Up to
    the first dispatch where either the routing or a token differs, every
    token must be equal. That first difference must be excused: a
    routing difference by ROUTE_MARGIN (run b's probability gap at the
    flipped tokens), a token difference with the routing equal by
    MOE_TIE (run b's least top-2 logit gap in that dispatch); from that
    dispatch on the runs' states differ (capacity couples the co-batched
    slots) and tokens are counted, not compared. Returns (equal tokens
    before the first difference, total, excuse text)."""
    a_reqs, a_stats, a_log = a
    b_reqs, b_stats, b_log = b
    before = a_stats["outs_before"]

    def dispatch_of(r, i):            # the dispatch that produced token i
        return max(d for d, n in enumerate(before) if n[r] <= i)
    d_tok = None
    for r, (ra, rb) in enumerate(zip(a_reqs, b_reqs)):
        for i, (ta, tb) in enumerate(zip(ra.out, rb.out)):
            if ta != tb:
                d = dispatch_of(r, i)
                d_tok = d if d_tok is None else min(d_tok, d)
                break
    div = route_divergence(a_log, b_log)
    total = sum(len(r.out) for r in a_reqs)
    d0 = min(x for x in (d_tok, div and div[0]) if x is not None) \
        if (d_tok is not None or div) else None
    if d0 is None:
        return total, total, "none needed"
    same = sum(1 for r, ra in enumerate(a_reqs) for i in range(len(ra.out))
               if dispatch_of(r, i) < d0)
    after = total - same
    if div is not None and div[0] <= d0:
        d, gap, dp, n = div
        if gap > ROUTE_MARGIN[dtype]:
            fail(f"{what}: routing differs at dispatch {d} ({n} tokens) "
                 f"with a k/k+1 probability gap of {gap:.3e} in the "
                 f"reference run, above ROUTE_MARGIN {ROUTE_MARGIN[dtype]} "
                 f"(max |Δp| {dp:.3e}): not a near-tie")
        return same, total, (
            f"routing margin: experts differ first at dispatch {d} for {n} "
            f"tokens, k/k+1 gap <= {gap:.3e} (bound {ROUTE_MARGIN[dtype]}, "
            f"max |Δp| there {dp:.3e}); covers the {after} tokens from that "
            "dispatch on")
    gap = b_stats["top2_gaps"][d0]
    if gap > MOE_TIE[dtype]:
        fail(f"{what}: tokens differ first at dispatch {d0} with the routing "
             f"equal and a least top-2 logit gap of {gap:.3e} (bound "
             f"{MOE_TIE[dtype]}): not a tie")
    return same, total, (
        f"logit tie: tokens differ first at dispatch {d0} with equal "
        f"routing, least top-2 gap {gap:.3e} (bound {MOE_TIE[dtype]}); "
        f"covers the {after} tokens from that dispatch on")


def serve_logged(cfg, params, consts, prompts, arrivals, *, exec_mode,
                 attn_kernel, device, until=None, **kw):
    """One engine run (``serve``) with its routing recorded: (requests,
    stats, RouteLog), stats with each dispatch's outputs-before counts
    and least top-2 logit gap. With ``until`` (another run's log) the run
    stops at its first routing difference from that run, its requests
    holding the tokens made so far."""
    with RouteLog(until) as log:
        reqs, stats, _, _ = serve(cfg, params, consts, prompts, arrivals,
                                  exec_mode=exec_mode,
                                  attn_kernel=attn_kernel, device=device,
                                  route_log=log, **kw)
    return reqs, stats, log


def grouped_case(gen, device, n_exp, m, d_in, d_out, dtype, rank, delta,
                 alpha, n_supports=4):
    """A stack of ``n_exp`` expert linears at real width: expert e on the
    (e % n_supports)-th sampled support (sampling 128 full-width supports
    would take the host seconds), its own x (m rows), B, A and v; the tile
    consts and Wᵀ's stacked. Returns (x, B, A, v_t, rows_t, cols_t,
    scale, Wᵀ's tiles, nnz)."""
    from repro_torch.kernels import ops
    r = max(4, min(rank, min(d_in, d_out) // 2))
    sup = [support_tiles(d_in * 7 + d_out + s, d_in, d_out, delta)
           for s in range(n_supports)]
    tiles = {k: torch.stack([sup[e % n_supports][2][k]
                             for e in range(n_exp)]).to(device)
             for k in sup[0][2]}
    tiles = ops.add_transposed_tiles(tiles)
    nnz = sup[0][0].shape[0]

    def u(shape, lim):
        return ((torch.rand(shape, generator=gen, device=device) * 2 - 1)
                * lim).to(dtype)
    x = torch.randn((n_exp, m, d_in), generator=gen, device=device).to(dtype)
    B = u((n_exp, d_in, r), 1.0)
    A = u((n_exp, r, d_out), (6.0 / d_in) ** 0.5)
    v = u((n_exp, nnz), d_in ** -0.5)
    v_t = ops._gather_tiles_grouped(v, tiles["perm"])
    return (x, B, A, v_t, tiles["rows_t"], tiles["cols_t"], alpha / r,
            tiles, nnz * n_exp)


def time_sl_matmul_grouped(timer, label, args, dtype, nnz):
    """One grouped sl_matmul case: bit for bit a loop of single launches
    (and its own rerun), within TOL of the plain version (a loop of
    ``ref.sl_matmul_ref``), timed beside the loop, the plain version and
    ``torch.bmm`` on the pre-densified bf16 W stack. The loop's time
    includes the host's enqueue of its E launches where the Timer's spin
    does not cover it: the cost a loop over the stack pays. The bound
    takes, for each expert, the fewer operations of densifying W and
    multiplying or of the factored form (as ``time_sl_matmul``), and every
    operand once."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sl_matmul as slk
    x, B, A, v_t, rt, ct, scale = args
    n_exp, m, d_in = x.shape
    r, d_out = A.shape[1:]

    def loop():
        return torch.stack([slk.sl_matmul(x[e], B[e], A[e], v_t[e], rt[e],
                                          ct[e], scale)
                            for e in range(n_exp)])

    def plain():
        return torch.stack([ref.sl_matmul_ref(x[e], B[e], A[e], v_t[e],
                                              rt[e], ct[e], scale)
                            for e in range(n_exp)])
    got = slk.sl_matmul_grouped(*args)
    if not torch.equal(got, loop()):
        fail(f"sl_matmul_grouped {label}: differs from a loop of single "
             "launches")
    if not torch.equal(got, slk.sl_matmul_grouped(*args)):
        fail(f"sl_matmul_grouped {label}: a rerun gave other bits")
    err = compare(f"sl_matmul_grouped {label}", got, plain(), dtype)
    W = torch.stack([ref.densify_tiles(B[e], A[e], v_t[e], rt[e], ct[e],
                                       scale, dtype)[:d_in, :d_out]
                     for e in range(n_exp)])
    t_g = timer.ms(lambda: slk.sl_matmul_grouped(*args))
    t_loop = timer.ms(loop)
    t_p = timer.ms(plain, reps=5)
    t_l = timer.ms(lambda: torch.bmm(x, W))
    del W
    dense_ops = n_exp * (2.0 * d_in * d_out * r + 2.0 * m * d_in * d_out)
    fact_ops = n_exp * 2.0 * m * r * (d_in + d_out) + 2.0 * m * nnz
    ops_ = min(dense_ops, fact_ops)
    b, by = bound_ms(nbytes(x, B, A, got) + support_bytes(nnz, v_t, rt, ct),
                     ops_, dtype)
    variant = slk.plan(m, d_in, d_out, r, dtype).variant
    say(f"kernel sl_matmul_grouped {label} ({variant}, {n_exp} experts, one "
        f"launch a stage): bit for bit a loop of {n_exp} single launches | "
        f"max_abs_err vs plain {err:.3e} (tol {TOL[dtype]}) | grouped "
        f"{t_g:.4f} ms, loop of single launches {t_loop:.4f} ms, plain "
        f"{t_p:.4f} ms, torch.bmm on the dense W stack {t_l:.4f} ms, bound "
        f"{b:.4f} ms ({by}, {ops_ / 1e9:.2f} GFLOP)")
    return dict(name="sl_matmul", shape=label, grouped=True,
                experts=n_exp, max_abs_err=err, tol=TOL[dtype], ms=t_g,
                loop_ms=t_loop, plain_ms=t_p, library_ms=t_l, bound_ms=b,
                bound_by=by, variant=variant)


def time_sddmm_grouped(timer, label, x, dy, rt, ct, dtype, nnz):
    """One grouped sddmm case: bit for bit a loop of single launches (and
    its rerun), within the sddmm tolerances of the plain version (a loop
    of ``ref.sddmm_ref``), timed beside the loop, the plain version and
    ``torch.bmm`` of xᵀ·dy in bf16 with the gather; bound 2·M·nnz
    operations over the stack and every operand once."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sddmm as sdk
    n_exp, m, _ = x.shape

    def loop():
        return torch.stack([sdk.sddmm(x[e], dy[e], rt[e], ct[e])
                            for e in range(n_exp)])

    def plain():
        return torch.stack([ref.sddmm_ref(x[e], dy[e], rt[e], ct[e])
                            for e in range(n_exp)])
    got = sdk.sddmm_grouped(x, dy, rt, ct)
    if not torch.equal(got, loop()):
        fail(f"sddmm_grouped {label}: differs from a loop of single launches")
    if not torch.equal(got, sdk.sddmm_grouped(x, dy, rt, ct)):
        fail(f"sddmm_grouped {label}: a rerun gave other bits")
    want = plain()
    err = (got - want).abs()
    if not torch.isfinite(got).all() or bool(
            (err > SDDMM_ATOL + SDDMM_RTOL * want.abs()).any()):
        fail(f"sddmm_grouped {label}: kernel disagrees with its plain "
             f"version: max abs err {err.max().item():.3e}")
    err = float(err.max().item())
    e_idx = torch.arange(n_exp, device=x.device).view(n_exp, 1, 1, 1)
    rows_all, cols_all = zip(*(ref._tile_coords(rt[e], ct[e])
                               for e in range(n_exp)))
    gr, gc = torch.stack(rows_all), torch.stack(cols_all)
    xt = x.transpose(1, 2)

    def lib():
        return torch.bmm(xt, dy, out_dtype=torch.float32)[e_idx, gr, gc] \
            if dtype == torch.bfloat16 else torch.bmm(xt, dy)[e_idx, gr, gc]
    t_g = timer.ms(lambda: sdk.sddmm_grouped(x, dy, rt, ct))
    t_loop = timer.ms(loop)
    t_p = timer.ms(plain, reps=5)
    t_l = timer.ms(lib)
    ops_ = 2.0 * m * nnz
    b, by = bound_ms(nbytes(x, dy) + support_bytes(nnz, rt, ct, got), ops_,
                     dtype)
    say(f"kernel sddmm_grouped {label} ({n_exp} experts, one launch): bit "
        f"for bit a loop of {n_exp} single launches | max_abs_err vs plain "
        f"{err:.3e} (atol {SDDMM_ATOL} rtol {SDDMM_RTOL}) | grouped "
        f"{t_g:.4f} ms, loop of single launches {t_loop:.4f} ms, plain "
        f"{t_p:.4f} ms, torch.bmm bf16 (out_dtype f32) + gather {t_l:.4f} "
        f"ms, bound {b:.4f} ms ({by}, {ops_ / 1e9:.2f} GFLOP)")
    return dict(name="sddmm", shape=label, grouped=True, experts=n_exp,
                max_abs_err=err, tol=SDDMM_ATOL, ms=t_g, loop_ms=t_loop,
                plain_ms=t_p, library_ms=t_l, bound_ms=b, bound_by=by)


def grouped_sparse_case(gen, device, n_exp, d_in, d_out, delta,
                        n_supports=4):
    """A stack of ``n_exp`` experts' sparse terms at real width in both
    decode layouts: expert e on the (e % n_supports)-th sampled support,
    its own values v ~ U(±1/sqrt(d_in)) as f32 tile-CSR, and its own int8
    codes (uniform in ±127 on the support, 0 on padding slots) and
    per-channel scales (U(0.5, 1)/(127·sqrt(d_in))). Returns ((v_t,
    rows_t, cols_t), (qv_t, rows_q, cols_q, qscale), the stack's nnz)."""
    from repro_torch.kernels import ops
    sup = [support_tiles(d_in * 7 + d_out + s, d_in, d_out, delta)
           for s in range(n_supports)]
    tiles = {k: torch.stack([sup[e % n_supports][2][k]
                             for e in range(n_exp)]).to(device)
             for k in ("rows_t", "cols_t", "perm")}
    nnz = sup[0][0].shape[0]
    perm = tiles["perm"]
    v = (torch.rand((n_exp, nnz), generator=gen, device=device) * 2 - 1) \
        * d_in ** -0.5
    codes = torch.randint(-127, 128, perm.shape, generator=gen,
                          device=device).to(torch.int8)
    qv_t = torch.where(perm >= 0, codes, torch.zeros_like(codes))
    qscale = (torch.rand((n_exp, perm.shape[2], 128), generator=gen,
                         device=device) * 0.5 + 0.5) * d_in ** -0.5 / 127
    sp = (ops._gather_tiles_grouped(v, perm), tiles["rows_t"],
          tiles["cols_t"])
    qp = (qv_t, tiles["rows_t"].to(torch.int16),
          tiles["cols_t"].to(torch.int16), qscale)
    return sp, qp, nnz * n_exp


def time_sparse_grouped(timer, label, x, sp, qp, d_out, nnz, timed=True):
    """The grouped sparse-decode launches at one expert-stack shape:
    ``sparse_matmul_grouped`` with an f32 y for a bf16 x (as exec_mode
    sparse's linear calls it) and ``quant_sparse_matmul_grouped``, each
    bit for bit a loop of single launches (and its own rerun), within the
    tolerance of y's dtype of the plain version (a loop of the single
    plain versions). ``timed``: each beside the loop (its time includes
    the host's enqueue of its E launches where the Timer's spin does not
    cover it: the cost a loop over the stack pays), the plain version and
    ``torch.bmm`` on the pre-densified bf16 S stack (dequantized for the
    int8 layout); bound: x, the stack's nnz entries (values and indices,
    or codes and indices, and the scales) and y moved once, or 2·M·nnz
    operations, the larger."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_decode as spk
    n_exp, m, d_in = x.shape
    dtype = x.dtype
    rows = []
    for name, grouped, single, plain, args, out in (
            ("sparse_matmul", spk.sparse_matmul_grouped, spk.sparse_matmul,
             ref.sparse_matmul_ref, sp,
             [torch.float32] if dtype != torch.float32 else []),
            ("quant_sparse_matmul", spk.quant_sparse_matmul_grouped,
             spk.quant_sparse_matmul, ref.quant_sparse_matmul_ref, qp, [])):
        def each(fn):
            return torch.stack([fn(x[e], *(a[e] for a in args), d_out, *out)
                                for e in range(n_exp)])
        got = grouped(x, *args, d_out, *out)
        lbl = label + (" f32 out" if out else "")
        if not torch.equal(got, each(single)):
            fail(f"{grouped.__name__} {lbl}: differs from a loop of single "
                 "launches")
        if not torch.equal(got, grouped(x, *args, d_out, *out)):
            fail(f"{grouped.__name__} {lbl}: a rerun gave other bits")
        err = compare(f"{grouped.__name__} {lbl}", got, each(plain),
                      got.dtype)
        row = dict(name=name, shape=lbl, grouped=True, experts=n_exp,
                   max_abs_err=err, tol=TOL[got.dtype])
        if timed:
            S = torch.stack([
                ref._tile_dense(*(a[e] for a in args[:3]))
                * (args[3][e].reshape(1, -1) if len(args) > 3 else 1.0)
                for e in range(n_exp)])[:, :d_in, :d_out].to(dtype)
            lib = (lambda: torch.bmm(x, S, out_dtype=torch.float32)) if out \
                else (lambda: torch.bmm(x, S))
            t_g = timer.ms(lambda: grouped(x, *args, d_out, *out))
            t_loop = timer.ms(lambda: each(single))
            t_p = timer.ms(lambda: each(plain), reps=5)
            t_l = timer.ms(lib)
            del S
            ops_ = 2.0 * m * nnz
            moved = nbytes(x, got, *args[3:]) + support_bytes(nnz,
                                                              *args[:3])
            b, by = bound_ms(moved, ops_, dtype)
            row.update(ms=t_g, loop_ms=t_loop, plain_ms=t_p, library_ms=t_l,
                       bound_ms=b, bound_by=by)
            say(f"kernel {grouped.__name__} {lbl} ({n_exp} experts, one "
                f"launch, {spk.plan(m, d_in, d_out).splits} splits an "
                f"expert): bit for bit a loop of {n_exp} single launches | "
                f"max_abs_err vs plain {err:.3e} (tol {TOL[got.dtype]}) | "
                f"grouped {t_g:.4f} ms, loop of single launches "
                f"{t_loop:.4f} ms, plain {t_p:.4f} ms, torch.bmm on the "
                f"dense{' dequantized' if len(args) > 3 else ''} S stack "
                f"{t_l:.4f} ms, bound {b:.4f} ms ({by}, {moved / 1e6:.2f} "
                "MB)")
        else:
            say(f"kernel {grouped.__name__} {lbl} ({n_exp} experts, one "
                f"launch): bit for bit a loop of {n_exp} single launches | "
                f"max_abs_err vs plain {err:.3e} (tol {TOL[got.dtype]}), "
                "untimed")
        rows.append(row)
    return rows


def check_kernels_moe(device, cfgs, n_slots, block_len, bps, buckets,
                      m_train_rows):
    """Phase m1: the grouped launches at the experts' shapes in bf16:
    ``sl_matmul_grouped`` at deepseek_moe_16b's (64 experts, 2048 -> 1408
    and 1408 -> 2048, rank 512) at the rows an expert takes at decode (1),
    prefill (15) and training (``m_train_rows``), with the training dx,
    and ``sddmm_grouped`` at training rows; qwen3_moe_235b's (128 experts,
    4096 -> 1536 and 1536 -> 4096, rank 768) at 1 and ``m_train_rows``
    rows; the grouped ``sparse_matmul`` and ``quant_sparse_matmul``
    (``time_sparse_grouped``) at both configs' expert shapes, timed at 1
    and ``m_train_rows`` rows an expert of the d_model -> d_ff_expert
    linears and checked untimed at every other row count the MoE engine
    gives them (``moe_rows``); the paged kernels at qwen3's GQA group 16,
    head_dim 128. Own generators, so no earlier phase's draws move."""
    deep, qwen = cfgs
    timer = Timer(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(70)
    sgen = torch.Generator(device=device)
    sgen.manual_seed(71)
    bf16 = torch.bfloat16
    rows = []
    engine_rows = moe_rows(deep, n_slots, buckets)
    for cfg, ms_, train, sparse_ms in (
            (deep, (1, 15, m_train_rows), True,
             sorted(set(engine_rows) | {m_train_rows})),
            (qwen, (1, m_train_rows), False, (1, m_train_rows))):
        pc, m = cfg.param, cfg.moe
        tag = cfg.name.split("-")[0]
        for d_in, d_out in ((cfg.d_model, m.d_ff_expert),
                            (m.d_ff_expert, cfg.d_model)):
            sp, qp, nnz = grouped_sparse_case(sgen, device, m.n_experts,
                                              d_in, d_out, pc.delta)
            for rows_e in sparse_ms:
                x = torch.randn((m.n_experts, rows_e, d_in), generator=sgen,
                                device=device).to(bf16)
                rows += time_sparse_grouped(
                    timer, f"{m.n_experts}x{rows_e}x{d_in}->{d_out} "
                    f"bfloat16 ({tag})", x, sp, qp, d_out, nnz,
                    timed=d_in == cfg.d_model and rows_e in (1, m_train_rows))
                del x
            del sp, qp
            torch.cuda.empty_cache()
            for rows_e in ms_:
                x, B, A, v_t, rt, ct, scale, tiles, nnz = grouped_case(
                    gen, device, m.n_experts, rows_e, d_in, d_out, bf16,
                    pc.rank, pc.delta, pc.alpha)
                label = (f"{m.n_experts}x{rows_e}x{d_in}->{d_out} bfloat16 "
                         f"({tag})")
                rows.append(time_sl_matmul_grouped(
                    timer, label, (x, B, A, v_t, rt, ct, scale), bf16, nnz))
                if train and rows_e == m_train_rows and d_in == cfg.d_model:
                    dy = torch.randn((m.n_experts, rows_e, d_out),
                                     generator=gen, device=device).to(bf16)
                    from repro_torch.kernels import ops
                    rows.append(time_sl_matmul_grouped(
                        timer, f"dx {m.n_experts}x{rows_e}x{d_out}->{d_in} "
                        f"bfloat16 ({tag})",
                        (dy, A.transpose(1, 2).contiguous(),
                         B.transpose(1, 2).contiguous(),
                         ops.transpose_tiles(v_t), tiles["rows_tT"],
                         tiles["cols_tT"], scale), bf16, nnz))
                    rows.append(time_sddmm_grouped(
                        timer, f"{m.n_experts}x{rows_e}x({d_in},{d_out}) "
                        f"bfloat16 ({tag})", x, dy, rt, ct, bf16, nnz))
                    del dy
                del x, B, A, v_t, rt, ct, tiles
                torch.cuda.empty_cache()
    rows += check_attention_wide(timer, gen, device, qwen, n_slots,
                                 block_len, bps, buckets, False)
    del timer
    torch.cuda.empty_cache()
    return rows


def moe_rows(cfg, n_slots, buckets):
    """The rows an expert takes at each dispatch of the MoE paged engine
    (``models/mlp.py::route``'s capacity, every row of the dispatch
    routing): a decode step's ``n_slots`` rows, each prefill bucket's
    ``n_slots`` x bucket."""
    m = cfg.moe
    return sorted({min(int(max(1, 1.25 * t * m.top_k / m.n_experts)),
                       t * m.top_k)
                   for t in (n_slots,) + tuple(n_slots * b for b in buckets)})


def moe_init(cfg, device, gen, label):
    """A pooled init of ``cfg`` with B ~ U(-1, 1), and its size line."""
    from repro_torch.models import lm
    from repro_torch.models.common import tree_leaves
    from repro_torch.obs import metrics as obs_metrics
    reg = obs_metrics.Registry()
    params, consts = lm.init_lm(cfg, seed=0, device=device, obs=reg)
    randomize_b(params, gen)
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    m = cfg.moe
    say(f"init {arch(cfg)} {label}: {m.first_k_dense} dense + "
        f"{cfg.n_layers - m.first_k_dense} MoE layers ({m.n_experts} experts "
        f"top-{m.top_k} + {m.n_shared_experts} shared, d_ff_expert "
        f"{m.d_ff_expert}, dense d_ff {m.d_ff_dense}), d_model {cfg.d_model}, "
        f"rank {cfg.param.rank}, delta {cfg.param.delta}, "
        f"{n_params / 1e6:.1f} M params, consts "
        f"{sum(nbytes(t) for _, t in tree_leaves(consts)) / 2**30:.2f} GiB, "
        f"in {reg.get('init.seconds').value:.1f} s with "
        f"{reg.get('init.sampling_workers').value:.0f} support sampling "
        "workers")
    return params, consts


def moe_compare(what, cfg, params, consts, prompts, arrivals, device, dtype,
                mode, a=None, base_mode="dense", base_params=None, **kw):
    """Engine tokens of exec_mode ``mode`` (run ``a``, or a new run)
    against exec_mode ``base_mode`` (on ``base_params``, default
    ``params``), both reading the cache through the paged kernels, tick
    for tick under the routing-margin and logit-tie excuses
    (``moe_same_tokens``). Not against the gathered read: a prefill's
    padding positions past a prompt's end (in pages the table leaves
    null) and an idle slot's row route too and take capacity, and the two
    reads give those rows other values, so the co-batched requests'
    routing differs by more than rounding (on the smoke config, 16
    padding rows of the first prefill differ by up to 0.2 in
    probability). Returns run ``a``."""
    a = a or serve_logged(cfg, params, consts, prompts, arrivals,
                          exec_mode=mode, attn_kernel="paged", device=device,
                          **kw)
    b = serve_logged(cfg, params if base_params is None else base_params,
                     consts, prompts, arrivals, exec_mode=base_mode,
                     attn_kernel="paged", device=device, until=a[2], **kw)
    moe_say_same(what, cfg, mode, base_mode, a, b, dtype)
    return a


def moe_say_same(what, cfg, mode, base_mode, a, b, dtype):
    """Print (and gate, ``moe_same_tokens``) run ``a``'s tokens against
    the reference run ``b``'s."""
    same, total, excuse = moe_same_tokens(what, a, b, dtype)
    say(f"engine {dname(dtype)} {arch(cfg)} {mode} vs {base_mode}, paged "
        f"kernels: {same}/{total} tokens equal before the first difference "
        f"| excuse: {excuse} | router calls {len(a[2].calls)} and "
        f"{len(b[2].calls)}" + (f" (the {base_mode} run stopped at the "
                                "first routing difference)"
                                if "diverged_at" in b[1] else ""))


def phase_parity_moe(cfg, device, *, n_slots, block_len, max_len):
    """Phase m2: deepseek_moe_16b at full width in f32 on
    MOE_PARITY_LAYERS layers (its dense first layer and one MoE layer):
    the plain forward of 4 x 32 tokens (a prefill's batch) in fused
    (grouped sl_matmul over the experts) and sparse (grouped
    sparse_matmul) against dense, the logits within 1e-3 x max(1, scale)
    where the routing is equal (else the routing margin must excuse it);
    then the 8-request traffic on the paged engine, fused and sparse each
    against dense and sparse against fused, tick for tick
    (``moe_compare``); then the model calibrated on the card (each routed
    expert's slice its own matrix) and served in exec_mode quant (one
    grouped ``quant_sparse_matmul`` launch a routed-expert linear)
    against the sparse engine on the dequantized weights, tick for tick.
    Returns (params, consts, quant params, quant consts) for phase m3."""
    from repro_torch.models import lm
    gen = torch.Generator(device=device)
    gen.manual_seed(80)
    cfg32 = dataclasses.replace(cfg, n_layers=MOE_PARITY_LAYERS,
                                dtype="float32", param=dataclasses.replace(
                                    cfg.param, exec_mode="fused"))
    params, consts = moe_init(cfg32, device, gen, "f32")
    toks = torch.randint(3, cfg.vocab_size, (n_slots, 32), generator=gen,
                         device=device)
    out, logs = {}, {}
    for mode in ("fused", "sparse", "dense"):
        c = dataclasses.replace(cfg32, param=dataclasses.replace(
            cfg32.param, exec_mode=mode))
        with torch.no_grad(), RouteLog() as logs[mode]:
            out[mode], aux = lm.apply_lm(c, params, consts, toks)
        if not torch.isfinite(out[mode]).all() or not 0.5 < float(aux) < 4:
            fail(f"forward f32 {mode}: non-finite logits or aux {float(aux)}")
    scale = out["dense"].abs().max().item()
    for mode in ("fused", "sparse"):
        div = route_divergence(logs[mode], logs["dense"])
        err = (out[mode] - out["dense"]).abs().max().item()
        if div is None:
            if err > 1e-3 * max(1.0, scale):
                fail(f"forward f32 {mode} vs dense: max abs err {err:.3e} "
                     f"at logit scale {scale:.3e}, routing equal")
            note = "routing equal"
        elif div[1] > ROUTE_MARGIN[torch.float32]:
            fail(f"forward f32 {mode} vs dense: routing differs with a gap "
                 f"of {div[1]:.3e}")
        else:
            note = (f"routing differs for {div[3]} tokens at a gap <= "
                    f"{div[1]:.3e} (excused), logits not compared")
        say(f"forward f32 {arch(cfg32)} {mode} vs dense, {tuple(toks.shape)} "
            f"tokens: max abs err {err:.3e} (tol 1e-3 x max(1, {scale:.2f}))"
            f", {note}")
    prompts, arrivals = traffic(cfg.vocab_size)
    kw = dict(n_slots=n_slots, max_len=max_len, block_len=block_len,
              new_tokens=16)
    runs = {}
    for mode in ("fused", "sparse"):
        reset_launch_counts()
        runs[mode] = moe_compare(f"f32 {mode}", cfg32, params, consts,
                                 prompts, arrivals, device, torch.float32,
                                 mode, **kw)
    moe_say_same("f32 sparse vs fused", cfg32, "sparse", "fused",
                 runs["sparse"], runs["fused"], torch.float32)
    qparams, qconsts = calibrate_on_card(cfg32, params, consts, device,
                                         artifact=False)
    reset_launch_counts()
    q_run = serve_logged(cfg32, qparams, qconsts, prompts, arrivals,
                         exec_mode="quant", attn_kernel="paged",
                         device=device, **kw)
    launches = launch_counts()
    path = "serve_quant_deepseek_moe_16b"
    if not all(launches[k] for k in PATH_KERNELS[path]) or any(
            launches[k] for k in ("sl_matmul", "sl_matmul_grouped",
                                  "sparse_matmul", "sparse_matmul_grouped")):
        fail(f"f32 quant {arch(cfg32)} launched the wrong kernels: "
             f"{launches}")
    moe_compare("f32 quant", cfg32, qparams, qconsts, prompts, arrivals,
                device, torch.float32, "quant", a=q_run, base_mode="sparse",
                base_params=dequantized(qparams, qconsts), **kw)
    say(f"engine f32 {arch(cfg32)} quant launches {launches}")
    return params, consts, qparams, qconsts


def phase_moe_bf16(cfg, device, smi, model, *, batch, seq, n_slots,
                   block_len, max_len, buckets, m_train_rows):
    """Phase m3: deepseek_moe_16b in bf16 at full width. Serving on phase
    m2's MOE_PARITY_LAYERS-layer model and its calibration, cast to bf16
    (``model``: params, consts, quant params, quant consts): the fused,
    sparse and quant paged engines on the 8-request traffic, each timed
    under the device-only profiler (tokens/s, busy share), their launches
    asserted exactly per dispatch (one single launch for each attention,
    shared-expert and dense-MLP linear; one grouped launch over the
    experts for each routed-expert linear of each MoE layer:
    ``sl_matmul_grouped``, ``sparse_matmul_grouped`` or
    ``quant_sparse_matmul_grouped``), every row count an expert took in
    the sparse and quant runs one that phase m1 checked; the fused
    engine's tokens against dense + the paged read under the
    routing-margin excuse. Then the Trainer on MOE_TRAIN_LAYERS layers,
    MOE_TRAIN_STEPS steps of global AdamW (fused) and of per-layer 8-bit
    AdamW: step ms, MFU from active parameters, peak memory, the aux
    loss; finite losses. Returns each path's launch counts."""
    from repro_torch.models.common import tree_map
    lap = Laps()
    to16 = lambda tree: tree_map(
        lambda t: t.to(torch.bfloat16) if t.is_floating_point() else t, tree)
    params, consts, qparams, qconsts = model
    params, qparams = to16(params), to16(qparams)
    cfg16 = dataclasses.replace(cfg, n_layers=MOE_PARITY_LAYERS,
                                param=dataclasses.replace(
                                    cfg.param, exec_mode="fused"))
    prompts, arrivals = traffic(cfg.vocab_size)
    kw = dict(n_slots=n_slots, max_len=max_len, block_len=block_len,
              new_tokens=16)
    single, grouped = linear_counts(cfg16)
    checked = set(moe_rows(cfg, n_slots, buckets)) | {m_train_rows}
    expert_shapes = {(cfg.d_model, cfg.moe.d_ff_expert),
                     (cfg.moe.d_ff_expert, cfg.d_model)}
    by_path = {}
    for mode, p, c, kernels in (
            ("fused", params, consts, ("sl_matmul", "sl_matmul_grouped")),
            ("sparse", params, consts, ("sparse_matmul",
                                        "sparse_matmul_grouped")),
            ("quant", qparams, qconsts, ("quant_sparse_matmul",
                                         "quant_sparse_matmul_grouped"))):
        path = f"{EXEC_PATH[mode]}_deepseek_moe_16b"
        with ShapeRecorder() as rec:
            launches, _, _ = phase_engine_bf16(
                cfg16, p, c, prompts, arrivals, device, exec_mode=mode,
                path=path, profiled=True,
                want_per_dispatch=dict(zip(kernels, (single, grouped))),
                **kw)
        by_path[path] = launches
        seen = {m for m, k, n in rec.shapes["sparse_matmul"]
                if (k, n) in expert_shapes}
        if not seen <= checked:
            fail(f"bf16 {mode} {arch(cfg16)}: experts took rows "
                 f"{sorted(seen)}; phase m1 checked {sorted(checked)}")
        say(f"engine bf16 {arch(cfg16)} {mode}: {single} {kernels[0]} and "
            f"{grouped} {kernels[1]} launches a dispatch (asserted); a loop "
            f"over the experts would launch "
            f"{single + grouped * cfg.moe.n_experts}"
            + (f"; rows an expert {sorted(seen)}, all checked in m1"
               if mode != "fused" else ""))
        lap(f"m3: bf16 {mode} engine, timed and profiled")
    moe_compare("bf16 fused", cfg16, params, consts, prompts, arrivals,
                device, torch.bfloat16, "fused", **kw)
    lap("m3: fused against dense, routing logged")
    del params, consts, qparams, qconsts, model
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device)
    gen.manual_seed(90)
    cfg_t = dataclasses.replace(cfg16, n_layers=MOE_TRAIN_LAYERS)
    tr, state, by_path["train_deepseek_moe_16b"], _, _, peak = \
        phase_train_bf16(cfg_t, device, smi, batch=batch, seq=seq,
                         steps=MOE_TRAIN_STEPS, save=False)
    say(f"train bf16 {arch(cfg_t)} global AdamW: aux per step "
        f"{[round(h['aux'], 4) for h in tr.metrics_history]}")
    lap("m3: Trainer, global AdamW")
    del tr, state
    torch.cuda.empty_cache()
    tr, state, by_path["train_per_layer_deepseek_moe_16b"], _, _, _ = \
        phase_perlayer_bf16(cfg_t, device, smi, batch=batch, seq=seq,
                            steps=MOE_TRAIN_STEPS, save=False,
                            global_peak=peak)
    say(f"train bf16 {arch(cfg_t)} per-layer 8-bit: aux per step "
        f"{[round(h['aux'], 4) for h in tr.metrics_history]}")
    del tr, state
    torch.cuda.empty_cache()
    return by_path


def representatives_moe(rows, n_slots, m_train_rows, bucket):
    """{kernel: the shape of its representative MoE case} among phase m1's
    rows: the grouped launches at deepseek_moe_16b's 2048 -> 1408 experts
    at training rows; the paged kernels at qwen3's group 16."""
    def pick(name, pred):
        return next(r["shape"] for r in rows
                    if r["name"] == name and pred(r["shape"]))
    return {"sl_matmul": f"64x{m_train_rows}x2048->1408 bfloat16 (deepseek)",
            "sddmm": f"64x{m_train_rows}x(2048,1408) bfloat16 (deepseek)",
            "sparse_matmul": "64x1x2048->1408 bfloat16 (deepseek) f32 out",
            "quant_sparse_matmul": "64x1x2048->1408 bfloat16 (deepseek)",
            "paged_attention": pick("paged_attention",
                                    lambda s: s.startswith("qwen3")),
            "paged_prefill": pick("paged_prefill", lambda s: s.startswith(
                f"sq={bucket} qwen3"))}


def run_moe(device, smi, *, batch, seq, n_slots, block_len, max_len,
            buckets):
    """Phases m1 to m3; returns (phase m1's kernel rows, launch counts by
    path)."""
    from repro_torch.models import registry
    deep = registry.get_config("deepseek_moe_16b")
    qwen = registry.get_config("qwen3_moe_235b")
    lap = Laps()
    # rows an expert takes in training: 8 x 256 tokens, top-6 of 64 at
    # capacity factor 1.25
    m_train = int(max(1, 1.25 * batch * seq * deep.moe.top_k
                      / deep.moe.n_experts))
    rows = check_kernels_moe(device, (deep, qwen), n_slots, block_len,
                             max_len // block_len, buckets, m_train)
    lap("phase m1 (deepseek_moe_16b and qwen3_moe_235b kernels)")
    model = phase_parity_moe(deep, device, n_slots=n_slots,
                             block_len=block_len, max_len=max_len)
    lap(f"phase m2 (deepseek_moe_16b f32 parity and quant, "
        f"{MOE_PARITY_LAYERS} layers)")
    by_path = phase_moe_bf16(deep, device, smi, model, batch=batch, seq=seq,
                             n_slots=n_slots, block_len=block_len,
                             max_len=max_len, buckets=buckets,
                             m_train_rows=m_train)
    del model
    lap("phase m3 (deepseek_moe_16b bf16 serving and training)")
    return rows, by_path, representatives_moe(rows, n_slots, m_train,
                                              buckets[-1])


# ---------------------------------------------------------------------------
# the SSM and encoder families: zamba2_7b, xlstm_350m, whisper_large_v3
# (phases h1 to h3)
# ---------------------------------------------------------------------------

SSM_ARCHS = ("zamba2_7b", "xlstm_350m", "whisper_large_v3")
# h2: f32 parity at full width on a depth cut: zamba2 one super block (6
# Mamba blocks and the shared block with its adapter) and a tail of 1;
# xlstm one super block of 7 mLSTM and 1 sLSTM; whisper 2 encoder and 2
# decoder layers
SSM_PARITY_CUT = {"zamba2_7b": dict(n_layers=7),
                  "xlstm_350m": dict(n_layers=8),
                  "whisper_large_v3": dict(n_layers=2, encoder_layers=2)}
# h3: zamba2 in bf16 on this many of its 81 layers (a super block of 6
# and a tail of 1; hybrid_attn_every stays 6), for time: its serving and
# training at full depth would take ~3 pooled inits of 2.4 B params and
# more than the script's remaining budget (13 layers, 2 super blocks,
# before the quant phases). xlstm on XLSTM_BF16_LAYERS of its 24 (one
# super block of 7 mLSTM and 1 sLSTM; full depth before the quant
# phases), whisper's training at full depth.
HYBRID_LAYERS = 7
XLSTM_BF16_LAYERS = 8
SSM_TRAIN_STEPS = 3
# whisper's bf16 training batch (x 256 decoder tokens, each with 1500
# encoder frames): the plain encoder attention keeps the B·H·1500² f32
# probabilities of each of 32 layers for the backward (0.72 GB a layer
# and sample); the peak read 60.02 GiB at 4 and 48.50 GiB at 3 on an H100
WHISPER_TRAIN_BATCH = 3
# whisper's bf16 serving on this many of its 32 decoder layers (the
# encoder, which the engine never runs, keeps its 32): each dispatch runs
# 10 SLTrain linears a layer, the cross-attention's k and v at 1500 rows
# a slot, and at ~0.7 ms of host time a linear call the 124 dispatches
# took 28.7 s (fused) and 40.2 s (sparse) at full depth on the H100 (8
# layers before the quant phases, 4 until a slower host took the script
# past its limit)
WHISPER_SERVE_LAYERS = 2
for _a in SSM_ARCHS:
    PATH_KERNELS.update({
        f"serve_contiguous_{_a}": ("sl_matmul",),
        f"serve_contiguous_sparse_{_a}": ("sparse_matmul",),
        f"train_{_a}": ("sl_matmul", "sddmm"),
        f"train_sparse_{_a}": ("sparse_matmul", "sddmm")})


def ssm_shapes(cfg):
    """The distinct (d_in, d_out) of the family's SLTrain linears, in
    order."""
    from repro_torch.models.xlstm import slstm_ffn_width
    d, hd = cfg.d_model, cfg.resolved_head_dim
    attn = [(d, cfg.n_heads * hd), (d, cfg.n_kv_heads * hd),
            (cfg.n_heads * hd, d)]
    if cfg.family == "mamba_hybrid":
        sc = cfg.ssm
        di = sc.expand * d
        out = [(d, 2 * di + 2 * sc.state_dim + di // sc.head_dim), (di, d),
               (2 * d, d)] + attn + [(d, cfg.d_ff), (cfg.d_ff, d)]
    elif cfg.family == "xlstm":
        f = slstm_ffn_width(cfg)
        out = [(d, 4 * d), (2 * d, 6 * d), (2 * d, d), (d, 4 * d), (d, f),
               (f, d)]
    else:
        out = attn + [(d, cfg.d_ff), (cfg.d_ff, d)]
    return list(dict.fromkeys(out))


def ssm_linear_calls(cfg, decode=False):
    """The SLTrain linear calls of one forward of ``cfg`` (``decode``: of
    one decode step, which runs no encoder)."""
    if cfg.family == "mamba_hybrid":
        return 2 * cfg.n_layers + 8 * (cfg.n_layers // cfg.hybrid_attn_every)
    if cfg.family == "xlstm":
        m = cfg.xlstm_m_per_s
        return cfg.n_layers // (m + 1) * (3 * m + 4)
    return 10 * cfg.n_layers + (0 if decode else 6 * cfg.encoder_layers)


def ssm_rows(cfg, n_slots, batch, seq):
    """(serving M values, training M values) the main paths give the
    family's linears: the contiguous engine's n_slots rows (whisper's
    cross-attention also projects its n_slots x 1500 encoder rows); the
    training batch's tokens (whisper's decoder WHISPER_TRAIN_BATCH x seq,
    its encoder and cross-attention WHISPER_TRAIN_BATCH x 1500), the
    timed training rows first."""
    if cfg.family != "whisper":
        return (n_slots,), (batch * seq,)
    return ((n_slots, n_slots * cfg.encoder_seq),
            (WHISPER_TRAIN_BATCH * seq,
             WHISPER_TRAIN_BATCH * cfg.encoder_seq))


# the timed cases of phase h1 (the rest are checked against the plain
# versions without timing): {arch: [(d_in, d_out, what)]}
SSM_TIMED = {"zamba2_7b": [(3584, 14576, "in_proj"),
                           (7168, 3584, "out_proj, shared in_proj"),
                           (3584, 14336, "MLP")],
             "xlstm_350m": [(2048, 6144, "qkv"), (1024, 1408, "FFN")],
             "whisper_large_v3": [(1280, 5120, "MLP"),
                                  (1280, 1280, "qkv, bias added after")]}


def check_case(name, label, got, want, dtype, atol=None, rtol=None):
    """One untimed kernel case against its plain version: its row."""
    torch.cuda.synchronize()
    if atol is None:
        err = compare(f"{name} {label}", got, want, got.dtype)
        tol = TOL[got.dtype]
    else:
        e = (got - want).abs()
        if not torch.isfinite(got).all() or bool(
                (e > atol + rtol * want.abs()).any()):
            fail(f"{name} {label}: kernel disagrees with its plain version: "
                 f"max abs err {e.max().item():.3e}")
        err, tol = float(e.max().item()), atol
    return dict(name=name, shape=label, max_abs_err=err, tol=tol)


def check_kernels_ssm(device, cfgs, n_slots, batch, seq):
    """Phase h1: the kernels at the new families' full-width shapes in
    bf16. Timed, with the llama_1b phases' checks (plain version, rerun
    bit for bit, plans, the plain version's time, the bound and one
    library call): ``sl_matmul`` at SSM_TIMED's shapes at decode and
    training rows and its dx, ``sddmm`` at training rows, whisper's
    cross-attention k projection at its n_slots x 1500 encoder rows,
    ``sparse_matmul`` and ``quant_sparse_matmul`` at decode rows. Then
    every other (M, K, N) the h3 main paths give ``sl_matmul``,
    ``sddmm`` and ``sparse_matmul`` (every distinct linear shape at the
    serving and training rows, forward and dx) held against the plain
    versions untimed. Own generator, so no earlier phase's draws move.
    Returns (rows, {kernel: checked (M, K, N)})."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sddmm as sdk
    from repro_torch.kernels import sl_matmul as slk
    from repro_torch.kernels import sparse_decode as spk
    timer = Timer(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(110)
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []
    checked = {"sl_matmul": set(), "sddmm": set(), "sparse_matmul": set()}
    for cfg in cfgs:
        pc, tag = cfg.param, cfg.name.split("-")[0]
        name = cfg.name.replace("-", "_")
        serve_m, train_m = ssm_rows(cfg, n_slots, batch, seq)
        timed = {(a, b): w for a, b, w in SSM_TIMED[name]}
        for d_in, d_out in ssm_shapes(cfg):
            ms = sorted(set(serve_m) | set(train_m))
            seed = d_in * 7 + d_out
            big = sl_case(gen, device, d_in, d_out, ms[-1], bf16, pc.rank,
                          pc.delta, pc.alpha, seed)
            x_all, B, A, v_t, rt, ct, scale = big
            dx_args = (A.T.contiguous(), B.T.contiguous(),
                       ops.transpose_tiles(v_t), ops.transpose_tiles(ct),
                       ops.transpose_tiles(rt), scale)
            nnz = int((v_t != 0).sum())
            what = f" ({tag} {timed[(d_in, d_out)]})" \
                if (d_in, d_out) in timed else f" ({tag})"
            sp = [v_t.float(), rt, ct]
            spT = [dx_args[2].float(), dx_args[3], dx_args[4]]
            for m in ms:
                x = x_all[:m].contiguous()
                args = (x, B, A, v_t, rt, ct, scale)
                label = f"{m}x{d_in}->{d_out} bfloat16{what}"
                # whisper's cross-attention k at its encoder rows too
                is_timed = (d_in, d_out) in timed and (
                    m in (n_slots, train_m[0]) or m in serve_m and
                    (d_in, d_out) == (cfg.d_model, cfg.d_model))
                if is_timed:
                    rows.append(time_sl_matmul(timer, label, args, bf16))
                else:
                    rows.append(check_case("sl_matmul", label,
                                           slk.sl_matmul(*args),
                                           ref.sl_matmul_ref(*args), bf16))
                checked["sl_matmul"].add((m, d_in, d_out))
                # the sparse term's forward, with the f32 y of the sparse
                # linear (the timed shapes' decode rows timed below, with
                # the int8 kernel)
                if m != n_slots or (d_in, d_out) not in timed:
                    rows.append(check_case(
                        "sparse_matmul", label + " f32 out",
                        spk.sparse_matmul(x, *sp, d_out, f32),
                        ref.sparse_matmul_ref(x, *sp, d_out, f32), f32))
                checked["sparse_matmul"].add((m, d_in, d_out))
                if m not in train_m:
                    continue
                dy = torch.randn((m, d_out), generator=gen,
                                 device=device).to(bf16)
                dlabel = f"dx {m}x{d_out}->{d_in} bfloat16{what}"
                if is_timed and m == train_m[0]:
                    rows.append(time_sl_matmul(timer, dlabel,
                                               (dy,) + dx_args, bf16))
                    rows.append(time_sddmm(
                        timer, f"{m}x({d_in},{d_out}) bfloat16{what}", x,
                        dy, rt, ct, bf16, nnz))
                else:
                    rows.append(check_case(
                        "sl_matmul", dlabel, slk.sl_matmul(dy, *dx_args),
                        ref.sl_matmul_ref(dy, *dx_args), bf16))
                    rows.append(check_case(
                        "sddmm", f"{m}x({d_in},{d_out}) bfloat16{what}",
                        sdk.sddmm(x, dy, rt, ct), ref.sddmm_ref(x, dy, rt, ct),
                        bf16, sddmm_atol(m), SDDMM_RTOL))
                rows.append(check_case(
                    "sparse_matmul", dlabel + " f32 out",
                    spk.sparse_matmul(dy, *spT, d_in, f32),
                    ref.sparse_matmul_ref(dy, *spT, d_in, f32), f32))
                checked["sl_matmul"].add((m, d_out, d_in))
                checked["sddmm"].add((m, d_in, d_out))
                checked["sparse_matmul"].add((m, d_out, d_in))
                del dy
            del big, x_all, B, A, v_t, dx_args, sp, spT
            torch.cuda.empty_cache()
        rows += check_sparse_decode(
            timer, gen, device, cfg, (n_slots,), (bf16,),
            shapes=[(a, b) for a, b, _ in SSM_TIMED[name]], tag=f" ({tag})")
        torch.cuda.empty_cache()
    del timer
    torch.cuda.empty_cache()
    n_timed = sum("ms" in r for r in rows)
    say(f"phase h1: {len(rows)} kernel cases at the SSM and encoder "
        f"families' shapes, {n_timed} of them timed")
    return rows, checked


def check_ssm_coverage(shapes, checked, what):
    """Every (M, K, N) a main path gave sl_matmul, sddmm and sparse_matmul
    was held against the plain version in phase h1."""
    for k, seen in shapes.items():
        if not seen <= checked[k]:
            fail(f"{what} ran {k} at (M, K, N) "
                 f"{sorted(seen - checked[k])}, not checked in phase h1")
    say(f"coverage: {what} ran " + "; ".join(
        f"{k} at {len(v)} (M, K, N)" for k, v in shapes.items() if v)
        + ", all checked in phase h1")


def ssm_init(cfg, device, gen, label):
    """A pooled init of ``cfg`` with every B drawn (``randomize_b``), and
    its size line: the true parameter count beside the reference's
    analytic one (``param_count_active``, which 6·N·D and the MFU read)."""
    from repro_torch.analysis import roofline
    from repro_torch.models import registry
    from repro_torch.models.common import tree_leaves
    from repro_torch.obs import metrics as obs_metrics
    reg = obs_metrics.Registry()
    params, consts = registry.get_api(cfg).init(cfg, 0, device=device,
                                                obs=reg)
    randomize_b(params, gen)
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    say(f"init {arch(cfg)} {label}: d_model {cfg.d_model}, rank "
        f"{cfg.param.rank}, delta {cfg.param.delta}, {n_params / 1e6:.1f} M "
        f"params (the reference's analytic count "
        f"{roofline.param_count_active(cfg)[1] / 1e6:.1f} M), consts "
        f"{sum(nbytes(t) for _, t in tree_leaves(consts)) / 2**30:.2f} GiB, "
        f"in {reg.get('init.seconds').value:.1f} s with "
        f"{reg.get('init.sampling_workers').value:.0f} support sampling "
        "workers")
    return params, consts, n_params


def phase_parity_ssm(cfg, device, *, batch, seq, n_slots, block_len,
                     max_len):
    """Phase h2: one family at full width in f32 on its SSM_PARITY_CUT:
    the plain forward of n_slots x 32 tokens (whisper with seeded frames)
    fused and sparse against dense, within 1e-3 x max(1, scale); 3 train
    steps fused and sparse against dense (step 1 TRAIN_TOL_STEP1, later
    steps the larger of TRAIN_TOL_LATER and SPREAD_FACTOR times the
    spread a 1e-7 move of the init makes); the 8-request
    traffic on the contiguous engine, fused and sparse against dense tick
    for tick, a first difference excused only by a top-2 logit gap below
    1e-4 in the dense run's dispatch (``moe_same_tokens`` with no router
    calls)."""
    from repro_torch.models import registry
    name = cfg.name.replace("-", "_")
    gen = torch.Generator(device=device)
    gen.manual_seed(120 + SSM_ARCHS.index(name))
    cfg32 = dataclasses.replace(cfg, dtype="float32", **SSM_PARITY_CUT[name],
                                param=dataclasses.replace(cfg.param,
                                                          exec_mode="fused"))
    api = registry.get_api(cfg32)
    params, consts, _ = ssm_init(cfg32, device, gen, "f32")
    phase_train_parity(cfg32, device, gen, batch=batch, seq=seq,
                       names=("fused", "dense", "sparse"), spread=True,
                       init=(params, consts))
    torch.cuda.empty_cache()
    toks = torch.randint(3, cfg.vocab_size, (n_slots, 32), generator=gen,
                         device=device)
    b = model_batch(cfg32, toks, gen)
    out = {}
    for mode in ("fused", "sparse", "dense"):
        c = dataclasses.replace(cfg32, param=dataclasses.replace(
            cfg32.param, exec_mode=mode))
        with torch.no_grad():
            out[mode], _ = api.apply(c, params, consts, b)
        if not torch.isfinite(out[mode]).all():
            fail(f"forward f32 {arch(cfg32)} {mode}: non-finite logits")
    scale = out["dense"].abs().max().item()
    for mode in ("fused", "sparse"):
        err = (out[mode] - out["dense"]).abs().max().item()
        if err > 1e-3 * max(1.0, scale):
            fail(f"forward f32 {arch(cfg32)} {mode} vs dense: max abs err "
                 f"{err:.3e} at logit scale {scale:.3e}")
        say(f"forward f32 {arch(cfg32)} {mode} vs dense, "
            f"{tuple(toks.shape)} tokens: max abs err {err:.3e} (tol 1e-3 x "
            f"max(1, {scale:.2f}))")
    del out
    prompts, arrivals = traffic(cfg.vocab_size)
    kw = dict(n_slots=n_slots, max_len=max_len, block_len=block_len,
              new_tokens=16, paged=False)
    ref_run = serve_logged(cfg32, params, consts, prompts, arrivals,
                           exec_mode="dense", attn_kernel=None,
                           device=device, **kw)
    for mode in ("fused", "sparse"):
        a = serve_logged(cfg32, params, consts, prompts, arrivals,
                         exec_mode=mode, attn_kernel=None, device=device,
                         **kw)
        same, total, excuse = moe_same_tokens(
            f"f32 contiguous {arch(cfg32)} {mode}", a, ref_run,
            torch.float32)
        say(f"engine f32 {arch(cfg32)} contiguous {mode} vs dense: "
            f"{same}/{total} tokens equal tick for tick before the first "
            f"difference | excuse: {excuse} | {len(a[1]['top2_gaps'])} "
            "dispatches")
    del params, consts
    torch.cuda.empty_cache()


def phase_whisper_train_bf16(cfg, params, consts, device, smi, *, batch,
                             seq, steps):
    """Phase h3's whisper training: the global AdamW train step (fused,
    or sparse, as ``cfg`` says) that the Trainer would run, from
    ``params`` (left as they are: the step is functional) and ``consts``
    (with Wᵀ's tiles), fed batches with seeded frames (the Trainer's data
    has none and it refuses whisper, as the reference's dies on it), one
    warm-up step and the rest timed; launch counts, shapes and the peak
    read around the steps. Returns (launches, shapes, median step s, peak
    bytes)."""
    from repro_torch.analysis import roofline
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.pipeline import SyntheticC4
    from repro_torch.models import registry
    from repro_torch.optim import optimizers
    from repro_torch.train import step as step_lib
    mode = cfg.param.exec_mode
    gen = torch.Generator(device=device)
    gen.manual_seed(130)
    api = registry.get_api(cfg)
    opt = optimizers.make(OptimizerConfig(name="adamw", lr=3e-3,
                                          warmup_steps=1, total_steps=steps))
    fn = step_lib.make_train_step(cfg, api, opt)
    state = opt.init(params)
    data = SyntheticC4(cfg.vocab_size, seq, batch, seed=0)
    batches = [model_batch(cfg, torch.from_numpy(
        data.next_batch()["tokens"]).to(device), gen) for _ in range(steps)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    dts, losses = [], []
    with ShapeRecorder() as rec:
        for b in batches:
            t0 = time.perf_counter()
            params, state, m = fn(params, state, consts, b)
            losses.append(float(m["loss"]))
            dts.append(time.perf_counter() - t0)
            if float(m["nonfinite"]):
                fail(f"bf16 whisper {mode} training: a non-finite step")
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if not all(np.isfinite(losses)):
        fail(f"bf16 whisper {mode} training: losses {losses}")
    n_lin = ssm_linear_calls(cfg)
    linear = {"fused": "sl_matmul", "sparse": "sparse_matmul"}[mode]
    want = {k: 0 for k in launches}
    want.update({linear: 2 * n_lin * steps, "sddmm": n_lin * steps})
    if launches != want:
        fail(f"bf16 whisper {mode} training launched {launches}, expected "
             f"{want}")
    med = statistics.median(dts[1:])
    tokens = batch * seq
    say(f"train bf16 {arch(cfg)} (train step with seeded frames, {mode}): "
        f"{steps} steps, batch {batch} x {seq} tokens (+ {cfg.encoder_seq} "
        f"frames each), losses {[round(x, 4) for x in losses]} | step ms "
        f"{[round(d * 1e3, 1) for d in dts]}, median of steps 2-{steps} "
        f"{med * 1e3:.1f} ms = {tokens / med:.0f} tokens/s, MFU (the "
        f"reference's count) {100 * roofline.train_mfu(cfg, tokens, med):.3f}"
        f"% | launches per step: {linear} {launches[linear] // steps}, "
        f"sddmm {launches['sddmm'] // steps} | max_memory_allocated "
        f"{peak / 2**30:.2f} GiB | {smi}")
    del params, state, batches
    torch.cuda.empty_cache()
    return launches, rec.shapes, med, peak


def phase_ssm_bf16(cfg, device, smi, *, batch, seq, n_slots, block_len,
                   max_len, checked):
    """Phase h3: one family in bf16 at full width (zamba2 on
    HYBRID_LAYERS layers, whisper's serving on WHISPER_SERVE_LAYERS
    decoder layers): the contiguous engine on the 8-request traffic
    in exec_mode fused (timed under the device-only profiler: tokens/s,
    dispatches, busy share) and sparse, each with its launches asserted
    per dispatch; then 3 steps of global AdamW in exec_mode fused and
    sparse (the Trainer; whisper's train step with seeded frames at
    WHISPER_TRAIN_BATCH): step ms, MFU from the reference's analytic
    count, the true parameter count, the peak. Every (M, K, N) the paths
    gave the linears' kernels must have been checked in phase h1. Returns
    each path's launch counts."""
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.models.common import tree_leaves
    name = cfg.name.replace("-", "_")
    lap = Laps()
    gen = torch.Generator(device=device)
    gen.manual_seed(125 + SSM_ARCHS.index(name))
    if cfg.family == "mamba_hybrid":
        cfg = dataclasses.replace(cfg, n_layers=HYBRID_LAYERS)
    if cfg.family == "xlstm":
        cfg = dataclasses.replace(cfg, n_layers=XLSTM_BF16_LAYERS)
    serve_layers = WHISPER_SERVE_LAYERS if cfg.family == "whisper" else \
        cfg.n_layers
    cfg16 = dataclasses.replace(cfg, n_layers=serve_layers,
                                param=dataclasses.replace(
                                    cfg.param, exec_mode="fused"))
    params, consts, n_params = ssm_init(cfg16, device, gen, "bf16")
    prompts, arrivals = traffic(cfg.vocab_size)
    kw = dict(n_slots=n_slots, max_len=max_len, block_len=block_len,
              new_tokens=16)
    per_dispatch = ssm_linear_calls(cfg16, decode=True)
    by_path = {}
    for mode, kernel, path in (
            ("fused", "sl_matmul", f"serve_contiguous_{name}"),
            ("sparse", "sparse_matmul", f"serve_contiguous_sparse_{name}")):
        with ShapeRecorder() as rec:
            by_path[path], _, _ = phase_engine_bf16(
                cfg16, params, consts, prompts, arrivals, device,
                exec_mode=mode, path=path, paged=False,
                profiled=mode == "fused",
                want_per_dispatch={kernel: per_dispatch}, **kw)
        check_ssm_coverage({kernel: rec.shapes[kernel]}, checked,
                           f"bf16 {arch(cfg16)} {mode} serving")
    say(f"engine bf16 {arch(cfg16)}: {per_dispatch} SLTrain linear launches "
        f"a dispatch (asserted), {n_params / 1e6:.1f} M params")
    lap(f"h3: {arch(cfg16)} init and serving")
    del params, consts
    torch.cuda.empty_cache()
    if cfg.family == "whisper":
        # one init (B = 0, as the Trainer's) for both modes' train steps
        params, consts = registry.get_api(cfg).init(
            dataclasses.replace(cfg16, n_layers=cfg.n_layers), 0,
            device=device)
        consts = ops.add_transposed_tiles(consts)
        n_params = sum(t.numel() for _, t in tree_leaves(params))
    for mode in ("fused", "sparse"):
        c = dataclasses.replace(cfg, param=dataclasses.replace(
            cfg.param, exec_mode=mode))
        path = f"train_{name}" if mode == "fused" else \
            f"train_sparse_{name}"
        if cfg.family == "whisper":
            launches, shapes, _, _ = phase_whisper_train_bf16(
                c, params, consts, device, smi, batch=WHISPER_TRAIN_BATCH,
                seq=seq, steps=SSM_TRAIN_STEPS)
        else:
            tr, state, launches, shapes, _, _ = phase_train_bf16(
                c, device, smi, batch=batch, seq=seq, steps=SSM_TRAIN_STEPS,
                save=False)
            n_params = sum(t.numel() for _, t in tree_leaves(state.params))
            del tr, state
        by_path[path] = launches
        check_ssm_coverage(shapes, checked, f"bf16 {arch(c)} {mode} training")
        torch.cuda.empty_cache()
    if cfg.family == "whisper":
        del params, consts
        torch.cuda.empty_cache()
    say(f"train bf16 {arch(cfg)}: {n_params / 1e6:.1f} M params (true count; "
        "the MFU above reads the reference's analytic count)")
    lap(f"h3: {arch(cfg)} training")
    return by_path


def representatives_ssm(cfgs, n_slots, batch, seq):
    """{kernel: {arch: the shape of its representative phase h1 case}}:
    each family's first timed projection at its timed training rows
    (sl_matmul, sddmm) and at decode rows (the sparse kernels)."""
    out = {"sl_matmul": {}, "sddmm": {}, "sparse_matmul": {},
           "quant_sparse_matmul": {}}
    for cfg in cfgs:
        name, tag = cfg.name.replace("-", "_"), cfg.name.split("-")[0]
        d_in, d_out, what = SSM_TIMED[name][0]
        m = ssm_rows(cfg, n_slots, batch, seq)[1][0]
        out["sl_matmul"][name] = f"{m}x{d_in}->{d_out} bfloat16 ({tag} {what})"
        out["sddmm"][name] = f"{m}x({d_in},{d_out}) bfloat16 ({tag} {what})"
        dec = f"{n_slots}x{d_in}->{d_out} bfloat16 ({tag})"
        out["sparse_matmul"][name] = dec + " f32 out"
        out["quant_sparse_matmul"][name] = dec
    return out


def run_ssm(device, smi, *, batch, seq, n_slots, block_len, max_len):
    """Phases h1 to h3; returns (phase h1's kernel rows, launch counts by
    path, representatives)."""
    from repro_torch.models import registry
    cfgs = [registry.get_config(a) for a in SSM_ARCHS]
    lap = Laps()
    rows, checked = check_kernels_ssm(device, cfgs, n_slots, batch, seq)
    lap("phase h1 (zamba2_7b, xlstm_350m, whisper_large_v3 kernels)")
    for cfg in cfgs:
        phase_parity_ssm(cfg, device, batch=batch, seq=seq, n_slots=n_slots,
                         block_len=block_len, max_len=max_len)
    lap("phase h2 (f32 parity on the depth cuts)")
    by_path = {}
    for cfg in cfgs:
        by_path.update(phase_ssm_bf16(cfg, device, smi, batch=batch, seq=seq,
                                      n_slots=n_slots, block_len=block_len,
                                      max_len=max_len, checked=checked))
    lap("phase h3 (bf16 serving and training)")
    return rows, by_path, representatives_ssm(cfgs, n_slots, batch, seq)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def run_serving(cfg, device, gen, n_slots, block_len, max_len, buckets,
                m_values):
    """Phases 3 to 5 on the serving paths (fused, sparse, quant; paged,
    then the contiguous cache); returns each path's launch counts from its
    bf16 run."""
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
    lap = Laps()
    shapes = {"fused": set(), "sparse": set(), "quant": set()}
    fused, b_reqs = phase_engine_f32(cfg32, params, consts, prompts,
                                     arrivals, device, **kw)
    shapes["fused"] |= fused
    shapes["sparse"] |= phase_sparse_f32(cfg32, params, consts, prompts,
                                         arrivals, b_reqs, device, **kw)
    lap("serving: f32 paged fused, sparse and dense")
    qparams, qconsts, dq, quant = phase_quant_f32(cfg32, params, consts,
                                                  prompts, arrivals, device,
                                                  **kw)
    shapes["quant"] |= quant
    lap("serving: calibration, artifact and f32 paged quant")
    contiguous, quant_launches = phase_contiguous_f32(
        cfg32, params, consts, qparams, qconsts, dq, prompts, device, **kw)
    del dq
    for mode, s in contiguous.items():
        shapes[mode] |= s
    lap("serving: f32 contiguous")

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
    lap("serving: bf16 paged, timed and profiled")
    # the contiguous cache in bf16: fused (its one run timed under the
    # device-only profiler) and sparse; quant's launches are its f32 run's
    by_path["serve_contiguous_quant"] = quant_launches
    for mode in ("fused", "sparse"):
        launches, s16, _ = phase_engine_bf16(
            cfg16, params16, consts, prompts, arrivals, device,
            exec_mode=mode, paged=False, profiled=mode == "fused", **kw)
        by_path[CONTIGUOUS_PATH[mode]] = launches
        shapes[mode] |= s16
    lap("serving: bf16 contiguous")
    for mode, kernel in (("fused", "sl_matmul"), ("sparse", "sparse_matmul"),
                         ("quant", "quant_sparse_matmul")):
        check_coverage(shapes[mode], m_values, buckets, kernel)
    return by_path


# ---------------------------------------------------------------------------
# phase dist: training on a device mesh, four ranks sharing the card
# ---------------------------------------------------------------------------

# llama_7b at full width on this many of its 32 layers, f32, DIST_STEPS
# steps from one init and one data stream, on one gloo world of DIST_WORLD
# ranks, each a process on the one card (gloo stages every collective
# through host memory; NCCL refuses two ranks on one device)
DIST_LAYERS = 2
DIST_STEPS = 3
DIST_WORLD = 4
# name: (mesh shape, axis names, exec_mode, update_mode, optimizer, fsdp,
# int8 pod compression), run in this order; a mesh of fewer ranks than
# the world runs on its first ranks while the others wait
DIST_RUNS = {
    "model 2, fused, AdamW": (
        (1, 2), ("data", "model"), "fused", "global", "adamw", False, False),
    "data 2 x model 2, fsdp, fused, AdamW": (
        (2, 2), ("data", "model"), "fused", "global", "adamw", True, False),
    "model 4, fused, AdamW": (
        (1, 4), ("data", "model"), "fused", "global", "adamw", False, False),
    "pod 4, int8 compression, fused, AdamW": (
        (4,), ("pod",), "fused", "global", "adamw", False, True),
    "data 2 x model 2, fsdp, per-layer 8-bit, fused": (
        (2, 2), ("data", "model"), "fused", "per_layer", "adam8bit", True,
        False),
    "model 2, dense, AdamW": (
        (1, 2), ("data", "model"), "dense", "global", "adamw", False, False),
    "model 2, sparse, AdamW": (
        (1, 2), ("data", "model"), "sparse", "global", "adamw", False, False),
}
# the bf16 run, timed: run 2's configuration, a warm-up step and a timed
# one (cut from 3 steps for the phase's time)
DIST_BF16 = "data 2 x model 2, fsdp, fused, AdamW"
DIST_BF16_STEPS = 2
# the kernels each run must launch (summed over its ranks)
DIST_KERNELS = {"fused": ("sl_matmul", "sddmm"),
                "sparse": ("sparse_matmul", "sddmm"), "dense": (),
                # and per-layer 8-bit AdamW in exec_mode fused
                "adam8bit": ("adam8bit",)}
# the int8 run (4) is held to the compressed step's plain version in one
# process (int8_one_process) at the f32 gates, and at step 1, from the
# same params, to the uncompressed run at INT8_TOL: each pod rounds its
# gradient once onto the shared grid (half a step, absmax/254, of each
# block), the sum is exact and divided by n_pods; a Gaussian block's
# absmax is ~3.5 times its rms, so an element's error is ~0.8% of the
# pods' rms gradient at most, and the norm moves far less. Later steps
# are not held to the uncompressed run: Adam's first steps scale a
# near-zero element's update to ~lr whatever its sign, so an int8
# rounding moves the trajectory by more than rounding does (6.3e-2 in
# the step-2 gradient norm on an H100)
INT8_TOL = 1e-2
# int8_psum on the card against its plain version: elements per rank (a
# ragged tail) with its first block all zero
INT8_ELEMS = (1 << 20) + 77


def dist_config(cfg, exec_mode, dtype="float32"):
    return dataclasses.replace(cfg, n_layers=DIST_LAYERS, dtype=dtype,
                               param=dataclasses.replace(
                                   cfg.param, exec_mode=exec_mode))


def dist_train(cfg, params, consts, mesh, *, update_mode, optimizer, fsdp,
               compression, batch, seq, device="cuda", steps=DIST_STEPS):
    """``steps`` Trainer steps of ``cfg`` from ``params`` (cloned) on
    ``mesh`` (None: one process): (loss, grad_norm, nonfinite) a step, the
    kernels' launches in the steps, the median later step's ms, the
    seconds before the first step, the peak device memory after init and
    the modelled collective bytes a step. (``device`` "cpu" rehearses it:
    no peak.)"""
    t0 = time.perf_counter()
    from repro_torch.models.common import tree_map
    from repro_torch.train.trainer import Trainer
    tc = train_config(cfg, steps=steps, batch=batch, seq=seq,
                      ckpt_dir=os.path.join(ROOT, "build",
                                            "chip_smoke_dist_ckpt"),
                      optimizer=optimizer, update_mode=update_mode)
    tc = dataclasses.replace(tc, sharding=dataclasses.replace(
        tc.sharding, fsdp=fsdp, pod_grad_compression=compression))
    cuda = torch.device(device).type == "cuda"
    tr = Trainer(tc, device=device, mesh=mesh, log_fn=lambda *a: None)
    tr.save = lambda *a, **k: None
    # a signal ends the run with its name instead of the Trainer's
    # checkpoint-and-exit(42)
    tr._install_signal_handlers = lambda: None
    state = tr.state_from(tree_map(lambda t: t.to(device, copy=True),
                                   params),
                          tree_map(lambda t: t.to(device), consts))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    setup = time.perf_counter() - t0
    tr.run(state=state)
    if cuda:
        torch.cuda.synchronize()
    hist = tr.metrics_history
    wire = sum(v["value"] for k, v in tr.obs.snapshot().items()
               if k.startswith("dist.collective_bytes"))
    return {"rows": [(h["loss"], h["grad_norm"], h["nonfinite"])
                     for h in hist],
            "launches": launch_counts(),
            "ms": statistics.median(h["dt"] for h in hist[1:]) * 1e3,
            "setup_s": setup,
            "peak": torch.cuda.max_memory_allocated() if cuda else 0,
            "wire": wire / len(hist)}


def int8_one_process(cfg, params, consts, *, batch, seq, n_pods, device):
    """The compressed step's math in one process, the plain version of run
    4: each pod's gradient of its rows (the batch's n_pods chunks), summed
    as ``psum_tree`` sums them (``int8_psum_plain`` on float leaves of
    1024 elements and more, exact elsewhere), divided by n_pods, the
    losses averaged, then the one-card AdamW update; (loss, grad_norm,
    nonfinite) a step."""
    from repro_torch.data.pipeline import SyntheticC4
    from repro_torch.dist import compression
    from repro_torch.kernels import ops
    from repro_torch.models import registry
    from repro_torch.models.common import tree_map
    from repro_torch.optim import optimizers
    from repro_torch.train import step as step_lib
    tc = train_config(cfg, steps=DIST_STEPS, batch=batch, seq=seq,
                      ckpt_dir="")
    opt = optimizers.make(tc.optim)
    loss_fn = step_lib.make_loss_fn(cfg, registry.get_api(cfg))
    p = tree_map(lambda t: t.to(device, copy=True), params)
    st = opt.init(p)
    consts = ops.add_transposed_tiles(consts)
    data = SyntheticC4(cfg.vocab_size, seq, batch, seed=tc.seed)

    def combine(*gs):
        if gs[0].is_floating_point() and gs[0].numel() >= 1024:
            return compression.int8_psum_plain(list(gs)) / n_pods
        return sum(gs[1:], gs[0]) / n_pods
    rows = []
    for _ in range(DIST_STEPS):
        toks = torch.from_numpy(data.next_batch()["tokens"]).to(device)
        per, losses = [], []
        for part in toks.chunk(n_pods):
            loss, _, g = step_lib._value_and_grad(loss_fn, p, consts,
                                                  {"tokens": part})
            per.append(g)
            losses.append(loss)
        grads = tree_map(combine, *per)
        del per
        p, st, stats = opt.update(grads, st, p)
        rows.append((float(sum(losses) / n_pods), float(stats["grad_norm"]),
                     0.0))
    return rows


def int8_case(rank, device):
    """Rank ``rank``'s summand of the int8_psum check: seeded, its first
    block all zero."""
    gen = torch.Generator(device=device)
    gen.manual_seed(100 + rank)
    x = torch.randn(INT8_ELEMS, generator=gen, device=device)
    x[:256] = 0
    return x


class CollectiveLog:
    """Counts, bytes (the tensors passed) and wall seconds of a rank's
    collectives (every one goes through ``dist.compat``'s
    ``all_reduce``, ``all_gather_into_tensor`` or
    ``reduce_scatter_tensor``), the card synchronized first so that its
    queued work is not counted as a collective's."""

    def __init__(self, compat, device):
        self.n, self.bytes, self.s = 0, 0, 0.0
        for name in ("all_reduce", "all_gather_into_tensor",
                     "reduce_scatter_tensor"):
            setattr(compat, name, self._timed(getattr(compat, name), device))

    def _timed(self, fn, device):
        def timed(*tensors, **kw):
            if device.type == "cuda":
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*tensors, **kw)
            if device.type == "cuda":
                torch.cuda.synchronize()
            self.s += time.perf_counter() - t
            self.n += 1
            self.bytes += sum(x.numel() * x.element_size() for x in tensors
                              if isinstance(x, torch.Tensor))
            return out
        return timed

    def since(self, mark):
        return {"n": self.n - mark[0], "bytes": self.bytes - mark[1],
                "s": self.s - mark[2]}

    def mark(self):
        return self.n, self.bytes, self.s


def dist_rank_runs(rank, world, init_path, base, batch, seq, device):
    """The world's work on one rank: int8_psum over the world, then each
    of DIST_RUNS of ``base`` (llama_7b) on its mesh (ranks outside a
    smaller mesh wait at the barrier), then DIST_BF16 in bf16. Each run's
    result carries its wall seconds and its collectives' (CollectiveLog)."""
    import torch.distributed as dist
    from repro_torch.dist import compat, compression
    from repro_torch.models.common import tree_map
    device = torch.device(device)
    log = CollectiveLog(compat, device)
    # the init stays in host memory: each run copies it to the card
    init = torch.load(init_path)
    out = {"int8": compression.int8_psum(
        int8_case(rank, device), dist.group.WORLD).cpu()}
    t0 = time.perf_counter()
    for name, (shape, names, mode, um, opt, fsdp, comp) in DIST_RUNS.items():
        size = int(np.prod(shape))
        mesh = compat.make_mesh(shape, names, ranks=range(size))
        if rank == 0:
            say(f"dist rank 0: {name} from {time.perf_counter() - t0:.1f} s")
        if mesh.member:
            mark, t1 = log.mark(), time.perf_counter()
            out[name] = dist_train(
                dist_config(base, mode), init["params"], init["consts"],
                mesh, update_mode=um, optimizer=opt, fsdp=fsdp,
                compression=comp, batch=batch, seq=seq, device=device)
            out[name].update(wall=time.perf_counter() - t1,
                             collectives=log.since(mark))
        dist.barrier()
    shape, names, mode, um, opt, fsdp, comp = DIST_RUNS[DIST_BF16]
    mesh = compat.make_mesh(shape, names, ranks=range(int(np.prod(shape))))
    params16 = tree_map(lambda t: t.to(torch.bfloat16), init["params"])
    del init["params"]
    if mesh.member:
        mark, t1 = log.mark(), time.perf_counter()
        out["bf16"] = dist_train(
            dist_config(base, mode, "bfloat16"), params16, init["consts"],
            mesh, update_mode=um, optimizer=opt, fsdp=fsdp,
            compression=comp, batch=batch, seq=seq, device=device,
            steps=DIST_BF16_STEPS)
        out["bf16"].update(wall=time.perf_counter() - t1,
                           collectives=log.since(mark))
    dist.barrier()
    return out


def dist_rank(rank, world, root, init_path, base, batch, seq, device,
              serve):
    """A rank's process: the gloo world through a FileStore under
    ``root``, phase dist's runs, then phase serve-mesh's
    (``serve_mesh_rank_runs`` on ``serve``, its (paths, configs)), its
    results pickled to ``root/rank<r>.pkl``. A rank that fails exits at
    once, so its peers' collectives fail instead of waiting."""
    import datetime
    import pickle
    import traceback
    import faulthandler
    import signal
    import torch.distributed as dist
    faulthandler.enable()
    # four processes share the card's memory: segments that grow in place
    # keep what one rank frees usable to it (set before its first CUDA
    # allocation)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")

    def on_signal(signum, frame):
        raise RuntimeError(f"rank {rank} got signal {signum}")
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, on_signal)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the ranks share the host's cores with each other and the parent
    torch.set_num_threads(2)
    if device == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=300))
    try:
        out = dist_rank_runs(rank, world, init_path, base, batch, seq, device)
        out["serve_mesh"] = serve_mesh_rank_runs(rank, *serve, device)
        result = ("ok", out)
    except Exception:
        result = ("error", traceback.format_exc())
    with open(os.path.join(root, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    if result[0] != "ok":
        os._exit(1)
    dist.destroy_process_group()


def start_dist_world(init_path, base, batch, seq, device, serve):
    """Spawn the DIST_WORLD ranks (they run while the caller goes on);
    :func:`join_dist_world` collects them."""
    import torch.multiprocessing as mp
    root = os.path.join(ROOT, "build", "chip_smoke_dist_world")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    return root, mp.start_processes(
        dist_rank, args=(DIST_WORLD, root, init_path, base, batch, seq,
                         device.type, serve),
        nprocs=DIST_WORLD, join=False, start_method="spawn")


def join_dist_world(world):
    """Wait for the ranks and collect their results; fail with a rank's
    traceback if one failed."""
    import pickle
    root, ctx = world
    try:
        while not ctx.join():
            pass
    except Exception as e:                # a rank exited non-zero
        failure = str(e)
    else:
        failure = None
    results, errors = [], []
    for r in range(DIST_WORLD):
        path = os.path.join(root, f"rank{r}.pkl")
        if not os.path.exists(path):
            errors.append((1, r, f"rank {r} left no result ({failure})"))
            continue
        with open(path, "rb") as f:
            status, value = pickle.load(f)
        if status != "ok":
            # a rank the harness stopped after another failed says so, as
            # does one whose peer's exit closed its connection: the cause
            # is the other rank's
            errors.append((2 * ("got signal" in value) + (
                "closed by peer" in value), r, f"rank {r} failed:\n{value}"))
        results.append(value)
    if errors or failure:
        errors.sort()
        first = errors[0] if errors else None
        others = [f"rank {e[1]}: {e[2].strip().splitlines()[-1]}"
                  for e in errors[1:]]
        fail(f"dist: {first[2] if first else failure}"
             + (f"\nthe other ranks: {others}" if others else ""))
    shutil.rmtree(root, ignore_errors=True)
    return results


def dist_local_case(gen, device, cfg, m, tp, dtype):
    """Rank 0's operands at a TP-``tp`` layout of llama_7b's gate/up
    projection (d_model → d_ff), m local tokens: x, B, this rank's
    columns of A and its column tiles (the island's forward and dx, and
    its sddmm), with the support's local entry count."""
    from repro_torch.kernels import ops
    d_in, d_out = cfg.d_model, cfg.d_ff
    x, B, A, v_t, rt, ct, scale = sl_case(
        gen, device, d_in, d_out, m, dtype, cfg.param.rank, cfg.param.delta,
        cfg.param.alpha, seed=d_in * 7 + d_out)
    nl = v_t.shape[1] // tp
    dl = d_out // tp
    loc = [t[:, :nl].contiguous() for t in (v_t, rt, ct)]
    A_l = A[:, :dl].contiguous()
    dy = torch.randn((m, dl), generator=gen, device=device).to(dtype)
    return (x, B, A_l, *loc, scale), dy, int((loc[0] != 0).sum()), \
        ops.transpose_tiles


def check_dist_kernels(timer, gen, device, cfg, *, batch, seq):
    """B1, B2, B6 and B3 at the local shapes of the dist phase's (model
    2) layout, against their plain versions, timed with their bounds:
    sl_matmul's forward on rank 0's column tiles of the d_ff projection
    (batch·seq tokens, 4096 → 11008/2) and its dx on Wᵀ's local tiles;
    sddmm on the local tiles; sparse_matmul's forward and dx on them (f32
    out); then adam8bit on the fsdp shard the per-layer 8-bit run of
    (data 2, model 2) updates in one piece, a layer's gate A (its 8-bit
    state rows split over the data ranks)."""
    from repro_torch.kernels import adam8bit as adk
    from repro_torch.kernels import ref
    m, tp = batch * seq, 2
    rows = []
    for dtype in DTYPES:
        args, dy, nnz, tT = dist_local_case(gen, device, cfg, m, tp, dtype)
        x, B, A_l, v_t, rt, ct, scale = args
        d_in, dl = x.shape[1], A_l.shape[1]
        tag = f"TP 2 local {dname(dtype)}"
        rows.append(time_sl_matmul(timer, f"{m}x{d_in}->{dl} {tag}", args,
                                   dtype))
        rows.append(time_sl_matmul(
            timer, f"dx {m}x{dl}->{d_in} {tag}",
            (dy, A_l.T.contiguous(), B.T.contiguous(), tT(v_t), tT(ct),
             tT(rt), scale), dtype))
        rows.append(time_sddmm(timer, f"{m}x({d_in},{dl}) {tag}", x, dy, rt,
                               ct, dtype, nnz))
        rows.append(time_sparse_train(
            timer, f"{m}x{d_in}->{dl} {tag}" + (
                " f32 out" if dtype != torch.float32 else ""),
            x, [v_t, rt, ct], dl, dtype, nnz, device))
        rows.append(time_sparse_train(
            timer, f"dx {m}x{dl}->{d_in} {tag}" + (
                " f32 out" if dtype != torch.float32 else ""),
            dy, [tT(v_t), tT(ct), tT(rt)], d_in, dtype, nnz, device))
        del args, dy, x, B, A_l, v_t, rt, ct
    clip = torch.tensor(CLIP, device=device)
    n = cfg.param.rank * cfg.d_ff
    seg = adam8bit_case(gen, device, n, torch.float32, torch.float32, True)
    label = f"fsdp shard of mlp/gate/A n={n} float32 wd 0.1"
    scalars, plain = adam8bit_steps(label, [seg], clip, device, 3)
    t_k = timer.ms(lambda: adk.adam8bit_group([seg], scalars, clip))
    t_p = timer.ms(lambda: ref.adam8bit_segment_ref(
        *plain[0], scalars, clip, decay=True))
    moved = adam8bit_bytes([seg]) + nbytes(scalars, clip)
    b, by = bound_ms(moved, ADAM8BIT_OPS * n, torch.float32)
    rows.append(dict(name="adam8bit", shape=label, n=n, dtype=torch.float32,
                     max_abs_err=0.0, tol=0.0, ms=t_k, plain_ms=t_p,
                     library_ms=None, bound_ms=b, bound_by=by))
    say(f"kernel adam8bit {label}: 3 steps bit-identical to the plain "
        f"version | kernel {t_k:.4f} ms, plain {t_p:.4f} ms, bound "
        f"{b:.4f} ms ({by}, {moved / 1e6:.1f} MB)")
    return rows


def representatives_dist(batch, seq, cfg):
    m, d, f = batch * seq, cfg.d_model, cfg.d_ff // 2
    tag = "TP 2 local bfloat16"
    return {"sl_matmul": f"{m}x{d}->{f} {tag}",
            "sddmm": f"{m}x({d},{f}) {tag}",
            "sparse_matmul": f"{m}x{d}->{f} {tag} f32 out",
            "adam8bit": f"fsdp shard of mlp/gate/A n="
                        f"{cfg.param.rank * cfg.d_ff} float32 wd 0.1"}


def run_dist(device, smi, *, batch, seq, base=None, qwen=None,
             beside=None):
    """Phase dist: llama_7b at full width on DIST_LAYERS layers trained on
    meshes of ranks that share the card, each run against the one-process
    run of its configuration on the card (check_pair; the int8 run at
    INT8_TOL); int8_psum over the world bit for bit against its plain
    version; the bf16 run of DIST_BF16 with each rank's step time, peak
    memory and modelled collective bytes; then phase serve-mesh in the
    same world (SERVE_MESH_RUNS against the one-process engine, tick for
    tick; SERVE_MESH_BF16 timed, its launches a dispatch and cache bytes
    asserted); then the kernels at both phases' local shapes. Returns
    (kernel rows, serve-mesh kernel rows, launches by path), with
    ``beside``'s (a callable that returns launches by path: phases whose
    checks are exact and which time no kernel, run in this process while
    the ranks run, after the references). (``base`` and ``qwen`` replace
    llama_7b and qwen2_5_32b, and a CPU ``device`` rehearses the phases
    up to the kernel checks, which need the card.)"""
    from repro_torch.configs import llama_7b, qwen2_5_32b
    from repro_torch.dist import compression
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map
    lap = Laps()
    base = llama_7b.CONFIG if base is None else base
    qwen = dataclasses.replace(qwen2_5_32b.CONFIG if qwen is None else qwen,
                               n_layers=SERVE_MESH_QWEN_LAYERS)
    cfg32 = dist_config(base, "fused")
    gen = torch.Generator(device=device)
    gen.manual_seed(30)
    params, consts = lm.init_lm(cfg32, seed=0, device=device)
    randomize_b(params, gen)
    init_path = os.path.join(ROOT, "build", "chip_smoke_dist_init.pt")
    os.makedirs(os.path.dirname(init_path), exist_ok=True)
    torch.save({"params": tree_map(lambda t: t.cpu(), params),
                "consts": tree_map(lambda t: t.cpu(), consts)}, init_path)
    lap(f"dist: init {arch(cfg32)} f32, written for the ranks")
    # the one-process references on the init (phase dist's runs, the
    # llama_7b engines, the quant calibration, written for the ranks) run
    # before the ranks start and are freed; phase serve-mesh's qwen2.5
    # model (7.5 GB in f32) is served beside the ranks, which wait for its
    # file, then the phases of ``beside``
    paths = {"llama": init_path, "qwen": os.path.join(
        ROOT, "build", "chip_smoke_serve_qwen.pt"), "quant": os.path.join(
        ROOT, "build", "chip_smoke_serve_quant.pt")}
    for key in ("qwen", "quant"):
        for p in (paths[key], paths[key] + ".failed"):
            if os.path.exists(p):
                os.remove(p)
    single = {}
    for name, (shape, names, mode, um, opt, fsdp, comp) in DIST_RUNS.items():
        if comp:
            single[name] = int8_one_process(
                dist_config(base, mode), params, consts, batch=batch,
                seq=seq, n_pods=int(np.prod(shape)), device=device)
            say(f"dist: one process, {name} (its plain version): (loss, "
                f"grad_norm, nonfinite) per step {single[name]}")
        key = (mode, um, opt)
        if key not in single:
            single[key] = dist_train(
                dist_config(base, mode), params, consts, None,
                update_mode=um, optimizer=opt, fsdp=False,
                compression=False, batch=batch, seq=seq, device=device)
            say(f"dist: one process, {mode}, {um}, {opt}: (loss, grad_norm, "
                f"nonfinite) per step {single[key]['rows']}")
    refs = serve_mesh_references("llama", cfg32, params, consts, device)
    quant_name = next(n for n, r in SERVE_MESH_RUNS.items()
                      if r[1] == "quant")
    refs[quant_name], quant_model = serve_mesh_quant(
        cfg32, params, consts, paths["quant"], device)
    del params, consts
    if device.type == "cuda":
        torch.cuda.empty_cache()
    lap("dist: one-process runs, serve-mesh's llama_7b engines and "
        "calibration")
    sm_gen = torch.Generator(device=device)
    sm_gen.manual_seed(31)
    cfgs = {"llama": cfg32, "qwen": serve_mesh_config(qwen, "fused"),
            "quant": cfg32}
    world = start_dist_world(init_path, base, batch, seq, device,
                             (paths, cfgs))
    try:
        qparams, qconsts = serve_mesh_init(cfgs["qwen"], device, sm_gen)
        refs.update(serve_mesh_references("qwen", cfgs["qwen"], qparams,
                                          qconsts, device))
        tmp = paths["qwen"] + ".tmp"
        torch.save({"params": tree_map(lambda t: t.cpu(), qparams),
                    "consts": tree_map(lambda t: t.cpu(), qconsts)}, tmp)
        os.replace(tmp, paths["qwen"])
    except BaseException:
        # the ranks wait for the model: tell them it will not come
        open(paths["qwen"] + ".failed", "w").close()
        raise
    del qparams, qconsts
    if device.type == "cuda":
        torch.cuda.empty_cache()
    lap(f"serve-mesh: {arch(cfgs['qwen'])} f32 init, one-process engine, "
        "written for the ranks, the ranks starting beside them")
    if beside is not None:
        by_path_beside = beside()
        lap("dist: the phases run beside the ranks")
    results = join_dist_world(world)
    lap(f"dist: the world of {DIST_WORLD} ranks (spawn, {len(DIST_RUNS)} "
        "f32 runs, the bf16 run)")
    xs = [int8_case(r, device) for r in range(DIST_WORLD)]
    want = compression.int8_psum_plain(xs).cpu()
    if not torch.equal(results[0]["int8"], want):
        fail("dist: int8_psum over the world differs from its plain version")
    if not all(torch.equal(r["int8"], want) for r in results):
        fail("dist: int8_psum gave the ranks different bits")
    say(f"dist: int8_psum of {INT8_ELEMS} f32 elements over {DIST_WORLD} "
        "gloo ranks (a ragged tail, a zero block) bit for bit equal to its "
        "plain version on every rank")
    by_path = {}
    for name, (shape, names, mode, um, opt, fsdp, comp) in DIST_RUNS.items():
        size = int(np.prod(shape))
        mine = [r[name] for r in results[:size]]
        if any(m["rows"] != mine[0]["rows"] for m in mine):
            fail(f"dist {name}: the ranks report different metrics "
                 f"{[m['rows'] for m in mine]}")
        launches = {k: sum(m["launches"][k] for m in mine)
                    for k in mine[0]["launches"]}
        want_k = DIST_KERNELS[mode] + (DIST_KERNELS["adam8bit"] if (
            opt, mode) == ("adam8bit", "fused") else ())
        if any(not launches[k] for k in want_k):
            fail(f"dist {name}: launched {launches}, expected {want_k}")
        path = "dist " + name
        by_path[path] = launches
        PATH_KERNELS[path] = want_k
        out = {name: mine[0]["rows"], "one process": single[(mode, um, opt)][
            "rows"]}
        if comp:
            # against the compressed step's plain version, and at step 1
            # (the same params) against the uncompressed run, INT8_TOL
            out["plain version"] = single[name]
            check_pair(out, name, "plain version")
            check_pair({k: v[:1] for k, v in out.items()}, name,
                       "one process", first=INT8_TOL)
        else:
            check_pair(out, name, "one process")
        c = mine[0]["collectives"]
        say(f"dist {name}: rank 0 {mine[0]['wall']:.1f} s for the run "
            f"({mine[0]['setup_s']:.1f} s to the first step, {DIST_STEPS} "
            f"steps), median step {mine[0]['ms']:.0f} ms; {c['n']} "
            f"collectives, "
            f"{c['bytes'] / 2**30:.2f} GiB through host memory, "
            f"{c['s']:.1f} s in them")
        say(f"dist {name} (mesh {dict(zip(names, shape))}): {DIST_STEPS} f32 "
            f"steps, (loss, grad_norm, nonfinite) {mine[0]['rows']} | "
            f"launches {launches}")
    mine = [r["bf16"] for r in results[:int(np.prod(DIST_RUNS[DIST_BF16][0]))]]
    for r, m in enumerate(mine):
        say(f"dist bf16 {DIST_BF16}, rank {r} of 4 ranks sharing one card "
            f"over gloo through host memory (not NCCL, not NVLink, not a "
            f"multi-card figure; {smi}): step {m['ms']:.1f} ms, peak "
            f"max_memory_allocated {m['peak'] / 2**30:.2f} GiB, modelled "
            f"dist.collective_bytes {m['wire'] / 2**20:.1f} MiB a step, "
            f"losses {[round(x[0], 4) for x in m['rows']]}")
    if any(not np.isfinite(x[0]) or x[2] for m in mine for x in m["rows"]):
        fail(f"dist bf16: {[m['rows'] for m in mine]}")
    by_path["dist bf16 " + DIST_BF16] = {k: sum(m["launches"][k]
                                               for m in mine)
                                        for k in mine[0]["launches"]}
    PATH_KERNELS["dist bf16 " + DIST_BF16] = DIST_KERNELS["fused"]
    if beside is not None:
        by_path.update(by_path_beside)
    lap("dist: checks")

    def loaded(key, mode="dense"):
        def load():
            tree = torch.load(paths[key], mmap=True)
            return (serve_mesh_config(cfgs[key], mode),
                    *(tree_map(lambda t: t.to(device), tree[k])
                      for k in ("params", "consts")))
        return load
    qcfg, qp, qc = quant_model
    by_path.update(serve_mesh_check(
        results, refs, {"llama": loaded("llama"), "qwen": loaded("qwen"),
                        "quant": lambda: (qcfg, dequantized(qp, qc), qc)},
        cfgs, device, smi))
    del quant_model, qp, qc
    for p in paths.values():
        os.remove(p)
    lap("serve-mesh: checks")
    if device.type != "cuda":
        return [], [], by_path
    torch.cuda.empty_cache()
    timer = Timer(device)
    rows = check_dist_kernels(timer, gen, device, base, batch=batch, seq=seq)
    lap("dist: kernels at the local shapes")
    rows_s = check_serve_mesh_kernels(timer, sm_gen, device, cfgs)
    del timer
    torch.cuda.empty_cache()
    lap("serve-mesh: kernels at the local shapes")
    return rows, rows_s, by_path


# ---------------------------------------------------------------------------
# phase serve-mesh: serving on a device mesh, in phase dist's world
# ---------------------------------------------------------------------------

# f32 runs on the dist world's ranks, each against the one-process engine
# on the card, tick for tick: name: (mesh shape (data, model), model,
# paged, exec_mode). "llama" is phase dist's llama_7b init (full width,
# DIST_LAYERS layers, B ~ U(±1)); "qwen" qwen2_5_32b at full width on
# SERVE_MESH_QWEN_LAYERS layers (GQA: 40 q heads on 8 kv heads, hd 128,
# its qkv bias drawn from the seed); "quant" the llama one calibrated
SERVE_MESH_RUNS = {
    "paged fused, model 2": ((1, 2), "llama", True, "fused"),
    "paged fused, model 4": ((1, 4), "llama", True, "fused"),
    "paged sparse, model 4": ((1, 4), "llama", True, "sparse"),
    "contiguous fused, data 2 x model 2": ((2, 2), "llama", False, "fused"),
    "qwen2.5 paged fused, model 4": ((1, 4), "qwen", True, "fused"),
    "paged quant, model 4": ((1, 4), "quant", True, "quant"),
}
SERVE_MESH_QWEN_LAYERS = 2
# the bf16 run, timed: llama_7b paged fused on (data 1, model 4)
SERVE_MESH_BF16 = ((1, 4), "llama", True, "fused")
SERVE_MESH_KW = dict(n_slots=4, max_len=128, block_len=16)
# the bf16 run's pools at a deployment's size: 8192 blocks of 16 tokens
# (4 GiB for llama_7b's 2 layers in one process): a rank allocates only
# its share, its construction's peak asserted below the whole
SERVE_MESH_BF16_BLOCKS = 8192
# what a rank's construction may allocate besides its cache shard: its
# column slices of the island linears and their transients
SERVE_MESH_BUILD_SLACK = 256 * 2**20
SERVE_MESH_TOKENS = 16
# the kernels each run must launch (summed over its ranks)
SERVE_MESH_KERNELS = {"fused": ("sl_matmul", "paged_attention",
                                "paged_prefill"),
                      "sparse": ("sparse_matmul", "paged_attention",
                                 "paged_prefill"),
                      "quant": ("quant_sparse_matmul", "paged_attention",
                                "paged_prefill")}


def serve_mesh_config(cfg, exec_mode, dtype="float32", n_layers=None):
    return dataclasses.replace(
        cfg, dtype=dtype, n_layers=n_layers or cfg.n_layers,
        param=dataclasses.replace(cfg.param, exec_mode=exec_mode))


def serve_mesh_engine(cfg, params, consts, *, paged, exec_mode, device,
                      mesh=None, lockstep=None, n_blocks=0):
    """One engine run of ``traffic`` (8 requests, SERVE_MESH_TOKENS new
    tokens each) on SERVE_MESH_KW (``n_blocks`` paged blocks, 0: enough
    for the slots): the paged cache through ``run_stream`` with prefix
    sharing and the paged kernels, the contiguous one drained token by
    token. With ``lockstep`` each dispatch's sampled tokens go through it
    (the ranks' all-gather and check). Returns the requests (uid, tokens,
    admit, first, done ticks), the wall seconds, each dispatch's (phase,
    tokens' shape, kernel launches), the cache's bytes on this rank and,
    on the card, the peak device memory its construction allocated."""
    from repro_torch.serve.engine import ServeEngine
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
    eng = ServeEngine(cfg, params, consts, paged=paged, exec_mode=exec_mode,
                      attn_kernel="paged" if paged else None,
                      prefix_sharing=paged, mesh=mesh, device=device,
                      n_blocks=n_blocks, **SERVE_MESH_KW)
    build_peak = torch.cuda.max_memory_allocated() - before if cuda else 0
    prompts, arrivals = traffic(cfg.vocab_size)
    per = []

    def wrap(fn, kind):
        def run(params, consts, tokens, *a, **k):
            before = launch_counts()
            out = fn(params, consts, tokens, *a, **k)
            if lockstep is not None:
                lockstep(out[0])
            per.append((kind, tuple(tokens.shape), {
                n: c - before[n] for n, c in launch_counts().items()
                if c != before[n]}))
            return out
        return run
    if paged:
        eng._prefill_fn = wrap(eng._prefill_fn, "prefill")
    eng._decode_fn = wrap(eng._decode_fn, "decode")
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if paged:
        reqs = [eng.submit(p, max_new_tokens=SERVE_MESH_TOKENS,
                           arrival=int(a)) for p, a in zip(prompts, arrivals)]
        eng.run_stream()
    else:
        reqs = [eng.submit(p, max_new_tokens=SERVE_MESH_TOKENS)
                for p in prompts]
        eng.run_until_drained()
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bad = [(r.uid, r.status, len(r.out)) for r in reqs if r.status != "done"
           or len(r.out) != SERVE_MESH_TOKENS
           or not all(0 <= t < cfg.vocab_size for t in r.out)]
    if bad:
        fail(f"serve-mesh {exec_mode}: requests not completed: {bad}")
    cache_bytes = sum(t.numel() * t.element_size() for t in
                      iter_leaves(eng.cache))
    return {"requests": [(r.uid, r.out, r.t_admit, r.t_first, r.t_done)
                         for r in reqs],
            "wall": wall, "dispatches": per, "cache_bytes": cache_bytes,
            "build_peak": build_peak}


def iter_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from iter_leaves(v)
    else:
        yield tree


class LocalShapes:
    """The attention heads each paged kernel call sees and the output
    width of each ``sl_matmul`` call while active (wrapping the
    ``kernels.ops`` functions; the kernel wrappers and their counts are
    untouched)."""

    def __enter__(self):
        from repro_torch.kernels import ops
        self.heads, self.widths = [], []
        self._orig = (ops.paged_attention, ops.paged_prefill_attention,
                      ops.sl_matmul)
        pa, pp, sl = self._orig

        def rec(fn, q_dim):
            def run(q, k_pool, *a, **k):
                self.heads.append((fn is pp, q.shape[q_dim], k_pool.shape[2]))
                return fn(q, k_pool, *a, **k)
            return run

        def sl_rec(x, B, A, *a, **k):
            self.widths.append(A.shape[-1])
            return sl(x, B, A, *a, **k)
        ops.paged_attention, ops.paged_prefill_attention, ops.sl_matmul = \
            rec(pa, 1), rec(pp, 2), sl_rec
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        (ops.paged_attention, ops.paged_prefill_attention,
         ops.sl_matmul) = self._orig


def serve_mesh_lockstep(mesh):
    """The check each rank runs on a dispatch's sampled tokens: all-gather
    them over the mesh and fail unless every rank sampled the same."""
    from repro_torch.dist import compat
    group = mesh.group(mesh.axis_names)

    def check(nxt):
        t = nxt.reshape(-1).to(torch.int32).contiguous()
        out = torch.empty(mesh.size * t.numel(), dtype=t.dtype,
                          device=t.device)
        compat.all_gather_into_tensor(out, t, group)
        if not bool((out.view(mesh.size, -1) == t[None]).all()):
            raise RuntimeError(f"serve-mesh: the ranks sampled different "
                               f"tokens: {out.view(mesh.size, -1).tolist()}")
    return check


def serve_mesh_rank_runs(rank, paths, cfgs, device):
    """The serve-mesh runs on one rank of phase dist's world (ranks
    outside a smaller mesh wait at the barrier): each of SERVE_MESH_RUNS
    in f32, the quant run last (its calibration is written by the parent
    while the world trains), then SERVE_MESH_BF16 in bf16, timed, with
    its per-dispatch launches, the heads each paged kernel call saw and
    the widths of the sl_matmul calls."""
    import torch.distributed as dist
    from repro_torch.dist import compat
    from repro_torch.models.common import tree_map
    device = torch.device(device)
    out = {}

    def load(key):
        path = paths[key]
        deadline = time.monotonic() + 600
        while not os.path.exists(path):
            if os.path.exists(path + ".failed") or \
                    time.monotonic() > deadline:
                raise RuntimeError(f"serve-mesh: {path} was not written")
            time.sleep(0.5)
        tree = torch.load(path, mmap=True)
        return [tree_map(lambda t: t.to(device), tree[k])
                for k in ("params", "consts")]
    cache, meshes = {}, {}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = compat.make_mesh(shape, ("data", "model"),
                                             ranks=range(int(np.prod(shape))))
        return meshes[shape]
    for name, (shape, model, paged, mode) in sorted(
            SERVE_MESH_RUNS.items(), key=lambda kv: kv[1][1] == "quant"):
        mesh = mesh_of(shape)
        if model not in cache:
            cache.clear()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            cache[model] = load(model)
        if mesh.member:
            if rank == 0:
                say(f"serve-mesh rank 0: {name}")
            out[name] = serve_mesh_engine(
                serve_mesh_config(cfgs[model], mode), *cache[model],
                paged=paged, exec_mode=mode, device=device, mesh=mesh,
                lockstep=serve_mesh_lockstep(mesh))
        dist.barrier()
    cache.clear()
    shape, model, paged, mode = SERVE_MESH_BF16
    params, consts = load(model)
    params = tree_map(lambda t: t.to(torch.bfloat16), params)
    mesh = mesh_of(shape)
    if mesh.member:
        cfg = serve_mesh_config(cfgs[model], mode, "bfloat16")
        with LocalShapes() as rec:
            out["bf16"] = serve_mesh_engine(
                cfg, params, consts, paged=paged, exec_mode=mode,
                device=device, mesh=mesh, lockstep=serve_mesh_lockstep(mesh),
                n_blocks=SERVE_MESH_BF16_BLOCKS)
        out["bf16"].update(
            peak=torch.cuda.max_memory_allocated() if device.type == "cuda"
            else 0, heads=sorted(set(rec.heads)),
            widths=sorted({w: rec.widths.count(w)
                           for w in rec.widths}.items()))
    del params, consts
    dist.barrier()
    return out


def serve_mesh_init(cfg, device, gen):
    """``cfg``'s params and consts (fused init, exec_mode fused tile
    consts) with B ~ U(±1) and every zero bias drawn U(±0.5) from ``gen``,
    so that the qkv bias is checked."""
    from repro_torch.models import lm
    params, consts = lm.init_lm(cfg, seed=0, device=device)
    randomize_b(params, gen)

    def bias(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                bias(v)
            elif k == "bias":
                v.uniform_(-0.5, 0.5, generator=gen)
    bias(params)
    return params, consts


def serve_mesh_references(model, cfg, params, consts, device):
    """The one-process engine on the card of each f32 serve-mesh run of
    ``model`` (its cfg, params and consts): {run name: requests}."""
    return {name: serve_mesh_engine(
        serve_mesh_config(cfg, mode), params, consts, paged=paged,
        exec_mode=mode, device=device)["requests"]
        for name, (_, m, paged, mode) in SERVE_MESH_RUNS.items()
        if m == model}


def serve_mesh_quant(cfg, params, consts, path, device):
    """Calibrate phase dist's llama_7b init (``quant.calibrate``, the
    error fold on the card), write it to ``path`` for the ranks, and
    serve it in one process: the quant run's reference requests."""
    from repro_torch.models.common import tree_map
    from repro_torch.quant import calibrate
    t0 = time.perf_counter()
    qcfg = serve_mesh_config(cfg, "quant")
    qp, qc, st = calibrate.calibrate_model(qcfg, params, consts)
    say(f"serve-mesh: calibrated {arch(qcfg)} ({st['n_matrices']} matrices) "
        f"in {time.perf_counter() - t0:.1f} s for the quant run")
    ref = serve_mesh_engine(qcfg, qp, qc, paged=True, exec_mode="quant",
                            device=device)["requests"]
    tmp = path + ".tmp"
    torch.save({"params": tree_map(lambda t: t.cpu(), qp),
                "consts": tree_map(lambda t: t.cpu(), qc)}, tmp)
    os.replace(tmp, path)
    return ref, (qcfg, qp, qc)


def serve_mesh_same(what, got, want, model, device):
    """A mesh run's requests against the one-process engine's, tick for
    tick; a token may differ only where the dense logits of ``model``
    ((cfg, params, consts), loaded on demand) have a top-2 gap below
    1e-4, and then that request is not compared further. Returns (equal
    tokens, ties)."""
    ties, same = [], 0
    for (uid, a, *ta), (_, b, *tb) in zip(got, want):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                cfg, params, consts = model()
                prompt = next(p for j, p in enumerate(
                    traffic(cfg.vocab_size)[0]) if j + 1 == uid)
                gap = top2_gap(cfg, params, consts, prompt + b[:i], device)
                if gap >= 1e-4:
                    fail(f"serve-mesh {what}: request {uid} token {i}: {x} "
                         f"vs {y} in one process, top-2 gap {gap:.3e} (not "
                         "a tie)")
                ties.append((uid, i, gap))
                break
            same += 1
        else:
            if ta != tb:
                fail(f"serve-mesh {what}: request {uid} ticks {ta} vs {tb} "
                     "in one process")
    return same, ties


def serve_mesh_check(results, refs, models, cfgs, device, smi):
    """The parent's checks of the serve-mesh runs: each f32 run's ranks
    agree, its tokens equal the one-process engine's tick for tick (a
    top-2 tie the only excuse), its kernels launched; the bf16 run's
    ranks agree, each prints its tokens/s, peak and cache bytes (a
    quarter of one process's pools, asserted) and its launches a
    dispatch are asserted. Returns the launches by path."""
    from repro_torch.models import lm
    by_path = {}
    cuda = device.type == "cuda"
    for name, (shape, model, paged, mode) in SERVE_MESH_RUNS.items():
        size = int(np.prod(shape))
        mine = [r["serve_mesh"][name] for r in results[:size]]
        if any(m["requests"] != mine[0]["requests"] for m in mine):
            fail(f"serve-mesh {name}: the ranks served different requests")
        same, ties = serve_mesh_same(name, mine[0]["requests"], refs[name],
                                     models[model], device)
        launches = {}
        for m in mine:
            for _, _, d in m["dispatches"]:
                for k, n in d.items():
                    launches[k] = launches.get(k, 0) + n
        want_k = SERVE_MESH_KERNELS[mode][:None if paged else 1]
        if cuda and any(not launches.get(k) for k in want_k):
            fail(f"serve-mesh {name}: launched {launches}, expected {want_k}")
        path = "serve mesh " + name
        by_path[path] = {k: launches.get(k, 0) for k in _wrappers()}
        PATH_KERNELS[path] = want_k
        total = sum(len(r[1]) for r in refs[name])
        say(f"serve-mesh {name} (mesh {dict(zip(('data', 'model'), shape))}"
            f", f32): tokens equal the one-process engine on {same}/{total}"
            + (f", ties (uid, token, top-2 gap) {ties}" if ties else "")
            + f", ticks equal; {len(mine[0]['dispatches'])} dispatches, "
            f"{mine[0]['wall']:.1f} s on rank 0; launches {launches}")
    shape, model, paged, mode = SERVE_MESH_BF16
    size = int(np.prod(shape))
    mine = [r["serve_mesh"]["bf16"] for r in results[:size]]
    if any(m["requests"] != mine[0]["requests"] for m in mine):
        fail("serve-mesh bf16: the ranks served different requests")
    cfg = serve_mesh_config(cfgs[model], mode, "bfloat16")
    full = lm.init_cache(cfg, SERVE_MESH_KW["n_slots"],
                         SERVE_MESH_KW["max_len"], paged=True,
                         block_len=SERVE_MESH_KW["block_len"],
                         n_blocks=SERVE_MESH_BF16_BLOCKS, device="meta")
    full_bytes = sum(t.numel() * t.element_size() for t in iter_leaves(full))
    tokens = sum(len(r[1]) for r in mine[0]["requests"])
    tp = shape[1]
    for r, m in enumerate(mine):
        if m["cache_bytes"] * tp != full_bytes:
            fail(f"serve-mesh bf16 rank {r}: cache {m['cache_bytes']} bytes, "
                 f"one process's pools {full_bytes}: not 1/{tp}")
        if cuda and m["build_peak"] > m["cache_bytes"] + \
                SERVE_MESH_BUILD_SLACK:
            fail(f"serve-mesh bf16 rank {r}: its construction's peak "
                 f"{m['build_peak']} bytes exceeds its cache shard "
                 f"{m['cache_bytes']} + {SERVE_MESH_BUILD_SLACK} (one "
                 f"process's pools {full_bytes})")
        say(f"serve-mesh bf16 {arch(cfg)} paged fused, rank {r} of {size} "
            f"ranks sharing one card over gloo through host memory (not "
            f"NCCL, not a multi-card figure; {smi}): {tokens / m['wall']:.1f} "
            f"tokens/s ({tokens} tokens in {m['wall']:.2f} s, each "
            f"dispatch's tokens all-gathered for the lockstep check), peak "
            f"max_memory_allocated {m['peak'] / 2**30:.2f} GiB, cache "
            f"{m['cache_bytes'] / 2**20:.2f} MiB (one process's pools "
            f"{full_bytes / 2**20:.2f} MiB, {SERVE_MESH_BF16_BLOCKS} blocks), "
            f"the construction's peak {m['build_peak'] / 2**20:.2f} MiB")
    L = cfg.n_layers
    local = cfg.n_heads // tp
    want_heads = [(False, local, cfg.n_kv_heads // tp),
                  (True, local, cfg.n_kv_heads // tp)]
    island = 4 * L          # wq, wk, wv, wo at d_model/TP columns
    whole = 3 * L           # gate, up (d_ff % (TP·128) != 0) and down
    launches = {}
    for r, m in enumerate(mine):
        if m["heads"] != want_heads:
            fail(f"serve-mesh bf16 rank {r}: paged kernel calls on (prefill, "
                 f"q heads, kv heads) {m['heads']}, expected {want_heads}")
        widths = dict(m["widths"])
        per = {w: n // len(m["dispatches"]) for w, n in widths.items()}
        if per != {cfg.d_model // tp: island, cfg.d_ff: 2 * L,
                   cfg.d_model: L}:
            fail(f"serve-mesh bf16 rank {r}: sl_matmul widths a dispatch "
                 f"{per}")
        for kind, shp, d in m["dispatches"]:
            want = {"sl_matmul": island + whole,
                    "paged_attention" if kind == "decode" else
                    "paged_prefill": L}
            if cuda and d != want:
                fail(f"serve-mesh bf16 rank {r}: a {kind} dispatch of "
                     f"{shp} launched {d}, expected {want}")
            for k, n in d.items():
                launches[k] = launches.get(k, 0) + n
    path = "serve mesh bf16 paged fused, model 4"
    by_path[path] = {k: launches.get(k, 0) for k in _wrappers()}
    PATH_KERNELS[path] = SERVE_MESH_KERNELS["fused"]
    say(f"serve-mesh bf16: every rank's dispatches launched one "
        f"paged_attention a layer at decode and one paged_prefill a layer at "
        f"prefill on {local} q heads over {cfg.n_kv_heads // tp} kv heads, "
        f"{island + whole} sl_matmul a dispatch ({island} on the rank's "
        f"{cfg.d_model // tp} columns); summed over ranks {launches}")
    return by_path


def local_tiles(t, tp):
    """Rank 0's column tiles of a tile array (nkt, nnt, cap) at TP
    ``tp``."""
    return t[:, :t.shape[1] // tp].contiguous()


def time_sparse_local(timer, label, x, sp, qp, d_out, nnz):
    """sparse_matmul (f32 y) and quant_sparse_matmul on a rank's column
    tiles: each against its plain version and its own rerun bit for bit,
    timed beside the plain version, the library call on the pre-densified
    S and its bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_decode as spk
    rows = []
    dtype = x.dtype
    for name, fn, plain, args, out, dense in (
            ("sparse_matmul", spk.sparse_matmul, ref.sparse_matmul_ref, sp,
             [torch.float32], ref._tile_dense(*sp)),
            ("quant_sparse_matmul", spk.quant_sparse_matmul,
             ref.quant_sparse_matmul_ref, qp, [],
             ref._tile_dense(*qp[:3]) * qp[3].reshape(1, -1))):
        lbl = label + (" f32 out" if out and dtype != torch.float32 else "")
        got = fn(x, *args, d_out, *out)
        want = plain(x, *args, d_out, *out)
        torch.cuda.synchronize()
        err = compare(f"{name} {lbl}", got, want, got.dtype)
        if not torch.equal(got, fn(x, *args, d_out, *out)):
            fail(f"{name} {lbl}: a rerun on the same inputs gave other bits")
        S = dense[:x.shape[1], :d_out].to(dtype).contiguous()
        lib, lib_name = matmul_call(x, S, *out)
        t_k = timer.ms(lambda: fn(x, *args, d_out, *out))
        t_p = timer.ms(lambda: plain(x, *args, d_out, *out))
        t_l = timer.ms(lib)
        moved = nbytes(x, got, *args[3:]) + support_bytes(nnz, *args[:3])
        b, by = bound_ms(moved, 2.0 * x.shape[0] * nnz, dtype)
        rows.append(dict(name=name, shape=lbl, max_abs_err=err,
                         tol=TOL[got.dtype], ms=t_k, plain_ms=t_p,
                         library_ms=t_l, bound_ms=b, bound_by=by))
        say(f"kernel {name} {lbl}: max_abs_err {err:.3e} | kernel "
            f"{t_k:.4f} ms, plain {t_p:.4f} ms, {lib_name} on dense S "
            f"{t_l:.4f} ms, bound {b:.4f} ms ({by})")
    return rows


# the decode linears on rank 0's column tiles: (label, d_in, full d_out,
# TP, model config key)
SERVE_MESH_LINEARS = (
    ("llama_7b wq..wo TP 4", 4096, 4096, 4, "llama"),
    ("llama_7b wq..wo TP 2", 4096, 4096, 2, "llama"),
    ("llama_7b gate/up TP 2", 4096, 11008, 2, "llama"),
    ("qwen2.5 wq/wo TP 4", 5120, 5120, 4, "qwen"))
# the paged kernels on a rank's heads: (label, kv heads, group)
SERVE_MESH_HEADS = (("llama_7b TP 2, 16 local heads", 16, 1),
                    ("llama_7b TP 4, 8 local heads", 8, 1),
                    ("qwen2.5 TP 4, 2 local kv heads, group 5", 2, 5))


def check_serve_mesh_kernels(timer, gen, device, cfgs):
    """B1, B6 and B7 at decode (the engine's 4 slots) on rank 0's column
    tiles of each of SERVE_MESH_LINEARS, and B4 and B5 (sq 32, the
    traffic's largest prefill bucket) on each of SERVE_MESH_HEADS (hd
    128), in bf16 and f32, against their plain versions, timed beside
    their bounds and library calls."""
    rows = []
    m = SERVE_MESH_KW["n_slots"]
    for label, d_in, d_out, tp, key in SERVE_MESH_LINEARS:
        pc = cfgs[key].param
        dl = d_out // tp
        sp, qp, _ = sparse_decode_case(gen, device, d_in, d_out, pc.delta,
                                       seed=d_in * 7 + d_out)
        sp = [local_tiles(t, tp) for t in sp]
        qp = [local_tiles(t, tp) for t in qp[:3]] + [
            qp[3][:qp[3].shape[0] // tp].contiguous()]
        nnz = int((sp[0] != 0).sum())
        for dtype in DTYPES:
            x, B, A, v_t, rt, ct, scale = sl_case(
                gen, device, d_in, d_out, m, dtype, pc.rank, pc.delta,
                pc.alpha, seed=d_in * 7 + d_out)
            args = (x, B, A[:, :dl].contiguous(), local_tiles(v_t, tp),
                    local_tiles(rt, tp), local_tiles(ct, tp), scale)
            tag = f"{m}x{d_in}->{dl} {dname(dtype)} serve mesh {label}"
            rows.append(time_sl_matmul(timer, tag, args, dtype))
            rows += time_sparse_local(timer, tag, x, sp, qp, dl, nnz)
            del x, B, A, v_t, rt, ct, args
    bl, bps = SERVE_MESH_KW["block_len"], SERVE_MESH_KW["max_len"] // 16
    hd = 128
    positions = [40 + 9 * s for s in range(m - 1)] + [-1]
    offsets = [16 * (s % 2) for s in range(m - 1)] + [0]
    for label, n_kv, group in SERVE_MESH_HEADS:
        label = f"serve mesh {label}, hd {hd}"
        kw = dict(scale=hd ** -0.5, softcap=0.0, window=0)
        for dtype in DTYPES:
            kp, vp, tbl, pos = attn_case(
                gen, device, dtype, n_slots=m, n_kv=n_kv, group=group, hd=hd,
                block_len=bl, bps=bps, positions=positions)
            q = torch.randn((m, n_kv, group, hd), generator=gen,
                            device=device).to(dtype)
            rows.append(decode_row(timer, label, q, kp, vp, tbl, pos, kw))
            rows.append(check_prefill(timer, gen, device, dtype, label, n_kv,
                                      group, hd, bl, bps, 32, offsets,
                                      positions, kw))
            del kp, vp
    return rows


def representatives_serve_mesh():
    tag = "4x4096->1024 bfloat16 serve mesh llama_7b wq..wo TP 4"
    heads = "serve mesh llama_7b TP 4, 8 local heads, hd 128"
    return {"sl_matmul": tag, "sparse_matmul": tag + " f32 out",
            "quant_sparse_matmul": tag,
            "paged_attention": f"{heads} bfloat16",
            "paged_prefill": f"sq=32 {heads} bfloat16"}


def main() -> int:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    from repro_torch.core import support
    # the phases init the same models again and again (each dtype, exec
    # mode and depth cut, each Trainer): each support is sampled once
    with support.keep_supports(KEEP_SUPPORT_BYTES):
        return run()


def run() -> int:
    from repro_torch.configs import llama_1b, llama_7b
    from repro_torch.core import support
    from repro_torch.kernels import build
    from repro_torch.models import lm

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
    # the llama_1b and llama_7b phases init at full depth: their supports
    # are sampled while nvcc builds and the first phases run
    ahead = {c.name: support.sample_ahead(lm.support_specs(
        dataclasses.replace(c, param=dataclasses.replace(
            c.param, exec_mode="fused"))), workers)
        for c, workers in ((llama_1b.CONFIG, AHEAD_1B_WORKERS),
                           (llama_7b.CONFIG, AHEAD_7B_WORKERS))}
    build.build()
    say(f"build: {len(build.SOURCES)} kernels with nvcc in "
        f"{time.perf_counter() - t0:.1f} s (parallel, sm_90a; the supports "
        f"of llama_1b and llama_7b sampled beside it by {AHEAD_1B_WORKERS} "
        f"and {AHEAD_7B_WORKERS} workers)")
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

    ahead[cfg.name]()
    by_path = run_serving(dataclasses.replace(cfg, n_layers=SERVE_LAYERS),
                          device, gen, n_slots, block_len, max_len,
                          buckets, m_values)
    torch.cuda.empty_cache()
    lap("llama_1b serving")

    phase_train_parity(dataclasses.replace(
        cfg, dtype="float32", n_layers=PARITY_LAYERS,
        param=dataclasses.replace(cfg.param, exec_mode="fused")), device,
        gen, batch=batch, seq=seq)
    torch.cuda.empty_cache()
    phase_baseline_parity(dataclasses.replace(
        cfg, dtype="float32", n_layers=PARITY_LAYERS), device, batch=batch,
        seq=seq)
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

    def beside():
        # the chaos drills and the comparison while the dist world runs:
        # their gates are exact (bit-identical relaunches, counted faults,
        # the comparison's losses), and they time no kernel
        sub = Laps()
        out = phase_chaos(device)
        torch.cuda.empty_cache()
        sub("chaos drills and profiler (llama_60m), beside the ranks")
        phase_comparison(device)
        sub("Table 2 comparison, beside the ranks")
        return out
    rows_d, rows_s, by_path_d = run_dist(device, smi, batch=batch, seq=seq,
                                         beside=beside)
    by_path.update(by_path_d)
    lap("dist and serve-mesh: llama_7b and qwen2.5 on meshes of ranks "
        "sharing the card, the chaos drills and the comparison beside them")
    recipe_cfg = dataclasses.replace(cfg16, n_layers=RECIPE_LAYERS)
    by_path["recipe_llama_1b"], recipe_ckpt, _, _ = phase_recipe(
        recipe_cfg, device, smi, batch=batch, seq=seq)
    torch.cuda.empty_cache()
    by_path["serve_quant_fallback"] = phase_quant_fallback(
        recipe_cfg, device, recipe_ckpt)
    shutil.rmtree(recipe_ckpt, ignore_errors=True)
    torch.cuda.empty_cache()
    by_path["recipe_llama_60m"] = phase_recipe_default(device)
    torch.cuda.empty_cache()
    lap("quant recipe and fallback")

    ahead[llama_7b.CONFIG.name]()
    rows_7b, by_path_7b = run_7b(device, smi, batch=batch, seq=seq,
                                 n_slots=n_slots, block_len=block_len,
                                 max_len=max_len, buckets=buckets,
                                 m_values=m_values)
    by_path.update(by_path_7b)
    lap("llama_7b phases")
    rows_g, by_path_g = run_families(device, smi, batch=batch, seq=seq,
                                     n_slots=n_slots, block_len=block_len,
                                     max_len=max_len, buckets=buckets,
                                     m_values=m_values)
    by_path.update(by_path_g)
    lap("gemma2_2b and paligemma_3b phases")
    rows_m, by_path_m, representative_m = run_moe(
        device, smi, batch=batch, seq=seq, n_slots=n_slots,
        block_len=block_len, max_len=max_len, buckets=buckets)
    by_path.update(by_path_m)
    lap("deepseek_moe_16b and qwen3_moe_235b phases")
    rows_h, by_path_h, representative_h = run_ssm(
        device, smi, batch=batch, seq=seq, n_slots=n_slots,
        block_len=block_len, max_len=max_len)
    by_path.update(by_path_h)
    lap("zamba2_7b, xlstm_350m and whisper_large_v3 phases")

    rows = sl_rows + at_rows + tr_rows + ad_rows + sp_rows + st_rows
    line = kernels_line(
        rows, by_path,
        representatives(cfg, rows, batch * seq, n_slots, buckets[-1]),
        rows_7b, representatives(llama_7b.CONFIG, rows_7b, batch * seq,
                                 n_slots, buckets[-1]),
        rows_g, representatives_families(rows_g, n_slots, batch * seq,
                                         buckets[-1]),
        rows_m, representative_m, rows_h, representative_h, rows_d,
        representatives_dist(batch, seq, llama_7b.CONFIG), rows_s,
        representatives_serve_mesh())
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
