"""The paged-attention kernels' wrappers: decode (``paged_attention``) and
chunked suffix prefill (``paged_prefill``) over the KV block pools, read
in place through the block table.

Replace the Pallas TPU kernels ``repro/kernels/paged_attention.py::
paged_attention`` and ``::paged_prefill`` with the CUDA kernels in
``csrc/paged_attention.cu`` (its header says what bounds them on the H100
and how the design meets that). Layouts are the reference's: q grouped by
kv head, pools ``(n_blocks, block_len, Hkv, hd)`` with block 0 the null
block. A tensor on the CPU runs the plain version
(:mod:`repro_torch.kernels.ref`); a CUDA tensor launches the kernel or
raises, never falls back.

The bf16 decode splits each slot's live keys across warps and, where the
card would sit idle, across blocks: :func:`decode_plan` picks its warps,
rows and splits from the shapes alone, and :func:`decode_launch` runs a
plan (a forced split count). The bf16 prefill runs on the tensor cores,
16 query rows a warp: :func:`prefill_plan` picks its warps per block and
row blocks from the shapes alone. f32 decode and prefill run the first
kernel (``attend``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.sparse_decode import counter_scratch

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256       # MAX_D * 32 in the kernel
MAX_BLOCK_LEN = 128      # MAX_T * 32 in the kernel
# the bf16 prefill on the tensor cores (csrc's prefill_tc_kernel)
TC_ROWS_PER_WARP = 16    # the m16 of mma.sync m16n8k16
TC_MAX_WARPS = 8
TC_KEYS_PER_STAGE = 64   # keys staged in shared memory at a time
TC_MAX_HEAD_DIM = 128
# the bf16 decode (csrc's decode_bf16_kernel)
DECODE_KEYS_PER_WARP = 32   # keys a warp stages at a time, one a lane
DECODE_MAX_WARPS = 4
DECODE_MAX_ROWS = 8         # query rows of a GQA group one block takes
# the H100's opt-in shared memory a block, less a margin for the kernel's
# static shared memory
DECODE_SMEM_MAX = 232448 - 1024
# the H100 SXM's SMs (the wrapper passes the card's own count) and the
# blocks a split aims to keep in flight on each
SMS = 132
BLOCKS_PER_SM = 2


class DecodePlan(NamedTuple):
    """The bf16 decode's grid: ``warps`` per block (each staging 32 keys
    at a time), ``rows`` of a GQA group a block takes (1, 2, 4 or 8),
    ``row_blocks`` blocks along the group, and ``splits`` blocks sharing
    each (slot, kv head, row block)'s live keys. With more than one split
    the wrapper allocates f32 partials and uses one int32 counter per
    (slot, kv head, row block)."""
    warps: int
    rows: int
    row_blocks: int
    splits: int


def decode_smem_bytes(warps: int, rows: int, hd: int) -> int:
    """The bf16 decode's dynamic shared memory (csrc's
    decode_smem_bytes): q's rows in f32, and per warp two buffers of K and
    V, 32 rows of hd + 8 bf16 each."""
    return 4 * rows * hd + warps * 2 * 2 * DECODE_KEYS_PER_WARP * \
        (hd + 8) * 2


def decode_most_splits(keys: int) -> int:
    """The most splits a decode over ``keys`` key positions takes: one
    per 32-key chunk."""
    return max(1, -(-keys // DECODE_KEYS_PER_WARP))


def decode_plan(n_slots: int, n_kv: int, group: int, hd: int, keys: int,
                sms: int = SMS, splits: Optional[int] = None) -> DecodePlan:
    """The bf16 decode's grid for q (n_slots, n_kv, group, hd) over a
    block table spanning ``keys`` key positions (blocks per slot ×
    block_len). One warp per 32 keys up to ``DECODE_MAX_WARPS`` (fewer
    where their buffers would not fit in shared memory); the group's rows
    in blocks of the next power of two up to ``DECODE_MAX_ROWS``; and the
    fewest splits of the keys that give ``BLOCKS_PER_SM`` blocks on each
    of ``sms`` SMs, while every split keeps one chunk for each warp (1 at
    the engine's short contexts). ``splits`` forces a count, 1 ..
    :func:`decode_most_splits` (timing, the card tests). Raises for a
    head_dim the kernel does not take (a multiple of 8, at most 256):
    there is no other bf16 path to fall back to."""
    if hd % 8 or not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"paged_attention: bf16 head_dim {hd} must be a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}")
    if min(n_slots, n_kv, group, keys) < 1:
        raise ValueError(f"paged_attention: empty decode ({n_slots} slots, "
                         f"{n_kv} kv heads, group {group}, {keys} keys)")
    rows = min(DECODE_MAX_ROWS, 1 << (group - 1).bit_length())
    row_blocks = -(-group // rows)
    chunks = decode_most_splits(keys)
    warps = min(DECODE_MAX_WARPS, chunks)
    while warps > 1 and decode_smem_bytes(warps, rows, hd) > \
            DECODE_SMEM_MAX:
        warps -= 1
    if splits is None:
        want = -(-BLOCKS_PER_SM * sms // (n_slots * n_kv * row_blocks))
        splits = max(1, min(chunks // warps, want))
    elif not 1 <= splits <= chunks:
        raise ValueError(f"paged_attention: splits {splits} not in "
                         f"1..{chunks}")
    return DecodePlan(warps, rows, row_blocks, splits)


class PrefillPlan(NamedTuple):
    """The bf16 prefill's grid for sq * group query rows per (slot, kv
    head): ``warps`` per block (16 rows each), ``row_blocks`` blocks, and
    the rows of the last m16 tiles past the end, which the kernel masks
    and never stores."""
    warps: int
    row_blocks: int
    masked_rows: int


def prefill_plan(sq: int, group: int, hd: int) -> PrefillPlan:
    """All sq * group rows of a (slot, kv head) in one block, one warp per
    16 of them, up to ``TC_MAX_WARPS``; more rows take more blocks. Raises
    for a head_dim the MMA path does not take (a multiple of 16, at most
    ``TC_MAX_HEAD_DIM``): there is no other bf16 path to fall back to."""
    if hd % 16 or not 0 < hd <= TC_MAX_HEAD_DIM:
        raise ValueError(f"paged_prefill: bf16 head_dim {hd} must be a "
                         f"multiple of 16 up to {TC_MAX_HEAD_DIM}")
    rows = sq * group
    warps = max(1, min(TC_MAX_WARPS, -(-rows // TC_ROWS_PER_WARP)))
    per_block = warps * TC_ROWS_PER_WARP
    row_blocks = max(1, -(-rows // per_block))
    return PrefillPlan(warps, row_blocks, row_blocks * per_block - rows)


def _lib():
    lib = build.library("paged_attention")
    if lib.paged_attention_launch.argtypes is None:
        lib.paged_attention_launch.argtypes = \
            [_P] * 9 + [_I] * 6 + [_F, _F] + [_I] * 6 + [_P]
        lib.paged_attention_launch.restype = _I
        lib.paged_prefill_launch.argtypes = \
            [_P] * 6 + [_I] * 7 + [_F, _F, _I, _I, _I, _I, _P]
        lib.paged_prefill_launch.restype = _I
    return lib


def _check(what, q, k_pool, v_pool, block_table, pos, n_slots, n_kv, hd):
    if q.dtype not in _DTYPES:
        raise TypeError(f"{what}: q dtype {q.dtype} not in {list(_DTYPES)}")
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape or \
            tuple(k_pool.shape[2:]) != (n_kv, hd):
        raise ValueError(f"{what}: pools {tuple(k_pool.shape)} / "
                         f"{tuple(v_pool.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"{what}: pool dtypes must match q ({q.dtype})")
    if hd > MAX_HEAD_DIM or k_pool.shape[1] > MAX_BLOCK_LEN:
        raise ValueError(f"{what}: head_dim {hd} > {MAX_HEAD_DIM} or "
                         f"block_len {k_pool.shape[1]} > {MAX_BLOCK_LEN}")
    if block_table.dim() != 2 or block_table.shape[0] != n_slots or \
            block_table.dtype != torch.int32:
        raise ValueError(f"{what}: block_table must be int32 (n_slots, "
                         f"bps), got {block_table.dtype} "
                         f"{tuple(block_table.shape)}")
    if tuple(pos.shape) != (n_slots,) or pos.dtype != torch.int32:
        raise ValueError(f"{what}: positions/offsets must be int32 "
                         f"({n_slots},), got {pos.dtype} {tuple(pos.shape)}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_table", block_table), ("positions", pos)):
        if t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def paged_attention(q, k_pool, v_pool, block_table, positions, *,
                    scale: float, softcap: float = 0.0, window: int = 0):
    """Decode attention, one query token per slot. q (n_slots, Hkv, group,
    hd); pools (n_blocks, block_len, Hkv, hd); block_table (n_slots, bps)
    int32; positions (n_slots,) int32. Returns (n_slots, Hkv, group, hd)
    in q.dtype; idle slots (all-null table rows) give exact zeros. bf16
    runs the split decode on :func:`decode_plan`'s grid and takes a
    head_dim that is a multiple of 8; f32 takes any up to 256."""
    if q.device.type == "cpu":
        return ref.paged_attention_ref(q, k_pool, v_pool, block_table,
                                       positions, scale=scale,
                                       softcap=softcap, window=window)
    _check_decode(q, k_pool, v_pool, block_table, positions)
    plan = None
    if q.dtype == torch.bfloat16:
        n_slots, n_kv, group, hd = q.shape
        plan = decode_plan(n_slots, n_kv, group, hd,
                           block_table.shape[1] * k_pool.shape[1],
                           torch.cuda.get_device_properties(
                               q.device).multi_processor_count)
    return _decode(plan, q, k_pool, v_pool, block_table, positions, scale,
                   softcap, window)


def decode_launch(plan: DecodePlan, q, k_pool, v_pool, block_table,
                  positions, *, scale: float, softcap: float = 0.0,
                  window: int = 0):
    """The bf16 decode kernel on ``plan`` for CUDA operands that
    :func:`paged_attention` accepts; it counts one launch.
    :func:`paged_attention` runs the plan of the shapes; a caller that
    times or tests a split count passes ``decode_plan(..., splits=s)``."""
    _check_decode(q, k_pool, v_pool, block_table, positions)
    n_slots, n_kv, group, hd = q.shape
    if q.dtype != torch.bfloat16 or plan != decode_plan(
            n_slots, n_kv, group, hd,
            block_table.shape[1] * k_pool.shape[1], splits=plan.splits):
        raise ValueError(f"paged_attention: plan {plan} is not one for a "
                         f"{q.dtype} decode of q {tuple(q.shape)}")
    return _decode(plan, q, k_pool, v_pool, block_table, positions, scale,
                   softcap, window)


def _check_decode(q, k_pool, v_pool, block_table, positions):
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    n_slots, n_kv, group, hd = q.shape
    _check("paged_attention", q, k_pool, v_pool, block_table, positions,
           n_slots, n_kv, hd)
    # 16-byte cp.async of K/V rows
    if q.dtype == torch.bfloat16 and (k_pool.data_ptr() % 16 or
                                      v_pool.data_ptr() % 16):
        raise ValueError("paged_attention: bf16 pools must start on "
                         "16-byte bounds")


def _decode(plan, q, k_pool, v_pool, block_table, positions, scale,
            softcap, window):
    """Launch the decode (``plan`` None: f32's ``attend``) into a new
    output, with the plan's partials and counters as scratch; raise if
    the launch returned a CUDA error, else count it."""
    n_slots, n_kv, group, hd = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    warps, rows, row_blocks, splits = plan or (0, 0, 0, 1)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        acc = ml = counter = None         # held until the launch is queued
        if splits > 1:
            n_rows = n_slots * n_kv * group
            acc = torch.empty((splits, n_rows, hd), dtype=torch.float32,
                              device=q.device)
            ml = torch.empty((splits, n_rows, 2), dtype=torch.float32,
                             device=q.device)
            counter = counter_scratch(q.device, stream,
                                      n_slots * n_kv * row_blocks)
        ptr = lambda t: None if t is None else t.data_ptr()
        err = lib.paged_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), positions.data_ptr(), out.data_ptr(),
            ptr(acc), ptr(ml), ptr(counter), n_slots, n_kv, group, hd,
            k_pool.shape[1], block_table.shape[1], float(scale),
            float(softcap), int(window), warps, rows, row_blocks, splits,
            _DTYPES[q.dtype], stream)
    build.check(lib, err, "paged_attention")
    paged_attention.launches += 1
    return out


def paged_prefill(q, k_pool, v_pool, block_table, offsets, *,
                  scale: float, softcap: float = 0.0, window: int = 0):
    """Chunked suffix prefill. q (n_slots, sq, Hkv, group, hd), query i of
    slot s at absolute position offsets[s] + i, the chunk's own K/V
    already scattered into the pools. Returns (n_slots, sq, Hkv, group,
    hd) in q.dtype; rows with nothing to attend give exact zeros. bf16
    runs on the tensor cores and takes a head_dim that is a multiple of
    16 up to 128 (:func:`prefill_plan`); f32 takes any up to 256."""
    if q.device.type == "cpu":
        return ref.paged_prefill_ref(q, k_pool, v_pool, block_table,
                                     offsets, scale=scale, softcap=softcap,
                                     window=window)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill: unsupported device {q.device}")
    n_slots, sq, n_kv, group, hd = q.shape
    _check("paged_prefill", q, k_pool, v_pool, block_table, offsets,
           n_slots, n_kv, hd)
    warps = row_blocks = 0
    if q.dtype == torch.bfloat16:
        warps, row_blocks, _ = prefill_plan(sq, group, hd)
        # 16-byte cp.async of K/V rows, 4-byte loads and stores of q/out
        if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16 or \
                q.data_ptr() % 4:
            raise ValueError("paged_prefill: bf16 pools must start on "
                             "16-byte bounds and q on 4-byte bounds")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_prefill_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), offsets.data_ptr(), out.data_ptr(),
            n_slots, sq, n_kv, group, hd, k_pool.shape[1],
            block_table.shape[1], float(scale), float(softcap), int(window),
            warps, row_blocks, _DTYPES[q.dtype], stream)
    build.check(lib, err, "paged_prefill")
    paged_prefill.launches += 1
    return out


paged_attention.launches = 0
paged_prefill.launches = 0
