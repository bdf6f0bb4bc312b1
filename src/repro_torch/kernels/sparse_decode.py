"""The sparse-decode kernels' wrappers: the sparse term of SLTrain's
factored decode, y = x @ S (``exec_mode="sparse"``) and y = x @ dequant(S)
(``exec_mode="quant"``).

Replace the Pallas TPU kernels ``repro/kernels/sparse_decode.py::
sparse_matmul`` and ``::quant_sparse_matmul`` with the CUDA kernels in
``csrc/sparse_decode.cu`` (its header says what bounds them on the H100 and
how the design meets that). A tensor on the CPU runs the plain version
(:func:`repro_torch.kernels.ref.sparse_matmul_ref`,
:func:`~repro_torch.kernels.ref.quant_sparse_matmul_ref`); a CUDA tensor
launches the kernel or raises, never falls back. Each wrapper counts its
launches in ``.launches``.

Both kernels split the k-tiles of each n-tile across blocks: :func:`plan`
picks the split count and the scratch it needs from the shapes and the
card's SM count alone, and :func:`launch` (``sparse_matmul``) and
:func:`quant_launch` (``quant_sparse_matmul``) run a plan.

:func:`sparse_matmul_grouped` and :func:`quant_sparse_matmul_grouped` run
E products of one shape (an MoE layer's experts, stacked on a leading
axis) in one launch, the expert folded into the grid's z with its split:
the counterpart of the TPU kernels batched under the reference's vmap over
the expert stack. Each expert keeps the single product's plan, so the
result is the bits of a loop of single launches; the plain version is
that loop over the single plain version. A single product is the
kernels' case E = 1 of the same C entry point.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.support import TILE
from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the H100 SXM's SMs; the wrapper passes the card's own count
SMS = 132
# blocks the split aims to keep in flight on each SM (a block takes 66 to
# 80 KB of shared memory, so two or three fit)
BLOCKS_PER_SM = 2


class Plan(NamedTuple):
    """A ``sparse_matmul`` or ``quant_sparse_matmul`` call's grid and
    scratch: blocks of
    ``rows_per_block`` rows of x (4 up to 4 rows, 8 up to 8, else 32),
    ``row_blocks`` of them per n-tile, ``splits`` blocks sharing each
    n-tile's k-tiles; with more than one split, the f32 partials (splits,
    M, N) and one int32 counter per (row block, n-tile)."""
    rows_per_block: int
    row_blocks: int
    n_tiles: int
    splits: int
    partial: Optional[Tuple[int, int, int]]
    counters: int

    @property
    def blocks(self) -> int:
        return self.n_tiles * self.row_blocks * self.splits

    @property
    def partial_bytes(self) -> int:
        return 4 * self.partial[0] * self.partial[1] * self.partial[2] \
            if self.partial else 0


def k_tiles(plan: Plan, nkt: int, split: int) -> range:
    """The k-tiles split ``split`` of a plan sums (the kernel's own
    formula): every k-tile of an n-tile falls in exactly one split."""
    return range(split * nkt // plan.splits,
                 (split + 1) * nkt // plan.splits)


def plan(m: int, k: int, n: int, sms: int = SMS,
         splits: Optional[int] = None) -> Plan:
    """The grid for x (m, k) @ S (k, n): the fewest splits of the
    ceil(k/128) k-tiles that give ``BLOCKS_PER_SM`` blocks on each of
    ``sms`` SMs, at most one split per k-tile, and one where the row
    blocks and n-tiles already give that many. ``splits`` forces a
    count (timing, the card tests)."""
    nkt, nnt = -(-k // TILE), -(-n // TILE)
    rows = 4 if m <= 4 else 8 if m <= 8 else 32
    row_blocks = -(-m // rows)
    if splits is None:
        want = -(-BLOCKS_PER_SM * sms // max(1, nnt * row_blocks))
        splits = max(1, min(nkt, want))
    elif not 1 <= splits <= max(1, nkt):
        raise ValueError(f"sparse decode: splits {splits} not in 1.."
                         f"{max(1, nkt)}")
    many = splits > 1
    return Plan(rows, row_blocks, nnt, splits,
                (splits, m, n) if many else None,
                nnt * row_blocks if many else 0)


def _lib():
    lib = build.library("sparse_decode")
    if lib.sparse_matmul_launch.argtypes is None:
        lib.sparse_matmul_launch.argtypes = [_P] * 7 + [_I] * 11 + [_P]
        lib.sparse_matmul_launch.restype = _I
        lib.quant_sparse_matmul_launch.argtypes = [_P] * 8 + [_I] * 10 + [_P]
        lib.quant_sparse_matmul_launch.restype = _I
    return lib


# int32 counters per (device, stream): zeroed when allocated, and every
# launch (this module's kernels and the split bf16 decode's) leaves them
# at zero, so launches in one stream's order can share them
_counters = {}


def counter_scratch(device, stream: int, n: int):
    """At least ``n`` int32 zeros on ``device`` for kernels that count
    finished blocks and leave the counters at zero, shared by the
    launches on ``stream``."""
    key = (device, stream)
    c = _counters.get(key)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _counters[key] = c
    return c


def _check(what, x, n, tiles):
    """Raise on what the kernel does not take: x (M, K) f32/bf16, or (E,
    M, K) for a grouped call, and the tile arrays ((name, tensor, dtype,
    shape) entries, each with x's leading E) on x's device, contiguous,
    shaped for ceil(K/128) x ceil(n/128) tiles."""
    grouped = what.endswith("_grouped")
    if x.dim() != 2 + grouped:
        want = "(E, M, K)" if grouped else "(M, K)"
        raise ValueError(f"{what}: x must be {want}, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: x dtype {x.dtype} not in {list(_DTYPES)}")
    k = x.shape[-1]
    stack = tuple(x.shape[:1]) if grouped else ()
    lead = stack + (-(-k // TILE), -(-n // TILE))
    cap = tiles[0][1].shape[-1]
    for name, t, dt, shape in tiles:
        want = stack + shape if shape is not None else lead + (cap,)
        if tuple(t.shape) != want or t.dtype != dt:
            raise ValueError(f"{what}: {name} must be {dt} {want}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("x", x),) + tuple((nm, t) for nm, t, _, _ in tiles):
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _sms(x) -> int:
    return torch.cuda.get_device_properties(x.device).multi_processor_count


def sparse_matmul(x, v_t, rows_t, cols_t, n: int, out_dtype=None):
    """y = x @ S for x (M, K) and S (K, n) in tile-CSR form: v_t f32,
    rows_t/cols_t int32, each (ceil(K/128), ceil(n/128), cap). K and n
    need not be multiples of 128. f32 accumulation (one chain per split of
    K, the splits added in order), one final rounding to ``out_dtype``:
    x.dtype by default, or f32 (no rounding) for a caller that adds y to
    other f32 terms first."""
    if x.device.type == "cpu":
        return ref.sparse_matmul_ref(x, v_t, rows_t, cols_t, n, out_dtype)
    out_dtype = _check_sparse(x, v_t, rows_t, cols_t, n, out_dtype)
    return _run(plan(x.shape[0], x.shape[1], n, _sms(x)), sparse_matmul, x,
                (v_t, rows_t, cols_t), n, out_dtype)


def sparse_matmul_grouped(x, v_t, rows_t, cols_t, n: int, out_dtype=None):
    """y (E, M, n) = x[e] @ S[e] for a stack of E products of one shape:
    x (E, M, K), v_t f32 and rows_t/cols_t int32 (E, ceil(K/128),
    ceil(n/128), cap). On the card one launch of :func:`sparse_matmul`'s
    kernel on the plan of one (M, K, n) product; on the CPU a loop of the
    plain version."""
    if x.device.type == "cpu":
        return torch.stack([ref.sparse_matmul_ref(*t, n, out_dtype)
                            for t in zip(x, v_t, rows_t, cols_t)])
    out_dtype = _check_sparse(x, v_t, rows_t, cols_t, n, out_dtype,
                              "sparse_matmul_grouped")
    return _run(_grouped_plan("sparse_matmul_grouped", x, n),
                sparse_matmul_grouped, x, (v_t, rows_t, cols_t), n,
                out_dtype)


def launch(p: Plan, x, v_t, rows_t, cols_t, n: int, out_dtype=None):
    """The ``sparse_matmul`` kernel on plan ``p`` for CUDA operands that
    :func:`sparse_matmul` accepts; it counts one launch.
    :func:`sparse_matmul` runs the plan of the shapes; a caller that times
    or tests a split count passes ``plan(..., splits=s)``."""
    out_dtype = _check_sparse(x, v_t, rows_t, cols_t, n, out_dtype)
    _check_plan("sparse_matmul", p, x, n)
    return _run(p, sparse_matmul, x, (v_t, rows_t, cols_t), n, out_dtype)


def _check_sparse(x, v_t, rows_t, cols_t, n, out_dtype,
                  what="sparse_matmul"):
    """Raise on what the kernel does not take; returns y's dtype."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if out_dtype not in (x.dtype, torch.float32):
        raise TypeError(f"{what}: y in {out_dtype} for x in "
                        f"{x.dtype}; y is x's dtype or float32")
    _check(what, x, n, (
        ("v_t", v_t, torch.float32, None),
        ("rows_t", rows_t, torch.int32, None),
        ("cols_t", cols_t, torch.int32, None)))
    return out_dtype


def quant_sparse_matmul(x, qv_t, rows_q, cols_q, qscale, n: int):
    """y = x @ dequant(S) in x.dtype for the int8 tile-CSR layout
    (repro_torch.quant.layout): qv_t int8 codes, rows_q/cols_q int16
    tile-local indices, each (ceil(K/128), ceil(n/128), cap), and qscale
    f32 (ceil(n/128), 128) per-output-channel scales. Each value is its
    code times its column's scale in f32; f32 accumulation (one chain per
    split of K, the splits added in order), one final rounding."""
    if x.device.type == "cpu":
        return ref.quant_sparse_matmul_ref(x, qv_t, rows_q, cols_q, qscale,
                                           n)
    _check_quant(x, qv_t, rows_q, cols_q, qscale, n)
    return _run(plan(x.shape[0], x.shape[1], n, _sms(x)),
                quant_sparse_matmul, x, (qv_t, rows_q, cols_q, qscale), n)


def quant_sparse_matmul_grouped(x, qv_t, rows_q, cols_q, qscale, n: int):
    """y (E, M, n) = x[e] @ dequant(S[e]) in x.dtype for a stack of E
    products of one shape: x (E, M, K), qv_t int8 and rows_q/cols_q int16
    (E, ceil(K/128), ceil(n/128), cap), qscale f32 (E, ceil(n/128), 128).
    On the card one launch of :func:`quant_sparse_matmul`'s kernel on the
    plan of one (M, K, n) product; on the CPU a loop of the plain
    version."""
    if x.device.type == "cpu":
        return torch.stack([ref.quant_sparse_matmul_ref(*t, n) for t in
                            zip(x, qv_t, rows_q, cols_q, qscale)])
    _check_quant(x, qv_t, rows_q, cols_q, qscale, n,
                 "quant_sparse_matmul_grouped")
    return _run(_grouped_plan("quant_sparse_matmul_grouped", x, n),
                quant_sparse_matmul_grouped, x,
                (qv_t, rows_q, cols_q, qscale), n)


def quant_launch(p: Plan, x, qv_t, rows_q, cols_q, qscale, n: int):
    """The ``quant_sparse_matmul`` kernel on plan ``p`` for CUDA operands
    that :func:`quant_sparse_matmul` accepts; it counts one launch. A
    caller that times or tests a split count passes ``plan(...,
    splits=s)``."""
    _check_quant(x, qv_t, rows_q, cols_q, qscale, n)
    _check_plan("quant_sparse_matmul", p, x, n)
    return _run(p, quant_sparse_matmul, x, (qv_t, rows_q, cols_q, qscale), n)


def _check_quant(x, qv_t, rows_q, cols_q, qscale, n,
                 what="quant_sparse_matmul"):
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    _check(what, x, n, (
        ("qv_t", qv_t, torch.int8, None),
        ("rows_q", rows_q, torch.int16, None),
        ("cols_q", cols_q, torch.int16, None),
        ("qscale", qscale, torch.float32, (-(-n // TILE), TILE))))


def _grouped_plan(what, x, n: int) -> Plan:
    """The plan of one of the stack's (M, K, n) products; raise where the
    grid's z (experts x splits) would pass its limit of 65535."""
    n_exp, m, k = x.shape
    p = plan(m, k, n, _sms(x))
    if not 1 <= n_exp * p.splits <= 65535:
        raise ValueError(f"{what}: {n_exp} experts x {p.splits} splits; "
                         "the grid's z takes 1..65535")
    return p


def _check_plan(what, p: Plan, x, n: int):
    m, k = x.shape
    if p != plan(m, k, n, splits=p.splits):
        raise ValueError(f"{what}: plan {p} is not one for ({m}, {k}) @ "
                         f"({k}, {n})")


def _run(p: Plan, wrapper, x, consts, n: int, out_dtype=None):
    """Launch the kernel of ``wrapper`` (``sparse_matmul``,
    ``quant_sparse_matmul`` or their grouped forms) on plan ``p`` for x
    (M, K), or (E, M, K) with every array of ``consts`` stacked likewise,
    and S's arrays ``consts`` into a new (M, n) or (E, M, n) output, with
    the plan's partials and counters (E times a product's) as scratch;
    raise if the launch returned a CUDA error, else count it.
    ``out_dtype`` (``sparse_matmul`` only) is y's dtype; without it y is
    in x.dtype."""
    what = wrapper.__name__
    m, k = x.shape[-2:]
    n_exp = x.shape[0] if x.dim() == 3 else 1
    # the C entry's dtype codes: x's, then sparse_matmul's y's
    codes = [_DTYPES[x.dtype]]
    if out_dtype is not None:
        codes.append(_DTYPES[out_dtype])
    y = torch.empty(x.shape[:-1] + (n,), dtype=out_dtype or x.dtype,
                    device=x.device)
    if m == 0 or n == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    partial = counter = None          # held until the launch is queued
    if p.partial:
        partial = torch.empty((n_exp,) + p.partial, dtype=torch.float32,
                              device=x.device)
        counter = counter_scratch(x.device, stream, n_exp * p.counters)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _lib()
    entry = getattr(lib, f"{what.removesuffix('_grouped')}_launch")
    with torch.cuda.device(x.device):
        err = entry(
            x.data_ptr(), *(t.data_ptr() for t in consts), y.data_ptr(),
            ptr(partial), ptr(counter), m, k, n, -(-k // TILE),
            -(-n // TILE), consts[1].shape[-1], p.rows_per_block, p.splits,
            *codes, n_exp, stream)
    build.check(lib, err, what)
    wrapper.launches += 1
    return y


sparse_matmul.launches = 0
quant_sparse_matmul.launches = 0
sparse_matmul_grouped.launches = 0
quant_sparse_matmul_grouped.launches = 0
