"""The ``sl_matmul`` kernel's wrapper: y = x @ (scale·B·A ⊕ V).

Replaces the Pallas TPU kernel ``repro/kernels/sl_matmul.py::sl_matmul``
with the CUDA kernels in ``csrc/sl_matmul.cu`` (its header says what
bounds them on the H100 and how the design meets that). A tensor on the
CPU runs the plain version (:func:`repro_torch.kernels.ref.sl_matmul_ref`);
a CUDA tensor launches the kernel or raises, never falls back.

:func:`plan` picks the variant and its scratch from the shapes alone: f32
keeps the CUDA-core kernels with f32 partials; bf16 runs on the tensor
cores, in one pass with small f32 partials up to ``SMALL_M_MAX`` rows and
in two stages (a bf16 W in scratch, then an in-block k loop) above.

:func:`sl_matmul_grouped` runs E linears of one shape (an MoE layer's
experts, stacked on a leading axis) in one launch per stage of the same
plan, the expert the grid's outermost index: the counterpart of the TPU
kernel batched under the reference's vmap over the expert stack. Each
expert's device code is the single launch's, so it gives the bits of a
loop of :func:`sl_matmul`; its plain version is that loop over
:func:`repro_torch.kernels.ref.sl_matmul_ref`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import build, ref
from repro_torch.core.support import TILE

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = (torch.float32, torch.bfloat16)
_VARIANTS = {"f32": 0, "single_pass": 1, "two_stage": 2}
# the crossover: the most rows the bf16 single pass is given before the
# two-stage variant takes over, picked from both variants' times at M =
# 32, 64 and 128 (PERF.md §6); also the most it can hold (csrc's
# SMALL_M_ROWS: x's tile in shared memory)
SMALL_M_MAX = 128


class Plan(NamedTuple):
    """A call's variant and the shapes of the scratch it allocates: the
    f32 partial (nkt, M, N), the bf16 Wᵀ (nnt·128, nkt·128), and bf16
    copies of x (M, K), B (K, r) and A (r, N) padded with zeros to a
    multiple of 8 columns; None where unused."""
    variant: str
    partial: Optional[Tuple[int, int, int]]
    w_t: Optional[Tuple[int, int]]
    x_pad: Optional[Tuple[int, int]]
    b_pad: Optional[Tuple[int, int]]
    a_pad: Optional[Tuple[int, int]]


def pad8(rows: int, cols: int):
    """(rows, cols rounded up to a multiple of 8), or None where cols
    already is one: the shape of an operand's padded bf16 copy."""
    c8 = -(-cols // 8) * 8
    return (rows, c8) if c8 != cols else None


def plan(m: int, k: int, n: int, r: int, dtype,
         small_m_max: int = SMALL_M_MAX) -> Plan:
    """The variant and scratch for x (m, k) @ (B (k, r) · A (r, n) ⊕ V)
    in ``dtype``. The bf16 kernels load every operand 16 bytes at a time,
    so an operand whose rows are not a multiple of 8 elements is copied,
    padded with zeros (llama_1b's d_ff = 5461); the wrapper also copies
    one whose base is not 16-byte aligned."""
    nkt, nnt = -(-k // TILE), -(-n // TILE)
    if dtype == torch.float32:
        return Plan("f32", (nkt, m, n), None, None, None, None)
    pads = (pad8(m, k), pad8(k, r), pad8(r, n))
    if m <= min(small_m_max, SMALL_M_MAX):
        return Plan("single_pass", (nkt, m, n), None, *pads)
    return Plan("two_stage", None, (nnt * TILE, nkt * TILE), *pads)


def _lib():
    lib = build.library("sl_matmul")
    fn = lib.sl_matmul_grouped_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 9 + [_I] * 10 + [ctypes.c_float, _I, _I, _P]
        fn.restype = _I
        lib.sl_pad_rows.argtypes = [_P, _P, _I, _I, _I, _P]
        lib.sl_pad_rows.restype = _I
    return lib


def _check(x, B, A, v_t, rows_t, cols_t):
    if x.dim() != 2:
        raise ValueError(f"sl_matmul: x must be (M, K), got {tuple(x.shape)}")
    m, k = x.shape
    if x.dtype not in _DTYPES:
        raise TypeError(f"sl_matmul: x dtype {x.dtype} not in "
                        f"{list(_DTYPES)}")
    if B.dim() != 2 or A.dim() != 2 or B.shape[0] != k or \
            A.shape[0] != B.shape[1]:
        raise ValueError(f"sl_matmul: B {tuple(B.shape)} / A "
                         f"{tuple(A.shape)} do not fit x {tuple(x.shape)}")
    if B.dtype != x.dtype or A.dtype != x.dtype:
        raise TypeError(f"sl_matmul: B/A dtypes {B.dtype}/{A.dtype} must "
                        f"match x {x.dtype}")
    n = A.shape[1]
    want = (-(-k // TILE), -(-n // TILE))
    for name, t, dt in (("v_t", v_t, torch.float32),
                        ("rows_t", rows_t, torch.int32),
                        ("cols_t", cols_t, torch.int32)):
        if t.dim() != 3 or tuple(t.shape[:2]) != want or t.dtype != dt:
            raise ValueError(f"sl_matmul: {name} must be {dt} "
                             f"{want + ('cap',)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if t.shape != rows_t.shape:
            raise ValueError("sl_matmul: v_t/rows_t/cols_t shapes differ")
    for name, t in (("x", x), ("B", B), ("A", A), ("v_t", v_t),
                    ("rows_t", rows_t), ("cols_t", cols_t)):
        if t.device != x.device:
            raise ValueError(f"sl_matmul: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"sl_matmul: {name} must be contiguous")


def _check_grouped(x, B, A, v_t, rows_t, cols_t):
    """The checks of :func:`_check` for each expert of a stack, and one
    expert count on every operand's leading axis."""
    if x.dim() != 3 or B.dim() != 3 or A.dim() != 3 or v_t.dim() != 4 or \
            rows_t.dim() != 4 or cols_t.dim() != 4:
        raise ValueError(
            f"sl_matmul_grouped: x (E, M, K), B (E, K, r), A (E, r, N) and "
            f"the tile consts (E, nkt, nnt, cap) expected, got "
            f"{[tuple(t.shape) for t in (x, B, A, v_t, rows_t, cols_t)]}")
    n_exp = x.shape[0]
    if any(t.shape[0] != n_exp for t in (B, A, v_t, rows_t, cols_t)):
        raise ValueError("sl_matmul_grouped: operands stack different "
                         "expert counts")
    if not 1 <= n_exp <= 65535:
        raise ValueError(f"sl_matmul_grouped: {n_exp} experts; the grid "
                         "takes 1 to 65535")
    _check(x[0], B[0], A[0], v_t[0], rows_t[0], cols_t[0])
    for name, t in (("x", x), ("B", B), ("A", A), ("v_t", v_t),
                    ("rows_t", rows_t), ("cols_t", cols_t)):
        if not t.is_contiguous():
            raise ValueError(f"sl_matmul_grouped: {name} must be contiguous")


def _padded(lib, stream, t, shape):
    """A copy of ``t`` of ``shape`` (or of t's own shape), the rows
    padded with zeros to a multiple of 8, made by the kernel library's pad
    kernel."""
    rows, ld = shape or t.shape
    out = torch.empty((rows, ld), dtype=t.dtype, device=t.device)
    build.check(lib, lib.sl_pad_rows(t.data_ptr(), out.data_ptr(), rows,
                                     t.shape[1], ld, stream), "sl_matmul")
    return out


def _cuda_only(x):
    if x.device.type != "cuda":
        raise ValueError(f"sl_matmul: unsupported device {x.device}")


def pad_rows(t, shape):
    """The bf16 CUDA tensor ``t`` as a kernel that loads 16 bytes at a
    time reads it: ``t`` itself where ``shape`` is None and its base is
    16-byte aligned, else a copy of ``shape`` (or of t's own shape) with
    zero-padded rows, made by the library's pad kernel on the current
    stream. A stack (E, rows, cols) is padded as its E·rows rows, each
    matrix to ``shape``."""
    _cuda_only(t)
    if shape is None and t.data_ptr() % 16 == 0:
        return t
    lib = _lib()
    cols = t.shape[-1]
    ld = shape[1] if shape else cols
    with torch.cuda.device(t.device):
        out = _padded(lib, torch.cuda.current_stream(t.device).cuda_stream,
                      t.reshape(-1, cols), (t.numel() // cols, ld))
    return out.reshape(*t.shape[:-1], ld)


def pad_operands(p: Plan, x, B, A):
    """x, B and A as the bf16 variants of plan ``p`` read them: each one
    that ``p`` pads (or whose base is not 16-byte aligned) copied with
    zero-padded rows on the current stream, the others as they are
    (stacks too)."""
    return tuple(pad_rows(t, shape) for t, shape in
                 ((x, p.x_pad), (B, p.b_pad), (A, p.a_pad)))


def sl_matmul(x, B, A, v_t, rows_t, cols_t, scale: float):
    """y = x @ (scale·B·A ⊕ V) in x.dtype for x (M, K), B (K, r), A (r, N)
    and V in tile-CSR form: v_t f32, rows_t/cols_t int32, each
    (ceil(K/128), ceil(N/128), cap). K and N need not be multiples of 128:
    the kernels mask the ragged edge themselves. Each W tile is built in
    f32, rounded once to x.dtype and multiplied with f32 accumulation."""
    if x.device.type == "cpu":
        return ref.sl_matmul_ref(x, B, A, v_t, rows_t, cols_t, scale)
    _cuda_only(x)
    _check(x, B, A, v_t, rows_t, cols_t)
    (m, k), (r, n) = x.shape, A.shape
    return launch(plan(m, k, n, r, x.dtype), x, B, A, v_t, rows_t, cols_t,
                  scale)


def launch(p: Plan, x, B, A, v_t, rows_t, cols_t, scale: float):
    """The kernels of plan ``p`` on CUDA operands that :func:`sl_matmul`
    accepts (the grouped launch of one linear); it counts one launch.
    :func:`sl_matmul` passes the plan of the shapes; a caller that times
    or tests one bf16 variant against the other passes ``plan(...,
    small_m_max=0)``."""
    y = _launch(p, *(t[None] for t in (x, B, A, v_t, rows_t, cols_t)),
                scale)[0]
    sl_matmul.launches += 1
    return y


sl_matmul.launches = 0


def sl_matmul_grouped(x, B, A, v_t, rows_t, cols_t, scale: float):
    """y (E, M, N) = x[e] @ (scale·B[e]·A[e] ⊕ V[e]) for each of E
    linears of one shape, stacked on the leading axis: x (E, M, K), B (E,
    K, r), A (E, r, N), v_t f32 and rows_t/cols_t int32 (E, nkt, nnt,
    cap). On the card one launch per stage of ``plan(M, K, N, r,
    dtype)``; on the CPU a loop of the plain version."""
    if x.device.type == "cpu":
        return torch.stack([ref.sl_matmul_ref(*t, scale) for t in
                            zip(x, B, A, v_t, rows_t, cols_t)])
    _cuda_only(x)
    _check_grouped(x, B, A, v_t, rows_t, cols_t)
    _, m, k = x.shape
    r, n = A.shape[1:]
    return launch_grouped(plan(m, k, n, r, x.dtype), x, B, A, v_t, rows_t,
                          cols_t, scale)


def launch_grouped(p: Plan, x, B, A, v_t, rows_t, cols_t, scale: float):
    """The kernels of plan ``p`` over a stack of E linears that
    :func:`sl_matmul_grouped` accepts, one launch a stage with the expert
    as the outer grid index; it counts one launch."""
    y = _launch(p, x, B, A, v_t, rows_t, cols_t, scale)
    sl_matmul_grouped.launches += 1
    return y


def _launch(p: Plan, x, B, A, v_t, rows_t, cols_t, scale: float):
    """``sl_matmul_grouped_launch`` on E stacked linears (E = 1 for one):
    y (E, M, N). Scratch grows by E (the two-stage variant's bf16 Wᵀ
    stack: E·nnt·128·nkt·128 elements)."""
    _cuda_only(x)
    n_exp, m, k = x.shape
    r, n = A.shape[1:]
    _, nkt, nnt, cap = rows_t.shape
    y = torch.empty((n_exp, m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    scratch = lambda shape, dt: (
        torch.empty((n_exp, *shape), dtype=dt, device=x.device)
        if shape else None)
    partial = scratch(p.partial, torch.float32)
    w_t = scratch(p.w_t, torch.bfloat16)
    ptr = lambda t: None if t is None else t.data_ptr()
    if p.variant != "f32":
        x, B, A = pad_operands(p, x, B, A)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.sl_matmul_grouped_launch(
            x.data_ptr(), B.data_ptr(), A.data_ptr(), v_t.data_ptr(),
            rows_t.data_ptr(), cols_t.data_ptr(), ptr(partial), ptr(w_t),
            y.data_ptr(), m, k, n, r, nkt, nnt, cap, x.shape[-1],
            B.shape[-1], A.shape[-1], float(scale), _VARIANTS[p.variant],
            n_exp, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, "sl_matmul")
    return y


sl_matmul_grouped.launches = 0
