"""The ``sddmm`` kernel's wrapper: dv tiles = (xᵀ·dy) sampled at the
support, the dV half of the fused linear's backward.

Replaces the Pallas TPU kernel ``repro/kernels/sddmm.py::sddmm`` with the
CUDA kernels in ``csrc/sddmm.cu`` (its header says what bounds them on the
H100 and how the design meets that): bf16 forms whole G tiles on the
tensor cores and gathers the slots, f32 samples the slots on the CUDA
cores. A tensor on the CPU runs the plain version
(:func:`repro_torch.kernels.ref.sddmm_ref`); a CUDA tensor launches the
kernel or raises, never falls back.

:func:`plan` says, from the shapes alone, which bf16 operand the wrapper
copies with padded rows first (a width that is not a multiple of 8:
llama_1b's d_ff = 5461), as ``sl_matmul`` does.

:func:`sddmm_grouped` runs E calls of one shape (an MoE layer's experts,
stacked on a leading axis) in one launch, the expert the grid's outermost
index: the counterpart of the TPU kernel batched under the reference's
vmap. Each expert's device code is the single launch's, so it gives the
bits of a loop of :func:`sddmm`; its plain version is that loop over
:func:`repro_torch.kernels.ref.sddmm_ref`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.support import TILE
from repro_torch.kernels import build, ref
from repro_torch.kernels import sl_matmul as sl_kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class Plan(NamedTuple):
    """A call's kernel (``"f32"``: sampled on the CUDA cores;
    ``"tensor_core"``: whole bf16 G tiles) and the shapes of the bf16
    copies of x (M, K) and dy (M, N) padded with zeros to a multiple of 8
    columns; None where the operand is read as it is."""
    variant: str
    x_pad: Optional[Tuple[int, int]]
    dy_pad: Optional[Tuple[int, int]]


def plan(m: int, k: int, n: int, dtype) -> Plan:
    """The kernel and padded copies for x (m, k) and dy (m, n) in
    ``dtype``. The bf16 kernel loads both operands 16 bytes at a time, so
    one whose rows are not a multiple of 8 elements is copied first; the
    wrapper also copies one whose base is not 16-byte aligned."""
    if dtype == torch.float32:
        return Plan("f32", None, None)
    return Plan("tensor_core", sl_kernel.pad8(m, k), sl_kernel.pad8(m, n))


def _lib():
    lib = build.library("sddmm")
    fn = lib.sddmm_grouped_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 10 + [_P]
        fn.restype = _I
    return lib


def _check(x, dy, rows_t, cols_t):
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"sddmm: x (M, K) and dy (M, N) expected, got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    if x.dtype not in _DTYPES or dy.dtype != x.dtype:
        raise TypeError(f"sddmm: x/dy dtypes {x.dtype}/{dy.dtype}: both "
                        f"must be one of {list(_DTYPES)}")
    want = (-(-x.shape[1] // TILE), -(-dy.shape[1] // TILE))
    for name, t in (("rows_t", rows_t), ("cols_t", cols_t)):
        if t.dim() != 3 or tuple(t.shape[:2]) != want or \
                t.dtype != torch.int32:
            raise ValueError(f"sddmm: {name} must be int32 "
                             f"{want + ('cap',)}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if rows_t.shape != cols_t.shape:
        raise ValueError("sddmm: rows_t/cols_t shapes differ")
    for name, t in (("x", x), ("dy", dy), ("rows_t", rows_t),
                    ("cols_t", cols_t)):
        if t.device != x.device:
            raise ValueError(f"sddmm: {name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"sddmm: {name} must be contiguous")


def pad_operands(p: Plan, x, dy):
    """x and dy as the bf16 kernel of plan ``p`` reads them: each one that
    ``p`` pads (or whose base is not 16-byte aligned) copied with
    zero-padded rows by ``sl_pad_rows`` on the current stream, the other
    as it is (stacks too)."""
    return sl_kernel.pad_rows(x, p.x_pad), sl_kernel.pad_rows(dy, p.dy_pad)


def sddmm(x, dy, rows_t, cols_t):
    """dv_t (ceil(K/128), ceil(N/128), cap) f32 for x (M, K) and dy (M, N)
    of one dtype: G = xᵀ·dy at every slot of the tile-CSR support
    (rows_t/cols_t int32, local to each 128×128 tile; padding slots get G
    at their tile's local (0, 0)). Products in f32, sums over tokens in
    f32."""
    if x.device.type == "cpu":
        return ref.sddmm_ref(x, dy, rows_t, cols_t)
    if x.device.type != "cuda":
        raise ValueError(f"sddmm: unsupported device {x.device}")
    _check(x, dy, rows_t, cols_t)
    out = _launch(x[None], dy[None], rows_t[None], cols_t[None])[0]
    sddmm.launches += 1
    return out


sddmm.launches = 0


def sddmm_grouped(x, dy, rows_t, cols_t):
    """dv_t (E, nkt, nnt, cap) f32 for E calls of one shape stacked on the
    leading axis: x (E, M, K), dy (E, M, N) of one dtype, rows_t/cols_t
    int32 (E, nkt, nnt, cap); each expert as :func:`sddmm`. On the card
    one launch with the expert as the outer grid index; on the CPU a loop
    of the plain version."""
    if x.device.type == "cpu":
        return torch.stack([ref.sddmm_ref(*t) for t in
                            zip(x, dy, rows_t, cols_t)])
    if x.device.type != "cuda":
        raise ValueError(f"sddmm_grouped: unsupported device {x.device}")
    if x.dim() != 3 or dy.dim() != 3 or rows_t.dim() != 4 or \
            cols_t.dim() != 4:
        raise ValueError("sddmm_grouped: x (E, M, K), dy (E, M, N) and the "
                         "tile consts (E, nkt, nnt, cap) expected")
    n_exp = x.shape[0]
    if any(t.shape[0] != n_exp for t in (dy, rows_t, cols_t)):
        raise ValueError("sddmm_grouped: operands stack different expert "
                         "counts")
    if not 1 <= n_exp <= 65535:
        raise ValueError(f"sddmm_grouped: {n_exp} experts; the grid takes "
                         "1 to 65535")
    _check(x[0], dy[0], rows_t[0], cols_t[0])
    for name, t in (("x", x), ("dy", dy), ("rows_t", rows_t),
                    ("cols_t", cols_t)):
        if not t.is_contiguous():
            raise ValueError(f"sddmm_grouped: {name} must be contiguous")
    out = _launch(x, dy, rows_t, cols_t)
    sddmm_grouped.launches += 1
    return out


def _launch(x, dy, rows_t, cols_t):
    """``sddmm_grouped_launch`` on E stacked calls (E = 1 for one): dv_t
    (E, nkt, nnt, cap) f32."""
    n_exp, m, k = x.shape
    n = dy.shape[2]
    _, nkt, nnt, cap = rows_t.shape
    if m == 0:
        return torch.zeros((n_exp, nkt, nnt, cap), dtype=torch.float32,
                           device=x.device)
    p = plan(m, k, n, x.dtype)
    if p.variant != "f32":
        x, dy = pad_operands(p, x, dy)
    out = torch.empty((n_exp, nkt, nnt, cap), dtype=torch.float32,
                      device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sddmm_grouped_launch(
            x.data_ptr(), dy.data_ptr(), rows_t.data_ptr(), cols_t.data_ptr(),
            out.data_ptr(), m, k, n, nkt, nnt, cap, x.shape[2], dy.shape[2],
            _DTYPES[x.dtype], n_exp, stream)
    build.check(lib, err, "sddmm")
    return out


sddmm_grouped.launches = 0
