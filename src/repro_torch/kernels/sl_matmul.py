"""The ``sl_matmul`` kernel's wrapper: y = x @ (scale·B·A ⊕ V).

Replaces the Pallas TPU kernel ``repro/kernels/sl_matmul.py::sl_matmul``
with the CUDA kernel in ``csrc/sl_matmul.cu`` (its header says what bounds
it on the H100 and how the design meets that). A tensor on the CPU runs
the plain version (:func:`repro_torch.kernels.ref.sl_matmul_ref`); a CUDA
tensor launches the kernel or raises, never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.core.support import TILE

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.library("sl_matmul")
    fn = lib.sl_matmul_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 8 + [_I] * 7 + [ctypes.c_float, _I, _P]
        fn.restype = _I
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


def sl_matmul(x, B, A, v_t, rows_t, cols_t, scale: float):
    """y = x @ (scale·B·A ⊕ V) in x.dtype for x (M, K), B (K, r), A (r, N)
    and V in tile-CSR form: v_t f32, rows_t/cols_t int32, each
    (ceil(K/128), ceil(N/128), cap). K and N need not be multiples of 128:
    the kernel masks the ragged edge itself. Each W tile is built in f32,
    rounded once to x.dtype and multiplied with f32 accumulation."""
    if x.device.type == "cpu":
        return ref.sl_matmul_ref(x, B, A, v_t, rows_t, cols_t, scale)
    if x.device.type != "cuda":
        raise ValueError(f"sl_matmul: unsupported device {x.device}")
    _check(x, B, A, v_t, rows_t, cols_t)
    m, k = x.shape
    r, n = A.shape
    nkt, nnt, cap = rows_t.shape
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    partial = torch.empty((nkt, m, n), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sl_matmul_launch(
            x.data_ptr(), B.data_ptr(), A.data_ptr(), v_t.data_ptr(),
            rows_t.data_ptr(), cols_t.data_ptr(), partial.data_ptr(),
            y.data_ptr(), m, k, n, r, nkt, nnt, cap, float(scale),
            _DTYPES[x.dtype], stream)
    build.check(lib, err, "sl_matmul")
    sl_matmul.launches += 1
    return y


sl_matmul.launches = 0
