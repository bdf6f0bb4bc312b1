"""The ``sddmm`` kernel's wrapper: dv tiles = (xᵀ·dy) sampled at the
support, the dV half of the fused linear's backward.

Replaces the Pallas TPU kernel ``repro/kernels/sddmm.py::sddmm`` with the
CUDA kernel in ``csrc/sddmm.cu`` (its header says what bounds it on the
H100 and how the design meets that). A tensor on the CPU runs the plain
version (:func:`repro_torch.kernels.ref.sddmm_ref`); a CUDA tensor
launches the kernel or raises, never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.support import TILE
from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    lib = build.library("sddmm")
    fn = lib.sddmm_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 5 + [_I] * 7 + [_P]
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
    m, k = x.shape
    n = dy.shape[1]
    nkt, nnt, cap = rows_t.shape
    if m == 0:
        return torch.zeros((nkt, nnt, cap), dtype=torch.float32,
                           device=x.device)
    out = torch.empty((nkt, nnt, cap), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sddmm_launch(x.data_ptr(), dy.data_ptr(), rows_t.data_ptr(),
                               cols_t.data_ptr(), out.data_ptr(), m, k, n,
                               nkt, nnt, cap, _DTYPES[x.dtype], stream)
    build.check(lib, err, "sddmm")
    sddmm.launches += 1
    return out


sddmm.launches = 0
