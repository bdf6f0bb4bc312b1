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
    lib = build.library("sparse_decode")
    for fn, n_ptr in ((lib.sparse_matmul_launch, 5),
                      (lib.quant_sparse_matmul_launch, 6)):
        if fn.argtypes is None:
            fn.argtypes = [_P] * n_ptr + [_I] * 7 + [_P]
            fn.restype = _I
    return lib


def _check(what, x, n, tiles):
    """Raise on what the kernel does not take: x (M, K) f32/bf16, and the
    tile arrays ((name, tensor, dtype, shape) entries) on x's device,
    contiguous, shaped for ceil(K/128) x ceil(n/128) tiles."""
    if x.dim() != 2:
        raise ValueError(f"{what}: x must be (M, K), got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what}: x dtype {x.dtype} not in {list(_DTYPES)}")
    k = x.shape[1]
    lead = (-(-k // TILE), -(-n // TILE))
    cap = tiles[0][1].shape[-1]
    for name, t, dt, shape in tiles:
        want = shape if shape is not None else lead + (cap,)
        if tuple(t.shape) != want or t.dtype != dt:
            raise ValueError(f"{what}: {name} must be {dt} {want}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("x", x),) + tuple((nm, t) for nm, t, _, _ in tiles):
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _launch(lib, fn, what, x, n, ptrs, cap):
    """Launch ``fn`` on x (M, K) into a new (M, n) output; raise if the
    launch returned a CUDA error."""
    m, k = x.shape
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return y
    nkt, nnt = -(-k // TILE), -(-n // TILE)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), *ptrs, y.data_ptr(), m, k, n, nkt, nnt, cap,
                 _DTYPES[x.dtype], stream)
    build.check(lib, err, what)
    return y


def sparse_matmul(x, v_t, rows_t, cols_t, n: int):
    """y = x @ S in x.dtype for x (M, K) and S (K, n) in tile-CSR form: v_t
    f32, rows_t/cols_t int32, each (ceil(K/128), ceil(n/128), cap). K and n
    need not be multiples of 128. f32 accumulation, one final rounding."""
    if x.device.type == "cpu":
        return ref.sparse_matmul_ref(x, v_t, rows_t, cols_t, n)
    if x.device.type != "cuda":
        raise ValueError(f"sparse_matmul: unsupported device {x.device}")
    _check("sparse_matmul", x, n, (
        ("v_t", v_t, torch.float32, None),
        ("rows_t", rows_t, torch.int32, None),
        ("cols_t", cols_t, torch.int32, None)))
    lib = _lib()
    y = _launch(lib, lib.sparse_matmul_launch, "sparse_matmul", x, n,
                (v_t.data_ptr(), rows_t.data_ptr(), cols_t.data_ptr()),
                rows_t.shape[-1])
    if y.numel():
        sparse_matmul.launches += 1
    return y


def quant_sparse_matmul(x, qv_t, rows_q, cols_q, qscale, n: int):
    """y = x @ dequant(S) in x.dtype for the int8 tile-CSR layout
    (repro_torch.quant.layout): qv_t int8 codes, rows_q/cols_q int16
    tile-local indices, each (ceil(K/128), ceil(n/128), cap), and qscale
    f32 (ceil(n/128), 128) per-output-channel scales. f32 accumulation,
    one final rounding."""
    if x.device.type == "cpu":
        return ref.quant_sparse_matmul_ref(x, qv_t, rows_q, cols_q, qscale,
                                           n)
    if x.device.type != "cuda":
        raise ValueError(f"quant_sparse_matmul: unsupported device "
                         f"{x.device}")
    _check("quant_sparse_matmul", x, n, (
        ("qv_t", qv_t, torch.int8, None),
        ("rows_q", rows_q, torch.int16, None),
        ("cols_q", cols_q, torch.int16, None),
        ("qscale", qscale, torch.float32, (-(-n // TILE), TILE))))
    lib = _lib()
    y = _launch(lib, lib.quant_sparse_matmul_launch, "quant_sparse_matmul",
                x, n, (qv_t.data_ptr(), rows_q.data_ptr(), cols_q.data_ptr(),
                       qscale.data_ptr()), rows_q.shape[-1])
    if y.numel():
        quant_sparse_matmul.launches += 1
    return y


sparse_matmul.launches = 0
quant_sparse_matmul.launches = 0
