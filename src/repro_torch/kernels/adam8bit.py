"""The ``adam8bit`` kernel's wrapper: one fused blockwise 8-bit Adam step
over (n_q, 256) quantization blocks.

Replaces the Pallas TPU kernel ``repro/kernels/adam8bit.py::adam8bit_update``
with the CUDA kernel in ``csrc/adam8bit.cu`` (its header says what bounds
it on the H100 and how the design meets that). A tensor on the CPU runs
the plain version (:func:`repro_torch.kernels.ref.adam8bit_ref`); a CUDA
tensor launches the kernel or raises, never falls back.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
Q = 256          # the kernel's quantization block (OptimizerConfig.q_block)


def _lib():
    lib = build.library("adam8bit")
    fn = lib.adam8bit_launch
    if fn.argtypes is None:
        fn.argtypes = [_P] * 12 + [ctypes.c_longlong, ctypes.c_longlong,
                                   ctypes.c_int, _P]
        fn.restype = ctypes.c_int
    return lib


def _check(p, g, m_codes, m_scales, v_codes, v_scales, scalars, n_valid):
    if p.dim() != 2 or p.shape[1] != Q:
        raise ValueError(f"adam8bit: p must be (n_q, {Q}) blocks, got "
                         f"{tuple(p.shape)}")
    n_q = p.shape[0]
    if p.dtype not in _DTYPES:
        raise TypeError(f"adam8bit: p dtype {p.dtype} must be one of "
                        f"{list(_DTYPES)}")
    want = {"g": (g, torch.float32, (n_q, Q)),
            "m_codes": (m_codes, torch.int8, (n_q, Q)),
            "v_codes": (v_codes, torch.int8, (n_q, Q)),
            "m_scales": (m_scales, torch.float32, (n_q,)),
            "v_scales": (v_scales, torch.float32, (n_q,)),
            "scalars": (scalars, torch.float32, (10,))}
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"adam8bit: {name} must be {dtype}, got "
                            f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"adam8bit: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    for name, t in (("p", p), ("g", g), ("m_codes", m_codes),
                    ("v_codes", v_codes), ("m_scales", m_scales),
                    ("v_scales", v_scales), ("scalars", scalars)):
        if t.device != p.device:
            raise ValueError(f"adam8bit: {name} on {t.device}, p on "
                             f"{p.device}")
        if not t.is_contiguous():
            raise ValueError(f"adam8bit: {name} must be contiguous")
    for name, t in (("p", p), ("g", g), ("m_codes", m_codes),
                    ("v_codes", v_codes)):
        if t.data_ptr() % 16:
            raise ValueError(f"adam8bit: {name} must be 16-byte aligned "
                             "(the kernel's vector loads)")
    if not 0 < n_valid <= n_q * Q or n_valid <= (n_q - 1) * Q:
        raise ValueError(f"adam8bit: n_valid {n_valid} must fall in the "
                         f"last of the {n_q} blocks")


def adam8bit_update(p, g, m_codes, m_scales, v_codes, v_scales, scalars,
                    n_valid: int, *, inplace: bool = False):
    """One 8-bit Adam step. p (n_q, 256) f32 or bf16, g (n_q, 256) f32,
    codes int8 (n_q, 256), scales f32 (n_q,), ``scalars`` f32 (10,) on p's
    device = [lr, b1, b2, 1-b1, 1-b2, bc1, bc2, eps, wd, 0], ``n_valid``
    the count of real elements (the lanes past it are masked). Returns
    (new_p, m_codes, m_scales, v_codes, v_scales); with ``inplace`` they
    are written into p and the given codes and scales, which are returned.
    """
    if p.device.type == "cpu":
        out = ref.adam8bit_ref(p, g, m_codes, m_scales, v_codes, v_scales,
                               scalars, n_valid)
        if not inplace:
            return out
        dst = (p, m_codes, m_scales, v_codes, v_scales)
        for d, o in zip(dst, out):
            d.copy_(o)
        return dst
    if p.device.type != "cuda":
        raise ValueError(f"adam8bit: unsupported device {p.device}")
    _check(p, g, m_codes, m_scales, v_codes, v_scales, scalars, n_valid)
    if inplace:
        outs = (p, m_codes, m_scales, v_codes, v_scales)
    else:
        outs = (torch.empty_like(p), torch.empty_like(m_codes),
                torch.empty_like(m_scales), torch.empty_like(v_codes),
                torch.empty_like(v_scales))
    po, mco, mso, vco, vso = outs
    lib = _lib()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = lib.adam8bit_launch(
            po.data_ptr(), p.data_ptr(), g.data_ptr(), mco.data_ptr(),
            mso.data_ptr(), vco.data_ptr(), vso.data_ptr(),
            m_codes.data_ptr(), m_scales.data_ptr(), v_codes.data_ptr(),
            v_scales.data_ptr(), scalars.data_ptr(), int(n_valid),
            p.shape[0], _DTYPES[p.dtype], stream)
    build.check(lib, err, "adam8bit")
    adam8bit_update.launches += 1
    return outs


adam8bit_update.launches = 0
