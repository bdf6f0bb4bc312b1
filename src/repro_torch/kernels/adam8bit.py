"""The ``adam8bit`` kernel's wrappers: the fused blockwise 8-bit Adam step
over a list of segments in one launch (:func:`adam8bit_group`), and its
one-segment case on (n_q, 256) blocks (:func:`adam8bit_update`).

Replaces the Pallas TPU kernel ``repro/kernels/adam8bit.py::adam8bit_update``
with the CUDA kernel in ``csrc/adam8bit.cu`` (its header says what bounds
it on the H100 and how the design meets that). A tensor on the CPU runs
the plain version (:func:`repro_torch.kernels.ref.adam8bit_segment_ref`,
segment by segment); a CUDA tensor launches the kernel or raises, never
falls back. ``adam8bit_update.launches`` counts every launch of the
kernel, through either wrapper.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from repro_torch.kernels import build, ref

_P = ctypes.c_void_p
Q = 256          # the kernel's quantization block (OptimizerConfig.q_block)
MAX_SEGMENTS = 48   # segments one launch takes (csrc's MAX_SEGS)
_DECAY = 1
_DTYPES = (torch.float32, torch.bfloat16)


class Segment(NamedTuple):
    """One leaf or layer slice of an 8-bit Adam step: p (n elements, f32
    or bf16, contiguous; updated in place), g (n elements, f32 or bf16),
    the moments' codes (int8, ceil(n/256) * 256 elements) and scales (f32,
    ceil(n/256)), written in place, and whether weight decay
    (``scalars[8]``) applies to it."""
    p: torch.Tensor
    g: torch.Tensor
    m_codes: torch.Tensor
    m_scales: torch.Tensor
    v_codes: torch.Tensor
    v_scales: torch.Tensor
    decay: bool


class _Seg(ctypes.Structure):
    _fields_ = [("p", _P), ("g", _P), ("mc", _P), ("ms", _P), ("vc", _P),
                ("vs", _P), ("n", ctypes.c_longlong),
                ("blk0", ctypes.c_longlong), ("flags", ctypes.c_int),
                ("pad", ctypes.c_int)]


class _SegTable(ctypes.Structure):
    _fields_ = [("count", ctypes.c_int), ("pad", ctypes.c_int),
                ("blocks", ctypes.c_longlong),
                ("seg", _Seg * MAX_SEGMENTS)]


def _lib():
    lib = build.library("adam8bit")
    fn = lib.adam8bit_launch
    if fn.argtypes is None:
        fn.argtypes = [_P, _P, _P, ctypes.c_int, ctypes.c_int, _P]
        fn.restype = ctypes.c_int
        lib.adam8bit_max_segments.restype = ctypes.c_int
        if lib.adam8bit_max_segments() != MAX_SEGMENTS:
            raise RuntimeError("adam8bit: the library's segment limit "
                               "differs from the wrapper's")
    return lib


def _check_segment(i, s: Segment, device):
    n = s.p.numel()
    nq = -(-n // Q)
    what = f"adam8bit segment {i}"
    if s.p.dtype not in _DTYPES or s.g.dtype not in _DTYPES:
        raise TypeError(f"{what}: p and g must be f32 or bf16, got "
                        f"{s.p.dtype} / {s.g.dtype}")
    if n == 0 or s.g.numel() != n:
        raise ValueError(f"{what}: p has {n} elements, g {s.g.numel()}")
    want = {"m_codes": (s.m_codes, torch.int8, nq * Q),
            "v_codes": (s.v_codes, torch.int8, nq * Q),
            "m_scales": (s.m_scales, torch.float32, nq),
            "v_scales": (s.v_scales, torch.float32, nq)}
    for name, (t, dtype, numel) in want.items():
        if t.dtype != dtype:
            raise TypeError(f"{what}: {name} must be {dtype}, got {t.dtype}")
        if t.numel() != numel:
            raise ValueError(f"{what}: {name} must hold {numel} elements "
                             f"({nq} blocks of {Q}), got {t.numel()}")
    for name, t in (("p", s.p), ("g", s.g)) + tuple(
            (k, v[0]) for k, v in want.items()):
        if t.device != device:
            raise ValueError(f"{what}: {name} on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    for name in ("m_codes", "v_codes"):
        if want[name][0].data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned "
                             "(the kernel's vector loads)")


def _check_shared(scalars, clip, device):
    if scalars.dtype != torch.float32 or tuple(scalars.shape) != (10,) or \
            scalars.device != device or not scalars.is_contiguous():
        raise ValueError(f"adam8bit: scalars must be contiguous f32 (10,) "
                         f"on {device}, got {scalars.dtype} "
                         f"{tuple(scalars.shape)} on {scalars.device}")
    if clip is not None and (clip.dtype != torch.float32 or
                             clip.numel() != 1 or clip.device != device):
        raise ValueError(f"adam8bit: clip must be one f32 on {device}, got "
                         f"{clip.dtype} {tuple(clip.shape)} on "
                         f"{clip.device}")


def adam8bit_group(segments: Sequence[Segment], scalars, clip=None):
    """One 8-bit Adam step on every segment, written in place: each
    segment's p, codes and scales. ``scalars`` f32 (10,) on the segments'
    device = [lr, b1, b2, 1-b1, 1-b2, bc1, bc2, eps, wd, 0] (wd applies to
    the segments whose ``decay`` is set); ``clip`` an optional f32 device
    scalar each gradient is multiplied by first (the step's clip scale).
    On the card: one launch per ``MAX_SEGMENTS`` segments with the same
    pair of p and g dtypes (the kernel is compiled for each pair)."""
    if not segments:
        return
    device = segments[0].p.device
    if device.type == "cpu":
        for s in segments:
            out = ref.adam8bit_segment_ref(*s[:6], scalars, clip,
                                           decay=s.decay)
            for dst, src in zip((s.p,) + tuple(s[2:6]), out):
                dst.copy_(src.reshape(dst.shape))
        return
    if device.type != "cuda":
        raise ValueError(f"adam8bit: unsupported device {device}")
    _check_shared(scalars, clip, device)
    for i, s in enumerate(segments):
        _check_segment(i, s, device)
    by_dtypes = {}
    for s in segments:
        by_dtypes.setdefault((s.p.dtype, s.g.dtype), []).append(s)
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for (p_dtype, g_dtype), segs in by_dtypes.items():
            for at in range(0, len(segs), MAX_SEGMENTS):
                table = _SegTable()
                blocks = 0
                for j, s in enumerate(segs[at:at + MAX_SEGMENTS]):
                    n = s.p.numel()
                    table.seg[j] = _Seg(
                        s.p.data_ptr(), s.g.data_ptr(), s.m_codes.data_ptr(),
                        s.m_scales.data_ptr(), s.v_codes.data_ptr(),
                        s.v_scales.data_ptr(), n, blocks,
                        _DECAY if s.decay else 0, 0)
                    blocks += -(-n // Q)
                    table.count = j + 1
                table.blocks = blocks
                err = lib.adam8bit_launch(
                    ctypes.addressof(table), scalars.data_ptr(),
                    None if clip is None else clip.data_ptr(),
                    int(p_dtype == torch.bfloat16),
                    int(g_dtype == torch.bfloat16), stream)
                build.check(lib, err, "adam8bit")
                adam8bit_update.launches += 1


def _check_blocks(p, g, m_codes, m_scales, v_codes, v_scales, scalars,
                  n_valid):
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
    """One 8-bit Adam step on (n_q, 256) blocks. p (n_q, 256) f32 or bf16,
    g (n_q, 256) f32 (already clipped), codes int8 (n_q, 256), scales f32
    (n_q,), ``scalars`` f32 (10,) on p's device = [lr, b1, b2, 1-b1, 1-b2,
    bc1, bc2, eps, wd, 0], ``n_valid`` the count of real elements (the
    lanes past it are masked; on the card they are neither read nor
    written). Returns (new_p, m_codes, m_scales, v_codes, v_scales); with
    ``inplace`` they are written into p and the given codes and scales,
    which are returned. On the card: one launch of the kernel with one
    segment (:func:`adam8bit_group`)."""
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
    _check_blocks(p, g, m_codes, m_scales, v_codes, v_scales, scalars,
                  n_valid)
    outs = (p, m_codes, m_scales, v_codes, v_scales)
    if not inplace:
        outs = tuple(t.clone() for t in outs)
    po, mco, mso, vco, vso = outs
    adam8bit_group([Segment(po.reshape(-1)[:n_valid],
                            g.reshape(-1)[:n_valid], mco, mso, vco, vso,
                            True)], scalars)
    return outs


adam8bit_update.launches = 0
