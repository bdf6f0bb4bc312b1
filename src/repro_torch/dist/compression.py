"""Int8-compressed gradient reduction over the slow cross-pod link,
ported from ``repro.dist.compression``.

:func:`int8_psum` sums a tensor over a process group with block-wise
symmetric int8 codes on the wire: the block scales are agreed first (an
all-reduce MAX of each block's absmax), every participant quantizes onto
that shared grid, the int8 codes are all-gathered, and each participant
sums them exactly in int32 in group-rank order before one dequantization.
The only error is the single rounding of the quantization, whatever the
number of participants; every participant gets the same bits.

:func:`wire_bytes` is the reference's analytic model of the bytes each
participant moves, and :func:`psum_tree` lifts the reduction over a
gradient tree, counting the modelled bytes on the registry counter
``dist.collective_bytes`` labelled ``compressed=true|false``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist import compat


def int8_psum(x, group, *, block: int = 256):
    """The sum of ``x`` over ``group`` (None: a group of one), through
    int8 block codes: absmax per ``block`` elements of the flattened f32
    tensor (the tail zero-padded), all-reduced with MAX into a shared
    scale (1 where a block is all zero), codes round(x / scale) clipped to
    ±127, all-gathered as int8, summed in int32, times the scale. Returns
    ``x``'s shape and dtype."""
    shape, dtype = x.shape, x.dtype
    flat = x.reshape(-1).float()
    n = flat.numel()
    pad = (-n) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    absmax = blocks.abs().amax(dim=1)
    if group is not None:
        compat.all_reduce(absmax, group, op=dist.ReduceOp.MAX)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones((), device=absmax.device))
    q = blocks / scale[:, None]
    codes = q.round_().clamp_(-127, 127).to(torch.int8)
    del q
    if group is None:
        gathered = codes[None]
    else:
        size = dist.get_world_size(group)
        gathered = torch.empty((size * codes.shape[0], block),
                               dtype=torch.int8, device=codes.device)
        compat.all_gather_into_tensor(gathered, codes, group)
        gathered = gathered.reshape(size, -1, block)
    # the exact int32 sum, a participant at a time (one int32 buffer)
    total = torch.zeros(codes.shape, dtype=torch.int32, device=codes.device)
    for part in gathered:
        total += part
    out = total.float().mul_(scale[:, None])
    return out.reshape(-1)[:n].reshape(shape).to(dtype)


def int8_psum_plain(xs, *, block: int = 256):
    """:func:`int8_psum`'s result from every participant's tensor ``xs``
    (a list, in group-rank order) in one process: the plain version the
    collective is held against, bit for bit."""
    shape, dtype = xs[0].shape, xs[0].dtype
    n = xs[0].numel()
    pad = (-n) % block
    blocks = torch.stack([torch.nn.functional.pad(
        x.reshape(-1).float(), (0, pad)).reshape(-1, block) for x in xs])
    absmax = blocks.abs().amax(dim=2).amax(dim=0)
    scale = torch.where(absmax > 0, absmax / 127.0,
                        torch.ones((), device=absmax.device))
    codes = torch.clamp(torch.round(blocks / scale[None, :, None]), -127,
                        127).to(torch.int8)
    out = codes.to(torch.int32).sum(dim=0).float() * scale[:, None]
    return out.reshape(-1)[:n].reshape(shape).to(dtype)


def wire_bytes(n_elems: int, *, compressed: bool, n_participants: int,
               dtype_bytes: int = 4, block: int = 256) -> float:
    """Per-participant wire bytes of one n-element reduction: a ring
    all-reduce moves 2·(p-1)/p copies at full precision; the int8
    exchange moves the scale sync ((p-1)/p · n/block f32), the codes of
    p-1 remote shards (1 B an element) and their scales."""
    p = max(1, int(n_participants))
    n_blocks = (n_elems + block - 1) // block
    if not compressed:
        return 2.0 * (p - 1) / p * n_elems * dtype_bytes
    scale_sync = (p - 1) / p * n_blocks * 4
    code_gather = (p - 1) * n_elems * 1.0
    scale_gather = (p - 1) * n_blocks * 4
    return scale_sync + code_gather + scale_gather


def psum_tree(tree, group, *, compress: bool = True, block: int = 256,
              min_size: int = 1024, obs=None, n_participants: int = 1):
    """Sum every leaf of a tree of nested dicts over ``group``. With
    ``compress``, float leaves of at least ``min_size`` elements go
    through :func:`int8_psum`; smaller and integer leaves are summed
    exactly (an all-reduce). ``obs`` (a metrics Registry) counts each
    reduction's modelled per-participant bytes (:func:`wire_bytes`) on
    ``dist.collective_bytes{compressed=...}``, once per call: the
    reference counts at trace time, once per compiled step, so a port
    step's counter delta equals the reference's count."""
    c_wire = None
    if obs is not None:
        c_wire = obs.counter(
            "dist.collective_bytes",
            help="modeled per-participant wire bytes of gradient "
                 "reductions (dist.compression.wire_bytes), per step")

    def reduce_leaf(g):
        comp = compress and g.is_floating_point() and g.numel() >= min_size
        if c_wire is not None:
            c_wire.labels(compressed=str(comp).lower()).inc(
                wire_bytes(g.numel(), compressed=comp,
                           n_participants=n_participants,
                           dtype_bytes=4 if comp else g.element_size(),
                           block=block))
        if comp:
            return int8_psum(g, group, block=block)
        out = g.clone()
        if group is not None:
            compat.all_reduce(out, group)
        return out

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(t[k]) for k in sorted(t)}
        return reduce_leaf(t)

    return walk(tree)
