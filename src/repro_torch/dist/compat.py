"""Version-portable wrappers over ``torch.distributed``, the port's
counterpart of ``repro.dist.compat``.

The collectives the port calls have moved between torch releases:
``all_gather_into_tensor`` became ``all_gather_single`` (torch 2.13 warns
that the first is deprecated) and ``reduce_scatter_tensor`` became
``reduce_scatter_single``. Every module of the port goes through this one:
it calls the newer spelling where the installed torch has it, else the
older one, decided once by name, never by catching an error.

Under the gloo backend the data of a collective moves through host
memory, by rule:

* a group whose ranks all run on this host exchanges it through a
  :class:`Mailbox`, a file mapped shared into every member (one slot a
  rank, and one for results), gloo carrying only the barriers (gloo's
  own transport between processes of one host is far slower than a
  copy through shared memory). Each element of a sum is added in
  group-rank order by one rank, so every rank gets the same bits;
* any other gloo group runs gloo's collective on host copies (gloo's
  CUDA coverage differs between collectives and releases).

That is how ranks that share one card exchange data; NCCL takes the
device tensors as they are.

:func:`make_mesh` builds the port's :class:`repro_torch.dist.sharding.Mesh`
over the current process group.
"""
from __future__ import annotations

import os
import socket
import tempfile
import uuid

import torch
import torch.distributed as dist

_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor

# bytes of one rank's slot in a Mailbox: larger collectives go in pieces
MAILBOX_SLOT = 64 << 20


def init_device_mesh(device_type: str, shape, names):
    """``torch.distributed.device_mesh.init_device_mesh`` with the axis
    names passed by keyword, as every release since 2.2 takes them."""
    from torch.distributed.device_mesh import init_device_mesh as init
    return init(device_type, tuple(shape), mesh_dim_names=tuple(names))


def backend_of(group) -> str:
    """The backend name of ``group`` (None: the default group)."""
    return str(dist.get_backend(group))


class Mailbox:
    """Host memory shared by the ranks of one gloo group on one host: a
    file under the temporary directory, mapped by every member and
    unlinked once all have it (the mapping keeps it alive), holding a
    slot of ``MAILBOX_SLOT`` bytes a rank and one for results. A
    collective writes each rank's piece into its slot, meets at a
    barrier, reads (and sums, in group-rank order) and meets again before
    the slots are reused."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        name = [uuid.uuid4().hex if self.rank == 0 else None]
        dist.broadcast_object_list(name, src=dist.get_global_rank(group, 0),
                                   group=group)
        path = os.path.join(tempfile.gettempdir(),
                            f"repro_torch_mailbox_{name[0]}")
        self.buf = torch.from_file(path, shared=True,
                                   size=(self.size + 1) * MAILBOX_SLOT,
                                   dtype=torch.uint8)
        self.barrier()
        if self.rank == 0:
            os.unlink(path)

    def barrier(self):
        dist.barrier(group=self.group)

    def slot(self, r, dtype, n):
        """``n`` elements of ``dtype`` at the start of slot ``r`` (slot
        ``size`` is the results')."""
        return self.buf[r * MAILBOX_SLOT:(r + 1) * MAILBOX_SLOT].view(
            dtype)[:n]

    def pieces(self, n, dtype, parts=1):
        """[lo, hi) ranges of ``n`` elements, ``parts`` of each fitting a
        slot."""
        step = max(1, MAILBOX_SLOT // (dtype.itemsize * parts))
        return [(lo, min(n, lo + step)) for lo in range(0, n, step)]

    @staticmethod
    def _reduce(views, op):
        """The elementwise sum (or max) of ``views`` in their order."""
        acc = views[0].clone()
        for v in views[1:]:
            if op == dist.ReduceOp.MAX:
                torch.maximum(acc, v, out=acc)
            else:
                acc += v
        return acc

    def all_reduce(self, flat, op):
        """Sum (or max) of ``flat`` (1-D, contiguous) over the group, in
        place: each rank reduces one chunk of every piece across the
        slots into the results' slot, then all read it."""
        g, me = self.size, self.rank
        for lo, hi in self.pieces(flat.numel(), flat.dtype):
            m = hi - lo
            self.slot(me, flat.dtype, m).copy_(flat[lo:hi])
            self.barrier()
            c = -(-m // g)
            a, b = min(m, me * c), min(m, (me + 1) * c)
            if b > a:
                self.slot(g, flat.dtype, m)[a:b] = self._reduce(
                    [self.slot(r, flat.dtype, m)[a:b] for r in range(g)], op)
            self.barrier()
            # no barrier after the read: a rank writes the results' slot
            # again only after the next piece's first barrier, which
            # every rank reaches once it has read this one
            flat[lo:hi].copy_(self.slot(g, flat.dtype, m))

    def all_gather(self, out, inp):
        """``out`` (g·n) = every rank's ``inp`` (n), in group-rank
        order."""
        g, me, n = self.size, self.rank, inp.numel()
        outv = out.view(g, n)
        for lo, hi in self.pieces(n, inp.dtype):
            self.slot(me, inp.dtype, hi - lo).copy_(inp[lo:hi])
            self.barrier()
            for r in range(g):
                outv[r, lo:hi].copy_(self.slot(r, inp.dtype, hi - lo))
            self.barrier()

    def reduce_scatter(self, out, inp):
        """``out`` (n) = this rank's chunk of the sum, in group-rank
        order, of every rank's ``inp`` (g·n)."""
        g, me, n = self.size, self.rank, out.numel()
        inv = inp.view(g, n)
        for lo, hi in self.pieces(n, inp.dtype, parts=g):
            m = hi - lo
            self.slot(me, inp.dtype, g * m).view(g, m).copy_(inv[:, lo:hi])
            self.barrier()
            out[lo:hi].copy_(self._reduce(
                [self.slot(r, inp.dtype, g * m).view(g, m)[me]
                 for r in range(g)], dist.ReduceOp.SUM))
            self.barrier()


_MAILBOXES = {}


def _mailbox(group):
    """The Mailbox of a gloo ``group`` whose members all run on this host
    (asked of them once, at the group's first collective), else None."""
    key = id(group)
    if key not in _MAILBOXES:
        box = None
        if backend_of(group) == "gloo":
            hosts = [None] * dist.get_world_size(group)
            dist.all_gather_object(hosts, socket.gethostname(), group=group)
            box = Mailbox(group) if len(set(hosts)) == 1 else None
        _MAILBOXES[key] = (group, box)
    return _MAILBOXES[key][1]


def _host(t):
    """A pinned host tensor of ``t``'s shape and dtype (PyTorch caches
    pinned blocks, so a size seen before costs no new pinning)."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def _staged(fn, group, out, *inputs):
    """Run collective ``fn(out, *inputs)`` (``out`` the output, or the
    buffer of an in-place collective when there are no inputs); under
    gloo with CUDA tensors on pinned host copies, the result copied back
    into ``out``."""
    if out.device.type != "cuda" or backend_of(group) != "gloo":
        fn(out, *inputs)
        return out
    host_in = [_host(t).copy_(t) for t in inputs]
    host_out = _host(out)
    if not inputs:
        host_out.copy_(out)
    fn(host_out, *host_in)
    out.copy_(host_out)
    return out


def all_gather_into_tensor(out, inp, group):
    """``out`` (G·n, ...) = the group's ``inp`` (n, ...) in group-rank
    order."""
    inp = inp.contiguous()
    box = _mailbox(group)
    if box is not None:
        box.all_gather(out.view(-1), inp.view(-1))
        return out
    return _staged(lambda o, i: _ALL_GATHER(o, i, group=group), group,
                   out, inp)


def reduce_scatter_tensor(out, inp, group):
    """``out`` (n, ...) = this rank's chunk of the sum over the group of
    ``inp`` (G·n, ...)."""
    inp = inp.contiguous()
    box = _mailbox(group)
    if box is not None:
        box.reduce_scatter(out.view(-1), inp.view(-1))
        return out
    return _staged(lambda o, i: _REDUCE_SCATTER(o, i, group=group), group,
                   out, inp)


def all_reduce(t, group, op=dist.ReduceOp.SUM):
    """In-place all-reduce of ``t`` (contiguous) over ``group``: the sum,
    or with ``op`` MAX the maximum."""
    box = _mailbox(group)
    if box is not None:
        box.all_reduce(t.view(-1), op)
        return t
    return _staged(lambda x: dist.all_reduce(x, op=op, group=group), group,
                   t)


def make_mesh(shape, names, *, backend=None, ranks=None):
    """A :class:`~repro_torch.dist.sharding.Mesh` of ``shape`` with axes
    ``names`` over the current process group: its whole world, whose size
    must be the product of ``shape``, or the world ranks ``ranks`` (a mesh
    of one rank needs no group). Ranks map to coordinates row-major, the
    last axis fastest, as a jax mesh of ``np.array(devices).reshape(shape)``
    does. ``backend`` is the backend of the axis groups (None: the default
    group's)."""
    from repro_torch.dist.sharding import Mesh
    return Mesh(shape, names, backend=backend, ranks=ranks)
