"""The sharding spec engine, ported from ``repro.dist.sharding``: specs
from tree paths, the mesh, and placement of tensors on it.

Trees are the port's nested dicts, addressed by "/"-joined paths; a spec
is the port's own :class:`P`, one entry per dim (None, or a tuple of mesh
axis names). The rules are the reference's, leaf for leaf:

* dense ``w (d_in, d_out)`` and factor ``A (r, d_out)`` shard d_out over
  the model axis; ``B (d_in, r)`` is replicated;
* the row-balanced support ``v``/``cols (d_in, k)`` shards its d_in rows
  over model; an iid COO support (nnz,) is replicated;
* the tile consts ``rows_t``/``cols_t``/``perm`` (nkt, nnt, cap) and the
  quant consts shard their nnt (d_out tile) axis over model; the port's
  own Wᵀ tile consts ``rows_tT``/``cols_tT`` (nnt, nkt, cap) shard their
  axis 0, the same column tiles;
* expert stacks shard the expert dim over model; norms, embeddings and
  routers are replicated;
* under fsdp the data axis is appended to the first matrix dim it
  divides, never reusing an axis; a dim an axis does not divide is
  replicated (:func:`_guard`), never an error.

Where the reference hands its specs to XLA's partitioner, the port places
tensors itself: :class:`Mesh` holds this process's rank on a
``torch.distributed`` world and a process group for every set of axes;
:func:`place` cuts a full tensor to this rank's shard exactly as
``NamedSharding(mesh, spec).devices_indices_map`` does (a dim over
("model", "data") splits model-major, data-minor), :func:`gather` is its
inverse, :func:`reduce_grad` turns a rank's gradient of its local batch
into its shard of the global-batch gradient (summed over the batch axes,
reduce-scattered where the spec holds one), and :func:`is_first_replica`
picks the one rank that counts a replicated shard in a sum over shards.

:func:`constrain` and :func:`constrain_boundary` are the identity: in the
reference they are layout hints to XLA's partitioner, which never change
a value, and the port has no partitioner to hint.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.dist import compat

MODEL_AXIS = "model"
BATCH_AXES = ("pod", "data")


class P(tuple):
    """A partition spec: one entry per dim, None or a tuple of axis
    names (a bare name is taken as a 1-tuple)."""

    def __new__(cls, *entries):
        norm = []
        for e in entries:
            if isinstance(e, str):
                e = (e,)
            norm.append(tuple(e) if e else None)
        return super().__new__(cls, norm)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

class Mesh:
    """Named axes over a ``torch.distributed`` world.

    ``shape`` maps each axis name to its size, as a jax mesh's does; this
    process's rank sits at ``coords`` (row-major over the axes, the last
    fastest). The constructor makes one process group per set of axes
    whose sizes multiply above 1 (every rank must construct the mesh, in
    the same order, as ``new_group`` requires); :meth:`group` returns the
    one that holds this rank, None where the set spans one rank. A mesh of
    size 1 needs no initialized process group.

    ``ranks`` (default: the whole world) puts the mesh on those world
    ranks, in order; every world rank still constructs it (``new_group``
    is collective over the world), and on a rank outside it ``member`` is
    False and nothing may run on it."""

    def __init__(self, shape, names, *, backend=None, ranks=None):
        import torch.distributed as dist
        self.axis_names = tuple(names)
        dims = tuple(int(s) for s in shape)
        if len(dims) != len(self.axis_names):
            raise ValueError(f"mesh shape {dims} vs axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, dims))
        self.size = int(np.prod(dims))
        live = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if live else 1
        me = dist.get_rank() if live else 0
        ranks = list(range(world)) if ranks is None else list(ranks)
        if len(ranks) != self.size or not set(ranks) <= set(range(world)):
            raise ValueError(
                f"a mesh of {self.size} ranks {self.shape} needs that many "
                f"ranks of the world ({world}; initialize the process group "
                f"first), given {ranks}")
        self.member = me in ranks
        self.rank = ranks.index(me) if self.member else 0
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(
                                   self.rank, dims))))
        self.backend = backend or (compat.backend_of(None) if live
                                   else None)
        self._groups = {}
        for n in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, n):
                if self.axis_size(axes) <= 1:
                    continue
                for idx in self._partition(axes):
                    g = dist.new_group([ranks[i] for i in idx],
                                       backend=backend)
                    if self.member and self.rank in idx:
                        self._groups[axes] = g

    def _partition(self, axes):
        """The rank lists of ``axes``'s groups: ranks that agree on every
        other axis, each list sorted."""
        dims = tuple(self.shape[a] for a in self.axis_names)
        coords = np.array(np.unravel_index(np.arange(self.size), dims)).T
        others = [i for i, a in enumerate(self.axis_names) if a not in axes]
        by_key = {}
        for r, c in enumerate(coords):
            by_key.setdefault(tuple(c[others]), []).append(r)
        return [by_key[k] for k in sorted(by_key)]

    def _norm(self, axes) -> Tuple[str, ...]:
        if axes is None:
            return ()
        if isinstance(axes, str):
            axes = (axes,)
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def axis_size(self, axes) -> int:
        return axis_size(self, axes)

    def group(self, axes):
        """The process group over ``axes`` holding this rank (None: the
        axes span this rank alone)."""
        return self._groups.get(self._norm(axes))

    def members(self, axes):
        """Coordinates of ``axes``'s group members in group-rank order
        (global rank order, as ``new_group`` orders them)."""
        axes = self._norm(axes)
        dims = tuple(self.shape[a] for a in self.axis_names)
        for ranks in self._partition(axes):
            if self.rank in ranks:
                return [dict(zip(self.axis_names, (int(c) for c in
                                                   np.unravel_index(r, dims))))
                        for r in ranks]
        return [dict(self.coords)]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank {self.rank})"


def make_production_mesh(*, multi_pod: bool = False, backend=None):
    """16×16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod, as the
    reference's (a world of that size must be initialized)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat.make_mesh(shape, axes, backend=backend)


def make_local_mesh():
    """The (data 1, model 1) mesh of one process, as the reference's
    ``make_local_mesh`` (tests, ``--use-mesh``)."""
    return compat.make_mesh((1, 1), ("data", "model"))


# ---------------------------------------------------------------------------
# The ambient mesh
# ---------------------------------------------------------------------------

_AMBIENT = []


def ambient_mesh():
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return _AMBIENT[-1][0] if _AMBIENT else None


def serving_layout():
    """The :class:`ServingLayout` of the innermost :func:`use_mesh`, or
    None (no mesh, or a mesh that is not serving)."""
    return _AMBIENT[-1][2] if _AMBIENT else None


@contextlib.contextmanager
def use_mesh(mesh, *, global_batch: Optional[int] = None, layout=None):
    """Make ``mesh`` ambient (read by the linears' islands) for the
    block; the port's ``with mesh:``. ``global_batch`` is the batch the
    step's ranks share (None: one that divides over the batch ranks);
    ``layout`` a serving mesh's :class:`ServingLayout`, read by the
    model's cached forward."""
    _AMBIENT.append((mesh, global_batch, layout))
    try:
        yield mesh
    finally:
        _AMBIENT.pop()


def island_mesh(x, d_out: int, *, nnt: Optional[int] = None):
    """The ambient mesh where a linear of input ``x`` (..., d_in) and
    output width ``d_out`` runs its tensor-parallel island, else None: the
    reference's conditions (``core/sltrain.py`` ``_grads_distributed``,
    ``kernels/ops.py`` ``_fused_grads_dist``), checked one by one where the
    reference catches the partitioner's errors. The island needs a mesh
    with a batch axis and a model axis of more than one rank, the global
    batch dividing over the batch ranks, ``d_in <= d_out`` (else its edge
    would gather the larger activation), and d_out dividing over the model
    ranks; the tiled modes (``nnt``, the column-tile count) need an input
    of exactly 3 dims, ``d_out % (TP·128) == 0`` and ``nnt % TP == 0``, the
    dense mode at least 3 dims."""
    if not _AMBIENT:
        return None
    mesh, global_batch, _ = _AMBIENT[-1]
    nb = axis_size(mesh, BATCH_AXES)
    batch = x.shape[0] * nb if global_batch is None else global_batch
    if x.dim() < 3 or (nnt is not None and x.dim() != 3):
        return None
    return mesh if island_engages(mesh, x.shape[-1], d_out, batch,
                                  nnt=nnt) else None


def island_engages(mesh, d_in: int, d_out: int, batch: int, *,
                   nnt: Optional[int] = None) -> bool:
    """:func:`island_mesh`'s conditions on the shapes alone: a batch axis
    whose ranks divide the global ``batch``, a model axis of more than
    one rank dividing ``d_out``, ``d_in <= d_out``, and for a tiled mode
    (``nnt`` column tiles) ``d_out % (TP·128) == 0`` and ``nnt % TP ==
    0``."""
    bt = tuple(a for a in BATCH_AXES if a in mesh.axis_names)
    nm = mesh.shape[MODEL_AXIS] if MODEL_AXIS in mesh.axis_names else 1
    if (d_in > d_out or not bt or batch % axis_size(mesh, bt)
            or nm <= 1 or d_out % nm):
        return False
    return nnt is None or not (d_out % (nm * 128) or nnt % nm)


def axis_size(mesh, names) -> int:
    """Product of the sizes of ``names`` (a name or tuple) on ``mesh``;
    names absent from the mesh count as 1."""
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    return int(np.prod([mesh.shape[a] for a in names
                        if a in mesh.axis_names] or [1]))


def constrain(x, *spec):
    """The identity. The reference's ``constrain`` is a sharding hint to
    XLA (``with_sharding_constraint``) that never changes a value; the
    port places tensors itself and has no partitioner to hint."""
    return x


def constrain_boundary(x, *, seq_sharded: bool = False):
    """The identity, as :func:`constrain` (the reference pins a boundary
    save's batch dim over the batch axes)."""
    return x


# ---------------------------------------------------------------------------
# Path → spec rules
# ---------------------------------------------------------------------------

def _items(tree, prefix=()):
    """(path tuple, leaf) of nested dicts, keys sorted at every level."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def _map(fn, tree, prefix=()):
    """``fn(path tuple, leaf)`` over nested dicts, keeping the structure."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, prefix + (str(k),)) for k, v in tree.items()}
    return fn(prefix, tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(int(s) for s in leaf.shape)


def _guard(dim: int, mesh, names):
    """``names`` (a tuple filtered to the mesh's axes) if they divide
    ``dim``, else None (replicate that dim)."""
    if not names:
        return None
    req = names if isinstance(names, tuple) else (names,)
    tup = tuple(n for n in req if n in mesh.axis_names)
    if not tup:
        return None
    n = axis_size(mesh, tup)
    return tup if dim % max(n, 1) == 0 else None


_REPLICATED_NAMES = frozenset({
    "bias", "ln_attn", "ln_mlp", "ln_attn_post", "ln_mlp_post", "ln_f",
    "q_norm", "k_norm", "embed", "lm_head", "W0",
})


def _base_spec(name: str, keys: Tuple[str, ...], trailing: Tuple[int, ...],
               mesh, model_axis: str):
    """Spec of the trailing (non-stack) dims of one leaf."""
    nd = len(trailing)
    if name in _REPLICATED_NAMES or nd == 0:
        return (None,) * nd
    if name == "w":
        if "router" in keys:
            return (None,) * nd
        if nd >= 2:
            return (None,) * (nd - 1) + (_guard(trailing[-1], mesh,
                                                model_axis),)
        return (None,) * nd
    if name == "B":
        return (None,) * nd
    if name == "A":
        return (None,) * (nd - 1) + (_guard(trailing[-1], mesh, model_axis),)
    if name in ("v", "cols", "rows"):
        if nd >= 2:
            return (_guard(trailing[0], mesh, model_axis),) + \
                (None,) * (nd - 1)
        return (None,) * nd
    if name in ("rows_t", "cols_t", "perm") and nd == 3:
        return (None, _guard(trailing[1], mesh, model_axis), None)
    if name in ("rows_tT", "cols_tT") and nd == 3:
        # Wᵀ's tiles (nnt, nkt, cap): the same column tiles, on axis 0
        return (_guard(trailing[0], mesh, model_axis), None, None)
    if name in ("qv_t", "rows_q", "cols_q") and nd == 3:
        return (None, _guard(trailing[1], mesh, model_axis), None)
    if name == "qscale" and nd == 2:
        return (_guard(trailing[0], mesh, model_axis), None)
    return (None,) * nd


_MATRIX_NDIM = {"w": 2, "B": 2, "A": 2, "cols": 2, "v": 2, "W0": 2,
                "embed": 2, "lm_head": 2,
                "rows_t": 3, "cols_t": 3, "perm": 3, "rows_tT": 3,
                "cols_tT": 3, "qv_t": 3, "rows_q": 3, "cols_q": 3,
                "qscale": 2}


def _append_fsdp(base, trailing, mesh, fsdp_axes, used):
    """The fsdp axes appended to the first trailing dim they divide (on
    top of its TP axes), never reusing a mesh axis; ``base`` unchanged
    where no dim can take them."""
    axes = tuple(a for a in fsdp_axes
                 if a in mesh.axis_names and a not in used)
    if not axes:
        return base
    out = list(base)
    for i, dim in enumerate(trailing):
        cur = out[i] if isinstance(out[i], tuple) else (
            (out[i],) if out[i] else ())
        cand = cur + axes
        if dim % max(axis_size(mesh, cand), 1) == 0:
            out[i] = cand
            return tuple(out)
    return base


def spec_for_param(path, leaf, mesh, *, model_axis: str = MODEL_AXIS,
                   support_layout: Optional[str] = None,
                   fsdp_axes: Tuple[str, ...] = ()) -> P:
    """Spec of one parameter or const leaf at ``path`` (a tuple of keys or
    a "/"-joined string): layer-stack dims lead unsharded, an expert
    stack's dim shards over model, the trailing matrix dims follow
    :func:`_base_spec`, and ``fsdp_axes`` append as :func:`_append_fsdp`
    says. ``support_layout`` ("iid" or "row_balanced", None: row-balanced)
    tells a support leaf's layout, which stacking hides."""
    keys = tuple(path.split("/")) if isinstance(path, str) else \
        tuple(str(k) for k in path)
    name = keys[-1] if keys else ""
    shape = _shape(leaf)
    ndim = len(shape)

    base_nd = min(_MATRIX_NDIM.get(name, 1), ndim)
    if name in ("v", "rows", "cols") and ndim >= 1:
        if support_layout == "iid" or name == "rows":
            base_nd = 1
        else:
            base_nd = min(2, ndim)

    n_lead = ndim - base_nd
    trailing = shape[n_lead:]
    lead = [None] * n_lead
    used_model = False
    if "experts" in keys and n_lead >= 1:
        e_spec = _guard(shape[n_lead - 1], mesh, model_axis)
        if e_spec is not None:
            lead[n_lead - 1] = e_spec
            used_model = True
    if used_model:
        base = (None,) * base_nd
    else:
        base = _base_spec(name, keys, trailing, mesh, model_axis)
    if fsdp_axes and base_nd > 0:
        used = set()
        for s in tuple(lead) + tuple(base):
            used.update(s if isinstance(s, tuple) else ((s,) if s else ()))
        base = _append_fsdp(base, trailing, mesh, fsdp_axes, used)
    return P(*(tuple(lead) + tuple(base)))


def param_specs(params, mesh, *, model_axis: str = MODEL_AXIS,
                fsdp_axes: Tuple[str, ...] = ()):
    """A spec tree mirroring ``params`` (works on meta tensors)."""
    all_paths = {p for p, _ in _items(params)}

    def spec(keys, leaf):
        layout = None
        if keys and keys[-1] in ("v", "cols", "rows"):
            layout = ("iid" if keys[:-1] + ("rows",) in all_paths
                      else "row_balanced")
        return spec_for_param(keys, leaf, mesh, model_axis=model_axis,
                              support_layout=layout, fsdp_axes=fsdp_axes)

    return _map(spec, params)


def batch_specs(batch, mesh, batch_axes: Sequence[str] = BATCH_AXES):
    """The leading (batch) dim of every leaf over ``batch_axes``."""
    axes = tuple(a for a in batch_axes if a in mesh.axis_names)

    def spec(_, leaf):
        shape = _shape(leaf)
        if not shape:
            return P()
        return P(_guard(shape[0], mesh, axes), *([None] * (len(shape) - 1)))

    return _map(spec, batch)


def opt_state_specs(opt_state, p_specs, mesh, *,
                    fsdp_axes: Tuple[str, ...] = ()):
    """Specs of an optimizer state: a moment that mirrors a param leaf
    (AdamW's mu/nu) takes that leaf's spec; state whose shape diverges
    (8-bit codes and scales, GaLore's factors) and scalars are replicated,
    except under fsdp, where such a leaf shards dim 0 over the fsdp axes
    when they divide it (8-bit blocks are per leaf flat, so a dim-0 split
    is a contiguous run of blocks)."""
    by_path = {p: s for p, s in _items(p_specs)}

    def spec(keys, leaf):
        shape = _shape(leaf)
        for i in range(1, len(keys)):
            cand = by_path.get(keys[i:])
            if cand is not None and len(cand) <= len(shape):
                return cand
        if fsdp_axes and shape:
            g = _guard(shape[0], mesh, tuple(fsdp_axes))
            if g is not None:
                return P(g, *([None] * (len(shape) - 1)))
        return P()

    return _map(spec, opt_state)


def cache_specs(cache, mesh, batch_axes: Sequence[str] = BATCH_AXES, *,
                model_axis: str = MODEL_AXIS, seq_sharded: bool = False,
                paged: bool = False, attn_kernel: str = "paged"):
    """KV-cache specs, the reference's: contiguous leaves (..., batch,
    seq, heads, head_dim) shard batch over the batch axes and heads over
    model (``seq_sharded``: the sequence dim over model instead); paged
    pools (..., n_blocks, block_len, heads, head_dim) shard heads over
    model only. The paged kernels stream whole blocks, so a paged cache
    read by them cannot be seq-sharded: that raises."""
    if paged and attn_kernel == "paged" and seq_sharded:
        raise ValueError(
            "attn_kernel='paged' cannot run seq-sharded: the kernel "
            "streams whole K/V blocks per (slot, head) grid cell, so the "
            "sequence/block dims must stay replicated — use the head-"
            "sharded TP layout (default) or attn_kernel='gather'")
    axes = tuple(a for a in batch_axes if a in mesh.axis_names)

    def spec(_, leaf):
        shape = _shape(leaf)
        if len(shape) < 4:
            return P(*([None] * len(shape)))
        n_lead = len(shape) - 4
        d0, d1, h, _ = shape[n_lead:]
        if paged:
            tail = (None, None, _guard(h, mesh, model_axis), None)
        elif seq_sharded:
            tail = (_guard(d0, mesh, axes), _guard(d1, mesh, model_axis),
                    None, None)
        else:
            tail = (_guard(d0, mesh, axes), None,
                    _guard(h, mesh, model_axis), None)
        return P(*([None] * n_lead + list(tail)))

    return _map(spec, cache)


def boundary_save_specs(xs, mesh, batch_axes: Sequence[str] = BATCH_AXES,
                        *, model_axis: str = MODEL_AXIS,
                        seq_sharded: bool = False,
                        fsdp_axes: Tuple[str, ...] = ()):
    """Specs of stacked boundary saves (n_layers, B, S, d): the layer dim
    replicated (or, under fsdp, over the fsdp axes the batch dim could not
    take), batch over the batch axes, seq over model with
    ``seq_sharded``."""
    axes = tuple(a for a in batch_axes if a in mesh.axis_names)

    def spec(_, leaf):
        shape = _shape(leaf)
        if len(shape) < 3:
            return P(*([None] * len(shape)))
        n_lead = len(shape) - 3
        b, s, _ = shape[n_lead:]
        bt = _guard(b, mesh, axes)
        seq = _guard(s, mesh, model_axis) if seq_sharded else None
        lead = [None] * n_lead
        if fsdp_axes and n_lead >= 1:
            rem = tuple(a for a in fsdp_axes if a not in (bt or ()))
            g = _guard(shape[0], mesh, rem) if rem else None
            if g is not None:
                lead[0] = g
        return P(*lead, bt, seq, None)

    return _map(spec, xs)


# ---------------------------------------------------------------------------
# Placement
# ---------------------------------------------------------------------------

def _chunk(entry, coords, mesh) -> Tuple[int, int]:
    """(index, count) of a rank's chunk of a dim split over the axes
    ``entry``: mixed radix, the first axis major."""
    idx, n = 0, 1
    for a in entry or ():
        if a in mesh.axis_names:
            idx = idx * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
    return idx, n


def shard_slices(shape, spec, mesh, coords=None):
    """The slice of each dim that the rank at ``coords`` (default: this
    process's) holds of a tensor of ``shape`` under ``spec``."""
    coords = mesh.coords if coords is None else coords
    out = []
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        idx, n = _chunk(entry, coords, mesh)
        c = dim // n
        out.append(slice(idx * c, (idx + 1) * c))
    return tuple(out)


def place_leaf(t, spec, mesh):
    """This rank's shard of the full tensor ``t`` (a contiguous copy where
    the spec splits it, ``t`` itself where it does not)."""
    sl = shard_slices(t.shape, spec, mesh)
    if all(s.start == 0 and s.stop == d for s, d in zip(sl, t.shape)):
        return t
    return t[sl].contiguous()


def _gather_dim(t, dim, entry, mesh):
    """All-gather ``t`` along ``dim`` over the axes ``entry``, the chunks
    put in the spec's mixed-radix order."""
    group = mesh.group(entry)
    if group is None:
        return t
    members = mesh.members(entry)
    moved = t.movedim(dim, 0).contiguous()
    out = torch.empty((len(members) * moved.shape[0],) + moved.shape[1:],
                      dtype=t.dtype, device=t.device)
    compat.all_gather_into_tensor(out, moved, group)
    parts = out.chunk(len(members))
    order = sorted(range(len(members)),
                   key=lambda g: _chunk(entry, members[g], mesh)[0])
    return torch.cat([parts[g] for g in order]).movedim(0, dim).contiguous()


def gather_leaf(t, spec, mesh):
    """The full tensor from each rank's shard ``t``, contiguous (every
    rank of the mesh calls it, in the same order)."""
    for dim, entry in enumerate(spec):
        if entry and mesh.axis_size(entry) > 1:
            t = _gather_dim(t, dim, entry, mesh)
    return t


def place(tree, mesh, specs=None):
    """This rank's shards of a tree of full tensors per a spec tree
    (default: :func:`param_specs`), as the reference's ``place`` puts them
    on the mesh's devices."""
    if specs is None:
        specs = param_specs(tree, mesh)
    return _zip_map(lambda t, s: place_leaf(t, s, mesh), tree, specs)


def gather(tree, mesh, specs):
    """The full tensors of a tree of shards: :func:`place`'s inverse."""
    return _zip_map(lambda t, s: gather_leaf(t, s, mesh), tree, specs)


def _zip_map(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


class NamedSharding:
    """A spec on a mesh: :meth:`shard` cuts this rank's piece of a full
    tensor (the reference's ``NamedSharding``, for checkpoint restore)."""

    def __init__(self, mesh, spec):
        self.mesh, self.spec = mesh, spec

    def shard(self, t):
        return place_leaf(t, self.spec, self.mesh)


def named_shardings(mesh, spec_tree):
    """A spec tree as :class:`NamedSharding` leaves."""
    return _map(lambda _, s: NamedSharding(mesh, s), spec_tree) \
        if isinstance(spec_tree, dict) else NamedSharding(mesh, spec_tree)


# ---------------------------------------------------------------------------
# Serving on a mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServingLayout:
    """What one rank of a serving mesh holds, decided once by
    :func:`serving_state` and read under :func:`use_mesh` by the model's
    cached forward: ``heads`` (m, TP) where the KV cache holds this
    rank's share m of TP of the kv heads (attention then takes the same
    share of the q heads: whole GQA groups), None where it holds every
    head; ``slots`` this rank's slice of a contiguous cache's slots where
    the batch axes ``slot_axes`` split them, None where every rank holds
    every slot."""
    mesh: object
    heads: Optional[Tuple[int, int]] = None
    slots: Optional[slice] = None
    slot_axes: Optional[tuple] = None

    def head_range(self, n: int) -> slice:
        """This rank's contiguous range of ``n`` heads."""
        m, tp = self.heads
        return slice(m * n // tp, (m + 1) * n // tp)


# the attention projections whose columns are its heads
_HEAD_PROJECTIONS = ("wq", "wk", "wv")


def serving_state(params, consts, cache, mesh, *, exec_mode, n_slots: int,
                  paged: bool, attn_kernel: str, seq_sharded: bool = False,
                  device=None):
    """One rank's serving state, built once: (params, consts, cache,
    :class:`ServingLayout`). ``cache`` is the engine's zero cache on the
    meta device; the rank allocates only its shard of :func:`cache_specs`
    (kv heads over the model axis; a contiguous cache's slots over the
    batch axes too) on ``device``, which the attention kernels read and
    the engine's writes update in place. In exec_mode fused, sparse and
    quant every SLTrain linear whose island engages
    (:func:`island_engages` at the global batch ``n_slots``) is held as
    this rank's column slice (``kernels.ops.serving_columns``); where
    the cache shards the heads, the q/k/v projections keep their columns,
    which are this rank's heads, local. Every other leaf is held whole. A
    dispatch then moves activations only: the all-gathers of the other
    linears' output columns, of the attention heads and, on a contiguous
    cache split over the batch axes, of the logits. A seq-sharded cache is
    refused: the paged kernels' with :func:`cache_specs`'s ``ValueError``,
    as the reference refuses it, any other with ``NotImplementedError``."""
    specs = cache_specs(cache, mesh, paged=paged, attn_kernel=attn_kernel,
                        seq_sharded=seq_sharded)
    if seq_sharded:
        raise NotImplementedError(
            "a seq-sharded KV cache on a serving mesh is not ported yet "
            "(ROADMAP queue A item 10b)")
    cache = _zip_map(lambda t, s: torch.zeros(
        [sl.stop - sl.start for sl in shard_slices(t.shape, s, mesh)],
        dtype=t.dtype, device=device), cache, specs)
    leaf, spec = cache, specs
    while isinstance(leaf, dict):
        key = next(iter(leaf))
        leaf, spec = leaf[key], spec[key]
    lay = {}
    if axis_size(mesh, spec[-2]) > 1:
        lay["heads"] = (mesh.coords[MODEL_AXIS], mesh.shape[MODEL_AXIS])
    if not paged and axis_size(mesh, spec[-4]) > 1:
        lay["slots"] = shard_slices((n_slots,), (spec[-4],), mesh)[0]
        lay["slot_axes"] = spec[-4]
    layout = ServingLayout(mesh, **lay)
    if exec_mode in ("fused", "sparse", "quant"):
        from repro_torch.kernels import ops

        def walk(p, c, name):
            if {"B", "A", "v"} <= set(p):
                return ops.serving_columns(
                    p, c, mesh, exec_mode, n_slots,
                    local=layout.heads is not None
                    and name in _HEAD_PROJECTIONS)
            out_p, out_c = {}, dict(c)
            for k, v in p.items():
                if isinstance(v, dict):
                    out_p[k], sub = walk(v, c.get(k, {}), k)
                    if sub:
                        out_c[k] = sub
                else:
                    out_p[k] = v
            return out_p, out_c
        params, consts = walk(params, consts, None)
    return params, consts, cache, layout


def gather_last(t, mesh, axes=(MODEL_AXIS,)):
    """(..., G·n) from each rank's (..., n) over ``axes``, in their order:
    a linear's output columns, or the attention heads."""
    return gather_leaf(t, (None,) * (t.dim() - 1) + (tuple(axes),), mesh)


# ---------------------------------------------------------------------------
# Gradients on the mesh
# ---------------------------------------------------------------------------

def batch_size_axes(mesh) -> Tuple[str, ...]:
    """The batch axes of ``mesh`` that span more than one rank."""
    return tuple(a for a in BATCH_AXES
                 if a in mesh.axis_names and mesh.shape[a] > 1)


def reduce_grad(g, spec, mesh):
    """This rank's shard of the global-batch gradient, from ``g``, its
    gradient of its local batch with respect to the full leaf: sliced to
    the spec's non-batch (model) chunk, summed over the batch axes (a
    reduce-scatter over a batch axis the spec holds, an all-reduce over
    the others) and divided by the number of batch ranks, so local means
    become the global mean. Only this rank's model chunk of
    ``g`` is read. Returns f32 for a float leaf of any dtype."""
    bt = batch_size_axes(mesh)
    coords = dict(mesh.coords)
    keep, scatter = [], None
    for i, entry in enumerate(spec):
        entry = entry or ()
        b = tuple(a for a in entry if a in bt)
        if b and entry[len(entry) - len(b):] != b:
            raise ValueError(f"spec {spec}: batch axes must be the minor "
                             "end of a dim's axes")
        nb_part = tuple(a for a in entry if a not in bt)
        if b:
            scatter = (i, b)
            # the rank's block of the non-batch axes, all its batch chunks
            idx, n = _chunk(nb_part + b, {**coords, **{a: 0 for a in b}},
                            mesh)
            span = mesh.axis_size(b)
            c = g.shape[i] // n
            keep.append(slice(idx * c, (idx + span) * c))
        else:
            idx, n = _chunk(nb_part, coords, mesh)
            c = g.shape[i] // n
            keep.append(slice(idx * c, (idx + 1) * c))
    g = g[tuple(keep)].float().contiguous()
    rest = tuple(a for a in bt if scatter is None or a not in scatter[1])
    if rest:
        compat.all_reduce(g, mesh.group(rest))
    if scatter is not None:
        dim, axes = scatter
        moved = g.movedim(dim, 0).contiguous()
        out = torch.empty((moved.shape[0] // mesh.axis_size(axes),) +
                          moved.shape[1:], dtype=moved.dtype,
                          device=moved.device)
        compat.reduce_scatter_tensor(out, moved, mesh.group(axes))
        g = out.movedim(0, dim)
    nb = mesh.axis_size(bt)
    return g / nb if nb > 1 else g


def is_first_replica(spec, mesh) -> bool:
    """Whether this rank is the first (coordinate 0 on every axis the
    spec does not split) of the ranks holding its shard."""
    used = {a for e in spec for a in (e or ())}
    return all(mesh.coords[a] == 0 for a in mesh.axis_names if a not in used)
