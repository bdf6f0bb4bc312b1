"""The port's distribution layer (``repro_torch.dist``) against the
reference's (``repro.dist``) on the CPU: the spec engine leaf for leaf on
duck meshes for every registry config (SMOKE, and full size through the
abstract init on the meta device), ``place`` against jax's
``devices_indices_map`` on an 8-device host mesh in a subprocess, the
int8 compression bit for bit against the reference's ``int8_psum`` under
``jax.vmap``, the wire model and ``psum_tree``'s counters, and the
tensor-parallel islands of the dense, fused and sparse linears on gloo
worlds of 2 and 4 spawned ranks against ``jax.grad`` of the reference's
single-device linear, where the gates pass and where each one fails.
Ranks meet through a ``FileStore`` under ``tmp_path`` and never import
jax (``tests/_torch_dist_ranks.py``)."""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _torch_dist_ranks import run_world
from repro.dist import compression as jcomp
from repro.dist import sharding as jshard
from repro.models import registry as jregistry
from repro.optim import optimizers as joptim
from repro_torch.configs.base import OptimizerConfig
from repro_torch.dist import compression, sharding
from repro_torch.models import registry
from repro_torch.models.common import tree_leaves
from repro_torch.optim import optimizers

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

ARCHS = registry.PAPER_ARCHS + registry.ARCHS


class _Mesh:
    """A duck mesh (axis names and sizes only), as tests/test_dist.py
    builds the reference's."""

    def __init__(self, **shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"data16_model16": _Mesh(data=16, model=16),
          "pod2_data16_model16": _Mesh(pod=2, data=16, model=16),
          "pod2_data8_model8": _Mesh(pod=2, data=8, model=8)}


def _norm(spec):
    """A spec of either package as a tuple of (tuple of names | None)."""
    out = []
    for e in spec:
        if isinstance(e, str):
            e = (e,)
        out.append(tuple(e) if e else None)
    return tuple(out)


def _ref_specs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): _norm(s)
            for path, s in flat}


def _port_specs(tree):
    return {path: _norm(s) for path, s in tree_leaves(tree)}


def _same(port, ref, what):
    p, r = _port_specs(port), _ref_specs(ref)
    assert sorted(p) == sorted(r), what
    bad = {k: (p[k], r[k]) for k in r if p[k] != r[k]}
    assert not bad, f"{what}: {bad}"


def _trees(arch, size):
    """(reference params, consts), (port params, consts) of ``arch`` in
    exec_mode fused (its tile consts too): the reference's abstract init,
    the port's SMOKE init on the CPU or full-size abstract init on the
    meta device."""
    get_j = jregistry.get_smoke_config if size == "smoke" \
        else jregistry.get_config
    get_t = registry.get_smoke_config if size == "smoke" \
        else registry.get_config
    mk = lambda c: dataclasses.replace(c, param=dataclasses.replace(
        c.param, exec_mode="fused"))
    jcfg, cfg = mk(get_j(arch)), mk(get_t(arch))
    jp, jc = jregistry.get_api(jcfg).init(jcfg, None)
    tp, tc = registry.get_api(cfg).init(
        cfg, seed=0, device="cpu" if size == "smoke" else "meta")
    return (jp, jc), (tp, tc)


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_match_reference(arch, size):
    """param_specs (fsdp off and on) of params and consts, and
    opt_state_specs of the AdamW and the 8-bit state trees, equal the
    reference's leaf for leaf on the three duck meshes."""
    (jp, jc), (tp, tc) = _trees(arch, size)
    from repro.configs.base import OptimizerConfig as JOptimizerConfig
    states = {name: (jax.eval_shape(joptim.make(JOptimizerConfig(
        name=name)).init, jp), optimizers.make(OptimizerConfig(
            name=name)).init(tp)) for name in ("adamw", "adam8bit")}
    for mname, mesh in MESHES.items():
        for fsdp in ((), ("data",)):
            what = f"{arch} {size} {mname} fsdp={fsdp}"
            jps = jshard.param_specs(jp, mesh, fsdp_axes=fsdp)
            tps = sharding.param_specs(tp, mesh, fsdp_axes=fsdp)
            _same(tps, jps, what + " params")
            _same(sharding.param_specs(tc, mesh, fsdp_axes=fsdp),
                  jshard.param_specs(jc, mesh, fsdp_axes=fsdp),
                  what + " consts")
            for name, (js, ts) in states.items():
                _same(sharding.opt_state_specs(ts, tps, mesh,
                                               fsdp_axes=fsdp),
                      jshard.opt_state_specs(js, jps, mesh, fsdp_axes=fsdp),
                      f"{what} {name} state")


def test_transposed_tile_consts_shard_the_same_column_tiles():
    """The port's own Wᵀ tile consts (nnt, nkt, cap) shard axis 0 over
    model exactly where rows_t (nkt, nnt, cap) shards axis 1, stacked or
    not, and take fsdp on the first dim left."""
    mesh = MESHES["data16_model16"]
    for lead in ((), (4,)):
        for nnt in (32, 86):
            rt = torch.empty(lead + (16, nnt, 40), device="meta")
            rtT = torch.empty(lead + (nnt, 16, 40), device="meta")
            a = sharding.spec_for_param(("x", "rows_t"), rt, mesh)
            b = sharding.spec_for_param(("x", "rows_tT"), rtT, mesh)
            n = len(lead)
            assert a[n + 1] == b[n] == (("model",) if nnt % 16 == 0
                                        else None)
            f = sharding.spec_for_param(("x", "cols_tT"), rtT, mesh,
                                        fsdp_axes=("data",))
            assert (f[n] or ())[:1] == (a[n + 1] or ())[:1]


@pytest.mark.parametrize("arch", ["llama_60m", "gemma2_2b",
                                  "deepseek_moe_16b", "zamba2_7b"])
def test_cache_batch_and_boundary_specs_match_reference(arch):
    """cache_specs on the contiguous and the paged cache, seq-sharded or
    not, the paged + seq-sharded refusal, batch_specs of the launchers'
    input batches and boundary_save_specs of stacked saves equal the
    reference's."""
    from repro.launch import specs as jspecs
    from repro_torch.launch import specs
    jcfg, cfg = jregistry.get_smoke_config(arch), \
        registry.get_smoke_config(arch)
    japi, api = jregistry.get_api(jcfg), registry.get_api(cfg)
    for mname, mesh in MESHES.items():
        for paged in (False, True):
            if paged and api.prefill_step is None:
                continue
            kw = {"paged": True} if paged else {}
            jcache = japi.init_cache(jcfg, 32, 64, abstract=True, **kw)
            tcache = api.init_cache(cfg, 32, 64, device="cpu", **kw)
            for seq in (False, True):
                if paged and seq:
                    for fn, c in ((jshard.cache_specs, jcache),
                                  (sharding.cache_specs, tcache)):
                        with pytest.raises(ValueError, match="seq-sharded"):
                            fn(c, mesh, paged=True, seq_sharded=True)
                    _same(sharding.cache_specs(tcache, mesh, paged=True,
                                               seq_sharded=True,
                                               attn_kernel="gather"),
                          jshard.cache_specs(jcache, mesh, paged=True,
                                             seq_sharded=True,
                                             attn_kernel="gather"),
                          f"{arch} {mname} paged gather seq")
                    continue
                _same(sharding.cache_specs(tcache, mesh, paged=paged,
                                           seq_sharded=seq),
                      jshard.cache_specs(jcache, mesh, paged=paged,
                                         seq_sharded=seq),
                      f"{arch} {mname} paged={paged} seq={seq}")
        for b in (32, 3):
            _same(sharding.batch_specs(specs.input_specs(cfg, b, 16), mesh),
                  jshard.batch_specs(jspecs.input_specs(jcfg, b, 16), mesh),
                  f"{arch} {mname} batch {b}")
            for fsdp in ((), ("data",)):
                for seq in (False, True):
                    for shape in ((4, b, 128, 64), (b, 128, 64)):
                        t = {"xs": torch.empty(shape, device="meta")}
                        j = {"xs": jax.ShapeDtypeStruct(shape, jnp.float32)}
                        _same(sharding.boundary_save_specs(
                            t, mesh, seq_sharded=seq, fsdp_axes=fsdp),
                            jshard.boundary_save_specs(
                                j, mesh, seq_sharded=seq, fsdp_axes=fsdp),
                            f"{arch} boundary {shape} {fsdp} {seq}")


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_specs_match_reference(arch):
    """launch/specs.py: the abstract batch (meta tensors), the decode
    inputs and every shape cell's batch have the reference's shapes and
    dtypes; a concrete batch draws tokens inside the vocabulary."""
    from repro.configs.base import SHAPE_CELLS as JCELLS
    from repro.launch import specs as jspecs
    from repro_torch.configs.base import SHAPE_CELLS
    from repro_torch.launch import specs
    jcfg, cfg = jregistry.get_config(arch), registry.get_config(arch)

    def same(t, j):
        flat_t = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
                  for k, v in tree_leaves(t)}
        flat_j = {k: (tuple(v.shape), str(v.dtype)) for k, v in
                  _ref_leaves(j).items()}
        assert flat_t == flat_j, (flat_t, flat_j)
    same(specs.input_specs(cfg, 4, 64), jspecs.input_specs(jcfg, 4, 64))
    t_tok, t_idx = specs.decode_inputs(cfg, 4, 128)
    j_tok, j_idx = jspecs.decode_inputs(jcfg, 4, 128)
    assert tuple(t_tok.shape) == j_tok.shape and t_idx.dim() == 0
    for cell, jcell in zip(SHAPE_CELLS, JCELLS):
        assert cell == type(cell)(**vars(jcell))
        tb, jb = specs.cell_batch(cfg, cell), jspecs.cell_batch(jcfg, jcell)
        assert (tb is None) == (jb is None)
        if tb is not None:
            same(tb, jb)
    small = registry.get_smoke_config(arch)
    toks = specs.input_specs(small, 2, 8, abstract=False)["tokens"]
    assert toks.dtype == torch.int32 and int(toks.max()) < small.vocab_size


def _ref_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in flat}


_INDICES = """
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
cases = json.loads(sys.stdin.read())
out = []
for shape, names, specs in cases:
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                tuple(names))
    got = []
    for leaf_shape, spec in specs:
        spec = P(*[tuple(e) if e else None for e in spec])
        m = NamedSharding(mesh, spec).devices_indices_map(tuple(leaf_shape))
        flat = list(np.array(mesh.devices).reshape(-1))
        got.append([[[s.start or 0, d if s.stop is None else s.stop]
                     for s, d in zip(m[dev], leaf_shape)] for dev in flat])
    out.append(got)
print(json.dumps(out))
"""


def test_place_matches_devices_indices_map():
    """``shard_slices`` (what ``place`` cuts) gives every rank of a mesh
    the indices jax's ``NamedSharding(mesh, spec).devices_indices_map``
    gives the device at the same row-major position, on 8 host devices:
    the specs of llama_60m SMOKE's params, consts and 8-bit state (fsdp on
    and off) and dims split over two axes (model-major, data-minor)."""
    cfg = dataclasses.replace(registry.get_smoke_config("llama_60m"),
                              d_model=128, d_ff=512)
    cfg = dataclasses.replace(cfg, param=dataclasses.replace(
        cfg.param, exec_mode="fused"))
    params, consts = registry.get_api(cfg).init(cfg, seed=0, device="meta")
    state = optimizers.make(OptimizerConfig(name="adam8bit")).init(params)
    cases = []
    for shape, names in (((2, 4), ("data", "model")),
                         ((2, 2, 2), ("pod", "data", "model")),
                         ((8,), ("pod",)), ((4, 2), ("data", "model"))):
        mesh = _Mesh(**dict(zip(names, shape)))
        specs = [([8, 64], (("model", "data"), None)),
                 ([16, 8], (None, ("data", "model"))),
                 ([24, 8], (("data",), ("model",)))] \
            if "model" in names else []
        for fsdp in ((), ("data",)):
            ps = sharding.param_specs(params, mesh, fsdp_axes=fsdp)
            for tree, sp in ((params, ps),
                             (consts, sharding.param_specs(
                                 consts, mesh, fsdp_axes=fsdp)),
                             (state, sharding.opt_state_specs(
                                 state, ps, mesh, fsdp_axes=fsdp))):
                for (_, leaf), (_, s) in zip(tree_leaves(tree),
                                             tree_leaves(sp)):
                    specs.append((list(leaf.shape), _norm(s)))
        cases.append((list(shape), list(names), specs))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    out = subprocess.run([sys.executable, "-c", _INDICES], input=json.dumps(
        cases), capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    want = json.loads(out.stdout)
    checked = 0
    for (shape, names, specs), got in zip(cases, want):
        mesh = _Mesh(**dict(zip(names, shape)))
        for (leaf_shape, spec), per_dev in zip(specs, got):
            for d, idx in enumerate(per_dev):
                coords = dict(zip(names, (int(c) for c in
                                          np.unravel_index(d, shape))))
                sl = sharding.shard_slices(leaf_shape, spec, mesh, coords)
                assert [[s.start, s.stop] for s in sl] == idx, \
                    (shape, leaf_shape, spec, d)
                checked += 1
    assert checked > 1000


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------

def _summands(p, n, seed=0):
    """p participants' f32 tensors of n elements, the first block all
    zero."""
    x = np.random.default_rng(seed).standard_normal((p, n)).astype(
        np.float32) * np.float32(3.0)
    x[:, :256] = 0
    return x


def _ref_int8_psum(xs):
    return np.asarray(jax.vmap(lambda x: jcomp.int8_psum(x, "pod"),
                               axis_name="pod")(jnp.asarray(xs)))


def _int8_rank(rank, world, xs):
    import torch.distributed as dist
    return compression.int8_psum(torch.from_numpy(xs[rank]),
                                 dist.group.WORLD).numpy()


@pytest.mark.parametrize("p", [2, 4])
def test_int8_psum_matches_reference_bit_for_bit(p, tmp_path):
    """int8_psum on a gloo world of p ranks, and its plain version in one
    process, equal the reference's int8_psum under jax.vmap bit for bit
    (a ragged tail of 77 elements, an all-zero block), on every rank."""
    xs = _summands(p, 5 * 256 + 77, seed=p)
    want = _ref_int8_psum(xs)
    plain = compression.int8_psum_plain([torch.from_numpy(x) for x in xs])
    np.testing.assert_array_equal(plain.numpy(), want[0])
    for got in run_world(p, _int8_rank, tmp_path, xs):
        np.testing.assert_array_equal(got, want[0])
    # one participant, no group: the exact round trip through the codes
    one = compression.int8_psum(torch.from_numpy(xs[0]), None)
    np.testing.assert_array_equal(one.numpy(), _ref_int8_psum(xs[:1])[0])


def test_wire_bytes_matches_reference():
    for n in (1, 255, 256, 1000, 1 << 20):
        for p in (1, 2, 4, 16):
            for comp in (False, True):
                for db in (2, 4):
                    assert compression.wire_bytes(
                        n, compressed=comp, n_participants=p,
                        dtype_bytes=db) == jcomp.wire_bytes(
                        n, compressed=comp, n_participants=p, dtype_bytes=db)


def _psum_tree_rank(rank, world, tree_np):
    import torch.distributed as dist
    from repro_torch.obs import metrics
    reg = metrics.Registry()
    tree = {k: torch.from_numpy(v[rank]) for k, v in tree_np.items()}
    out = compression.psum_tree(tree, dist.group.WORLD, obs=reg,
                                n_participants=world)
    snap = {k: v["value"] for k, v in reg.snapshot().items()}
    from repro_torch.dist import compat
    dm = compat.init_device_mesh("cpu", (world,), ("pod",))
    snap["device mesh"] = (tuple(dm.mesh_dim_names), dm.size())
    return {k: v.numpy() for k, v in out.items()}, snap


def test_psum_tree_matches_reference(tmp_path):
    """psum_tree on a gloo world of 2: a large float leaf through int8 (the
    reference's bits), a small float leaf and an int leaf summed exactly,
    and the counters' values equal the reference's under vmap; compat's
    ``init_device_mesh`` builds the world's DeviceMesh."""
    from repro.obs import metrics as jmetrics
    rng = np.random.default_rng(5)
    tree = {"big": rng.standard_normal((2, 64, 40)).astype(np.float32),
            "small": rng.standard_normal((2, 100)).astype(np.float32),
            "steps": rng.integers(0, 9, (2, 7)).astype(np.int32)}
    reg = jmetrics.Registry()
    want = jax.vmap(lambda t: jcomp.psum_tree(t, "pod", obs=reg,
                                              n_participants=2),
                    axis_name="pod")(jax.tree.map(jnp.asarray, tree))
    ref_snap = {k: v["value"] for k, v in reg.snapshot().items()}
    for got, snap in run_world(2, _psum_tree_rank, tmp_path, tree):
        np.testing.assert_array_equal(got["big"], np.asarray(want["big"][0]))
        np.testing.assert_array_equal(got["small"], tree["small"].sum(0))
        np.testing.assert_array_equal(got["steps"], tree["steps"].sum(0))
        # compat's init_device_mesh spelling builds torch's DeviceMesh
        assert snap.pop("device mesh") == (("pod",), 2)
        assert snap == ref_snap


# ---------------------------------------------------------------------------
# The tensor-parallel islands
# ---------------------------------------------------------------------------

# (name, d_in, d_out, mesh shape (data, model), global batch, x dims,
#  which islands engage: dense, tiled)
ISLANDS = [
    ("pass tp2", 128, 256, (1, 2), 4, 3, True, True),
    ("pass data2 tp2", 128, 256, (2, 2), 4, 3, True, True),
    ("pass tp4", 128, 512, (1, 4), 4, 3, True, True),
    ("fail d_in > d_out", 256, 128, (1, 2), 4, 3, False, False),
    ("fail 2-d input", 128, 256, (1, 2), 4, 2, False, False),
    ("fail batch over data", 128, 256, (2, 2), 3, 3, False, False),
    ("fail tp 1", 128, 256, (2, 1), 4, 3, False, False),
    ("fail d_out % (tp 128)", 128, 384, (1, 2), 4, 3, True, False),
    ("fail tiles over tp4", 128, 768, (1, 4), 4, 3, True, False),
]
SEQ = 8


def _island_inputs(d_in, d_out, batch, ndim, seed):
    """The reference's fused init of one SLTrain linear (its tile consts)
    with B and v drawn, x and the output cotangent w, as numpy."""
    from repro.core import sltrain as jsl
    params, consts = jsl.init_params(jax.random.PRNGKey(seed), d_in, d_out,
                                     8, 0.05, jnp.float32, seed=seed,
                                     exec_mode="fused")
    rng = np.random.default_rng(seed)
    params = {k: np.asarray(v) for k, v in params.items()}
    params["B"] = rng.uniform(-0.5, 0.5, params["B"].shape).astype(
        np.float32)
    shape = (batch, SEQ, d_in) if ndim == 3 else (batch * SEQ, d_in)
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal(shape[:-1] + (d_out,)).astype(np.float32)
    return params, {k: np.asarray(v) for k, v in consts.items()}, x, w


def _ref_island_grads(params, consts, x, w, mode):
    from repro.core import sltrain as jsl

    def loss(p, x):
        y = jsl.sl_matmul(x, p, consts, 0.5, exec_mode=mode)
        return jnp.sum(y * w)
    g = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    return jax.tree.map(np.asarray, g)


def _rows(batch, mesh, coords):
    """(this rank's batch rows, the factor that turns the mean over the
    data ranks of their row sums into the batch's sum): the rows split
    over the data ranks where they divide (the factor: their count),
    else all of them on every rank (1)."""
    bspec = sharding.batch_specs({"x": torch.empty(batch)}, mesh)["x"]
    rows = sharding.shard_slices((batch,), bspec, mesh, coords)[0]
    return rows, mesh.shape["data"] if bspec[0] else 1


def _island_rank(rank, world, shape, batch, cases):
    """Each case's (engaged?, full param grads, this rank's dx rows) on a
    (data, model) mesh of ``shape``: the rank's batch rows forward and
    backward under ``use_mesh``, its param grads reduced to shards
    (summed over the data ranks) and gathered whole."""
    from repro_torch.core import sltrain
    from repro_torch.kernels import ops
    mesh = sharding.Mesh(shape, ("data", "model"))
    out = []
    for mode, (params, consts, x, w) in cases:
        rows, n_batch = _rows(x.shape[0], mesh, mesh.coords)
        p = {k: torch.from_numpy(v).requires_grad_(True)
             for k, v in params.items()}
        c = ops.add_transposed_tiles({k: torch.from_numpy(v)
                                      for k, v in consts.items()})
        xl = torch.from_numpy(x[rows]).requires_grad_(True)
        with sharding.use_mesh(mesh, global_batch=x.shape[0]):
            engaged = (sharding.island_mesh(xl, w.shape[-1]) is not None,
                       sharding.island_mesh(
                           xl, w.shape[-1], nnt=c["rows_t"].shape[1])
                       is not None)
            y = sltrain.sl_matmul(xl, p, c, 0.5, mode)
        (y * torch.from_numpy(w[rows])).sum().backward()
        specs = sharding.param_specs(p, mesh)
        # reduce_grad averages over the data ranks; the loss here sums
        full = {k: (sharding.gather_leaf(sharding.reduce_grad(
            t.grad, specs[k], mesh), specs[k], mesh) * n_batch).numpy()
            for k, t in p.items()}
        out.append((engaged, full, xl.grad.numpy()))
    return out


def _close(got, want, what):
    """f32 sums in another order: within 1e-5 of the leaf's largest
    magnitude."""
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale,
                               err_msg=what)


@pytest.fixture(scope="module")
def island_results(tmp_path_factory):
    """{case name: (cases, reference grads, each rank's results)}: the
    cases grouped by mesh shape, one gloo world each."""
    by_shape = {}
    for i, case in enumerate(ISLANDS):
        name, d_in, d_out, shape, batch, ndim, _, _ = case
        cases, wants = [], []
        for j, mode in enumerate(("dense", "fused", "sparse")):
            params, consts, x, w = _island_inputs(d_in, d_out, batch, ndim,
                                                  seed=11 + 3 * i + j)
            cases.append((mode, (params, consts, x, w)))
            wants.append(_ref_island_grads(params, consts, x, w, mode))
        by_shape.setdefault((shape, batch), []).append((name, cases, wants))
    out = {}
    for (shape, batch), group in by_shape.items():
        flat = [c for _, cases, _ in group for c in cases]
        results = run_world(shape[0] * shape[1], _island_rank,
                            tmp_path_factory.mktemp("islands"), shape, batch,
                            flat)
        for k, (name, cases, wants) in enumerate(group):
            out[name] = (cases, wants, [r[3 * k:3 * k + 3] for r in results])
    return out


@pytest.mark.parametrize("case", ISLANDS, ids=[c[0] for c in ISLANDS])
def test_islands_match_reference_gradients(case, island_results):
    """The dense-mode island (``core.sltrain._grads_distributed``) and the
    fused and sparse TP linears (``kernels.ops._SLLinearTP``,
    ``_SLSparseTP``) on a gloo world give jax.grad of the reference's
    single-device linear (dB, dA, dV and dx; ``_close``), and engage
    exactly where the reference's gates would: a 3-dim input (at least 3
    for the dense island), d_in ≤ d_out, the batch dividing over the data
    ranks, TP > 1, d_out % TP == 0, and for the tiled modes
    d_out % (TP·128) == 0 and nnt % TP == 0. Where a gate fails the
    linear runs the one-card path on the full operands."""
    name, d_in, d_out, shape, batch, ndim, dense_on, tiled_on = case
    cases, wants, results = island_results[name]
    mesh = _Mesh(data=shape[0], model=shape[1])
    for rank, res in enumerate(results):
        coords = dict(zip(("data", "model"),
                          (int(c) for c in np.unravel_index(rank, shape))))
        for (mode, (_, _, x, _)), (engaged, full, dx), (gp, gx) in zip(
                cases, res, wants):
            rows, _ = _rows(x.shape[0], mesh, coords)
            assert engaged == (dense_on, tiled_on), (name, engaged)
            for k in ("B", "A", "v"):
                _close(full[k], gp[k], f"{name} {mode} {k}")
            _close(dx, gx[rows], f"{name} {mode} dx")


def test_island_gate_needs_an_ambient_mesh_and_a_batch_axis():
    """No ambient mesh, or a mesh without a batch axis (the reference's
    ``not bt``), never engages; a (1, 1) mesh's model axis of one rank
    never either."""
    x = torch.zeros(2, 4, 128)
    assert sharding.island_mesh(x, 256) is None
    with sharding.use_mesh(_Mesh(model=2)):
        assert sharding.island_mesh(x, 256, nnt=2) is None
    with sharding.use_mesh(sharding.make_local_mesh()):
        assert sharding.island_mesh(x, 256) is None
    with sharding.use_mesh(_Mesh(data=1, model=2)):
        assert sharding.island_mesh(x, 256, nnt=2) is not None
