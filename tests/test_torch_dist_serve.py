"""The port's ``ServeEngine`` on a mesh against the port's one-process
engine and the reference's single-device engine, on gloo worlds of
spawned CPU ranks (``_torch_dist_ranks``): a world of 2 ranks runs the
(data 1, model 2) cases, a world of 4 the (data 1, model 4) and the
(data 2, model 2) ones.

Configs, in f32 with B in ±0.5 and the zero leaves (qwen2.5's qkv bias)
drawn as ``tests/_torch_parity.py`` draws them: ``llama_60m`` SMOKE
widened so that the tensor-parallel island engages at TP 2 and TP 4
(d_model and the q/k/v/o widths 512, 4 heads of 128, d_ff 1024; w_down,
1024 → 512, has d_in > d_out and runs whole), and ``qwen2_5_32b`` SMOKE
(GQA: 4 q heads on 2 kv heads, and the bias), whose kv heads a TP-2 mesh
shards and a TP-4 mesh leaves replicated (``cache_specs``' ``_guard``).
Each case runs exec_mode dense, fused, sparse or quant on the paged cache
(prefix sharing: the kernel read or the gathered read) or the contiguous
one. Held per case: every rank's requests (tokens, statuses, ticks) equal
each other's, the one-process port engine's and the reference's (its
dense engine with the gathered read for dense, fused and sparse, the same
f32 tokens; its quant engine on its own calibration for quant); each
rank's cache leaves have ``cache_specs``' shard shapes; the linears held
as column slices are exactly those whose island engages, the q/k/v
projections' kept local where the cache shards the heads; and every
dispatch all-gathers exactly its activations (the other island outputs'
columns, the attention heads, the logits of a contiguous cache split over
data), runs no other collective and moves no weight leaf."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_dist_ranks import (SERVE_KW, run_world, serve_engine,
                               serve_prompts, serve_rank, serve_run)
from _torch_parity import _fill
from repro.models import registry as jregistry
from repro.quant import calibrate as jcalibrate
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.ckpt.convert import from_jax_numpy
from repro_torch.models import registry

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

WIDE = dict(d_model=512, d_ff=1024, n_heads=4, n_kv_heads=4)
ARCHS = {"llama": ("llama_60m", WIDE), "qwen": ("qwen2_5_32b", {})}

# (id, mesh shape (data, model), arch, paged, exec_mode, attn_kernel)
CASES = [
    ("model2 llama paged fused", (1, 2), "llama", True, "fused", "paged"),
    ("model2 llama paged dense gather", (1, 2), "llama", True, "dense",
     "gather"),
    ("model2 llama contiguous sparse", (1, 2), "llama", False, "sparse",
     None),
    ("model2 llama paged quant", (1, 2), "llama", True, "quant", "paged"),
    ("model2 qwen paged fused", (1, 2), "qwen", True, "fused", "paged"),
    ("model2 qwen contiguous fused", (1, 2), "qwen", False, "fused", None),
    ("model4 llama paged fused", (1, 4), "llama", True, "fused", "paged"),
    ("model4 llama paged sparse", (1, 4), "llama", True, "sparse", "paged"),
    ("model4 llama paged quant", (1, 4), "llama", True, "quant", "paged"),
    ("model4 llama contiguous fused", (1, 4), "llama", False, "fused",
     None),
    ("model4 llama paged fused gather", (1, 4), "llama", True, "fused",
     "gather"),
    ("model4 qwen paged fused", (1, 4), "qwen", True, "fused", "paged"),
    ("model4 qwen contiguous dense", (1, 4), "qwen", False, "dense", None),
    ("data2 model2 llama contiguous fused", (2, 2), "llama", False, "fused",
     None),
    ("data2 model2 llama contiguous dense", (2, 2), "llama", False, "dense",
     None),
    ("data2 model2 llama contiguous quant", (2, 2), "llama", False, "quant",
     None),
    ("data2 model2 llama paged fused", (2, 2), "llama", True, "fused",
     "paged"),
    ("data2 model2 llama paged sparse gather", (2, 2), "llama", True,
     "sparse", "gather"),
    ("data2 model2 qwen contiguous fused", (2, 2), "qwen", False, "fused",
     None),
]


def _cfgs(arch, exec_mode):
    """(reference, port) SMOKE config of ``arch`` in f32 with
    ``exec_mode``."""
    name, kw = ARCHS[arch]

    def mk(reg):
        c = dataclasses.replace(reg.get_smoke_config(name), dtype="float32",
                                **kw)
        return dataclasses.replace(c, param=dataclasses.replace(
            c.param, exec_mode=exec_mode))
    return mk(jregistry), mk(registry)


def _to_np(t):
    return {k: _to_np(v) for k, v in t.items()} if isinstance(t, dict) \
        else t.numpy()


@pytest.fixture(scope="module")
def weights():
    """{tree key: (reference params, reference consts, the port's as
    numpy)}: each arch's reference fused init (supports and tile consts)
    with the leaves drawn, and "quant", the reference's calibration of
    the llama one."""
    out = {}
    for i, arch in enumerate(ARCHS):
        jcfg, _ = _cfgs(arch, "fused")
        params, consts = jregistry.get_api(jcfg).init(
            jcfg, jax.random.PRNGKey(i), seed=0)
        np_p = jax.tree_util.tree_map_with_path(
            _fill(np.random.default_rng(1 + i)), params)
        np_c = jax.tree.map(np.asarray, consts)
        out[arch] = (jax.tree.map(jnp.asarray, np_p), consts,
                     [_to_np(t) for t in from_jax_numpy(np_p, np_c, "cpu")])
    jp, jc = out["llama"][:2]
    qp, qc, _ = jcalibrate.calibrate_model(_cfgs("llama", "quant")[0], jp,
                                           jc)
    np_qp, np_qc = (jax.tree.map(np.asarray, t) for t in (qp, qc))
    out["quant"] = (qp, qc, [_to_np(t) for t in from_jax_numpy(
        np_qp, np_qc, "cpu")])
    return out


def _key(arch, mode):
    return "quant" if mode == "quant" else arch


@pytest.fixture(scope="module")
def served(weights, tmp_path_factory):
    """{case id: each rank's results}: one world of 2 ranks, one of 4."""
    tmp = tmp_path_factory.mktemp("serve")
    trees = {k: w[2] for k, w in weights.items()}
    out = {}
    for world, shapes in ((2, [(1, 2)]), (4, [(1, 4), (2, 2)])):
        meshes = [(s, [(c[0], _key(c[2], c[4]), _cfgs(c[2], c[4])[1], c[3],
                        c[4], c[5]) for c in CASES if c[1] == s])
                  for s in shapes]
        ranks = run_world(world, serve_rank, tmp, meshes, trees)
        for s, cases in meshes:
            for c in cases:
                out[c[0]] = [r[c[0]] for r in ranks]
    return out


_ONE, _REF = {}, {}


def _one_process(weights, arch, paged, mode, attn):
    key = (arch, paged, mode, attn)
    if key not in _ONE:
        cfg = _cfgs(arch, mode)[1]
        _ONE[key] = serve_run(serve_engine(cfg, weights[_key(arch, mode)][2],
                                           paged=paged, exec_mode=mode,
                                           attn_kernel=attn),
                              serve_prompts(cfg.vocab_size, paged))
    return _ONE[key]


def _reference(weights, arch, paged, mode):
    """The reference's single-device engine: quant on its calibration,
    else dense (the same f32 tokens as fused and sparse), the paged
    cache read through its gathered view."""
    mode = "quant" if mode == "quant" else "dense"
    key = (arch, paged, mode)
    if key not in _REF:
        jcfg = _cfgs(arch, mode)[0]
        jp, jc, _ = weights[_key(arch, mode)]
        eng = JaxEngine(jcfg, jp, jc, paged=paged, prefix_sharing=paged,
                        attn_kernel="gather" if paged else None, **SERVE_KW)
        _REF[key] = serve_run(eng, serve_prompts(jcfg.vocab_size, paged))
    return _REF[key]


def _island(d_in, d_out, tp, dp, mode):
    """Whether the island engages for a (d_in, d_out) linear: the
    reference's conditions (``dist/sharding.py::island_engages``)."""
    nnt = -(-d_out // 128)
    return (mode != "dense" and d_in <= d_out and SERVE_KW["n_slots"] % dp
            == 0 and d_out % (tp * 128) == 0 and nnt % tp == 0)


def _expected(cfg, shape, paged, mode):
    """(cache leaf shape, {linear path: (its column-slice width, consts
    key)}, the elements a dispatch of (B, S) tokens all-gathers) of one
    rank. Where the cache shards the heads, the q/k/v projections' column
    slices are the rank's heads and are not all-gathered."""
    dp, tp = shape
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nkv = cfg.n_heads, cfg.n_kv_heads
    heads = nkv % tp == 0
    kv = (nkv // tp if heads else nkv, hd)
    n = SERVE_KW["n_slots"]
    split = not paged and n % dp == 0 and dp > 1
    if paged:
        per = -(-SERVE_KW["max_len"] // SERVE_KW["block_len"])
        lead = (1 + n * per, SERVE_KW["block_len"])
    else:
        lead = (n // dp if split else n, SERVE_KW["max_len"])
    cache = (cfg.n_layers,) + lead + kv
    linears = {"attn/wq": (d, nh * hd), "attn/wk": (d, nkv * hd),
               "attn/wv": (d, nkv * hd), "attn/wo": (nh * hd, d),
               "mlp/gate": (d, cfg.d_ff), "mlp/up": (d, cfg.d_ff),
               "mlp/down": (cfg.d_ff, d)}
    heads = heads and tp > 1
    cols = {f"layers/k0/{k}": (do // tp, "tp_heads" if heads and k in (
        "attn/wq", "attn/wk", "attn/wv") else "tp")
        for k, (di, do) in linears.items() if _island(di, do, tp, dp, mode)}
    per_row = cfg.n_layers * (sum(w for w, key in cols.values()
                                  if key == "tp") +
                              (nh // tp * hd if heads else 0))

    def gathered(tokens):
        rows = tokens[0] // dp if split else tokens[0]
        return rows * tokens[1] * (per_row + (cfg.padded_vocab if split
                                              else 0))
    return cache, cols, gathered


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_mesh_engine_matches_one_process_and_reference(case, served,
                                                       weights):
    name, shape, arch, paged, mode, attn = case
    ranks = served[name]
    want = _one_process(weights, arch, paged, mode, attn)
    for r, got in enumerate(ranks):
        assert got["requests"] == want, (name, r)
    assert want == _reference(weights, arch, paged, mode), name
    assert all(s == "done" for _, s, *_ in want)
    cfg = _cfgs(arch, mode)[1]
    cache, cols, gathered = _expected(cfg, shape, paged, mode)
    for r, got in enumerate(ranks):
        assert set(got["cache"].values()) == {cache}, (name, r, got["cache"])
        assert got["columns"] == cols, (name, r)
        assert got["others"] == 0 and not got["weights_moved"], (name, r)
        assert got["dispatches"], name
        for tokens, numels in got["dispatches"]:
            assert sum(numels) == gathered(tokens), (name, r, tokens, numels)


class _Mesh:
    """A duck mesh of one process at one coordinate: (data 1, model TP)
    at model coordinate ``m``, or with ``dp`` (data DP, model 1) at data
    coordinate ``m``. Enough for ``serving_columns`` and the placement of
    a dense engine's cache, which read shapes and coordinates only."""

    def __init__(self, tp, m, dp=None):
        self.axis_names = ("data", "model")
        if dp is None:
            self.shape = {"data": 1, "model": tp}
            self.coords = {"data": 0, "model": m}
        else:
            self.shape = {"data": dp, "model": 1}
            self.coords = {"data": m, "model": 0}
        self.size = tp if dp is None else dp


@pytest.mark.parametrize("mode", ["fused", "sparse", "quant"])
def test_column_slices_give_the_whole_linears_columns(weights, mode):
    """Each model rank's column slice of a stacked linear (the up
    projection of both layers, 512 → 1024) at TP 2 and 4, run through the
    one forward of a rank's slice (``ops._Local.forward``, the kernels'
    plain versions here) without the all-gather, gives exactly its
    columns of the one-process linear's output (the kernels compute each
    column tile alone); held as a projection's heads (``local``) the same
    tiles sit under ``"tp_heads"``."""
    from repro_torch.core import sltrain
    from repro_torch.kernels import ops
    _, cfg = _cfgs("llama", mode)
    p, c = (weights[_key("llama", mode)][2][i]["layers"]["k0"]["mlp"]["up"]
            for i in range(2))
    p = {k: torch.from_numpy(v) for k, v in p.items()}
    c = {k: torch.from_numpy(v) for k, v in c.items()}
    scale = cfg.param.alpha / p["B"].shape[-1]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, 3, 512)).astype(np.float32))
    for layer in range(2):
        one = {k: v[layer] for k, v in p.items()}
        whole = sltrain.sl_matmul(x, one, {k: v[layer] for k, v in c.items()},
                                  scale, mode)
        for tp in (2, 4):
            parts = []
            for m in range(tp):
                mesh = _Mesh(tp, m)
                lp, lc = ops.serving_columns(p, c, mesh, mode, 4)
                assert set(lc) == {"tp"} and "v" not in lp
                _, heads = ops.serving_columns(p, c, mesh, mode, 4,
                                               local=True)
                assert set(heads) == {"tp_heads"}
                for k, t in lc["tp"].items():
                    torch.testing.assert_close(heads["tp_heads"][k], t,
                                               rtol=0, atol=0)
                tiles = {k: v[layer] for k, v in lc["tp"].items()}
                parts.append(ops._Local(mesh, lp["A"][layer], tiles).forward(
                    x, lp["B"][layer], scale, mode, gather=False))
            torch.testing.assert_close(torch.cat(parts, -1), whole, rtol=0,
                                       atol=0)
    # a linear whose island does not engage (d_in > d_out) stays whole
    down = [weights[_key("llama", mode)][2][i]["layers"]["k0"]["mlp"]["down"]
            for i in range(2)]
    lp, lc = ops.serving_columns(*down, _Mesh(2, 1), mode, 4)
    assert lp is down[0] and lc is down[1]


def test_mesh_engine_allocates_only_its_cache_shard(monkeypatch):
    """A mesh engine never allocates the whole KV cache: it builds the
    cache on the meta device (shapes only) and each rank allocates its
    ``cache_specs`` shard (here rank 1 of a (data 1, model 2) mesh: half
    the kv heads; of a (data 2, model 1) mesh on the contiguous cache:
    half the slots), and its layout says so."""
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    cfg = _cfgs("llama", "dense")[1]
    params, consts = lm.init_lm(cfg, device="cpu")
    devices = []
    init_cache = lm.init_cache

    def spy(*a, **k):
        devices.append(str(k.get("device")))
        return init_cache(*a, **k)
    monkeypatch.setattr(lm, "init_cache", spy)
    for paged, mesh in ((True, _Mesh(2, 1)), (False, _Mesh(2, 1, dp=2))):
        eng = ServeEngine(cfg, params, consts, paged=paged,
                          attn_kernel="paged" if paged else None,
                          mesh=mesh, device="cpu", **SERVE_KW)
        lay = eng.placement
        k = eng.cache["layers"]["k0"]["k"]
        if paged:
            assert k.shape[-2] == cfg.n_kv_heads // 2
            assert lay.heads == (1, 2) and lay.slots is None
        else:
            assert k.shape[1] == SERVE_KW["n_slots"] // 2
            assert k.shape[-2] == cfg.n_kv_heads and lay.heads is None
            assert lay.slots == slice(2, 4) and lay.slot_axes == ("data",)
        assert k.device.type == "cpu" and not k.any()
    assert devices == ["meta", "meta"]


def test_refusals_name_item_10b():
    """On a mesh: MoE expert stacks, the other families, a wall-clock
    deadline across ranks and a seq-sharded cache raise naming ROADMAP
    queue A item 10b; a seq-sharded cache on the paged kernels' pools
    raises the reference's ValueError."""
    from repro_torch.dist import sharding
    from repro_torch.models import lm
    from repro_torch.serve.engine import ServeEngine
    local = sharding.make_local_mesh()
    kw = dict(max_len=32, device="cpu")
    for arch in ("deepseek_moe_16b", "gemma2_2b", "paligemma_3b",
                 "zamba2_7b", "xlstm_350m", "whisper_large_v3"):
        with pytest.raises(NotImplementedError, match="item 10b"):
            ServeEngine(registry.get_smoke_config(arch), None, None,
                        mesh=local, **kw)
    cfg = registry.get_smoke_config("llama_60m")
    with pytest.raises(NotImplementedError, match="item 10b"):
        ServeEngine(cfg, None, None, mesh=_Mesh(2, 0), deadline_ms=5.0, **kw)
    params, consts = lm.init_lm(cfg, device="cpu")
    seq = dataclasses.replace(cfg, seq_shard_activations=True)
    with pytest.raises(ValueError, match="seq-sharded"):
        ServeEngine(seq, params, consts, paged=True, mesh=local, **kw)
    for paged in (False, True):
        with pytest.raises(NotImplementedError, match="item 10b"):
            ServeEngine(seq, params, consts, paged=paged, mesh=local,
                        attn_kernel="gather" if paged else None, **kw)


@pytest.mark.parametrize("flags", [[], ["--paged", "--prefix-sharing",
                                        "--exec-mode", "fused"]],
                         ids=["contiguous", "paged fused"])
def test_launcher_use_mesh_serves_the_same_tokens(flags, capsys):
    """``launch/serve.py --use-mesh`` serves on the local (data 1, model
    1) mesh, as the reference's launcher does: the same requests and
    tokens as without it."""
    from repro_torch.launch import serve
    argv = ["--arch", "llama_60m", "--smoke", "--requests", "3", "--slots",
            "2", "--max-len", "32", "--new-tokens", "4", "--device",
            "cpu"] + flags
    runs = []
    for extra in ([], ["--use-mesh"]):
        eng, reqs = serve.main(argv + extra)
        runs.append([(r.uid, r.status, r.out) for r in reqs])
        assert (eng.mesh is not None) == bool(extra)
    assert runs[0] == runs[1]
    assert "/mesh" in capsys.readouterr().out
