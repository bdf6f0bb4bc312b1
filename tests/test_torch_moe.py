"""The MoE family of the port against the reference on the CPU, on the
SMOKE configs of ``deepseek_moe_16b`` (8 routed experts top-2, one shared
expert, a dense first layer) and ``qwen3_moe_235b`` (8 experts top-2, no
shared expert, QK-norm, GQA), in f32 from one reference init carried over
with ``from_jax_numpy``, the reference under ``jax.jit`` (its Pallas
kernels in interpret mode in exec_mode fused), the port through its
kernels' plain versions. B, the norms and the QK-norm weights are drawn
non-zero (the init's zeros and ones would hide bugs in those paths):

* ``apply_moe`` alone (outputs and aux) on both archs, with a router
  skewed so that capacity drops happen, with exact ties in the router,
  and with ``moe_groups=2``;
* the grouped kernels' plain versions and the grouped fused linear
  against a loop of the single-matrix ones, bit for bit;
* forward logits and aux in exec_mode dense and fused;
* prefill and per-slot decode logits and K/V on the paged and the
  contiguous cache, through deepseek's dense prefix;
* the paged engine's tokens tick for tick in dense, fused and sparse, and
  the reference's co-batching behaviour (capacity follows every slot of
  the batch, ROADMAP queue C reference behaviour 8);
* the supports and tile consts of the port's own init, the 6·N·D counts;
* exec_mode quant on the expert stack: the grouped sparse-decode
  kernels' plain versions and the grouped decode ops against a loop of
  the single ones (E = 1 too), the calibration of both configs (each
  expert's codes, scales and layout bit for bit, the fold and
  ``max_abs_err`` as ``test_torch_quant.py`` holds a single linear), the
  quant forward logits, the paged and contiguous engines' tokens tick
  for tick on one calibrated artifact, and the calibrate CLI and the
  serve launcher on deepseek's smoke config (a checkpoint of either
  package).

``tests/test_torch_moe_train.py`` holds the training side.

Tolerances: logits and K/V 1e-4 absolute and relative (f32, sums in
another order; the combine sums each token's k slots in k order where the
reference scatter-adds them in XLA's order); aux 1e-6 (a mean of f32
probabilities); the grouped kernels' plain paths bit for bit; the
calibration's fold 1e-5 of its largest entry and ``max_abs_err`` 1e-6
(``FOLD_RTOL``, ``ERR_ATOL``: an SVD in another library, f32).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import roofline as jroofline
from repro.ckpt import checkpoint as jckpt
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import registry as jregistry
from repro.quant import calibrate as jcalibrate
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.analysis import roofline
from repro_torch.ckpt import checkpoint as ckpt_lib
from repro_torch.ckpt.convert import from_jax_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sddmm as sddmm_kernel
from repro_torch.kernels import sl_matmul as sl_kernel
from repro_torch.kernels import sparse_decode as sd_kernel
from repro_torch.models import common, mlp, registry
from repro_torch.models.common import tree_leaves
from repro_torch.quant import calibrate
from repro_torch.serve.engine import ServeEngine

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

ARCHS = ("deepseek_moe_16b", "qwen3_moe_235b")
TOL = 1e-4
AUX_TOL = 1e-6
FOLD_RTOL = 1e-5
ERR_ATOL = 1e-6
QUANT_KEYS = ("qv_t", "rows_q", "cols_q", "qscale")


def _cfgs(arch, exec_mode="fused", attn_kernel="paged", **kw):
    def mk(cfg):
        return dataclasses.replace(
            cfg, dtype="float32", attn_kernel=attn_kernel,
            param=dataclasses.replace(cfg.param, exec_mode=exec_mode), **kw)
    return (mk(jregistry.get_smoke_config(arch)),
            mk(registry.get_smoke_config(arch)))


def _fill(rng):
    """B uniform in ±1, norms (the QK-norm's too) in 1 ± 0.3."""
    def fill(path, leaf):
        name = str(path[-1].key)
        if name == "B":
            return rng.uniform(-1, 1, leaf.shape).astype(np.float32)
        if name.startswith("ln") or name.endswith("_norm"):
            return rng.uniform(0.7, 1.3, leaf.shape).astype(np.float32)
        return np.asarray(leaf)
    return fill


_INITS, _WEIGHTS = {}, {}


def _weights(arch):
    """The reference's fused init of ``arch`` with B and the norms drawn,
    as jax arrays and as the port's tensors (cached per arch)."""
    if arch not in _WEIGHTS:
        jcfg, _ = _cfgs(arch)
        params, consts = jregistry.get_api(jcfg).init(
            jcfg, jax.random.PRNGKey(0), seed=0)
        np_params = jax.tree_util.tree_map_with_path(
            _fill(np.random.default_rng(1)), params)
        np_consts = jax.tree.map(np.asarray, consts)
        tp, tc = from_jax_numpy(np_params, np_consts, device="cpu")
        _WEIGHTS[arch] = (jax.tree.map(jnp.asarray, np_params), consts, tp,
                          ops.add_transposed_tiles(tc))
    return _WEIGHTS[arch]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


# ---------------------------------------------------------------------------
# the MoE block alone
# ---------------------------------------------------------------------------

def _moe_block(arch, exec_mode="fused", router=None, **cfg_kw):
    """(jcfg, cfg, reference params/consts, port params/consts) of one MoE
    block built by ``init_moe`` at the blocks' path, B drawn; ``router``
    (numpy) replaces the router's w. Built in exec_mode fused (the tile
    consts every mode's kernels read; the reference's sparse mode reads
    only the support)."""
    jcfg, cfg = _cfgs(arch, exec_mode, **cfg_kw)
    jfused, _ = _cfgs(arch, "fused", **cfg_kw)
    jp, jc = jmlp.init_moe(jcommon.Builder(jfused, jax.random.PRNGKey(0),
                                           "/blocks/p0/k0/moe", seed=3),
                           jfused)
    np_params = jax.tree_util.tree_map_with_path(
        _fill(np.random.default_rng(5)), jp)
    if router is not None:
        np_params["router"]["w"] = router.astype(np.float32)
    np_consts = jax.tree.map(np.asarray, jc)
    tp, tc = from_jax_numpy(np_params, np_consts, device="cpu")
    return (jcfg, cfg, jax.tree.map(jnp.asarray, np_params), jc, tp,
            ops.add_transposed_tiles(tc))


def _run_moe(jcfg, cfg, jp, jc, tp, tc, x):
    jy, jaux = jax.jit(lambda p, c, x: jmlp.apply_moe(jcfg, p, c, x))(
        jp, jc, jnp.asarray(x))
    ty, taux = mlp.apply_moe(cfg, tp, tc, torch.from_numpy(x))
    return (ty, taux), (np.asarray(jy), float(jaux))


def _x(cfg, rows=3, seq=8, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (rows, seq, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("exec_mode", ["dense", "fused", "sparse"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, exec_mode):
    """Outputs and aux of one MoE block, 24 tokens (capacity 7 of 48
    slots: some drops), in each exec mode the experts run."""
    jcfg, cfg, jp, jc, tp, tc = _moe_block(arch, exec_mode)
    (ty, taux), (jy, jaux) = _run_moe(jcfg, cfg, jp, jc, tp, tc, _x(cfg))
    _close(ty, jy)
    np.testing.assert_allclose(float(taux), jaux, atol=AUX_TOL,
                               rtol=AUX_TOL)


def test_capacity_drops_match_reference():
    """A router skewed to expert 0 (its column scaled up) overflows its
    capacity: the port drops the same (token, k) slots as the reference,
    which pins the outputs (qwen3 has no shared expert, so a token whose
    slots are all dropped gives exactly 0 in both)."""
    jcfg, cfg = _cfgs("qwen3_moe_235b")
    rng = np.random.default_rng(9)
    w = rng.standard_normal((cfg.d_model, cfg.moe.n_experts)) * 0.05
    x = np.abs(_x(cfg, seed=4))                    # positive rows
    w[:, 0] = 1.0                                  # expert 0 wins everywhere
    w[:, 1] = 0.5                                  # expert 1 second
    jcfg, cfg, jp, jc, tp, tc = _moe_block("qwen3_moe_235b", router=w)
    probs = torch.softmax(torch.from_numpy(x.reshape(1, -1, cfg.d_model))
                          @ torch.from_numpy(w.astype(np.float32)), -1)
    _, _, _, keep, cap = mlp.route(cfg, probs)
    assert not bool(keep.all()) and int((~keep).sum()) >= 24 - cap
    (ty, _), (jy, _) = _run_moe(jcfg, cfg, jp, jc, tp, tc, x)
    _close(ty, jy)
    zero_t = (ty.reshape(-1, cfg.d_model) == 0).all(-1).numpy()
    zero_j = (jy.reshape(-1, cfg.d_model) == 0).all(-1)
    assert zero_t.any() and (zero_t == zero_j).all()
    assert (zero_t == (~keep[0]).all(-1).numpy()).all()


def test_router_ties_pick_the_lower_expert_first():
    """Router columns 0-2 equal and the rest zero: every token's top-k is
    decided by exact ties (experts 0 and 1 where x·c > 0, else 3 and 4),
    as ``jax.lax.top_k`` breaks them, lower index first."""
    jcfg, cfg = _cfgs("deepseek_moe_16b")
    c = np.random.default_rng(6).standard_normal(cfg.d_model)
    w = np.zeros((cfg.d_model, cfg.moe.n_experts))
    w[:, 0] = w[:, 1] = w[:, 2] = c
    jcfg, cfg, jp, jc, tp, tc = _moe_block("deepseek_moe_16b", router=w)
    x = _x(cfg, seed=8)
    probs = torch.softmax(torch.from_numpy(x.reshape(1, -1, cfg.d_model))
                          @ torch.from_numpy(w.astype(np.float32)), -1)
    _, ids, _, _, _ = mlp.route(cfg, probs)
    pos = torch.from_numpy(x.reshape(-1, cfg.d_model) @ c > 0)
    want = torch.where(pos[:, None], torch.tensor([0, 1]),
                       torch.tensor([3, 4]))
    assert torch.equal(ids[0], want)
    (ty, taux), (jy, jaux) = _run_moe(jcfg, cfg, jp, jc, tp, tc, x)
    _close(ty, jy)
    np.testing.assert_allclose(float(taux), jaux, atol=AUX_TOL)


def test_moe_groups_match_reference():
    """``moe_groups=2``: routing, capacity and the aux loss per group of
    12 tokens; 25 tokens do not divide, so one group, as the reference."""
    jcfg, cfg, jp, jc, tp, tc = _moe_block("deepseek_moe_16b", moe_groups=2)
    for rows, seq in ((3, 8), (5, 5)):
        (ty, taux), (jy, jaux) = _run_moe(jcfg, cfg, jp, jc, tp, tc,
                                          _x(cfg, rows, seq))
        _close(ty, jy)
        np.testing.assert_allclose(float(taux), jaux, atol=AUX_TOL)


# ---------------------------------------------------------------------------
# the grouped kernels' plain versions and the grouped fused linear
# ---------------------------------------------------------------------------

def _stack_case(n_exp, m, d_in, d_out, rank, dtype, seed=0):
    """E linears of one shape with sampled supports (one seed each) in
    tile-CSR form, B drawn, x of m rows each."""
    from repro_torch.core import support
    g = torch.Generator().manual_seed(seed)
    cap = support.tile_cap(d_in, d_out, 0.05)
    tiles, vs = [], []
    for e in range(n_exp):
        rows, cols = support.sample_support(seed * 100 + e, d_in, d_out,
                                            0.05)
        t = ops.prepare_tile_consts(rows, cols, d_in, d_out, pad=cap)
        tiles.append(t)
        vs.append(torch.rand(rows.shape[0], generator=g) - 0.5)
    st = {k: torch.stack([t[k] for t in tiles]) for k in tiles[0]}
    v = torch.stack(vs).reshape(n_exp, d_in, -1).to(dtype)
    x = torch.randn((n_exp, m, d_in), generator=g).to(dtype)
    B = (torch.rand((n_exp, d_in, rank), generator=g) * 2 - 1).to(dtype)
    A = (torch.rand((n_exp, rank, d_out), generator=g) - 0.5).to(dtype)
    return x, B, A, v, st


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_kernels_plain_path_is_a_loop(dtype):
    """``sl_matmul_grouped`` and ``sddmm_grouped`` on the CPU give the
    bits of a loop of the single-matrix plain versions, at a ragged shape
    (K and N not multiples of 128)."""
    x, B, A, v, st = _stack_case(3, 5, 200, 136, 8, dtype)
    v_t = ops._gather_tiles_grouped(v, st["perm"])
    y = sl_kernel.sl_matmul_grouped(x, B, A, v_t, st["rows_t"], st["cols_t"],
                                    0.5)
    dy = torch.randn((3, 5, 136), generator=torch.Generator().manual_seed(
        1)).to(dtype)
    dv = sddmm_kernel.sddmm_grouped(x, dy, st["rows_t"], st["cols_t"])
    for e in range(3):
        assert torch.equal(v_t[e], ops._gather_tiles(v[e], st["perm"][e]))
        assert torch.equal(y[e], ref.sl_matmul_ref(
            x[e], B[e], A[e], v_t[e], st["rows_t"][e], st["cols_t"][e], 0.5))
        assert torch.equal(dv[e], ref.sddmm_ref(x[e], dy[e], st["rows_t"][e],
                                                st["cols_t"][e]))
    assert y.dtype == dtype and dv.dtype == torch.float32


def test_grouped_fused_linear_matches_single_linears():
    """``ops.sl_linear_grouped``: the forward bit for bit a loop of
    ``ops.sl_linear``, and x, B, A and v's gradients equal the loop's
    (the batched f32 products of dB and dA on the CPU to 1e-6)."""
    x, B, A, v, st = _stack_case(4, 6, 144, 130, 8, torch.float32, seed=2)
    st = ops.add_transposed_tiles(st)
    dy = torch.randn((4, 6, 130), generator=torch.Generator().manual_seed(3))
    leaves = [t.clone().requires_grad_(True) for t in (x, B, A, v)]
    y = ops.sl_linear_grouped(*leaves, st["rows_t"], st["cols_t"],
                              st["perm"], 0.25, rows_tT=st["rows_tT"],
                              cols_tT=st["cols_tT"])
    grads = torch.autograd.grad(y, leaves, dy)
    for e in range(4):
        one = [t[e].clone().requires_grad_(True) for t in (x, B, A, v)]
        ye = ops.sl_linear(*one, st["rows_t"][e], st["cols_t"][e],
                           st["perm"][e], 0.25, rows_tT=st["rows_tT"][e],
                           cols_tT=st["cols_tT"][e])
        assert torch.equal(y[e], ye)
        for g, ge in zip(grads, torch.autograd.grad(ye, one, dy[e])):
            torch.testing.assert_close(g[e], ge, atol=1e-6, rtol=1e-6)


def test_transposed_tiles_of_an_expert_stack():
    """``add_transposed_tiles`` on a (layers, experts, nkt, nnt, cap)
    stack swaps each expert's two tile axes and nothing else."""
    _, _, _, _, st = _stack_case(3, 1, 300, 136, 8, torch.float32)
    stack = {k: torch.stack([v, v]) for k, v in st.items()}
    out = ops.add_transposed_tiles(stack)
    assert out["rows_tT"].shape == (2, 3, 2, 3, st["rows_t"].shape[-1])
    for i in range(2):
        for e in range(3):
            assert torch.equal(out["rows_tT"][i, e],
                               st["cols_t"][e].transpose(0, 1))
            assert torch.equal(out["cols_tT"][i, e],
                               st["rows_t"][e].transpose(0, 1))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("exec_mode", ["dense", "fused"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, exec_mode):
    jparams, jconsts, tparams, tconsts = _weights(arch)
    jcfg, cfg = _cfgs(arch, exec_mode)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    japi = jregistry.get_api(jcfg)
    jl, jaux = jax.jit(lambda p, c, b: japi.apply(jcfg, p, c, b))(
        jparams, jconsts, {"tokens": jnp.asarray(toks)})
    tl, aux = registry.get_api(cfg).apply(cfg, tparams, tconsts,
                                          {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    np.testing.assert_allclose(float(aux), float(jaux), atol=AUX_TOL,
                               rtol=AUX_TOL)
    assert float(aux) > 0.5


@pytest.mark.parametrize("cache_kind", ["paged", "contiguous"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, cache_kind):
    """A 12-token prefill on every row, then per-slot decode steps from
    staggered positions: logits at each step and the K/V of every cache
    (deepseek's dense prefix's too) at the end; the paged cache in
    exec_mode fused, the contiguous one in dense."""
    jparams, jconsts, tparams, tconsts = _weights(arch)
    paged = cache_kind == "paged"
    jcfg, cfg = _cfgs(arch, "fused" if paged else "dense",
                      "paged" if paged else "gather")
    japi, api = jregistry.get_api(jcfg), registry.get_api(cfg)
    n_slots, max_len, bl = 2, 32, 8
    kw = dict(paged=True, block_len=bl) if paged else {}
    jcache = japi.init_cache(jcfg, n_slots, max_len, **kw)
    cache = api.init_cache(cfg, n_slots, max_len, device="cpu", **kw)
    assert sorted(cache) == sorted(jcache)
    table = np.arange(1, 1 + n_slots * max_len // bl, dtype=np.int32
                      ).reshape(n_slots, -1)
    tbl = dict(block_table=table) if paged else {}
    jtbl = {k: jnp.asarray(v) for k, v in tbl.items()}
    ttbl = {k: torch.from_numpy(v) for k, v in tbl.items()}
    rng = np.random.default_rng(2)
    jprefill = jax.jit(functools.partial(japi.prefill_step, jcfg))
    jdecode = jax.jit(functools.partial(japi.decode_step, jcfg))
    toks = rng.integers(0, cfg.vocab_size, (n_slots, 12)).astype(np.int32)
    jl, jcache = jprefill(jparams, jconsts, jnp.asarray(toks), jcache,
                          **jtbl)
    tl, cache = api.prefill_step(cfg, tparams, tconsts,
                                 torch.from_numpy(toks), cache, **ttbl)
    _close(tl, jl)
    for step in range(4):
        pos = np.asarray([12 + step, 9 + step], np.int32)
        tok = rng.integers(0, cfg.vocab_size, (n_slots, 1)).astype(np.int32)
        jl, jcache = jdecode(jparams, jconsts, jnp.asarray(tok), jcache,
                             jnp.asarray(pos), **jtbl)
        tl, cache = api.decode_step(cfg, tparams, tconsts,
                                    torch.from_numpy(tok), cache,
                                    torch.from_numpy(pos), **ttbl)
        _close(tl, jl)
    want = dict(tree_leaves(jax.tree.map(np.asarray, jcache)))
    have = dict(tree_leaves(cache))
    assert sorted(have) == sorted(want)
    for path in want:
        _close(have[path], want[path])


def _traffic(vocab, n=5):
    rng = np.random.default_rng(0)
    shared = rng.integers(3, vocab, size=12).tolist()
    prompts = []
    for i in range(n):
        tail = rng.integers(3, vocab, size=int(rng.integers(2, 7))).tolist()
        prompts.append(shared + tail if i % 2 == 0 else tail)
    return prompts, np.cumsum(rng.poisson(2.0, size=n))


def _run_engines(arch, exec_mode, prompts, arrivals, new_tokens=8,
                 weights=None, **kw):
    """Each request's (uid, status, tokens, ticks) from the reference's
    engine and the port's on ``weights`` (``_weights(arch)`` by
    default): paged, streamed with ``arrivals``; with ``paged=False`` the
    contiguous engine, every request submitted at once and drained."""
    jparams, jconsts, tparams, tconsts = weights or _weights(arch)
    jcfg, cfg = _cfgs(arch, exec_mode)
    kw = {**dict(n_slots=3, max_len=48, paged=True, block_len=8), **kw}
    runs = []
    for e in (JaxEngine(jcfg, jparams, jconsts, **kw),
              ServeEngine(cfg, tparams, tconsts, device="cpu", **kw)):
        if kw["paged"]:
            reqs = [e.submit(p, max_new_tokens=new_tokens, arrival=int(a))
                    for p, a in zip(prompts, arrivals)]
            assert not e.run_stream()["exhausted"]
        else:
            reqs = [e.submit(p, max_new_tokens=new_tokens) for p in prompts]
            e.run_until_drained()
        runs.append([(r.uid, r.status, r.out, r.t_first, r.t_done)
                     for r in reqs])
    return runs


@pytest.mark.parametrize("exec_mode", ["dense", "fused", "sparse"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch, exec_mode):
    """Tokens and ticks of the paged engine with prefix sharing, tick for
    tick, in each exec mode the experts run (sparse: ``sparse_matmul``'s
    plain version on each expert's slice)."""
    _, cfg = _cfgs(arch)
    prompts, arrivals = _traffic(cfg.vocab_size)
    ref_run, port_run = _run_engines(arch, exec_mode, prompts, arrivals,
                                     prefix_sharing=True)
    assert port_run == ref_run


def test_capacity_follows_the_co_batched_slots():
    """The reference's behaviour, kept bit for bit (ROADMAP queue C,
    reference behaviour 8): every slot of a dispatch routes, idle ones
    too, and takes capacity (1 slot an expert at 3 slots, top-2 of 8), so
    a request's tokens depend on what shares the engine with it. Served
    alone and beside the others, each request's tokens are the
    reference's, and some request's tokens change with the company."""
    _, cfg = _cfgs("qwen3_moe_235b")
    prompts, _ = _traffic(cfg.vocab_size)
    together = _run_engines("qwen3_moe_235b", "fused", prompts,
                            [0] * len(prompts))
    assert together[1] == together[0]
    changed = 0
    for i, p in enumerate(prompts[:3]):
        alone = _run_engines("qwen3_moe_235b", "fused", [p], [0])
        assert alone[1] == alone[0]
        changed += alone[1][0][2] != together[1][i][2]
    assert changed > 0


def test_supports_and_tile_consts_match_reference_bit_for_bit():
    """The port's own init of both smoke configs samples every support and
    tile const as the reference does (the routed experts' at
    ``/blocks/p{i}/k0/moe/expert{e}/...``, the shared experts', the dense
    prefix's at ``/dense/dl0/mlp/...``), and builds the same tree of
    params, the router full rank."""
    for arch in ARCHS:
        jcfg, cfg = _cfgs(arch)
        jp, jc = jregistry.get_api(jcfg).init(jcfg, jax.random.PRNGKey(0),
                                              seed=11)
        tp, tc = registry.get_api(cfg).init(cfg, seed=11, device="cpu")
        want = dict(tree_leaves(jax.tree.map(np.asarray, jc)))
        have = dict(tree_leaves(tc))
        assert sorted(have) == sorted(want)
        for p, v in want.items():
            np.testing.assert_array_equal(have[p].numpy(), v)
        jshapes = {p: v.shape for p, v in tree_leaves(
            jax.tree.map(np.asarray, jp))}
        assert {p: tuple(v.shape) for p, v in tree_leaves(tp)} == jshapes
        assert "layers/k0/moe/router/w" in jshapes
        if arch == "deepseek_moe_16b":
            assert "dense_layers/mlp/gate/v" in jshapes
            assert "layers/k0/moe/shared/up/B" in jshapes
        else:
            assert "layers/k0/attn/q_norm" in jshapes


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch):
    """``param_count_active`` (active: top-k routed plus shared experts)
    and ``model_flops`` as the reference counts them, and the configs'
    hashes."""
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    total, active = roofline.param_count_active(cfg)
    assert (total, active) == jroofline.param_count_active(jcfg)
    assert active < total
    assert roofline.model_flops(cfg, 2048) == jroofline.model_flops(jcfg,
                                                                    2048)
    assert cfg.hash() == jcfg.hash()
    assert registry.get_smoke_config(arch).hash() == \
        jregistry.get_smoke_config(arch).hash()


def test_quant_on_moe_raises_naming_item_4b():
    """Nothing raises naming ROADMAP item 4b any more: exec_mode quant on
    an expert stack inits (no quant consts yet), the engine takes the
    calibrated model and the calibration takes the expert stack, one
    matrix per layer and expert, in the reference's count."""
    _, cfg = _cfgs("deepseek_moe_16b", "quant")
    registry.get_api(cfg).init(cfg, device="cpu")
    _, _, jst, tqp, tqc, tst = _quant("deepseek_moe_16b")
    _, fused = _cfgs("deepseek_moe_16b")
    eng = ServeEngine(fused, tqp, tqc, exec_mode="quant", paged=True,
                      device="cpu")
    assert eng.cfg.param.exec_mode == "quant" and not eng.quant_fell_back
    m = fused.moe
    n_moe = fused.n_layers - m.first_k_dense
    assert tst["n_matrices"] == jst["n_matrices"] >= 3 * m.n_experts * n_moe


# ---------------------------------------------------------------------------
# exec_mode quant on the expert stack
# ---------------------------------------------------------------------------

def _decode_stack(n_exp, m, d_in, d_out, dtype, seed=4):
    """``_stack_case``'s E linears with each support also in the int8
    layout (codes and scales drawn): x, B, A, v, the tile consts, (v_t,
    rows_t, cols_t) and (qv_t, rows_q, cols_q, qscale), each stacked on
    the expert axis."""
    from repro_torch.core import support
    from repro_torch.quant import layout
    x, B, A, v, st = _stack_case(n_exp, m, d_in, d_out, 8, dtype, seed)
    rng = np.random.default_rng(seed)
    qs = []
    for e in range(n_exp):
        rows, cols = support.sample_support(seed * 100 + e, d_in, d_out,
                                            0.05)
        qv = rng.integers(-127, 128, rows.shape).astype(np.int8)
        sc = rng.uniform(1e-3, 1e-2, d_out).astype(np.float32)
        q = layout.build_quant_consts(rows, cols, qv, sc, d_in, d_out, 0.05,
                                      "row_balanced")
        qs.append([q[k] for k in QUANT_KEYS])
    sp = (ops._gather_tiles_grouped(v, st["perm"]), st["rows_t"],
          st["cols_t"])
    return x, B, A, v, st, sp, [torch.stack(t) for t in zip(*qs)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_exp", [1, 3])
def test_grouped_decode_plain_paths_are_a_loop(n_exp, dtype):
    """``sparse_matmul_grouped`` (x's dtype and f32 out) and
    ``quant_sparse_matmul_grouped`` on the CPU give the bits of a loop of
    the single plain versions, and ``ops.sl_decode_grouped`` /
    ``ops.sl_quant_decode_grouped`` the bits of a loop of
    ``ops.sl_decode`` / ``ops.sl_quant_decode``, at a ragged shape (K and
    N not multiples of 128) and at one expert."""
    x, B, A, _, _, sp, qp = _decode_stack(n_exp, 5, 200, 136, dtype)
    n = 136
    y = sd_kernel.sparse_matmul_grouped(x, *sp, n)
    y32 = sd_kernel.sparse_matmul_grouped(x, *sp, n, torch.float32)
    yq = sd_kernel.quant_sparse_matmul_grouped(x, *qp, n)
    d = ops.sl_decode_grouped(x, B, A, *sp, 0.5)
    dq = ops.sl_quant_decode_grouped(x, B, A, *qp, 0.5)
    assert (y.dtype, y32.dtype, yq.dtype, d.dtype, dq.dtype) == \
        (dtype, torch.float32, dtype, dtype, dtype)
    for e in range(n_exp):
        s1 = [t[e] for t in sp]
        q1 = [t[e] for t in qp]
        assert torch.equal(y[e], ref.sparse_matmul_ref(x[e], *s1, n))
        assert torch.equal(y32[e], ref.sparse_matmul_ref(x[e], *s1, n,
                                                         torch.float32))
        assert torch.equal(yq[e], ref.quant_sparse_matmul_ref(x[e], *q1, n))
        assert torch.equal(d[e], ops.sl_decode(x[e], B[e], A[e], *s1, 0.5))
        assert torch.equal(dq[e], ops.sl_quant_decode(x[e], B[e], A[e], *q1,
                                                      0.5))


def test_grouped_sparse_linear_matches_single_linears():
    """``ops.sl_sparse_linear_grouped`` (exec_mode sparse training on the
    expert stack): the forward bit for bit a loop of
    ``ops.sl_sparse_linear``, and x, B, A and v's gradients equal the
    loop's (the batched f32 products on the CPU to 1e-6)."""
    x, B, A, v, st = _stack_case(4, 6, 144, 130, 8, torch.float32, seed=2)
    st = ops.add_transposed_tiles(st)
    dy = torch.randn((4, 6, 130), generator=torch.Generator().manual_seed(3))
    leaves = [t.clone().requires_grad_(True) for t in (x, B, A, v)]
    y = ops.sl_sparse_linear_grouped(*leaves, st["rows_t"], st["cols_t"],
                                     st["perm"], 0.25, rows_tT=st["rows_tT"],
                                     cols_tT=st["cols_tT"])
    grads = torch.autograd.grad(y, leaves, dy)
    for e in range(4):
        one = [t[e].clone().requires_grad_(True) for t in (x, B, A, v)]
        ye = ops.sl_sparse_linear(*one, st["rows_t"][e], st["cols_t"][e],
                                  st["perm"][e], 0.25,
                                  rows_tT=st["rows_tT"][e],
                                  cols_tT=st["cols_tT"][e])
        assert torch.equal(y[e], ye)
        for g, ge in zip(grads, torch.autograd.grad(ye, one, dy[e])):
            torch.testing.assert_close(g[e], ge, atol=1e-6, rtol=1e-6)


_QUANT = {}


def _quant(arch):
    """(reference params, consts, stats, port params, consts, stats): each
    package's calibration of ``_weights(arch)``, cached per arch."""
    if arch not in _QUANT:
        jparams, jconsts, tparams, tconsts = _weights(arch)
        jcfg, cfg = _cfgs(arch)
        _QUANT[arch] = (jcalibrate.calibrate_model(jcfg, jparams, jconsts)
                        + calibrate.calibrate_model(cfg, tparams, tconsts))
    return _QUANT[arch]


def _quant_weights(arch):
    """The reference's calibrated artifact as each package loads it: the
    same params and consts on both sides of an engine comparison."""
    jqp, jqc = _quant(arch)[:2]
    tp, tc = from_jax_numpy(jax.tree.map(np.asarray, jqp),
                            jax.tree.map(np.asarray, jqc), device="cpu")
    return jqp, jqc, tp, tc


@pytest.mark.parametrize("arch", ARCHS)
def test_expert_stack_calibration_matches_reference(arch):
    """Every matrix of the model, each routed expert's slice of each
    layer included: codes, scales and the ``qv_t/rows_q/cols_q/qscale``
    layout bit for bit; ``scale·B'·A'`` within ``FOLD_RTOL`` of the
    reference's (relative to its largest entry) slice by slice;
    ``max_abs_err`` within ``ERR_ATOL``; no code is −128."""
    jqp, jqc, jst, tqp, tqc, tst = _quant(arch)
    assert (tst["n_matrices"], tst["nnz"], tst["format"]) == \
        (jst["n_matrices"], jst["nnz"], jst["format"])
    assert abs(tst["max_abs_err"] - jst["max_abs_err"]) <= ERR_ATOL
    want = dict(tree_leaves(jax.tree.map(np.asarray, jqc)))
    have = {p: v for p, v in tree_leaves(tqc)
            if p.split("/")[-1] in QUANT_KEYS}
    assert sorted(have) == sorted(p for p in want
                                  if p.split("/")[-1] in QUANT_KEYS)
    assert any("/experts/" in p for p in have)
    for p, v in have.items():
        np.testing.assert_array_equal(v.numpy(), want[p], err_msg=p)
        if p.endswith("qv_t"):
            assert int(v.min()) >= -127
    wp = dict(tree_leaves(jax.tree.map(np.asarray, jqp)))
    hp = dict(tree_leaves(tqp))
    assert sorted(hp) == sorted(wp)
    alpha = _cfgs(arch)[1].param.alpha
    for p in wp:
        if not p.endswith("/B"):
            continue
        a = p[:-1] + "A"
        r = wp[p].shape[-1]
        got = [t.numpy().astype(np.float64) for t in (hp[p], hp[a])]
        ref_ = [np.asarray(t, np.float64) for t in (wp[p], wp[a])]
        lead = wp[p].shape[:-2]
        flat = lambda t: t.reshape((-1,) + t.shape[len(lead):])
        for gb, ga, wb, wa in zip(*map(flat, got + ref_)):
            want_f = (alpha / r) * (wb @ wa)
            np.testing.assert_allclose((alpha / r) * (gb @ ga), want_f,
                                       rtol=0, atol=FOLD_RTOL * np.abs(
                                           want_f).max(), err_msg=p)


@pytest.mark.parametrize("arch", ARCHS)
def test_quant_forward_matches_reference(arch):
    """The logits and aux of exec_mode quant under ``jax.jit`` and in the
    port, on one calibrated artifact (the reference's, loaded by each
    package; the port's own calibration is held to it above)."""
    jqp, jqc, tqp, tqc = _quant_weights(arch)
    jcfg, cfg = _cfgs(arch, "quant")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    japi = jregistry.get_api(jcfg)
    jl, jaux = jax.jit(lambda p, c, b: japi.apply(jcfg, p, c, b))(
        jqp, jqc, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        tl, aux = registry.get_api(cfg).apply(
            cfg, tqp, tqc, {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    np.testing.assert_allclose(float(aux), float(jaux), atol=AUX_TOL,
                               rtol=AUX_TOL)


@pytest.mark.parametrize("cache_kind", ["paged", "contiguous"])
@pytest.mark.parametrize("arch", ARCHS)
def test_quant_engine_matches_reference(arch, cache_kind):
    """Tokens and ticks of exec_mode quant on one calibrated artifact (the
    reference's, loaded by each package), tick for tick: the paged
    engine with prefix sharing and the contiguous (legacy) engine."""
    _, cfg = _cfgs(arch)
    prompts, arrivals = _traffic(cfg.vocab_size)
    kw = dict(prefix_sharing=True) if cache_kind == "paged" else \
        dict(paged=False)
    ref_run, port_run = _run_engines(arch, "quant", prompts, arrivals,
                                     weights=_quant_weights(arch), **kw)
    assert port_run == ref_run
    assert any(r[2] for r in port_run)


def _run_main(fn, argv):
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn(argv)
    return out.getvalue()


@pytest.mark.parametrize("writer", ["port_trainer", "reference"])
def test_calibrate_cli_and_quant_launcher_on_moe(tmp_path, writer):
    """``python -m repro_torch.quant.calibrate --arch deepseek_moe_16b``
    on a checkpoint of either package (the port's train launcher, or the
    reference's ``arrays.npz`` of its own init with B drawn) gives the
    codes, scales and layout of the reference's calibrate CLI on the same
    checkpoint, and the serve launcher serves the artifact in exec_mode
    quant."""
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    arch = "deepseek_moe_16b"
    ck = str(tmp_path / "ckpt")
    if writer == "port_trainer":
        train_launch.main(["--arch", arch, "--smoke", "--steps", "1",
                           "--batch", "2", "--seq", "8", "--device", "cpu",
                           "--exec-mode", "fused", "--ckpt-dir", ck])
    else:
        jcfg = jregistry.get_smoke_config(arch)
        jp, _ = jregistry.get_api(jcfg).init(jcfg, jax.random.PRNGKey(0),
                                             seed=0)
        rng = np.random.default_rng(4)
        jp = jax.tree_util.tree_map_with_path(
            lambda p, leaf: jnp.asarray(rng.uniform(-0.5, 0.5, leaf.shape),
                                        leaf.dtype)
            if str(p[-1].key) == "B" else leaf, jp)
        jckpt.CheckpointManager(ck).save(3, {"params": jp},
                                         config_hash=jcfg.hash())
    art, jart = str(tmp_path / "artifact"), str(tmp_path / "artifact_ref")
    argv = ["--arch", arch, "--smoke", "--ckpt-dir", ck]
    out = _run_main(calibrate.main, argv + ["--out", art, "--device", "cpu"])
    _run_main(jcalibrate.main, argv + ["--out", jart])
    _, tc, man = ckpt_lib.load_quant_artifact(art, device="cpu")
    _, jc, jman = jckpt.load_quant_artifact(jart)
    n = jman["extra"]["n_matrices"]
    assert out.startswith(f"quant artifact: {n} matrices")
    assert man["config_hash"] == jman["config_hash"]
    assert man["extra"]["nnz"] == jman["extra"]["nnz"]
    want = dict(tree_leaves(jax.tree.map(np.asarray, jc)))
    have = dict(tree_leaves(tc))
    assert sorted(have) == sorted(want)
    for p in want:
        np.testing.assert_array_equal(have[p].numpy(), want[p], err_msg=p)
    out = _run_main(serve_launch.main, [
        "--arch", arch, "--smoke", "--paged", "--requests", "2", "--slots",
        "2", "--max-len", "32", "--new-tokens", "3", "--device", "cpu",
        "--exec-mode", "quant", "--quant-ckpt", art])
    assert f"quant artifact: {art} ({n} matrices)" in out
    assert "served 2 requests, 6 tokens" in out and "exec_mode=quant" in out
