"""The port's contiguous KV cache (the reference engine's ``paged=False``
legacy path) against the reference on the llama_60m smoke config in f32,
with the reference's weights carried over by ``from_jax_numpy`` and a
non-zero B:

* ``init_cache`` shapes; ``decode_step`` and ``prefill_step`` logits and
  cache contents at a scalar index (a clamped and a wrapped start among
  them) and at a per-slot vector (a wrapped and two dropped writes among
  them): which cache positions each call writes exactly, the values at
  rtol = 1e-4 and atol = 1e-4 times the larger of 1 and the tensor's
  largest magnitude (f32 sums in another order: with B ~ U(-1, 1) the
  plain forward already differs from the reference's by up to 8.1e-5 on
  this config, and the K/V rows reach 36);
* the contiguous engine token for token and tick for tick in exec_mode
  dense, fused, sparse and quant (quant on one artifact the reference
  wrote), on traffic with staggered prompt lengths, so the shared decode
  index and the every-row prefill writes (the reference's warts, kept)
  show; the reference's refusals and its silent attn_kernel downgrade;
* deadlines, shedding and ``stall@T:K`` on the contiguous engine, and
  ``stall@T:K`` on the paged one, against the reference's tokens, ticks
  and statuses.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro.models import registry as jregistry
from repro.quant import calibrate as jcalibrate
from repro.resilience import ChaosEngine as JaxChaos
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.ckpt.checkpoint import load_quant_artifact
from repro_torch.ckpt.convert import from_jax_numpy
from repro_torch.models import registry
from repro_torch.resilience import ChaosEngine
from repro_torch.serve.engine import ServeEngine

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

TOL = 1e-4


def _cfgs(exec_mode="fused", dtype="float32"):
    def mk(cfg):
        return dataclasses.replace(
            cfg, dtype=dtype,
            param=dataclasses.replace(cfg.param, exec_mode=exec_mode))
    return (mk(jregistry.get_smoke_config("llama_60m")),
            mk(registry.get_smoke_config("llama_60m")))


@pytest.fixture(scope="module")
def weights():
    """Reference init (fused: supports and tile consts) with B drawn
    U(-1, 1), as numpy trees."""
    jcfg, _ = _cfgs()
    params, consts = jregistry.get_api(jcfg).init(
        jcfg, jax.random.PRNGKey(0), seed=0)
    rng = np.random.default_rng(1)

    def fill_b(path, leaf):
        if str(path[-1].key) == "B":
            return rng.uniform(-1, 1, leaf.shape).astype(np.float32)
        return np.asarray(leaf)

    return (jax.tree_util.tree_map_with_path(fill_b, params),
            jax.tree.map(np.asarray, consts))


def _both(np_params, np_consts):
    """(reference trees, port trees) of the same numpy weights."""
    return ((jax.tree.map(jnp.asarray, np_params),
             jax.tree.map(jnp.asarray, np_consts)),
            from_jax_numpy(np_params, np_consts, device="cpu"))


def _close(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               atol=TOL * max(1.0, np.abs(want).max()),
                               rtol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("paged", [False, True])
def test_init_cache_shapes_match_reference(paged, dtype):
    jcfg, cfg = _cfgs(dtype=dtype)
    jc = jregistry.get_api(jcfg).init_cache(jcfg, 3, 40, paged=paged,
                                            block_len=8)
    tc = registry.get_api(cfg).init_cache(cfg, 3, 40, paged=paged,
                                          block_len=8, device="cpu")
    assert set(tc) == set(jc) and set(tc["layers"]) == set(jc["layers"])
    for leaf in ("k", "v"):
        want = jc["layers"]["k0"][leaf]
        got = tc["layers"]["k0"][leaf]
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        assert not got.any()


def test_decode_and_prefill_on_the_contiguous_cache_match_reference(weights):
    """A scalar-index prefill writes every row; scalar-index decodes (one
    past the written positions, one whose start the reference clamps so
    the update fits, one negative start that wraps); per-slot decodes
    (staggered, one column wrapping from -1, two out of range that the
    reference drops). Logits and both cache leaves after every call."""
    (jp, jc), (tp, tc) = _both(*weights)
    jcfg, cfg = _cfgs("dense")
    japi, api = jregistry.get_api(jcfg), registry.get_api(cfg)
    n_slots, max_len = 4, 16
    jcache = japi.init_cache(jcfg, n_slots, max_len)
    cache = api.init_cache(cfg, n_slots, max_len, device="cpu")
    rng = np.random.default_rng(2)
    vocab = cfg.vocab_size
    t = lambda a: torch.from_numpy(np.asarray(a))

    def check(jl, tl, before):
        _close(tl, jl)
        for leaf, old in zip(("k", "v"), before):
            got = cache["layers"]["k0"][leaf]
            want = np.asarray(jcache["layers"]["k0"][leaf])
            _close(got, want)
            # the positions this call wrote, (layer, slot, position)
            np.testing.assert_array_equal(
                (got.numpy() != old[0]).any(axis=(-2, -1)),
                (want != old[1]).any(axis=(-2, -1)))

    def snap():
        return [(cache["layers"]["k0"][leaf].numpy().copy(),
                 np.asarray(jcache["layers"]["k0"][leaf]))
                for leaf in ("k", "v")]

    toks = rng.integers(3, vocab, (n_slots, 6)).astype(np.int32)
    before = snap()
    jl, jcache = japi.prefill_step(jcfg, jp, jc, jnp.asarray(toks), jcache)
    tl, cache = api.prefill_step(cfg, tp, tc, t(toks), cache)
    check(jl, tl, before)
    for idx in (6, 7, max_len + 3, -5):
        tok = rng.integers(3, vocab, (n_slots, 1)).astype(np.int32)
        before = snap()
        jl, jcache = japi.decode_step(jcfg, jp, jc, jnp.asarray(tok), jcache,
                                      jnp.int32(idx))
        tl, cache = api.decode_step(cfg, tp, tc, t(tok), cache, idx)
        check(jl, tl, before)
    for pos in ([8, 9, 12, 15], [9, -1, max_len + 2, -max_len - 3]):
        tok = rng.integers(3, vocab, (n_slots, 1)).astype(np.int32)
        pos = np.asarray(pos, np.int32)
        before = snap()
        jl, jcache = japi.decode_step(jcfg, jp, jc, jnp.asarray(tok), jcache,
                                      jnp.asarray(pos))
        tl, cache = api.decode_step(cfg, tp, tc, t(tok), cache, t(pos))
        check(jl, tl, before)
    # a per-slot chunk of two positions per row: the second row's first
    # column wraps, the third row's second column is dropped
    toks = rng.integers(3, vocab, (n_slots, 2)).astype(np.int32)
    offs = np.asarray([3, -1, max_len - 1, 10], np.int32)
    before = snap()
    jl, jcache = japi.decode_step(jcfg, jp, jc, jnp.asarray(toks), jcache,
                                  jnp.asarray(offs))
    tl, cache = api.decode_step(cfg, tp, tc, t(toks), cache, t(offs))
    check(jl, tl, before)


# ---------------------------------------------------------------------------
# the contiguous engine
# ---------------------------------------------------------------------------

# staggered prompt lengths on 2 slots: the second slot's prefill writes
# the first slot's row, and decode writes both rows at the larger position
PROMPTS = [[5, 9, 11], [7, 3, 2, 8, 6, 14, 30], [4, 4], [9, 2, 21, 17, 3],
           [12, 19, 7, 5, 8, 2, 3, 1, 40]]


def _run(engine, prompts, new_tokens=5, **submit):
    reqs = [engine.submit(p, max_new_tokens=new_tokens, **submit)
            for p in prompts]
    stats = engine.run_until_drained()
    return ([(r.uid, r.status, r.out, r.t_admit, r.t_first, r.t_done)
             for r in reqs], stats["summary"], dict(engine.dispatches))


def _pair(weights, exec_mode, jkw=None, **kw):
    """The reference and the port engine on the same weights (``jkw``: the
    reference's keywords where they differ from the port's)."""
    (jp, jc), (tp, tc) = _both(*weights)
    jcfg, cfg = _cfgs("fused")
    kw = dict(dict(n_slots=2, max_len=32), **kw)
    return (JaxEngine(jcfg, jp, jc, exec_mode=exec_mode, **dict(kw, **(
                jkw or {}))),
            ServeEngine(cfg, tp, tc, exec_mode=exec_mode, device="cpu",
                        **kw))


@pytest.mark.parametrize("exec_mode", ["dense", "fused", "sparse"])
def test_contiguous_engine_matches_reference(weights, exec_mode):
    jeng, eng = _pair(weights, exec_mode)
    assert not eng.paged and eng.cfg.attn_kernel == "gather"
    want = _run(jeng, PROMPTS)
    assert _run(eng, PROMPTS) == want
    # prefill burns one dispatch (and tick) per prompt token
    assert want[2]["prefill"] == sum(map(len, PROMPTS))


def test_contiguous_quant_engine_matches_reference(weights, tmp_path):
    """exec_mode quant on one artifact the reference calibrated and wrote,
    loaded by each package."""
    jcfg, cfg = _cfgs("fused")
    qp, qc, st = jcalibrate.calibrate_model(jcfg, *weights)
    art = str(tmp_path / "artifact")
    jckpt.save_quant_artifact(art, jax.tree.map(np.asarray, qp),
                              jax.tree.map(np.asarray, qc), extra=st)
    jqp, jqc, _ = jckpt.load_quant_artifact(art)
    tqp, tqc, _ = load_quant_artifact(art, device="cpu")
    kw = dict(n_slots=2, max_len=32, exec_mode="quant")
    want = _run(JaxEngine(jcfg, jqp, jqc, **kw), PROMPTS)
    assert _run(ServeEngine(cfg, tqp, tqc, device="cpu", **kw),
                PROMPTS) == want


def test_contiguous_shared_index_wart_matches_reference(weights):
    """The reference's legacy engine (kept bit for bit, ROADMAP queue C):
    two requests of different prompt lengths sharing 2 slots give other
    tokens than each served alone, in the reference and in the port
    alike."""
    prompts = PROMPTS[:2]
    together = []
    for which in (0, 1):
        eng = _pair(weights, "dense")[which]
        together.append([o for _, _, o, *_ in _run(eng, prompts)[0]])
    alone = [[o for _, _, o, *_ in _run(_pair(weights, "dense")[1], [p])[0]]
             for p in prompts]
    assert together[1] == together[0]
    assert [a[0] for a in alone] != together[1]


def test_contiguous_refusals_match_reference(weights):
    (jp, jc), (tp, tc) = _both(*weights)
    jcfg, cfg = _cfgs("fused")
    for kw in (dict(attn_kernel="paged"), dict(prefix_sharing=True)):
        with pytest.raises(ValueError) as jerr:
            JaxEngine(jcfg, jp, jc, max_len=32, **kw)
        with pytest.raises(ValueError) as err:
            ServeEngine(cfg, tp, tc, max_len=32, device="cpu", **kw)
        assert str(err.value) == str(jerr.value)
    # the config's default "paged" falls back to the gathered read
    assert cfg.attn_kernel == jcfg.attn_kernel == "paged"
    jeng = JaxEngine(jcfg, jp, jc, max_len=32)
    eng = ServeEngine(cfg, tp, tc, max_len=32, device="cpu")
    assert eng.cfg.attn_kernel == jeng.cfg.attn_kernel == "gather"
    for e in (jeng, eng):
        with pytest.raises(ValueError, match="run_stream requires"):
            e.run_stream()


# ---------------------------------------------------------------------------
# engine faults: deadlines, shedding, stalls
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["deadline", "queued_deadline", "shed"])
def test_contiguous_deadlines_and_shedding_match_reference(weights, case):
    kw = {"deadline": dict(deadline_ticks=6),
          "queued_deadline": dict(n_slots=1, deadline_ticks=9),
          "shed": dict(max_queue=2)}[case]
    jeng, eng = _pair(weights, "dense", **kw)
    want = _run(jeng, PROMPTS, new_tokens=6)
    got = _run(eng, PROMPTS, new_tokens=6)
    assert got == want
    assert set(want[1]) - {"done"}, want[1]     # the fault did happen
    assert not eng._has_work()
    assert [r.fail_reason for r in eng.timed_out + eng.rejected] == \
        [r.fail_reason for r in jeng.timed_out + jeng.rejected]


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("spec,seed,kw", [
    ("stall@2:5", 3, {}),
    ("stall@3:50", 0, dict(n_slots=1, deadline_ticks=12)),
    ("stall@4:6", 1, dict(deadline_ticks=30))],
    ids=["delay", "past_deadline", "deadline"])
def test_stalls_match_reference(weights, paged, spec, seed, kw):
    """``stall@T:K`` through ``tick_hook`` on either engine: the same slot
    stalls, the same ticks burn, the same requests finish or time out, and
    no request stays wedged (the paged engine frees every block)."""
    if paged:
        kw = dict(kw, paged=True, block_len=8)
    jchaos = JaxChaos.parse(spec, seed=seed)
    chaos = ChaosEngine.parse(spec, seed=seed)
    jeng, eng = _pair(weights, "fused", jkw=dict(tick_hook=jchaos.serve_hook),
                      tick_hook=chaos.serve_hook, **kw)
    jchaos.bind(jeng.obs)
    chaos.bind(eng.obs)
    want = _run(jeng, PROMPTS[:3], new_tokens=4)
    got = _run(eng, PROMPTS[:3], new_tokens=4)
    assert got == want
    assert not eng._has_work() and not eng._stall_until
    if paged:
        assert eng.sched.blocks.blocks_in_use == 0
    for e in (jeng, eng):
        snap = e.obs.snapshot()
        assert snap["resilience.faults_injected{kind=stall}"]["value"] == 1
    assert eng.obs.snapshot().get("serve.deadline_exceeded") == \
        jeng.obs.snapshot().get("serve.deadline_exceeded")
