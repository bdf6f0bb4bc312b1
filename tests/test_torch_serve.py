"""The port's serving slice against the reference on the llama_60m smoke
config in f32, with the reference's weights carried over by
``from_jax_numpy`` and a non-zero B (the paper init's B = 0 would hide
every low-rank bug):

* decode_step and prefill_step logits (scalar-offset prefill, per-slot
  suffix prefill over prior pages, per-slot decode) for exec dense/fused
  × attn paged/gather — the reference's Pallas kernels in interpret mode;
* the paged engine with prefix sharing and ``run_stream`` token for token
  and tick for tick;
* the host-side block table and scheduler under the same operation
  sequence.

Tolerance for logits: atol = rtol = 1e-4 (f32, sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jregistry
from repro.serve import kv as jkv
from repro.serve.engine import ServeEngine as JaxEngine
from repro.serve.scheduler import Scheduler as JaxScheduler
from repro_torch.ckpt.convert import from_jax_numpy
from repro_torch.models import registry
from repro_torch.serve import kv
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.scheduler import Scheduler

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

TOL = 1e-4


def _cfgs(exec_mode="fused", attn_kernel="paged"):
    def mk(cfg):
        return dataclasses.replace(
            cfg, dtype="float32", attn_kernel=attn_kernel,
            param=dataclasses.replace(cfg.param, exec_mode=exec_mode))
    return (mk(jregistry.get_smoke_config("llama_60m")),
            mk(registry.get_smoke_config("llama_60m")))


@pytest.fixture(scope="module")
def weights():
    """Reference init (fused, so both tile consts and supports exist) with
    B drawn non-zero, as numpy trees and as the port's tensors."""
    jcfg, _ = _cfgs()
    params, consts = jregistry.get_api(jcfg).init(
        jcfg, jax.random.PRNGKey(0), seed=0)
    rng = np.random.default_rng(1)

    def fill_b(path, leaf):
        if str(path[-1].key) == "B":
            return rng.uniform(-1, 1, leaf.shape).astype(np.float32)
        return np.asarray(leaf)

    np_params = jax.tree_util.tree_map_with_path(fill_b, params)
    np_consts = jax.tree.map(np.asarray, consts)
    tparams, tconsts = from_jax_numpy(np_params, np_consts, device="cpu")
    jparams = jax.tree.map(jnp.asarray, np_params)
    return jparams, consts, tparams, tconsts


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("attn_kernel", ["paged", "gather"])
@pytest.mark.parametrize("exec_mode", ["dense", "fused"])
def test_prefill_and_decode_logits_match_reference(weights, exec_mode,
                                                   attn_kernel):
    jparams, jconsts, tparams, tconsts = weights
    jcfg, cfg = _cfgs(exec_mode, attn_kernel)
    japi, api = jregistry.get_api(jcfg), registry.get_api(cfg)
    n_slots, max_len, bl = 3, 32, 8
    jcache = japi.init_cache(jcfg, n_slots, max_len, paged=True,
                             block_len=bl)
    cache = api.init_cache(cfg, n_slots, max_len, paged=True, block_len=bl,
                           device="cpu")
    table = np.zeros((n_slots, max_len // bl), np.int32)
    table[0, :3] = [1, 2, 3]
    table[1, :2] = [4, 5]
    table[2, :3] = [6, 7, 8]
    rng = np.random.default_rng(2)
    vocab = cfg.vocab_size
    t = lambda a: torch.from_numpy(np.asarray(a))

    # 1) scalar-offset prefill of an 8-token chunk on every row
    toks = rng.integers(3, vocab, (n_slots, 8)).astype(np.int32)
    jl, jcache = japi.prefill_step(jcfg, jparams, jconsts, jnp.asarray(toks),
                                   jcache, block_table=jnp.asarray(table))
    tl, cache = api.prefill_step(cfg, tparams, tconsts, t(toks), cache,
                                 block_table=t(table))
    _close(tl, jl)
    # 2) per-slot suffix prefill over the prior pages (offsets 8)
    toks = rng.integers(3, vocab, (n_slots, 8)).astype(np.int32)
    offs = np.full(n_slots, 8, np.int32)
    jl, jcache = japi.prefill_step(jcfg, jparams, jconsts, jnp.asarray(toks),
                                   jcache, block_table=jnp.asarray(table),
                                   offsets=jnp.asarray(offs))
    tl, cache = api.prefill_step(cfg, tparams, tconsts, t(toks), cache,
                                 block_table=t(table), offsets=t(offs))
    _close(tl, jl)
    # 3) per-slot decode at staggered positions
    for pos in ([16, 12, 20], [17, 13, 21]):
        tok = rng.integers(3, vocab, (n_slots, 1)).astype(np.int32)
        pos = np.asarray(pos, np.int32)
        jl, jcache = japi.decode_step(jcfg, jparams, jconsts,
                                      jnp.asarray(tok), jcache,
                                      jnp.asarray(pos),
                                      block_table=jnp.asarray(table))
        tl, cache = api.decode_step(cfg, tparams, tconsts, t(tok), cache,
                                    t(pos), block_table=t(table))
        _close(tl, jl)
    for leaf in ("k", "v"):
        _close(cache["layers"]["k0"][leaf], jcache["layers"]["k0"][leaf])


@pytest.mark.parametrize("exec_mode", ["dense", "fused"])
def test_apply_lm_matches_reference(weights, exec_mode):
    jparams, jconsts, tparams, tconsts = weights
    jcfg, cfg = _cfgs(exec_mode)
    toks = np.random.default_rng(3).integers(3, cfg.vocab_size, (2, 12))
    jl, _ = jregistry.get_api(jcfg).apply(jcfg, jparams, jconsts,
                                          {"tokens": jnp.asarray(toks)})
    tl, _ = registry.get_api(cfg).apply(cfg, tparams, tconsts,
                                        {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)


def test_full_rank_param_mode_matches_reference():
    """param.mode="dense" (the paper's full-rank baseline): every linear is
    one ``w``, and the forward still matches."""
    jcfg, cfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, param=dataclasses.replace(
        jcfg.param, mode="dense"))
    cfg = dataclasses.replace(cfg, param=dataclasses.replace(
        cfg.param, mode="dense"))
    jp, jc = jregistry.get_api(jcfg).init(jcfg, jax.random.PRNGKey(1))
    tp, tc = from_jax_numpy(jax.tree.map(np.asarray, jp), {}, device="cpu")
    assert "w" in tp["layers"]["k0"]["attn"]["wq"]
    toks = np.random.default_rng(4).integers(3, cfg.vocab_size, (2, 9))
    jl, _ = jregistry.get_api(jcfg).apply(jcfg, jp, jc,
                                          {"tokens": jnp.asarray(toks)})
    tl, _ = registry.get_api(cfg).apply(cfg, tp, tc,
                                        {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)


def _traffic(vocab, n=8):
    """The launcher's traffic: half the prompts open with a shared 16-token
    prefix, tails of 2-7 tokens, Poisson arrivals."""
    rng = np.random.default_rng(0)
    shared = rng.integers(3, vocab, size=16).tolist()
    prompts = []
    for i in range(n):
        tail = rng.integers(3, vocab, size=int(rng.integers(2, 8))).tolist()
        prompts.append(shared + tail if i % 2 == 0 else tail)
    return prompts, np.cumsum(rng.poisson(2.0, size=n))


@pytest.mark.parametrize("exec_mode,attn_kernel",
                         [("fused", "paged"), ("dense", "gather")])
def test_engine_stream_with_prefix_sharing_matches_reference(
        weights, exec_mode, attn_kernel):
    jparams, jconsts, tparams, tconsts = weights
    jcfg, cfg = _cfgs(exec_mode, attn_kernel)
    prompts, arrivals = _traffic(cfg.vocab_size)
    kw = dict(n_slots=4, max_len=64, paged=True, block_len=16,
              prefix_sharing=True)
    jeng = JaxEngine(jcfg, jparams, jconsts, **kw)
    eng = ServeEngine(cfg, tparams, tconsts, device="cpu", **kw)
    runs = []
    for e in (jeng, eng):
        reqs = [e.submit(p, max_new_tokens=12, arrival=int(a))
                for p, a in zip(prompts, arrivals)]
        stats = e.run_stream()
        assert not stats["exhausted"]
        runs.append([(r.uid, r.status, r.out, r.arrival, r.t_first,
                      r.t_done) for r in reqs])
        e.sched.blocks.check()
    assert runs[1] == runs[0]
    assert dict(eng.prefill_traffic) == dict(jeng.prefill_traffic)
    assert eng.prefill_traffic["tokens_shared"] > 0
    assert dict(eng.dispatches) == dict(jeng.dispatches)


def test_engine_preemption_and_shedding_match_reference(weights):
    """An undersized pool forces parking and preemption; a queue cap sheds
    the overflow. Both engines take the same decisions."""
    jparams, jconsts, tparams, tconsts = weights
    jcfg, cfg = _cfgs("fused", "paged")
    prompts, _ = _traffic(cfg.vocab_size, n=6)
    kw = dict(n_slots=3, max_len=64, paged=True, block_len=8, n_blocks=9,
              prefix_sharing=True, max_queue=4)
    runs = []
    for e in (JaxEngine(jcfg, jparams, jconsts, **kw),
              ServeEngine(cfg, tparams, tconsts, device="cpu", **kw)):
        reqs = [e.submit(p, max_new_tokens=20) for p in prompts]
        stats = e.run_until_drained()
        runs.append(([(r.uid, r.status, r.out) for r in reqs],
                     stats["summary"], e.obs.snapshot().get(
                         "serve.sched.preemptions")))
    assert runs[1] == runs[0]
    assert runs[1][1].get("rejected") == 2
    assert runs[1][2]["value"] > 0


def test_block_table_and_scheduler_track_reference():
    """The port's host-side copies under one seeded operation sequence."""
    rng = np.random.default_rng(4)
    layout_j = jkv.PagedLayout.plan(3, 32, 4, 20)
    layout_t = kv.PagedLayout.plan(3, 32, 4, 20)
    assert layout_j.view_len == layout_t.view_len
    js = JaxScheduler(3, 32, layout_j, prefix_sharing=True)
    ts = Scheduler(3, 32, layout_t, prefix_sharing=True)

    class R:
        def __init__(self, uid, prompt):
            self.uid, self.prompt, self.out, self.arrival = uid, prompt, [], 0

    base = rng.integers(3, 50, 8).tolist()
    for uid in range(12):
        prompt = (base if uid % 2 else []) + \
            rng.integers(3, 50, int(rng.integers(1, 6))).tolist()
        for s in (js, ts):
            s.submit(R(uid, list(prompt)))
        adm = [(s_, r.uid) for s_, r in js.admit()]
        assert [(s_, r.uid) for s_, r in ts.admit()] == adm
        if adm:
            jp = js.build_prefill([(s_, js.slot_req[s_]) for s_, _ in adm])
            tp = ts.build_prefill([(s_, ts.slot_req[s_]) for s_, _ in adm])
            for a, b in zip(jp, tp):
                np.testing.assert_array_equal(a, b)
            js.finish_prefill([(s_, js.slot_req[s_]) for s_, _ in adm])
            ts.finish_prefill([(s_, ts.slot_req[s_]) for s_, _ in adm])
        active = js.active_slots
        assert ts.active_slots == active
        assert ts.ensure_decode_blocks(active) == \
            js.ensure_decode_blocks(active)
        for s_ in active:
            js.advance(s_)
            ts.advance(s_)
        if active and rng.random() < 0.5:
            victim = active[int(rng.integers(len(active)))]
            js.finish(victim)
            ts.finish(victim)
        np.testing.assert_array_equal(ts.table(), js.table())
        np.testing.assert_array_equal(ts.blocks.refcount, js.blocks.refcount)
        ts.blocks.check()
