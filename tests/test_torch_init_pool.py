"""The port's pooled init: every SLTrain linear's support sampled first, in
worker processes (``core.support.sample_supports``, driven by
``models.common.presample``), then the values drawn from the one
generator as before. It must change no bit: params and consts equal to
the in-process init's in every exec mode, through the tile-cap re-sample
too, and the supports equal to the reference's sampler at the real
``llama_7b`` Builder paths. Also the least-squares depth fit that
chip_smoke.py extrapolates the full-rank 7B peak with."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import support as jsupport
from repro.models.common import _name_hash as jname_hash
from repro_torch.core import memory
from repro_torch.core import support
from repro_torch.models import common, lm, registry
from repro_torch.models.common import tree_leaves


def _cfg(arch, exec_mode, smoke=True):
    cfg = registry.get_smoke_config(arch) if smoke else \
        registry.get_config(arch)
    return dataclasses.replace(cfg, param=dataclasses.replace(
        cfg.param, exec_mode=exec_mode))


def _specs(cfg, seed):
    """(path, spec) of every SLTrain linear, in the Builder's order."""
    specs = []
    lm._build_lm(cfg, common.Builder(cfg, None, torch.device("meta"),
                                     seed=seed, plan=specs))
    return specs


def _assert_same_trees(a, b):
    for ta, tb in zip(a, b):
        la, lb = list(tree_leaves(ta)), list(tree_leaves(tb))
        assert [k for k, _ in la] == [k for k, _ in lb]
        for (k, x), (_, y) in zip(la, lb):
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert torch.equal(x, y), k


@pytest.mark.parametrize("exec_mode", ["dense", "fused", "sparse"])
@pytest.mark.parametrize("arch", ["llama_7b", "llama_60m"])
def test_pooled_init_bit_identical_to_one_process(arch, exec_mode):
    cfg = _cfg(arch, exec_mode)
    reg = {}
    for workers in (1, 2):
        from repro_torch.obs import metrics as obs_metrics
        obs = obs_metrics.Registry()
        reg[workers] = (lm.init_lm(cfg, 7, device="cpu", workers=workers,
                                   obs=obs), obs)
        assert obs.get("init.sampling_workers").value == workers
        assert obs.get("init.seconds").value > 0
    _assert_same_trees(reg[1][0], reg[2][0])
    # and equal to the Builder that samples each support where it builds
    gen = torch.Generator().manual_seed(7)
    inline = lm._build_lm(cfg, common.Builder(cfg, gen, torch.device("cpu"),
                                              seed=7))
    _assert_same_trees(reg[2][0], inline)


def _first_draw_max(spec):
    seed, d_in, d_out, delta, kind, _ = spec
    rows, cols = support.sample_support(seed, d_in, d_out, delta, kind)
    ceil = lambda n: -(-n // support.TILE) * support.TILE
    return int(support.tile_layout(rows, cols, ceil(d_in),
                                   ceil(d_out))[2].max())


def test_pooled_init_bit_identical_through_tile_cap_resample(monkeypatch):
    """A capacity one below the largest tile of any linear's first draw:
    those linears re-sample with the bumped seed in the workers, and the
    init is still bit-identical to the in-process one."""
    cfg = _cfg("llama_60m", "fused")
    specs = [s for _, s in _specs(cfg, 3)]
    firsts = [_first_draw_max(s) for s in specs]
    cap = max(firsts) - 1
    monkeypatch.setattr(support, "tile_cap", lambda *a, **k: cap)
    busting = [s for s, m in zip(specs, firsts) if m > cap]
    assert busting
    for s in busting:
        rows, cols, _ = support.final_support(*s[:5], cap=cap)
        assert not np.array_equal(cols, support.sample_support(*s[:5])[1])
    one = lm.init_lm(cfg, 3, device="cpu", workers=1)
    two = lm.init_lm(cfg, 3, device="cpu", workers=2)
    _assert_same_trees(one, two)
    assert all(t.shape[-1] == cap for k, t in tree_leaves(two[1])
               if k.endswith("/perm"))


def test_pooled_supports_match_reference_at_7b_paths():
    """The collecting pass over the full llama_7b config gives the
    reference Builder's 224 paths; supports sampled in the pool at one
    full 4096 x 11008 matrix and a few attention ones equal the
    reference's sampler keyed by seed ^ crc32(path)."""
    cfg = _cfg("llama_7b", "dense", smoke=False)
    specs = dict(_specs(cfg, 0))
    assert len(specs) == 7 * cfg.n_layers == 224
    picks = ["/blocks/p0/k0/mlp/gate", "/blocks/p31/k0/attn/wq"]
    for path in picks:
        assert specs[path][0] == 0 ^ jname_hash(path)
    # the full-width MLP matrix, then smoke-sized matrices at the attention
    # paths of the last layer
    jobs = [specs[picks[0]]] + [
        (specs[p][0], 64, 160, 0.05, "row_balanced", None)
        for p in ("/blocks/p31/k0/attn/wq", "/blocks/p31/k0/attn/wo")]
    got = support.sample_supports(jobs, workers=2)
    assert jobs[0][1:3] == (4096, 11008)
    for (seed, d_in, d_out, delta, kind, _), (rows, cols, tiles) in zip(
            jobs, got):
        want = jsupport.sample_support(seed, d_in, d_out, delta, kind)
        assert tiles is None
        np.testing.assert_array_equal(rows, want[0])
        np.testing.assert_array_equal(cols, want[1])


def test_failing_worker_raises():
    """A worker whose support cannot fit its capacity (every re-sample of
    a dense 128 x 128 tile busts 8 slots) exits non-zero: the caller gets
    its traceback."""
    spec = (1, 128, 128, 0.3, "row_balanced", 8)
    with pytest.raises(RuntimeError, match="too small"):
        support.sample_supports([spec, spec], workers=2)


def test_default_workers_pools_from_llama_350m():
    def workers(arch):
        return support.default_workers(
            [s for _, s in _specs(_cfg(arch, "fused", smoke=False), 0)])
    assert workers("llama_60m") == workers("llama_130m") == 1
    for arch in ("llama_350m", "llama_1b", "llama_7b"):
        assert 1 <= workers(arch) <= support.MAX_WORKERS
    assert support.default_workers(
        [(0, 64, 64, 0.05, "row_balanced", None)]) == 1


def test_depth_fit_exact_on_linear_data():
    depths, a, b = (2, 4, 8), 3.5e9, 4.25e9
    fit = memory.depth_fit(depths, [a + b * d for d in depths])
    assert fit.a == pytest.approx(a, rel=1e-12)
    assert fit.b == pytest.approx(b, rel=1e-12)
    assert max(abs(r) for r in fit.residuals) <= 1e-6 * b
    assert fit.at(32) == pytest.approx(a + 32 * b, rel=1e-12)


def test_depth_fit_reports_residuals():
    depths, ys = (2, 4, 8), (10.0, 21.0, 38.0)
    fit = memory.depth_fit(depths, ys)
    assert fit.residuals == pytest.approx(
        [y - (fit.a + fit.b * d) for d, y in zip(depths, ys)])
    assert sum(fit.residuals) == pytest.approx(0.0, abs=1e-9)
    assert any(abs(r) > 0.1 for r in fit.residuals)
    # least squares: the slope and intercept numpy's polyfit gives
    b, a = np.polyfit(depths, ys, 1)
    assert (fit.a, fit.b) == pytest.approx((a, b), rel=1e-9)
    with pytest.raises(ValueError, match="two distinct depths"):
        memory.depth_fit((4, 4), (1.0, 2.0))
