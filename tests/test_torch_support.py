"""The port's copy of the sparse-support sampler and tile layout
(src/repro_torch/core/support.py, kernels/ops.py, core/sltrain.py) must
stay bit-identical to the reference's, including the iid sampler, the
blocked DENSE_KEYS_ELEMS branch and the fused re-sample fallback."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.core import sltrain as jsltrain
from repro.core import support as jsupport
from repro.kernels import ops as jops
from repro.models import registry as jregistry
from repro_torch.core import support
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.models.common import tree_leaves

SHAPES = [(64, 160, 0.05), (160, 64, 0.05), (300, 517, 0.03),
          (129, 1000, 0.01), (8, 8, 0.5)]


@pytest.mark.parametrize("kind", ["row_balanced", "iid"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 12345, 2 ** 31 - 1])
def test_sample_support_bit_identical(shape, kind, seed):
    d_in, d_out, delta = shape
    want = jsupport.sample_support(seed, d_in, d_out, delta, kind)
    got = support.sample_support(seed, d_in, d_out, delta, kind)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert support.nnz_for(d_in, d_out, delta, kind) == \
        jsupport.nnz_for(d_in, d_out, delta, kind)
    assert support.tile_cap(d_in, d_out, delta, kind) == \
        jsupport.tile_cap(d_in, d_out, delta, kind)


@pytest.mark.parametrize("block_elems", [300, 1000, 5000])
def test_blocked_keys_branch_bit_identical(monkeypatch, block_elems):
    """Both packages with the key matrix drawn in row blocks, against the
    reference's single full-matrix draw."""
    full = jsupport.sample_support(3, 97, 130, 0.05)
    monkeypatch.setattr(jsupport, "DENSE_KEYS_ELEMS", block_elems)
    monkeypatch.setattr(support, "DENSE_KEYS_ELEMS", block_elems)
    want = jsupport.sample_support(3, 97, 130, 0.05)
    got = support.sample_support(3, 97, 130, 0.05)
    for g, w, f in zip(got, want, full):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, f)


@pytest.mark.parametrize("kind", ["row_balanced", "iid"])
@pytest.mark.parametrize("shape", SHAPES[:4])
def test_tile_layout_and_consts_bit_identical(shape, kind):
    d_in, d_out, delta = shape
    rows, cols = jsupport.sample_support(7, d_in, d_out, delta, kind)
    for pad in (None, jsupport.tile_cap(d_in, d_out, delta, kind)):
        want = jsupport.tile_layout(rows, cols, d_in, d_out, pad=pad)
        got = support.tile_layout(rows, cols, d_in, d_out, pad=pad)
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3]
    cap = jsupport.tile_cap(d_in, d_out, delta, kind)
    want = jops.prepare_tile_consts(rows, cols, d_in, d_out, pad=cap)
    got = ops.prepare_tile_consts(rows, cols, d_in, d_out, pad=cap)
    for name in ("rows_t", "cols_t", "perm"):
        assert got[name].numpy().dtype == np.int32
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]))


def test_tile_layout_overflow_raises_like_reference():
    rows, cols = jsupport.sample_support(1, 128, 128, 0.3)
    with pytest.raises(ValueError, match="re-sample"):
        support.tile_layout(rows, cols, 128, 128, pad=8)


def test_fused_resample_fallback_matches_reference(monkeypatch):
    """A capacity the sampled support busts makes both packages re-sample
    with the same bumped seed and land on the same support."""
    d_in, d_out, delta = 128, 256, 0.05

    def tile_max(seed):
        r, c = jsupport.sample_support(seed, d_in, d_out, delta)
        return int(jsupport.tile_layout(r, c, d_in, d_out)[2].max())

    # a seed whose first draw busts a capacity its first re-sample fits
    seed = next(s for s in range(100)
                if tile_max(s + jsltrain._RESAMPLE_STRIDE) < tile_max(s))
    cap = tile_max(seed + jsltrain._RESAMPLE_STRIDE)
    rows, cols = jsupport.sample_support(seed, d_in, d_out, delta)
    monkeypatch.setattr(jsupport, "tile_cap", lambda *a, **k: cap)
    monkeypatch.setattr(support, "tile_cap", lambda *a, **k: cap)
    want = jsltrain.prepare_fused_consts(rows, cols, d_in, d_out, delta,
                                         "row_balanced", seed)
    got = support.fit_tiles(rows, cols, d_in, d_out, delta, "row_balanced",
                            seed, support.tile_cap(d_in, d_out, delta))
    assert support.RESAMPLE_STRIDE == jsltrain._RESAMPLE_STRIDE
    assert support.RESAMPLE_ATTEMPTS == jsltrain._RESAMPLE_ATTEMPTS
    assert not np.array_equal(got[1], cols)        # it did re-sample
    np.testing.assert_array_equal(got[1], want[1])
    for name, arr in zip(support.TILE_CONSTS, got[2]):
        assert arr.dtype == np.int32
        np.testing.assert_array_equal(arr, np.asarray(want[2][name]))
    # the init path: the same re-sample behind final_support's capacity
    final = support.final_support(seed, d_in, d_out, delta, cap=cap)
    np.testing.assert_array_equal(final[1], want[1])


@pytest.mark.parametrize("exec_mode", ["dense", "fused"])
def test_init_lm_supports_and_shapes_match_reference(exec_mode):
    """The port's init walks the reference Builder's paths: every const
    (supports and tile consts) is bit-identical and every param has the
    reference's path, shape and dtype."""
    jcfg = jregistry.get_smoke_config("llama_60m")
    jcfg = dataclasses.replace(jcfg, param=dataclasses.replace(
        jcfg.param, exec_mode=exec_mode))
    jp, jc = jregistry.get_api(jcfg).init(jcfg, jax.random.PRNGKey(0),
                                          seed=5)
    cfg = registry.get_smoke_config("llama_60m")
    cfg = dataclasses.replace(cfg, param=dataclasses.replace(
        cfg.param, exec_mode=exec_mode))
    tp, tc = registry.get_api(cfg).init(cfg, 5, device="cpu")

    def flat(tree):
        out = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out["/".join(str(k.key) for k in path)] = np.asarray(leaf)
        return out

    jpf, jcf = flat(jp), flat(jc)
    tpf = {k: v for k, v in tree_leaves(tp)}
    tcf = {k: v for k, v in tree_leaves(tc)}
    assert sorted(tpf) == sorted(jpf) and sorted(tcf) == sorted(jcf)
    for k, v in tcf.items():
        np.testing.assert_array_equal(v.numpy(), jcf[k], err_msg=k)
    for k, v in tpf.items():
        assert tuple(v.shape) == jpf[k].shape, k
        assert str(v.dtype).split(".")[-1] == str(jpf[k].dtype), k
