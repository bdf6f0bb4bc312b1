"""exec_mode sparse and quant on the gemma2, vlm and dense llama-variant
families of the port against the reference on the CPU, on the SMOKE
configs of ``gemma2_2b`` (local/global windows, softcaps, post-norms,
GeGLU, tied head), ``paligemma_3b`` (MQA, patch splice) and
``qwen2_5_32b`` (qkv bias), in f32 from one reference init carried over
with ``from_jax_numpy`` (B in ±1, norms and biases in ±0.3, as
``tests/test_torch_families.py`` draws them):

* the calibration: ``repro.quant.calibrate.calibrate_model`` against
  ``repro_torch.quant.calibrate.calibrate_tree`` on the same params, the
  same matrices and nnz, every code, scale and index bit for bit, and
  ``max_abs_err`` within ``ERR_ATOL``;
* the paged engine's tokens and ticks with prefix sharing, decoding past
  gemma2's smoke window of 32, in exec_mode sparse (the support's tile
  consts) and quant (one calibrated artifact, the reference's, loaded by
  each package), tick for tick.

Tolerance: ``max_abs_err`` 1e-6 (f32, an SVD in another library; as
``tests/test_torch_quant.py`` holds it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import registry as jregistry
from repro.quant import calibrate as jcalibrate
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch.ckpt.convert import from_jax_numpy
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.models.common import tree_leaves
from repro_torch.quant import calibrate
from repro_torch.serve.engine import ServeEngine

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

ARCHS = ("gemma2_2b", "paligemma_3b", "qwen2_5_32b")
ERR_ATOL = 1e-6
QUANT_KEYS = ("qv_t", "rows_q", "cols_q", "qscale")


def _cfgs(arch, exec_mode="fused"):
    def mk(cfg):
        return dataclasses.replace(
            cfg, dtype="float32", attn_kernel="paged",
            param=dataclasses.replace(cfg.param, exec_mode=exec_mode))
    return (mk(jregistry.get_smoke_config(arch)),
            mk(registry.get_smoke_config(arch)))


_WEIGHTS, _QUANT = {}, {}


def _weights(arch):
    """The reference's fused init of ``arch`` with B in ±1 and the norms
    and biases in ±0.3, as numpy (cached per arch)."""
    if arch not in _WEIGHTS:
        jcfg, _ = _cfgs(arch)
        params, consts = jregistry.get_api(jcfg).init(
            jcfg, jax.random.PRNGKey(0), seed=0)
        rng = np.random.default_rng(1)

        def fill(path, leaf):
            name = str(path[-1].key)
            if name == "B":
                return rng.uniform(-1, 1, leaf.shape).astype(np.float32)
            if name.startswith("ln") or name == "bias":
                return rng.uniform(-0.3, 0.3, leaf.shape).astype(np.float32)
            return np.asarray(leaf)

        _WEIGHTS[arch] = (jax.tree_util.tree_map_with_path(fill, params),
                          jax.tree.map(np.asarray, consts))
    return _WEIGHTS[arch]


def _quant(arch):
    """Each package's calibration of ``_weights(arch)``: (reference
    params, consts, stats, port consts, stats), cached per arch."""
    if arch not in _QUANT:
        np_params, np_consts = _weights(arch)
        jcfg, cfg = _cfgs(arch)
        jqp, jqc, jst = jcalibrate.calibrate_model(
            jcfg, jax.tree.map(jnp.asarray, np_params), np_consts)
        tp, tc = from_jax_numpy(np_params, np_consts, device="cpu")
        _, tqc, tst = calibrate.calibrate_tree(
            tp, tc, alpha=cfg.param.alpha, delta=cfg.param.delta,
            support_kind=cfg.param.support_kind)
        _QUANT[arch] = (jqp, jqc, jst, tqc, tst)
    return _QUANT[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_calibrate_tree_matches_reference_calibrate_model(arch):
    _, jqc, jst, tqc, tst = _quant(arch)
    assert (tst["n_matrices"], tst["nnz"]) == (jst["n_matrices"],
                                               jst["nnz"])
    assert tst["n_matrices"] > 0
    assert abs(tst["max_abs_err"] - jst["max_abs_err"]) <= ERR_ATOL
    want = {p: v for p, v in tree_leaves(jax.tree.map(np.asarray, jqc))
            if p.split("/")[-1] in QUANT_KEYS}
    have = {p: v for p, v in tree_leaves(tqc)
            if p.split("/")[-1] in QUANT_KEYS}
    assert sorted(have) == sorted(want)
    for p, v in want.items():
        np.testing.assert_array_equal(have[p].numpy(), v, err_msg=p)


def _traffic(cfg, n=6):
    """Half the prompts open with a shared 16-token prefix, tails of 2-7
    tokens, Poisson arrivals; the vlm family's requests carry no patches
    (the engine serves text), as in ``tests/test_torch_families.py``."""
    rng = np.random.default_rng(0)
    shared = rng.integers(3, cfg.vocab_size, size=16).tolist()
    prompts = []
    for i in range(n):
        tail = rng.integers(3, cfg.vocab_size,
                            size=int(rng.integers(2, 8))).tolist()
        prompts.append(shared + tail if i % 2 == 0 else tail)
    return prompts, np.cumsum(rng.poisson(2.0, size=n))


@pytest.mark.parametrize("exec_mode", ["sparse", "quant"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_sparse_and_quant_match_reference(arch, exec_mode):
    """Tokens, ticks and prefill traffic of the paged engine with prefix
    sharing, decoding to position ~35."""
    jcfg, cfg = _cfgs(arch, exec_mode)
    if exec_mode == "quant":
        jqp, jqc = _quant(arch)[:2]
        np_params, np_consts = (jax.tree.map(np.asarray, jqp),
                                jax.tree.map(np.asarray, jqc))
    else:
        np_params, np_consts = _weights(arch)
    tp, tc = from_jax_numpy(np_params, np_consts, device="cpu")
    prompts, arrivals = _traffic(cfg)
    kw = dict(n_slots=4, max_len=64, paged=True, block_len=16,
              prefix_sharing=True)
    runs = []
    for e in (JaxEngine(jcfg, jax.tree.map(jnp.asarray, np_params),
                        jax.tree.map(jnp.asarray, np_consts), **kw),
              ServeEngine(cfg, tp, ops.add_transposed_tiles(tc),
                          device="cpu", **kw)):
        reqs = [e.submit(p, max_new_tokens=12, arrival=int(a))
                for p, a in zip(prompts, arrivals)]
        stats = e.run_stream()
        assert not stats["exhausted"]
        runs.append(([(r.uid, r.status, r.out, r.t_first, r.t_done)
                      for r in reqs], dict(e.prefill_traffic)))
    assert runs[1] == runs[0]
    assert runs[1][1]["tokens_shared"] > 0
    assert all(r[1] == "done" and len(r[2]) == 12 for r in runs[1][0])
