"""Training in exec_mode sparse: the port against the reference on the CPU.

* Each sparse-mode linear's gradients (dx, dB, dA, dv) from
  ``ops.sl_sparse_linear`` (through ``sltrain.sl_matmul(..., "sparse")``)
  against ``jax.grad`` of the reference's ``repro.core.sltrain.sl_matmul(...,
  "sparse")`` (its autodiff of ``_sl_matmul_sparse``), in f32, on
  row-balanced and iid supports at three shapes (one tile, ragged K and N,
  d_out < d_in). The port's dx goes through the plain version of
  ``sparse_matmul`` over Wᵀ's tiles, its dV through ``sddmm``'s.
* The sparse-mode forward, served and trained, against the reference's
  ``sl_matmul(..., "sparse")`` in f32 and bf16: one rounding of the f32
  sum of both terms.
* Three f32 train steps of the ``llama_60m`` smoke config in exec_mode
  sparse, from the reference's params carried over with
  ``from_jax_numpy`` (B drawn at random so that dA and the low-rank half
  of dx are not 0), under the port's global and per-layer AdamW, against
  ``jax.jit`` of the reference's ``make_train_step``.

Tolerances: gradients |got − want| ≤ 1e-5·(|want| + max|want|), the same
f32 sums in another order. Trajectories: step 1 runs from identical
params, so loss and grad norm agree to 1e-5 relative; from step 2 Adam
divides each gradient by its own magnitude, so an element whose gradient
is near 0 moves by up to lr either way, and they agree to 1e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import OptimizerConfig as JOptimizerConfig
from repro.core import sltrain as jsltrain
from repro.models import registry as jregistry
from repro.optim import optimizers as joptim
from repro.train import step as jstep
from repro_torch.ckpt.convert import from_jax_numpy
from repro_torch.configs.base import OptimizerConfig
from repro_torch.core import sltrain
from repro_torch.data.pipeline import SyntheticC4
from repro_torch.kernels import ops
from repro_torch.models import registry
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.optim import optimizers
from repro_torch.train import perlayer
from repro_torch.train import step as step_lib

# one intra-op thread a worker: pytest-xdist runs a worker per core
torch.set_num_threads(1)

RTOL = 1e-5
STEPS = 3
TRAIN_TOL_STEP1 = 1e-5
TRAIN_TOL_LATER = 1e-3
# (M, K, N, r, delta): one tile, ragged K and N, d_out < d_in
SHAPES = [(5, 128, 128, 16, 0.05), (7, 130, 250, 8, 0.05),
          (3, 384, 200, 8, 0.03)]


def _close(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want)
    bound = RTOL * (np.abs(want) + np.abs(want).max())
    assert (err <= bound).all(), (f"max abs err {err.max():.3e}, worst "
                                  f"err/bound {(err / bound).max():.2f}")


@pytest.mark.parametrize("support_kind", ["row_balanced", "iid"])
@pytest.mark.parametrize("case", SHAPES)
def test_sparse_linear_grads_match_reference_autodiff(case, support_kind):
    m, k, n, r, delta = case
    _, jc = jsltrain.init_params(jax.random.PRNGKey(0), k, n, r, delta,
                                 dtype=jnp.float32, support_kind=support_kind,
                                 seed=k + n, exec_mode="sparse")
    _, tc = sltrain.init_params(torch.Generator(), k, n, r, delta,
                                dtype=torch.float32,
                                support_kind=support_kind, seed=k + n,
                                exec_mode="sparse", device="cpu")
    tc = ops.add_transposed_tiles(tc)
    rng = np.random.default_rng(m * k)
    f32 = np.float32
    x = rng.standard_normal((m, k)).astype(f32)
    B = (rng.standard_normal((k, r)) * 0.1).astype(f32)
    A = (rng.standard_normal((r, n)) * 0.1).astype(f32)
    v = (rng.standard_normal(tc["cols"].shape) * 0.1).astype(f32)
    dy = rng.standard_normal((m, n)).astype(f32)
    scale = 16.0 / r

    def jloss(x, B, A, v):
        y = jsltrain.sl_matmul(x, {"B": B, "A": A, "v": v}, jc, scale,
                               "sparse")
        return jnp.sum(y * jnp.asarray(dy))

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, (x, B, A, v)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, B, A, v)]
    y = sltrain.sl_matmul(leaves[0], dict(zip("BAv", leaves[1:])), tc, scale,
                          "sparse")
    y.backward(torch.from_numpy(dy))
    for name, t, w in zip(("dx", "dB", "dA", "dv"), leaves, want):
        assert t.grad is not None, name
        _close(t.grad, w)


def _bf16_ulp(t):
    """One bf16 ulp at the magnitude of ``t`` (8 significant bits)."""
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(t), 2.0 ** -126)))
                   - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad", [False, True], ids=["serve", "train"])
@pytest.mark.parametrize("case", SHAPES)
def test_sparse_linear_forward_rounds_once_as_reference(case, grad, dtype):
    """The sparse-mode forward, served (``ops.sl_decode``) and trained
    (``ops.sl_sparse_linear``), against the reference's ``sl_matmul(...,
    "sparse")``, which sums the low-rank and sparse terms in f32 and
    rounds once. f32: RTOL of the output's scale.
    bf16: the two round the same f32 sum (up to its order) once, so they
    differ by at most one ulp of the output, plus RTOL of the two addends'
    magnitude for the f32 sums' order; a kernel term rounded to bf16
    before the sum would add half an ulp of x·S, far more where the terms
    cancel."""
    m, k, n, r, delta = case
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    _, jc = jsltrain.init_params(jax.random.PRNGKey(0), k, n, r, delta,
                                 dtype=jnp.float32, seed=k + n,
                                 exec_mode="sparse")
    _, tc = sltrain.init_params(torch.Generator(), k, n, r, delta,
                                dtype=torch.float32, seed=k + n,
                                exec_mode="sparse", device="cpu")
    tc = ops.add_transposed_tiles(tc)
    rng = np.random.default_rng(m * k + n)
    f32 = np.float32
    x = rng.standard_normal((m, k)).astype(f32)
    B = (rng.standard_normal((k, r)) * 0.3).astype(f32)
    A = (rng.standard_normal((r, n)) * 0.3).astype(f32)
    v = (rng.standard_normal(tc["cols"].shape) * 0.3).astype(f32)
    scale = 16.0 / r
    want = jax.jit(lambda *a: jsltrain.sl_matmul(
        a[0], dict(zip("BAv", a[1:])), jc, scale, "sparse"))(
        *(jnp.asarray(a).astype(jdt) for a in (x, B, A, v)))
    want = np.asarray(want.astype(jnp.float32))
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_(grad)
              for a in (x, B, A, v)]
    got = sltrain.sl_matmul(leaves[0], dict(zip("BAv", leaves[1:])), tc,
                            scale, "sparse")
    assert got.dtype == tdt and got.requires_grad == grad
    got = got.detach().float().numpy()
    # the addends from the same (rounded) operands, in f32
    xs, Bs, As, vs = (a.detach().float().numpy() for a in leaves)
    S = np.zeros((k, n), f32)
    np.add.at(S, (np.broadcast_to(np.arange(k)[:, None], tc["cols"].shape),
                  tc["cols"].numpy()), vs)
    terms = np.maximum(np.abs((xs @ Bs) @ As * scale), np.abs(xs @ S))
    err = np.abs(got - want)
    if dtype == "float32":
        bound = RTOL * (np.abs(want) + np.abs(want).max())
    else:
        bound = _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) \
            + RTOL * terms
    assert (err <= bound).all(), (f"max abs err {err.max():.3e}, worst "
                                  f"err/bound {(err / bound).max():.2f}")


def test_sparse_linear_backward_needs_transposed_tiles():
    """Without Wᵀ's tile consts (built once by the Trainer) the backward
    raises; the forward alone needs none."""
    p, c = sltrain.init_params(torch.Generator().manual_seed(0), 64, 96, 8,
                               0.05, dtype=torch.float32, seed=3,
                               exec_mode="sparse", device="cpu")
    x = torch.randn(2, 64, requires_grad=True)
    y = sltrain.sl_matmul(x, p, c, 1.0, "sparse")
    with pytest.raises(ValueError, match="add_transposed_tiles"):
        y.sum().backward()


# ---------------------------------------------------------------------------
# 3-step trajectories on the llama_60m smoke config, f32
# ---------------------------------------------------------------------------

def _cfgs(exec_mode):
    def mk(cfg):
        return dataclasses.replace(cfg, dtype="float32",
                                   param=dataclasses.replace(
                                       cfg.param, exec_mode=exec_mode))
    return (mk(jregistry.get_smoke_config("llama_60m")),
            mk(registry.get_smoke_config("llama_60m")))


def _carried():
    """The reference's init (fused, so that its consts hold the tile consts
    that the port's sparse mode reads besides the support) with B drawn
    U(−0.1, 0.1), as numpy trees, and the port's copy of it."""
    jcfg, _ = _cfgs("fused")
    params, consts = jregistry.get_api(jcfg).init(
        jcfg, jax.random.PRNGKey(42), seed=42)
    rng = np.random.default_rng(7)

    def fill_b(path, leaf):
        if str(path[-1].key) == "B":
            return rng.uniform(-0.1, 0.1, leaf.shape).astype(np.float32)
        return np.asarray(leaf)

    params = jax.tree_util.tree_map_with_path(fill_b, params)
    consts = jax.tree.map(np.asarray, consts)
    tp, tc = from_jax_numpy(params, consts, device="cpu")
    return params, consts, tp, ops.add_transposed_tiles(tc)


def _okw():
    return dict(lr=1e-3, warmup_steps=1, total_steps=STEPS)


def _reference_rows(params, consts, batches):
    jcfg, _ = _cfgs("sparse")
    jopt = joptim.make(JOptimizerConfig(**_okw()))
    fn = jax.jit(jstep.make_train_step(jcfg, jregistry.get_api(jcfg), jopt))
    p = jax.tree.map(jnp.asarray, params)
    c = jax.tree.map(jnp.asarray, consts)
    s = jopt.init(p)
    rows = []
    for toks in batches:
        p, s, m = fn(p, s, c, {"tokens": jnp.asarray(toks)})
        rows.append((float(m["loss"]), float(m["grad_norm"])))
    return rows


@pytest.mark.parametrize("update_mode", ["global", "per_layer"])
def test_sparse_train_trajectory_matches_reference(update_mode):
    params, consts, tp, tc = _carried()
    data = SyntheticC4(512, 32, 4, seed=0)
    batches = [data.next_batch()["tokens"] for _ in range(STEPS)]
    want = _reference_rows(params, consts, batches)
    _, cfg = _cfgs("sparse")
    api = registry.get_api(cfg)
    opt = optimizers.make(OptimizerConfig(**_okw()))
    fn = perlayer.make_perlayer_train_step(cfg, api, opt) \
        if update_mode == "per_layer" else \
        step_lib.make_train_step(cfg, api, opt)
    p = tree_map(torch.clone, tp)
    st = opt.init(p)
    got = []
    for toks in batches:
        p, st, m = fn(p, st, tc, {"tokens": torch.from_numpy(toks)})
        assert float(m["nonfinite"]) == 0.0
        got.append((float(m["loss"]), float(m["grad_norm"])))
    for i, (g, w) in enumerate(zip(got, want)):
        tol = TRAIN_TOL_STEP1 if i == 0 else TRAIN_TOL_LATER
        np.testing.assert_allclose(g, w, rtol=tol, err_msg=f"step {i + 1}")


def test_sparse_and_dense_grads_agree_in_port():
    """One step's gradients of exec_mode sparse and dense on the same
    params: the two backwards compute one function."""
    _, _, tp, tc = _carried()
    toks = torch.from_numpy(SyntheticC4(512, 32, 2, seed=1).next_batch()[
        "tokens"])
    grads = {}
    for mode in ("sparse", "dense"):
        _, cfg = _cfgs(mode)
        loss_fn = step_lib.make_loss_fn(cfg, registry.get_api(cfg))
        _, _, grads[mode] = step_lib._value_and_grad(loss_fn, tp, tc,
                                                      {"tokens": toks})
    for (path, a), (_, b) in zip(tree_leaves(grads["sparse"]),
                                 tree_leaves(grads["dense"])):
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5 * max(scale, 1e-3),
                                   err_msg=path)
