"""AdamW, blockwise 8-bit AdamW and GaLore-AdamW with global-norm
clipping and the warmup-cosine schedule, ported from
``repro.optim.optimizers``.

Interface, as the reference's:

    opt = adamw(oc)
    state = opt.init(params)
    new_params, new_state, stats = opt.update(grads, state, params)

Trees are nested dicts of tensors. ``update`` is functional (new tensors,
the inputs untouched), so the global train step can select the old state
bit-exactly when a step is non-finite. The states mirror the reference's
trees, so checkpoints restore across the two packages: AdamW keeps f32
moments ``mu``/``nu`` shaped like the params, 8-bit AdamW keeps
``{"codes": int8 (n_blocks, q_block), "scales": f32 (n_blocks,)}`` per
moment and leaf, and both an int32 scalar ``step``; GaLore-AdamW keeps
``{"leaves": {...}, "step"}``, per leaf ``{"P", "mu", "nu"}`` where it
projects and ``{"mu", "nu"}`` elsewhere. The optimizer never sees the
fixed SLTrain support (consts live outside the trainable tree).

Per-layer API (``repro_torch.train.perlayer``), as the reference's: the
one-step scalar math is split out of ``update`` so a layer-wise backward
sweep can apply one layer's update while only that layer's gradients
exist:

    ctx, stats = opt.prepare(state, global_grad_norm)   # step/lr/clip/bias
    new_p, new_ls = opt.update_slice(ctx, p, g, ls, full_ndim=...)
    state = opt.finish(state, ctx)                      # bump step counter

``ls`` is one param leaf's state (``leaf_state``/``with_leaf_state``
address it by tree path); ``stack_state`` reshapes it so a leading
layer-stack axis of size n can be sliced, returning None when it cannot
(8-bit blocks that straddle layer boundaries, GaLore's projected leaves),
and the sweep then updates that leaf once at the end from its accumulated
gradient. Weight decay applies to leaves whose full (stacked) leaf has
at least 2 dims: ``full_ndim`` passes that rank for a layer's slice. The
global ``update`` runs through the same ``prepare``/``update_slice``
path, so per-layer and global modes agree leaf for leaf by construction.

``update_slice_fused`` is 8-bit AdamW's kernel dispatch (the ``adam8bit``
kernel, one fused pass) for one leaf or slice, and ``update_group_fused``
for a list of them in one launch (the per-layer sweep sends a layer's
slices, the head leaves, the deferred leaves and the embedding, each
group at once). Both write the new values into the parameter and state
tensors they are given, which keeps the sweep's memory at one layer.
GaLore-AdamW has no kernel dispatch: the sweep runs its ``update_slice``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.models import common
from repro_torch.models.common import tree_map
from repro_torch.optim import quant
from repro_torch.optim.schedule import warmup_cosine


@dataclass(frozen=True)
class Optimizer:
    init: Callable      # params -> state
    update: Callable    # (grads, state, params) -> (new_params, new_state, stats)
    # --- per-layer slice API (repro_torch.train.perlayer) ---
    prepare: Callable = None        # (state, gnorm) -> (ctx, stats)
    update_slice: Callable = None   # (ctx, p, g, ls, full_ndim=None)
    update_slice_fused: Optional[Callable] = None  # kernel dispatch
    update_group_fused: Optional[Callable] = None  # ... over a list
    leaf_state: Callable = None     # (state, path) -> ls
    with_leaf_state: Callable = None  # (state, path, ls) -> state
    stack_state: Callable = None    # (ls, p_leaf, n) -> ls | None
    unstack_state: Callable = None  # (ls_stacked, p_leaf, n) -> ls
    finish: Callable = None         # (state, ctx) -> state


def tree_leaves(tree):
    """Leaves of nested dicts in the reference's flatten order (sorted
    keys at every level), so sums over leaves run in the same order."""
    return [leaf for _, leaf in common.tree_leaves(tree)]


def _global_norm(grads):
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))


# -- nested-dict path addressing (all param/state trees here are dicts) -----

def _tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _tree_set(tree, path, val):
    if not path:
        return val
    out = dict(tree)
    out[path[0]] = _tree_set(tree[path[0]], path[1:], val)
    return out


def _prepare_fn(oc: OptimizerConfig):
    """(state, gnorm) -> (ctx, stats): the step's clip scale, bias
    corrections and learning rate, all device scalars (no host sync)."""
    lr_fn = warmup_cosine(oc)
    b1, b2 = oc.beta1, oc.beta2

    def prepare(state, gnorm):
        step = state["step"] + 1
        scale = torch.clamp(oc.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        sf = step.to(torch.float32)
        bc1 = 1 - torch.pow(b1, sf)
        bc2 = 1 - torch.pow(b2, sf)
        lr = lr_fn(step)
        ctx = {"step": step, "scale": scale, "bc1": bc1, "bc2": bc2,
               "lr": lr}
        return ctx, {"grad_norm": gnorm, "lr": lr}
    return prepare


def _moment_api():
    """leaf_state / with_leaf_state / finish of the {"mu", "nu", "step"}
    states both optimizers keep."""
    def leaf_state(state, path):
        return {"mu": _tree_get(state["mu"], path),
                "nu": _tree_get(state["nu"], path)}

    def with_leaf_state(state, path, ls):
        out = dict(state)
        out["mu"] = _tree_set(state["mu"], path, ls["mu"])
        out["nu"] = _tree_set(state["nu"], path, ls["nu"])
        return out

    def finish(state, ctx):
        return {**state, "step": ctx["step"]}
    return leaf_state, with_leaf_state, finish


def _decays(oc: OptimizerConfig, p, full_ndim) -> bool:
    nd = p.dim() if full_ndim is None else full_ndim
    return oc.weight_decay > 0 and nd >= 2


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(oc: OptimizerConfig) -> Optimizer:
    b1, b2 = oc.beta1, oc.beta2
    prepare = _prepare_fn(oc)
    leaf_state, with_leaf_state, finish = _moment_api()

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        device = tree_leaves(params)[0].device
        return {"mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def update_slice(ctx, p, g, ls, full_ndim=None):
        g = g.float() * ctx["scale"]
        m = b1 * ls["mu"] + (1 - b1) * g
        v = b2 * ls["nu"] + (1 - b2) * g * g
        u = (m / ctx["bc1"]) / (torch.sqrt(v / ctx["bc2"]) + oc.eps)
        if _decays(oc, p, full_ndim):
            u = u + oc.weight_decay * p.float()
        new_p = (p.float() - ctx["lr"] * u).to(p.dtype)
        return new_p, {"mu": m, "nu": v}

    def update(grads, state, params):
        with torch.no_grad():
            ctx, stats = prepare(state, _global_norm(grads))
            paired = tree_map(
                lambda p, g, m, v: update_slice(ctx, p, g,
                                                {"mu": m, "nu": v}),
                params, grads, state["mu"], state["nu"])
            new_params = tree_map(lambda t: t[0], paired)
            mu = tree_map(lambda t: t[1]["mu"], paired)
            nu = tree_map(lambda t: t[1]["nu"], paired)
        return new_params, {"mu": mu, "nu": nu, "step": ctx["step"]}, stats

    def stack_state(ls, p_leaf, n):
        # moments mirror the param leaf, whose leading axis IS the stack
        return ls

    def unstack_state(ls, p_leaf, n):
        return ls

    return Optimizer(init, update, prepare=prepare, update_slice=update_slice,
                     leaf_state=leaf_state, with_leaf_state=with_leaf_state,
                     stack_state=stack_state, unstack_state=unstack_state,
                     finish=finish)


# ---------------------------------------------------------------------------
# Blockwise 8-bit AdamW (paper §5.1 "8-bit SLTrain")
# ---------------------------------------------------------------------------

def adam8bit(oc: OptimizerConfig) -> Optimizer:
    b1, b2 = oc.beta1, oc.beta2
    block = oc.q_block
    prepare = _prepare_fn(oc)
    leaf_state, with_leaf_state, finish = _moment_api()

    def init(params):
        def qz(signed):
            def go(p):
                z = torch.zeros(p.shape, dtype=torch.float32,
                                device=p.device)
                codes, scales, _ = quant.quantize_blockwise(z, block, signed)
                return {"codes": codes, "scales": scales}
            return go
        device = tree_leaves(params)[0].device
        return {"mu": tree_map(qz(True), params),
                "nu": tree_map(qz(False), params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def update_slice(ctx, p, g, ls, full_ndim=None):
        """The plain path: dequantize -> f32 Adam -> requantize. Blocks
        are independent, so applying this to a layer slice whose flat size
        is a whole number of q-blocks equals the global update of those
        blocks."""
        g = g.float() * ctx["scale"]
        n = p.numel()
        m = quant.dequantize_blockwise(ls["mu"]["codes"], ls["mu"]["scales"],
                                       n, p.shape, True)
        v = quant.dequantize_blockwise(ls["nu"]["codes"], ls["nu"]["scales"],
                                       n, p.shape, False)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        u = (m / ctx["bc1"]) / (torch.sqrt(v / ctx["bc2"]) + oc.eps)
        if _decays(oc, p, full_ndim):
            u = u + oc.weight_decay * p.float()
        new_p = (p.float() - ctx["lr"] * u).to(p.dtype)
        mc, ms, _ = quant.quantize_blockwise(m, block, True)
        vc, vs, _ = quant.quantize_blockwise(v, block, False)
        return new_p, {"mu": {"codes": mc, "scales": ms},
                       "nu": {"codes": vc, "scales": vs}}

    def update_group_fused(ctx, items):
        """The ``adam8bit`` kernel over several leaves or layer slices in
        one launch: ``items`` are (p, g, ls, full_ndim), p contiguous.
        Each gradient is read in its own dtype and multiplied by the
        step's clip scale inside the kernel (the bits of ``g.float() *
        ctx["scale"]``); the new parameters, codes and scales are written
        into each p and ``ls``'s tensors. The kernel's (10,) scalars are
        built once per step and device, on the step's ``ctx``."""
        from repro_torch.kernels import ops
        if not items:
            return
        device = items[0][0].device
        cache = ctx.setdefault("adam8bit_scalars", {})
        if device not in cache:
            cache[device] = ops.adam8bit_scalars(
                lr=ctx["lr"], b1=b1, b2=b2, bc1=ctx["bc1"], bc2=ctx["bc2"],
                eps=oc.eps, wd=oc.weight_decay, device=device)
        ops.adam8bit_group_update(
            [(p, g, ls["mu"]["codes"], ls["mu"]["scales"],
              ls["nu"]["codes"], ls["nu"]["scales"],
              _decays(oc, p, full_ndim)) for p, g, ls, full_ndim in items],
            scalars=cache[device], clip=ctx["scale"])

    def update_slice_fused(ctx, p, g, ls, full_ndim=None):
        """One leaf or layer slice through the ``adam8bit`` kernel (the
        one-item case of ``update_group_fused``); p and ``ls``'s tensors
        are updated in place and returned."""
        update_group_fused(ctx, [(p, g, ls, full_ndim)])
        return p, ls

    def update(grads, state, params):
        with torch.no_grad():
            ctx, stats = prepare(state, _global_norm(grads))
            paired = tree_map(
                lambda p, g, m, v: update_slice(ctx, p, g,
                                                {"mu": m, "nu": v}),
                params, grads, state["mu"], state["nu"])
            new_params = tree_map(lambda t: t[0], paired)
            mu = tree_map(lambda t: t[1]["mu"], paired)
            nu = tree_map(lambda t: t[1]["nu"], paired)
        return new_params, {"mu": mu, "nu": nu, "step": ctx["step"]}, stats

    def stack_state(ls, p_leaf, n):
        """Views of the codes/scales with a leading axis of the n layer
        slices. Possible exactly when each slice is a whole number of
        q-blocks; otherwise blocks straddle layer boundaries and the leaf
        takes the deferred full-gradient path (returns None)."""
        if n <= 0 or p_leaf.numel() % n:
            return None
        per = p_leaf.numel() // n
        if per % block:
            return None
        bpl = per // block

        def go(moment):
            return {"codes": moment["codes"].reshape(n, bpl, block),
                    "scales": moment["scales"].reshape(n, bpl)}
        return {"mu": go(ls["mu"]), "nu": go(ls["nu"])}

    def unstack_state(ls, p_leaf, n):
        def go(moment):
            return {"codes": moment["codes"].reshape(-1, block),
                    "scales": moment["scales"].reshape(-1)}
        return {"mu": go(ls["mu"]), "nu": go(ls["nu"])}

    return Optimizer(init, update, prepare=prepare, update_slice=update_slice,
                     update_slice_fused=update_slice_fused,
                     update_group_fused=update_group_fused,
                     leaf_state=leaf_state, with_leaf_state=with_leaf_state,
                     stack_state=stack_state, unstack_state=unstack_state,
                     finish=finish)


# ---------------------------------------------------------------------------
# GaLore-AdamW (paper baseline [59]): low-rank gradient projection
# ---------------------------------------------------------------------------

def galore_adamw(oc: OptimizerConfig) -> Optimizer:
    """AdamW whose moments live in the span of P, the top-r singular
    vectors of the gradient, refreshed every ``galore_update_proj_gap``
    steps. Projected are, as in the reference, the 2-D leaves with both
    dims above ``galore_rank`` and no "embed" in their path. Layer leaves
    are stacked on a leading axis, so on the llama trees only ``lm_head``
    is 2-D: it alone is projected, as in the reference, and every other
    leaf keeps full f32 moments.

    P comes from ``torch.linalg.svd`` in f32 of g·gᵀ (of gᵀ·g when
    d > q), cuSOLVER on the card; its columns' signs are the solver's
    choice, which P·Pᵀ and the update do not see. Whether this step
    refreshes P is read on the host once per step in ``prepare`` (one
    ``.item()`` of the device step counter): the SVD runs only at a
    refresh."""
    r = oc.galore_rank
    b1, b2 = oc.beta1, oc.beta2
    base_prepare = _prepare_fn(oc)

    def is_proj(path, p):
        return p.dim() == 2 and min(p.shape) > r and "embed" not in path

    def init(params):
        def st(path, p):
            z = lambda *shape: torch.zeros(shape, dtype=torch.float32,
                                           device=p.device)
            if is_proj(path, p):
                d, q = p.shape
                if d <= q:
                    return {"P": z(d, r), "mu": z(r, q), "nu": z(r, q)}
                return {"P": z(q, r), "mu": z(d, r), "nu": z(d, r)}
            return {"mu": z(*p.shape), "nu": z(*p.shape)}

        def walk(tree, prefix):
            if isinstance(tree, dict):
                return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                        for k, v in tree.items()}
            return st(prefix, tree)
        device = tree_leaves(params)[0].device
        return {"leaves": walk(params, ""),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def prepare(state, gnorm):
        ctx, stats = base_prepare(state, gnorm)
        # the one host read of the step: the SVD runs only at a refresh
        ctx["refresh"] = (int(ctx["step"].item()) - 1) \
            % oc.galore_update_proj_gap == 0
        return ctx, stats

    def update_slice(ctx, p, g, ls, full_ndim=None):
        g = g.float() * ctx["scale"]
        if "P" not in ls:
            m = b1 * ls["mu"] + (1 - b1) * g
            v = b2 * ls["nu"] + (1 - b2) * g * g
            u = (m / ctx["bc1"]) / (torch.sqrt(v / ctx["bc2"]) + oc.eps)
            if _decays(oc, p, full_ndim):
                u = u + oc.weight_decay * p.float()
            return (p.float() - ctx["lr"] * u).to(p.dtype), \
                {"mu": m, "nu": v}
        d, q = p.shape
        left = d <= q
        P = ls["P"]
        if ctx["refresh"]:
            # top-r singular vectors of the current gradient
            if left:
                P = torch.linalg.svd(g @ g.T)[0][:, :r]
            else:
                P = torch.linalg.svd(g.T @ g)[2][:r].T
        R = P.T @ g if left else g @ P               # projected gradient
        m = b1 * ls["mu"] + (1 - b1) * R
        v = b2 * ls["nu"] + (1 - b2) * R * R
        u_low = (m / ctx["bc1"]) / (torch.sqrt(v / ctx["bc2"]) + oc.eps)
        u = (P @ u_low if left else u_low @ P.T) * oc.galore_scale
        if oc.weight_decay > 0:
            u = u + oc.weight_decay * p.float()
        return (p.float() - ctx["lr"] * u).to(p.dtype), \
            {"P": P, "mu": m, "nu": v}

    def update(grads, state, params):
        with torch.no_grad():
            ctx, stats = prepare(state, _global_norm(grads))
            # tree_map walks params: each leaf meets its whole state dict
            paired = tree_map(lambda p, g, ls: update_slice(ctx, p, g, ls),
                              params, grads, state["leaves"])
            new_params = tree_map(lambda t: t[0], paired)
            leaves = tree_map(lambda t: t[1], paired)
        return new_params, {"leaves": leaves, "step": ctx["step"]}, stats

    def leaf_state(state, path):
        return _tree_get(state["leaves"], path)

    def with_leaf_state(state, path, ls):
        return {**state, "leaves": _tree_set(state["leaves"], path, ls)}

    def stack_state(ls, p_leaf, n):
        # a projected leaf shares one P and one moment pair across the
        # whole leaf: it cannot be sliced layer-wise (and stacked leaves
        # are never projected, see is_proj)
        return None if "P" in ls else ls

    def unstack_state(ls, p_leaf, n):
        return ls

    def finish(state, ctx):
        return {**state, "step": ctx["step"]}

    return Optimizer(init, update, prepare=prepare, update_slice=update_slice,
                     leaf_state=leaf_state, with_leaf_state=with_leaf_state,
                     stack_state=stack_state, unstack_state=unstack_state,
                     finish=finish)


def make(oc: OptimizerConfig) -> Optimizer:
    if oc.name == "adamw":
        return adamw(oc)
    if oc.name == "adam8bit":
        return adam8bit(oc)
    if oc.name == "galore_adamw":
        return galore_adamw(oc)
    raise ValueError(f"unknown optimizer {oc.name!r}")
