"""AdamW with global-norm clipping and the warmup-cosine schedule, ported
from ``repro.optim.optimizers``.

Interface, as the reference's:

    opt = adamw(oc)
    state = opt.init(params)
    new_params, new_state, stats = opt.update(grads, state, params)

Trees are nested dicts of tensors. ``update`` is functional (new tensors,
the inputs untouched), so the train step can select the old state
bit-exactly when a step is non-finite. It runs through the same
``prepare``/``update_slice`` split as the reference: the step's scalars
once, then one leaf at a time. The state mirrors the reference's tree: f32
moments ``mu``/``nu`` shaped like the params and an int32 scalar ``step``,
so checkpoints restore across the two packages. The optimizer never sees
the fixed SLTrain support (consts live outside the trainable tree).

``adam8bit`` and ``galore_adamw`` are not ported yet (ROADMAP queue A
item 5) and raise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.models import common
from repro_torch.models.common import tree_map
from repro_torch.optim.schedule import warmup_cosine


@dataclass(frozen=True)
class Optimizer:
    init: Callable      # params -> state
    update: Callable    # (grads, state, params) -> (new_params, new_state, stats)
    prepare: Callable   # (state, gnorm) -> (ctx, stats)
    update_slice: Callable  # (ctx, p, g, {"mu", "nu"}) -> (new_p, {"mu", "nu"})


def tree_leaves(tree):
    """Leaves of nested dicts in the reference's flatten order (sorted
    keys at every level), so sums over leaves run in the same order."""
    return [leaf for _, leaf in common.tree_leaves(tree)]


def _global_norm(grads):
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))


def adamw(oc: OptimizerConfig) -> Optimizer:
    lr_fn = warmup_cosine(oc)
    b1, b2 = oc.beta1, oc.beta2

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        device = tree_leaves(params)[0].device
        return {"mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

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

    def update_slice(ctx, p, g, ls):
        g = g.float() * ctx["scale"]
        m = b1 * ls["mu"] + (1 - b1) * g
        v = b2 * ls["nu"] + (1 - b2) * g * g
        u = (m / ctx["bc1"]) / (torch.sqrt(v / ctx["bc2"]) + oc.eps)
        if oc.weight_decay > 0 and p.dim() >= 2:
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

    return Optimizer(init, update, prepare, update_slice)


def make(oc: OptimizerConfig) -> Optimizer:
    if oc.name != "adamw":
        raise NotImplementedError(
            f"optimizer {oc.name!r} is not ported yet (ROADMAP queue A item "
            "5: the memory path, adam8bit and galore_adamw); the port "
            "trains with adamw")
    return adamw(oc)
