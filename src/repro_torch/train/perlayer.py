"""Layer-wise backward with in-sweep optimizer updates (the paper's
"per-layer updates" memory path, §5.1 / Appendix F), ported from
``repro.train.perlayer``.

The global train step (``train/step.py``) holds the whole model's
gradients before one ``optimizer.update``, so its peak memory carries a
term of the size of the trainable parameters. This step removes it:

  1. **Forward once**, without autograd, saving only each layer's input
     (``lm.forward_saving_boundaries``).
  2. **Norm sweep** (top layer to bottom): re-run one layer's forward and
     backward at a time from its saved input, reduce its gradients to a
     squared norm at once, and carry only the input cotangent down. This
     gives the exact global gradient norm the clip needs before any
     update, for one extra backward recompute.
  3. **Update sweep** (top to bottom again): re-run each layer's backward
     and apply that layer's optimizer update at once, through the
     per-layer slice API (``Optimizer.update_slice``; under ``fused_opt``
     the 8-bit optimizer's ``update_group_fused``, one launch of the
     ``adam8bit`` kernel for all of the layer's slices; GaLore-AdamW,
     which has no kernel, through ``update_slice``), before the next
     layer's gradients exist. The head leaves, the deferred leaves (below)
     and the embedding are each one such group too.

The update order is head → layers (top to bottom) → embedding. No
layer's update feeds another's gradient within the step, so for the Adam
family this is value-identical to the global step: checkpoints keep the
same trees, only the order in which their leaves are written differs.

Where eager PyTorch differs from the reference's jitted scan:

* Each layer's backward is ``torch.autograd.grad`` on a graph of that one
  layer: its saved input with ``requires_grad``, plus detached views of
  its parameter slices. No graph outlives its layer.
* The updates write the stacked parameter leaves and the optimizer state
  **in place**, slice by slice (the kernel writes them directly), which
  keeps the memory at one layer: the step returns the params and state
  it was given, updated. Every backward still sees pre-step values: a
  layer's gradients and input cotangent exist before its update, and no
  group reads another group's updated values, except the tied embedding's
  head cotangent, which reads the pre-step ``ln_f``: it is computed from a
  copy taken before the head update.
* The non-finite gate reads ``isfinite(loss) & isfinite(gnorm)`` on the
  host once, after the norm sweep (one scalar sync per step). If it is
  false the update sweep is skipped: params, state and step counter stay
  pre-step, bit for bit, and ``nonfinite`` is 1.0, as the reference's
  end-of-step select gives. The update sweep recomputes the same
  deterministic gradients, so finite norms mean finite gradients.
* ``layer_timing`` records a CUDA event between layer updates on the card
  (a host clock on the CPU) and reads them after the sweep's last
  launch, into ``train.perlayer.layer_update_ms``: no sync inside the
  sweep.

Leaves whose optimizer state cannot be sliced along the layer axis
(``stack_state`` returns None: 8-bit blocks straddling layer boundaries,
``mlp/down/v`` of llama_1b) accumulate their stacked gradient in f32
through the sweep and are updated once at the end, from their pre-step
value, exactly like global mode.

Tied embeddings: the head's backward treats the embedding as a constant,
so only the boundary cotangent travels down the sweep; the embedding's
head cotangent is recomputed at the embedding step of each pass.

``grad_accum > 1`` is the in-sweep microbatch accumulator: the forward
saves boundaries per microbatch, and at each layer the sweep re-runs the
layer's backward once per microbatch and sums the layer's gradients in
f32 (divided by the count), so the gradients held stay one layer's.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import (remat_wrap, tree_leaves, tree_map,
                                       unstack)
from repro_torch.models.registry import ModelApi
from repro_torch.obs import metrics as obs_metrics
from repro_torch.optim.optimizers import Optimizer
from repro_torch.train.step import check_trainable, cross_entropy

_SLICE_API = ("prepare", "update_slice", "leaf_state", "with_leaf_state",
              "stack_state", "unstack_state", "finish")


def _sq(grads):
    """Sum of the squares of ``grads`` in f32, leaf by leaf in order."""
    return sum(torch.sum(torch.square(g.float())) for g in grads)


def _grads(fn, tree, args, ct):
    """Gradients of ``fn(tree, *args)`` with cotangent ``ct``, on a graph
    of its own: (leaf grads of ``tree`` in sorted-path order, grads of
    ``args``, the output detached). The inputs are left untouched (the
    graph runs on detached aliases of them)."""
    live = tree_map(lambda t: t.detach().requires_grad_(True), tree)
    leaves = [t for _, t in tree_leaves(live)]
    live_args = [a.detach().requires_grad_(True) for a in args]
    with torch.enable_grad():
        out = fn(live, *live_args)
    gs = torch.autograd.grad(out, leaves + live_args, ct)
    return list(gs[:len(leaves)]), list(gs[len(leaves):]), out.detach()


def _write(dst, src):
    """Put ``src`` into ``dst``'s storage, unless an in-place update
    already did."""
    if src is not dst:
        dst.copy_(src)


def make_perlayer_train_step(cfg: ModelConfig, api: ModelApi,
                             optimizer: Optimizer, *, remat: str = "none",
                             grad_accum: int = 1, aux_coef: float = 0.01,
                             fused_opt: Optional[bool] = None,
                             grad_specs=None,
                             layer_timing: Optional[
                                 obs_metrics.Registry] = None):
    """train_step(params, opt_state, consts, batch) -> (params, opt_state,
    metrics) with per-layer in-sweep updates. The params and the state's
    leaves are updated in place and returned.

    ``fused_opt`` routes the updates through the optimizer's kernel
    dispatch when it has one (the ``adam8bit`` kernel): a group at a time
    through ``update_group_fused``, else leaf by leaf through
    ``update_slice_fused``; it defaults to ``cfg.param.exec_mode ==
    "fused"``, so exec_mode "sparse" takes the plain optimizer slice, as
    the reference's sweep does.
    ``layer_timing`` (a registry, or None = off) records per-layer update
    times into ``train.perlayer.layer_update_ms``. ``grad_specs`` (fsdp)
    is not ported (ROADMAP queue A item 10) and raises."""
    plapi = api.perlayer
    if plapi is None:
        raise ValueError(f"update_mode='per_layer' needs the per-layer "
                         f"model API; family {cfg.family!r} does not "
                         "expose one")
    for fn in _SLICE_API:
        if getattr(optimizer, fn) is None:
            raise ValueError(f"optimizer lacks the per-layer slice API "
                             f"({fn}); update_mode='per_layer' supports "
                             "adamw, adam8bit and galore_adamw")
    if grad_specs is not None:
        raise NotImplementedError(
            "grad_specs (fsdp gradient placement) is not ported yet "
            "(ROADMAP queue A item 10: distribution); the port trains on "
            "one card")
    check_trainable(cfg)
    if fused_opt is None:
        fused_opt = cfg.param.exec_mode == "fused"
    upd = optimizer.update_slice
    group_upd = None
    if fused_opt and optimizer.update_slice_fused is not None:
        upd = optimizer.update_slice_fused
        group_upd = optimizer.update_group_fused
    tied = cfg.tie_embeddings
    n_mb = grad_accum
    layer_fn = remat_wrap(lambda p, c, x: plapi.period(cfg, p, c, x)[0],
                          remat)

    hist = None
    if layer_timing is not None:
        hist = layer_timing.histogram(
            "train.perlayer.layer_update_ms",
            buckets=obs_metrics.ms_buckets(),
            help="wall time between consecutive in-sweep layer updates")

    def update_leaf(ctx, ls, p, g, full_ndim=None):
        """One leaf (or layer slice) update through the dispatch, written
        into ``p`` and its state ``ls``'s tensors."""
        new_p, new_ls = upd(ctx, p, g, ls, full_ndim=full_ndim)
        _write(p, new_p)
        tree_map(_write, ls, new_ls)

    def update_group(ctx, items):
        """A group of (p, g, ls, full_ndim) updates: one kernel launch
        under ``group_upd``, else leaf by leaf."""
        if group_upd is not None:
            group_upd(ctx, items)
            return
        for p, g, ls, nd in items:
            update_leaf(ctx, ls, p, g, full_ndim=nd)

    def layer_grads(p_l, c_l, x_l, dh):
        """One layer's param grads (sorted-leaf order; the f32 mean over
        microbatches when n_mb > 1) and its input cotangents."""
        if n_mb == 1:
            gp, (dx,), _ = _grads(lambda p, x: layer_fn(p, c_l, x), p_l,
                                  [x_l[0]], dh[0])
            return gp, [dx]
        acc, dxs = None, []
        for x_m, dh_m in zip(x_l, dh):
            gp, (dx,), _ = _grads(lambda p, x: layer_fn(p, c_l, x), p_l,
                                  [x_m], dh_m)
            gp = [g.float() for g in gp]
            acc = gp if acc is None else [a + g for a, g in zip(acc, gp)]
            dxs.append(dx)
        return [a / n_mb for a in acc], dxs

    def train_step(params, opt_state, consts, batch):
        if "dense_layers" in params:
            raise NotImplementedError(
                "the MoE dense-layer prefix of the sweep is not ported yet "
                "(ROADMAP queue A item 9: the other model families)")
        chaos_scale = None
        if "chaos_scale" in batch:
            chaos_scale = torch.mean(batch["chaos_scale"].float())
        if n_mb == 1:
            mbs = [batch]
        else:
            if any(v.shape[0] % n_mb for v in batch.values()
                   if v.dim() > 0):
                raise ValueError(f"grad_accum={n_mb} does not divide the "
                                 "batch")
            mbs = [{k: (v.chunk(n_mb, dim=0)[i] if v.dim() > 0 else v)
                    for k, v in batch.items()} for i in range(n_mb)]

        # ---- forward, saving per-layer boundaries (no autograd) --------
        bnds = [plapi.forward_boundaries(cfg, params, consts, mb)
                for mb in mbs]
        toks = [mb["tokens"] for mb in mbs]
        patches = [mb.get("patches") for mb in mbs]
        h_tops = [b["h_top"] for b in bnds]
        n_layers = len(bnds[0]["xs"])
        xs = [[b["xs"][i] for b in bnds] for i in range(n_layers)]
        aux_total = sum(b["aux"].sum() for b in bnds)
        if n_mb > 1:
            aux_total = aux_total / n_mb
        device = h_tops[0].device
        one = torch.ones((), dtype=torch.float32, device=device)
        emb0 = params["embed"] if tied else None
        hp = {"ln_f": params["ln_f"]}
        if not tied:
            hp["lm_head"] = params["lm_head"]
        head_keys = sorted(hp)

        def head_ce(hp_, emb, h_top, tokens):
            full = dict(hp_)
            if tied:
                full["embed"] = emb
            logits = plapi.head(cfg, full, h_top)
            ce = cross_entropy(logits[:, :-1], tokens[:, 1:], cfg.vocab_size)
            return ce if chaos_scale is None else ce * chaos_scale

        def head_grads():
            """(head leaf grads in sorted order, boundary cotangents, ce)."""
            acc, dhs, ce_sum = None, [], 0.0
            for h_m, t_m in zip(h_tops, toks):
                g, (dh,), ce_m = _grads(
                    lambda hp_, h_: head_ce(hp_, emb0, h_, t_m), hp, [h_m],
                    one)
                if n_mb == 1:
                    return g, [dh], ce_m
                g = [x.float() for x in g]
                acc = g if acc is None else [a + x for a, x in zip(acc, g)]
                dhs.append(dh)
                ce_sum = ce_sum + ce_m
            return [a / n_mb for a in acc], dhs, ce_sum / n_mb

        def mb_mean(grad_of):
            """``grad_of(i)`` for the one microbatch, or the f32 mean over
            microbatches."""
            if n_mb == 1:
                return grad_of(0)
            acc = None
            for i in range(n_mb):
                g = grad_of(i).float()
                acc = g if acc is None else acc + g
            return acc / n_mb

        def embed_grad(dhs):
            return mb_mean(lambda i: _grads(
                lambda ep: plapi.embed(cfg, ep, toks[i], patches[i]),
                {"embed": params["embed"]}, [], dhs[i])[0][0])

        def head_embed_cotangent(ln_f):
            hp_c = {"ln_f": ln_f}
            return mb_mean(lambda i: _grads(
                lambda ep: head_ce(hp_c, ep["embed"], h_tops[i], toks[i]),
                {"embed": params["embed"]}, [], one)[0][0])

        def embed_total(dhs, ln_f):
            d = embed_grad(dhs)
            if tied:
                d = d.float() + head_embed_cotangent(ln_f)
            return d

        p_stack = params["layers"]
        paths = [p for p, _ in tree_leaves(p_stack)]
        leaves = [t for _, t in tree_leaves(p_stack)]
        p_layers = unstack(p_stack, n_layers)
        c_layers = unstack(consts.get("layers", {}), n_layers)

        # ---- pass 1: the exact global grad norm (norm sweep) -----------
        d_head, dhs, ce = head_grads()
        loss = ce + aux_coef * aux_total
        total_sq = _sq(d_head)
        del d_head
        acc = 0.0
        for i in reversed(range(n_layers)):
            gp, dhs = layer_grads(p_layers[i], c_layers[i], xs[i], dhs)
            acc = acc + _sq(gp)
        total_sq = total_sq + acc
        total_sq = total_sq + _sq([embed_total(dhs, params["ln_f"])])
        gnorm = torch.sqrt(total_sq)
        ctx, stats = optimizer.prepare(opt_state, gnorm)
        good = torch.isfinite(loss) & torch.isfinite(gnorm)
        metrics = {"loss": loss, "ce": ce, "aux": aux_total, **stats,
                   "nonfinite": 1.0 - good.float()}
        if not bool(good):
            # skip the update sweep: everything stays pre-step
            return params, opt_state, metrics

        # ---- pass 2: the update sweep (one layer's grads at a time) ----
        state = opt_state
        stamps = []

        def stamp():
            if hist is None:
                return
            if device.type == "cuda":
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                stamps.append(ev)
            else:
                stamps.append(time.perf_counter_ns())

        stamp()
        ln_f0 = params["ln_f"].clone() if tied else None
        d_head, dhs, _ = head_grads()
        update_group(ctx, [(params[key], g, optimizer.leaf_state(
            state, (key,)), None) for key, g in zip(head_keys, d_head)])
        del d_head

        stacked, deferred = {}, {}
        for path, leaf in zip(paths, leaves):
            ls = optimizer.leaf_state(state, ("layers",) +
                                      tuple(path.split("/")))
            st = optimizer.stack_state(ls, leaf, n_layers)
            if st is None:
                deferred[path] = torch.zeros(leaf.shape, dtype=torch.float32,
                                             device=leaf.device)
            else:
                stacked[path] = st
        for i in reversed(range(n_layers)):
            gp, dhs = layer_grads(p_layers[i], c_layers[i], xs[i], dhs)
            items = []
            for path, leaf, g in zip(paths, leaves, gp):
                if path in deferred:
                    deferred[path][i] = g
                    continue
                ls_i = tree_map(lambda t: t[i], stacked[path])
                items.append((leaf[i], g, ls_i, leaf.dim()))
            update_group(ctx, items)
            del gp, items
            stamp()
        update_group(ctx, [
            (leaf, deferred[path],
             optimizer.leaf_state(state, ("layers",) + tuple(path.split("/"))),
             None)
            for path, leaf in zip(paths, leaves) if path in deferred])
        deferred.clear()

        d_embed = embed_total(dhs, ln_f0)
        update_group(ctx, [(params["embed"], d_embed,
                            optimizer.leaf_state(state, ("embed",)), None)])
        del d_embed
        state = optimizer.finish(state, ctx)

        if hist is not None:
            if device.type == "cuda":
                stamps[-1].synchronize()
                ms = [a.elapsed_time(b) for a, b in zip(stamps, stamps[1:])]
            else:
                ms = [(b - a) / 1e6 for a, b in zip(stamps, stamps[1:])]
            for t in ms:
                hist.observe(t)
        return params, state, metrics

    return train_step
