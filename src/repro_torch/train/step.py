"""Train, eval and serve step builders, ported from ``repro.train.step``:
the cross-entropy loss, the train step (grad accumulation, AdamW, the
non-finite gate), the eval step, one batched decode step and one batched
(suffix-)prefill, each of the last two ending in a greedy argmax over the
real vocabulary in f32; on a mesh, the global step over shards
(:class:`MeshPlan`) and the int8-compressed data-parallel step over the
pod axis (:func:`make_compressed_dp_step`).

The reference's steps are jitted pure functions; here each step runs
eagerly and stays functional in the same way: ``train_step`` returns new
params and optimizer state and leaves its inputs untouched, so a
non-finite step hands back the old state bit for bit. Nothing in a step
waits on the device; the caller syncs when it reads a metric.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.dist import compat
from repro_torch.dist import sharding as dist_sharding
from repro_torch.dist.compression import wire_bytes
from repro_torch.models.common import tree_leaves as tree_leaves_with_paths
from repro_torch.models.common import tree_map
from repro_torch.models.registry import ModelApi
from repro_torch.optim.optimizers import Optimizer, tree_leaves


def cross_entropy(logits, labels, vocab_size: int):
    """Mean next-token CE in f32; a padded vocab tail is masked out with
    -1e30, as the reference does."""
    lf = logits.float()
    if lf.shape[-1] > vocab_size:
        keep = torch.arange(lf.shape[-1], device=lf.device) < vocab_size
        penalty = torch.where(keep, 0.0, -1e30)
        lf = lf + penalty
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def make_loss_fn(cfg: ModelConfig, api: ModelApi, remat: str = "none",
                 aux_coef: float = 0.01):
    """loss_fn(params, consts, batch) -> (loss, {"ce", "aux"})."""
    def loss_fn(params, consts, batch):
        logits, aux = api.apply(cfg, params, consts, batch, remat=remat)
        toks = batch["tokens"]
        ce = cross_entropy(logits[:, :-1], toks[:, 1:], cfg.vocab_size)
        aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
        loss = ce + aux_coef * aux
        if "chaos_scale" in batch:
            # fault injection: a NaN scale poisons the loss through the
            # real backward, so the gate sees genuine NaN gradients
            loss = loss * torch.mean(batch["chaos_scale"].float())
        return loss, {"ce": ce, "aux": aux}
    return loss_fn


def nonfinite_gate(loss, grads, new_state, old_state):
    """Skip-step gate: when the loss or any gradient is non-finite, every
    leaf of ``new_state`` (a tuple of trees, e.g. (params, opt_state)) is
    replaced by its ``old_state`` counterpart; when all is finite the new
    leaves come through unchanged (``torch.where`` on a true predicate
    selects them bit for bit). The selection is written into the new
    leaves (``out=``), so the step holds the old and the new state and no
    third copy, as the reference's one fused select does; the old leaves
    are never written. Returns (gated_state, nonfinite) with
    ``nonfinite`` a 0/1 f32 metric. No host sync."""
    good = torch.isfinite(loss)
    for g in tree_leaves(grads):
        if g.is_floating_point():
            good = good & torch.isfinite(g).all()
    gated = tuple(tree_map(lambda n, o: torch.where(good, n, o, out=n),
                           new, old)
                  for new, old in zip(new_state, old_state))
    return gated, 1.0 - good.float()


def _value_and_grad(loss_fn, params, consts, batch):
    """(loss, parts, grads) with grads shaped like ``params``; the
    params themselves are left untouched (the backward runs on detached
    aliases of them)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, parts = loss_fn(live, consts, batch)
    leaves = tree_leaves(live)
    grads = iter(torch.autograd.grad(loss, leaves))
    order = {id(p): next(grads) for p in leaves}
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            tree_map(lambda p: order[id(p)], live))


def check_trainable(cfg: ModelConfig) -> None:
    """Refuse the SLTrain exec mode no train step runs: "quant", as the
    reference does."""
    if cfg.param.mode == "sltrain" and cfg.param.exec_mode == "quant":
        raise ValueError(
            "exec_mode='quant' is serve-only (int8 codes are not trainable) "
            "— train with dense, fused or sparse")


def _accumulated(loss_fn, params, consts, batch, grad_accum: int):
    """(loss, parts, grads) of ``batch``; with ``grad_accum`` > 1 the batch
    is split into microbatches run one after the other, their grads summed
    in f32 and averaged, as the reference's microbatch scan does."""
    if grad_accum == 1:
        return _value_and_grad(loss_fn, params, consts, batch)
    grads = tree_map(lambda p: torch.zeros(
        p.shape, dtype=torch.float32, device=p.device), params)
    loss, parts = 0.0, {"ce": 0.0, "aux": 0.0}
    if any(v.shape[0] % grad_accum for v in batch.values()):
        raise ValueError(f"grad_accum={grad_accum} does not divide "
                         "the batch")
    micro = {k: v.chunk(grad_accum, dim=0) for k, v in batch.items()}
    for i in range(grad_accum):
        mb = {k: v[i] for k, v in micro.items()}
        l, pt, g = _value_and_grad(loss_fn, params, consts, mb)
        grads = tree_map(lambda a, b: a + b.float(), grads, g)
        loss = loss + l
        parts = {k: parts[k] + pt[k] for k in parts}
    grads = tree_map(lambda g: g / grad_accum, grads)
    return (loss / grad_accum, {k: v / grad_accum for k, v in parts.items()},
            grads)


def make_train_step(cfg: ModelConfig, api: ModelApi, optimizer: Optimizer,
                    *, remat: str = "none", grad_accum: int = 1,
                    aux_coef: float = 0.01, grad_specs=None,
                    state_specs=None, obs=None):
    """train_step(params, opt_state, consts, batch) -> (params, opt_state,
    metrics). With ``grad_accum`` > 1 the global batch is split into
    microbatches run one after the other, their grads summed in f32 and
    averaged, as the reference's microbatch scan does. ``remat`` is the
    layers' rematerialization policy (``models.common.remat_wrap``).

    ``grad_specs`` (the param spec tree of ``dist.sharding.param_specs``)
    with ``state_specs`` (``opt_state_specs``) makes it the step on the
    ambient mesh (:class:`MeshPlan`; the caller runs it under
    ``dist.sharding.use_mesh``): params and state are this rank's shards,
    the batch this rank's rows, and the gradients are summed over the
    batch ranks into the specs' layout (reduce-scattered under fsdp)
    before the update, as the reference pins them; ``obs`` counts the
    modelled gradient-reduction bytes there."""
    check_trainable(cfg)
    loss_fn = make_loss_fn(cfg, api, remat, aux_coef)
    if grad_specs is not None:
        mesh = dist_sharding.ambient_mesh()
        if mesh is None or state_specs is None:
            raise ValueError("grad_specs: build the step under "
                             "dist.sharding.use_mesh(mesh), with "
                             "state_specs")
        return _mesh_train_step(MeshPlan(mesh, grad_specs, state_specs, obs),
                                optimizer, loss_fn, grad_accum)

    def train_step(params, opt_state, consts, batch):
        loss, parts, grads = _accumulated(loss_fn, params, consts, batch,
                                          grad_accum)
        new_params, new_opt, stats = optimizer.update(grads, opt_state,
                                                      params)
        (new_params, new_opt), nonfinite = nonfinite_gate(
            loss, grads, (new_params, new_opt), (params, opt_state))
        metrics = {"loss": loss, **parts, **stats, "nonfinite": nonfinite}
        return new_params, new_opt, metrics

    return train_step


# ---------------------------------------------------------------------------
# Training on a mesh (repro_torch.dist)
# ---------------------------------------------------------------------------

class MeshPlan:
    """A train step's placement on a mesh: ``p_specs``, the param spec
    tree of ``dist.sharding.param_specs`` (the reference's
    ``grad_specs``), and ``s_specs``, the optimizer state's
    (``opt_state_specs``).

    Each rank holds its shards of the params and of the optimizer state.
    A step gathers the full params, runs the forward and backward on the
    rank's local batch (the linears' tensor-parallel islands inside),
    turns each gradient into the rank's shard of the global-batch gradient
    (:meth:`reduce`: summed over the batch ranks, reduce-scattered where
    fsdp splits the leaf over one, divided by their count, since a rank's
    loss is the mean of its local batch), and updates its shards
    (:meth:`item`, :meth:`update`): the reference's global-view step,
    partitioned."""

    def __init__(self, mesh, p_specs, s_specs, obs=None):
        self.mesh, self.p_specs, self.s_specs = mesh, p_specs, s_specs
        self._wire = None if obs is None else obs.counter(
            "dist.collective_bytes",
            help="modeled per-participant wire bytes of gradient "
                 "reductions (dist.compression.wire_bytes), per step")

    def gather(self, params):
        return dist_sharding.gather(params, self.mesh, self.p_specs)

    def write_back(self, shards, full):
        """Copy each rank's shard of the updated full leaves into its
        shard tensors (a leaf no spec splits is its shard already)."""
        tree_map(lambda sh, f, sp: sh if sh is f else sh.copy_(
            dist_sharding.place_leaf(f, sp, self.mesh)), shards, full,
            self.p_specs)

    def reduce(self, g, spec):
        """This rank's shard of the global-batch gradient
        (``dist.sharding.reduce_grad``), its modelled wire bytes counted
        on ``dist.collective_bytes{compressed=false}``: a ring all-reduce
        of its f32 model chunk over the batch ranks, half that where fsdp
        reduce-scatters."""
        out = dist_sharding.reduce_grad(g, spec, self.mesh)
        bt = dist_sharding.batch_size_axes(self.mesh)
        if self._wire is not None and bt:
            sc = self.mesh.axis_size(tuple(a for e in spec for a in (e or ())
                                           if a in bt))
            self._wire.labels(compressed="false").inc(wire_bytes(
                out.numel() * sc, compressed=False,
                n_participants=self.mesh.axis_size(bt)) / (2 if sc > 1
                                                            else 1))
        return out

    def batch_mean(self, t):
        """A scalar of the local batch → its global-batch mean."""
        bt = dist_sharding.batch_size_axes(self.mesh)
        if not bt:
            return t
        out = torch.as_tensor(t).detach().float().reshape(1).clone()
        compat.all_reduce(out, self.mesh.group(bt))
        return out[0] / self.mesh.axis_size(bt)

    def sq(self, grads, specs):
        """This rank's part of Σ g² over the shards ``grads`` (each
        counted by its first replica); :meth:`world_sum` totals it."""
        total = 0.0
        for g, s in zip(grads, specs):
            if dist_sharding.is_first_replica(s, self.mesh):
                total = total + torch.sum(torch.square(g.float()))
        return total

    def world_sum(self, t, device):
        out = torch.as_tensor(t, dtype=torch.float32,
                              device=device).reshape(1).clone()
        group = self.mesh.group(self.mesh.axis_names)
        if group is not None:
            compat.all_reduce(out, group)
        return out[0]

    def item(self, p, g, spec, ls, s_spec, *, ndim=None, layer=None,
             n_layers: int = 1, reduced: bool = False):
        """One update: the full working leaf ``p`` (or layer ``layer`` of
        a stacked leaf of ``n_layers``; ``spec``, ``ls``, ``s_spec`` then
        the whole leaf's), its rank-local gradient ``g`` (with
        ``reduced``, already this rank's shard of the global gradient),
        this rank's state ``ls``; ``ndim`` is the whole leaf's rank, which
        weight decay reads (default: ``p``'s). AdamW (moments mirroring the
        shard) updates the shard's region of ``p`` from the reduced
        gradient. 8-bit AdamW
        keeps the reference's state layout, blocks of the whole flat leaf
        (replicated, or split over the fsdp axes by rows): it updates the
        elements of ``p`` its rows cover, from the full reduced gradient
        (the gradient moved to the state's layout)."""
        sub = spec if layer is None else dist_sharding.P(*spec[1:])
        if ndim is None:
            ndim = p.dim()
        if not reduced:
            g = self.reduce(g, sub)
        if not isinstance(ls["mu"], dict):
            region = p[dist_sharding.shard_slices(p.shape, sub, self.mesh)]
            return ("shard", region, g, ls if layer is None
                    else tree_map(lambda t: t[layer], ls), ndim)
        q = ls["mu"]["codes"].shape[-1]
        entry = s_spec["mu"]["codes"][0] if len(s_spec["mu"]["codes"]) \
            else None
        per = p.numel()
        if layer is None and entry and tuple(sub) == (entry,) + (None,) * (
                p.dim() - 1) and (per // self.mesh.axis_size(entry)) % q == 0:
            # the state's rows are exactly this rank's dim-0 shard (fsdp on
            # an unstacked leaf, block-aligned): update it in place from
            # the reduced shard, nothing to gather or to share
            region = p[dist_sharding.shard_slices(p.shape, sub, self.mesh)]
            return ("flat", region, g, ls, ndim, q, -(-region.numel() // q),
                    None, 0)
        return ("flat", p, dist_sharding.gather_leaf(g, sub, self.mesh), ls,
                ndim, q, -(-per * n_layers // q), entry,
                0 if layer is None else layer * per // q)

    def _rows(self, n_blocks, entry, coords=None):
        if not entry or self.mesh.axis_size(entry) <= 1:
            return 0, n_blocks
        sl = dist_sharding.shard_slices((n_blocks,), (entry,), self.mesh,
                                        coords)[0]
        return sl.start, sl.stop

    def update(self, optimizer, ctx, items, *, fused: bool):
        """Apply ``items`` (:meth:`item`) in place. The 8-bit ranges go
        through the ``adam8bit`` kernel in one launch under ``fused``;
        the ranges each rank updated are then all-gathered over the axes
        that split the state, so every rank holds the whole updated
        leaf."""
        flat, spread = [], []
        for it in items:
            if it[0] == "shard":
                _, region, g, ls, nd = it
                new_p, new_ls = optimizer.update_slice(ctx, region, g, ls,
                                                       full_ndim=nd)
                region.copy_(new_p)
                tree_map(lambda d, s: d.copy_(s), ls, new_ls)
                continue
            _, p, g, ls, nd, q, n_blocks, entry, off = it
            if not p.is_contiguous():
                raise ValueError("an 8-bit update's leaf must be contiguous: "
                                 "its flat ranges are updated in place")
            span = self._span(p, q, n_blocks, entry, off, None)
            if span is not None:
                (lo, hi), (r0, r1) = span
                flat.append((p.reshape(-1)[lo:hi], g.reshape(-1)[lo:hi],
                             tree_map(lambda t: t[r0:r1], ls), nd))
            if entry and self.mesh.axis_size(entry) > 1:
                spread.append((p, q, n_blocks, entry, off))
        if fused and flat and optimizer.update_group_fused is not None:
            optimizer.update_group_fused(ctx, flat)
        else:
            for p, g, ls, nd in flat:
                new_p, new_ls = optimizer.update_slice(ctx, p, g, ls,
                                                       full_ndim=nd)
                p.copy_(new_p)
                tree_map(lambda d, s: d.copy_(s), ls, new_ls)
        for p, q, n_blocks, entry, off in spread:
            self._share(p, q, n_blocks, entry, off)

    def _span(self, p, q, n_blocks, entry, off, coords):
        """((lo, hi) elements of ``p``, (r0, r1) rows of the holder's
        state) that the rank at ``coords`` updates, or None."""
        b0, b1 = self._rows(n_blocks, entry, coords)
        n_p = -(-p.numel() // q)
        r0, r1 = max(b0, off), min(b1, off + n_p)
        if r1 <= r0:
            return None
        return ((r0 - off) * q, min((r1 - off) * q, p.numel())), \
            (r0 - b0, r1 - b0)

    def _share(self, p, q, n_blocks, entry, off):
        members = self.mesh.members(entry)
        spans = [self._span(p, q, n_blocks, entry, off, c) for c in members]
        spans = [s[0] if s else (0, 0) for s in spans]
        width = max(hi - lo for lo, hi in spans)
        if width == 0:
            return
        flat = p.reshape(-1)
        lo, hi = spans[members.index(self.mesh.coords)]
        buf = torch.zeros(width, dtype=p.dtype, device=p.device)
        buf[:hi - lo] = flat[lo:hi]
        out = torch.empty(width * len(members), dtype=p.dtype,
                          device=p.device)
        compat.all_gather_into_tensor(out, buf, self.mesh.group(entry))
        for i, (lo, hi) in enumerate(spans):
            flat[lo:hi] = out[i * width:i * width + hi - lo]


def _mesh_train_step(plan: MeshPlan, optimizer: Optimizer, loss_fn,
                     grad_accum: int):
    """The global step on ``plan``'s mesh (``make_train_step`` with
    ``grad_specs``): params and state are this rank's shards, the batch
    its local rows; the update runs the optimizer's plain update
    (``update_slice``), as the one-card global step does. The non-finite
    gate is read on the host before the update (one sync, as the
    per-layer step reads it), so a skipped step leaves everything
    pre-step; a finite one updates the shards in place, one leaf at a
    time (the per-layer step's memory discipline), and returns them."""
    def train_step(params, opt_state, consts, batch):
        full = plan.gather(params)
        loss, parts, grads = _accumulated(loss_fn, full, consts, batch,
                                          grad_accum)
        loss = plan.batch_mean(loss)
        parts = {k: plan.batch_mean(v) for k, v in parts.items()}
        specs = [s for _, s in tree_leaves_with_paths(plan.p_specs)]
        shards = [plan.reduce(g, s) for g, s in zip(tree_leaves(grads),
                                                    specs)]
        del grads
        gnorm = torch.sqrt(plan.world_sum(plan.sq(shards, specs),
                                          loss.device))
        ctx, stats = optimizer.prepare(opt_state, gnorm)
        good = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
        metrics = {"loss": loss, **parts, **stats,
                   "nonfinite": torch.tensor(0.0 if good else 1.0)}
        if not good:
            return params, opt_state, metrics
        with torch.no_grad():
            for (path, p), g, spec in zip(tree_leaves_with_paths(full),
                                          shards, specs):
                keys = tuple(path.split("/"))
                plan.update(optimizer, ctx, [plan.item(
                    p, g, spec, optimizer.leaf_state(opt_state, keys),
                    optimizer.leaf_state(plan.s_specs, keys),
                    reduced=True)], fused=False)
            plan.write_back(params, full)
        return params, optimizer.finish(opt_state, ctx), metrics

    return train_step


def make_eval_step(cfg: ModelConfig, api: ModelApi):
    """eval_step(params, consts, batch) -> {"loss", "ppl", "ce", "aux"}."""
    loss_fn = make_loss_fn(cfg, api)

    def eval_step(params, consts, batch):
        with torch.no_grad():
            loss, parts = loss_fn(params, consts, batch)
        return {"loss": loss, "ppl": torch.exp(parts["ce"]), **parts}
    return eval_step


def _greedy(logits, vocab_size: int):
    return torch.argmax(logits[..., :vocab_size].float(), dim=-1).to(
        torch.int32)


def _on_mesh(layout, tokens):
    """A serving mesh's layout made ambient for one dispatch of
    ``tokens`` (its rows the global batch), as the reference runs a step
    ``with mesh:``; nothing without one."""
    if layout is None:
        return contextlib.nullcontext()
    return dist_sharding.use_mesh(layout.mesh, global_batch=tokens.shape[0],
                                  layout=layout)


def make_serve_step(cfg: ModelConfig, api: ModelApi, layout=None):
    """serve_step(params, consts, tokens, cache, index, block_table=None)
    -> (next_tokens (B, 1) int32, logits, cache). ``index`` is a scalar or
    a (B,) per-slot position vector; ``block_table`` addresses the paged
    pools. With ``layout`` (a serving mesh's
    ``dist.sharding.ServingLayout``: params, consts and cache a rank's,
    ``dist.sharding.serving_state``) every call runs under its mesh."""
    def serve_step(params, consts, tokens, cache, index, block_table=None):
        with _on_mesh(layout, tokens):
            logits, cache = api.decode_step(cfg, params, consts, tokens,
                                            cache, index,
                                            block_table=block_table)
        return _greedy(logits[:, -1], cfg.vocab_size)[:, None], logits, cache
    return serve_step


def make_prefill_step(cfg: ModelConfig, api: ModelApi, layout=None):
    """prefill_step(params, consts, tokens, cache, lengths,
    block_table=None, offsets=None) -> (first_tokens (B, 1) int32, logits,
    cache): a batch of prompts (B, S) runs through one forward that writes
    their K/V, and each row's first output token is sampled from
    logits[s, lengths[s] - 1]. ``offsets`` switches to chunked suffix
    prefill (``lengths`` are then suffix lengths). ``layout`` as
    :func:`make_serve_step`'s."""
    def prefill_step(params, consts, tokens, cache, lengths, block_table=None,
                     offsets=None):
        with _on_mesh(layout, tokens):
            logits, cache = api.prefill_step(cfg, params, consts, tokens,
                                             cache, block_table=block_table,
                                             offsets=offsets)
        rows = torch.arange(tokens.shape[0], device=logits.device)
        last_idx = (lengths.long() - 1).clamp(0, tokens.shape[1] - 1)
        nxt = _greedy(logits[rows, last_idx], cfg.vocab_size)
        return nxt[:, None], logits, cache
    return prefill_step


def make_compressed_dp_step(cfg: ModelConfig, api: ModelApi,
                            optimizer: Optimizer, mesh, *,
                            pod_axis: str = "pod", block: int = 256,
                            aux_coef: float = 0.01, obs=None):
    """The reference's hierarchical data-parallel step with int8 gradient
    compression over the pod axis (the slow cross-pod link): each pod's
    rank computes full-precision grads of its batch rows with replicated
    params, the grads are summed over the pods by
    ``dist.compression.psum_tree`` (int8 codes on the wire, an exact int32
    sum; small and integer leaves exact) and divided by ``n_pods``, the
    loss is averaged over the pods, and every pod applies the same update
    and the same non-finite gate (read on the host before the update, so
    a skipped step leaves everything pre-step; a finite one updates the
    params and state in place, a leaf at a time). ``obs`` counts the
    modelled wire bytes on ``dist.collective_bytes``. Metrics: loss,
    grad_norm, lr, nonfinite, as the reference's."""
    from repro_torch.dist.compression import psum_tree

    check_trainable(cfg)
    loss_fn = make_loss_fn(cfg, api, "none", aux_coef)
    n_pods = mesh.shape[pod_axis]
    group = mesh.group(pod_axis)

    def step(params, opt_state, consts, batch):
        loss, _, grads = _value_and_grad(loss_fn, params, consts, batch)
        grads = psum_tree(grads, group, compress=True, block=block, obs=obs,
                          n_participants=n_pods)
        grads = tree_map(lambda g: g.div_(n_pods), grads)
        if group is not None:
            loss = loss.float().reshape(1).clone()
            compat.all_reduce(loss, group)
            loss = loss[0] / n_pods
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in tree_leaves(grads)))
        ctx, stats = optimizer.prepare(opt_state, gnorm)
        # the summed grads are the same bits on every pod, so is the gate
        good = bool(torch.isfinite(loss) & torch.isfinite(gnorm))
        metrics = {"loss": loss, **stats,
                   "nonfinite": torch.tensor(0.0 if good else 1.0)}
        if not good:
            return params, opt_state, metrics
        with torch.no_grad():
            for (path, p), g in zip(tree_leaves_with_paths(params),
                                    tree_leaves(grads)):
                ls = optimizer.leaf_state(opt_state, tuple(path.split("/")))
                new_p, new_ls = optimizer.update_slice(ctx, p, g, ls)
                p.copy_(new_p)
                tree_map(lambda d, n: d.copy_(n), ls, new_ls)
        return params, optimizer.finish(opt_state, ctx), metrics

    return step
