"""Train, eval and serve step builders, ported from ``repro.train.step``:
the cross-entropy loss, the train step (grad accumulation, AdamW, the
non-finite gate), the eval step, one batched decode step and one batched
(suffix-)prefill, each of the last two ending in a greedy argmax over the
real vocabulary in f32.

The reference's steps are jitted pure functions; here each step runs
eagerly and stays functional in the same way: ``train_step`` returns new
params and optimizer state and leaves its inputs untouched, so a
non-finite step hands back the old state bit for bit. Nothing in a step
waits on the device; the caller syncs when it reads a metric.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
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
    selects them bit for bit). Returns (gated_state, nonfinite) with
    ``nonfinite`` a 0/1 f32 metric. No host sync."""
    good = torch.isfinite(loss)
    for g in tree_leaves(grads):
        if g.is_floating_point():
            good = good & torch.isfinite(g).all()
    gated = tuple(tree_map(lambda n, o: torch.where(good, n, o), new, old)
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


def make_train_step(cfg: ModelConfig, api: ModelApi, optimizer: Optimizer,
                    *, remat: str = "none", grad_accum: int = 1,
                    aux_coef: float = 0.01):
    """train_step(params, opt_state, consts, batch) -> (params, opt_state,
    metrics). With ``grad_accum`` > 1 the global batch is split into
    microbatches run one after the other, their grads summed in f32 and
    averaged, as the reference's microbatch scan does. ``remat`` is the
    layers' rematerialization policy (``models.common.remat_wrap``)."""
    check_trainable(cfg)
    loss_fn = make_loss_fn(cfg, api, remat, aux_coef)

    def train_step(params, opt_state, consts, batch):
        if grad_accum == 1:
            loss, parts, grads = _value_and_grad(loss_fn, params, consts,
                                                 batch)
        else:
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
            loss = loss / grad_accum
            parts = {k: v / grad_accum for k, v in parts.items()}
        new_params, new_opt, stats = optimizer.update(grads, opt_state,
                                                      params)
        (new_params, new_opt), nonfinite = nonfinite_gate(
            loss, grads, (new_params, new_opt), (params, opt_state))
        metrics = {"loss": loss, **parts, **stats, "nonfinite": nonfinite}
        return new_params, new_opt, metrics

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


def make_serve_step(cfg: ModelConfig, api: ModelApi):
    """serve_step(params, consts, tokens, cache, index, block_table=None)
    -> (next_tokens (B, 1) int32, logits, cache). ``index`` is a scalar or
    a (B,) per-slot position vector; ``block_table`` addresses the paged
    pools."""
    def serve_step(params, consts, tokens, cache, index, block_table=None):
        logits, cache = api.decode_step(cfg, params, consts, tokens, cache,
                                        index, block_table=block_table)
        return _greedy(logits[:, -1], cfg.vocab_size)[:, None], logits, cache
    return serve_step


def make_prefill_step(cfg: ModelConfig, api: ModelApi):
    """prefill_step(params, consts, tokens, cache, lengths,
    block_table=None, offsets=None) -> (first_tokens (B, 1) int32, logits,
    cache): a batch of prompts (B, S) runs through one forward that writes
    their K/V, and each row's first output token is sampled from
    logits[s, lengths[s] - 1]. ``offsets`` switches to chunked suffix
    prefill (``lengths`` are then suffix lengths)."""
    def prefill_step(params, consts, tokens, cache, lengths, block_table=None,
                     offsets=None):
        logits, cache = api.prefill_step(cfg, params, consts, tokens, cache,
                                         block_table=block_table,
                                         offsets=offsets)
        rows = torch.arange(tokens.shape[0], device=logits.device)
        last_idx = (lengths.long() - 1).clamp(0, tokens.shape[1] - 1)
        nxt = _greedy(logits[rows, last_idx], cfg.vocab_size)
        return nxt[:, None], logits, cache
    return prefill_step
