"""Shared model building blocks and the parameter Builder, ported from
``repro.models.common``.

Parameters are plain nested dicts of tensors laid out as the reference's
pytrees (stacked layers on a leading axis), so a reference checkpoint maps
onto them leaf for leaf (``ckpt/convert.py``). The Builder walks the same
path strings as the reference's: each SLTrain linear samples its support
from ``seed ^ crc32(path)`` with the numpy sampler, so supports match the
reference bit for bit. Values come from a ``torch.Generator`` and differ
from the reference's ``jax.random`` draws.

:func:`presample` runs a model's build once with a collecting Builder
(nothing is created, no value is drawn), samples every SLTrain linear's
support in a pool of worker processes (``core.support.sample_supports``),
and hands the results to the real build, which draws its values from the
one generator in the same order as a build that samples in place: the
params and consts are the same bits either way.
"""
from __future__ import annotations

import functools
import math
import zlib
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import lowrank, relora, sltrain
from repro_torch.core import support as support_lib

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


def _name_hash(path: str) -> int:
    return zlib.crc32(path.encode()) & 0x7FFFFFFF


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree, prefix: str = ""):
    """(``/``-joined path, leaf) pairs in the reference's flatten order
    (sorted keys at every level): the checkpoint's keys and the order of
    sums over leaves."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k],
                                   f"{prefix}/{k}" if prefix else str(k))
    else:
        yield prefix, tree


class Builder:
    """Creates parameter/const trees at ``path`` on ``device``.

    ``plan`` says where SLTrain linears get their supports: None samples
    each where it is built; a list makes the build a collecting pass (each
    linear appends its (path, ``sltrain.support_spec``) and returns empty
    trees, every tensor is a meta tensor, nothing is drawn); a dict maps
    each linear's path to its pre-sampled support (:func:`presample`)."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator, device,
                 path: str = "", seed: int = 0, plan=None):
        self.cfg = cfg
        self.gen = gen
        self.device = device
        self.path = path
        self.seed = seed
        self.plan = plan
        self.dtype = DTYPES[cfg.dtype]

    def sub(self, name: str) -> "Builder":
        return Builder(self.cfg, self.gen, self.device, f"{self.path}/{name}",
                       self.seed, self.plan)

    @property
    def collecting(self) -> bool:
        return isinstance(self.plan, list)

    def tensor(self, name: str, shape: Tuple[int, ...], init: str = "normal",
               fan_in: Optional[int] = None, dtype=None):
        dtype = dtype or self.dtype
        if self.collecting:
            return torch.empty(shape, dtype=dtype, device="meta")
        if init == "ones":
            return torch.ones(shape, dtype=dtype, device=self.device)
        if init != "normal":
            raise ValueError(init)
        fan = fan_in if fan_in is not None else (
            shape[0] if len(shape) >= 2 else shape[-1])
        t = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return (t * (1.0 / math.sqrt(fan))).to(dtype)

    def linear(self, name: str, d_in: int, d_out: int):
        """(params, consts) of one linear, parameterized as
        ``cfg.param.mode`` says: a full-rank ``w``, low-rank ``B``/``A``,
        ReLoRA's ``W0``/``B``/``A`` or SLTrain factors."""
        pc = self.cfg.param
        b = self.sub(name)
        consts: dict = {}
        # per-matrix effective rank: global rank capped at half the min dim
        r = max(4, min(pc.rank, min(d_in, d_out) // 2))
        if pc.mode == "dense":
            params = {"w": b.tensor("w", (d_in, d_out), "normal",
                                    fan_in=d_in)}
        elif self.collecting:
            if pc.mode == "sltrain":
                self.plan.append((b.path, sltrain.support_spec(
                    d_in, d_out, pc.delta, pc.support_kind,
                    self.seed ^ _name_hash(b.path), pc.exec_mode)))
            params = {}
        elif pc.mode == "lowrank":
            params = lowrank.init_params(self.gen, d_in, d_out, r, b.dtype,
                                         device=self.device)
        elif pc.mode == "relora":
            params = relora.init_params(self.gen, d_in, d_out, r, b.dtype,
                                        device=self.device)
        elif pc.mode == "sltrain":
            params, consts = sltrain.init_params(
                self.gen, d_in, d_out, r, pc.delta, b.dtype,
                pc.support_kind, seed=self.seed ^ _name_hash(b.path),
                exec_mode=pc.exec_mode, device=self.device,
                support=None if self.plan is None else self.plan.pop(b.path))
        else:
            raise ValueError(pc.mode)
        return params, consts


def presample(cfg: ModelConfig, seed: int, build, workers=None):
    """(plan, workers): every SLTrain linear's support that ``build(b)``
    (a model's init body over Builder ``b``) makes, sampled by
    ``support.sample_supports`` with ``workers`` processes (None:
    ``support.default_workers``) and keyed by path, as a Builder's
    ``plan``. (None, 0) when ``cfg`` has no SLTrain linears."""
    if cfg.param.mode != "sltrain":
        return None, 0
    specs: list = []
    build(Builder(cfg, None, torch.device("meta"), seed=seed, plan=specs))
    if not specs:
        return None, 0
    paths, specs = zip(*specs)
    if workers is None:
        workers = support_lib.default_workers(specs)
    return (dict(zip(paths, support_lib.sample_supports(specs, workers))),
            workers)


def apply_linear(cfg: ModelConfig, params, consts, x):
    pc = cfg.param
    if "w" in params:
        return x @ params["w"]
    # per-matrix scale alpha/r_eff (r_eff capped at init)
    scale = pc.alpha / params["B"].shape[-1]
    if pc.mode == "lowrank":
        return lowrank.lr_matmul(x, params, scale)
    if pc.mode == "relora":
        return relora.rl_matmul(x, params, scale)
    if pc.mode == "sltrain":
        return sltrain.sl_matmul(x, params, consts, scale, pc.exec_mode)
    raise ValueError(pc.mode)


def stack_layers(builder: Builder, fn, n: int, name: str = "layer"):
    """Stack per-layer (params, consts) along a new leading axis; ``fn`` is
    called once per layer at path ``{name}{i}``."""
    if n == 0:
        return {}, {}
    ps, cs = zip(*(fn(builder.sub(f"{name}{i}")) for i in range(n)))
    params = tree_map(lambda *xs: torch.stack(xs), *ps) if ps[0] else {}
    consts = tree_map(lambda *xs: torch.stack(xs), *cs) if cs[0] else {}
    return params, consts


def remat_wrap(fn, remat: str):
    """Apply the remat policy ("none" | "full" | "dots_saveable") to a
    layer function: the one owner of the policy names, as the reference's
    ``remat_wrap``, so the train forward (``lm.apply_lm``) and the
    per-layer sweep (``train/perlayer.py``) recompute under the same
    policy. "full" saves nothing inside the layer and recomputes it in
    the backward (``torch.utils.checkpoint``, non-reentrant);
    "dots_saveable" saves the outputs of 2-D matrix products (``aten.mm``,
    ``aten.addmm``) and recomputes the rest, the counterpart of the
    reference's ``checkpoint_dots_with_no_batch_dims``: batched einsums
    and the kernels' calls are recomputed. Recomputation runs the same
    operations on the same inputs, so no value changes."""
    if remat == "none":
        return fn
    if remat not in ("full", "dots_saveable"):
        raise ValueError(f"unknown remat policy {remat!r}: expected none, "
                         "full or dots_saveable")
    from torch.utils import checkpoint as ckpt

    kw = {}
    if remat == "dots_saveable":
        saved = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

        def policy(ctx, op, *args, **kwargs):
            return (ckpt.CheckpointPolicy.MUST_SAVE if op in saved
                    else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, policy)

    def wrapped(*args):
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


def unstack(tree, n: int):
    """The ``n`` per-layer trees of a stacked tree, as views (no copies).
    One ``unbind`` per leaf: its backward stacks the layers' grads in one
    op, where indexing each layer would add a full-size zero grad per
    layer."""
    parts = tree_map(lambda t: t.unbind(0), tree)
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


# ---------------------------------------------------------------------------
# Normalization / activations / rope
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-6):
    """RMS norm computed in f32, returned in x.dtype."""
    xf = x.float()
    n = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (n * weight.float()).to(x.dtype)


def rope(x, pos, theta: float = 10000.0):
    """Rotary embedding, half-split layout (not interleaved). x: (...,
    seq, heads, head_dim); pos: (..., seq)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    ang = pos[..., :, None].float() * freqs[None, :]       # (..., s, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def silu(x):
    return x * torch.sigmoid(x)
