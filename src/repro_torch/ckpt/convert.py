"""Load the reference's numpy trees onto the port's tensors.

The port's params/consts/optimizer state are nested dicts laid out as the
reference's pytrees, so a leaf's ``/``-joined path (the key
``repro.ckpt.checkpoint`` writes into ``arrays.npz``) names the same leaf
on both sides. bf16 leaves travel as uint16 bit-views (the checkpoint's
convention; no parameter of the port is a uint16) and are viewed back as
bf16 here. The port's :class:`repro_torch.ckpt.checkpoint.CheckpointManager`
is the other route: it restores the reference's checkpoints directly.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.device import resolve

_SEP = "/"


def _to_tensor(arr, device) -> torch.Tensor:
    a = np.array(arr)                     # a writable copy
    if str(a.dtype) == "bfloat16":        # ml_dtypes' bf16 from a jax array
        a = a.view(np.uint16)
    t = torch.from_numpy(a)
    if a.dtype == np.uint16:
        t = t.view(torch.bfloat16)
    return t.to(device)


def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, leaf in flat.items():
        node = out
        parts = key.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def _is_flat(tree) -> bool:
    return isinstance(tree, Mapping) and any(
        _SEP in k for k in tree) and not any(
        isinstance(v, Mapping) for v in tree.values())


def _convert(tree, device):
    if isinstance(tree, Mapping):
        if _is_flat(tree):
            tree = _nest(tree)
        return {str(k): _convert(v, device) for k, v in tree.items()}
    return _to_tensor(tree, device)


def from_jax_numpy(params, consts, device="cuda"):
    """(params, consts) as the port's tensors on ``device``, from the
    reference's trees as numpy arrays — nested dicts (``np.asarray`` of
    each leaf) or flat ``{"a/b/c": array}`` dicts as the reference's
    checkpoint stores them."""
    device = resolve(device)
    return _convert(params, device), _convert(consts, device)


def opt_state_from_jax_numpy(opt_state, device="cuda"):
    """The reference's optimizer state (numpy arrays, nested or flat) as
    the port's, which keeps the same trees: AdamW's ``{"mu", "nu",
    "step"}`` with f32 moments mirroring the params (ReLoRA's W0
    included), 8-bit AdamW's ``{"codes": int8, "scales": f32}`` per
    moment and leaf, GaLore-AdamW's ``{"leaves": {... {"P", "mu", "nu"}
    or {"mu", "nu"}}, "step"}``, and an int32 scalar step. Every dtype
    carries over as it is, int8 codes bit for bit."""
    return _convert(opt_state, resolve(device))
