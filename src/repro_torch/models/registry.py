"""Uniform model API, ported from ``repro.models.registry``: the llama
family exposes init / apply / init_cache / decode_step / prefill_step and
the segmented per-layer API, so the engine, the trainers and the tests
stay arch-agnostic. Other families raise until their
slice lands (ROADMAP queue A item 9)."""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class PerLayerApi:
    """The segmented forward the per-layer backward sweep drives
    (``repro_torch.train.perlayer``): one callable per model segment, each
    taking exactly the params it reads, so the sweep can differentiate
    segments in isolation. ``forward_boundaries`` runs the same math as
    ``ModelApi.apply``."""
    forward_boundaries: Callable  # (cfg, params, consts, batch) -> dict
    embed: Callable               # (cfg, {"embed": leaf}, tokens, patches) -> h0
    period: Callable              # (cfg, p_period, c_period, x) -> (x', aux)
    head: Callable                # (cfg, head_params, h_top) -> logits


@dataclass(frozen=True)
class ModelApi:
    init: Callable          # (cfg, seed=0, *, device, workers, obs) -> (params, consts)
    apply: Callable         # (cfg, params, consts, batch, remat) -> (logits, aux)
    init_cache: Callable    # (cfg, batch, max_len, *, paged, ...) -> cache
    decode_step: Callable   # (cfg, params, consts, tokens, cache, index) -> (logits, cache)
    prefill_step: Optional[Callable] = None
    # segmented per-layer API (the update_mode="per_layer" train path)
    perlayer: Optional[PerLayerApi] = None


def _lm_api() -> ModelApi:
    from repro_torch.models import lm

    def apply(cfg, params, consts, batch, remat="none"):
        return lm.apply_lm(cfg, params, consts, batch["tokens"], remat=remat)

    def forward_boundaries(cfg, params, consts, batch):
        return lm.forward_saving_boundaries(
            cfg, params, consts, batch["tokens"],
            patch_embeds=batch.get("patches"))

    pl = PerLayerApi(forward_boundaries, lm.embed_apply, lm.period_apply,
                     lm.head_apply)
    return ModelApi(lm.init_lm, apply, lm.init_cache, lm.decode_step,
                    lm.prefill_step, perlayer=pl)


_FAMILY_API = {"llama": _lm_api}

# paper configs the port ships (repro_torch.configs.<arch>)
PAPER_ARCHS = ("llama_60m", "llama_130m", "llama_350m", "llama_1b", "llama_7b")


def get_api(cfg: ModelConfig) -> ModelApi:
    if cfg.family not in _FAMILY_API:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue A item "
            "9: the other model families)")
    return _FAMILY_API[cfg.family]()


def _config_module(arch: str):
    name = arch.replace("-", "_")
    if name not in PAPER_ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP queue A item 9); the "
            f"port ships {', '.join(PAPER_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _config_module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _config_module(arch).SMOKE
