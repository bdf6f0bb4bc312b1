"""Uniform model API, ported from ``repro.models.registry``: the llama,
gemma2, vlm and MoE families expose init / apply / init_cache /
decode_step / prefill_step and the segmented per-layer API, so the
engine, the trainers and the tests stay arch-agnostic. The other families
raise until their slice lands (ROADMAP queue A item 9)."""
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
    dense: Callable               # (cfg, p_block, c_block, x) -> (x', aux)
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
        return lm.apply_lm(cfg, params, consts, batch["tokens"],
                           patch_embeds=batch.get("patches"), remat=remat)

    def forward_boundaries(cfg, params, consts, batch):
        return lm.forward_saving_boundaries(
            cfg, params, consts, batch["tokens"],
            patch_embeds=batch.get("patches"))

    pl = PerLayerApi(forward_boundaries, lm.embed_apply, lm.period_apply,
                     lm.dense_apply, lm.head_apply)
    return ModelApi(lm.init_lm, apply, lm.init_cache, lm.decode_step,
                    lm.prefill_step, perlayer=pl)


_FAMILY_API = {"llama": _lm_api, "gemma2": _lm_api, "vlm": _lm_api,
               "moe": _lm_api}
# the families still to port, with their ROADMAP item
_WAITING = {"mamba_hybrid": "9 (mamba2)",
            "xlstm": "9 (xlstm)",
            "whisper": "9 (whisper)"}

# configs the port ships (repro_torch.configs.<arch>): the paper's, and
# the other lm families (gemma2, vlm, the dense llama variants, MoE)
PAPER_ARCHS = ("llama_60m", "llama_130m", "llama_350m", "llama_1b", "llama_7b")
ARCHS = ("gemma2_2b", "paligemma_3b", "qwen2_5_32b", "yi_34b", "llama3_405b",
         "deepseek_moe_16b", "qwen3_moe_235b")
# the reference's archs that wait, with their family
_WAITING_ARCHS = {"zamba2_7b": "mamba_hybrid", "xlstm_350m": "xlstm",
                  "whisper_large_v3": "whisper"}


def _not_ported(what: str, family: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue A item "
        f"{_WAITING.get(family, '9: the other model families')})")


def get_api(cfg: ModelConfig) -> ModelApi:
    if cfg.family not in _FAMILY_API:
        raise _not_ported(f"family {cfg.family!r}", cfg.family)
    return _FAMILY_API[cfg.family]()


def _config_module(arch: str):
    name = arch.replace("-", "_")
    if name in _WAITING_ARCHS:
        raise _not_ported(f"arch {arch!r}", _WAITING_ARCHS[name])
    if name not in PAPER_ARCHS + ARCHS:
        raise ValueError(f"unknown arch {arch!r}; the port ships "
                         f"{', '.join(PAPER_ARCHS + ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _config_module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _config_module(arch).SMOKE
