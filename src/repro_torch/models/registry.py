"""Uniform model API, ported from ``repro.models.registry``: every family
exposes init / apply / init_cache / decode_step, so the engine, the
trainers and the tests stay arch-agnostic. The llama, gemma2, vlm and MoE
families add prefill_step (the paged engine) and the segmented per-layer
API; the zamba2 hybrid, xLSTM and whisper families have neither, as in
the reference, so they serve on the contiguous cache and train with the
global update."""
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


def _hybrid_api() -> ModelApi:
    from repro_torch.models import mamba2

    def apply(cfg, params, consts, batch, remat="none"):
        return mamba2.apply_hybrid(cfg, params, consts, batch["tokens"],
                                   remat=remat)

    return ModelApi(mamba2.init_hybrid, apply, mamba2.init_hybrid_cache,
                    mamba2.hybrid_decode_step)


def _xlstm_api() -> ModelApi:
    from repro_torch.models import xlstm

    def apply(cfg, params, consts, batch, remat="none"):
        return xlstm.apply_xlstm(cfg, params, consts, batch["tokens"],
                                 remat=remat)

    return ModelApi(xlstm.init_xlstm, apply, xlstm.init_xlstm_cache,
                    xlstm.xlstm_decode_step)


def _whisper_api() -> ModelApi:
    from repro_torch.models import whisper

    def apply(cfg, params, consts, batch, remat="none"):
        return whisper.apply_whisper(cfg, params, consts, batch["tokens"],
                                     batch["frames"], remat=remat)

    return ModelApi(whisper.init_whisper, apply, whisper.init_whisper_cache,
                    whisper.whisper_decode_step)


_FAMILY_API = {
    "llama": _lm_api, "moe": _lm_api, "gemma2": _lm_api, "vlm": _lm_api,
    "mamba_hybrid": _hybrid_api, "xlstm": _xlstm_api, "whisper": _whisper_api,
}

# configs the port ships (repro_torch.configs.<arch>): the paper's and
# every other arch of the reference
PAPER_ARCHS = ("llama_60m", "llama_130m", "llama_350m", "llama_1b", "llama_7b")
ARCHS = ("gemma2_2b", "paligemma_3b", "qwen2_5_32b", "yi_34b", "llama3_405b",
         "deepseek_moe_16b", "qwen3_moe_235b", "zamba2_7b", "xlstm_350m",
         "whisper_large_v3")


def get_api(cfg: ModelConfig) -> ModelApi:
    if cfg.family not in _FAMILY_API:
        raise ValueError(f"unknown family {cfg.family!r}; the port runs "
                         f"{', '.join(sorted(_FAMILY_API))}")
    return _FAMILY_API[cfg.family]()


def _config_module(arch: str):
    name = arch.replace("-", "_")
    if name not in PAPER_ARCHS + ARCHS:
        raise ValueError(f"unknown arch {arch!r}; the port ships "
                         f"{', '.join(PAPER_ARCHS + ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _config_module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _config_module(arch).SMOKE
