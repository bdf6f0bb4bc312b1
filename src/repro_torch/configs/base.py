"""Config dataclasses of the model side, copied from ``repro.configs.base``.

Plain frozen dataclasses so configs hash and compare; ``ModelConfig.hash``
gives the same digest as the reference for the same field values, so a
checkpoint's ``config_hash`` agrees across the two packages. The
train-side configs keep the reference's field names and defaults; the
options the port does not run yet raise where they are used.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ParamConfig:
    """How linear-layer weights are parameterized.

    mode:
      dense   — full-rank W
      lowrank — W = (alpha/r) B A
      sltrain — W = (alpha/r) B A  ⊕_I  V        (the paper's method)
      relora  — W = W0 + (alpha/r) B A, periodic merge

    exec_mode (sltrain only) picks how the linear runs; the trainable
    params are identical across modes:
      "dense"  — densify W, one matmul.
      "fused"  — the hand-written ``sl_matmul`` kernel densifies W one
                 128×128 tile at a time on chip; W never reaches device
                 memory. Init emits int32 tile consts (core/sltrain.py).
      "sparse" — factored: (x·B)·A in f32 plus x·S from the
                 ``sparse_matmul`` kernel; trains too (dx over Wᵀ's tiles
                 through ``sparse_matmul``, dV through ``sddmm``).
      "quant"  — int8 decode of a calibrated quant artifact through the
                 ``quant_sparse_matmul`` kernel; forward-only (serving).
    """
    mode: str = "dense"
    rank: int = 128
    delta: float = 0.03
    alpha: float = 32.0
    # "row_balanced" gives each row exactly round(delta*d_out) entries;
    # "iid" matches the paper's sampling.
    support_kind: str = "row_balanced"
    exec_mode: str = "dense"
    relora_period: int = 2000


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 2
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    first_k_dense: int = 0
    d_ff_dense: int = 0
    router_aux_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64
    conv_width: int = 4
    n_ssm_heads: int = 0
    head_dim: int = 64
    expand: int = 2
    chunk: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str = "llama"
    # family: llama | moe | gemma2 | mamba_hybrid | xlstm | whisper | vlm
    family: str = "llama"
    n_layers: int = 8
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 0             # 0 -> d_model // n_heads
    d_ff: int = 1376
    vocab_size: int = 32000
    vocab_pad_multiple: int = 256
    max_seq_len: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    qkv_bias: bool = False
    tie_embeddings: bool = True
    sliding_window: int = 4096
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    use_post_norms: bool = False
    query_pre_attn_scalar: float = 0.0
    attn_pattern: Tuple[str, ...] = ()  # e.g. ("local","global"); empty = all global
    qk_norm: bool = False
    # Attention read path over the paged KV cache (serve/kv.py):
    #   "gather" — materialize the gathered (n_slots, view_len) per-slot
    #              view, plain attention over it;
    #   "paged"  — the paged_attention / paged_prefill kernels stream K/V
    #              blocks in place; the view never exists.
    attn_kernel: str = "paged"
    moe: MoEConfig = field(default_factory=MoEConfig)
    moe_groups: int = 1
    ssm: SSMConfig = field(default_factory=SSMConfig)
    hybrid_attn_every: int = 6
    xlstm_m_per_s: int = 7
    encoder_layers: int = 0
    encoder_seq: int = 1500
    n_patches: int = 256
    frontend_dim: int = 0
    param: ParamConfig = field(default_factory=ParamConfig)
    dtype: str = "bfloat16"
    seq_shard_activations: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim > 0 else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    def hash(self) -> str:
        return hashlib.sha256(
            json.dumps(dataclasses.asdict(self), sort_keys=True, default=str).encode()
        ).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Training / runtime
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"           # adamw | adam8bit | galore_adamw
    lr: float = 3e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    # GaLore
    galore_rank: int = 128
    galore_update_proj_gap: int = 200
    galore_scale: float = 0.25
    # 8-bit Adam
    q_block: int = 256


@dataclass(frozen=True)
class ShardingConfig:
    """Sharding policy and train-step execution knobs, the reference's
    fields: ``update_mode`` "global" or "per_layer", ``remat`` "none",
    "full" or "dots_saveable". On a mesh (``Trainer(mesh=...)``,
    ``repro_torch.dist``) ``fsdp`` also shards params and optimizer state
    over ``fsdp_axis``, the spec engine appending it to the first matrix
    dim it divides, and the gradients are reduce-scattered to that
    layout; ``pod_grad_compression`` sums the gradients over the pod axis
    in int8 (``dist.compression``). All 12 combinations of update_mode ×
    exec_mode (dense, sparse, fused) × fsdp train on a mesh; grad_accum
    composes with each. Without a mesh both flags change nothing, as in
    the reference."""
    batch_axes: Tuple[str, ...] = ("pod", "data")
    model_axis: str = "model"
    fsdp: bool = False
    fsdp_axis: str = "data"
    remat: str = "none"           # none | full | dots_saveable
    grad_accum: int = 1
    update_mode: str = "global"   # global | per_layer
    pod_grad_compression: bool = False
    seq_shard_decode: bool = False


@dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimizerConfig = field(default_factory=OptimizerConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)
    seed: int = 42
    global_batch: int = 8
    seq_len: int = 256
    steps: int = 50
    log_every: int = 10
    ckpt_every: int = 1000
    ckpt_dir: str = "/tmp/repro_ckpt"
    async_ckpt: bool = True
    keep_ckpts: int = 3


# ---------------------------------------------------------------------------
# Shape cells (the reference's assigned input shapes)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str       # "train" | "prefill" | "decode" | "long_decode"


SHAPE_CELLS = (
    ShapeCell("train_4k", 4096, 256, "train"),
    ShapeCell("prefill_32k", 32768, 32, "prefill"),
    ShapeCell("decode_32k", 32768, 128, "decode"),
    ShapeCell("long_500k", 524288, 1, "long_decode"),
)
