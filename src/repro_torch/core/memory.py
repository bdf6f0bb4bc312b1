"""Memory estimator reproducing the paper's Appendix-F accounting, ported
from ``repro.core.memory`` (which its package's ``__init__`` ties to jax):
the same functions and numbers, on the port's own ``core.support``.

Conventions (paper §5.1 "Memory cost estimation"):
  * bf16 params/moments: 2 bytes; 1 G = 1e9 bytes.
  * SLTrain indices: int64 = 8 B/entry (paper). We also expose the int32
    convention the framework keeps on the device (the tile consts).
  * Adam optimizer state = 2x trainable parameter count.
  * GaLore: moments live in the projected space (project the smaller matrix
    dim to rank r), plus the stored projection matrices.

The estimator consumes a *matrix inventory*: every weight matrix in the
model, flagged ``adapted`` if the method reparameterizes it (all attention +
MLP linears; embeddings/norms/head stay dense — paper §5.1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from repro_torch.core import support as support_lib


@dataclass(frozen=True)
class MatrixInfo:
    name: str
    d_in: int
    d_out: int
    adapted: bool = True
    count: int = 1          # e.g. n_layers or n_layers*n_experts


@dataclass(frozen=True)
class MemoryEstimate:
    method: str
    param_count: float
    trainable_count: float
    param_bytes: float
    optim_bytes: float

    @property
    def total_bytes(self) -> float:
        return self.param_bytes + self.optim_bytes

    def gb(self, x: float) -> float:
        return x / 1e9

    def as_dict(self) -> Dict[str, float]:
        return {
            "method": self.method,
            "params_M": self.param_count / 1e6,
            "trainable_M": self.trainable_count / 1e6,
            "param_G": self.gb(self.param_bytes),
            "optim_G": self.gb(self.optim_bytes),
            "total_G": self.gb(self.total_bytes),
        }


def estimate(inventory: List[MatrixInfo], method: str, *, rank: int = 128,
             delta: float = 0.03, dtype_bytes: int = 2, index_bytes: int = 8,
             support_kind: str = "iid", galore_rank: int | None = None
             ) -> MemoryEstimate:
    galore_rank = galore_rank or rank
    base = sum(m.d_in * m.d_out * m.count for m in inventory if not m.adapted)
    dense_adapted = sum(m.d_in * m.d_out * m.count for m in inventory if m.adapted)
    lr_adapted = sum((m.d_in + m.d_out) * rank * m.count
                     for m in inventory if m.adapted)

    if method == "full":
        p = base + dense_adapted
        return MemoryEstimate(method, p, p, p * dtype_bytes, 2 * p * dtype_bytes)

    if method == "lowrank":
        p = base + lr_adapted
        return MemoryEstimate(method, p, p, p * dtype_bytes, 2 * p * dtype_bytes)

    if method == "relora":
        # stores W0 (dense) + factors; moments only on trainable (factors+base)
        p = base + dense_adapted + lr_adapted
        t = base + lr_adapted
        return MemoryEstimate(method, p, t, p * dtype_bytes, 2 * t * dtype_bytes)

    if method == "galore":
        p = base + dense_adapted
        proj = 0.0
        moments = 2.0 * base
        for m in inventory:
            if not m.adapted:
                continue
            small, big = min(m.d_in, m.d_out), max(m.d_in, m.d_out)
            r = min(galore_rank, small)
            proj += small * r * m.count
            moments += 2.0 * r * big * m.count
        return MemoryEstimate(method, p, p, p * dtype_bytes,
                              (moments + proj) * dtype_bytes)

    if method == "sltrain":
        nnz = sum(support_lib.nnz_for(m.d_in, m.d_out, delta, support_kind)
                  * m.count for m in inventory if m.adapted)
        t = base + lr_adapted + nnz
        param_bytes = t * dtype_bytes + nnz * index_bytes
        return MemoryEstimate(method, t, t, param_bytes, 2 * t * dtype_bytes)

    raise ValueError(f"unknown method {method!r}")


def llama_inventory(n_layers: int, d_model: int, d_ff: int, vocab: int,
                    n_heads: int = 0, n_kv_heads: int = 0, head_dim: int = 0,
                    tie_embeddings: bool = False) -> List[MatrixInfo]:
    """Inventory for a LLaMA-family model (SwiGLU MLP, untied head by default
    — matches the paper's 60M–7B accounting)."""
    hd = head_dim or (d_model // max(1, n_heads))
    nh = n_heads or (d_model // hd)
    nkv = n_kv_heads or nh
    inv = [
        MatrixInfo("embed", vocab, d_model, adapted=False),
        MatrixInfo("wq", d_model, nh * hd, count=n_layers),
        MatrixInfo("wk", d_model, nkv * hd, count=n_layers),
        MatrixInfo("wv", d_model, nkv * hd, count=n_layers),
        MatrixInfo("wo", nh * hd, d_model, count=n_layers),
        MatrixInfo("gate", d_model, d_ff, count=n_layers),
        MatrixInfo("up", d_model, d_ff, count=n_layers),
        MatrixInfo("down", d_ff, d_model, count=n_layers),
    ]
    if not tie_embeddings:
        inv.append(MatrixInfo("lm_head", d_model, vocab, adapted=False))
    return inv


# ---------------------------------------------------------------------------
# Training-state estimator: gradients + optimizer transients
#
# The base `estimate` reproduces Appendix F's params+optimizer accounting;
# this extension adds the two residency terms `update_mode` actually moves:
#   * gradient residency — global mode materializes the full trainable
#     gradient tree before the update; per_layer holds one layer group's
#     grads at a time (repro_torch.train.perlayer),
#   * optimizer transients — the f32 m/v working set the 8-bit update
#     dequantizes into (adamw keeps f32 moments as persistent state, so its
#     transient term is 0; its cost shows up in optim_bytes instead).
# Conventions follow the paper (bf16 = dtype_bytes for params/grads/
# moments, int64 indices by default; pass index_bytes=4 for the int32
# layout this framework ships on device).
# ---------------------------------------------------------------------------

def _per_copy_trainable(m: MatrixInfo, method: str, rank: int, delta: float,
                        support_kind: str) -> float:
    """Trainable parameter count of ONE copy of one inventory matrix."""
    if not m.adapted:
        return m.d_in * m.d_out
    if method in ("full", "galore"):
        return m.d_in * m.d_out
    if method == "lowrank":
        return (m.d_in + m.d_out) * rank
    if method == "relora":
        return m.d_in * m.d_out + (m.d_in + m.d_out) * rank
    if method == "sltrain":
        return (m.d_in + m.d_out) * rank \
            + support_lib.nnz_for(m.d_in, m.d_out, delta, support_kind)
    raise ValueError(method)


@dataclass(frozen=True)
class TrainMemoryEstimate:
    """Appendix-F style steady-state training memory, extended with the
    gradient + optimizer-transient residency terms update_mode moves."""
    method: str
    optimizer: str
    update_mode: str
    param_count: float
    trainable_count: float
    resident_count: float       # co-resident grad group (O(P_t) vs O(P_layer))
    param_bytes: float
    grad_bytes: float
    optim_bytes: float
    transient_bytes: float

    @property
    def total_bytes(self) -> float:
        return (self.param_bytes + self.grad_bytes + self.optim_bytes
                + self.transient_bytes)

    def gb(self, x: float) -> float:
        return x / 1e9

    def as_dict(self) -> Dict[str, float]:
        return {
            "method": self.method, "optimizer": self.optimizer,
            "update_mode": self.update_mode,
            "params_M": self.param_count / 1e6,
            "trainable_M": self.trainable_count / 1e6,
            "resident_M": self.resident_count / 1e6,
            "param_G": self.gb(self.param_bytes),
            "grad_G": self.gb(self.grad_bytes),
            "optim_G": self.gb(self.optim_bytes),
            "transient_G": self.gb(self.transient_bytes),
            "total_G": self.gb(self.total_bytes),
        }


def training_estimate(inventory: List[MatrixInfo], method: str, *,
                      optimizer: str = "adamw",
                      update_mode: str = "global", rank: int = 128,
                      delta: float = 0.03, dtype_bytes: int = 2,
                      index_bytes: int = 8, q_block: int = 256,
                      support_kind: str = "iid", fused_opt: bool = False,
                      galore_rank: int | None = None,
                      moment_bytes: int | None = None) -> TrainMemoryEstimate:
    """Training-state memory = params + grads + optimizer state +
    optimizer f32 transients, under an optimizer × update_mode choice.

    ``update_mode="per_layer"`` (repro_torch.train.perlayer) shrinks the
    co-resident gradient/transient group from the FULL trainable count to
    the largest single update group: max over (one layer's stacked
    matrices, each count==1 leaf such as embed/head) — the engine updates
    the head, then one layer at a time, then the embedding.

    ``fused_opt`` models the ``adam8bit`` kernel dispatch
    (kernels/adam8bit.py): the dequantized f32 m/v exist only in the
    kernel's registers, so the device-memory transient term drops to 0;
    the plain path round-trips the update group's f32 moments through
    device memory.

    ``moment_bytes`` overrides the per-element size of the adamw m/v
    state. The paper's Appendix-F convention keeps bf16 moments
    (``dtype_bytes``, the default); this framework's adamw
    (optim/optimizers.py) allocates f32 moments regardless of param
    dtype, so gates that compare against MEASURED device residency
    pass ``moment_bytes=4``.
    """
    base = estimate(inventory, method, rank=rank, delta=delta,
                    dtype_bytes=dtype_bytes, index_bytes=index_bytes,
                    support_kind=support_kind, galore_rank=galore_rank)
    t = base.trainable_count

    if update_mode == "per_layer":
        layer_group = sum(
            _per_copy_trainable(m, method, rank, delta, support_kind)
            for m in inventory if m.count > 1)
        singles = [
            _per_copy_trainable(m, method, rank, delta, support_kind)
            for m in inventory if m.count == 1]
        resident = max([layer_group] + singles)
    elif update_mode == "global":
        resident = t
    else:
        raise ValueError(f"unknown update_mode {update_mode!r}")

    grad_bytes = resident * dtype_bytes

    if optimizer == "adam8bit":
        # 2 moments × 1 byte codes + f32 per-block scales; the f32 m/v
        # working set exists only while a group updates (in the kernel's
        # registers under the fused dispatch, in device memory otherwise)
        optim_bytes = 2.0 * t * 1 + 2.0 * (t / q_block) * 4
        transient_bytes = 0.0 if fused_opt else 8.0 * resident
    elif optimizer == "adamw":
        # paper convention: bf16 moments (moment_bytes=None keeps it)
        optim_bytes = 2.0 * t * (moment_bytes or dtype_bytes)
        transient_bytes = 0.0
    elif optimizer == "galore_adamw":
        optim_bytes = base.optim_bytes if method == "galore" else \
            estimate(inventory, "galore", rank=rank, delta=delta,
                     dtype_bytes=dtype_bytes,
                     galore_rank=galore_rank).optim_bytes
        transient_bytes = 0.0
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")

    return TrainMemoryEstimate(
        method, optimizer, update_mode, base.param_count, t, resident,
        base.param_bytes, grad_bytes, optim_bytes, transient_bytes)


def paper_f_reduction(size: str = "7b", *, index_bytes: int = 8
                      ) -> Dict[str, float]:
    """The paper's headline §5.1/Appendix-F claim: SLTrain + 8-bit Adam +
    per-layer updates vs the full-rank AdamW baseline on LLaMA. For 7B
    (δ=0.05, r=1024 — configs/llama_7b.py) this reproduces the ~73%
    total-memory reduction (73.6% with the framework's int32 on-device
    indices, 71.2% with the paper's int64 convention). The lean side
    models the fused-kernel dispatch the per-layer engine uses under
    exec_mode="fused" (f32 moments never in device memory)."""
    cfg = dict(PAPER_LLAMA[size])
    rank = cfg.pop("rank")
    delta = 0.05 if size == "7b" else 0.03
    inv = llama_inventory(**cfg)
    full = training_estimate(inv, "full", optimizer="adamw",
                             update_mode="global", rank=rank, delta=delta)
    lean = training_estimate(inv, "sltrain", optimizer="adam8bit",
                             update_mode="per_layer", rank=rank, delta=delta,
                             index_bytes=index_bytes, fused_opt=True)
    return {"full_G": full.gb(full.total_bytes),
            "lean_G": lean.gb(lean.total_bytes),
            "resident_ratio": lean.resident_count / lean.trainable_count,
            "reduction": 1.0 - lean.total_bytes / full.total_bytes}


# The paper's LLaMA pretraining configs (GaLore/ReLoRA lineage).
PAPER_LLAMA = {
    "60m": dict(n_layers=8, d_model=512, d_ff=1376, vocab=32000, n_heads=8, rank=128),
    "130m": dict(n_layers=12, d_model=768, d_ff=2048, vocab=32000, n_heads=12, rank=256),
    "350m": dict(n_layers=24, d_model=1024, d_ff=2736, vocab=32000, n_heads=16, rank=256),
    "1b": dict(n_layers=24, d_model=2048, d_ff=5461, vocab=32000, n_heads=32, rank=512),
    "7b": dict(n_layers=32, d_model=4096, d_ff=11008, vocab=32000, n_heads=32, rank=1024),
}


def paper_table8(size: str, delta: float = 0.03) -> Dict[str, Dict[str, float]]:
    """Reproduce Table 8 (memory breakdown) for one paper model size."""
    cfg = dict(PAPER_LLAMA[size])
    rank = cfg.pop("rank")
    inv = llama_inventory(**cfg)
    out = {}
    for method in ("full", "lowrank", "relora", "galore", "sltrain"):
        out[method] = estimate(inv, method, rank=rank, delta=delta).as_dict()
    return out


@dataclass(frozen=True)
class DepthFit:
    """A measured quantity (a peak's bytes) as ``a + b·depth``, fitted by
    least squares, with each point's residual (measured minus fitted) in
    the points' order. The port's own: the reference fits nothing."""
    a: float
    b: float
    residuals: tuple

    def at(self, depth: float) -> float:
        """The line at ``depth`` (an extrapolation outside the points)."""
        return self.a + self.b * depth


def depth_fit(depths, values) -> DepthFit:
    """Least-squares line through (depth, value) points; at least two
    distinct depths."""
    xs, ys = tuple(float(d) for d in depths), tuple(float(v) for v in values)
    if len(xs) != len(ys) or len(set(xs)) < 2:
        raise ValueError(f"depth_fit needs two distinct depths, one value "
                         f"each: got depths {xs}, values {ys}")
    mx, my = sum(xs) / len(xs), sum(ys) / len(ys)
    b = sum((x - mx) * (y - my) for x, y in zip(xs, ys)) / \
        sum((x - mx) ** 2 for x in xs)
    a = my - b * mx
    return DepthFit(a, b, tuple(y - (a + b * x) for x, y in zip(xs, ys)))
