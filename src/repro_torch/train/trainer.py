"""Training loop: logging, checkpoint/restart, preemption handling,
straggler watchdog and divergence recovery, ported from
``repro.train.trainer`` for one card.

As in the reference:
  * resume-from-latest is the default (a relaunch is a restart),
  * SIGTERM/SIGINT triggers a synchronous checkpoint, then exit(42), so a
    scheduler can requeue the job,
  * a per-step deadline watchdog flags stragglers (``on_straggler`` is the
    mitigation hook),
  * ``fault_hook(step)`` lets tests crash the loop at exact steps to prove
    kill/resume bit-exactness,
  * every step carries the non-finite gate (train/step.py): a NaN/inf
    loss or gradient never reaches the weights. After ``max_skips``
    consecutive skipped steps the trainer rolls back to the newest intact
    checkpoint and skips the data cursor forward (doubling per rollback);
    after ``max_rollbacks`` rollbacks it gives up,
  * corrupt batches (token ids out of range) are dropped on the host and
    the cursor advances (bounded retries),
  * checkpoints are checksummed; restore falls back to the newest intact
    step (ckpt/checkpoint.py),
  * ``chaos=ChaosEngine.parse(spec)`` (``resilience/chaos.py``; the
    launcher's ``--chaos``) injects the fault matrix: kills before a step
    (exit 43), checkpoint corruption, corrupt batches at the batch
    boundary, a NaN loss scale (``batch["chaos_scale"]``, carried on
    every step once a ``nonfinite`` fault is scheduled) and stragglers
    inside the timed window; injections are counted as
    ``resilience.faults_injected{kind=...}``.
Every recovery event lands on the obs registry
(``resilience.nonfinite_steps``, ``resilience.rollbacks``,
``resilience.bad_batches``) and the trace (``resilience.rollback``,
``resilience.restore``).

Each step's time ``dt`` is dispatch + sync: the host enqueues the whole
step, then the sync phase waits on the device for the loss, so ``dt`` is
the device time plus whatever dispatch did not overlap it, as in the
reference. ``update_mode="per_layer"`` runs the per-layer update sweep
(``train/perlayer.py``), which updates the params and the optimizer state
in place; checkpoints copy them to the host synchronously, so a
background write never sees a later step's values.

``param.mode="relora"`` merges and restarts the factors after each step
whose number is a multiple of ``relora_period``, as the reference does
(:func:`_make_relora_merge`). ReLoRA with 8-bit AdamW is refused at
construction: the reference's merge crashes on that state at the first
merge (ROADMAP queue C).

``mesh=`` (a ``dist.sharding.Mesh`` over a ``torch.distributed`` world,
every rank running its own Trainer) trains on the mesh, as the
reference's ``_place`` and ``_build_train_step`` do: every rank inits the
full state from the seed and keeps its shards of it per the spec engine
(``sharding.fsdp`` adds the data axis), takes its rows of each global
batch, and runs the step under ``dist.sharding.use_mesh``, so the
linears' tensor-parallel islands engage. ``sharding.pod_grad_compression``
on a mesh with a pod axis runs ``train.step.make_compressed_dp_step``.
Checkpoints hold the gathered full leaves (rank 0 writes them), so they
restore onto any mesh, or none. Still refused on a mesh (ROADMAP queue A
item 10b): the low-rank and ReLoRA modes, GaLore-AdamW, iid supports,
families other than llama, and ``seq_shard_activations``.
"""
from __future__ import annotations

import contextlib
import signal
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.analysis import roofline
from repro_torch.ckpt.checkpoint import (CheckpointCorruptError,
                                         CheckpointManager)
from repro_torch.configs.base import TrainConfig
from repro_torch.core import relora as relora_lib
from repro_torch.data.pipeline import SyntheticC4
from repro_torch.device import resolve
from repro_torch.kernels.ops import add_transposed_tiles
from repro_torch.models import registry
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import optimizers
from repro_torch.train import perlayer
from repro_torch.train import step as step_lib


def _is_relora(t) -> bool:
    return isinstance(t, dict) and {"W0", "B", "A"} <= set(t)


def relora_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of the merge after ``step``, seeded from (seed,
    step) as the reference folds ``step`` into ``PRNGKey(seed)``. The
    port cannot reproduce ``jax.random``'s bits: its redrawn A follow the
    same law from another stream."""
    gen = torch.Generator(device=device)
    gen.manual_seed(((seed & 0xFFFFFFFF) << 31) ^ step)
    return gen


def _make_relora_merge(cfg):
    """ReLoRA restart (paper eq. (1), baseline [32]), the reference's
    ``_make_relora_merge``: at each period end merge B·A into W0, restart
    the factors, and zero B's and A's AdamW moments (W0's are kept).
    merge(params, opt_state, gen) -> (params, opt_state), new trees.

    The leaves are walked in sorted key order, the reference's order
    under ``jax.jit``, each drawing its A from ``gen`` in turn. The merge
    scale is alpha / r_eff per matrix (r_eff = B.shape[-1]), the forward's
    convention. Only a state with top-level ``mu``/``nu`` (AdamW) is
    reset; GaLore's ``{"leaves", "step"}`` passes unchanged, as in the
    reference."""
    alpha = cfg.param.alpha

    def merge(params, opt_state, gen):
        def walk(t):
            if _is_relora(t):
                return relora_lib.merge(t, gen, alpha / t["B"].shape[-1])
            if isinstance(t, dict):
                return {k: walk(t[k]) for k in sorted(t)}
            return t

        def reset(m, p):
            if _is_relora(p):
                return {**m, "B": torch.zeros_like(m["B"]),
                        "A": torch.zeros_like(m["A"])}
            if isinstance(p, dict):
                return {k: reset(m[k], p[k]) for k in p}
            return m

        new_opt = dict(opt_state)
        if "mu" in opt_state:
            new_opt["mu"] = reset(opt_state["mu"], params)
            new_opt["nu"] = reset(opt_state["nu"], params)
        with torch.no_grad():
            return walk(params), new_opt

    return merge


@dataclass
class TrainerState:
    params: Any
    opt_state: Any
    consts: Any
    step: int = 0


@dataclass
class StepTimeWatchdog:
    """Flags steps slower than ``factor`` × the rolling median (straggler
    detection). The response is a callback, so a deployment can re-dispatch
    the straggler's data shard to a spare."""
    factor: float = 3.0
    window: int = 32
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    times: List[float] = field(default_factory=list)
    flagged: List[int] = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        med = float(np.median(self.times))
        slow = len(self.times) >= 8 and dt > self.factor * med
        if slow:
            self.flagged.append(step)
            if self.on_straggler:
                self.on_straggler(step, dt, med)
        return slow


def _check_mesh(tc: TrainConfig, mesh) -> None:
    """Raise on what the mesh path does not run yet, naming its ROADMAP
    item."""
    sh, cfg = tc.sharding, tc.model
    pc = cfg.param
    refused = []
    if pc.mode not in ("sltrain", "dense"):
        refused.append(f"param.mode {pc.mode!r}")
    if tc.optim.name not in ("adamw", "adam8bit"):
        refused.append(f"optimizer {tc.optim.name!r}")
    if pc.mode == "sltrain" and pc.support_kind != "row_balanced":
        refused.append(f"{pc.support_kind!r} supports")
    if cfg.family != "llama" or cfg.moe.n_experts:
        refused.append(f"the {cfg.family!r} family")
    if cfg.seq_shard_activations:
        refused.append("seq_shard_activations")
    if sh.pod_grad_compression and "pod" in mesh.axis_names:
        if sh.fsdp or sh.update_mode != "global" or any(
                n > 1 for a, n in mesh.shape.items() if a != "pod"):
            refused.append("pod compression beside fsdp, per-layer "
                           "updates or other mesh axes (the reference's "
                           "compressed step shards over the pod axis "
                           "alone)")
    if refused:
        raise NotImplementedError(
            f"on a mesh: {', '.join(refused)} not ported yet (ROADMAP "
            "queue A item 10b); the mesh path trains SLTrain "
            "(row-balanced) and full-rank llama models with AdamW or "
            "8-bit AdamW")


def _check_supported(tc: TrainConfig, mesh) -> None:
    """Raise on what the port does not run, naming its reason."""
    sh, pc = tc.sharding, tc.model.param
    if mesh is not None:
        _check_mesh(tc, mesh)
    if sh.update_mode not in ("global", "per_layer"):
        raise ValueError(f"unknown update_mode {sh.update_mode!r}: "
                         "expected 'global' or 'per_layer'")
    if pc.mode not in ("dense", "lowrank", "relora", "sltrain"):
        raise ValueError(f"unknown param.mode {pc.mode!r}")
    if tc.model.family == "whisper":
        raise ValueError(
            f"{tc.model.name}: the Trainer's data (SyntheticC4) carries "
            "tokens and no 'frames', which whisper's apply reads; the "
            "reference's Trainer dies on it with KeyError: 'frames' "
            "(ROADMAP queue C, reference behaviour 10). Train whisper "
            "through train.step.make_train_step with a batch holding "
            "'frames'")
    if pc.mode == "relora" and tc.optim.name == "adam8bit":
        raise ValueError(
            "ReLoRA with adam8bit is refused: the reference's merge "
            "(repro.train.trainer._make_relora_merge) resets the moments "
            "with jnp.zeros_like on the 8-bit {codes, scales} state and "
            "crashes at the first merge with \"TypeError: zeros_like "
            "requires ndarray or scalar arguments\" (ROADMAP queue C); "
            "train ReLoRA with adamw or galore_adamw")


class Trainer:
    def __init__(self, tc: TrainConfig, *, device="cuda", mesh=None,
                 log_fn=print,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 chaos=None, max_skips: int = 2, max_rollbacks: int = 2,
                 rollback_data_skip: int = 1,
                 obs: Optional[obs_metrics.Registry] = None,
                 trace: Optional[obs_trace.Trace] = None,
                 metrics_out: Optional[str] = None,
                 layer_timing: bool = False):
        _check_supported(tc, mesh)
        self.device = resolve(device)
        self.mesh = mesh
        self._chips = 1 if mesh is None else mesh.size
        self._plan = None
        self.tc = tc
        self.log = log_fn
        self.fault_hook = fault_hook
        self.chaos = chaos
        # -- resilience policy (module docstring) --
        self.max_skips = max_skips
        self.max_rollbacks = max_rollbacks
        self.rollback_data_skip = rollback_data_skip
        self._skip_streak = 0
        self._rollbacks = 0
        self.cfg = tc.model
        self.api = registry.get_api(self.cfg)
        self.optimizer = optimizers.make(tc.optim)
        self.ckpt = CheckpointManager(tc.ckpt_dir, keep=tc.keep_ckpts)
        self.data = SyntheticC4(self.cfg.vocab_size, tc.seq_len,
                                tc.global_batch, seed=tc.seed)
        self.watchdog = StepTimeWatchdog()
        self._preempted = False
        self.metrics_history: List[Dict[str, float]] = []

        # -- observability: own registry per trainer unless one is passed;
        # a disabled trace makes every span a no-op
        self.obs = obs if obs is not None else obs_metrics.Registry()
        self.trace = trace if trace is not None \
            else obs_trace.Trace(enabled=False)
        self.metrics_out = metrics_out
        self._c_steps = self.obs.counter("train.steps")
        self._c_tokens = self.obs.counter(
            "train.tokens", help="tokens consumed (global batch x seq)")
        self._g_loss = self.obs.gauge("train.loss")
        self._g_lr = self.obs.gauge("train.lr")
        self._g_gnorm = self.obs.gauge("train.grad_norm")
        self._g_tps = self.obs.gauge(
            "train.tokens_per_sec", help="tokens / (dispatch + sync) time")
        self._g_mfu = self.obs.gauge(
            "train.mfu", help="6ND model-FLOPs utilisation vs the card's "
            "peak (analysis.roofline.train_mfu)")
        self._h_step = self.obs.histogram(
            "train.step_ms", buckets=obs_metrics.ms_buckets())
        phase_h = self.obs.histogram(
            "train.phase_ms", buckets=obs_metrics.ms_buckets(),
            help="per-step phase split: data | dispatch | sync")
        self._h_phase = {k: phase_h.labels(phase=k)
                         for k in ("data", "dispatch", "sync")}
        self._c_nonfinite = self.obs.counter(
            "resilience.nonfinite_steps",
            help="steps whose update was skipped (non-finite loss/grads)")
        self._c_rollbacks = self.obs.counter(
            "resilience.rollbacks",
            help="rollbacks to the newest intact checkpoint")
        self._c_bad_batches = self.obs.counter(
            "resilience.bad_batches",
            help="corrupt data batches dropped by host-side validation")
        if self.chaos is not None:
            self.chaos.bind(self.obs)
        self._layer_timing = layer_timing
        self._train_step = self._build_train_step(None, None)
        self._relora_merge = _make_relora_merge(self.cfg) \
            if self.cfg.param.mode == "relora" else None

    def _build_train_step(self, p_specs, s_specs):
        """The step for the configured update_mode: the global step, or
        the per-layer sweep (with per-layer update timing on this
        trainer's registry when ``layer_timing``). On a mesh it is built
        again by :meth:`_place` with the spec trees, which exist once the
        state does: the int8-compressed step where pod compression is on,
        else the step over shards."""
        sh = self.tc.sharding
        if self._compressed():
            return step_lib.make_compressed_dp_step(
                self.cfg, self.api, self.optimizer, self.mesh, obs=self.obs)
        if sh.update_mode == "per_layer":
            return perlayer.make_perlayer_train_step(
                self.cfg, self.api, self.optimizer, remat=sh.remat,
                grad_accum=sh.grad_accum, grad_specs=p_specs,
                state_specs=s_specs, obs=self.obs,
                layer_timing=self.obs if self._layer_timing else None)
        return step_lib.make_train_step(
            self.cfg, self.api, self.optimizer, remat=sh.remat,
            grad_accum=sh.grad_accum, grad_specs=p_specs,
            state_specs=s_specs, obs=self.obs)

    def _compressed(self) -> bool:
        return (self.mesh is not None
                and self.tc.sharding.pod_grad_compression
                and "pod" in self.mesh.axis_names)

    # -- the mesh -------------------------------------------------------------
    def _specs(self, params, opt_state):
        """(param specs, optimizer-state specs) of the spec engine, fsdp
        axes included where ``sharding.fsdp`` asks for them."""
        from repro_torch.dist import sharding as dist_sharding
        sh = self.tc.sharding
        fsdp_axes = (sh.fsdp_axis,) if sh.fsdp else ()
        p_specs = dist_sharding.param_specs(params, self.mesh,
                                            fsdp_axes=fsdp_axes)
        return p_specs, dist_sharding.opt_state_specs(
            opt_state, p_specs, self.mesh, fsdp_axes=fsdp_axes)

    def _place(self, params, opt_state):
        """This rank's shards of the full state, and the step rebuilt for
        its specs (the reference's ``_place``). The consts stay whole on
        every rank: the islands slice the column tiles they read."""
        from repro_torch.dist import sharding as dist_sharding
        if self._compressed():
            return params, opt_state
        p_specs, s_specs = self._specs(params, opt_state)
        with dist_sharding.use_mesh(self.mesh):
            self._train_step = self._build_train_step(p_specs, s_specs)
        self._plan = (p_specs, s_specs)
        return (dist_sharding.place(params, self.mesh, p_specs),
                dist_sharding.place(opt_state, self.mesh, s_specs))

    def full_state(self, state: TrainerState):
        """(params, opt_state) of ``state`` whole: on a mesh gathered from
        every rank's shards (every rank calls it)."""
        if self._plan is None:
            return state.params, state.opt_state
        from repro_torch.dist import sharding as dist_sharding
        p_specs, s_specs = self._plan
        return (dist_sharding.gather(state.params, self.mesh, p_specs),
                dist_sharding.gather(state.opt_state, self.mesh, s_specs))

    def _local_batch(self, batch):
        """This rank's rows of a global batch (``dist.sharding.batch_specs``;
        all of it where the batch does not divide over the batch ranks)."""
        if self.mesh is None:
            return batch
        from repro_torch.dist import sharding as dist_sharding
        return dist_sharding.place(batch, self.mesh, dist_sharding.batch_specs(
            batch, self.mesh))

    def _barrier(self) -> None:
        if self.mesh is not None and self.mesh.size > 1:
            import torch.distributed as dist
            dist.barrier(self.mesh.group(self.mesh.axis_names))

    # -- state ----------------------------------------------------------------
    def init_state(self) -> TrainerState:
        """Params and consts from the model's init (the consts gain Wᵀ's
        tile consts for the fused and sparse backwards, built once here)
        and a fresh optimizer state. The init samples the supports in a
        pool of processes at llama_350m's size and up; its time and
        worker count land on ``obs`` (``init.seconds``,
        ``init.sampling_workers``) and in the log."""
        params, consts = self.api.init(self.cfg, seed=self.tc.seed,
                                       device=self.device, obs=self.obs)
        self.log(f"[trainer] init {self.obs.get('init.seconds').value:.1f} s "
                 f"({self.obs.get('init.sampling_workers').value:.0f} "
                 "support sampling workers)")
        return self.state_from(params, consts)

    def state_from(self, params, consts) -> TrainerState:
        """The step-0 state of the full ``params`` and ``consts`` (the
        model's init's trees): a fresh optimizer state, and on a mesh this
        rank's shards of both (every rank passes the same trees)."""
        opt_state = self.optimizer.init(params)
        if self.mesh is not None:
            params, opt_state = self._place(params, opt_state)
        return TrainerState(params, opt_state, add_transposed_tiles(consts),
                            step=0)

    def save(self, state: TrainerState, background: Optional[bool] = None
             ) -> None:
        bg = self.tc.async_ckpt if background is None else background
        params, opt_state = self.full_state(state)
        if self.mesh is not None and self.mesh.rank != 0:
            self._barrier()
            return
        self.ckpt.save(
            state.step, {"params": params, "opt_state": opt_state},
            config_hash=self.cfg.hash(),
            extra={"data": self.data.state_dict()},
            background=bg and self.mesh is None)
        self._barrier()

    def restore_or_init(self) -> TrainerState:
        state = self.init_state()
        if self.ckpt.latest_step() is None:
            return state
        try:
            with self.trace.span("resilience.restore", cat="resilience"):
                # step=None: checksum-verified, falls back newest → oldest;
                # on a mesh each leaf is cut to this rank's shard
                tree, manifest = self.ckpt.restore(
                    {"params": state.params, "opt_state": state.opt_state},
                    config_hash=self.cfg.hash(),
                    shardings=self._shardings())
        except CheckpointCorruptError as e:
            self.log(f"[trainer] every checkpoint failed verification "
                     f"({e}): starting fresh")
            return state
        self.data.restore(manifest["extra"]["data"])
        latest = int(manifest["step"])
        self.log(f"[trainer] resumed from step {latest}")
        return TrainerState(tree["params"], tree["opt_state"], state.consts,
                            step=latest)

    def _shardings(self):
        """The restore's shardings on a mesh (None off it)."""
        if self._plan is None:
            return None
        from repro_torch.dist import sharding as dist_sharding
        p_specs, s_specs = self._plan
        return {"params": dist_sharding.named_shardings(self.mesh, p_specs),
                "opt_state": dist_sharding.named_shardings(self.mesh,
                                                           s_specs)}

    # -- resilience -------------------------------------------------------------
    def _next_valid_batch(self, step: int):
        """Next data batch, validated on the host; a corrupt batch (a chaos
        fault or a real pipeline fault) is dropped and the cursor
        advances."""
        for _ in range(8):
            batch = self.data.next_batch()
            if self.chaos is not None:
                batch = self.chaos.corrupt_batch(step, batch)
            toks = batch["tokens"]
            if toks.dtype.kind in "iu" and \
                    bool(((toks >= 0) & (toks < self.cfg.vocab_size)).all()):
                return batch
            self._c_bad_batches.inc()
            self.log(f"[trainer] corrupt batch at step {step + 1}: "
                     "dropped, data cursor advanced")
        raise RuntimeError("data pipeline produced 8 consecutive corrupt "
                           "batches — not a transient fault, giving up")

    def _rollback(self, reason: str) -> TrainerState:
        """Restore the newest intact checkpoint and skip the data cursor
        past the offending batches (doubling per rollback). Bounded by
        ``max_rollbacks``."""
        self._rollbacks += 1
        self._c_rollbacks.inc()
        if self._rollbacks > self.max_rollbacks:
            raise RuntimeError(
                f"{reason} persisted through {self.max_rollbacks} "
                "rollbacks — giving up (raise --max-rollbacks or inspect "
                "the data/optimizer)")
        with self.trace.span("resilience.rollback", cat="resilience",
                             n=self._rollbacks):
            self.ckpt.wait()
            state = self.restore_or_init()
            skip = self.rollback_data_skip * (2 ** (self._rollbacks - 1))
            self.data.skip(skip)
        self._skip_streak = 0
        self.log(f"[trainer] rollback #{self._rollbacks} ({reason}): "
                 f"resumed step {state.step}, skipped {skip} data "
                 f"batch(es) forward")
        return state

    def _mesh_ctx(self):
        """``dist.sharding.use_mesh`` of this trainer's mesh (with the
        global batch the islands' gate reads), or nothing."""
        if self.mesh is None:
            return contextlib.nullcontext()
        from repro_torch.dist import sharding as dist_sharding
        return dist_sharding.use_mesh(self.mesh,
                                      global_batch=self.tc.global_batch)

    # -- preemption -------------------------------------------------------------
    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._preempted = True
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # not on the main thread (tests)

    # -- loop -------------------------------------------------------------------
    def run(self, steps: Optional[int] = None,
            state: Optional[TrainerState] = None) -> TrainerState:
        tc = self.tc
        total = steps if steps is not None else tc.steps
        if state is None:
            state = self.restore_or_init()
        self._install_signal_handlers()
        tokens_per_step = tc.global_batch * tc.seq_len
        while state.step < total:
            if self.chaos is not None:
                # injected kills and checkpoint corruption (a kill raises
                # ChaosKill, a SystemExit(43) the relaunch recovers from)
                self.chaos.train_hook(state.step, ckpt_dir=tc.ckpt_dir)
            if self.fault_hook:
                self.fault_hook(state.step)  # test hook: may raise/kill
            with self.trace.span("train.step", cat="train",
                                 step=state.step + 1):
                t0 = time.perf_counter()
                with self.trace.span("train.data", cat="train"):
                    batch_np = self._next_valid_batch(state.step)
                    if self.chaos is not None and self.chaos.wants_poison:
                        # the key rides along on every step (1.0 off the
                        # fault), so the step's inputs keep one structure
                        batch_np = dict(batch_np)
                        batch_np["chaos_scale"] = np.full(
                            (batch_np["tokens"].shape[0],),
                            self.chaos.poison_scale(state.step), np.float32)
                    batch = self._local_batch(
                        {k: torch.from_numpy(np.asarray(v)).to(self.device)
                         for k, v in batch_np.items()})
                t1 = time.perf_counter()
                with self.trace.span("train.dispatch", cat="train"), \
                        self._mesh_ctx():
                    params, opt_state, metrics = self._train_step(
                        state.params, state.opt_state, state.consts, batch)
                t2 = time.perf_counter()
                if self.chaos is not None:
                    self.chaos.straggle(state.step)   # inside the dt window
                with self.trace.span("train.sync", cat="train"):
                    row = {k: float(v) for k, v in metrics.items()}
                t3 = time.perf_counter()
            # dt: dispatch + sync (excludes host-side data work), the
            # watchdog's and the history's currency, as in the reference
            dt = t3 - t1
            self._h_phase["data"].observe((t1 - t0) * 1e3)
            self._h_phase["dispatch"].observe((t2 - t1) * 1e3)
            self._h_phase["sync"].observe((t3 - t2) * 1e3)
            self._h_step.observe(dt * 1e3)
            self._c_steps.inc()
            self._c_tokens.inc(tokens_per_step)
            state = TrainerState(params, opt_state, state.consts,
                                 state.step + 1)
            if self._relora_merge is not None and \
                    state.step % self.cfg.param.relora_period == 0:
                params, opt_state = self._relora_merge(
                    state.params, state.opt_state,
                    relora_generator(tc.seed, state.step, self.device))
                state = TrainerState(params, opt_state, state.consts,
                                     state.step)
                self.log(f"[trainer] ReLoRA merge+restart at {state.step}")
            slow = self.watchdog.observe(state.step, dt)
            row.update(step=state.step, dt=dt)
            self.metrics_history.append(row)
            skipped = row.get("nonfinite", 0.0) >= 1.0
            if skipped:
                # the step's gate already kept the pre-step state; here we
                # only account and decide whether to escalate
                self._c_nonfinite.inc()
                self._skip_streak += 1
                self.log(f"[trainer] non-finite loss/grads at step "
                         f"{state.step}: update skipped "
                         f"({self._skip_streak}/{self.max_skips} before "
                         "rollback)")
            else:
                self._skip_streak = 0
            self._g_loss.set(row["loss"])
            self._g_lr.set(row["lr"])
            self._g_gnorm.set(row["grad_norm"])
            self._g_tps.set(tokens_per_step / dt if dt > 0 else 0.0)
            self._g_mfu.set(roofline.train_mfu(self.cfg, tokens_per_step,
                                               dt, self._chips))
            if state.step % tc.log_every == 0 or state.step == total:
                self.log(f"[step {state.step:5d}] "
                         f"loss={self._g_loss.value:.4f} "
                         f"lr={self._g_lr.value or 0:.2e} {dt*1e3:.0f}ms "
                         f"{self._g_tps.value:.0f}tok/s "
                         f"mfu={self._g_mfu.value:.4f}"
                         + (" STRAGGLER" if slow else ""))
                if self.metrics_out:
                    self.obs.write_jsonl(self.metrics_out,
                                         extra={"step": state.step})
            if skipped and self._skip_streak >= self.max_skips:
                state = self._rollback("non-finite loss/grads")
                continue
            if self._preempted:
                self.log("[trainer] preemption signal: checkpoint + exit 42")
                self.save(state, background=False)
                self.ckpt.wait()
                sys.exit(42)
            if tc.ckpt_every and state.step % tc.ckpt_every == 0:
                self.save(state)
        self.save(state, background=False)
        self.ckpt.wait()
        return state
