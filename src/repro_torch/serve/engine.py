"""Serving engine: continuous batching over fixed slots with a paged KV
cache, copy-on-write prefix sharing, batched (suffix-)prefill and per-slot
decode positions, or the contiguous cache of the reference's legacy path
— a port of ``repro.serve.engine``.

Two run loops: :meth:`ServeEngine.run_until_drained` (admit whatever is
queued and run to empty) and :meth:`ServeEngine.run_stream` (requests
carry arrival ticks; admission happens inside the decode loop as slots
free up). With ``prefix_sharing=True`` an admission whose prompt matches a
resident block-aligned prefix attaches those pages read-only and prefills
only the divergent suffix through the chunked paged-prefill path.

Two cache layouts share the engine API:

* ``paged=True``: K/V lives in block pools (serve/kv.py) addressed through
  a per-slot block table; the scheduler (serve/scheduler.py) assigns
  slots and allocates and frees blocks. Prefill is batched (one forward
  per admission batch); decode is per-slot (a (n_slots,) position
  vector). It needs the family's ``prefill_step``: the zamba2 hybrid,
  xLSTM and whisper families have none and raise ``ValueError``, as in
  the reference.
* ``paged=False`` (the default, as in the reference): one contiguous
  (n_slots, max_len) cache. Each prompt is prefilled by stepping it
  through the (n_slots, 1) decode one token a dispatch, with token 0 in
  every other row, so every slot's row is written at that index; decode
  writes every row at one shared index, the largest position among the
  runnable slots. Both are the reference's semantics kept bit for bit,
  warts included (ROADMAP queue C): a request's tokens can depend on
  what shares the engine with it. Attention reads the rows with plain
  PyTorch, as the reference's XLA does; ``attn_kernel="paged"`` is
  refused there, and the config's default "paged" falls back to
  "gather". ``prefix_sharing`` and ``run_stream`` need the paged cache.

On the paged cache, with
``attn_kernel="paged"`` the reads go through the hand-written
paged-attention kernels; with ``"gather"`` through the gathered view.
Every linear runs as ``exec_mode`` says: ``"fused"`` through the
``sl_matmul`` kernel, ``"dense"`` by densifying W, ``"sparse"`` (or
``sparse_decode=True``) as the factored decode through the
``sparse_matmul`` kernel, ``"quant"`` through the ``quant_sparse_matmul``
kernel on the consts of a calibrated quant artifact (repro_torch.quant).
With ``quant_fallback=True`` a quant engine whose consts lack the int8
codes but hold the sparse path's tile consts serves in exec_mode
``"sparse"`` instead, through ``sparse_matmul``: it warns, sets
``quant_fell_back`` and counts ``serve.quant_fallback``, as the
reference does.

Observability: the counters, TTFT histograms and trace spans of the
reference engine, on the port's copy of ``repro.obs``. Resilience: every
submitted request reaches a terminal ``Request.status`` — ``done``,
``rejected`` (``max_queue`` shedding), ``timed_out`` (tick or wall
deadlines) or ``failed`` (a run loop's step budget ran out; calling it
again resumes). ``tick_hook(engine)`` runs at the top of every engine
step (``resilience.chaos.ChaosEngine.serve_hook`` wires ``stall@T:K``),
and :meth:`ServeEngine.stall_slot` freezes a slot for K ticks: the loop
decodes around it, and when every active slot is stalled the clock still
advances, so stalls and deadlines expire.

On a device ``mesh`` (a ``dist.sharding.Mesh`` over a
``torch.distributed`` world) the engine serves the llama family SPMD:
every rank constructs the same engine on the full params and runs the
same scheduler, so the ranks keep the same admissions, block tables and
tokens tick for tick. Construction places each rank's state once
(``dist.sharding.serving_state``): it allocates only its shard of the KV
cache as ``cache_specs`` gives it (kv heads over the model axis; a
contiguous cache's slots over the batch axes too), and in exec_mode
fused, sparse and quant holds the column slice of every linear whose
tensor-parallel island engages; every other leaf stays whole. What it
holds is the engine's ``placement`` (a ``dist.sharding.ServingLayout``),
made ambient in each dispatch (``train.step.make_serve_step(layout=)``):
the paged kernels read the rank's kv heads, the island linears run their
kernel on the rank's column tiles (the q/k/v projections straight into
its heads), and only activations are all-gathered (output columns,
attention heads, and logits over the batch axes of a contiguous cache).
Its tokens equal the one-process engine's. Refused on a mesh, naming
ROADMAP queue A item 10b: MoE expert stacks, the families other than
llama (gemma2, vlm, the SSM and encoder families), a seq-sharded cache
(``cfg.seq_shard_activations``; on the paged kernels' cache the
``ValueError`` of ``cache_specs``, as the reference's) and a wall-clock
deadline (``deadline_ms``) across more than one rank, whose ranks would
read different clocks.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.dist import sharding as dist_sharding
from repro_torch.models import registry
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.kv import PagedLayout, blocks_for
from repro_torch.serve.scheduler import Scheduler
from repro_torch.train import step as step_lib


@dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 16
    out: List[int] = field(default_factory=list)
    done: bool = False
    # preemption state: prompt + generated tokens to recompute on
    # readmission, and a no-progress counter bounding evict/readmit cycles
    resume: Optional[List[int]] = None
    stalls: int = 0
    _progress_mark: int = -1
    # engine clock ticks (one per prefill or decode dispatch): arrival,
    # admission, first token, completion. TTFT = t_first - arrival.
    arrival: int = 0
    t_admit: Optional[int] = None
    t_first: Optional[int] = None
    t_done: Optional[int] = None
    # the same milestones on the monotonic wall clock (seconds)
    wall_arrival: Optional[float] = None
    wall_admit: Optional[float] = None
    wall_first: Optional[float] = None
    wall_done: Optional[float] = None
    # queued → active → done / rejected / timed_out / failed
    status: str = "queued"
    fail_reason: Optional[str] = None
    deadline_ticks: Optional[int] = None


def _not_ported(what: str, item) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue A "
                               f"item {item})")


def _check_mesh(cfg: ModelConfig, mesh, deadline_ms) -> None:
    """Refuse what serving on a mesh does not run yet (ROADMAP queue A
    item 10b)."""
    if cfg.moe.n_experts > 0:
        raise _not_ported("serving MoE expert stacks on a device mesh",
                          "10b")
    if cfg.family != "llama":
        raise _not_ported(f"serving the {cfg.family} family on a device "
                          "mesh", "10b")
    if deadline_ms is not None and mesh.size > 1:
        raise _not_ported("a wall-clock deadline (deadline_ms) across the "
                          "ranks of a serving mesh", "10b")


# the consts the sparse path reads (besides params' v): what a quant
# engine's fallback checks for
_SPARSE_CONSTS = {"rows_t", "cols_t", "perm"}


def _all_keys(tree) -> set:
    if isinstance(tree, dict):
        return set(tree).union(*(_all_keys(v) for v in tree.values()))
    return set()


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, consts, *, n_slots: int = 4,
                 max_len: int = 256, sparse_decode: bool = False,
                 exec_mode: Optional[str] = None, mesh=None,
                 paged: bool = False, block_len: int = 16, n_blocks: int = 0,
                 attn_kernel: Optional[str] = None,
                 prefix_sharing: bool = False,
                 obs: Optional[obs_metrics.Registry] = None,
                 trace: Optional[obs_trace.Trace] = None,
                 max_queue: Optional[int] = None,
                 deadline_ticks: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 tick_hook=None, quant_fallback: bool = False,
                 device="cuda"):
        if mesh is not None:
            _check_mesh(cfg, mesh, deadline_ms)
        if exec_mode is not None:
            # the explicit serve-time mode supersedes the sparse_decode
            # shorthand
            if sparse_decode:
                raise ValueError("pass either sparse_decode or exec_mode, "
                                 "not both")
            if cfg.param.mode != "sltrain":
                raise ValueError(f"exec_mode={exec_mode!r} requires "
                                 "param.mode='sltrain'")
            if exec_mode not in ("dense", "sparse", "fused", "quant"):
                raise ValueError(f"unknown exec_mode {exec_mode!r}")
            cfg = dataclasses.replace(
                cfg, param=dataclasses.replace(cfg.param,
                                               exec_mode=exec_mode))
        if sparse_decode and cfg.param.mode == "sltrain":
            cfg = dataclasses.replace(
                cfg, param=dataclasses.replace(cfg.param, exec_mode="sparse"))
        # fail at construction, not at the first dispatch, when the consts
        # lack what the decode kernels read
        mode = cfg.param.exec_mode if cfg.param.mode == "sltrain" else None
        quant_fell_back = False
        if mode == "quant" and "qv_t" not in _all_keys(consts):
            # quant_fallback: serve through the sparse path instead, but
            # only when the leaves that path reads are there — a blind
            # downgrade would move the failure to the first dispatch
            if quant_fallback and _SPARSE_CONSTS <= _all_keys(consts) and \
                    "v" in _all_keys(params):
                warnings.warn(
                    "quant artifact validation failed (consts lack qv_t): "
                    "serving degraded to exec_mode='sparse' (the "
                    "sparse_matmul kernel in place of quant_sparse_matmul)")
                mode = "sparse"
                cfg = dataclasses.replace(
                    cfg, param=dataclasses.replace(cfg.param,
                                                   exec_mode=mode))
                quant_fell_back = True
            else:
                raise ValueError(
                    "exec_mode='quant' needs calibrated consts (qv_t/rows_q/"
                    "cols_q/qscale) — load a quant artifact (python -m "
                    "repro_torch.quant.calibrate, then "
                    "ckpt.checkpoint.load_quant_artifact) and pass its "
                    "params/consts")
        if mode == "sparse" and "perm" not in _all_keys(consts):
            raise ValueError(
                "exec_mode='sparse' needs the tile consts {rows_t, cols_t, "
                "perm}: init the model with exec_mode 'sparse' or 'fused'")
        if attn_kernel is not None:
            cfg = dataclasses.replace(cfg, attn_kernel=attn_kernel)
        if cfg.attn_kernel not in ("gather", "paged"):
            raise ValueError(f"attn_kernel {cfg.attn_kernel!r}: expected "
                             "'gather' or 'paged'")
        if cfg.attn_kernel == "paged" and not paged:
            if attn_kernel is not None:
                raise ValueError("attn_kernel='paged' requires the paged KV "
                                 "cache (paged=True): the kernel reads block "
                                 "pools, not the contiguous layout")
            # the config's default is "paged": a contiguous engine has no
            # pools to stream, so it reads through the gathered path, as
            # the reference falls back
            cfg = dataclasses.replace(cfg, attn_kernel="gather")
        if prefix_sharing and not paged:
            raise ValueError("prefix_sharing requires the paged KV cache "
                             "(paged=True): sharing attaches block-table "
                             "entries, which the contiguous layout lacks")
        self.device = resolve(device)
        self.cfg = cfg
        self.params, self.consts = params, consts
        self.api = registry.get_api(cfg)
        self.n_slots = n_slots
        self.max_len = max_len
        self.paged = paged
        self.prefix_sharing = prefix_sharing
        # each engine defaults to its own registry so side-by-side engines
        # never share counters; the default trace is a disabled recorder
        self.obs = obs if obs is not None else obs_metrics.Registry()
        self.trace = trace if trace is not None else \
            obs_trace.Trace(enabled=False)
        # on a mesh the full cache is only shapes: each rank allocates its
        # shard (serving_state)
        cache_device = "meta" if mesh is not None else self.device
        if paged:
            if self.api.prefill_step is None:
                raise ValueError(f"family {cfg.family!r} has no prefill_step;"
                                 " the paged engine requires one")
            self.layout = PagedLayout.plan(n_slots, max_len, block_len,
                                           n_blocks)
            self.cache = self.api.init_cache(
                cfg, n_slots, max_len, paged=True, block_len=block_len,
                n_blocks=self.layout.n_blocks, device=cache_device)
            self.sched = Scheduler(n_slots, max_len, self.layout,
                                   prefix_sharing=prefix_sharing,
                                   obs=self.obs)
        else:
            self.cache = self.api.init_cache(cfg, n_slots, max_len,
                                             device=cache_device)
            self.sched = None
        self.mesh, self.placement = mesh, None
        if mesh is not None:
            self.params, self.consts, self.cache, self.placement = \
                dist_sharding.serving_state(
                    params, consts, self.cache, mesh, exec_mode=mode,
                    n_slots=n_slots, paged=paged,
                    attn_kernel=cfg.attn_kernel,
                    seq_sharded=cfg.seq_shard_activations,
                    device=self.device)
        if paged:
            self._prefill_fn = step_lib.make_prefill_step(
                cfg, self.api, layout=self.placement)
        self._decode_fn = step_lib.make_serve_step(cfg, self.api,
                                                   layout=self.placement)
        # the contiguous path's host state: next position, slot owner, queue
        self.pos = np.zeros(n_slots, dtype=np.int32)
        self.slot_req: List[Optional[Request]] = [None] * n_slots
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        self._parked = False          # any active slot waiting for blocks
        self._uid = 0
        self._steps = 0
        # engine clock, in dispatches (prefill or decode, each += 1): the
        # deterministic time base for arrivals and TTFT
        self.clock = 0
        disp = self.obs.counter("serve.dispatches",
                                help="step dispatches by phase")
        self._c_disp = {k: disp.labels(phase=k)
                        for k in ("prefill", "decode")}
        ptok = self.obs.counter("serve.prefill.tokens",
                                help="prompt tokens by provenance")
        self._c_prefill = {f"tokens_{k}": ptok.labels(kind=k)
                           for k in ("total", "prefilled", "shared")}
        self._c_kv = {k: self.obs.counter(f"serve.kv.{k}")
                      for k in ("steps", "gather_tokens", "live_tokens",
                                "resident_tokens", "active_slots")}
        self._c_done = self.obs.counter("serve.requests.completed")
        self._c_sub = self.obs.counter("serve.requests.submitted")
        self._h_ttft = self.obs.histogram(
            "serve.ttft_ticks", buckets=obs_metrics.tick_buckets(),
            help="time to first token, engine clock ticks")
        self._h_ttft_ms = self.obs.histogram(
            "serve.ttft_wall_ms", buckets=obs_metrics.ms_buckets(),
            help="time to first token, wall ms from submit")
        self._h_e2e = self.obs.histogram(
            "serve.e2e_ticks", buckets=obs_metrics.tick_buckets(),
            help="arrival to completion, engine clock ticks")
        self._dispatches_view = obs_metrics.MetricView(self._c_disp)
        self._prefill_view = obs_metrics.MetricView(self._c_prefill)
        self._kv_view = obs_metrics.MetricView(self._c_kv)
        self.max_queue = max_queue
        self.default_deadline_ticks = deadline_ticks
        self._deadline_s = None if deadline_ms is None else deadline_ms / 1e3
        self.tick_hook = tick_hook
        self._stall_until: Dict[int, int] = {}
        self.rejected: List[Request] = []
        self.timed_out: List[Request] = []
        self._c_rejected = self.obs.counter(
            "serve.rejected",
            help="requests shed at submit (admission queue at max_queue)")
        self._c_deadline = self.obs.counter(
            "serve.deadline_exceeded",
            help="requests cancelled past their tick/wall deadline")
        self._c_qfall = self.obs.counter(
            "serve.quant_fallback",
            help="quant engines degraded to sparse at construction")
        if quant_fell_back:
            self._c_qfall.inc()
        self.quant_fell_back = quant_fell_back

    # -- counter views + measurement reset ------------------------------------
    @property
    def dispatches(self) -> obs_metrics.MetricView:
        return self._dispatches_view

    @property
    def prefill_traffic(self) -> obs_metrics.MetricView:
        return self._prefill_view

    @property
    def kv_traffic(self) -> obs_metrics.MetricView:
        return self._kv_view

    def reset_metrics(self) -> None:
        """Zero every obs instrument, the step counter, the tick clock and
        the completed list. Call while idle."""
        self.obs.reset()
        self._steps = 0
        self.clock = 0
        self.completed.clear()

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(self.device)

    # -- API --------------------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               arrival: Optional[int] = None,
               deadline_ticks: Optional[int] = None) -> Request:
        """Queue a request; invalid prompts are rejected here. ``arrival``
        (ticks) gates admission in :meth:`run_stream`; with ``max_queue``
        set a submit past the cap returns ``status="rejected"``."""
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) >= self.max_len:
            raise ValueError(f"prompt of {len(prompt)} tokens ≥ max_len "
                             f"{self.max_len}")
        if self.paged:
            need = blocks_for(len(prompt) + 1, self.layout.block_len)
            usable = self.layout.n_blocks - 1
            if need > usable:
                # admission is FIFO with break-on-first-misfit: a request
                # the whole pool cannot hold would starve everything behind
                raise ValueError(
                    f"prompt needs {need} blocks but the pool only has "
                    f"{usable}: raise n_blocks or shorten the prompt")
        self._uid += 1
        req = Request(self._uid, list(prompt), max_new_tokens,
                      arrival=int(arrival or 0),
                      wall_arrival=time.perf_counter(),
                      deadline_ticks=(deadline_ticks
                                      if deadline_ticks is not None
                                      else self.default_deadline_ticks))
        self._c_sub.inc()
        queue = self._queue()
        if self.max_queue is not None and len(queue) >= self.max_queue:
            req.status = "rejected"
            req.fail_reason = (f"admission queue full ({len(queue)} queued "
                               f">= max_queue={self.max_queue})")
            self.rejected.append(req)
            self._c_rejected.inc()
            return req
        if self.paged:
            self.sched.submit(req)
        else:
            self.queue.append(req)
        return req

    def _queue(self) -> List[Request]:
        return self.sched.queue if self.paged else self.queue

    def _complete(self, req: Request) -> None:
        req.done = True
        req.status = "done"
        req.fail_reason = None
        req.t_done = self.clock
        req.wall_done = time.perf_counter()
        self.completed.append(req)
        self._c_done.inc()
        if req.t_first is not None:
            self._h_ttft.observe(req.t_first - req.arrival)
            if req.wall_first is not None and req.wall_arrival is not None:
                self._h_ttft_ms.observe(
                    (req.wall_first - req.wall_arrival) * 1e3)
        self._h_e2e.observe(req.t_done - req.arrival)
        if self.trace.enabled:
            self._trace_request(req)

    def _trace_request(self, req: Request) -> None:
        """The request's lifecycle on the tick timeline (one lane per uid):
        queued [arrival, t_admit) → prefill [t_admit, t_first) → decode
        [t_first, t_done)."""
        k = obs_trace.TICK_US
        ta = req.t_admit if req.t_admit is not None else req.arrival
        tf = req.t_first if req.t_first is not None else ta
        ttft_ms = None
        if req.wall_first is not None and req.wall_arrival is not None:
            ttft_ms = round((req.wall_first - req.wall_arrival) * 1e3, 3)
        args = {"uid": req.uid, "arrival_tick": req.arrival,
                "t_first_tick": tf, "t_done_tick": req.t_done,
                "ttft_ticks": tf - req.arrival, "ttft_wall_ms": ttft_ms}
        self.trace.thread_name(req.uid, f"request {req.uid}")
        self.trace.event("queued", ts_us=req.arrival * k,
                         dur_us=(ta - req.arrival) * k, tid=req.uid,
                         cat="request", args=args)
        self.trace.event("prefill", ts_us=ta * k, dur_us=(tf - ta) * k,
                         tid=req.uid, cat="request", args=args)
        self.trace.event("decode", ts_us=tf * k,
                         dur_us=(req.t_done - tf) * k, tid=req.uid,
                         cat="request", args=args)

    # -- resilience: stalls, deadlines, budget exhaustion ---------------------
    def stall_slot(self, slot: int, ticks: int) -> None:
        """Freeze ``slot`` until the clock passes ``clock + ticks`` (the
        ``stall@T:K`` fault). The decode loop steps around a stalled slot:
        its position does not advance and no token is consumed. Repeated
        stalls extend the horizon, never shorten it."""
        self._stall_until[slot] = max(self._stall_until.get(slot, 0),
                                      self.clock + int(ticks))

    def _runnable(self, active) -> List[int]:
        return [s for s in active if self._stall_until.get(s, 0) <= self.clock]

    def _deadline_exceeded(self, req: Request, now: int) -> bool:
        if req.deadline_ticks is not None and \
                now - req.arrival >= req.deadline_ticks:
            return True
        if self._deadline_s is not None and req.wall_arrival is not None \
                and time.perf_counter() - req.wall_arrival > self._deadline_s:
            return True
        return False

    def _cancel(self, req: Request, reason: str) -> None:
        req.status = "timed_out"
        req.fail_reason = reason
        req.t_done = self.clock
        req.wall_done = time.perf_counter()
        req.resume = None
        self.timed_out.append(req)
        self._c_deadline.inc()
        if self.trace.enabled:
            self.trace.event("timed_out",
                             ts_us=self.clock * obs_trace.TICK_US, dur_us=0,
                             tid=req.uid, cat="request",
                             args={"uid": req.uid, "reason": reason})

    def _expire_deadlines(self, now: int) -> None:
        """Cancel queued and active requests past their deadline; an
        active slot's pages go back to the pool through ``sched.finish``,
        and a stall on the freed slot is cleared."""
        queue = self._queue()
        for req in [r for r in queue if self._deadline_exceeded(r, now)]:
            queue.remove(req)
            self._cancel(req, f"deadline exceeded at tick {now} while "
                              "queued (never admitted)")
        for s in self._active():
            req = self._slot_req(s)
            if self._deadline_exceeded(req, now):
                self._cancel(req, f"deadline exceeded at tick {now} "
                                  f"with {len(req.out)} tokens decoded")
                self._release(s)

    def _active(self) -> List[int]:
        if self.paged:
            return list(self.sched.active_slots)
        return [s for s in range(self.n_slots) if self.slot_req[s]]

    def _slot_req(self, slot: int) -> Request:
        return (self.sched.slot_req if self.paged else self.slot_req)[slot]

    def _release(self, slot: int) -> None:
        """Free a finished or cancelled request's slot (and its pages)."""
        if self.paged:
            self.sched.finish(slot)
        else:
            self.slot_req[slot] = None
        self._stall_until.pop(slot, None)

    def _revive_failed(self) -> None:
        """Requests a prior bounded run marked ``failed`` are still queued
        or resident: flip them back to live statuses."""
        for req in self._unfinished():
            if req.status == "failed":
                req.status = "queued" if any(req is q for q in
                                             self._queue()) else "active"
                req.fail_reason = None

    def _finish_run(self, max_steps: int, warn: bool) -> Dict[str, Any]:
        unfinished = self._unfinished()
        for req in unfinished:
            req.status = "failed"
            req.fail_reason = (
                f"run loop budget exhausted (max_steps={max_steps}) before "
                "completion; the request is still resident — call the run "
                "loop again to resume it")
        if unfinished and warn:
            warnings.warn(f"run_until_drained: max_steps={max_steps} "
                          f"exhausted with {len(unfinished)} requests still "
                          "queued or mid-decode (see the 'unfinished' list)")
        summary = {"done": len(self.completed)}
        for key, n in (("failed", len(unfinished)),
                       ("timed_out", len(self.timed_out)),
                       ("rejected", len(self.rejected))):
            if n:
                summary[key] = n
        return {"decode_steps": self._steps,
                "completed": list(self.completed),
                "unfinished": unfinished,
                "exhausted": bool(unfinished),
                "timed_out": list(self.timed_out),
                "rejected": list(self.rejected),
                "summary": summary}

    # -- paged path ---------------------------------------------------------
    def _admit_paged(self, now: Optional[int] = None) -> None:
        """Admit queued requests and run ONE batched prefill over them.
        While any active slot is parked for blocks, admission pauses so
        freed blocks reach the parked slots first."""
        if self._parked and self.sched.active_slots:
            return
        with self.trace.span("serve.admission", cat="engine"):
            admitted = self.sched.admit(now)
        if not admitted:
            return
        t_admit, wall_admit = self.clock, time.perf_counter()
        tokens, lengths, offsets, table = self.sched.build_prefill(admitted)
        pt = self._c_prefill
        for s, req in admitted:
            req.t_admit, req.wall_admit = t_admit, wall_admit
            req.status = "active"
            n = len(req.prompt if req.resume is None else req.resume)
            pt["tokens_total"].inc(n)
            pt["tokens_prefilled"].inc(n - int(offsets[s]))
            pt["tokens_shared"].inc(int(offsets[s]))
        self._c_disp["prefill"].inc()
        self.clock += 1
        # per-slot offsets switch prefill to the chunked-suffix path
        # (attends attached prefix pages in place); without sharing every
        # row starts at 0
        offs = self._tensor(offsets) if self.prefix_sharing else None
        with self.trace.span("serve.prefill_dispatch", cat="engine",
                             slots=len(admitted)):
            first, _, self.cache = self._prefill_fn(
                self.params, self.consts, self._tensor(tokens), self.cache,
                self._tensor(lengths), block_table=self._tensor(table),
                offsets=offs)
        with self.trace.span("serve.device_sync", cat="engine"):
            first = first.cpu().numpy()
        wall_first = time.perf_counter()
        self.sched.finish_prefill(admitted)
        for s, req in admitted:
            tok = int(first[s, 0])
            if req.resume is None:
                req.out = [tok]
                req.t_first = self.clock
                req.wall_first = wall_first
            else:
                # recompute after preemption: the re-prefilled context is
                # prompt + out, so this regenerates the trimmed token
                req.out.append(tok)
                req.resume = None
            if len(req.out) >= req.max_new_tokens:
                self._complete(req)
                self._release(s)

    def _evict_for_progress(self, active) -> None:
        """All active slots are parked: preempt the youngest request so the
        others can grow; fail loud when preemption is futile."""
        if len(active) == 1 and not self.sched.queue:
            raise RuntimeError(
                "paged KV pool too small for the active request: "
                f"{self.sched.blocks.free_blocks} free blocks and nothing "
                "left to evict — raise n_blocks or lower max_len")
        req = self.sched.preempt_youngest()
        total = len(req.prompt) + len(req.out)
        req.stalls = req.stalls + 1 if total <= req._progress_mark else 0
        req._progress_mark = total
        if req.stalls >= 3:
            raise RuntimeError(
                f"request {req.uid} evicted {req.stalls} times without "
                "progress: the pool cannot hold the working set — raise "
                "n_blocks or lower n_slots/max_len")

    def _step_paged(self, now: Optional[int] = None) -> int:
        if self.tick_hook is not None:
            self.tick_hook(self)
        self._expire_deadlines(self.clock if now is None else now)
        self._admit_paged(now)
        active = self.sched.active_slots
        if not active:
            return 0
        runnable = self._runnable(active)
        if not runnable:
            # every active slot is stalled: burn a tick anyway, so stalls
            # and deadlines expire instead of the loop spinning
            self.clock += 1
            return 0
        # grow pages for this step's write; slots the pool cannot hold are
        # parked and retry once other requests release blocks
        ready = set(self.sched.ensure_decode_blocks(runnable))
        self._parked = bool(set(runnable) - ready)
        if not ready:
            self._evict_for_progress(runnable)
            return 0
        # stalled and parked slots keep tok=0: their garbage K/V write
        # lands at a position their pos never advanced past, so their real
        # token overwrites it before it is first attended
        tok = np.zeros((self.n_slots, 1), np.int32)
        for s in ready:
            tok[s, 0] = self.sched.slot_req[s].out[-1]
        pos_vec = self.sched.decode_positions()
        t = self._c_kv
        t["steps"].inc()
        t["gather_tokens"].inc(self.n_slots * self.layout.view_len)
        t["live_tokens"].inc(sum(int(self.sched.pos[s]) + 1 for s in ready))
        t["resident_tokens"].inc(sum(self.sched.blocks.alloc_tokens(s)
                                     for s in ready))
        t["active_slots"].inc(len(ready))
        self._c_disp["decode"].inc()
        self.clock += 1
        with self.trace.span("serve.decode_dispatch", cat="engine",
                             slots=len(ready)):
            nxt, _, self.cache = self._decode_fn(
                self.params, self.consts, self._tensor(tok), self.cache,
                self._tensor(pos_vec),
                block_table=self._tensor(self.sched.table()))
        with self.trace.span("serve.device_sync", cat="engine"):
            nxt = nxt.cpu().numpy()
        self._steps += 1
        for s in sorted(ready):
            req = self.sched.slot_req[s]
            req.out.append(int(nxt[s, 0]))
            self.sched.advance(s)
            if len(req.out) >= req.max_new_tokens or \
                    int(self.sched.pos[s]) >= self.max_len - 1:
                self._complete(req)
                self._release(s)
        return len(ready)

    # -- contiguous path ------------------------------------------------------
    def _prefill(self, slot: int, req: Request) -> None:
        """Prefill by stepping the prompt through the (n_slots, 1) decode,
        one dispatch and one tick a token, token 0 in the other rows (so
        every row is written at that index). The last step's prediction is
        the request's first token."""
        self.pos[slot] = 0
        req.t_admit, req.wall_admit = self.clock, time.perf_counter()
        req.status = "active"
        nxt = None
        for t in req.prompt:
            tok = np.zeros((self.n_slots, 1), np.int32)
            tok[slot, 0] = t
            self._c_prefill["tokens_total"].inc()
            self._c_prefill["tokens_prefilled"].inc()
            self._c_disp["prefill"].inc()
            self.clock += 1
            with self.trace.span("serve.prefill_dispatch", cat="engine"):
                nxt, _, self.cache = self._decode_fn(
                    self.params, self.consts, self._tensor(tok), self.cache,
                    int(self.pos[slot]))
            self.pos[slot] += 1
        with self.trace.span("serve.device_sync", cat="engine"):
            req.out = [int(nxt[slot, 0])]
        req.t_first = self.clock
        req.wall_first = time.perf_counter()

    def _refill(self) -> None:
        for s in range(self.n_slots):
            if self.slot_req[s] is None and self.queue:
                req = self.queue.pop(0)
                self._prefill(s, req)
                if len(req.out) >= req.max_new_tokens:
                    self._complete(req)
                else:
                    self.slot_req[s] = req

    def _step_legacy(self) -> int:
        if self.tick_hook is not None:
            self.tick_hook(self)
        self._expire_deadlines(self.clock)
        self._refill()
        active = self._active()
        if not active:
            return 0
        runnable = self._runnable(active)
        if not runnable:
            self.clock += 1   # all stalled: burn a tick so stalls expire
            return 0
        tok = np.zeros((self.n_slots, 1), np.int32)
        for s in runnable:
            tok[s, 0] = self.slot_req[s].out[-1]
        # one index shared by the batch: the largest runnable position (a
        # lagging slot's K/V is written at that offset; the reference's
        # wart, which the paged path's per-slot vector removes)
        idx = int(max(self.pos[s] for s in runnable))
        self._c_disp["decode"].inc()
        self.clock += 1
        with self.trace.span("serve.decode_dispatch", cat="engine",
                             slots=len(runnable)):
            nxt, _, self.cache = self._decode_fn(
                self.params, self.consts, self._tensor(tok), self.cache, idx)
        with self.trace.span("serve.device_sync", cat="engine"):
            nxt = nxt.cpu().numpy()
        self._steps += 1
        for s in runnable:
            req = self.slot_req[s]
            req.out.append(int(nxt[s, 0]))
            self.pos[s] += 1
            if len(req.out) >= req.max_new_tokens or \
                    self.pos[s] >= self.max_len - 1:
                self._complete(req)
                self._release(s)
        return len(runnable)

    def step(self) -> int:
        """One engine step: admit (paged: one batched prefill; contiguous:
        a token-by-token prefill of each admitted prompt) and one batched
        decode over the runnable slots. Returns the number of slots
        stepped."""
        return self._step_paged() if self.paged else self._step_legacy()

    def _has_work(self) -> bool:
        if self.paged:
            return self.sched.has_work
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def _unfinished(self) -> List[Request]:
        return [self._slot_req(s) for s in self._active()] + \
            list(self._queue())

    def run_until_drained(self, max_steps: int = 10_000) -> Dict[str, Any]:
        """Step until every request finished or ``max_steps`` ran out;
        arrival stamps are ignored. Returns {"decode_steps",
        "completed", "unfinished", "exhausted", "timed_out", "rejected",
        "summary"}."""
        self._revive_failed()
        for _ in range(max_steps):
            if not self._has_work():
                break
            self.step()
        return self._finish_run(max_steps, warn=True)

    def run_stream(self, max_steps: int = 100_000) -> Dict[str, Any]:
        """Continuous batching: every iteration admits arrived requests
        into freed slots (one batched suffix-prefill), then runs one
        batched decode over all active slots; an idle engine fast-forwards
        its clock to the next arrival. Requires the paged engine. Returns
        the same dict as :meth:`run_until_drained`."""
        if not self.paged:
            raise ValueError("run_stream requires the paged engine "
                             "(paged=True): continuous admission recycles "
                             "slots through the block-table scheduler")
        self._revive_failed()
        for _ in range(max_steps):
            if not self.sched.has_work:
                break
            if not self.sched.active_slots:
                nxt = self.sched.next_arrival()
                if nxt is not None and nxt > self.clock:
                    self.clock = nxt      # idle engine: jump to next arrival
            self._step_paged(now=self.clock)
        return self._finish_run(max_steps, warn=False)
