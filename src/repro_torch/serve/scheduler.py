"""Slot scheduler for the paged serve engine, a copy of
``repro.serve.scheduler``: arrival-gated admission, shared-prefix attach,
batched (suffix-)prefill shaping, per-slot decode positions and the block
lifecycle. Pure host-side bookkeeping; it only builds the int32 inputs of
the engine's two step functions.

* **Admission** (:meth:`Scheduler.admit`): queued requests that have
  arrived move into free slots while their prompt fits the block pool.
  With ``prefix_sharing``, admission first attaches the longest resident
  block-aligned prefix of the prompt read-only (refcount++); only the
  remaining suffix is prefilled. Suffixes are padded to a shared
  power-of-two bucket; rows of slots mid-decode get nulled table rows, so
  their writes land in the null block.
* **Decode shaping** (:meth:`Scheduler.decode_positions`): each active slot
  steps at its own position; idle slots sit at 0 with a nulled row.
* **Block lifecycle**: blocks are allocated as positions cross block
  boundaries and released when a request finishes or is preempted
  (:meth:`Scheduler.evict`); shared prefix blocks return to the pool only
  when their last reader releases them.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.obs import metrics as obs_metrics
from repro_torch.serve.kv import BlockTable, PagedLayout, blocks_for


def _bucket(n: int, minimum: int) -> int:
    """Smallest power-of-two ≥ n (and ≥ minimum) — bounds prefill
    recompiles at log2(max_len) program shapes."""
    b = max(minimum, 1)
    while b < n:
        b *= 2
    return b


def _ptoks(req) -> List[int]:
    """The tokens a (re-)admission must prefill: the original prompt, or
    prompt + generated-so-far for a preempted request (``resume``)."""
    return req.prompt if getattr(req, "resume", None) is None else req.resume


class Scheduler:
    """Owns slots, the request queue, and the block table."""

    def __init__(self, n_slots: int, max_len: int, layout: PagedLayout,
                 *, min_prefill_bucket: int = 8,
                 prefix_sharing: bool = False,
                 obs: Optional[obs_metrics.Registry] = None):
        self.n_slots = n_slots
        self.max_len = max_len
        self.blocks = BlockTable(layout, n_slots)
        self.pos = np.zeros(n_slots, np.int32)       # next write position
        self.slot_req: List[Optional[object]] = [None] * n_slots
        self.queue: List[object] = []
        self.min_prefill_bucket = min_prefill_bucket
        self.prefix_sharing = prefix_sharing
        # tokens the shared-prefix attach skipped prefilling for, per slot
        # (engine folds them into its prefill traffic model at admission)
        self._shared = np.zeros(n_slots, np.int32)
        # scheduler-level obs: the engine passes its registry so queue
        # pressure, admission batch shaping, and preemptions land in the
        # same snapshot as the engine counters
        self.obs = obs if obs is not None else obs_metrics.Registry()
        self._g_queue = self.obs.gauge(
            "serve.sched.queue_depth", help="queued requests after admit")
        self._h_admit = self.obs.histogram(
            "serve.sched.admitted_batch", buckets=range(1, n_slots + 1),
            help="requests admitted per batched prefill")
        self._c_preempt = self.obs.counter("serve.sched.preemptions")

    # -- admission ------------------------------------------------------------
    def submit(self, req) -> None:
        self.queue.append(req)

    @property
    def active_slots(self) -> List[int]:
        return [s for s in range(self.n_slots) if self.slot_req[s] is not None]

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)

    def next_arrival(self) -> Optional[int]:
        """Earliest arrival tick among queued requests (None when the
        queue is empty or untimestamped) — the stream loop fast-forwards
        its clock here when every slot is idle."""
        ts = [getattr(r, "arrival", 0) or 0 for r in self.queue]
        return min(ts) if ts else None

    def admit(self, now: Optional[int] = None) -> List[Tuple[int, object]]:
        """Move queued, ARRIVED requests into free slots: attach any
        resident shared prefix read-only, then allocate the rest of the
        prompt's blocks. Stops at the first request the pool cannot hold
        or that has not arrived yet (FIFO, no reordering — queue order is
        arrival order) — it stays queued and retries next step. Prompt-
        length validation is the engine's job (submit time)."""
        admitted = []
        for s in range(self.n_slots):
            if self.slot_req[s] is not None or not self.queue:
                continue
            req = self.queue[0]
            if now is not None and (getattr(req, "arrival", 0) or 0) > now:
                break
            toks = _ptoks(req)
            plen = len(toks)
            shared = 0
            if self.prefix_sharing:
                # cap at plen - 1: at least one suffix token must run
                # through the model — its logits score the first output
                chain = self.blocks.match_prefix(toks, plen - 1)
                need_fresh = blocks_for(plen, self.blocks.layout.block_len) \
                    - len(chain)
                if need_fresh > self.blocks.free_blocks:
                    break
                shared = self.blocks.attach(s, chain)
            elif not self.blocks.can_fit(plen):
                break
            self.queue.pop(0)
            self.blocks.ensure(s, plen)
            self._shared[s] = shared
            self.slot_req[s] = req
            self.pos[s] = 0
            admitted.append((s, req))
        if admitted:
            self._h_admit.observe(len(admitted))
        self._g_queue.set(len(self.queue))
        return admitted

    def build_prefill(self, admitted) -> Tuple[np.ndarray, np.ndarray,
                                               np.ndarray, np.ndarray]:
        """(tokens (n_slots, bucket), lengths (n_slots,), offsets
        (n_slots,), table rows) for one batched SUFFIX prefill over the
        admitted slots: row s carries the prompt tokens from
        ``offsets[s]`` (the shared-prefix length, 0 without sharing) on,
        and the forward runs at true positions offset + i. Non-admitted
        rows carry zero tokens, length 1, offset 0, and a nulled table
        row. The bucket is capped at view_len; padding positions beyond
        offset + bucket are clamped INSIDE kv.scatter (never out of
        bounds, never into a shared block)."""
        bucket = min(_bucket(max(len(_ptoks(r)) - int(self._shared[s])
                                 for s, r in admitted),
                             self.min_prefill_bucket),
                     self.blocks.layout.view_len)
        tokens = np.zeros((self.n_slots, bucket), np.int32)
        lengths = np.ones(self.n_slots, np.int32)
        offsets = np.zeros(self.n_slots, np.int32)
        for s, req in admitted:
            toks = _ptoks(req)[int(self._shared[s]):]
            tokens[s, :len(toks)] = toks
            lengths[s] = len(toks)
            offsets[s] = self._shared[s]
        table = self.blocks.rows([s for s, _ in admitted])
        return tokens, lengths, offsets, table

    def finish_prefill(self, admitted) -> None:
        """Advance admitted slots past their prompts and publish each
        prompt's whole-block prefixes for future sharers."""
        for s, req in admitted:
            toks = _ptoks(req)
            self.pos[s] = len(toks)
            if self.prefix_sharing:
                self.blocks.register_prefix(s, toks, len(toks) - 1)

    # -- decode ---------------------------------------------------------------
    def ensure_decode_blocks(self, slots) -> List[int]:
        """Grow each slot's pages to hold one more position; returns the
        slots that actually have room (pool exhaustion parks the rest —
        they retry next step after other requests release blocks)."""
        ready = []
        for s in slots:
            if self.blocks.ensure(s, int(self.pos[s]) + 1):
                ready.append(s)
        return ready

    def decode_positions(self) -> np.ndarray:
        """(n_slots,) per-slot write positions; idle slots report 0 (their
        table row is all null block — writes are discarded)."""
        return self.pos.copy()

    def table(self) -> np.ndarray:
        return self.blocks.table

    def advance(self, slot: int) -> None:
        self.pos[slot] += 1

    def finish(self, slot: int) -> None:
        """Release the slot and drop its reference on every block it
        held (shared blocks stay resident for their other readers)."""
        self.blocks.release(slot)
        self.slot_req[slot] = None
        self.pos[slot] = 0
        self._shared[slot] = 0

    def evict(self, slot: int):
        """Preempt ``slot``: free its blocks and hand its request back to
        the engine (which requeues it for recompute)."""
        self._c_preempt.inc()
        req = self.slot_req[slot]
        self.blocks.release(slot)
        self.slot_req[slot] = None
        self.pos[slot] = 0
        self._shared[slot] = 0
        return req

    def preempt_youngest(self):
        """Evict the most recently submitted active request, fold its
        progress into ``resume`` (minus the not-yet-consumed last output
        token — greedy decode regenerates it exactly on readmission) and
        put it back at the queue head. Returns the request so the caller
        can apply its no-progress policy. All queue/slot/block mutations
        stay inside the scheduler."""
        victim = max(self.active_slots, key=lambda s: self.slot_req[s].uid)
        req = self.evict(victim)
        req.resume = req.prompt + req.out[:-1]
        req.out = req.out[:-1]
        self.queue.insert(0, req)
        return req
