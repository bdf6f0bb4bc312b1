"""Deterministic fault-injection harness, a copy of
``repro.resilience.chaos`` (numpy only).

A :class:`ChaosEngine` parses a spec ``kind@when[:arg]``, comma-separated,
into a schedule of faults that fire on the trainer's step counter or the
serve engine's tick clock:

=================  =====================================================
``kill@N``         raise :class:`ChaosKill` (``SystemExit`` with exit
                   code 43) before step N runs: the relaunch must
                   recover from it
``nonfinite@N``    poison step N's loss with a NaN scale
                   (``batch["chaos_scale"]``), so non-finite values run
                   through the real backward into the gradients
``ckpt_corrupt@N`` flip bytes in the newest checkpoint's ``arrays.npz``
                   at step N (restore must detect it and fall back to an
                   intact step)
``data_corrupt@N`` overwrite batch tokens with out-of-range values at
                   step N (host-side validation must drop the batch)
``straggler@N:MS`` sleep MS milliseconds inside step N's timed window
                   (the step watchdog must flag it)
``stall@T:K``      serve: freeze one active slot for K engine ticks from
                   tick T (deadlines and the drain must cope)
=================  =====================================================

Every fault fires at most once per engine (``@N`` is the first
opportunity at or after N), so steps re-run after a rollback are not
poisoned again. Random choices (which slot stalls, which rows and bytes
are corrupted) draw from a numpy generator keyed on (seed, fault time),
the reference's draws exactly. Injections are counted on the bound
registry as ``resilience.faults_injected{kind=...}``.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

KINDS = ("kill", "nonfinite", "ckpt_corrupt", "data_corrupt", "straggler",
         "stall")


class ChaosKill(SystemExit):
    """Injected process kill. A ``SystemExit``, so no ``except Exception``
    up the stack swallows it; its exit code differs from the trainer's
    preemption exit (42), so a harness tells a drill from a preemption."""

    EXIT_CODE = 43

    def __init__(self, step: int):
        super().__init__(self.EXIT_CODE)
        self.step = step


@dataclass(frozen=True)
class Fault:
    kind: str
    at: int                      # step (train) or tick (serve)
    arg: Optional[int] = None    # ms (straggler) / ticks (stall)


def corrupt_npz(path: str, *, seed: int = 0, n_bytes: int = 16) -> int:
    """Flip ``n_bytes`` bytes in the middle of ``path`` in place (XOR 0xFF
    at an offset drawn from ``seed``); returns the offset."""
    size = os.path.getsize(path)
    rng = np.random.default_rng(np.uint64(seed))
    # stay away from the zip's end-of-central-directory record at the tail
    off = int(rng.integers(size // 4, max(size // 4 + 1, size // 2)))
    with open(path, "r+b") as f:
        f.seek(off)
        raw = f.read(n_bytes)
        f.seek(off)
        f.write(bytes(b ^ 0xFF for b in raw))
    return off


class ChaosEngine:
    """The fault schedule and its fire-once state for one run."""

    def __init__(self, faults: List[Fault], *, seed: int = 0):
        for f in faults:
            if f.kind not in KINDS:
                raise ValueError(f"unknown fault kind {f.kind!r}: expected "
                                 f"one of {KINDS}")
        self.faults = list(faults)
        self.seed = seed
        self._fired: set = set()
        self._c_injected = None   # obs counter family, set by bind()

    @classmethod
    def parse(cls, spec: str, *, seed: int = 0) -> "ChaosEngine":
        """Parse ``"kind@when[:arg],..."`` (e.g. ``"kill@3"``,
        ``"nonfinite@5,straggler@4:50"``)."""
        faults = []
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            try:
                kind, rest = part.split("@", 1)
                arg = None
                if ":" in rest:
                    rest, a = rest.split(":", 1)
                    arg = int(a)
                faults.append(Fault(kind.strip(), int(rest), arg))
            except ValueError as e:
                raise ValueError(
                    f"bad chaos fault {part!r}: expected kind@when[:arg] "
                    f"with kind in {KINDS}") from e
        if not faults:
            raise ValueError(f"empty chaos spec {spec!r}")
        return cls(faults, seed=seed)

    def bind(self, obs) -> None:
        """Count injections on ``obs`` (a ``repro_torch.obs.metrics``
        Registry) as ``resilience.faults_injected{kind=...}``."""
        self._c_injected = obs.counter(
            "resilience.faults_injected",
            help="chaos faults injected, by kind")

    # -- internals ----------------------------------------------------------
    def _pending(self, kind: str, now: int) -> List[Fault]:
        return [f for f in self.faults
                if f.kind == kind and f not in self._fired and f.at <= now]

    def _fire(self, fault: Fault) -> None:
        self._fired.add(fault)
        if self._c_injected is not None:
            self._c_injected.labels(kind=fault.kind).inc()

    def _rng(self, at: int) -> np.random.Generator:
        return np.random.default_rng(np.uint64(self.seed * 1_000_003 + at))

    # -- train-side hooks ---------------------------------------------------
    @property
    def wants_poison(self) -> bool:
        """True when a ``nonfinite`` fault is scheduled: the trainer then
        carries ``batch["chaos_scale"]`` on every step, and only its value
        turns NaN."""
        return any(f.kind == "nonfinite" for f in self.faults)

    def train_hook(self, step: int, *, ckpt_dir: Optional[str] = None) -> None:
        """Top-of-loop faults: process kill and checkpoint corruption.
        ``ckpt_corrupt`` stays pending until a published checkpoint
        exists."""
        if ckpt_dir is not None:
            for f in self._pending("ckpt_corrupt", step):
                npz = _latest_ckpt_npz(ckpt_dir)
                if npz is None:
                    continue
                corrupt_npz(npz, seed=self.seed + f.at)
                self._fire(f)
        for f in self._pending("kill", step):
            self._fire(f)
            raise ChaosKill(step)

    def poison_scale(self, step: int) -> float:
        """NaN when a ``nonfinite`` fault fires at ``step``, else 1.0."""
        for f in self._pending("nonfinite", step):
            self._fire(f)
            return float("nan")
        return 1.0

    def corrupt_batch(self, step: int, batch: Dict[str, np.ndarray]
                      ) -> Dict[str, np.ndarray]:
        """Overwrite a stripe of tokens with out-of-range values; the
        trainer's host-side validation must reject the batch."""
        for f in self._pending("data_corrupt", step):
            self._fire(f)
            toks = np.array(batch["tokens"], copy=True)
            rng = self._rng(f.at)
            rows = rng.integers(0, toks.shape[0],
                                size=max(1, toks.shape[0] // 2))
            toks[rows, : max(1, toks.shape[1] // 4)] = -(7 + f.at)
            batch = dict(batch)
            batch["tokens"] = toks
        return batch

    def straggle(self, step: int) -> None:
        """Sleep inside the step's timed window (what the watchdog sees)."""
        for f in self._pending("straggler", step):
            self._fire(f)
            time.sleep((f.arg or 100) / 1e3)

    # -- serve-side hook ----------------------------------------------------
    def serve_hook(self, engine) -> None:
        """Per-tick hook (``ServeEngine(tick_hook=chaos.serve_hook)``):
        ``stall@T:K`` freezes one active slot, drawn from the keyed
        generator, for K ticks at the first tick ≥ T with a slot active."""
        for f in self._pending("stall", engine.clock):
            if engine.paged:
                slots = engine.sched.active_slots
            else:
                slots = [s for s in range(engine.n_slots)
                         if engine.slot_req[s] is not None]
            if not slots:
                continue      # stays pending until a slot is active
            slot = int(slots[int(self._rng(f.at).integers(len(slots)))])
            engine.stall_slot(slot, f.arg or 8)
            self._fire(f)


def _latest_ckpt_npz(ckpt_dir: str) -> Optional[str]:
    """The newest published checkpoint's arrays.npz (None before the
    first)."""
    try:
        names = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return None
    steps = []
    for d in names:
        if d.startswith("step_") and not d.endswith(".tmp"):
            try:
                steps.append(int(d[5:]))
            except ValueError:
                pass
    if not steps:
        return None
    path = os.path.join(ckpt_dir, f"step_{max(steps):08d}", "arrays.npz")
    return path if os.path.exists(path) else None
