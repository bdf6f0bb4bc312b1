"""Context-manager spans exporting Chrome trace-event JSON (loadable in
``chrome://tracing`` / Perfetto) — a copy of ``repro.obs.trace`` without
its ``jax.profiler`` hook, stdlib only.

Two timebases coexist in exported traces:

* **wall spans** (:meth:`Trace.span`) on the monotonic clock — engine
  phases (admission, prefill dispatch, decode dispatch, device sync).
* **tick spans** (:meth:`Trace.event` with explicit ``ts``/``dur``) laid
  out by the caller — the serve engine plots per-request lifecycles at 1
  engine tick = :data:`TICK_US` microseconds, so span geometry reproduces
  tick TTFT exactly.

A disabled recorder (``Trace(enabled=False)``) turns ``span()`` into a
shared no-op context manager.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

#: tick-timeline scale: 1 engine clock tick = 1000us in exported traces
TICK_US = 1000

_REQUIRED_KEYS = {"name", "ph", "ts", "pid", "tid"}


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_trace", "name", "cat", "tid", "args", "_t0")

    def __init__(self, trace: "Trace", name: str, cat: str, tid: Optional[int],
                 args: Optional[Dict[str, Any]]):
        self._trace = trace
        self.name = name
        self.cat = cat
        self.tid = tid
        self.args = args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        tr = self._trace
        tr._append({
            "name": self.name, "cat": self.cat or "span", "ph": "X",
            "ts": (self._t0 - tr._epoch_ns) / 1e3,
            "dur": (t1 - self._t0) / 1e3,
            "pid": tr.pid,
            "tid": self.tid if self.tid is not None else _tid(),
            **({"args": self.args} if self.args else {}),
        })
        return False


def _tid() -> int:
    return threading.get_ident() & 0x7FFFFFFF


class Trace:
    """Span recorder. All mutation goes through ``_append`` (locked);
    events accumulate in memory until :meth:`export`."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.pid = os.getpid()
        self._epoch_ns = time.perf_counter_ns()
        self._events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    # -- recording --------------------------------------------------------
    def span(self, name: str, cat: str = "", tid: Optional[int] = None,
             **args):
        """Context manager: one complete ("X") event on the wall clock."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, tid, args or None)

    def instant(self, name: str, cat: str = "", **args) -> None:
        if not self.enabled:
            return
        self._append({
            "name": name, "cat": cat or "instant", "ph": "i", "s": "t",
            "ts": (time.perf_counter_ns() - self._epoch_ns) / 1e3,
            "pid": self.pid, "tid": _tid(),
            **({"args": args} if args else {}),
        })

    def event(self, name: str, *, ts_us: float, dur_us: float,
              tid: int, cat: str = "",
              args: Optional[Dict[str, Any]] = None) -> None:
        """Append a complete event at an EXPLICIT position — the caller
        owns the timeline (the serve engine lays request lifecycles out on
        the tick clock at :data:`TICK_US` us/tick)."""
        if not self.enabled:
            return
        self._append({
            "name": name, "cat": cat or "span", "ph": "X",
            "ts": float(ts_us), "dur": float(dur_us),
            "pid": self.pid, "tid": int(tid),
            **({"args": args} if args else {}),
        })

    def thread_name(self, tid: int, label: str) -> None:
        """Metadata event: label a tid lane (e.g. one lane per request)."""
        if not self.enabled:
            return
        self._append({"name": "thread_name", "ph": "M", "ts": 0.0,
                      "pid": self.pid, "tid": int(tid),
                      "args": {"name": label}})

    def _append(self, ev: Dict[str, Any]) -> None:
        with self._lock:
            self._events.append(ev)

    # -- export -----------------------------------------------------------
    @property
    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    def to_dict(self) -> Dict[str, Any]:
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}

    def export(self, path: str) -> int:
        """Write the Chrome trace container; returns the event count."""
        doc = self.to_dict()
        with open(path, "w") as f:
            json.dump(doc, f, separators=(",", ":"))
            f.write("\n")
        return len(doc["traceEvents"])


def validate(doc) -> int:
    """Validate a trace document (or bare event list) against the Chrome
    trace-event schema subset this module emits: every event carries
    name/ph/ts/pid/tid, ``ts``/``dur`` are finite non-negative numbers,
    complete ("X") events carry ``dur``, metadata ("M") events carry
    ``args``. Raises ValueError on the first violation; returns the event
    count (> 0 — an empty trace is a wiring bug, not a trace)."""
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(events, list) or not events:
        raise ValueError("trace has no traceEvents list (or it is empty)")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i}: not an object: {ev!r}")
        missing = _REQUIRED_KEYS - ev.keys()
        if missing:
            raise ValueError(f"event {i} ({ev.get('name')!r}): missing "
                             f"required keys {sorted(missing)}")
        for k in ("ts", "dur"):
            if k in ev:
                v = ev[k]
                if not isinstance(v, (int, float)) or v < 0 or \
                        v != v or v in (float("inf"),):
                    raise ValueError(f"event {i} ({ev['name']!r}): {k}={v!r}"
                                     " not a finite non-negative number")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(f"event {i} ({ev['name']!r}): complete event "
                             "without dur")
        if ev["ph"] == "M" and "args" not in ev:
            raise ValueError(f"event {i} ({ev['name']!r}): metadata event "
                             "without args")
        if "args" in ev and not isinstance(ev["args"], dict):
            raise ValueError(f"event {i} ({ev['name']!r}): args not an "
                             "object")
    return len(events)


def validate_file(path: str) -> int:
    """JSON-load ``path`` and :func:`validate` it (CI smoke entry point)."""
    with open(path) as f:
        return validate(json.load(f))
