"""Metrics registry (counters, gauges, fixed-bucket histograms) with
labeled instruments, ``snapshot()`` and a JSONL sink — a copy of
``repro.obs.metrics``, stdlib only.

Instruments are host-side accumulators: every recorded value is coerced to
a Python float at the call site (``float(t)`` on a one-element tensor
waits for the device right there), so record around device work, never
inside it.

* :class:`Counter` — monotone totals (dispatches, tokens, requests).
* :class:`Gauge` — last-written point-in-time values (queue depth).
* :class:`Histogram` — fixed-bucket distributions (TTFT); only per-bucket
  counts and the sum are kept, and with unit-width integer buckets
  (:func:`tick_buckets`) percentiles of integer data are exact.

Any instrument can carry labels: ``registry.counter("serve.dispatches")
.labels(phase="prefill")`` returns a child; ``snapshot()`` flattens
children as ``name{k=v}``.
"""
from __future__ import annotations

import bisect
import json
import math
import threading
import time
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple


def _as_float(v, what: str = "recorded value") -> float:
    """Coerce to a host float; anything float() rejects raises TypeError."""
    try:
        return float(v)
    except (TypeError, ValueError, RuntimeError) as e:
        raise TypeError(
            f"{what} of type {type(v).__name__} cannot be coerced to a "
            "host float: obs instruments record concrete host values"
        ) from e


def _fmt_labels(labels: Tuple[Tuple[str, str], ...]) -> str:
    return "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


class _Instrument:
    """Shared label-family machinery. A parent instrument doubles as the
    family; ``labels(**kv)`` returns (get-or-create) the child keyed by
    the sorted label items."""

    kind = "instrument"

    def __init__(self, name: str, help: str = "",
                 label_items: Tuple[Tuple[str, str], ...] = ()):
        self.name = name
        self.help = help
        self.label_items = label_items
        self._children: Dict[Tuple[Tuple[str, str], ...], _Instrument] = {}
        self._lock = threading.Lock()

    def labels(self, **kv) -> "_Instrument":
        items = tuple(sorted((k, str(v)) for k, v in kv.items()))
        with self._lock:
            child = self._children.get(items)
            if child is None:
                child = self._make_child(items)
                self._children[items] = child
            return child

    def _make_child(self, items):
        raise NotImplementedError

    def reset(self) -> None:
        for c in self._children.values():
            c.reset()

    def _emit(self, out: Dict[str, dict]) -> None:
        """Flatten self + children into ``snapshot()`` rows."""
        if self._children:
            for items, c in sorted(self._children.items()):
                out[self.name + _fmt_labels(items)] = c._row()
            return
        out[self.name] = self._row()

    def _row(self) -> dict:
        raise NotImplementedError


class Counter(_Instrument):
    """Monotone total. ``value`` reads back as int when integral so
    counter views format/compare like the plain-int dicts they replace."""

    kind = "counter"

    def __init__(self, name, help="", label_items=()):
        super().__init__(name, help, label_items)
        self._v = 0.0

    def _make_child(self, items):
        return Counter(self.name, self.help, items)

    def inc(self, n=1) -> None:
        n = _as_float(n, f"counter {self.name} increment")
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self._v += n

    @property
    def value(self):
        v = self._v + sum(c._v for c in self._children.values())
        return int(v) if float(v).is_integer() else v

    def reset(self) -> None:
        self._v = 0.0
        super().reset()

    def _row(self):
        return {"type": "counter", "value": self.value}


class Gauge(_Instrument):
    """Last-written value (None until first ``set``)."""

    kind = "gauge"

    def __init__(self, name, help="", label_items=()):
        super().__init__(name, help, label_items)
        self._v: Optional[float] = None

    def _make_child(self, items):
        return Gauge(self.name, self.help, items)

    def set(self, v) -> None:
        self._v = _as_float(v, f"gauge {self.name} value")

    @property
    def value(self) -> Optional[float]:
        return self._v

    def reset(self) -> None:
        self._v = None
        super().reset()

    def _row(self):
        return {"type": "gauge", "value": self._v}


#: default histogram bounds: exponential-ish latency grid in ms
DEFAULT_MS_BUCKETS = (0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
                      100.0, 200.0, 500.0, 1e3, 2e3, 5e3, 1e4, 3e4, 6e4,
                      3e5)


def ms_buckets() -> Tuple[float, ...]:
    """Wall-latency bucket bounds (ms), ~2-5x steps from 50us to 5min."""
    return DEFAULT_MS_BUCKETS


def tick_buckets(limit: int = 512) -> Tuple[int, ...]:
    """Unit-width integer bounds [0, limit): percentiles of integer data
    ≤ limit-1 (engine clock ticks) are exact — every sample in a bucket
    sits exactly at the bucket bound."""
    return tuple(range(limit))


class Histogram(_Instrument):
    """Fixed-bucket histogram: per-bucket counts + sum, no samples.

    ``bounds`` are ascending inclusive upper bounds; values above the last
    bound land in an implicit +inf overflow bucket. :meth:`percentile`
    reconstructs order statistics by placing each sample at its bucket's
    upper bound (overflow samples at the last finite bound) and applies
    numpy's linear interpolation between order statistics — exact for
    integer data on :func:`tick_buckets`, within one bucket width
    otherwise."""

    kind = "histogram"

    def __init__(self, name, buckets: Sequence[float], help="",
                 label_items=()):
        super().__init__(name, help, label_items)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError(f"histogram {name}: needs >= 1 bucket bound")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1 = overflow
        self._sum = 0.0

    def _make_child(self, items):
        return Histogram(self.name, self.bounds, self.help, items)

    def observe(self, v) -> None:
        v = _as_float(v, f"histogram {self.name} observation")
        with self._lock:
            self._counts[bisect.bisect_left(self.bounds, v)] += 1
            self._sum += v

    @property
    def count(self) -> int:
        return sum(self._counts) + sum(c.count for c in self._children.values())

    @property
    def sum(self) -> float:
        return self._sum + sum(c.sum for c in self._children.values())

    def _merged_counts(self):
        counts = list(self._counts)
        for c in self._children.values():
            for i, n in enumerate(c._merged_counts()):
                counts[i] += n
        return counts

    def _value_of_rank(self, k: int, counts, total: int) -> float:
        """Representative value of the k-th order statistic (0-based)."""
        k = min(max(k, 0), total - 1)
        cum = 0
        for i, n in enumerate(counts):
            cum += n
            if k < cum:
                return self.bounds[min(i, len(self.bounds) - 1)]
        return self.bounds[-1]

    def percentile(self, q: float) -> float:
        """q in [0, 100]; NaN on an empty histogram."""
        counts = self._merged_counts()
        total = sum(counts)
        if total == 0:
            return math.nan
        rank = (total - 1) * (q / 100.0)
        lo, hi = math.floor(rank), math.ceil(rank)
        v_lo = self._value_of_rank(lo, counts, total)
        v_hi = self._value_of_rank(hi, counts, total)
        return v_lo + (rank - lo) * (v_hi - v_lo)

    def reset(self) -> None:
        self._counts = [0] * (len(self.bounds) + 1)
        self._sum = 0.0
        super().reset()

    def _row(self):
        counts = self._counts
        buckets = [[self.bounds[i], c] for i, c in enumerate(counts[:-1])
                   if c]
        if counts[-1]:
            buckets.append(["+Inf", counts[-1]])
        total = sum(counts)
        row = {"type": "histogram", "count": total,
               "sum": round(self._sum, 6), "buckets": buckets}
        if total:
            row["p50"] = self.percentile(50)
            row["p99"] = self.percentile(99)
        return row


class MetricView(Mapping):
    """Read-only dict-shaped view over live instruments — the
    backward-compat shim for code that read the serve engine's counter
    dicts (``eng.dispatches["prefill"]``, ``dict(eng.kv_traffic)``).
    Reads always reflect the live registry; writes are impossible (reset
    through ``Registry.reset()`` / ``ServeEngine.reset_metrics()``)."""

    def __init__(self, instruments: Dict[str, _Instrument]):
        self._m = dict(instruments)

    def __getitem__(self, k):
        return self._m[k].value

    def __iter__(self) -> Iterator[str]:
        return iter(self._m)

    def __len__(self) -> int:
        return len(self._m)

    def __repr__(self) -> str:
        return f"MetricView({dict(self)!r})"


class Registry:
    """Name → instrument store. ``counter``/``gauge``/``histogram`` are
    get-or-create (re-registration with a conflicting type or bucket
    layout raises); ``snapshot()`` returns a plain-JSON dict and
    ``write_jsonl`` appends one snapshot line to a file."""

    def __init__(self):
        self._instruments: Dict[str, _Instrument] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, **kw) -> _Instrument:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, **kw)
                self._instruments[name] = inst
                return inst
        if not isinstance(inst, cls):
            raise TypeError(f"instrument {name!r} already registered as "
                            f"{inst.kind}, not {cls.kind}")
        return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None,
                  help: str = "") -> Histogram:
        h = self._get(name, Histogram,
                      buckets=buckets if buckets is not None
                      else DEFAULT_MS_BUCKETS, help=help)
        if buckets is not None and \
                h.bounds != tuple(sorted(float(b) for b in buckets)):
            raise ValueError(f"histogram {name!r} already registered with "
                             f"different buckets")
        return h

    def get(self, name: str) -> Optional[_Instrument]:
        return self._instruments.get(name)

    def snapshot(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        with self._lock:
            insts = list(self._instruments.values())
        for inst in insts:
            inst._emit(out)
        return out

    def reset(self) -> None:
        """Zero every instrument (bench warmup / between measurements).
        Instrument objects stay registered — cached handles stay valid."""
        with self._lock:
            insts = list(self._instruments.values())
        for inst in insts:
            inst.reset()

    def to_prometheus_text(self) -> str:
        """Render the registry in the Prometheus text exposition format
        (version 0.0.4) — what a ``/metrics`` endpoint would serve.

        Per instrument family: ``# HELP`` / ``# TYPE`` header, then one
        sample per child (or the parent itself when unlabeled). Metric
        names are sanitized (``[^a-zA-Z0-9_:]`` → ``_``; a leading digit
        gets a ``_`` prefix), label values escape backslash, quote, and
        newline per the spec, and labels render in sorted-key order
        (``label_items`` is already sorted at creation). Histograms emit
        cumulative ``_bucket{le=...}`` series ending at ``le="+Inf"``
        plus ``_sum`` and ``_count``; unset gauges are skipped."""
        def san(name: str) -> str:
            s = "".join(ch if (ch.isascii() and (ch.isalnum() or ch in "_:"))
                        else "_" for ch in name)
            return "_" + s if s[:1].isdigit() else s

        def esc_label(v: str) -> str:
            return (v.replace("\\", "\\\\").replace('"', '\\"')
                    .replace("\n", "\\n"))

        def esc_help(v: str) -> str:
            return v.replace("\\", "\\\\").replace("\n", "\\n")

        def labelstr(items, extra=()) -> str:
            parts = [f'{san(k)}="{esc_label(str(v))}"'
                     for k, v in (*items, *extra)]
            return "{" + ",".join(parts) + "}" if parts else ""

        def num(v) -> str:
            f = float(v)
            if f != f:
                return "NaN"
            if f == math.inf:
                return "+Inf"
            if f == -math.inf:
                return "-Inf"
            return repr(int(f)) if f.is_integer() else repr(f)

        lines = []
        with self._lock:
            insts = sorted(self._instruments.items())
        for _, inst in insts:
            name = san(inst.name)
            if inst.help:
                lines.append(f"# HELP {name} {esc_help(inst.help)}")
            lines.append(f"# TYPE {name} {inst.kind}")
            children = ([inst._children[k] for k in sorted(inst._children)]
                        if inst._children else [inst])
            for ch in children:
                ls = ch.label_items
                if isinstance(ch, Counter):
                    lines.append(f"{name}{labelstr(ls)} {num(ch._v)}")
                elif isinstance(ch, Gauge):
                    if ch._v is not None:
                        lines.append(f"{name}{labelstr(ls)} {num(ch._v)}")
                elif isinstance(ch, Histogram):
                    cum = 0
                    for bound, n in zip(ch.bounds, ch._counts):
                        cum += n
                        lines.append(f"{name}_bucket"
                                     f"{labelstr(ls, (('le', num(bound)),))}"
                                     f" {cum}")
                    cum += ch._counts[-1]
                    lines.append(f"{name}_bucket"
                                 f"{labelstr(ls, (('le', '+Inf'),))} {cum}")
                    lines.append(f"{name}_sum{labelstr(ls)} {num(ch._sum)}")
                    lines.append(f"{name}_count{labelstr(ls)} {cum}")
        return "\n".join(lines) + ("\n" if lines else "")

    def write_jsonl(self, path: str, extra: Optional[dict] = None) -> None:
        """Append one ``{"ts": unix_s, ...extra, "metrics": snapshot}``
        line. One line per call — the caller owns the cadence (the trainer
        writes one per log interval; the serve launcher one per run)."""
        rec = {"ts": round(time.time(), 3)}
        if extra:
            rec.update(extra)
        rec["metrics"] = self.snapshot()
        with open(path, "a") as f:
            f.write(json.dumps(rec, separators=(",", ":"),
                               sort_keys=True) + "\n")


_REGISTRY = Registry()


def get_registry() -> Registry:
    """The process-wide default registry."""
    return _REGISTRY
