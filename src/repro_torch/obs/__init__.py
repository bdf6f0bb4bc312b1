"""Observability for the port: metrics registry and span tracing, copies
of ``repro.obs`` (stdlib only). The serve engine's dispatch and traffic
counters and TTFT histograms are registry instruments; a ``Trace`` records
wall spans per engine phase and tick-timeline request lifecycles."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,  # noqa: F401
                                     MetricView, Registry, get_registry,
                                     ms_buckets, tick_buckets)
from repro_torch.obs.trace import TICK_US, Trace, validate  # noqa: F401
