"""Observability shared by serving (and later training).

* ``registry``  — ``MetricsRegistry``: counters / gauges / histograms with
  JSONL and Prometheus-text exporters (a copy of the JAX package's).
* ``trace``     — ``SpanTracer``: Chrome-trace JSONL spans (a copy).
* ``recompile`` — ``RecompileWatchdog``: the bucket universe must stay
  ``plan.buckets()``; here it counts first uses of bucket keys.
* ``drift``     — ``DriftMonitor``: realized (dp, bias) draws vs the plan.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .drift import DriftMonitor
from .recompile import RecompileWatchdog
from .registry import (Counter, Gauge, Histogram, MetricsRegistry,
                       bucket_labels)
from .trace import SpanTracer


@dataclasses.dataclass
class Observability:
    """One bundle of the four obs pieces (the scheduler builds one)."""

    registry: MetricsRegistry
    tracer: SpanTracer
    watchdog: RecompileWatchdog
    drift: Optional[DriftMonitor] = None

    @classmethod
    def create(cls, *, trace_path: Optional[str] = None, clock=None,
               plan=None) -> "Observability":
        """Tracing on iff ``trace_path`` is given; the drift monitor
        attaches iff a ``DropoutPlan`` is given."""
        registry = MetricsRegistry(clock=clock)
        return cls(
            registry=registry,
            tracer=SpanTracer(path=trace_path, enabled=trace_path is not None,
                              clock=clock),
            watchdog=RecompileWatchdog(registry=registry),
            drift=DriftMonitor(plan, registry=registry)
            if plan is not None else None,
        )


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "bucket_labels",
    "SpanTracer", "RecompileWatchdog", "DriftMonitor", "Observability",
]
