"""Metrics registry: counters / gauges / histograms behind one object.

A copy of the JAX package's framework-free ``repro.obs.registry`` (the port
imports nothing of that package).  Design (DESIGN.md §12):

* One ``MetricsRegistry`` per process (or per trainer/server — they are
  cheap).  Metrics are created lazily via ``counter()/gauge()/histogram()``
  and identified by ``(name, labels)`` where ``labels`` is a sorted tuple of
  ``(key, value)`` pairs — the canonical label set for pattern-bucketed
  metrics is ``bucket_labels(dp, bias, family, backend)``.
* The clock is injectable (same convention as ``serve/server.py``), so
  deterministic replays produce deterministic metric timestamps.
* Two exporters: ``to_jsonl()`` (one metric per line — machine-diffable
  snapshots) and ``to_prometheus()`` (text exposition format 0.0.4 — what a
  scraper would pull from a /metrics endpoint).
* ``Histogram`` is exact below ``reservoir_cap`` samples and switches to
  reservoir sampling (Vitter's Algorithm R, deterministic seed) above it,
  so long-running servers hold bounded memory while short bounded runs —
  every existing bench — keep exact percentiles.
"""
from __future__ import annotations

import json
import time
from typing import Iterable, Optional

import numpy as np

Labels = tuple  # sorted tuple of (key, value) pairs


def _freeze_labels(labels: Optional[dict]) -> Labels:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def bucket_labels(dp: int, bias: int, family: str = "",
                  backend: str = "") -> dict:
    """The canonical label set for pattern-bucketed metrics."""
    labels = {"dp": dp, "bias": bias}
    if family:
        labels["family"] = family
    if backend:
        labels["backend"] = backend
    return labels


class Counter:
    """Monotonically increasing count (requests, tokens, violations)."""

    kind = "counter"

    def __init__(self, name: str, labels: Labels = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        self.value += n

    def snapshot(self) -> dict:
        return {"value": self.value}


class Gauge:
    """Last-set value (FLOPs of a compiled module, queue depth, ...)."""

    kind = "gauge"

    def __init__(self, name: str, labels: Labels = ()):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Sample distribution with exact-then-reservoir storage.

    Exact below ``cap`` recorded values; above it, Vitter's Algorithm R
    keeps a uniform random subset of size ``cap`` (deterministic RNG seeded
    from the metric name, so snapshots are reproducible).  ``summary()``
    returns the same schema the serving Telemetry always exposed:
    count / mean / p50 / p90 / p95 / max.  ``count``, ``mean`` and ``max``
    are tracked exactly regardless of sampling; percentiles come from the
    reservoir once it is active.
    """

    kind = "histogram"
    DEFAULT_CAP = 65536

    def __init__(self, name: str, labels: Labels = (),
                 cap: int = DEFAULT_CAP):
        if cap < 1:
            raise ValueError(f"histogram cap must be >= 1, got {cap}")
        self.name = name
        self.labels = labels
        self.cap = cap
        self._values: list[float] = []
        self._count = 0              # exact, even past the cap
        self._sum = 0.0              # exact
        self._max = 0.0              # exact
        self._rng = np.random.default_rng(
            abs(hash((name, labels))) % (2 ** 32))

    def record(self, value: float) -> None:
        value = float(value)
        self._count += 1
        self._sum += value
        if self._count == 1 or value > self._max:
            self._max = value
        if len(self._values) < self.cap:
            self._values.append(value)
        else:
            # Algorithm R: keep each of the n seen values with prob cap/n
            j = int(self._rng.integers(0, self._count))
            if j < self.cap:
                self._values[j] = value

    @property
    def count(self) -> int:
        return self._count

    @property
    def sampled(self) -> bool:
        """Whether the reservoir is active (summary percentiles are
        estimates over a uniform subsample rather than exact)."""
        return self._count > self.cap

    def summary(self) -> dict:
        if self._count == 0:
            return {"count": 0, "mean": 0.0, "p50": 0.0, "p90": 0.0,
                    "p95": 0.0, "max": 0.0}
        v = np.asarray(self._values, np.float64)
        return {
            "count": int(self._count),
            "mean": float(self._sum / self._count),
            "p50": float(np.percentile(v, 50)),
            "p90": float(np.percentile(v, 90)),
            "p95": float(np.percentile(v, 95)),
            "max": float(self._max),
        }

    def snapshot(self) -> dict:
        return self.summary()


class MetricsRegistry:
    """Lazily-created, label-keyed metrics with pluggable exporters."""

    def __init__(self, clock=None):
        self._metrics: dict[tuple[str, Labels], object] = {}
        self._clock = clock

    def now(self) -> float:
        """Registry timestamp — the injectable clock, else wall time."""
        return self._clock.now() if self._clock is not None else time.time()

    # ---- creation ----------------------------------------------------------
    def _get(self, cls, name: str, labels: Optional[dict], **kw):
        key = (name, _freeze_labels(labels))
        m = self._metrics.get(key)
        if m is None:
            m = cls(name, key[1], **kw)
            self._metrics[key] = m
        elif not isinstance(m, cls):
            raise TypeError(
                f"metric {name!r}{dict(key[1])} already registered as "
                f"{m.kind}, not {cls.kind}")
        return m

    def counter(self, name: str, labels: Optional[dict] = None) -> Counter:
        """Get-or-create the counter ``name`` with ``labels``."""
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: Optional[dict] = None) -> Gauge:
        """Get-or-create the gauge ``name`` with ``labels``."""
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, labels: Optional[dict] = None,
                  cap: int = Histogram.DEFAULT_CAP) -> Histogram:
        """Get-or-create the histogram ``name`` with ``labels``."""
        return self._get(Histogram, name, labels, cap=cap)

    # ---- views -------------------------------------------------------------
    def metrics(self) -> Iterable:
        """All registered metrics, in deterministic (name, labels) order."""
        return [self._metrics[k] for k in sorted(self._metrics)]

    def snapshot(self) -> list[dict]:
        """One dict per metric: name / kind / labels / value-or-summary."""
        return [{"name": m.name, "kind": m.kind, "labels": dict(m.labels),
                 **m.snapshot()} for m in self.metrics()]

    # ---- exporters ---------------------------------------------------------
    def to_jsonl(self) -> str:
        """One JSON object per line per metric (machine-diffable)."""
        return "\n".join(json.dumps(rec, sort_keys=True)
                         for rec in self.snapshot()) + "\n"

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4).

        Histograms export as ``<name>_count`` / ``<name>_sum`` (mean·count)
        plus quantile-labeled gauge lines — the summary-metric convention.
        """
        out = []
        seen_types: set[str] = set()
        for m in self.metrics():
            pname = m.name.replace(".", "_").replace("-", "_")
            if pname not in seen_types:
                seen_types.add(pname)
                out.append(f"# TYPE {pname} "
                           f"{'summary' if m.kind == 'histogram' else m.kind}")
            base_lbl = dict(m.labels)
            if m.kind == "histogram":
                s = m.summary()
                out.append(f"{pname}_count{_prom_labels(base_lbl)} "
                           f"{s['count']}")
                out.append(f"{pname}_sum{_prom_labels(base_lbl)} "
                           f"{s['mean'] * s['count']}")
                for q, k in (("0.5", "p50"), ("0.9", "p90"), ("0.95", "p95")):
                    out.append(f"{pname}"
                               f"{_prom_labels({**base_lbl, 'quantile': q})} "
                               f"{s[k]}")
            else:
                out.append(f"{pname}{_prom_labels(base_lbl)} {m.value}")
        return "\n".join(out) + "\n"


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"
