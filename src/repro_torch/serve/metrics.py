"""Serving telemetry: latency histograms + throughput counters (DESIGN.md §7).

The JAX package's ``repro.serve.metrics``, over the port's own registry.

All timestamps come from the server's injectable clock, so the same module
serves wall-clock benchmarking and virtual-clock deterministic replay.
Storage lives in one shared ``obs.MetricsRegistry``, so a serve run also
exports JSONL / Prometheus text and composes with the recompile watchdog.

Latency series come in **per-request** and **per-member** flavors — an
MC-dropout ensemble of size E is ONE request but E decode streams, and
folding both into one histogram double-counts:

* ``ttft`` / ``queue_delay``           — one sample per *request* (the
  earliest member's first token / the request's admission).
* ``ttft_member`` / ``queue_delay_member`` — one sample per ensemble
  *member* (tail behavior of individual streams).
* ``tpot`` is inherently per member per token.
* ``prompt_tokens`` counts prompt tokens actually *computed* (shared
  prefill: once per request); ``prompt_tokens_members`` counts the
  member-equivalent work a per-member prefill would have done, and
  ``prefill_shared_ratio = 1 - computed/member_equivalent`` is the
  fraction of prefill FLOPs the copy-on-write fork eliminated.
"""
from __future__ import annotations

from typing import Optional

from ..obs.registry import Histogram as _ObsHistogram
from ..obs.registry import MetricsRegistry, bucket_labels


class Histogram(_ObsHistogram):
    """Serving-facing histogram: exact below ``cap`` samples, reservoir
    (uniform subsample, exact count/mean/max) above it — bounded memory for
    long-running servers, bitwise-identical summaries for bounded runs."""

    def __init__(self, name: str, cap: int = _ObsHistogram.DEFAULT_CAP):
        super().__init__(name, (), cap)


def _registry_counter(metric_name: str, doc: str):
    """An int-like Telemetry attribute backed by a registry counter.

    The scheduler mutates telemetry with ``tel.decode_steps += 1``; a
    property pair keeps that API while the value lives in the registry
    (augmented assignment reads via the getter, writes the new total via
    the setter, which records the delta)."""

    def fget(self) -> int:
        return int(self.registry.counter(metric_name).value)

    def fset(self, value) -> None:
        c = self.registry.counter(metric_name)
        c.inc(value - c.value)   # Counter.inc raises if the value decreased

    return property(fget, fset, doc=doc)


class Telemetry:
    """Metric sink the scheduler/server/router record into (registry-backed).

    One Telemetry may be shared by several scheduler replicas (the
    multi-replica Router does exactly that): per-replica detail lives in
    labeled registry series (``replica`` label), aggregates in the plain
    counters below.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else MetricsRegistry()
        reg = self.registry
        # per-request latency series
        self.ttft = reg.histogram("serve_ttft_s")
        self.queue_delay = reg.histogram("serve_queue_delay_s")
        # per-member latency series
        self.ttft_member = reg.histogram("serve_ttft_member_s")
        self.queue_delay_member = reg.histogram("serve_queue_delay_member_s")
        self.tpot = reg.histogram("serve_tpot_s")

    tokens_generated = _registry_counter(
        "serve_tokens_generated_total", "generated tokens, all sequences")
    prompt_tokens = _registry_counter(
        "serve_prompt_tokens_total", "prompt tokens actually prefilled "
        "(shared prefill counts a request's prompt ONCE)")
    prompt_tokens_members = _registry_counter(
        "serve_prompt_tokens_members_total", "member-equivalent prompt "
        "tokens (what per-member prefill would have computed)")
    requests_completed = _registry_counter(
        "serve_requests_completed_total", "fully finished requests")
    requests_rejected = _registry_counter(
        "serve_requests_rejected_total", "admission-control rejections")
    requests_shed = _registry_counter(
        "serve_requests_shed_total", "queued lower-priority requests shed "
        "to admit more urgent work")
    members_completed = _registry_counter(
        "serve_members_completed_total", "finished ensemble members")
    decode_steps = _registry_counter(
        "serve_decode_steps_total", "batched decode steps executed")
    prefill_chunks = _registry_counter(
        "serve_prefill_chunks_total", "prefill chunks executed")
    # paged-KV accounting (synced from kv.PageStats by the scheduler)
    cow_forks = _registry_counter(
        "serve_kv_forks_total", "block-table forks (shared-prefill "
        "ensembles created)")
    cow_copies = _registry_counter(
        "serve_kv_cow_copies_total", "pages privatized copy-on-write")
    kv_pages_allocated = _registry_counter(
        "serve_kv_pages_allocated_total", "page allocations")
    kv_pages_freed = _registry_counter(
        "serve_kv_pages_freed_total", "pages returned to the pool")
    # router accounting
    router_affinity_hits = _registry_counter(
        "serve_router_affinity_hits_total", "requests routed to a replica "
        "with a warm executable for one of their buckets")
    router_affinity_misses = _registry_counter(
        "serve_router_affinity_misses_total", "requests routed by load "
        "only (no replica warm for their buckets)")

    # paper tie-in: FLOP cost of generated tokens relative to dense.  Each
    # token of a (dp, b) ensemble member counts 1/dp of a dense-FFN token.
    @property
    def ffn_flop_weighted_tokens(self) -> float:
        return self.registry.counter("serve_ffn_flop_weighted_tokens").value

    @property
    def bucket_tokens(self) -> dict:
        """Tokens decoded per pattern bucket, keyed ``"dp={dp},b={b}"``
        (derived view over the labeled registry counters)."""
        out = {}
        for m in self.registry.metrics():
            if m.name == "serve_bucket_tokens_total":
                lbl = dict(m.labels)
                out[f"dp={lbl['dp']},b={lbl['bias']}"] = int(m.value)
        return out

    # ------------------------------------------------------------------
    # per-replica labeled series
    # ------------------------------------------------------------------

    def record_compile_lookup(self, replica: str, hit: bool) -> None:
        name = ("serve_compile_cache_hits_total" if hit
                else "serve_compile_cache_misses_total")
        self.registry.counter(name, {"replica": replica}).inc()

    def set_page_gauges(self, replica: str, in_use: int, free: int,
                        num_pages: int, page_size: int) -> None:
        reg, lbl = self.registry, {"replica": replica}
        reg.gauge("serve_kv_pages_in_use", lbl).set(in_use)
        reg.gauge("serve_kv_pages_free", lbl).set(free)
        reg.gauge("serve_kv_pool_pages", lbl).set(num_pages)
        reg.gauge("serve_kv_page_size", lbl).set(page_size)

    def _labeled_view(self, names: dict[str, str]) -> dict:
        """{replica: {alias: value}} view over labeled counters/gauges."""
        out: dict[str, dict] = {}
        for m in self.registry.metrics():
            alias = names.get(m.name)
            if alias is not None and "replica" in dict(m.labels):
                rep = dict(m.labels)["replica"]
                out.setdefault(rep, {})[alias] = (
                    int(m.value) if float(m.value).is_integer()
                    else float(m.value))
        return out

    @property
    def compile_cache(self) -> dict:
        """Per-replica compile-cache hit accounting (+ derived hit rate)."""
        view = self._labeled_view({
            "serve_compile_cache_hits_total": "hits",
            "serve_compile_cache_misses_total": "misses"})
        for rec in view.values():
            h, m = rec.get("hits", 0), rec.get("misses", 0)
            rec.setdefault("hits", 0)
            rec.setdefault("misses", 0)
            rec["hit_rate"] = h / (h + m) if h + m else 0.0
        return view

    @property
    def kv_pages(self) -> dict:
        """Per-replica page-pool occupancy gauges."""
        return self._labeled_view({
            "serve_kv_pages_in_use": "in_use",
            "serve_kv_pages_free": "free",
            "serve_kv_pool_pages": "num_pages",
            "serve_kv_page_size": "page_size"})

    # ------------------------------------------------------------------
    def record_decode_tokens(self, dp: int, bias: int, n: int) -> None:
        reg = self.registry
        reg.counter("serve_tokens_generated_total").inc(n)
        reg.counter("serve_ffn_flop_weighted_tokens").inc(n / dp)
        reg.counter("serve_bucket_tokens_total",
                    bucket_labels(dp, bias)).inc(n)

    def mean_ffn_flop_fraction(self) -> float:
        """Mean per-token FFN FLOP fraction vs dense (1.0 = no dropout)."""
        if self.tokens_generated == 0:
            return 1.0
        return self.ffn_flop_weighted_tokens / self.tokens_generated

    def prefill_shared_ratio(self) -> float:
        """Fraction of member-equivalent prefill work eliminated by the
        shared-prefill CoW fork (0.0 = none shared, 1 - 1/E = full E-way
        sharing)."""
        if self.prompt_tokens_members == 0:
            return 0.0
        return 1.0 - self.prompt_tokens / self.prompt_tokens_members

    def snapshot(self, duration_s: Optional[float] = None) -> dict:
        snap = {
            "ttft": self.ttft.summary(),
            "ttft_member": self.ttft_member.summary(),
            "tpot": self.tpot.summary(),
            "queue_delay": self.queue_delay.summary(),
            "queue_delay_member": self.queue_delay_member.summary(),
            "tokens_generated": self.tokens_generated,
            "prompt_tokens": self.prompt_tokens,
            "prompt_tokens_members": self.prompt_tokens_members,
            "prefill_shared_ratio": self.prefill_shared_ratio(),
            "requests_completed": self.requests_completed,
            "requests_rejected": self.requests_rejected,
            "requests_shed": self.requests_shed,
            "members_completed": self.members_completed,
            "decode_steps": self.decode_steps,
            "prefill_chunks": self.prefill_chunks,
            "mean_ffn_flop_fraction": self.mean_ffn_flop_fraction(),
            "bucket_tokens": dict(self.bucket_tokens),
            "kv_pages": self.kv_pages,
            "cow_forks": self.cow_forks,
            "cow_copies": self.cow_copies,
            "compile_cache_hits": self.compile_cache,
            "router": {"affinity_hits": self.router_affinity_hits,
                       "affinity_misses": self.router_affinity_misses},
        }
        if duration_s is not None and duration_s > 0:
            snap["duration_s"] = float(duration_s)
            snap["throughput_tok_s"] = self.tokens_generated / duration_s
            snap["throughput_req_s"] = self.requests_completed / duration_s
        return snap
