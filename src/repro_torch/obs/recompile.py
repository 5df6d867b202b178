"""Recompile watchdog: the executable universe must stay ``plan.buckets()``.

A copy of the JAX package's ``repro.obs.recompile`` without its jit-cache
watching (the port has no jit caches).  PyTorch runs eagerly, so the serve
scheduler's "compile cache" is a first-use record per bucket key; the
watchdog counts first uses the way the JAX one counts compiles:

* ``expect(keys)`` declares the allowed universe (the plan's buckets);
  a first use of anything else is a violation the moment it happens.
* ``freeze()`` (after warm-up) declares the universe complete.
* Violations increment ``recompile_violations_total`` and warn;
  ``assert_clean()`` is the hard check for tests.
"""
from __future__ import annotations

import warnings
from typing import Iterable, Optional


class RecompileViolation(AssertionError):
    """Raised by ``assert_clean`` when unexpected first uses were observed."""


class RecompileWatchdog:
    """Tracks first uses against a declared executable universe."""

    def __init__(self, registry=None, name: str = "", project=None):
        self.name = name
        self.registry = registry
        self.expected: Optional[set] = None   # None = universe not declared
        self.frozen = False
        self.compiles: dict = {}              # key -> first-use count
        self.violations: list[dict] = []
        # maps a key to its membership key before the expected-set check —
        # the scheduler keys ("decode", bucket) / ("prefill_*", bucket, len)
        # while the universe is plain buckets
        self.project = project

    def expect(self, keys: Iterable) -> "RecompileWatchdog":
        """Declare the allowed universe (e.g. ``plan.buckets()``)."""
        self.expected = set(keys)
        return self

    def freeze(self) -> "RecompileWatchdog":
        """Declare warm-up complete: any further first use is a violation."""
        self.frozen = True
        return self

    def record_compile(self, key) -> bool:
        """Record one cache miss of ``key``; False when it is a violation."""
        self.compiles[key] = self.compiles.get(key, 0) + 1
        member = self.project(key) if self.project is not None else key
        reason = None
        if self.frozen:
            reason = "first use after freeze() — warm-up did not cover it"
        elif self.expected is not None and member not in self.expected:
            reason = "key outside the declared executable universe"
        elif self.compiles[key] > 1:
            reason = "duplicate first use of an already-seen key"
        if reason is None:
            return True
        rec = {"key": repr(key), "reason": reason,
               "count": self.compiles[key]}
        self.violations.append(rec)
        if self.registry is not None:
            self.registry.counter("recompile_violations_total",
                                  {"watchdog": self.name or "default"}).inc()
        warnings.warn(f"recompile watchdog"
                      f"{f' [{self.name}]' if self.name else ''}: "
                      f"{reason} ({rec['key']})", RuntimeWarning,
                      stacklevel=2)
        return False

    @property
    def violation_count(self) -> int:
        return len(self.violations)

    def report(self) -> dict:
        """Summary dict: keys seen, universe coverage, violations."""
        missing = (sorted(k for k in self.expected if k not in self.compiles)
                   if self.expected is not None else [])
        return {"compiles": {repr(k): v for k, v in
                             sorted(self.compiles.items(), key=repr)},
                "expected": (sorted(repr(k) for k in self.expected)
                             if self.expected is not None else None),
                "missing": [repr(k) for k in missing],
                "frozen": self.frozen,
                "violations": list(self.violations)}

    def assert_clean(self) -> None:
        """Hard check for tests: raise on any recorded violation."""
        if self.violations:
            raise RecompileViolation(
                f"{len(self.violations)} violation(s): {self.violations}")
