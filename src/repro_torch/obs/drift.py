"""Online drift monitor: realized (dp, bias) draws vs the plan's target K.

A copy of the JAX package's ``repro.obs.drift``, with its own copy of
``core/equivalence.mc_tolerance`` (the port imports nothing of that package).

The SGD-based Search Algorithm (paper §4) produces a distribution K over
dropout periods; every training-time and serving-time pattern draw is
supposed to follow it.  ``DropoutPlan.sample`` is deterministic in
(seed, step), but the ROADMAP's online-distribution-search and
train-while-serving items will *mutate* the distribution live — at which
point a skew between the distribution the plan claims and the draws the
system actually executes silently biases both the speedup and the
accuracy-compensation math.

``DriftMonitor`` counts realized draws per ``(dp, bias)`` bucket and
compares empirical frequencies against the target probability
``K[dp] / dp`` (bias is uniform over ``{0..dp-1}``).  The verdict uses the
same binomial-CI tolerance as the equivalence oracles
(``core/equivalence.mc_tolerance``, z=5 — far below one expected flake per
sweep); chi-square and KL statistics are reported alongside for
dashboards.
"""
from __future__ import annotations

import math



def mc_tolerance(p_g: float, steps: int, z: float = 5.0) -> float:
    """Binomial-CI bound on the max per-unit MC deviation: each unit's
    empirical frequency over ``steps`` draws is a mean of Bernoulli(p_g)
    indicators, so z·sqrt(p_g(1-p_g)/steps) bounds the deviation at z
    sigmas.  A small floor covers the p_g→{0,1} edges."""
    var = max(p_g * (1.0 - p_g), 1e-4)
    return z * math.sqrt(var / max(steps, 1))


class DriftMonitor:
    """Compares empirical bucket-draw frequencies to a plan's target.

    ``observe(dp, bias)`` per draw (or ``observe_bound(bound)``), then
    ``report()`` / ``in_distribution()`` for the verdict.  Draws outside
    ``plan.buckets()`` are drift no matter their frequency.
    """

    def __init__(self, plan, registry=None, z: float = 5.0):
        self.plan = plan
        self.registry = registry
        self.z = z
        self.expected: dict[tuple[int, int], float] = {
            (dp, b): plan.dist[dp - 1] / dp for dp, b in plan.buckets()}
        self.counts: dict[tuple[int, int], int] = {}
        self.total = 0
        self.unexpected: dict[tuple[int, int], int] = {}

    # ---- observation -------------------------------------------------------
    def observe(self, dp: int, bias: int) -> None:
        key = (int(dp), int(bias))
        self.counts[key] = self.counts.get(key, 0) + 1
        self.total += 1
        if key not in self.expected:
            self.unexpected[key] = self.unexpected.get(key, 0) + 1
        if self.registry is not None:
            self.registry.counter(
                "pattern_draws_total", {"dp": dp, "bias": bias}).inc()

    def observe_bound(self, bound) -> None:
        """Record a ``BoundPlan`` draw (``plan.sample(step)``'s output)."""
        self.observe(bound.dp, bound.bias)

    def retarget(self, plan) -> None:
        """Point the monitor at a re-distributed plan (online search).

        Every resync changes the target K, so the draws observed under the
        old distribution are no longer evidence about the new one — the
        observation window resets along with the per-bucket targets
        (DESIGN.md §14).  The frozen-superset contract means the new
        bucket set is always a subset of the old universe.
        """
        self.plan = plan
        self.expected = {(dp, b): plan.dist[dp - 1] / dp
                         for dp, b in plan.buckets()}
        self.counts = {}
        self.total = 0
        self.unexpected = {}
        if self.registry is not None:
            self.registry.counter("pattern_drift_retargets_total").inc()

    # ---- verdict -----------------------------------------------------------
    def report(self, min_samples: int = 50) -> dict:
        """Per-bucket deviations + chi-square/KL + an overall verdict.

        verdict is one of:
          * ``"insufficient-samples"`` — fewer than ``min_samples`` draws;
          * ``"in-distribution"`` — every bucket's |empirical − target| is
            within its binomial-CI tolerance and no off-plan bucket was
            ever drawn;
          * ``"drift"`` — otherwise.
        """
        n = self.total
        per_bucket = {}
        max_dev = 0.0
        worst = None
        within = True
        chi2 = 0.0
        kl = 0.0
        for key, p in sorted(self.expected.items()):
            c = self.counts.get(key, 0)
            emp = c / n if n else 0.0
            tol = mc_tolerance(p, n, z=self.z)
            dev = abs(emp - p)
            if dev > max_dev:
                max_dev, worst = dev, key
            if dev > tol:
                within = False
            exp_c = p * n
            if exp_c > 0:
                chi2 += (c - exp_c) ** 2 / exp_c
            if emp > 0 and p > 0:
                kl += emp * math.log(emp / p)
            per_bucket[key] = {"target": p, "empirical": emp, "count": c,
                               "tolerance": tol, "deviation": dev}
        if self.unexpected:
            within = False
        if n < min_samples:
            verdict = "insufficient-samples"
        elif within:
            verdict = "in-distribution"
        else:
            verdict = "drift"
        rep = {
            "verdict": verdict,
            "samples": n,
            "max_abs_deviation": max_dev,
            "worst_bucket": worst,
            "chi_square": chi2,
            "kl_divergence": kl,
            "unexpected_buckets": {repr(k): v
                                   for k, v in sorted(self.unexpected.items())},
            "buckets": {f"dp={k[0]},b={k[1]}": v
                        for k, v in per_bucket.items()},
        }
        if self.registry is not None:
            self.registry.gauge("pattern_drift_max_abs_deviation").set(max_dev)
            self.registry.gauge("pattern_drift_in_distribution").set(
                1.0 if verdict == "in-distribution" else 0.0)
        return rep

    def in_distribution(self, min_samples: int = 50) -> bool:
        return self.report(min_samples)["verdict"] == "in-distribution"
