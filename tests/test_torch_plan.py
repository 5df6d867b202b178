"""The port's DropoutPlan and Alg. 1 search against the JAX package.

* ``sample(step)`` draws are bitwise equal per (seed, step): both sides use
  numpy's ``SeedSequence([seed, step])``;
* ``for_layer`` biases are equal under every bias policy and override;
* ``buckets()`` are equal;
* Alg. 1 fed the same initial logits ``v0`` agrees on K to 1e-5 (float32
  SGD in both; only the summation order differs).
"""
import numpy as np
import pytest

from repro.core import plan as jplan_mod
from repro.core import search as jsearch

from repro_torch.core import plan as plan_mod
from repro_torch.core import search

DISTS = [(0.2, 0.3, 0.0, 0.5), (0.25, 0.25, 0.0, 0.25, 0.0, 0.0, 0.0, 0.25),
         (1.0,)]


def _pair(dist, nb=8, seed=0, policy="layer_offset", overrides=()):
    return (plan_mod.DropoutPlan(family="rdp", dist=dist, nb=nb, seed=seed,
                                 bias_policy=policy,
                                 layer_overrides=overrides),
            jplan_mod.DropoutPlan(family="rdp", dist=dist, nb=nb, seed=seed,
                                  bias_policy=policy,
                                  layer_overrides=overrides))


@pytest.mark.parametrize("dist", DISTS, ids=["dp124", "dp1248", "dense"])
def test_sample_draws_and_buckets_bitwise(dist):
    for seed in (0, 7, 123):
        port, ref = _pair(dist, seed=seed)
        assert port.buckets() == ref.buckets()
        assert port.support() == ref.support()
        for step in range(200):
            a, b = port.sample(step), ref.sample(step)
            assert (a.dp, a.bias) == (b.dp, b.bias), (seed, step)
        assert (port.reseed(5).sample(3).bucket
                == (ref.reseed(5).sample(3).dp, ref.reseed(5).sample(3).bias))


@pytest.mark.parametrize("policy", ["layer_offset", "fixed", "layer_hash"])
def test_for_layer_biases_equal(policy):
    overrides = {3: {"bias": 1}, 5: {"off": True}}
    port, ref = _pair((0.2, 0.3, 0.0, 0.5), policy=policy,
                      overrides=overrides)
    for dp, b in port.buckets():
        pb, rb = port.bind(dp, b), ref.bind(dp, b)
        for layer in range(12):
            pl, rl = pb.for_layer(layer), rb.for_layer(layer)
            assert (pl.dp, pl.bias, pl.family) == (rl.dp, rl.bias, rl.family)
            assert pb.layer_bias(layer) == rb.layer_bias(layer)


def test_plan_validation_mirrors_reference():
    with pytest.raises(ValueError):
        plan_mod.BoundPlan(family="rdp", dp=2, bias=2, nb=8)
    with pytest.raises(ValueError):
        plan_mod.BoundPlan(family="rdp", dp=3, bias=0, nb=8)
    with pytest.raises(ValueError):
        plan_mod.DropoutPlan(family="rdp", dist=(0.5, 0.5), backend="palas")
    with pytest.raises(plan_mod.BucketSupersetViolation):
        plan_mod.DropoutPlan(family="rdp", dist=(0.5, 0.5, 0.0, 0.0),
                             nb=8).with_dist((0.5, 0.0, 0.0, 0.5))
    assert set(plan_mod.FAMILIES["rdp"].backends) == {
        "slice", "gather", "cuda", "fused"}


@pytest.mark.parametrize("target,nb", [(0.3, 8), (0.5, 128), (0.7, 128)])
def test_search_matches_reference_given_v0(target, nb):
    allowed = tuple(plan_mod.P.valid_periods(nb, 8))
    v0 = (0.01 * np.random.default_rng(1).standard_normal(8)).astype(
        np.float32)
    cfg = search.SearchConfig(target_rate=target, n_patterns=8, lam1=0.85,
                              lam2=0.15, allowed=allowed)
    jcfg = jsearch.SearchConfig(target_rate=target, n_patterns=8, lam1=0.85,
                                lam2=0.15, allowed=allowed)
    _, k, loss, _ = search.resume_search(v0, cfg)
    _, jk, jloss, _ = jsearch.resume_search(v0, jcfg)
    np.testing.assert_allclose(k, jk, atol=1e-5, rtol=0)
    assert abs(loss - jloss) <= 1e-5
    assert abs(search.expected_rate(k) - jsearch.expected_rate(jk)) <= 1e-5


def test_build_plan_searches_a_valid_distribution():
    plan = plan_mod.build_plan("rdp", 0.5, nb=128, dp_max=8, block=70,
                               backend="cuda")
    assert plan.support() == [1, 2, 4, 8]
    assert abs(plan.expected_rate() - 0.5) < 0.05
    assert all(plan.bind(dp, b).backend == "cuda" for dp, b in plan.buckets())


def test_drift_monitor_accepts_the_plans_own_draws():
    """obs.DriftMonitor (the port's copy) over sample(step) draws: the
    plan's own draws are in distribution and every bucket is known."""
    from repro_torch.obs import Observability

    port, _ = _pair((0.2, 0.3, 0.0, 0.5), seed=11)
    obs = Observability.create(plan=port)
    for step in range(2000):
        obs.drift.observe_bound(port.sample(step))
    rep = obs.drift.report()
    assert rep["verdict"] == "in-distribution", rep
    assert not rep["unexpected_buckets"]
    assert "pattern_draws_total" in obs.registry.to_prometheus()
