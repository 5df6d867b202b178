"""The port's serving path held against the JAX package on identical inputs.

Weights come from the JAX ``init_lm`` + ``materialize`` (qwen2-1.5b SMOKE,
f32, 2 layers) with the qkv biases set non-zero (``materialize`` zeroes
them, which would hide a bias bug), bridged with ``params_from_jax``.  The
port runs its "cuda" and "fused" backends — on CPU tensors the kernel
wrappers take their plain versions — and the JAX side runs the "slice"
backend (the reference's pallas ≡ slice agreement keeps tier-1 fast).

Tolerance: f32 logits agree to 1e-5 absolute (logits here are O(0.1); the
two frameworks sum in different orders), greedy token streams exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.core.plan import BoundPlan as JBound
from repro.core.plan import DropoutPlan as JPlan
from repro.models import forward as jforward
from repro.models import init_lm as jax_init_lm
from repro.models import materialize as jax_materialize
from repro import serve as jserve
from repro.serve import engine as jengine

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.core.plan import BoundPlan, DropoutPlan
from repro_torch.models import forward
from repro_torch import serve
from repro_torch.serve import engine

ARCH = "qwen2_1_5b"
TOL = 1e-5
MAX_LEN = 32
BUCKETS = [(dp, b) for dp in (1, 2, 4, 8) for b in range(dp)]


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jax_smoke(ARCH), get_smoke(ARCH)
    params = jax_materialize(jax.random.PRNGKey(0), jax_init_lm(jcfg)[0])
    rng = np.random.default_rng(0)
    attn = params["stacks"][0]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(
            0.1 * rng.standard_normal(attn[name].shape), attn[name].dtype)
    np_params = jax.tree.map(np.asarray, params)
    return jcfg, params, cfg, params_from_jax(np_params, cfg, device="cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, tol=TOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a.astype(np.float64) - b).max())
    assert err <= tol, err


def _torch_cache(jcache):
    return {"layers": [{k: torch.from_numpy(np.array(v)) for k, v in g.items()}
                       for g in jcache["layers"]],
            "pos": jcache["pos"] if np.ndim(jcache["pos"]) == 0
            else torch.from_numpy(np.array(jcache["pos"])).long()}


def _rotated(params, b: int, nb: int):
    """JAX params whose FFN pattern blocks are rotated left by ``b``: the rdp
    pattern at bias 0 on them reads exactly the blocks — in the same order —
    that bias ``b`` reads on the originals (kept block j is (b + j·dp) mod
    nb).  One compiled JAX reference per dp then serves every bias."""
    if b == 0:
        return params
    stack = dict(params["stacks"][0])
    ffn = dict(stack["ffn"])
    for name, axis in (("w_up", 2), ("w_gate", 2), ("w_down", 1)):
        w = ffn[name]
        ffn[name] = jnp.roll(w, -b * (w.shape[axis] // nb), axis=axis)
    stack["ffn"] = ffn
    return {**params, "stacks": [stack]}


@pytest.fixture(scope="module")
def jax_engine_refs(models):
    """Per dp: jitted JAX prefill, two prefill_extend chunks, a ragged decode
    step (sequence 0 at position 12, sequence 1 at position 9), a decode
    step at position 12 and the train-path forward."""
    jcfg, _, cfg, _ = models
    fns = {}

    def get(dp):
        if dp in fns:
            return fns[dp]
        jpat = JBound(family="rdp" if dp > 1 else "identity", dp=dp, bias=0,
                      nb=cfg.pattern_nb, backend="slice")

        def reference(params, tok, feed):
            jl, jcache = jengine.prefill(jcfg, params, tok, MAX_LEN, pat=jpat)
            jc0 = jengine.init_cache(jcfg, 2, MAX_LEN)[0]
            jl1, jc1 = jengine.prefill_extend(jcfg, params, jc0, tok[:, :8],
                                              pat=jpat)
            jl2, jc2 = jengine.prefill_extend(jcfg, params, jc1, tok[:, 8:],
                                              pat=jpat)
            rag = {"layers": jcache["layers"],
                   "pos": jnp.asarray([12, 9], jnp.int32)}
            jlr, jcr = jengine.decode_step_ragged(jcfg, params, rag, feed,
                                                  pat=jpat)
            jld, _ = jengine.decode_step(jcfg, params, jcache, feed, pat=jpat)
            jlf, _ = jforward(jcfg, params, tok, jpat)
            return jl, jcache, jl1, jl2, jc2, rag, jlr, jcr, jld, jlf

        fns[dp] = jax.jit(reference)
        return fns[dp]

    return get


@pytest.mark.parametrize("bucket", BUCKETS, ids=lambda b: f"dp{b[0]}b{b[1]}")
def test_engine_matches_jax_per_bucket(models, jax_engine_refs, bucket):
    """prefill, prefill_extend (two chunks), decode_step_ragged (two
    sequences at different positions), decode_step and the train-path
    forward agree per (dp, b) bucket."""
    jcfg, jparams, cfg, params = models
    dp, b = bucket
    pats = [BoundPlan(family="rdp" if dp > 1 else "identity", dp=dp,
                      bias=b, nb=cfg.pattern_nb, backend=be)
            for be in (("cuda", "fused") if dp > 1 else ("cuda",))]
    rng = np.random.default_rng(dp * 10 + b)
    tok = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    jl, jcache, jl1, jl2, jc2, rag, jlr, jcr, jld, jlf = jax_engine_refs(dp)(
        _rotated(jparams, b, cfg.pattern_nb), tok, feed)

    ttok = torch.from_numpy(tok).long()
    for pat in pats:
        logits, cache = engine.prefill(cfg, params, ttok, MAX_LEN, pat=pat)
        _close(logits, jl)
        _close(cache["layers"][0]["k"], jcache["layers"][0]["k"])
        c0 = engine.init_cache(cfg, 2, MAX_LEN, device="cpu")
        l1, c1 = engine.prefill_extend(cfg, params, c0, ttok[:, :8], pat=pat)
        l2, c2 = engine.prefill_extend(cfg, params, c1, ttok[:, 8:], pat=pat)
        _close(l1, jl1)
        _close(l2, jl2)
        _close(c2["layers"][0]["v"], jc2["layers"][0]["v"])
        assert c2["pos"] == 12
        lr, cr = engine.decode_step_ragged(
            cfg, params, _torch_cache(rag), torch.from_numpy(feed).long(),
            pat=pat)
        _close(lr, jlr)
        _close(cr["layers"][0]["k"], jcr["layers"][0]["k"])
        assert cr["pos"].tolist() == [13, 10]
        ld, cd = engine.decode_step(cfg, params, cache,
                                    torch.from_numpy(feed).long(), pat=pat)
        _close(ld, jld)
        assert cd["pos"] == 13
        _close(forward(cfg, params, ttok, pat)[0], jlf)


def _trace(cfg):
    return jserve.poisson_trace(rate=200.0, n_requests=3, seed=3,
                                prompt_len=(8, 8), max_new=(3, 5),
                                vocab=cfg.vocab, ensemble=3,
                                ensemble_prob=0.75)


def _port_trace(trace):
    return [serve.Request(rid=r.rid, prompt=np.array(r.prompt),
                          max_new_tokens=r.max_new_tokens,
                          priority=r.priority, ensemble=r.ensemble,
                          seed=r.seed, arrival_time=r.arrival_time)
            for r in trace]


@pytest.fixture(scope="module")
def jax_replays(models):
    """The JAX scheduler's replay of the trace, shared and per-member."""
    jcfg, jparams, cfg, _ = models
    jplan = JPlan(family="rdp", dist=(0.3, 0.3, 0.0, 0.4), nb=cfg.pattern_nb)
    out = {}
    for shared in (True, False):
        sched = jserve.Scheduler(jcfg, jparams, capacity=8, max_len=MAX_LEN,
                                 prefill_chunk=4, plan=jplan,
                                 shared_prefill=shared)
        out[shared] = jserve.Server(sched, clock=jserve.VirtualClock()).run(
            _trace(jcfg))
    return jplan, out


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "member"])
@pytest.mark.parametrize("backend", ["cuda", "fused"])
def test_virtual_clock_replay_matches_jax_scheduler(models, jax_replays,
                                                    shared, backend):
    """Same plan, weights and trace: identical greedy token streams per
    member, first-token logits within 1e-5, identical prompt accounting
    and per-bucket token counts."""
    jcfg, _, cfg, params = models
    jplan, jout = jax_replays
    ref = jout[shared]
    plan = DropoutPlan(family="rdp", dist=jplan.dist, nb=cfg.pattern_nb,
                       backend=backend)
    sched = serve.Scheduler(cfg, params, capacity=8, max_len=MAX_LEN,
                            prefill_chunk=4, plan=plan, shared_prefill=shared,
                            device="cpu")
    out = serve.Server(sched, clock=serve.VirtualClock()).run(
        _port_trace(_trace(jcfg)))
    assert sorted(out["results"]) == sorted(ref["results"])
    n_patterned = 0
    for rid, members in ref["results"].items():
        got = {m["member"]: m for m in out["results"][rid]}
        for m in members:
            g = got[m["member"]]
            assert (g["dp"], g["bias"]) == (m["dp"], m["bias"])
            assert g["tokens"] == m["tokens"]
            _close(g["first_logits"], m["first_logits"])
            n_patterned += m["dp"] > 1
    assert n_patterned > 0          # the trace exercised the kernels' path
    t, rt = out["telemetry"], ref["telemetry"]
    for key in ("prompt_tokens", "prompt_tokens_members",
                "prefill_shared_ratio", "bucket_tokens", "tokens_generated",
                "requests_completed", "members_completed", "decode_steps"):
        assert t[key] == rt[key], key
    sched.obs.watchdog.assert_clean()


def test_aggregate_ensemble_matches_jax(models, jax_replays):
    """MC-dropout statistics over the same member outputs agree."""
    _, out = jax_replays
    for members in out[True]["results"].values():
        if len(members) > 1:
            a = serve.aggregate_ensemble(members)
            b = jserve.aggregate_ensemble(members)
            assert a["disagreement"] == b["disagreement"]
            np.testing.assert_allclose(a["p_mean"], b["p_mean"])


def test_warmup_covers_the_served_buckets(models):
    """After ``warmup`` over the plan's buckets, widths and chunk length,
    a frozen watchdog sees no first use while the trace is served."""
    jcfg, _, cfg, params = models
    plan = DropoutPlan(family="rdp", dist=(0.3, 0.3, 0.0, 0.4),
                       nb=cfg.pattern_nb, backend="cuda")
    sched = serve.Scheduler(cfg, params, capacity=8, max_len=MAX_LEN,
                            prefill_chunk=4, plan=plan, device="cpu")
    ran = sched.warmup(decode_widths=(1, 2, 4), chunk_lens=(4,))
    assert ran == 1 + 3 * len(plan.buckets())
    sched.obs.watchdog.freeze()
    sched.reset_telemetry()
    out = serve.Server(sched, clock=serve.VirtualClock()).run(
        _port_trace(_trace(jcfg)))
    assert out["telemetry"]["requests_completed"] == 3
    sched.obs.watchdog.assert_clean()
