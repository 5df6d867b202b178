"""The port's tile-based dropout (TDP) held against the JAX package.

* ``tdp_mask`` and ``tdp_kept_row_tile`` bitwise, at the SMOKE, a 64-tile
  and the full qwen2-1.5b TDP geometry (``pattern_nb`` 12: tile 128);
* the plain versions of kernels 8–10 (``tdp_matmul``, ``tdp_dgrad``,
  ``tdp_wgrad``) against the JAX Pallas kernels run ``interpret=True``
  (and ``ref.tdp_matmul_ref`` against the JAX oracle),
  every bias, dp 2/4/8 at tile 64, dp 3/6 at K 384, and N 320 (5
  tile-columns: the dgrad's mask-multiply fallback); ``expand_tdp_wgrad``
  against JAX's; ``TdpMatmul`` gradients against ``jax.vjp`` of
  ``tdp_matmul_vjp``;
* ``TdpFamily.apply_ffn`` on "slice" and "cuda" against the JAX family on
  "slice" and "pallas";
* ``lm_loss`` gradients of qwen2-1.5b SMOKE (f32, nb 8: tile 8) for every
  (dp, b) bucket against ``jax.grad(lm_loss)``, dropped ``w_up`` tiles
  exactly zero; ``prefill`` / ``decode_step_ragged`` logits per bucket, a
  replayed ``Server`` stream and 8 ``Trainer`` steps against the JAX ones;
* the refusals: ``gather``/``fused`` with tdp, dp not dividing K/tile,
  the full config's ``pattern_nb`` 128, and a non-CPU tensor never falling
  back to the plain version.

Inputs are numpy draws with O(1) outputs, so f32 agreement is held to 1e-5
absolute (the frameworks sum in different orders); masks, indices, bucket
draws and token streams bitwise.  ``test_cuda_tdp_kernels_match_plain``
holds the built kernels against the plain versions on the card; it skips
without a GPU.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import AxisType

from repro import serve as jserve
from repro.configs import get_config as jax_config
from repro.configs import get_smoke as jax_smoke
from repro.core import patterns as JP
from repro.core.plan import FAMILIES as JFAMILIES
from repro.core.plan import BoundPlan as JBound
from repro.core.plan import DropoutPlan as JPlan
from repro.core.plan import build_plan as jax_build_plan
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.kernels import ref as jref
from repro.kernels.autodiff import expand_tdp_wgrad as j_expand
from repro.kernels.autodiff import tdp_matmul_vjp as j_tdp_vjp
from repro.kernels.tdp_matmul import tdp_matmul as j_tdp_matmul
from repro.kernels.tdp_matmul_bwd import tdp_dgrad as j_tdp_dgrad
from repro.kernels.tdp_matmul_bwd import tdp_wgrad as j_tdp_wgrad
from repro.models import init_lm as jax_init_lm
from repro.models import materialize as jax_materialize
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim import optimizers as jopt
from repro.serve import engine as jengine
from repro.train.distributed import DistributedTrainer as JaxTrainer
from repro.train.distributed import TrainerConfig as JaxTrainerConfig

from repro_torch import kernels as K
from repro_torch import serve
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, get_smoke
from repro_torch.core import patterns as P
from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import BoundPlan, DropoutPlan, build_plan
from repro_torch.data import SyntheticLMData
from repro_torch.kernels import autodiff, ops, ref, tdp_matmul_bwd
from repro_torch.models import lm_loss
from repro_torch.optim import AdamW
from repro_torch.serve import engine
from repro_torch.train import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves

TOL = 1e-5
ARCH = "qwen2_1_5b"
MAX_LEN = 32


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, tol=TOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a.astype(np.float64) - b).max())
    assert err <= tol, err


def _draw(rng, *shape, fan=1):
    return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)


# --------------------------------------------------------------------------
# (a) pattern algebra
# --------------------------------------------------------------------------

# (rows, cols, tile): SMOKE w_up (nb 8), a 64-tile, qwen2-1.5b at nb 12
GEOMETRIES = {"smoke": (64, 256, 8), "tile64": (384, 320, 64),
              "full": (1536, 8960, 128)}


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_tdp_mask_and_kept_row_tiles_bitwise(geom):
    rows, cols, tile = GEOMETRIES[geom]
    tr, tc = rows // tile, cols // tile
    j = np.arange(tc)[None, :]
    for dp in P.valid_periods(tr, 8):
        slots = np.arange(tr // dp)[:, None]
        for b in range(dp):
            mask = P.tdp_mask(rows, cols, dp, b, tile)
            np.testing.assert_array_equal(
                mask.numpy(), np.asarray(JP.tdp_mask(rows, cols, dp, b, tile)))
            kept = P.tdp_kept_row_tile(torch.from_numpy(j),
                                       torch.from_numpy(slots), dp, b)
            np.testing.assert_array_equal(
                kept.numpy(),
                np.asarray(JP.tdp_kept_row_tile(j, slots, dp, b, tr)))
            # every tile-column keeps exactly its tr/dp listed row-tiles
            grid = mask[::tile, ::tile].bool()
            assert bool((grid.sum(0) == tr // dp).all())
            assert bool(grid[kept, torch.from_numpy(j)].all())


# --------------------------------------------------------------------------
# (b) kernels 8-10: plain versions, expansion, autograd
# --------------------------------------------------------------------------

# (K, N, tile, dp): dp 2/4/8 at tile 64; dp 3/6 at K 384; N 320 has 5
# tile-columns, so only dp 1 divides them and the dgrad takes the fallback
KERNEL_CASES = [(512, 256, 64, 2), (512, 256, 64, 4), (512, 512, 64, 8),
                (384, 384, 64, 3), (384, 384, 64, 6), (256, 320, 64, 2),
                (256, 320, 64, 4)]


@pytest.mark.parametrize("kd,n,tile,dp", KERNEL_CASES,
                         ids=[f"K{c[0]}N{c[1]}t{c[2]}dp{c[3]}"
                              for c in KERNEL_CASES])
def test_plain_tdp_kernels_match_jax_kernels(kd, n, tile, dp):
    m = 6
    rng = np.random.default_rng(kd + n + dp)
    a, w = _draw(rng, m, kd), _draw(rng, kd, n, fan=kd)
    dc = _draw(rng, m, n, fan=n // dp)
    t = torch.from_numpy
    dgrad_kernel = (n // tile) % dp == 0
    for b in range(dp):
        jb = jnp.int32(b)
        kw = dict(dp=dp, tile=tile, interpret=True)
        for scale in (False, True):
            _close(K.tdp_matmul(t(a), t(w), b, dp=dp, tile=tile, scale=scale),
                   j_tdp_matmul(a, w, jb, scale=scale, **kw))
            _close(ref.tdp_matmul_ref(t(a), t(w), dp, b, tile=tile,
                                      scale=scale),
                   jref.tdp_matmul_ref(a, w, dp, b, tile=tile, scale=scale))
            dwc = K.tdp_wgrad(t(a), t(dc), b, dp=dp, tile=tile, scale=scale)
            jdwc = j_tdp_wgrad(a, dc, jb, scale=scale, **kw)
            _close(dwc, jdwc)
            if dgrad_kernel:
                _close(K.tdp_dgrad(t(dc), t(w), b, dp=dp, tile=tile,
                                   scale=scale),
                       j_tdp_dgrad(dc, w, jb, scale=scale, **kw))
            else:
                with pytest.raises(ValueError, match="does not divide"):
                    K.tdp_dgrad(t(dc), t(w), b, dp=dp, tile=tile)
        # the expansion places each slot exactly (bitwise: a pure layout op)
        full = autodiff.expand_tdp_wgrad(dwc, kd, dp, b, tile=tile)
        np.testing.assert_array_equal(
            full.numpy(), np.asarray(j_expand(jnp.asarray(_np(dwc)), kd, dp,
                                              jb, tile=tile)))
        mask = P.tdp_mask(kd, n, dp, b, tile)
        assert bool((full[mask == 0] == 0).all())
        # TdpMatmul's gradients: kernel 9 or the mask-multiply fallback,
        # kernel 10 + expansion
        _, vjp = jax.vjp(lambda x, y: j_tdp_vjp(x, y, jb, dp, tile, True,
                                                True),
                         jnp.asarray(a), jnp.asarray(w))
        jda, jdw = vjp(jnp.asarray(dc))
        ta, tw = t(a).requires_grad_(), t(w).requires_grad_()
        out = ops.tdp_mm(ta[None], tw, b, dp=dp, tile=tile)[0]
        _close(out, j_tdp_matmul(a, w, jb, **kw))
        da, dw = torch.autograd.grad(out, (ta, tw), t(dc))
        _close(da, jda)
        _close(dw, jdw)
    assert all(k.launches == 0 for k in K.KERNELS)    # CPU: plain versions


def test_tdp_matmul_backward_picks_kernel_9_by_the_reference_shape_rule(
        monkeypatch):
    """dgrad kernel iff dp | N/tile, never as a way out of a failure; the
    wgrad kernel always."""
    calls = []
    for name in ("tdp_dgrad", "tdp_wgrad"):
        orig = getattr(autodiff, name)

        def counted(*args, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(*args, **kw)
        monkeypatch.setattr(autodiff, name, counted)
    rng = np.random.default_rng(1)
    for n, want in ((256, ["tdp_dgrad", "tdp_wgrad"]), (320, ["tdp_wgrad"])):
        calls.clear()
        a = torch.from_numpy(_draw(rng, 4, 256)).requires_grad_()
        w = torch.from_numpy(_draw(rng, 256, n, fan=256)).requires_grad_()
        ops.tdp_mm(a, w, 1, dp=2, tile=64).sum().backward()
        assert calls == want, (n, calls)


def test_tdp_wrappers_refuse_what_the_kernels_cannot_take():
    a, w = torch.zeros(2, 384), torch.zeros(384, 256)
    with pytest.raises(ValueError, match="does not divide"):
        K.tdp_matmul(a, w, 0, dp=4, tile=64)          # 6 row-tiles, dp 4
    with pytest.raises(ValueError, match="tiles of"):
        K.tdp_matmul(a, w, 0, dp=2, tile=100)
    with pytest.raises(ValueError, match="bias"):
        K.tdp_wgrad(a, torch.zeros(2, 256), 2, dp=2, tile=64)
    # a tile the CUDA kernels do not take is named, not sent to the plain
    # version; a tensor off the CPU launches or raises (meta: raises)
    with pytest.raises(ValueError, match="tile 8"):
        K.tdp_matmul(a.to("meta"), w.to("meta"), 0, dp=2, tile=8)
    for fn in (lambda: K.tdp_matmul(a.to("meta"), w.to("meta"), 0, dp=2,
                                    tile=64),
               lambda: K.tdp_dgrad(torch.zeros(2, 256, device="meta"),
                                   w.to("meta"), 0, dp=2, tile=64),
               lambda: tdp_matmul_bwd.tdp_wgrad(
                   a.to("meta"), torch.zeros(2, 256, device="meta"), 0, dp=2,
                   tile=64)):
        with pytest.raises(ValueError, match="CUDA device"):
            fn()


# --------------------------------------------------------------------------
# (c) the family
# --------------------------------------------------------------------------

def test_tdp_family_apply_ffn_matches_jax_family():
    d, dff, nb = 64, 256, 8                 # SMOKE widths: tile 8
    rng = np.random.default_rng(2)
    x = _draw(rng, 2, 5, d)
    wu, wg = _draw(rng, d, dff, fan=d), _draw(rng, d, dff, fan=d)
    wd = _draw(rng, dff, d, fan=dff)
    fam, jfam = plan_mod.get_family("tdp"), JFAMILIES["tdp"]
    t = torch.from_numpy
    for dp in (2, 4, 8):
        for b in range(dp):
            kw = dict(dp=dp, bias=b, nb=nb)
            ref = jfam.apply_ffn(jnp.asarray(x), wu, wd, wg, backend="slice",
                                 act=jax.nn.silu, **kw)
            _close(jfam.apply_ffn(jnp.asarray(x), wu, wd, wg,
                                  backend="pallas", act=jax.nn.silu, **kw),
                   ref)
            for backend in ("slice", "cuda"):
                _close(fam.apply_ffn(t(x), t(wu), t(wd), t(wg),
                                     backend=backend, act=F.silu, **kw), ref)
            _close(fam.oracle_ffn(t(x), t(wu), t(wd), t(wg), act=F.silu,
                                  **kw),
                   jfam.oracle_ffn(jnp.asarray(x), wu, wd, wg,
                                   act=jax.nn.silu, **kw))


def test_tdp_plan_refusals_mirror_the_reference():
    assert plan_mod.FAMILIES["tdp"].backends == ("slice", "cuda")
    for backend in ("gather", "fused"):
        with pytest.raises(ValueError, match="does not support backend"):
            BoundPlan(family="tdp", dp=2, bias=0, nb=8, backend=backend)
        with pytest.raises(ValueError, match="does not support backend"):
            DropoutPlan(family="tdp", dist=(0.5, 0.5), nb=8, backend=backend)
    with pytest.raises(ValueError, match="does not support backend"):
        JBound(family="tdp", dp=2, bias=0, nb=8, backend="gather")
    for cls in (BoundPlan, JBound):
        with pytest.raises(ValueError, match="not divisible"):
            cls(family="tdp", dp=3, bias=0, nb=8)
    # full qwen2-1.5b at its configured pattern_nb 128: tile 1536/128 = 12
    # does not divide d_ff 8960 — both packages raise the same error
    cfg, jcfg = get_config(ARCH), jax_config(ARCH)
    assert cfg.pattern_nb == jcfg.pattern_nb == 128
    x = np.zeros((1, cfg.d_model), np.float32)
    wu = np.zeros((cfg.d_model, cfg.d_ff), np.float32)
    wd = np.zeros((cfg.d_ff, cfg.d_model), np.float32)
    msg = "dim 8960 not divisible by block 12"
    with pytest.raises(ValueError, match=msg):
        JFAMILIES["tdp"].apply_ffn(jnp.asarray(x), wu, wd, None, dp=2,
                                   bias=0, nb=cfg.pattern_nb,
                                   backend="slice", act=jax.nn.silu)
    for backend in ("slice", "cuda"):
        with pytest.raises(ValueError, match=msg if backend == "slice"
                           else "tiles of 12"):
            plan_mod.get_family("tdp").apply_ffn(
                torch.from_numpy(x), torch.from_numpy(wu),
                torch.from_numpy(wd), None, dp=2, bias=0, nb=cfg.pattern_nb,
                backend=backend, act=F.silu)


# --------------------------------------------------------------------------
# (d) the model: lm_loss gradients, engine, server, trainer
# --------------------------------------------------------------------------

@functools.cache
def _setup():
    jcfg, cfg = jax_smoke(ARCH), get_smoke(ARCH)
    params = jax_materialize(jax.random.PRNGKey(0), jax_init_lm(jcfg)[0])
    rng = np.random.default_rng(0)
    attn = params["stacks"][0]["attn"]
    for name in ("bq", "bk", "bv"):          # materialize zeroes them
        attn[name] = jnp.asarray(
            0.1 * rng.standard_normal(attn[name].shape), attn[name].dtype)
    jplan = jax_build_plan("tdp", 0.5, nb=cfg.pattern_nb, dp_max=8)
    plan = build_plan("tdp", 0.5, nb=cfg.pattern_nb, dp_max=8)
    return jcfg, cfg, params, _port_params(params, cfg), jplan, plan


def _port_params(params, cfg):
    return params_from_jax(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")


def _tile(cfg):
    return cfg.d_model // cfg.pattern_nb


def _rotated(tree, b: int, tile: int):
    """The JAX tree with every FFN hidden unit moved left by ``b`` tiles
    (columns of w_up/w_gate, rows of w_down).  The tdp pattern at bias 0 on
    it keeps exactly the synapses that bias ``b`` keeps on the originals
    (tile (i, j) kept iff (i + j - b) % dp == 0, and dp divides the tile
    columns), and the FFN sums over hidden units, so one compiled JAX
    reference per dp serves every bias.  ``-b`` rotates back."""
    if b == 0:
        return tree
    stack = dict(tree["stacks"][0])
    ffn = dict(stack["ffn"])
    for name, axis in (("w_up", 2), ("w_gate", 2), ("w_down", 1)):
        ffn[name] = jnp.roll(ffn[name], -b * tile, axis=axis)
    stack["ffn"] = ffn
    return {**tree, "stacks": [stack]}


def _buckets():
    return [(dp, b) for dp in JP.valid_periods(8, 8) for b in range(dp)]


@functools.cache
def _jax_grad_fn(dp: int):
    jcfg, _, _, _, jplan, _ = _setup()
    batch = jax.tree.map(jnp.asarray, _batch())
    return jax.jit(jax.grad(lambda p: jax_lm_loss(
        jcfg, p, batch, jplan.bind(dp, 0))[0]))


@functools.cache
def _batch():
    cfg = get_smoke(ARCH)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 32))
    labels = rng.integers(0, cfg.vocab, (2, 32))
    labels[0, :3] = -1
    return {"tokens": tokens, "labels": labels}


@pytest.mark.parametrize("dp,bias", _buckets())
def test_lm_loss_grads_match_jax(dp, bias):
    jcfg, cfg, params, tparams, jplan, plan = _setup()
    assert (dp, bias) in jplan.buckets() and (dp, bias) in plan.buckets()
    tile = _tile(cfg)
    jg = _rotated(_jax_grad_fn(dp)(_rotated(params, bias, tile)), -bias,
                  tile)
    ref = tree_leaves(params_from_jax(jax.tree.map(np.asarray, jg), cfg,
                                      device="cpu"))
    tb = {k: torch.from_numpy(v) for k, v in _batch().items()}
    tparams = _port_params(params, cfg)
    leaves = tree_leaves(tparams)
    mask = P.tdp_mask(cfg.d_model, cfg.d_ff, dp, bias, tile)
    for backend in ("slice", "cuda"):
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = lm_loss(cfg, tparams, tb,
                          plan.with_backend(backend).bind(dp, bias))
        grads = torch.autograd.grad(loss, leaves)
        for g, r in zip(grads, ref):
            _close(g, r)
        gmap = {id(p): g for p, g in zip(leaves, grads)}
        for lp in tparams["layers"]:
            gu = gmap[id(lp["ffn"]["w_up"])]
            assert bool((gu[mask == 0] == 0).all())       # dropped tiles
            if dp > 1:
                assert bool((gu[mask == 1] != 0).any())
            # gate and down projections stay dense
            assert bool((gmap[id(lp["ffn"]["w_gate"])] != 0).any(0).all())
            assert bool((gmap[id(lp["ffn"]["w_down"])] != 0).any(1).all())


def _torch_cache(jcache):
    return {"layers": [{k: torch.from_numpy(np.array(v)) for k, v in g.items()}
                       for g in jcache["layers"]],
            "pos": torch.from_numpy(np.array(jcache["pos"])).long()}


@functools.cache
def _jax_engine(dp: int):
    jcfg, cfg, *_ = _setup()
    jpat = JBound(family="tdp" if dp > 1 else "identity", dp=dp, bias=0,
                  nb=cfg.pattern_nb, backend="slice")

    def reference(params, tok, feed):
        jl, jcache = jengine.prefill(jcfg, params, tok, MAX_LEN, pat=jpat)
        rag = {"layers": jcache["layers"],
               "pos": jnp.asarray([12, 9], jnp.int32)}
        jlr, _ = jengine.decode_step_ragged(jcfg, params, rag, feed,
                                            pat=jpat)
        return jl, rag, jlr

    return jax.jit(reference)


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_engine_matches_jax_per_bucket(dp):
    """prefill and a ragged decode step (sequences at positions 12 and 9)
    on the cuda backend, every bias of the period."""
    _, cfg, params, tparams, _, _ = _setup()
    rng = np.random.default_rng(dp)
    tok = rng.integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    for b in range(dp):
        jl, rag, jlr = _jax_engine(dp)(_rotated(params, b, _tile(cfg)), tok,
                                       feed)
        pat = BoundPlan(family="tdp", dp=dp, bias=b, nb=cfg.pattern_nb,
                        backend="cuda")
        logits, _ = engine.prefill(cfg, tparams, torch.from_numpy(tok).long(),
                                   MAX_LEN, pat=pat)
        _close(logits, jl)
        lr, cr = engine.decode_step_ragged(
            cfg, tparams, _torch_cache(rag), torch.from_numpy(feed).long(),
            pat=pat)
        _close(lr, jlr)
        assert cr["pos"].tolist() == [13, 10]


def _trace(cfg):
    return jserve.poisson_trace(rate=200.0, n_requests=3, seed=3,
                                prompt_len=(8, 8), max_new=(3, 5),
                                vocab=cfg.vocab, ensemble=3,
                                ensemble_prob=0.75)


@functools.cache
def _jax_replay():
    jcfg, cfg, params, _, _, _ = _setup()
    jplan = JPlan(family="tdp", dist=(0.3, 0.3, 0.0, 0.4), nb=cfg.pattern_nb)
    sched = jserve.Scheduler(jcfg, params, capacity=8, max_len=MAX_LEN,
                             prefill_chunk=4, plan=jplan)
    return jplan, jserve.Server(sched, clock=jserve.VirtualClock()).run(
        _trace(jcfg))


@pytest.mark.parametrize("backend", ["slice", "cuda"])
def test_server_replay_matches_jax_scheduler(backend):
    """Same TDP plan, weights and trace: identical greedy token streams
    and buckets per member, first-token logits within 1e-5."""
    jcfg, cfg, _, tparams, _, _ = _setup()
    jplan, ref = _jax_replay()
    plan = DropoutPlan(family="tdp", dist=jplan.dist, nb=cfg.pattern_nb,
                       backend=backend)
    sched = serve.Scheduler(cfg, tparams, capacity=8, max_len=MAX_LEN,
                            prefill_chunk=4, plan=plan, device="cpu")
    trace = [serve.Request(rid=r.rid, prompt=np.array(r.prompt),
                           max_new_tokens=r.max_new_tokens,
                           priority=r.priority, ensemble=r.ensemble,
                           seed=r.seed, arrival_time=r.arrival_time)
             for r in _trace(jcfg)]
    out = serve.Server(sched, clock=serve.VirtualClock()).run(trace)
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
    assert n_patterned > 0
    assert out["telemetry"]["bucket_tokens"] == \
        ref["telemetry"]["bucket_tokens"]
    sched.obs.watchdog.assert_clean()


def test_trainer_matches_jax_trainer():
    """8 steps of the port's Trainer on the cuda backend (plain kernel
    versions here) against the JAX trainer on slice, both under the SMOKE
    TDP plan: the same (dp, bias) draws and losses within 1e-5."""
    jcfg, cfg, params, tparams, jplan, plan = _setup()
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    jt = JaxTrainer(jcfg, jopt.AdamW(), jax.tree.map(jnp.copy, params),
                    mesh=mesh, plan=jplan,
                    tcfg=JaxTrainerConfig(steps=8, base_lr=1e-3,
                                          log_every=100))
    jh = jt.run(JaxData(vocab=cfg.vocab, seq_len=32, global_batch=2).batch)
    tt = Trainer(cfg, AdamW(), _port_params(params, cfg),
                 plan=plan.with_backend("cuda"),
                 tcfg=TrainerConfig(steps=8, base_lr=1e-3, log_every=100),
                 device="cpu")
    th = tt.run(SyntheticLMData(vocab=cfg.vocab, seq_len=32,
                                global_batch=2).batch)
    assert [(h["dp"], h["bias"]) for h in th] == \
        [(h["dp"], h["bias"]) for h in jh]
    assert any(h["dp"] > 1 for h in th)
    for a, b in zip(th, jh):
        assert abs(a["loss"] - b["loss"]) <= TOL, (a, b)
    tt.obs.watchdog.assert_clean()


def test_full_config_runs_tdp_at_pattern_nb_12():
    """qwen2-1.5b's widths take TDP at pattern_nb 12 (tile 128, 12 x 70
    tiles); the plan may only use the divisors of 12."""
    cfg = dataclasses.replace(get_config(ARCH), pattern_nb=12)
    tile = cfg.d_model // cfg.pattern_nb
    assert tile == 128 and cfg.d_ff % tile == 0
    plan = build_plan("tdp", 0.5, nb=cfg.pattern_nb, dp_max=8)
    assert set(plan.support()) <= {1, 2, 3, 4, 6}
    assert abs(plan.expected_rate() - 0.5) < 0.05


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_tdp_kernels_match_plain():
    """On the card: kernels 8-10 against their plain versions at the full
    width (f32 within 1e-4 of max|ref|, bf16 within 2e-2), tile 128 and
    64, and the guard (a direct call with grad mode on raises)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for kd, n, tile, dp in ((1536, 8960, 128, 2), (1536, 1536, 128, 6),
                                (512, 320, 64, 4)):
            w = (torch.randn(kd, n, generator=g, device="cuda")
                 / kd ** .5).to(dt)
            for m in (1, 100, 512):
                a = torch.randn(m, kd, generator=g, device="cuda").to(dt)
                dc = torch.randn(m, n, generator=g, device="cuda").to(dt)
                b = dp - 1
                kw = dict(dp=dp, tile=tile)
                pairs = [(K.tdp_matmul(a, w, b, **kw),
                          K.tdp_matmul_plain(a, w, b, **kw)),
                         (K.tdp_wgrad(a, dc, b, **kw),
                          K.tdp_wgrad_plain(a, dc, b, **kw))]
                if (n // tile) % dp == 0:
                    pairs.append((K.tdp_dgrad(dc, w, b, **kw),
                                  K.tdp_dgrad_plain(dc, w, b, **kw)))
                for got, ref in pairs:
                    err = (got.float() - ref.float()).abs().max()
                    assert err <= tol * ref.float().abs().max()
    x = torch.randn(4, 1536, device="cuda", requires_grad=True)
    w32 = torch.randn(1536, 8960, device="cuda")
    with pytest.raises(RuntimeError, match="grad mode"):
        K.tdp_matmul(x, w32, 0, dp=2, tile=128)
    with torch.no_grad():
        K.tdp_matmul(x, w32, 0, dp=2, tile=128)
