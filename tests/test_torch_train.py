"""The port's training path held against the JAX package on identical inputs.

* ``AdamW.update`` / ``SGDMomentum.update``, ``clip_by_global_norm`` and
  ``cosine_schedule`` against the JAX ones (f32, a 1-D leaf covers the
  no-decay rule) to 1e-6;
* the port's ``SyntheticLMData`` draws bitwise the JAX package's batches;
* ``make_train_step`` with two microbatches against the JAX one;
* an 8-step port ``Trainer`` against the JAX trainer, both on the
  "slice" backend (qwen2-1.5b SMOKE, f32, weights bridged from the JAX
  ``materialize``): the same (dp, bias) sequence and losses to 1e-5.  The
  JAX side is ``DistributedTrainer`` (the class its ``Trainer`` wraps) on a
  1x1 mesh with Auto axes: on the host mesh ``Trainer`` builds (Explicit
  axes under JAX 0.9), the embedding gather raises ``ShardingTypeError``
  before the first step, on every backend;
* the trainer's contracts: first-use record per bucket, ``warm_start`` +
  frozen watchdog, and the refusals (non-differentiable backend, no GPU
  without ``device="cpu"``, the parts not ported yet).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_smoke as jax_smoke
from repro.core.plan import build_plan as jax_build_plan
from repro.data.pipeline import SyntheticLMData as JaxData
from repro.models import init_lm as jax_init_lm
from repro.models import materialize as jax_materialize
from repro.optim import optimizers as jopt
from repro.train.distributed import DistributedTrainer as JaxTrainer
from repro.train.distributed import TrainerConfig as JaxTrainerConfig
from repro.train.train_step import make_train_step as jax_make_train_step

from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.core import plan as plan_mod
from repro_torch.core.plan import build_plan
from repro_torch.data import SyntheticLMData
from repro_torch.optim import optimizers as opt
from repro_torch.train import Trainer, TrainerConfig, make_train_step
from repro_torch.tree import tree_leaves

ARCH = "qwen2_1_5b"


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(a, b, tol):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a.astype(np.float64) - b).max())
    assert err <= tol, err


def _opt_trees(seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "stack": (2, 3, 4), "b": (5,)}   # b: 1-D, no decay
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 0.7).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    return params, grads


# --------------------------------------------------------------------------
# (c) optimizers, clipping, schedule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adamw", "sgd"])
def test_optimizer_updates_match_jax(name):
    params, grads = _opt_trees()
    jo, to = ((jopt.AdamW(), opt.AdamW()) if name == "adamw"
              else (jopt.SGDMomentum(), opt.SGDMomentum()))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ts = jo.init(jp), to.init(tp)
    for i, g in enumerate(grads):
        lr = 1e-2 * (i + 1)
        jp, js = jo.update(jp, {k: jnp.asarray(v) for k, v in g.items()},
                           js, jnp.float32(lr))
        tp, ts = to.update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                           ts, lr)
        for k in params:
            _close(tp[k], jp[k], 1e-6)
    assert ts["count"] == int(js["count"]) == len(grads)
    if name == "adamw":
        for k in params:
            _close(ts["mu"][k], js["mu"][k], 1e-6)
            _close(ts["nu"][k], js["nu"][k], 1e-6)


def test_adamw_keeps_bf16_params_without_a_master_copy():
    p = {"w": torch.randn(4, 4).to(torch.bfloat16)}
    state = opt.AdamW().init(p)
    assert state["mu"]["w"].dtype == torch.float32
    opt.AdamW().update(p, {"w": torch.randn(4, 4)}, state, 1e-3)
    assert p["w"].dtype == torch.bfloat16 and set(state) == {"mu", "nu",
                                                            "count"}


def test_weight_decay_follows_the_reference_stacked_rank():
    """The reference stacks each layer leaf over its layers, so a per-layer
    norm scale is 2-D there and decayed; the port's list of layers counts
    as that axis (a final-norm scale stays 1-D and undecayed)."""
    tree = {"layers": [{"scale": torch.ones(4), "w": torch.ones(4, 4)}] * 2,
            "final": torch.ones(4), "embed": torch.ones(3, 4)}
    assert opt.decay_mask(tree) == [True, True, True, True, False, True]


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    _, grads = _opt_trees(1)
    g = grads[0]
    jg, jn = jopt.clip_by_global_norm({k: jnp.asarray(v)
                                       for k, v in g.items()}, max_norm)
    tg, tn = opt.clip_by_global_norm({k: torch.from_numpy(v)
                                      for k, v in g.items()}, max_norm)
    _close(tn, jn, 1e-6)
    _close(opt.global_norm({k: torch.from_numpy(v) for k, v in g.items()}),
           jopt.global_norm({k: jnp.asarray(v) for k, v in g.items()}), 1e-6)
    for k in g:
        _close(tg[k], jg[k], 1e-6)


def test_cosine_schedule_matches_jax():
    for base, warm, total in ((3e-4, 10, 100), (1e-3, 10, 8), (1.0, 0, 5)):
        jf, tf = jopt.cosine_schedule(base, warm, total), \
            opt.cosine_schedule(base, warm, total)
        for step in range(0, total + 5):
            assert abs(tf(step) - float(jf(step))) <= 1e-6 * max(base, 1e-3)


# --------------------------------------------------------------------------
# (d) data
# --------------------------------------------------------------------------

def test_synthetic_lm_data_is_bitwise_the_reference():
    kw = dict(vocab=151936, seq_len=64, global_batch=4, seed=3)
    ours, ref = SyntheticLMData(**kw), JaxData(**kw)
    for step in range(8):
        a, b = ours.batch(step), ref.batch(step)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------------------------
# (e) train step and trainer against the JAX ones (slice backend)
# --------------------------------------------------------------------------

@functools.cache
def _setup():
    jcfg, cfg = jax_smoke(ARCH), get_smoke(ARCH)
    params = jax_materialize(jax.random.PRNGKey(0), jax_init_lm(jcfg)[0])
    block = cfg.d_ff // cfg.pattern_nb
    jplan = jax_build_plan("rdp", 0.5, nb=cfg.pattern_nb, dp_max=8,
                           block=block)
    plan = build_plan("rdp", 0.5, nb=cfg.pattern_nb, dp_max=8, block=block)
    return jcfg, cfg, params, jplan, plan


def _port_params(params, cfg):
    return params_from_jax(jax.tree.map(np.asarray, params), cfg,
                           device="cpu")


def test_microbatched_train_step_matches_jax():
    """Two microbatches on the cuda backend against the JAX step (slice).
    SGD keeps the update linear in the clipped gradient, so the updated
    parameters compare the gradients themselves (Adam's first step is
    ~lr·sign(g), which would amplify 1e-7 differences in near-zero
    gradient entries)."""
    jcfg, cfg, params, jplan, plan = _setup()
    batch = SyntheticLMData(vocab=cfg.vocab, seq_len=16,
                            global_batch=4).batch(5)
    jo, to = jopt.SGDMomentum(), opt.SGDMomentum()
    jstep = jax.jit(jax_make_train_step(jcfg, jo, microbatches=2,
                                        pat=jplan.bind(4, 1)))
    jp, _, jm = jstep(params, jo.init(params),
                      jax.tree.map(jnp.asarray, batch), jnp.float32(0.1))
    tp = _port_params(params, cfg)
    step = make_train_step(cfg, to, microbatches=2,
                           pat=plan.with_backend("cuda").bind(4, 1),
                           device="cpu")
    tp, _, tm = step(tp, to.init(tp), batch, 0.1)
    _close(tm["loss"], jm["loss"], 1e-5)
    _close(tm["grad_norm"], jm["grad_norm"], 1e-5)
    for a, b in zip(tree_leaves(tp), tree_leaves(_port_params(jp, cfg))):
        _close(a, b, 1e-5)


def test_trainer_matches_jax_trainer_on_slice():
    jcfg, cfg, params, jplan, plan = _setup()
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=32, global_batch=2)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    jt = JaxTrainer(jcfg, jopt.AdamW(), jax.tree.map(jnp.copy, params),
                    mesh=mesh, plan=jplan,
                    tcfg=JaxTrainerConfig(steps=8, base_lr=1e-3,
                                          log_every=100))
    jh = jt.run(JaxData(vocab=cfg.vocab, seq_len=32, global_batch=2).batch)
    tt = Trainer(cfg, opt.AdamW(), _port_params(params, cfg), plan=plan,
                 tcfg=TrainerConfig(steps=8, base_lr=1e-3, log_every=100),
                 device="cpu")
    th = tt.run(data.batch)
    assert [(h["dp"], h["bias"]) for h in th] == \
        [(h["dp"], h["bias"]) for h in jh]
    assert any(h["dp"] > 1 for h in th)
    for a, b in zip(th, jh):
        assert abs(a["loss"] - b["loss"]) <= 1e-5, (a, b)
        assert np.isfinite(a["grad_norm"])
    # one first use per distinct bucket, all inside the plan's universe
    seen = {(h["dp"], h["bias"]) for h in th}
    assert set(tt._buckets) == seen
    assert tt.obs.watchdog.compiles == {k: 1 for k in seen}
    tt.obs.watchdog.assert_clean()
    snap = tt.obs.registry.snapshot()
    assert sum(m["value"] for m in snap
               if m["name"] == "train_steps_total") == 8
    assert sum(m["count"] for m in snap
               if m["name"] == "train_step_time_s") == 8


def test_warm_start_covers_every_bucket_and_freezes(capsys):
    _, cfg, params, _, plan = _setup()
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=8, global_batch=2)
    tt = Trainer(cfg, opt.SGDMomentum(), _port_params(params, cfg),
                 plan=plan.with_backend("fused"),
                 tcfg=TrainerConfig(steps=3, log_every=1), device="cpu")
    before = [t.clone() for t in tree_leaves(tt.params)]
    tt.warm_start(data.batch)
    assert set(tt._buckets) == set(plan.buckets())
    assert tt.obs.watchdog.frozen
    for a, b in zip(before, tree_leaves(tt.params)):
        assert torch.equal(a, b)           # warm-up ran on a copy
    hist = tt.run(data.batch)
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    tt.obs.watchdog.assert_clean()
    assert "step 0: loss=" in capsys.readouterr().out


def test_trainer_refusals(monkeypatch):
    _, cfg, params, _, plan = _setup()
    tparams = _port_params(params, cfg)
    with pytest.raises(NotImplementedError):
        Trainer(cfg, opt.AdamW(), tparams, plan=plan,
                tcfg=TrainerConfig(ckpt_dir="ckpt"), device="cpu")
    with pytest.raises(NotImplementedError):
        Trainer(cfg, opt.AdamW(), tparams, plan=plan, online_search=object(),
                device="cpu")
    with pytest.raises(NotImplementedError):
        make_train_step(cfg, opt.AdamW(), compress_grads=True, device="cpu")
    monkeypatch.setitem(plan_mod.BACKENDS, "gather",
                        plan_mod.Backend("gather", differentiable=False))
    with pytest.raises(ValueError, match="not differentiable"):
        Trainer(cfg, opt.AdamW(), tparams, plan=plan.with_backend("gather"),
                device="cpu")
    if not torch.cuda.is_available():
        for fn in (lambda: Trainer(cfg, opt.AdamW(), tparams, plan=plan),
                   lambda: make_train_step(cfg, opt.AdamW())):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn()
