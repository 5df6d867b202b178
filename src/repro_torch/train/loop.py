"""Single-device trainer: pattern bucketing and the straggler watchdog.

Twin of ``repro.train.distributed.DistributedTrainer`` (and its single-host
``Trainer``) without the mesh:

* **pattern bucketing** — each step samples (dp, bias) from the plan's
  distribution K (``plan.sample(step)``, bitwise the reference's draws) and
  dispatches to that bucket's train step.  PyTorch runs eagerly, so a
  bucket's "executable" is its step function, made at first use; the
  first-use record is counted by ``obs.watchdog.record_compile`` as the
  reference counts compiles.  ``warm_start`` makes every bucket's step and
  runs it once on a copy of the state, then freezes the watchdog: any later
  first use is a violation.
* **straggler watchdog** — EMA step-time anomaly detection; slow steps are
  logged and counted (``train_stragglers_total``).

Metrics: ``train_step_time_s`` (histogram) and ``train_steps_total`` per
bucket, ``train_compiles_total`` per first use; spans ``data``,
``dispatch``, ``train_step`` (and ``compile`` in ``warm_start``).
Checkpoint/restart, online search and HLO gauges come with training at
scale; the constructor refuses them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from ..core import plan as plan_mod
from ..core.plan import BucketSupersetViolation, DropoutPlan, identity_plan
from ..device import resolve_device
from ..models.transformer import ModelConfig
from ..obs import Observability, bucket_labels
from ..optim.optimizers import cosine_schedule
from ..tree import tree_map
from .train_step import make_train_step, to_device


@dataclasses.dataclass
class TrainState:
    """Model params + optimizer state + step counter."""

    params: object
    opt: object
    step: int = 0


def _clone_state(state: TrainState) -> TrainState:
    copy = lambda t: t.detach().clone() if hasattr(t, "clone") else t  # noqa
    return TrainState(tree_map(copy, state.params), tree_map(copy, state.opt),
                      state.step)


@dataclasses.dataclass
class StragglerWatchdog:
    """Flags steps slower than mean + tolerance·std of an EMA estimate."""

    ema: float = 0.0
    var: float = 0.0
    beta: float = 0.9
    tolerance: float = 4.0
    warmup: int = 5
    seen: int = 0
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        """Fold one step time in; True when the step is a straggler."""
        self.seen += 1
        if self.seen <= self.warmup:
            self.ema = dt if self.seen == 1 else \
                self.beta * self.ema + (1 - self.beta) * dt
            return False
        mean = self.ema
        self.ema = self.beta * self.ema + (1 - self.beta) * dt
        dev = abs(dt - mean)
        self.var = self.beta * self.var + (1 - self.beta) * dev * dev
        slow = dt > mean + self.tolerance * max(self.var ** 0.5, 1e-4)
        if slow:
            self.flagged += 1
        return slow


@dataclasses.dataclass
class TrainerConfig:
    """Loop settings (the reference's fields; ``ckpt_*`` and
    ``compress_grads`` are refused until they are ported)."""

    steps: int = 100
    base_lr: float = 3e-4
    warmup: int = 10
    ckpt_dir: Optional[str] = None
    clip_norm: float = 1.0
    microbatches: int = 1
    compress_grads: bool = False
    log_every: int = 10


class Trainer:
    """Pattern-bucketed trainer on one device (the GPU unless ``device``
    is given)."""

    def __init__(self, cfg: ModelConfig, optimizer, params,
                 tcfg: Optional[TrainerConfig] = None,
                 plan: Optional[DropoutPlan] = None, *,
                 obs: Optional[Observability] = None,
                 online_search=None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.optimizer = optimizer
        self.tcfg = tcfg if tcfg is not None else TrainerConfig()
        if self.tcfg.ckpt_dir or online_search is not None:
            raise NotImplementedError(
                "checkpointing and online search are not ported yet (they "
                "come with training at scale)")
        self.plan = (plan.with_nb(cfg.pattern_nb) if plan is not None
                     else identity_plan(nb=cfg.pattern_nb))
        # training needs grads through the pattern matmuls
        if not plan_mod.BACKENDS[self.plan.backend].differentiable:
            raise ValueError(
                f"pattern backend {self.plan.backend!r} is not "
                f"differentiable and cannot be used for training")
        self.obs = obs if obs is not None \
            else Observability.create(plan=self.plan)
        self.plan0 = self.plan
        self._superset = frozenset(self.plan0.buckets())
        params = tree_map(lambda t: t.to(self.device), params)
        self.state = TrainState(params=params, opt=optimizer.init(params))
        self.lr_fn = cosine_schedule(self.tcfg.base_lr, self.tcfg.warmup,
                                     self.tcfg.steps)
        self._buckets: dict[tuple, Callable] = {}
        self.obs.watchdog.expect(self.plan0.buckets())
        self.watchdog = StragglerWatchdog()
        self.start_step = 0
        self.history: list[dict] = []

    @property
    def params(self):
        """The current model parameters."""
        return self.state.params

    @property
    def opt_state(self):
        """The current optimizer state."""
        return self.state.opt

    # ---- pattern bucketing -------------------------------------------------
    def _step_fn(self, dp: int, bias: int) -> Callable:
        key = (dp, bias)
        if key not in self._buckets:
            self.obs.watchdog.record_compile(key)
            self.obs.registry.counter("train_compiles_total",
                                      bucket_labels(dp, bias)).inc()
            pat = self.plan.bind(dp, bias) if dp > 1 else plan_mod.IDENTITY
            base = make_train_step(
                self.cfg, self.optimizer,
                microbatches=self.tcfg.microbatches, pat=pat,
                clip_norm=self.tcfg.clip_norm,
                compress_grads=self.tcfg.compress_grads, device=self.device)

            def step(state, batch, lr):
                p, o, metrics = base(state.params, state.opt, batch, lr)
                return TrainState(params=p, opt=o,
                                  step=state.step + 1), metrics

            self._buckets[key] = step
        return self._buckets[key]

    def warm_start(self, batch_fn: Callable[[int], dict]):
        """Make every ``plan.buckets()`` step and run it once on a copy of
        the state (the real state is untouched), then freeze the watchdog:
        any later first use is a violation."""
        batch = to_device(batch_fn(0), self.device)
        for dp, b in self.plan0.buckets():
            fn = self._step_fn(dp, b)
            with self.obs.tracer.span("compile", dp=dp, bias=b):
                _, metrics = fn(_clone_state(self.state), batch, 0.0)
                float(metrics["loss"])
        self.obs.watchdog.freeze()

    # ---- the loop ----------------------------------------------------------
    def run(self, batch_fn: Callable[[int], dict],
            until: Optional[int] = None) -> list[dict]:
        """Train until ``until`` (default tcfg.steps); returns history."""
        until = until or self.tcfg.steps
        tracer, reg = self.obs.tracer, self.obs.registry
        for step in range(self.start_step, until):
            bound = self.plan.sample(step)
            if (bound.dp, bound.bias) not in self._superset:
                raise BucketSupersetViolation(
                    f"sampled bucket (dp={bound.dp}, bias={bound.bias}) "
                    f"outside the frozen superset {sorted(self._superset)}")
            if self.obs.drift is not None:
                self.obs.drift.observe_bound(bound)
            with tracer.span("data", step=step):
                batch = to_device(batch_fn(step), self.device)
            with tracer.span("dispatch", dp=bound.dp, bias=bound.bias):
                fn = self._step_fn(bound.dp, bound.bias)
            t0 = time.perf_counter()
            with tracer.span("train_step", step=step, dp=bound.dp,
                             bias=bound.bias):
                self.state, metrics = fn(self.state, batch,
                                         self.lr_fn(step))
                loss = float(metrics["loss"])       # waits for the step
            dt = time.perf_counter() - t0
            slow = self.watchdog.observe(dt)
            blabels = bucket_labels(bound.dp, bound.bias)
            reg.histogram("train_step_time_s", blabels).record(dt)
            reg.counter("train_steps_total", blabels).inc()
            if slow:
                reg.counter("train_stragglers_total", blabels).inc()
                tracer.instant("straggler", step=step, dt=dt)
            rec = {"step": step, "loss": loss,
                   "grad_norm": float(metrics["grad_norm"]),
                   "dp": bound.dp, "bias": bound.bias, "dt": dt,
                   "straggler": slow}
            self.history.append(rec)
            if step % self.tcfg.log_every == 0:
                print(f"step {step}: loss={rec['loss']:.4f} "
                      f"dp={bound.dp} dt={dt*1e3:.0f}ms"
                      + (" [STRAGGLER]" if slow else ""), flush=True)
        return self.history
