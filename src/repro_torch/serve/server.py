"""Front-end serving driver: arrival traces, clocks, the event loop.

The JAX package's ``repro.serve.server``, over the port's scheduler.

``Server`` runs a *synchronous* event loop over an injectable clock:

* ``WallClock`` — real time, so TTFT/TPOT histograms measure actual
  compute (``chip_smoke.py`` serves on the GPU with it);
* ``VirtualClock`` + a deterministic ``StepCostModel`` — simulated time;
  identical (seed, trace) inputs replay to identical admission order,
  pattern buckets and token streams — the same streams as the JAX
  package's server (tests/test_torch_serve.py).

Admission control is the scheduler's ``max_queue`` backpressure: rejected
requests are dropped and counted in telemetry (a real deployment would
return 429 / shed to a replica).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence as Seq

import numpy as np

from .scheduler import Request, Scheduler


# --------------------------------------------------------------------------
# clocks
# --------------------------------------------------------------------------

class VirtualClock:
    """Deterministic simulated time, advanced explicitly by the server."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> None:
        self._now += max(0.0, float(dt))

    def wait_until(self, t: float) -> None:
        self._now = max(self._now, float(t))


class WallClock:
    """Real time relative to construction."""

    def __init__(self):
        self._t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def advance(self, dt: float) -> None:
        pass                                    # real time advances itself

    def wait_until(self, t: float) -> None:
        dt = t - self.now()
        if dt > 0:
            time.sleep(dt)


@dataclasses.dataclass(frozen=True)
class StepCostModel:
    """Virtual seconds one scheduler step costs — the determinism anchor.

    Linear in the work done: chunked-prefill tokens and decoded sequences.
    The constants are arbitrary but fixed; only their *ratios* shape the
    schedule (e.g. how many decode steps happen while a prompt prefills).
    """

    base: float = 1e-3
    per_prefill_token: float = 2e-4
    per_decode_seq: float = 5e-4

    def cost(self, stats: dict) -> float:
        return (self.base
                + self.per_prefill_token * stats["prefill_tokens"]
                + self.per_decode_seq * stats["decoded"])


# --------------------------------------------------------------------------
# arrival traces
# --------------------------------------------------------------------------

def poisson_trace(*, rate: float, n_requests: int, seed: int = 0,
                  prompt_len: tuple = (8, 16), max_new: tuple = (4, 8),
                  vocab: int = 256, ensemble: int = 1,
                  ensemble_prob: float = 0.0,
                  priorities: Seq[int] = (0,)) -> list[Request]:
    """Poisson arrivals at ``rate`` req/s with random prompts.

    A fraction ``ensemble_prob`` of requests ask for an MC-dropout ensemble
    of size ``ensemble``.  Pure in ``seed`` — the determinism anchor for
    trace replay.
    """
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for rid in range(n_requests):
        t += float(rng.exponential(1.0 / rate))
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        out.append(Request(
            rid=rid,
            prompt=rng.integers(0, vocab, plen).astype(np.int32),
            max_new_tokens=int(rng.integers(max_new[0], max_new[1] + 1)),
            priority=int(rng.choice(list(priorities))),
            ensemble=(ensemble if rng.random() < ensemble_prob else 1),
            seed=seed + rid,
            arrival_time=t,
        ))
    return out


# --------------------------------------------------------------------------
# server
# --------------------------------------------------------------------------

class Server:
    """Synchronous event loop: admit arrivals, run scheduler steps."""

    def __init__(self, scheduler: Scheduler, clock=None,
                 step_cost: Optional[StepCostModel] = None,
                 max_steps: int = 100_000):
        self.scheduler = scheduler
        self.clock = clock if clock is not None else VirtualClock()
        self.step_cost = step_cost if step_cost is not None \
            else StepCostModel()
        self.max_steps = max_steps

    def run(self, trace: Seq[Request]) -> dict:
        """Serve every request in the trace to completion (or rejection).

        Returns {"results": rid -> member outputs, "telemetry": snapshot}.
        """
        sched = self.scheduler
        pending = sorted(trace, key=lambda r: (r.arrival_time, r.rid))
        pending = list(reversed(pending))       # pop() yields earliest
        steps = 0
        while pending or sched.has_work:
            if steps >= self.max_steps:
                raise RuntimeError(
                    f"server exceeded {self.max_steps} steps — "
                    f"scheduler is not draining")
            now = self.clock.now()
            while pending and pending[-1].arrival_time <= now:
                # anchor t_submit to the ARRIVAL time, not when the loop
                # noticed it — queue delay / TTFT must include the wait
                # spent inside the previous step
                req = pending.pop()
                sched.submit(req, req.arrival_time)
            if not sched.has_work:
                if not pending:
                    break
                self.clock.wait_until(pending[-1].arrival_time)
                continue
            stats = sched.step(now, clock=self.clock)
            self.clock.advance(self.step_cost.cost(stats))
            steps += 1
        duration = self.clock.now()
        return {"results": sched.completed,
                "telemetry": sched.telemetry.snapshot(duration_s=duration)}


def aggregate_ensemble(members: list[dict]) -> dict:
    """Combine one request's member outputs into MC-dropout statistics.

    Predictive distribution = mean of member softmaxes over the FIRST
    generated token (prompt uncertainty); disagreement = fraction of
    members whose greedy first token differs from the ensemble mode.
    """
    logits = np.stack([m["first_logits"] for m in members])  # [E, V]
    z = logits - logits.max(-1, keepdims=True)
    probs = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
    p_mean = probs.mean(0)
    entropy = float(-(p_mean * np.log(p_mean + 1e-9)).sum())
    firsts = [m["tokens"][0] for m in members]
    mode = max(set(firsts), key=firsts.count)
    disagree = sum(f != mode for f in firsts) / len(firsts)
    return {
        "p_mean": p_mean,
        "predictive_entropy": entropy,
        "disagreement": float(disagree),
        "mean_ffn_flop_fraction": float(
            np.mean([m["ffn_flop_fraction"] for m in members])),
    }
