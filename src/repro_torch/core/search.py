"""SGD-based Search Algorithm for the dropout-pattern distribution (Alg. 1).

Searches a categorical ``K = softmax(v)`` over periods ``dp ∈ {1..N}``:

    E_p = || K · p_u − p ||²,   E_n = (1/N) Σ_i K_i log K_i,
    loss = λ1·E_p + λ2·E_n,     p_u[i] = (i−1)/i.

A host-side, one-time cost per plan: the loop runs in float32 on CPU
tensors with autograd, SGD + momentum, stopping once |Δloss| falls below the
threshold after ``min_iters`` (the init sits on the entropy plateau).  The
initial logits ``v0`` come from numpy (``search_distribution``) or the
caller (``resume_search``), so a test can hand both packages the same
``v0``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Inputs to Algorithm 1: target rate, support size and loss weights."""

    target_rate: float          # p, the conventional dropout rate to match
    n_patterns: int = 8         # N = dp_max
    lam1: float = 0.95          # fit weight
    lam2: float = 0.05          # entropy weight (lam1 + lam2 = 1)
    lr: float = 1.0
    momentum: float = 0.9
    threshold: float = 1e-12    # |Δloss| stopping criterion
    min_iters: int = 500        # don't trust |Δloss| near the flat init
    max_iters: int = 20_000
    allowed: tuple[int, ...] | None = None  # restrict support (divisor periods)

    def __post_init__(self):
        if not 0.0 <= self.target_rate < 1.0:
            raise ValueError(
                f"target_rate must be in [0,1), got {self.target_rate}")
        if abs(self.lam1 + self.lam2 - 1.0) > 1e-6:
            raise ValueError("lam1 + lam2 must equal 1 (paper Alg. 1)")


def pattern_rates(n: int) -> torch.Tensor:
    """p_u = [0, 1/2, 2/3, ..., (N-1)/N] (float32)."""
    i = torch.arange(1, n + 1, dtype=torch.float32)
    return (i - 1.0) / i


def support_mask(cfg: SearchConfig) -> np.ndarray:
    """[N] bool mask of allowed periods (all-true when unrestricted)."""
    n = cfg.n_patterns
    if cfg.allowed is None:
        return np.ones(n, bool)
    mask = np.zeros(n, bool)
    for dp in cfg.allowed:
        if not (1 <= dp <= n):
            raise ValueError(f"allowed period {dp} outside 1..{n}")
        mask[dp - 1] = True
    if not mask.any():
        raise ValueError("empty allowed-period set")
    return mask


def _loss_fn(v, p_u, mask, target: float, cfg: SearchConfig):
    logits = torch.where(mask, v, torch.tensor(-torch.inf))
    d = torch.softmax(logits, 0)
    e_p = torch.square(torch.dot(d, p_u) - target)
    safe = torch.where(mask & (d > 0), d, torch.ones_like(d))
    e_n = torch.sum(torch.where(mask, d * torch.log(safe),
                                torch.zeros_like(d))) / p_u.shape[0]
    return cfg.lam1 * e_p + cfg.lam2 * e_n


def _value_and_grad(v, p_u, mask, target, cfg):
    v = v.detach().requires_grad_(True)
    loss = _loss_fn(v, p_u, mask, target, cfg)
    (g,) = torch.autograd.grad(loss, v)
    return float(loss.detach()), g


def _run(v0: np.ndarray, cfg: SearchConfig):
    mask = torch.as_tensor(support_mask(cfg))
    p_u = pattern_rates(cfg.n_patterns)
    target = float(np.float32(cfg.target_rate))
    v = torch.as_tensor(np.asarray(v0, np.float32))
    with torch.inference_mode(False), torch.enable_grad():
        loss, _ = _value_and_grad(v, p_u, mask, target, cfg)
        mom = torch.zeros_like(v)
        prev, it = float("inf"), 0
        zero = torch.zeros_like(v)
        while ((it < cfg.min_iters or not abs(prev - loss) < cfg.threshold)
               and it < cfg.max_iters):
            new_loss, g = _value_and_grad(v, p_u, mask, target, cfg)
            mom = cfg.momentum * mom + torch.where(mask, g, zero)
            v = v - cfg.lr * mom
            prev, loss, it = loss, new_loss, it + 1
        d = torch.softmax(torch.where(mask, v, torch.tensor(-torch.inf)), 0)
    return v.numpy(), d.numpy(), loss, it


def search_distribution(cfg: SearchConfig, seed: int = 0):
    """Run Algorithm 1.  Returns (K, loss, iters) with K a [N] numpy array.

    The warm start is ``0.01 · N(0, 1)`` from numpy's generator at ``seed``
    (the JAX package draws it from ``jax.random``, so the two packages'
    searched K agree only to the optimizer's tolerance, not bitwise).
    """
    v0 = 0.01 * np.random.default_rng(seed).standard_normal(cfg.n_patterns)
    _, d, loss, iters = _run(v0.astype(np.float32), cfg)
    return d, loss, iters


def resume_search(v0, cfg: SearchConfig):
    """Warm-restart Algorithm 1 from logits ``v0``; returns (v, K, loss, it)."""
    v0 = np.asarray(v0, np.float32)
    if v0.shape != (cfg.n_patterns,):
        raise ValueError(f"v0 must have shape ({cfg.n_patterns},), "
                         f"got {v0.shape}")
    return _run(v0, cfg)


def expected_rate(k: np.ndarray) -> float:
    """K · p_u — the distribution's expected global dropout rate (Eq. 3)."""
    n = len(k)
    i = np.arange(1, n + 1, dtype=np.float64)
    return float(np.dot(k, (i - 1.0) / i))
