"""Optimizers and the LR schedule over trees (dicts / lists) of tensors.

Twins of ``repro.optim.optimizers`` with the same semantics — this AdamW is
not ``torch.optim.AdamW``: decoupled weight decay applies only to tensors
with ``ndim >= 2``, eps sits outside ``sqrt(nu / bc2)``, the moments are
f32 and a bf16 parameter has no f32 master copy (``p ← (p.f32 − lr·step)
.to(p.dtype)``).

The reference decays by the rank of its *stacked* leaves (one array per
parameter over all layers of a stack), so there a per-layer norm scale is
2-D and decayed.  The port keeps layers as a list of dicts; a leaf inside a
list counts the list as its leading axis (``decay_mask``), which keeps the
reference's rule leaf for leaf.

``update`` computes each leaf's new values out of place, in the reference's
order of operations, and then writes them into the parameter and state
tensors it was given (in place, one leaf at a time: at full width the
moments alone are 12 GB, and a second copy of the trees would not be
needed for anything).  It returns the same trees.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..tree import tree_leaves, tree_map


def _update_leaves(fn, trees) -> None:
    """Run ``fn(*leaves)`` over aligned leaves of ``trees`` without autograd."""
    with torch.no_grad():
        for leaves in zip(*(tree_leaves(t) for t in trees)):
            fn(*leaves)


def decay_mask(tree, stacked: int = 0) -> list[bool]:
    """Per leaf (``tree_leaves`` order): does weight decay apply?  True for
    rank >= 2, where every enclosing list of layers adds one axis."""
    if isinstance(tree, dict):
        return [m for k in tree for m in decay_mask(tree[k], stacked)]
    if isinstance(tree, (list, tuple)):
        return [m for t in tree for m in decay_mask(t, stacked + 1)]
    return [tree.ndim + stacked >= 2]


@dataclasses.dataclass(frozen=True)
class AdamW:
    """Adam with decoupled weight decay on matrices only."""

    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params) -> dict:
        """Zero moments beside every parameter and a step count of 0."""
        zeros = lambda p: torch.zeros(  # noqa: E731
            p.shape, dtype=torch.float32, device=p.device)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "count": 0}

    def update(self, params, grads, state, lr):
        """One AdamW step; returns (params, state), updated in place."""
        c = state["count"] + 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(c))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(c))
        b1, b2 = self.b1, self.b2

        def upd(p, g, mu, nu, decay):
            g32 = g.float()
            mu_n = b1 * mu.float() + (1 - b1) * g32
            nu_n = b2 * nu.float() + (1 - b2) * torch.square(g32)
            step = (mu_n / bc1) / (torch.sqrt(nu_n / bc2) + self.eps)
            if decay:  # decoupled weight decay on matrices only
                step = step + self.weight_decay * p.float()
            p.copy_((p.float() - lr * step).to(p.dtype))
            mu.copy_(mu_n)
            nu.copy_(nu_n)

        _update_leaves(upd, (params, grads, state["mu"], state["nu"],
                             decay_mask(params)))
        state["count"] = c
        return params, state


@dataclasses.dataclass(frozen=True)
class SGDMomentum:
    """Heavy-ball SGD with an f32 momentum buffer."""

    momentum: float = 0.9

    def init(self, params) -> dict:
        """Zero f32 momenta and a step count of 0."""
        return {"mom": tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params),
            "count": 0}

    def update(self, params, grads, state, lr):
        """One momentum step; returns (params, state), updated in place."""
        def upd(p, g, m):
            m_n = self.momentum * m + g.float()
            p.copy_((p - lr * m_n).to(p.dtype))
            m.copy_(m_n)

        _update_leaves(upd, (params, grads, state["mom"]))
        state["count"] += 1
        return params, state


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable[[int], float]:
    """Linear warmup to ``base_lr``, then cosine decay to
    ``min_frac·base_lr`` at ``total``; computed in float32 as the
    reference computes it."""
    f32 = np.float32

    def lr(step) -> float:
        s = f32(step)
        warm = f32(base_lr) * s / f32(max(warmup, 1))
        prog = np.clip((s - f32(warmup)) / f32(max(total - warmup, 1)),
                       f32(0.0), f32(1.0))
        cos = f32(base_lr) * (f32(min_frac) + f32((1 - min_frac) * 0.5)
                              * (f32(1) + np.cos(f32(np.pi) * prog)))
        return float(warm if s < warmup else cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32 (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` so their global norm is at most ``max_norm``.
    Returns (clipped grads, the norm before clipping)."""
    n = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), n
