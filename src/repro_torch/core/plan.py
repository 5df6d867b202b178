"""DropoutPlan — the single configuration surface for structured dropout.

Three registries (the JAX package's DESIGN.md §8), with the same names and
semantics as ``repro.core.plan``:

    BACKENDS       how compact matmuls execute: "slice" | "gather" | "cuda"
                   | "fused"
    FAMILIES       what a pattern drops: "identity" | "rdp"
    BIAS_POLICIES  how per-layer biases derive from the sampled base bias

``DropoutPlan`` is the distribution K over periods plus everything needed to
execute a draw; ``sample(step)`` is a pure function of (seed, step) (numpy
``SeedSequence``, bitwise the JAX package's draws).  ``BoundPlan`` is one
concrete (family, dp, bias) pattern, consumed by the model layers.

The "cuda" backend is the counterpart of the JAX "pallas" one: the compact
up/gate/down products run through the hand-written kernels in
``kernels/rdp_matmul``; "fused" runs the whole FFN in one kernel
(``kernels/fused_ffn``).  Single-device only: the JAX package's mesh
constraints and shard_map dispatch have no counterpart here yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Optional

import numpy as np
import torch

from . import patterns as P
from .search import SearchConfig, search_distribution


class BucketSupersetViolation(ValueError):
    """A redistribution put probability mass outside the plan's buckets."""


# ==========================================================================
# Backend registry
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class Backend:
    """One execution strategy for compact pattern matmuls (forward only:
    the backward kernels come with the training slice)."""

    name: str
    doc: str = ""


BACKENDS: dict[str, Backend] = {}


def register_backend(name: str, doc: str = "") -> Backend:
    """Register an execution backend.  Raises on duplicates."""
    if name in BACKENDS:
        raise ValueError(f"backend {name!r} already registered")
    BACKENDS[name] = Backend(name, doc)
    return BACKENDS[name]


def validate_backend(name: str) -> str:
    """Return ``name`` if registered, else raise a clear ValueError."""
    if name not in BACKENDS:
        raise ValueError(
            f"unknown pattern backend {name!r}; registered backends: "
            f"{sorted(BACKENDS)}")
    return name


register_backend("slice", "strided block slices of the weights, then "
                          "library matmuls")
register_backend("gather", "index_select over kept unit indices, then "
                           "library matmuls")
register_backend("cuda", "compact CUDA kernels: kept column/row blocks are "
                         "the only weights read (kernels/rdp_matmul); their "
                         "plain versions on CPU tensors")
register_backend("fused", "one CUDA kernel for up + activation + gate + "
                          "down over kept blocks (kernels/fused_ffn); its "
                          "plain version on CPU tensors")


# ==========================================================================
# Bias-policy registry
# ==========================================================================

# fn(base_bias, layer, dp) -> int in [0, dp)
BIAS_POLICIES: dict[str, Callable[[int, int, int], int]] = {}


def register_bias_policy(name: str):
    """Decorator registering a per-layer bias derivation."""
    def deco(fn):
        if name in BIAS_POLICIES:
            raise ValueError(f"bias policy {name!r} already registered")
        BIAS_POLICIES[name] = fn
        return fn
    return deco


def validate_bias_policy(name: str) -> str:
    """Return ``name`` if registered, else raise a clear ValueError."""
    if name not in BIAS_POLICIES:
        raise ValueError(
            f"unknown bias policy {name!r}; registered policies: "
            f"{sorted(BIAS_POLICIES)}")
    return name


@register_bias_policy("layer_offset")
def _policy_layer_offset(bias: int, layer: int, dp: int) -> int:
    """Fold the layer index into the bias (cross-layer diversity)."""
    return (bias + layer) % dp


@register_bias_policy("fixed")
def _policy_fixed(bias: int, layer: int, dp: int) -> int:
    """Same bias at every layer."""
    return bias % dp


@register_bias_policy("layer_hash")
def _policy_layer_hash(bias: int, layer: int, dp: int) -> int:
    """Decorrelated layer mixing via a Knuth multiplicative hash."""
    return (bias + ((layer * 2654435761) >> 16)) % dp


# ==========================================================================
# Family registry
# ==========================================================================

class PatternFamily:
    """One structured-dropout pattern family (subclass + ``register_family``)."""

    name: str = "?"
    backends: tuple = ("slice", "gather")

    def validate(self, nb: int, dp: int) -> None:
        """Reject (nb, dp) combinations at construction time."""
        if dp < 1:
            raise ValueError(f"{self.name}: dp must be >= 1, got {dp}")
        if dp > 1 and nb % dp != 0:
            raise ValueError(
                f"{self.name}: block count nb={nb} not divisible by "
                f"dp={dp} — kept shapes would be bias-dependent")

    def check_backend(self, backend: str) -> None:
        """Reject backends this family cannot execute on."""
        validate_backend(backend)
        if backend not in self.backends:
            raise ValueError(
                f"pattern family {self.name!r} does not support backend "
                f"{backend!r}; supported: {list(self.backends)}")

    def apply_ffn(self, x, w_up, w_down, w_gate, *, dp: int, bias: int,
                  nb: int, backend: str, act):
        """(Gated) FFN under this family's pattern."""
        raise NotImplementedError


FAMILIES: dict[str, PatternFamily] = {}


def register_family(cls):
    """Class decorator: instantiate and register a PatternFamily."""
    inst = cls()
    if inst.name in FAMILIES:
        raise ValueError(f"pattern family {inst.name!r} already registered")
    for b in inst.backends:
        validate_backend(b)
    FAMILIES[inst.name] = inst
    return cls


def get_family(name: str) -> PatternFamily:
    """Look up a registered PatternFamily instance by name."""
    if name not in FAMILIES:
        raise ValueError(
            f"unknown pattern family {name!r}; registered families: "
            f"{sorted(FAMILIES)}")
    return FAMILIES[name]


def validate_family(name: str) -> str:
    """Return ``name`` if registered, else raise a clear ValueError."""
    get_family(name)
    return name


# ==========================================================================
# Shared execution helpers
# ==========================================================================

def _slice_blocks(w: torch.Tensor, axis: int, nb: int, dp: int, b: int):
    """Strided keep-slice over ``axis`` split into ``nb`` blocks: keep block
    j iff j % dp == b — the same kept set, in the same order, as
    ``kept_block_indices`` (``(b + j·dp) mod nb``)."""
    if dp == 1:
        return w
    dim = w.shape[axis]
    if dim % nb or nb % dp:
        raise ValueError(f"cannot slice dim {dim} into {nb} blocks at dp {dp}")
    blk = dim // nb
    wt = w.reshape(w.shape[:axis] + (nb, blk) + w.shape[axis + 1:])
    sl = [slice(None)] * wt.ndim
    sl[axis] = slice(b, None, dp)
    return wt[tuple(sl)].reshape(w.shape[:axis] + (dim // dp,)
                                 + w.shape[axis + 1:])


def _gather_blocks(w: torch.Tensor, axis: int, nb: int, dp: int, b: int):
    """index_select twin of ``_slice_blocks`` — same kept set, same order."""
    if dp == 1:
        return w
    idx = P.kept_unit_indices(w.shape[axis], dp, b, w.shape[axis] // nb,
                              device=w.device)
    return w.index_select(axis, idx)


def _rdp_compact_ffn(x, w_up, w_down, w_gate, *, dp, bias, nb, backend, act):
    """The compact (gated) FFN body of the rdp family."""
    block = w_up.shape[-1] // nb
    if backend == "cuda":
        from ..kernels import ops as KO
        return KO.rdp_ffn(x, w_up, w_down, bias, dp=dp, act=act,
                          w_gate=w_gate, block=block)
    if backend == "fused":
        from ..kernels import ops as KO
        return KO.fused_ffn(x, w_up, w_down, bias, dp=dp, act=act,
                            w_gate=w_gate, block=block)
    take = _gather_blocks if backend == "gather" else _slice_blocks
    w_up = take(w_up, 1, nb, dp, bias)
    w_down = take(w_down, 0, nb, dp, bias)
    if w_gate is not None:
        w_gate = take(w_gate, 1, nb, dp, bias)
    h = x @ w_up
    h = act(h) * (x @ w_gate) if w_gate is not None else act(h)
    if dp > 1:
        h = h * dp  # inverted-dropout scale
    return h @ w_down


# ==========================================================================
# Built-in families
# ==========================================================================

@register_family
class IdentityFamily(PatternFamily):
    """dp=1 always — dense execution (eval mode / baseline)."""

    name = "identity"
    backends = ("slice", "gather", "cuda")

    def apply_ffn(self, x, w_up, w_down, w_gate, *, dp, bias, nb, backend,
                  act):
        """Dense (gated) FFN — no pattern applied."""
        h = x @ w_up
        h = act(h) * (x @ w_gate) if w_gate is not None else act(h)
        return h @ w_down



@register_family
class RdpFamily(PatternFamily):
    """Row-based dropout (paper §III-A): drop hidden *neurons* of the FFN
    on a strided block pattern; kept columns of w_up/w_gate and rows of
    w_down form compact matrices at 1/dp the FLOPs."""

    name = "rdp"
    backends = ("slice", "gather", "cuda", "fused")

    def apply_ffn(self, x, w_up, w_down, w_gate, *, dp, bias, nb, backend,
                  act):
        """Compact FFN over kept hidden neurons."""
        return _rdp_compact_ffn(x, w_up, w_down, w_gate, dp=dp, bias=bias,
                                nb=nb, backend=backend, act=act)


# ==========================================================================
# BoundPlan — one concrete pattern, consumed by model code
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class LayerOverride:
    """Per-layer override: pin the bias or switch the pattern off."""

    bias: Optional[int] = None
    off: bool = False


def _freeze_overrides(ov) -> tuple:
    if not ov:
        return ()
    items = sorted(ov.items()) if isinstance(ov, Mapping) else sorted(tuple(ov))
    out = []
    for layer, o in items:
        if isinstance(o, Mapping):
            o = LayerOverride(**o)
        if not isinstance(o, LayerOverride):
            raise TypeError(f"layer override for layer {layer} must be a "
                            f"LayerOverride or mapping, got {type(o)}")
        out.append((int(layer), o))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class BoundPlan:
    """A concrete (family, dp, bias) pattern bound from a DropoutPlan.

    Hashable and validated at construction: ``bias >= dp``, non-divisible
    block counts and unregistered family/backend names raise immediately.
    """

    family: str = "identity"
    dp: int = 1
    bias: int = 0
    nb: int = 128
    backend: str = "slice"
    bias_policy: str = "layer_offset"
    layer_overrides: tuple = ()

    def __post_init__(self):
        fam = get_family(self.family)
        fam.check_backend(self.backend)
        validate_bias_policy(self.bias_policy)
        fam.validate(self.nb, self.dp)
        if self.dp > 1 and not (0 <= self.bias < self.dp):
            raise ValueError(
                f"bias must be in [0, dp): got bias={self.bias}, "
                f"dp={self.dp}")
        ov = _freeze_overrides(self.layer_overrides)
        for layer, o in ov:
            if (o.bias is not None and self.dp > 1
                    and not (0 <= o.bias < self.dp)):
                raise ValueError(
                    f"layer {layer} bias override {o.bias} outside "
                    f"[0, dp={self.dp})")
        object.__setattr__(self, "layer_overrides", ov)

    @property
    def active(self) -> bool:
        """Whether the pattern drops anything (dp > 1)."""
        return self.dp > 1

    @property
    def bucket(self) -> tuple:
        """The (dp, bias) bucket key."""
        return (self.dp, self.bias)

    def _override(self, layer: int) -> Optional[LayerOverride]:
        for lyr, o in self.layer_overrides:
            if lyr == layer:
                return o
        return None

    def layer_bias(self, layer: int) -> int:
        """Deterministic per-layer bias via the plan's policy + overrides."""
        if self.dp <= 1:
            return 0
        o = self._override(layer)
        if o is not None and o.off:
            return 0
        if o is not None and o.bias is not None:
            return o.bias % self.dp
        return BIAS_POLICIES[self.bias_policy](self.bias, layer, self.dp) \
            % self.dp

    def for_layer(self, layer: int) -> "BoundPlan":
        """Resolve this pattern at one layer: bias policy applied, override
        honored (``off`` collapses to the identity pattern)."""
        o = self._override(layer)
        if o is not None and o.off:
            return IDENTITY
        if not self.active:
            return self
        return dataclasses.replace(self, bias=self.layer_bias(layer),
                                   bias_policy="fixed", layer_overrides=())


IDENTITY = BoundPlan()


def as_bound(pat) -> BoundPlan:
    """Normalize a pattern argument (None → identity) to a BoundPlan."""
    if pat is None:
        return IDENTITY
    if isinstance(pat, BoundPlan):
        return pat
    raise TypeError(f"cannot interpret {type(pat).__name__} as a dropout "
                    f"pattern; pass a BoundPlan")


# ==========================================================================
# DropoutPlan — the distribution over patterns
# ==========================================================================

@dataclasses.dataclass(frozen=True)
class DropoutPlan:
    """A distribution K over periods dp=1..N for one pattern family, plus
    block geometry, backend, bias policy and per-layer overrides."""

    family: str
    dist: tuple                      # K over dp = 1..N
    nb: int = 128                    # pattern blocks in the dropped dim
    block: int = 128                 # units per block (mask oracles)
    backend: str = "slice"
    bias_policy: str = "layer_offset"
    seed: int = 0
    layer_overrides: tuple = ()

    def __post_init__(self):
        fam = get_family(self.family)
        fam.check_backend(self.backend)
        validate_bias_policy(self.bias_policy)
        d = np.asarray(self.dist, np.float64)
        if d.ndim != 1 or d.size < 1:
            raise ValueError("dist must be a 1-D categorical distribution")
        if not np.isclose(d.sum(), 1.0, atol=1e-5):
            raise ValueError(f"dist must sum to 1, got {d.sum()}")
        d = d / d.sum()
        object.__setattr__(self, "dist", tuple(d.tolist()))
        object.__setattr__(self, "layer_overrides",
                           _freeze_overrides(self.layer_overrides))
        for dp in self.support():
            fam.validate(self.nb, dp)

    @property
    def n_patterns(self) -> int:
        """Size N of the categorical K (periods dp = 1..N)."""
        return len(self.dist)

    def support(self) -> list[int]:
        """Distinct dp values with nonzero probability."""
        return [i + 1 for i, k in enumerate(self.dist) if k > 1e-9]

    def buckets(self) -> list[tuple[int, int]]:
        """Every (dp, bias) bucket this plan can produce."""
        return [(dp, b) for dp in self.support() for b in range(dp)]

    def expected_rate(self) -> float:
        """K · p_u — the plan's expected global dropout rate (Eq. 3)."""
        dps = np.arange(1, self.n_patterns + 1, dtype=np.float64)
        return float(np.dot(self.dist, (dps - 1.0) / dps))

    def bind(self, dp: int, bias: int) -> BoundPlan:
        """Bind one concrete (dp, bias) draw — validated at construction."""
        return BoundPlan(family=self.family, dp=dp, bias=bias, nb=self.nb,
                         backend=self.backend, bias_policy=self.bias_policy,
                         layer_overrides=self.layer_overrides)

    def identity(self) -> BoundPlan:
        """The dp=1 (eval-mode) binding of this plan."""
        return self.bind(1, 0)

    def sample(self, step: Optional[int] = None, *,
               rng: Optional[np.random.Generator] = None) -> BoundPlan:
        """Deterministic BoundPlan for a step (or a draw from ``rng``)."""
        if rng is None:
            if step is None:
                raise ValueError("sample() needs a step or an rng")
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, int(step)]))
        dp = int(rng.choice(self.n_patterns, p=self.dist)) + 1
        b = int(rng.integers(0, dp))  # uniform over {0..dp-1}
        return self.bind(dp, b)

    def reseed(self, seed: int) -> "DropoutPlan":
        """The same plan with a different sampling seed."""
        return dataclasses.replace(self, seed=seed)

    def with_backend(self, backend: str) -> "DropoutPlan":
        """The same plan executing on a different backend (re-validated)."""
        return dataclasses.replace(self, backend=backend)

    def with_nb(self, nb: int) -> "DropoutPlan":
        """The same plan with the pattern-block count pinned to ``nb``."""
        return dataclasses.replace(self, nb=nb)

    def with_dist(self, dist) -> "DropoutPlan":
        """A re-distributed view inside this plan's bucket universe."""
        d = np.asarray(dist, np.float64)
        if d.shape != (self.n_patterns,):
            raise BucketSupersetViolation(
                f"with_dist: distribution has shape {d.shape}, the bucket "
                f"universe is over {self.n_patterns} periods")
        escaped = [i + 1 for i, k in enumerate(d)
                   if k > 1e-9 and (i + 1) not in self.support()]
        if escaped:
            raise BucketSupersetViolation(
                f"with_dist: new support {escaped} escapes the superset "
                f"{self.support()}; reweight within it instead")
        return dataclasses.replace(self, dist=tuple(d.tolist()))


# ==========================================================================
# Constructors
# ==========================================================================

def build_plan(family: str, target_rate: float, nb: int, dp_max: int = 8,
               block: int = 128, backend: str = "slice", seed: int = 0,
               lam1: float = 0.85, lam2: float = 0.15,
               bias_policy: str = "layer_offset",
               layer_overrides=()) -> DropoutPlan:
    """Search K (Alg. 1) restricted to divisor periods of ``nb`` and wrap
    it in a DropoutPlan."""
    validate_family(family)
    allowed = tuple(P.valid_periods(nb, dp_max))
    if allowed == (1,):
        raise ValueError(
            f"dimension with {nb} blocks admits no nontrivial period "
            f"<= {dp_max}; increase dp_max or change blocking")
    cfg = SearchConfig(target_rate=target_rate, n_patterns=dp_max,
                       lam1=lam1, lam2=lam2, allowed=allowed)
    k, _, _ = search_distribution(cfg, seed=seed)
    return DropoutPlan(family=family, dist=tuple(k.tolist()), nb=nb,
                       block=block, backend=backend, seed=seed,
                       bias_policy=bias_policy,
                       layer_overrides=layer_overrides)


def identity_plan(family: str = "identity", nb: int = 128,
                  block: int = 128) -> DropoutPlan:
    """dp=1 always — no dropout (eval mode / baseline)."""
    return DropoutPlan(family=family, dist=(1.0,), nb=nb, block=block)
