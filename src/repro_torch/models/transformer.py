"""Dense decoder-only LM: config, init, train-path forward.

Twin of ``repro.models.transformer`` for the dense family.  Parameters are a
plain dict; the JAX package's scanned ``params["stacks"][0]`` becomes the
list ``params["layers"]`` (one dict per layer), and ``lax.scan`` over layers
becomes a Python loop.

Every entry point takes a pattern (a ``core.plan.BoundPlan``) and the FFN
computes only the kept 1/dp of its hidden units.  Like the JAX reference,
whose layer scan hands every layer the index 0, each layer resolves the
pattern at layer 0 — so the per-layer bias policy does not vary the bias
across layers (the reference's behaviour, kept for parity).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import plan as plan_mod
from . import layers as L


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The dense-family subset of the JAX package's ``ModelConfig``: the
    fields the ported dense model reads (no sliding window, logit softcap,
    remat or attention chunking yet)."""

    name: str
    family: str                    # only "dense" is ported
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    qkv_bias: bool = False
    rope_theta: float = 1e6
    tie_embeddings: bool = False
    pattern_nb: int = 128          # pattern blocks over d_ff (dp must divide)
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6

    def __post_init__(self):
        if self.family != "dense":
            raise ValueError(f"{self.name}: only the dense family is ported "
                             f"(got {self.family!r})")

    @property
    def tdtype(self) -> torch.dtype:
        """The parameter / activation dtype as a torch dtype."""
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def layer_groups(cfg: ModelConfig) -> list[tuple[str, int]]:
    """Contiguous (kind, count) runs over layers."""
    return [("dense", cfg.n_layers)]


def _dense_layer(cfg: ModelConfig) -> dict:
    dt = cfg.tdtype
    return {"attn": L.init_attention(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.head_dim, cfg.qkv_bias, dt),
            "ffn": L.init_ffn(cfg.d_model, cfg.d_ff, gated=True, dtype=dt),
            "norm1": L.init_rmsnorm(cfg.d_model),
            "norm2": L.init_rmsnorm(cfg.d_model)}


def init_lm(cfg: ModelConfig) -> dict:
    """Abstract parameters (meta tensors): feed to ``layers.materialize``."""
    return {"embed": L.init_embed(cfg.vocab, cfg.d_model, cfg.tie_embeddings,
                                  cfg.tdtype),
            "layers": [_dense_layer(cfg) for _ in range(cfg.n_layers)],
            "final_norm": L.init_rmsnorm(cfg.d_model)}


def _ffn_pat(cfg: ModelConfig, pat) -> plan_mod.BoundPlan:
    """The pattern with nb pinned to the model's pattern blocking."""
    bp = plan_mod.as_bound(pat)
    return dataclasses.replace(bp, nb=cfg.pattern_nb) if bp.active else bp


def _run_dense(cfg, lp, x, pat):
    h = L.rms_norm(lp["norm1"], x, cfg.norm_eps)
    x = x + L.attention_block(lp["attn"], h, n_heads=cfg.n_heads,
                              n_kv=cfg.n_kv_heads, head_dim=cfg.head_dim,
                              rope_theta=cfg.rope_theta)
    h = L.rms_norm(lp["norm2"], x, cfg.norm_eps)
    return x + L.ffn_block(lp["ffn"], h, _ffn_pat(cfg, pat))


@torch.inference_mode()
def forward(cfg: ModelConfig, params, tokens: torch.Tensor, pat=None):
    """Train-path forward (no autograd yet).  tokens: [B, S].
    Returns (logits [B, S, V] f32, aux_loss)."""
    pat = plan_mod.as_bound(pat)
    x = L.embed_tokens(params["embed"], tokens)
    for lp in params["layers"]:
        x = _run_dense(cfg, lp, x, pat)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    logits = L.unembed(params["embed"], x)
    return logits, torch.zeros((), device=logits.device)
