"""Model building blocks of the dense decoder (plain dict params, JAX layouts).

Twins of ``repro.models.layers``' dense subset.  Parameters are nested dicts
of tensors in the JAX package's layouts (``wq`` [d, H, hd], ``wo``
[H, hd, d], ``w_up``/``w_gate`` [d, d_ff], ``w_down`` [d_ff, d]), so a test
can load the same numbers into both packages.  Attention is plain PyTorch,
as it is plain XLA there; the FFN dispatches the dropout pattern through the
family/backend registries of ``core.plan``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..core import plan as plan_mod
from ..device import resolve_device
from ..tree import tree_map

# --------------------------------------------------------------------------
# Norms and RoPE
# --------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    """An abstract parameter: shape and dtype only (``materialize`` fills)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def init_rmsnorm(dim: int) -> dict:
    return {"scale": _meta((dim,), torch.float32)}


def rms_norm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xf * params["scale"]).to(dt)


def rope_cache(positions: torch.Tensor, dim: int, theta: float = 1e4):
    """positions: [...]; returns cos/sin of shape [..., dim/2] (f32)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=positions.device) / dim
    # a Python-float base: no host-to-device copy (and sync) per call
    freqs = 1.0 / torch.pow(float(theta), exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x: [B, S, H, D]; cos/sin: [B, S, D/2] (broadcast over heads)."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA, causal)
# --------------------------------------------------------------------------

def init_attention(d_model: int, n_heads: int, n_kv: int, head_dim: int,
                   qkv_bias: bool = False, dtype=torch.bfloat16) -> dict:
    params = {"wq": _meta((d_model, n_heads, head_dim), dtype),
              "wk": _meta((d_model, n_kv, head_dim), dtype),
              "wv": _meta((d_model, n_kv, head_dim), dtype),
              "wo": _meta((n_heads, head_dim, d_model), dtype)}
    if qkv_bias:
        params |= {"bq": _meta((n_heads, head_dim), dtype),
                   "bk": _meta((n_kv, head_dim), dtype),
                   "bv": _meta((n_kv, head_dim), dtype)}
    return params


def qkv_project(params, h: torch.Tensor):
    """q [B,S,H,D], k/v [B,S,KH,D] with the optional qkv bias added."""
    q = torch.einsum("bsd,dhk->bshk", h, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, params["wv"])
    if "bq" in params:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return q, k, v


def causal_attention(q, k, v, q_offset: int = 0) -> torch.Tensor:
    """Causal GQA softmax attention in f32 (the twin of the JAX package's
    ``blockwise_attention``, which computes the same softmax in chunks).

    q: [B, Sq, H, D]; k/v: [B, Sk, KH, D]; query i sits at q_offset + i.
    """
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, KH, H // KH, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(D)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    mask = torch.arange(Sk, device=q.device)[None, :] <= q_pos[:, None]
    s = s.masked_fill(~mask, -torch.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len) -> torch.Tensor:
    """One query per sequence over a cache of which positions
    ``[0, cache_len)`` are valid.

    q: [B, 1, H, D]; caches: [B, S, KH, D]; cache_len: int or [B] tensor.
    """
    B, _, H, D = q.shape
    S, KH = k_cache.shape[1], k_cache.shape[2]
    qg = q.float().reshape(B, KH, H // KH, D)
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) / math.sqrt(D)
    n = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    mask = torch.arange(S, device=q.device)[None, :] < n        # [B|1, S]
    s = s.masked_fill(~mask[:, None, None, :], -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


def attention_block(params, x: torch.Tensor, *, n_heads: int, n_kv: int,
                    head_dim: int, rope_theta: float = 1e4,
                    positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full causal attention sub-layer on [B, S, d_model] (dense pattern)."""
    B, S, _ = x.shape
    q, k, v = qkv_project(params, x)
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    cos, sin = rope_cache(positions, head_dim, rope_theta)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    o = causal_attention(q, k, v)
    return torch.einsum("bshk,hkd->bsd", o, params["wo"])


# --------------------------------------------------------------------------
# FFN with Approximate Random Dropout
# --------------------------------------------------------------------------

def init_ffn(d_model: int, d_ff: int, gated: bool = True,
             dtype=torch.bfloat16) -> dict:
    params = {"w_up": _meta((d_model, d_ff), dtype),
              "w_down": _meta((d_ff, d_model), dtype)}
    if gated:
        params["w_gate"] = _meta((d_model, d_ff), dtype)
    return params


def ffn_block(params, x: torch.Tensor, pat=None, *, layer: int = 0,
              act: Callable = F.silu) -> torch.Tensor:
    """(Gated) FFN computing only the kept 1/dp of the hidden dim, on the
    backend the pattern names (slice / gather / cuda / fused)."""
    bp = plan_mod.as_bound(pat).for_layer(layer)
    fam = plan_mod.get_family(bp.family if bp.active else "identity")
    return fam.apply_ffn(x, params["w_up"], params["w_down"],
                         params.get("w_gate"), dp=bp.dp, bias=bp.bias,
                         nb=bp.nb, backend=bp.backend, act=act)


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------

def init_embed(vocab: int, d_model: int, tie: bool,
               dtype=torch.bfloat16) -> dict:
    params = {"tok": _meta((vocab, d_model), dtype)}
    if not tie:
        params["unembed"] = _meta((d_model, vocab), dtype)
    return params


def embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens, params["tok"])


def unembed(params, x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    w = params.get("unembed")
    if w is None:
        w = params["tok"].T
    return (x @ w).float() * scale


# --------------------------------------------------------------------------
# Weight materialization (abstract tree → real random init)
# --------------------------------------------------------------------------

def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def materialize(seed: int, abstract_params, *, device=None) -> dict:
    """Name-aware init on ``device`` (the GPU unless given): embeddings
    N(0,1)·0.02; matmuls fan-in normal; norm scales ones; biases zeros.

    The same name rules as the JAX ``layers.materialize``, drawn from one
    ``torch.Generator`` seeded with ``seed`` in leaf order — the numbers
    differ from the JAX package's (tests load shared weights through
    ``bridge.params_from_jax`` instead).
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    real = {}
    for path, leaf in _paths(abstract_params):
        name = str(path[-1])
        shape, dtype = tuple(leaf.shape), leaf.dtype
        if name == "scale":
            t = torch.ones(shape, dtype=dtype, device=dev)
        elif name.startswith("b") or not shape:
            t = torch.zeros(shape, dtype=dtype, device=dev)
        elif name == "tok":
            t = (torch.randn(shape, generator=gen, device=dev) * 0.02
                 ).to(dtype)
        else:
            if name == "wo":                          # [H, hd, d]
                fan_in = math.prod(shape[-3:-1])
            elif name in ("wq", "wk", "wv"):          # [d, H, hd]
                fan_in = shape[-3]
            elif len(shape) >= 2:                     # [fan_in, fan_out]
                fan_in = shape[-2]
            else:
                fan_in = shape[0]
            std = 1.0 / math.sqrt(max(fan_in, 1))
            t = (torch.randn(shape, generator=gen, device=dev) * std
                 ).to(dtype)
        real[path] = t
    it = iter(_paths(abstract_params))
    return tree_map(lambda _leaf: real[next(it)[0]], abstract_params)
