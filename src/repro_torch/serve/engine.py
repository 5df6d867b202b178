"""Serving engine: KV caches, prefill, chunked prefill, ragged decode.

Twin of ``repro.serve.engine`` for plain-attention dense models.  The cache
keeps the JAX layout — ``{"layers": [{"k", "v"}], "pos"}`` with one entry per
decode group and leaves ``[n_layers, B, C, KH, HD]`` — so the paged store and
the tests line up with the reference.  ``pos`` is an int (one position for
the batch) or a ``[B]`` int64 tensor (``decode_step_ragged``).

Unlike the JAX functions, which return new arrays, the entry points here
write the new K/V into the cache they are given, in place, and return it:
that saves a copy of the whole cache per step.  Callers hand them caches
they own (the paged store always gathers a fresh one).

Every entry point takes a pattern (a ``core.plan.BoundPlan``) and applies it
to the FFN exactly like the train-path ``forward`` — that is what lets the
MC-dropout runtime run each ensemble member as a (dp, b) sub-model.  They run
under ``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..models import layers as L
from ..models.transformer import ModelConfig, _ffn_pat, layer_groups
from ..tree import tree_map


@dataclasses.dataclass(frozen=True)
class DecodeGroup:
    """A contiguous run of same-kind layers sharing one cache entry."""

    kind: str
    start: int
    count: int


def decode_groups(cfg: ModelConfig) -> list[DecodeGroup]:
    groups, layer = [], 0
    for kind, count in layer_groups(cfg):
        groups.append(DecodeGroup(kind, layer, count))
        layer += count
    return groups


def init_cache(cfg: ModelConfig, B: int, max_len: int, *,
               device=None) -> dict:
    """Zeroed cache for ``B`` sequences of ``max_len`` positions, on
    ``device`` (the GPU unless given)."""
    dev = resolve_device(device)
    layers = []
    for g in decode_groups(cfg):
        shape = (g.count, B, max_len, cfg.n_kv_heads, cfg.head_dim)
        layers.append({"k": torch.zeros(shape, dtype=cfg.tdtype, device=dev),
                       "v": torch.zeros(shape, dtype=cfg.tdtype, device=dev)})
    return {"layers": layers, "pos": 0}


def _layer_params(params, cfg):
    """(group cache index, layer index within group, layer params)."""
    for gi, g in enumerate(decode_groups(cfg)):
        for i in range(g.count):
            yield gi, i, params["layers"][g.start + i]


def _rope(cfg, q, k, positions):
    cos, sin = L.rope_cache(positions, q.shape[-1], cfg.rope_theta)
    return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)


def _ffn_residual(cfg, lp, x, pat):
    h2 = L.rms_norm(lp["norm2"], x, cfg.norm_eps)
    return x + L.ffn_block(lp["ffn"], h2, _ffn_pat(cfg, pat))


def _logits(cfg, params, x_last):
    x = L.rms_norm(params["final_norm"], x_last, cfg.norm_eps)
    return L.unembed(params["embed"], x)[:, 0]


# --------------------------------------------------------------------------
# prefill (whole prompt) and chunked prefill
# --------------------------------------------------------------------------

@torch.inference_mode()
def prefill(cfg: ModelConfig, params, tokens: torch.Tensor, max_len: int,
            pat=None):
    """Process a full prompt: returns (last-token logits [B, V], cache)."""
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    x = L.embed_tokens(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    for gi, i, lp in _layer_params(params, cfg):
        h = L.rms_norm(lp["norm1"], x, cfg.norm_eps)
        q, k, v = L.qkv_project(lp["attn"], h)
        q, k = _rope(cfg, q, k, positions)
        o = L.causal_attention(q, k, v)
        x = x + torch.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"])
        cl = cache["layers"][gi]
        cl["k"][i, :, :S] = k
        cl["v"][i, :, :S] = v
        x = _ffn_residual(cfg, lp, x, pat)
    cache["pos"] = S
    return _logits(cfg, params, x[:, -1:]), cache


@torch.inference_mode()
def prefill_extend(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                   pat=None):
    """Extend a cache at position ``cache["pos"]`` (an int shared by the
    batch) by one prompt chunk ``tokens`` [B, Sc].  Returns (last-token
    logits [B, V], the cache advanced to pos + Sc)."""
    if not supports_chunked_prefill(cfg):
        raise ValueError(f"{cfg.name}: arch does not support chunked prefill")
    pos0 = int(cache["pos"])
    B, Sc = tokens.shape
    x = L.embed_tokens(params["embed"], tokens)
    positions = pos0 + torch.arange(Sc, device=tokens.device)[None, :]
    positions = positions.expand(B, Sc)
    for gi, i, lp in _layer_params(params, cfg):
        h = L.rms_norm(lp["norm1"], x, cfg.norm_eps)
        q, k, v = L.qkv_project(lp["attn"], h)
        q, k = _rope(cfg, q, k, positions)
        kc, vc = cache["layers"][gi]["k"][i], cache["layers"][gi]["v"][i]
        kc[:, pos0:pos0 + Sc] = k
        vc[:, pos0:pos0 + Sc] = v
        # queries at [pos0, pos0+Sc) over the cache, keys already written
        o = L.causal_attention(q, kc, vc, q_offset=pos0)
        x = x + torch.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"])
        x = _ffn_residual(cfg, lp, x, pat)
    return _logits(cfg, params, x[:, -1:]), {"layers": cache["layers"],
                                             "pos": pos0 + Sc}


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

@torch.inference_mode()
def decode_step_ragged(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                       pat=None):
    """One decode step for sequences at different positions.

    ``cache["pos"]`` is a per-sequence ``[B]`` int tensor (or list); the
    JAX package vmaps its scalar-position step over the batch, here the
    batch dimension is written out: each sequence writes its K/V at its own
    position and attends over ``[0, pos]``.  tokens: [B, 1].  Returns
    (logits [B, V], the cache with pos incremented per sequence).
    """
    B = tokens.shape[0]
    pos = torch.as_tensor(cache["pos"], dtype=torch.int64,
                          device=tokens.device).reshape(B)
    rows = torch.arange(B, device=tokens.device)
    x = L.embed_tokens(params["embed"], tokens)
    for gi, i, lp in _layer_params(params, cfg):
        h = L.rms_norm(lp["norm1"], x, cfg.norm_eps)
        q, k, v = L.qkv_project(lp["attn"], h)
        q, k = _rope(cfg, q, k, pos[:, None])
        kc, vc = cache["layers"][gi]["k"][i], cache["layers"][gi]["v"][i]
        kc[rows, pos] = k[:, 0]
        vc[rows, pos] = v[:, 0]
        o = L.decode_attention(q, kc, vc, pos + 1)
        x = x + torch.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"])
        x = _ffn_residual(cfg, lp, x, pat)
    return _logits(cfg, params, x), {"layers": cache["layers"],
                                     "pos": pos + 1}


def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                pat=None):
    """One token for every sequence, all at the int position
    ``cache["pos"]``.  Returns (logits [B, V], cache at pos + 1)."""
    B = tokens.shape[0]
    pos = int(cache["pos"])
    ragged = {"layers": cache["layers"], "pos": [pos] * B}
    logits, new = decode_step_ragged(cfg, params, ragged, tokens, pat)
    return logits, {"layers": new["layers"], "pos": pos + 1}


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked prefill covers the plain-attention dense family."""
    return cfg.family == "dense"


# --------------------------------------------------------------------------
# paged KV primitives: block-table reads, span write-back
# --------------------------------------------------------------------------
#
# Every cache leaf carries the sequence dimension at axis 2 ([n_layers, B, C,
# KH, HD]); pages partition that axis into fixed-size chunks, so a page
# fragment is ``init_cache(cfg, 1, page_size)``'s layers.

PAGED_SEQ_AXIS = 2


def supports_paged_kv(cfg: ModelConfig) -> bool:
    """Whether every cache group of ``cfg`` has a pageable seq axis."""
    return cfg.family == "dense"


def page_slice(layers, lo: int, hi: int, axis: int = PAGED_SEQ_AXIS):
    """Positions ``[lo, hi)`` of a cache ``layers`` tree (views)."""
    return tree_map(lambda a: a.narrow(axis, lo, hi - lo), layers)


def page_update(frag, chunk, off: int, axis: int = PAGED_SEQ_AXIS):
    """Write ``chunk`` into fragment ``frag`` at offset ``off``, in place.

    The caller guarantees that ``frag`` is private to one page (the paged
    store clones shared and template fragments before writing)."""
    def write(f, c):
        f.narrow(axis, off, c.shape[axis]).copy_(c)
        return f
    return tree_map(write, frag, chunk)


def page_join(frags, axis: int = PAGED_SEQ_AXIS):
    """Concatenate page fragments into the dense cache layout.  Always a
    new tensor, so the result may be written without touching a page."""
    return tree_map(lambda *a: torch.cat(a, dim=axis), *frags)
