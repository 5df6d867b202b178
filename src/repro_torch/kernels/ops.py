"""Compact-FFN ops over the kernels, with the JAX package's numerics order.

``rdp_ffn`` keeps ``repro.kernels.ops.rdp_ffn``'s order: up and gate
projections unscaled (each cast to the activation dtype), then
``act(h) * g``, then ×dp, then the unscaled down projection.  ``dp == 1``
is a plain dense product.  Each wrapper launches its CUDA kernel on CUDA
tensors and takes the kernel's plain version on CPU tensors.
"""
from __future__ import annotations

import torch.nn.functional as F

from .fused_ffn import fused_ffn_fwd
from .rdp_matmul import rdp_matmul_cols, rdp_matmul_rows


def rdp_up(a, w, bias: int, *, dp: int, block: int, scale: bool = True):
    """Compact up-projection: [., K] @ [K, N] -> [., N/dp] (×dp if scale)."""
    if dp == 1:
        return a @ w
    lead = a.shape[:-1]
    out = rdp_matmul_cols(a.reshape(-1, a.shape[-1]), w, bias, dp=dp,
                          block=block, scale=scale)
    return out.reshape(*lead, -1)


def rdp_down(a_compact, w, bias: int, *, dp: int, block: int):
    """Compact down-projection: [., K/dp] @ [K, N] -> [., N]."""
    if dp == 1:
        return a_compact @ w
    lead = a_compact.shape[:-1]
    out = rdp_matmul_rows(a_compact.reshape(-1, a_compact.shape[-1]), w,
                          bias, dp=dp, block=block)
    return out.reshape(*lead, -1)


def rdp_ffn(x, w_up, w_down, bias: int, *, dp: int, act=F.relu,
            w_gate=None, block: int):
    """h = act(x @ Wup[:,kept]) [* (x @ Wgate[:,kept])] ×dp;
    y = h @ Wdown[kept,:] — through the compact kernels."""
    h = rdp_up(x, w_up, bias, dp=dp, block=block, scale=False)
    if w_gate is None:
        h = act(h)
    else:
        g = rdp_up(x, w_gate, bias, dp=dp, block=block, scale=False)
        h = act(h) * g
    if dp > 1:
        h = h * dp
    return rdp_down(h, w_down, bias, dp=dp, block=block)


def fused_ffn(x, w_up, w_down, bias: int, *, dp: int, act=F.relu,
              w_gate=None, block: int):
    """Single-kernel compact FFN; ``dp == 1`` is the dense FFN."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if dp == 1:
        h = act(x2 @ w_up)
        if w_gate is not None:
            h = h * (x2 @ w_gate)
        out = h.to(x2.dtype) @ w_down
    else:
        out = fused_ffn_fwd(x2, w_up, w_gate, w_down, bias, dp=dp,
                            block=block, act=act)
    return out.reshape(*lead, -1)
