"""RDP applied to an FFN block: the compact path and its mask oracle.

Inverted-dropout scaling: kept activations are multiplied by ``dp``
(= 1/keep_prob) after the activation, so eval (dp = 1) needs no rescale.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from . import patterns as P


def rdp_ffn_apply(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                  dp: int, b: int, *, act: Callable = F.relu,
                  w_gate: Optional[torch.Tensor] = None,
                  b_up: Optional[torch.Tensor] = None,
                  block: int, scale: bool = True) -> torch.Tensor:
    """Compact FFN under RDP: only kept hidden neurons are computed.

    x: [..., d_in]; w_up/w_gate: [d_in, d_ff]; w_down: [d_ff, d_out].
    """
    if dp == 1:
        h = x @ w_up
        if b_up is not None:
            h = h + b_up
        h = act(h) if w_gate is None else act(h) * (x @ w_gate)
        return h @ w_down
    idx = P.kept_unit_indices(w_up.shape[-1], dp, b, block, device=x.device)
    h = x @ w_up.index_select(-1, idx)
    if b_up is not None:
        h = h + b_up.index_select(-1, idx)
    if w_gate is None:
        h = act(h)
    else:
        h = act(h) * (x @ w_gate.index_select(-1, idx))
    if scale:
        h = h * dp
    return h @ w_down.index_select(0, idx)


def rdp_ffn_oracle(x, w_up, w_down, dp: int, b: int, *, act=F.relu,
                   w_gate=None, b_up=None, block: int, scale: bool = True):
    """Mask-multiply semantics (what dense frameworks execute, Fig. 1a)."""
    h = x @ w_up
    if b_up is not None:
        h = h + b_up
    h = act(h) if w_gate is None else act(h) * (x @ w_gate)
    h = h * P.rdp_mask(w_up.shape[-1], dp, b, block, h.dtype,
                       device=h.device)
    if scale and dp > 1:
        h = h * dp
    return h @ w_down
