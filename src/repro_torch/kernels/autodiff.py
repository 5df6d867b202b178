"""Autograd rules for the compact RDP matmuls (twin of the RDP half of
``repro.kernels.autodiff``).

Each forward kernel of ``rdp_matmul`` becomes a ``torch.autograd.Function``
whose backward runs the dropout-aware backward kernels of
``rdp_matmul_bwd`` — 1/dp of the dense FLOPs in the backward pass too — and
places the compact weight grads into a zero ``dW``, so dropped blocks get
exactly zero gradient (their true gradient: the forward does not read
them).  The bias is an index, not a weight: its gradient is ``None``.
``kernels.ops`` keeps ``dp == 1`` a plain product with PyTorch's own
adjoints.

The Functions run on both devices: on CPU tensors every wrapper they call
takes its kernel's plain version, so the CPU tests exercise the same
backward.  The TDP half (``tdp_matmul_vjp``, ``expand_tdp_wgrad``) comes
with the tdp family.
"""
from __future__ import annotations

import torch

from ..core import patterns as P
from .rdp_matmul import rdp_matmul_cols, rdp_matmul_rows
from .rdp_matmul_bwd import (rdp_cols_dgrad, rdp_cols_wgrad, rdp_rows_dgrad,
                             rdp_rows_wgrad)


def scatter_col_blocks(dwc, n: int, dp: int, bias: int, *, block: int):
    """Place compact column-block grads [K, N/dp] into a zero dW [K, N]:
    compact block j lands at block ``(bias + j·dp) mod (N/block)``."""
    idx = P.kept_unit_indices(n, dp, bias, block, device=dwc.device)
    return dwc.new_zeros((dwc.shape[0], n)).index_copy_(1, idx, dwc)


def scatter_row_blocks(dwc, k: int, dp: int, bias: int, *, block: int):
    """Place compact row-block grads [K/dp, N] into a zero dW [K, N]."""
    idx = P.kept_unit_indices(k, dp, bias, block, device=dwc.device)
    return dwc.new_zeros((k, dwc.shape[1])).index_copy_(0, idx, dwc)


class RdpMatmulCols(torch.autograd.Function):
    """C[M, N/dp] = A @ W[:, kept] (×dp if ``scale``); backward: kernels
    ``rdp_cols_dgrad`` + ``rdp_cols_wgrad``, then ``scatter_col_blocks``."""

    @staticmethod
    def forward(ctx, a, w, bias: int, dp: int, block: int, scale: bool):
        """Kernel ``rdp_matmul_cols``; keeps A and W for the backward."""
        ctx.save_for_backward(a, w)
        ctx.pattern = (bias, dp, block, scale)
        return rdp_matmul_cols(a, w, bias, dp=dp, block=block, scale=scale)

    @staticmethod
    def backward(ctx, dc):
        """(dA, dW, None...): kernels 4 + 5, then the column scatter."""
        a, w = ctx.saved_tensors
        bias, dp, block, scale = ctx.pattern
        dc = dc.contiguous()
        da = dw = None
        if ctx.needs_input_grad[0]:
            da = rdp_cols_dgrad(dc, w, bias, dp=dp, block=block,
                                scale=scale).to(a.dtype)
        if ctx.needs_input_grad[1]:
            dwc = rdp_cols_wgrad(a, dc, dp=dp, block=block, scale=scale)
            dw = scatter_col_blocks(dwc, w.shape[1], dp, bias,
                                    block=block).to(w.dtype)
        return da, dw, None, None, None, None


class RdpMatmulRows(torch.autograd.Function):
    """C[M, N] = Ac @ W[kept rows, :] (×dp if ``scale``); backward: kernels
    ``rdp_rows_dgrad`` + ``rdp_rows_wgrad``, then ``scatter_row_blocks``."""

    @staticmethod
    def forward(ctx, a_compact, w, bias: int, dp: int, block: int,
                scale: bool):
        """Kernel ``rdp_matmul_rows``; keeps Ac and W for the backward."""
        ctx.save_for_backward(a_compact, w)
        ctx.pattern = (bias, dp, block, scale)
        return rdp_matmul_rows(a_compact, w, bias, dp=dp, block=block,
                               scale=scale)

    @staticmethod
    def backward(ctx, dc):
        """(dAc, dW, None...): kernels 6 + 7, then the row scatter."""
        ac, w = ctx.saved_tensors
        bias, dp, block, scale = ctx.pattern
        dc = dc.contiguous()
        dac = dw = None
        if ctx.needs_input_grad[0]:
            dac = rdp_rows_dgrad(dc, w, bias, dp=dp, block=block,
                                 scale=scale).to(ac.dtype)
        if ctx.needs_input_grad[1]:
            dwc = rdp_rows_wgrad(ac, dc, dp=dp, block=block, scale=scale)
            dw = scatter_row_blocks(dwc, w.shape[0], dp, bias,
                                    block=block).to(w.dtype)
        return dac, dw, None, None, None, None


def rdp_matmul_cols_vjp(a, w, bias: int, dp: int, block: int,
                        scale: bool = True):
    """Differentiable ``rdp_matmul_cols`` on 2-D ``a``."""
    return RdpMatmulCols.apply(a.contiguous(), w, int(bias), dp, block,
                               scale)


def rdp_matmul_rows_vjp(a_compact, w, bias: int, dp: int, block: int,
                        scale: bool = False):
    """Differentiable ``rdp_matmul_rows`` on 2-D ``a_compact``."""
    return RdpMatmulRows.apply(a_compact.contiguous(), w, int(bias), dp,
                               block, scale)
