"""Autograd rules for the compact RDP and TDP matmuls (twin of
``repro.kernels.autodiff``).

Each forward kernel of ``rdp_matmul`` and ``tdp_matmul`` becomes a
``torch.autograd.Function`` whose backward runs the dropout-aware backward
kernels of ``rdp_matmul_bwd`` / ``tdp_matmul_bwd`` — 1/dp of the dense
FLOPs in the backward pass too — and places the compact weight grads into a
zero ``dW``, so dropped blocks and tiles get exactly zero gradient (their
true gradient: the forward does not read them).  The bias is an index, not
a weight: its gradient is ``None``.  ``kernels.ops`` keeps ``dp == 1`` a
plain product with PyTorch's own adjoints.

The Functions run on both devices: on CPU tensors every wrapper they call
takes its kernel's plain version, so the CPU tests exercise the same
backward.
"""
from __future__ import annotations

import torch

from ..core import patterns as P
from .rdp_matmul import rdp_matmul_cols, rdp_matmul_rows
from .rdp_matmul_bwd import (rdp_cols_dgrad, rdp_cols_wgrad, rdp_rows_dgrad,
                             rdp_rows_wgrad)
from .tdp_matmul import tdp_matmul
from .tdp_matmul_bwd import tdp_dgrad, tdp_wgrad


def scatter_col_blocks(dwc, n: int, dp: int, bias: int, *, block: int):
    """Place compact column-block grads [K, N/dp] into a zero dW [K, N]:
    compact block j lands at block ``(bias + j·dp) mod (N/block)``."""
    idx = P.kept_unit_indices(n, dp, bias, block, device=dwc.device)
    return dwc.new_zeros((dwc.shape[0], n)).index_copy_(1, idx, dwc)


def scatter_row_blocks(dwc, k: int, dp: int, bias: int, *, block: int):
    """Place compact row-block grads [K/dp, N] into a zero dW [K, N]."""
    idx = P.kept_unit_indices(k, dp, bias, block, device=dwc.device)
    return dwc.new_zeros((k, dwc.shape[1])).index_copy_(0, idx, dwc)


def expand_tdp_wgrad(dwc, k: int, dp: int, bias: int, *, tile: int):
    """Expand the compact TDP wgrad [K/dp, N] into the full dW [K, N]: slot
    ``s`` of tile-column ``j`` lands at row-tile ``(bias - j) mod dp +
    s·dp``, every other tile exactly zero."""
    kept_rows, n = dwc.shape
    kept, tr, tc = kept_rows // tile, k // tile, n // tile
    # [kept, tc, tile, tile]: slot-major view of the compact grads
    src = dwc.reshape(kept, tile, tc, tile).permute(0, 2, 1, 3)
    j = torch.arange(tc, device=dwc.device)
    rows = P.tdp_kept_row_tile(j[None, :],
                               torch.arange(kept, device=dwc.device)[:, None],
                               dp, bias)                      # [kept, tc]
    out = dwc.new_zeros((tr, tile, tc, tile))
    out[rows, :, j[None, :], :] = src
    return out.reshape(k, n)


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


class TdpMatmul(torch.autograd.Function):
    """C[M, N] = (A @ (W ∘ diagonal-TDP-mask)) (×dp if ``scale``); backward:
    kernel ``tdp_dgrad`` when dp divides W's tile-columns, else the
    reference's mask-multiply adjoint (f32 ``dC @ (W∘mask)ᵀ``, then ×dp);
    kernel ``tdp_wgrad``, then ``expand_tdp_wgrad``."""

    @staticmethod
    def forward(ctx, a, w, bias: int, dp: int, tile: int, scale: bool):
        """Kernel ``tdp_matmul``; keeps A and W for the backward."""
        ctx.save_for_backward(a, w)
        ctx.pattern = (bias, dp, tile, scale)
        return tdp_matmul(a, w, bias, dp=dp, tile=tile, scale=scale)

    @staticmethod
    def backward(ctx, dc):
        """(dA, dW, None...): kernel 9 or the mask-multiply adjoint, then
        kernel 10 and the tile expansion."""
        a, w = ctx.saved_tensors
        bias, dp, tile, scale = ctx.pattern
        dc = dc.contiguous()
        kdim, n = w.shape
        da = dw = None
        if ctx.needs_input_grad[0]:
            if (n // tile) % dp == 0:
                da = tdp_dgrad(dc, w, bias, dp=dp, tile=tile, scale=scale)
            else:
                # dp does not divide the output tile-columns: the kept
                # counts per input tile-row depend on the bias, so (as the
                # reference does) take the dense mask-multiply adjoint
                mask = P.tdp_mask(kdim, n, dp, bias, tile, device=w.device)
                da = dc.float() @ (w.float() * mask).T
                if scale:
                    da = da * dp
            da = da.to(a.dtype)
        if ctx.needs_input_grad[1]:
            dwc = tdp_wgrad(a, dc, bias, dp=dp, tile=tile, scale=scale)
            dw = expand_tdp_wgrad(dwc, kdim, dp, bias,
                                  tile=tile).to(w.dtype)
        return da, dw, None, None, None, None


def tdp_matmul_vjp(a, w, bias: int, dp: int, tile: int, scale: bool = True):
    """Differentiable ``tdp_matmul`` on 2-D ``a``."""
    return TdpMatmul.apply(a.contiguous(), w, int(bias), dp, tile, scale)
