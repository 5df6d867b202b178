"""Fused compact FFN: CUDA kernel (``csrc/fused_ffn.cu``) + plain version.

``y = (act(x @ Wu[:, kept]) [· (x @ Wg[:, kept])] · dp).astype(x.dtype)
@ Wd[kept, :]`` with the ``[tokens, d_ff/dp]`` hidden activation kept in
shared memory.  Replaces the TPU kernel ``fused_ffn_fwd``
(src/repro/kernels/fused_ffn.py:93, body ``_fused_kernel`` :45).  Bound by
the kept weight bytes (3·d_model·d_ff/dp elements) at the serving path's
small M; each CTA computes one chunk of kept hidden units once and writes an
f32 partial of the output, which a second pass sums and casts (the TPU
kernel's resident ``[bm, d_model]`` accumulator does not fit one SM at
d_model 1536).  At M <= 16 a GEMV-shaped variant streams the weight rows
of one chunk of 32·V kept hidden units per CTA.

A CUDA tensor launches the kernel (and adds one to ``FUSED_FFN.launches``)
or raises; a CPU tensor takes the plain version.  ``FusedFFN`` is its
autograd rule (the twin of ``fused_ffn_gated_vjp`` / ``fused_ffn_plain_vjp``
and ``_bwd_common``, src/repro/kernels/fused_ffn.py:145-252): the backward
rematerializes the compact hidden activation with ``rdp_matmul_cols`` and
runs the four backward kernels of ``rdp_matmul_bwd``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import patterns as P
from . import _build
from .autodiff import scatter_col_blocks, scatter_row_blocks
from .rdp_matmul import (BN, DTYPES, WARPS, _check_pattern, bm_for,
                         check_args, rdp_matmul_cols, skinny_rows, vec_for)
from .rdp_matmul_bwd import (rdp_cols_dgrad, rdp_cols_wgrad, rdp_rows_dgrad,
                             rdp_rows_wgrad)

FUSED_FFN = _build.Kernel("fused_ffn_fwd", "src/repro_torch/csrc/fused_ffn.cu",
                          "src/repro/kernels/fused_ffn.py:93")

# activations the kernel implements, by the callable the model passes
ACTS = {F.silu: 0, F.relu: 1}
FUSED_SKINNY_SMEM = 227 * 1024      # opt-in shared memory of one CTA


def skinny_smem(m: int, vec: int, kdim: int) -> int:
    """Dynamic shared memory (bytes) of the skinny fused kernel: Wd row
    offsets, x rows, per-warp partials of u and g, and the hidden chunk."""
    mt, cw = skinny_rows(m), 32 * vec
    return 8 * cw + 4 * (mt * kdim + 2 * WARPS * mt * cw + mt * cw)


def fused_ffn_plain(x, w_up, w_gate, w_down, bias: int, *, dp: int,
                    block: int, act=F.silu):
    """Plain PyTorch version of ``fused_ffn_fwd``: f32 hidden, cast to
    ``x.dtype`` after ×dp, f32 down product, one final cast."""
    idx = P.kept_unit_indices(w_up.shape[-1], dp, bias, block,
                              device=x.device)
    xf = x.float()
    h = act(xf @ w_up.index_select(-1, idx).float())
    if w_gate is not None:
        h = h * (xf @ w_gate.index_select(-1, idx).float())
    h = (h * dp).to(x.dtype)
    return (h.float() @ w_down.index_select(0, idx).float()).to(x.dtype)


def fused_ffn_fwd(x2, w_up, w_gate, w_down, bias: int, *, dp: int,
                  block: int, act=F.silu):
    """y[M, O] over kept blocks only; x2 [M, K], w_up/w_gate [K, N],
    w_down [N, O] (w_gate may be None)."""
    m, kdim = x2.shape
    k2, n = w_up.shape
    nd, odim = w_down.shape
    if kdim != k2 or nd != n or (w_gate is not None
                                 and w_gate.shape != w_up.shape):
        raise ValueError(f"fused_ffn_fwd: shapes x {x2.shape}, w_up "
                         f"{w_up.shape}, w_down {w_down.shape}")
    _check_pattern("fused_ffn_fwd", n, dp, bias, block)
    if x2.device.type == "cpu" and w_up.device.type == "cpu":
        return fused_ffn_plain(x2, w_up, w_gate, w_down, bias, dp=dp,
                               block=block, act=act)
    ops = [x2, w_up, w_down] + ([w_gate] if w_gate is not None else [])
    check_args("fused_ffn_fwd", ops, x2.dtype)
    if act not in ACTS:
        raise ValueError(f"fused_ffn_fwd: the kernel implements "
                         f"{[a.__name__ for a in ACTS]}, not {act}")
    out = torch.empty((m, odim), dtype=x2.dtype, device=x2.device)
    if m == 0:
        return out
    bm, vec = bm_for(m), 1
    if bm == 0:
        vec = vec_for(n // dp, block, *ops) if odim % 2 == 0 else 1
        if skinny_smem(m, vec, kdim) > FUSED_SKINNY_SMEM:
            bm, vec = 16, 1
    chunks = -(-(n // dp) // (32 * vec if bm == 0 else BN))
    ws = torch.empty((chunks, m, odim), dtype=torch.float32,
                     device=x2.device)
    fn = _build.library("fused_ffn").fused_ffn_fwd
    err = fn(x2.data_ptr(), w_up.data_ptr(),
             None if w_gate is None else w_gate.data_ptr(),
             w_down.data_ptr(), out.data_ptr(), ws.data_ptr(),
             DTYPES[x2.dtype], m, kdim, n, odim, dp, int(bias), block,
             bm, vec, ACTS[act],
             torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check(err, FUSED_FFN.name)
    FUSED_FFN.launches += 1
    return out


# --------------------------------------------------------------------------
# autograd rule (gated and ungated in one Function: ``w_gate`` may be None)
# --------------------------------------------------------------------------

def _bwd_common(x2, w_up, w_gate, w_down, bias, dy, *, dp, block, act):
    """Compact backward of the fused FFN: rematerialize u (and g) with
    kernel ``rdp_matmul_cols``, then the down projection's adjoints, the
    activation's, and the up (and gate) projections', in the reference's
    order and with its cast of ``act(u)·g·dp`` to ``x2.dtype``."""
    kw = dict(dp=dp, block=block)
    u = rdp_matmul_cols(x2, w_up, bias, scale=False, **kw)
    g = (rdp_matmul_cols(x2, w_gate, bias, scale=False, **kw)
         if w_gate is not None else None)
    with torch.enable_grad():            # the activation's small graph
        leaves = [u.requires_grad_()] + ([g.requires_grad_()]
                                         if g is not None else [])
        h = act(u) * g * dp if g is not None else act(u) * dp
        h = h.to(x2.dtype)
    # down-projection adjoints (compact cotangent dh, kept-row wgrad)
    dh = rdp_rows_dgrad(dy, w_down, bias, scale=False, **kw)
    dwd = scatter_row_blocks(
        rdp_rows_wgrad(h.detach(), dy, scale=False, **kw),
        w_down.shape[0], dp, bias, block=block)
    # activation (+gate, +×dp) adjoint
    grads = torch.autograd.grad(h, leaves, dh)
    du = grads[0].contiguous()
    # up- (and gate-) projection adjoints
    dx = rdp_cols_dgrad(du, w_up, bias, scale=False, **kw)
    dwu = scatter_col_blocks(rdp_cols_wgrad(x2, du, scale=False, **kw),
                             w_up.shape[1], dp, bias, block=block)
    dwg = None
    if g is not None:
        dg = grads[1].contiguous()
        dx = dx + rdp_cols_dgrad(dg, w_gate, bias, scale=False, **kw)
        dwg = scatter_col_blocks(rdp_cols_wgrad(x2, dg, scale=False, **kw),
                                 w_gate.shape[1], dp, bias,
                                 block=block).to(w_gate.dtype)
    return (dx.to(x2.dtype), dwu.to(w_up.dtype), dwg,
            dwd.to(w_down.dtype))


class FusedFFN(torch.autograd.Function):
    """``fused_ffn_fwd`` with the compact backward of ``_bwd_common``."""

    @staticmethod
    def forward(ctx, x2, w_up, w_gate, w_down, bias: int, dp: int,
                block: int, act):
        """Kernel ``fused_ffn_fwd``; keeps its inputs for the backward."""
        ctx.save_for_backward(x2, w_up, w_gate, w_down)
        ctx.pattern = (bias, dp, block, act)
        return fused_ffn_fwd(x2, w_up, w_gate, w_down, bias, dp=dp,
                             block=block, act=act)

    @staticmethod
    def backward(ctx, dy):
        """(dx, dWu, dWg, dWd, None...) from ``_bwd_common``."""
        x2, w_up, w_gate, w_down = ctx.saved_tensors
        bias, dp, block, act = ctx.pattern
        dx, dwu, dwg, dwd = _bwd_common(x2, w_up, w_gate, w_down, bias,
                                        dy.contiguous(), dp=dp, block=block,
                                        act=act)
        return dx, dwu, dwg, dwd, None, None, None, None


def fused_ffn_vjp(x2, w_up, w_gate, w_down, bias: int, dp: int, block: int,
                  act=F.silu):
    """Differentiable fused (gated if ``w_gate`` is given) compact FFN on
    2-D ``x2``, ``dp > 1``."""
    return FusedFFN.apply(x2.contiguous(), w_up, w_gate, w_down, int(bias),
                          dp, block, act)
