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
or raises; a CPU tensor takes the plain version.  Forward only.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core import patterns as P
from . import _build
from .rdp_matmul import (BN, DTYPES, WARPS, bm_for, check_args, skinny_rows,
                         vec_for)

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
    if block < 1 or n % block or (n // block) % dp:
        raise ValueError(f"fused_ffn_fwd: d_ff {n} must split into blocks "
                         f"of {block} whose count divides by dp={dp}")
    if not 0 <= bias < n // block:
        raise ValueError(f"fused_ffn_fwd: bias {bias} outside "
                         f"[0, {n // block})")
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
