"""Backward products of the compact RDP matmuls: CUDA kernels
(``csrc/rdp_matmul_bwd.cu``) + plain versions.

For each forward kernel of ``rdp_matmul`` its two adjoints (the paper's
Fig. 3 step 4: the backward matmuls skip dropped blocks too):

* ``rdp_cols_dgrad`` — ``dA[M, K] = dC[M, N/dp] @ W[:, kept]ᵀ`` (×dp if
  ``scale``).  Replaces ``rdp_cols_dgrad``
  (src/repro/kernels/rdp_matmul_bwd.py:43).
* ``rdp_cols_wgrad`` — compact ``dWc[K, N/dp] = Aᵀ @ dC`` (×dp if
  ``scale``); bias-free, the caller scatters it into the kept columns of a
  zero ``dW``.  Replaces ``rdp_cols_wgrad`` (rdp_matmul_bwd.py:88).
* ``rdp_rows_dgrad`` — ``dAc[M, K/dp] = dC[M, N] @ W[kept rows, :]ᵀ``.
  Replaces ``rdp_rows_dgrad`` (rdp_matmul_bwd.py:126).
* ``rdp_rows_wgrad`` — compact ``dWc[K/dp, N] = Acᵀ @ dC``, scattered into
  the kept rows.  Replaces ``rdp_rows_wgrad`` (rdp_matmul_bwd.py:170).

All four accumulate in f32 and cast once to ``dC``'s dtype.  At training
sizes (M = tokens of a step, ~2048) each does ~2·M·d_model·d_ff/dp
operations on a few MB, so the bound is operations over the card's peak
rate; the dgrads read only kept blocks of W.  The kernel is a shared-memory
tiled FMA product (``csrc/tile_gemm.cuh``) that splits the contraction
across CTAs, with a deterministic second pass, when the output alone would
leave the card idle.

A CUDA tensor launches the kernel (and adds one to its ``launches``) or
raises; a CPU tensor takes the plain version.
"""
from __future__ import annotations

import torch

from ..core import patterns as P
from . import _build
from .rdp_matmul import BN, DTYPES, _check_pattern, check_args, split_k

_SRC = "src/repro_torch/csrc/rdp_matmul_bwd.cu"
_REF = "src/repro/kernels/rdp_matmul_bwd.py"
COLS_DGRAD = _build.Kernel("rdp_cols_dgrad", _SRC, f"{_REF}:43")
COLS_WGRAD = _build.Kernel("rdp_cols_wgrad", _SRC, f"{_REF}:88")
ROWS_DGRAD = _build.Kernel("rdp_rows_dgrad", _SRC, f"{_REF}:126")
ROWS_WGRAD = _build.Kernel("rdp_rows_wgrad", _SRC, f"{_REF}:170")

BM = 64                       # output rows per tile (columns: BN)


def _factor(scale: bool, dp: int) -> float:
    return float(dp) if (scale and dp > 1) else 1.0


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


# --------------------------------------------------------------------------
# plain versions: f32 accumulate, one cast to dC's dtype
# --------------------------------------------------------------------------

def rdp_cols_dgrad_plain(dc, w, bias: int, *, dp: int, block: int,
                         scale: bool = True):
    """Plain PyTorch version of ``rdp_cols_dgrad``."""
    c = dc.float() @ P.compact_columns(w, dp, bias, block).float().T
    return (c * _factor(scale, dp)).to(dc.dtype)


def rdp_cols_wgrad_plain(a, dc, *, dp: int, block: int, scale: bool = True):
    """Plain PyTorch version of ``rdp_cols_wgrad`` (compact grad)."""
    return (a.float().T @ dc.float() * _factor(scale, dp)).to(dc.dtype)


def rdp_rows_dgrad_plain(dc, w, bias: int, *, dp: int, block: int,
                         scale: bool = False):
    """Plain PyTorch version of ``rdp_rows_dgrad``."""
    c = dc.float() @ P.compact_rows(w, dp, bias, block).float().T
    return (c * _factor(scale, dp)).to(dc.dtype)


def rdp_rows_wgrad_plain(a_compact, dc, *, dp: int, block: int,
                         scale: bool = False):
    """Plain PyTorch version of ``rdp_rows_wgrad`` (compact grad)."""
    return (a_compact.float().T @ dc.float()
            * _factor(scale, dp)).to(dc.dtype)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _launch(kernel, x, y, out, m, kdim, n, dp, bias, block, scale, kc):
    """Launch ``kernel`` for an output ``out`` whose contraction is ``kc``
    long; ``kdim`` x ``n`` is the forward weight's shape."""
    rows, cols = out.shape
    tiles = -(-rows // BM) * -(-cols // BN)
    splits, k_split = split_k(kc, tiles)
    ws = (torch.empty((splits, rows, cols), dtype=torch.float32,
                      device=out.device) if splits > 1 else None)
    fn = getattr(_build.library("rdp_matmul_bwd"), kernel.name)
    err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(), DTYPES[x.dtype], m,
             kdim, n, dp, int(bias), block, splits, k_split,
             _factor(scale, dp),
             torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, kernel.name)
    kernel.launches += 1
    return out


def rdp_cols_dgrad(dc, w, bias: int, *, dp: int, block: int,
                   scale: bool = True):
    """dA[M, K] = dC[M, N/dp] @ W[:, kept col-blocks]ᵀ (×dp if ``scale``)."""
    m, nc = dc.shape
    kdim, n = w.shape
    if nc * dp != n:
        raise ValueError(f"rdp_cols_dgrad: compact {dc.shape} vs weight "
                         f"{w.shape} at dp={dp}")
    _check_pattern("rdp_cols_dgrad", n, dp, bias, block)
    if _on_cpu(dc, w):
        return rdp_cols_dgrad_plain(dc, w, bias, dp=dp, block=block,
                                    scale=scale)
    check_args("rdp_cols_dgrad", (dc, w), dc.dtype)
    out = torch.empty((m, kdim), dtype=dc.dtype, device=dc.device)
    if m == 0:
        return out
    return _launch(COLS_DGRAD, dc, w, out, m, kdim, n, dp, bias, block,
                   scale, kc=nc)


def rdp_cols_wgrad(a, dc, *, dp: int, block: int, scale: bool = True):
    """Compact dWc[K, N/dp] = Aᵀ @ dC (×dp if ``scale``)."""
    m, kdim = a.shape
    m2, nc = dc.shape
    if m != m2 or nc % block:
        raise ValueError(f"rdp_cols_wgrad: shapes {a.shape}, {dc.shape} "
                         f"at block {block}")
    if _on_cpu(a, dc):
        return rdp_cols_wgrad_plain(a, dc, dp=dp, block=block, scale=scale)
    check_args("rdp_cols_wgrad", (a, dc), dc.dtype)
    if m == 0:
        return torch.zeros((kdim, nc), dtype=dc.dtype, device=dc.device)
    out = torch.empty((kdim, nc), dtype=dc.dtype, device=dc.device)
    # the kernel's pattern check sees a full width nc·dp with bias 0
    return _launch(COLS_WGRAD, a, dc, out, m, kdim, nc * dp, dp, 0, block,
                   scale, kc=m)


def rdp_rows_dgrad(dc, w, bias: int, *, dp: int, block: int,
                   scale: bool = False):
    """dAc[M, K/dp] = dC[M, N] @ W[kept row-blocks, :]ᵀ (×dp if ``scale``)."""
    m, n = dc.shape
    kdim, n2 = w.shape
    if n != n2:
        raise ValueError(f"rdp_rows_dgrad: shapes {dc.shape}, {w.shape}")
    _check_pattern("rdp_rows_dgrad", kdim, dp, bias, block)
    if _on_cpu(dc, w):
        return rdp_rows_dgrad_plain(dc, w, bias, dp=dp, block=block,
                                    scale=scale)
    check_args("rdp_rows_dgrad", (dc, w), dc.dtype)
    out = torch.empty((m, kdim // dp), dtype=dc.dtype, device=dc.device)
    if m == 0:
        return out
    return _launch(ROWS_DGRAD, dc, w, out, m, kdim, n, dp, bias, block,
                   scale, kc=n)


def rdp_rows_wgrad(a_compact, dc, *, dp: int, block: int,
                   scale: bool = False):
    """Compact dWc[K/dp, N] = Acᵀ @ dC (×dp if ``scale``)."""
    m, kc = a_compact.shape
    m2, n = dc.shape
    if m != m2 or kc % block:
        raise ValueError(f"rdp_rows_wgrad: shapes {a_compact.shape}, "
                         f"{dc.shape} at block {block}")
    if _on_cpu(a_compact, dc):
        return rdp_rows_wgrad_plain(a_compact, dc, dp=dp, block=block,
                                    scale=scale)
    check_args("rdp_rows_wgrad", (a_compact, dc), dc.dtype)
    if m == 0:
        return torch.zeros((kc, n), dtype=dc.dtype, device=dc.device)
    out = torch.empty((kc, n), dtype=dc.dtype, device=dc.device)
    return _launch(ROWS_WGRAD, a_compact, dc, out, m, kc * dp, n, dp, 0,
                   block, scale, kc=m)
