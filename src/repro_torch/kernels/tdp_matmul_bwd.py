"""Backward products of the TDP masked matmul: CUDA kernels
(``csrc/tdp_matmul_bwd.cu``) + plain versions.

The adjoints of ``tdp_matmul`` (``C = (A @ (W ∘ mask)) · dp``); the
diagonal tile structure survives transposition, so both stay compact:

* ``tdp_dgrad`` — ``dA[M, K] = dC[M, N] @ (W ∘ mask)ᵀ`` (×dp if ``scale``):
  input tile-row ``i`` sums the kept output tiles ``j = (b - i) mod dp +
  s·dp``.  Requires ``dp | N/tile``; ``autodiff.TdpMatmul`` takes the
  reference's mask-multiply adjoint otherwise.  Replaces ``tdp_dgrad``
  (src/repro/kernels/tdp_matmul_bwd.py:38).
* ``tdp_wgrad`` — compact ``dWc[K/dp, N]``: slot ``s`` of tile-column ``j``
  is ``A[:, tile i]ᵀ @ dC[:, tile j]`` (×dp if ``scale``) for the kept
  row-tile ``i = (b - j) mod dp + s·dp``; ``autodiff.expand_tdp_wgrad``
  places it into a zero ``dW``.  Replaces ``tdp_wgrad``
  (tdp_matmul_bwd.py:100).

Both accumulate in f32 and cast once to ``dC``'s dtype.  At training sizes
each does ``2·M·K·N/dp`` operations on a few MB, so the bound is
operations; neither reads a dropped tile.  The kernels are the
shared-memory tiled FMA product of ``csrc/tile_gemm.cuh`` (64 × 64 output
tiles) and split the contraction across CTAs, with a deterministic second
pass, when the output alone would leave the card idle.

A CUDA tensor launches the kernel (and adds one to its ``launches``) or
raises; a CPU tensor takes the plain version.
"""
from __future__ import annotations

import torch

from ..core import patterns as P
from . import _build
from .rdp_matmul import BN, DTYPES, check_args, split_k
from .rdp_matmul_bwd import BM, _factor, _on_cpu
from .tdp_matmul import check_card_tile, check_pattern

_SRC = "src/repro_torch/csrc/tdp_matmul_bwd.cu"
_REF = "src/repro/kernels/tdp_matmul_bwd.py"
TDP_DGRAD = _build.Kernel("tdp_dgrad", _SRC, f"{_REF}:38")
TDP_WGRAD = _build.Kernel("tdp_wgrad", _SRC, f"{_REF}:100")


def compact_tdp_rows(full, dp: int, bias: int, *, tile: int):
    """The kept tiles of a ``[K, N]`` matrix in the compact wgrad layout
    ``[K/dp, N]``: slot ``s`` of tile-column ``j`` holds tile ``(i, j)``
    with ``i = (bias - j) mod dp + s·dp``."""
    k, n = full.shape
    tr, tc = k // tile, n // tile
    kept = tr // dp
    j = torch.arange(tc, device=full.device)
    rows = P.tdp_kept_row_tile(j[None, :],
                               torch.arange(kept, device=full.device)[:, None],
                               dp, bias)                      # [kept, tc]
    tiles = full.reshape(tr, tile, tc, tile)[rows, :, j[None, :], :]
    return tiles.permute(0, 2, 1, 3).reshape(kept * tile, n)


# --------------------------------------------------------------------------
# plain versions: f32 accumulate, one cast to dC's dtype
# --------------------------------------------------------------------------

def tdp_dgrad_plain(dc, w, bias: int, *, dp: int, tile: int,
                    scale: bool = True):
    """Plain PyTorch version of ``tdp_dgrad``."""
    mask = P.tdp_mask(w.shape[0], w.shape[1], dp, bias, tile,
                      device=w.device)
    c = dc.float() @ (w.float() * mask).T
    return (c * _factor(scale, dp)).to(dc.dtype)


def tdp_wgrad_plain(a, dc, bias: int, *, dp: int, tile: int,
                    scale: bool = True):
    """Plain PyTorch version of ``tdp_wgrad`` (compact grad)."""
    full = a.float().T @ dc.float()
    return (compact_tdp_rows(full, dp, bias, tile=tile)
            * _factor(scale, dp)).to(dc.dtype)


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

def _launch(kernel, x, y, out, m, kdim, n, dp, bias, tile, scale, kc):
    """Launch ``kernel`` for an output ``out`` whose compact contraction is
    ``kc`` long; ``kdim`` x ``n`` is the forward weight's shape."""
    rows, cols = out.shape
    splits, k_split = split_k(kc, -(-rows // BM) * -(-cols // BN))
    ws = (torch.empty((splits, rows, cols), dtype=torch.float32,
                      device=out.device) if splits > 1 else None)
    fn = getattr(_build.library("tdp_matmul_bwd"), kernel.name)
    err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(), DTYPES[x.dtype], m,
             kdim, n, dp, int(bias), tile, splits, k_split,
             _factor(scale, dp),
             torch.cuda.current_stream(out.device).cuda_stream)
    _build.check(err, kernel.name)
    kernel.launches += 1
    return out


def tdp_dgrad(dc, w, bias: int, *, dp: int, tile: int, scale: bool = True):
    """dA[M, K] = dC[M, N] @ (W ∘ diagonal-TDP-mask)ᵀ (×dp if ``scale``)."""
    m, n = dc.shape
    kdim, n2 = w.shape
    if n != n2:
        raise ValueError(f"tdp_dgrad: shapes {dc.shape}, {w.shape}")
    check_pattern("tdp_dgrad", kdim, n, dp, bias, tile, divides="N")
    if _on_cpu(dc, w):
        return tdp_dgrad_plain(dc, w, bias, dp=dp, tile=tile, scale=scale)
    check_card_tile("tdp_dgrad", tile)
    check_args("tdp_dgrad", (dc, w), dc.dtype)
    out = torch.empty((m, kdim), dtype=dc.dtype, device=dc.device)
    if m == 0:
        return out
    return _launch(TDP_DGRAD, dc, w, out, m, kdim, n, dp, bias, tile, scale,
                   kc=n // dp)


def tdp_wgrad(a, dc, bias: int, *, dp: int, tile: int, scale: bool = True):
    """Compact dWc[K/dp, N]: the kept tiles' ``Aᵀ @ dC`` (×dp if
    ``scale``), slot-major per tile-column."""
    m, kdim = a.shape
    m2, n = dc.shape
    if m != m2:
        raise ValueError(f"tdp_wgrad: shapes {a.shape}, {dc.shape}")
    check_pattern("tdp_wgrad", kdim, n, dp, bias, tile)
    if _on_cpu(a, dc):
        return tdp_wgrad_plain(a, dc, bias, dp=dp, tile=tile, scale=scale)
    check_card_tile("tdp_wgrad", tile)
    check_args("tdp_wgrad", (a, dc), dc.dtype)
    if m == 0:
        return torch.zeros((kdim // dp, n), dtype=dc.dtype, device=dc.device)
    out = torch.empty((kdim // dp, n), dtype=dc.dtype, device=dc.device)
    return _launch(TDP_WGRAD, a, dc, out, m, kdim, n, dp, bias, tile, scale,
                   kc=m)
