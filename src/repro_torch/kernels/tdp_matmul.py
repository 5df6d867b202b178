"""TDP masked matmul: CUDA kernel (``csrc/tdp_matmul.cu``) + plain version.

``tdp_matmul`` — ``C[M, N] = (A[M, K] @ (W ∘ mask)) · dp`` (×dp if
``scale``), the mask keeping weight tile ``(i, j)`` iff ``(i + j - b) % dp
== 0``.  Replaces the TPU kernel ``tdp_matmul``
(src/repro/kernels/tdp_matmul.py:28).  Requires ``dp | K/tile``: every
tile-column keeps the ``K/(tile·dp)`` row-tiles ``(b - j) mod dp + s·dp``,
and only those tiles of W (and the matching columns of A) are read.

Accumulates in f32, scales in f32, casts once (the Pallas kernel's order).
On the serving path M is a decode width or a prefill chunk and the product
is bound by the kept weight bytes; at a training step by operations.  The
kernel takes tiles of 64 and 128 (a ``ValueError`` names any other); it is
the shared-memory tiled product of ``csrc/tile_gemm.cuh`` with 16-row
output tiles at M <= 16, and splits the contraction across CTAs when the
output alone would leave the card idle.

A CUDA tensor launches the kernel (and adds one to its ``launches``) or
raises; a CPU tensor takes the plain version.  The wrapper has no autograd
rule: ``kernels.autodiff.TdpMatmul`` pairs it with its backward kernels
(``tdp_matmul_bwd``), and a direct call with grad mode on and an operand
that requires grad raises.
"""
from __future__ import annotations

import torch

from ..core import patterns as P
from . import _build
from .rdp_matmul import BN, DTYPES, check_args, split_k
from .rdp_matmul_bwd import _factor

TDP_MATMUL = _build.Kernel("tdp_matmul",
                           "src/repro_torch/csrc/tdp_matmul.cu",
                           "src/repro/kernels/tdp_matmul.py:28")

CARD_TILES = (64, 128)       # tiles the CUDA kernels take


def check_pattern(name: str, k: int, n: int, dp: int, bias: int, tile: int,
                  *, divides: str = "K") -> None:
    """Raise unless tiles of ``tile`` split ``[k, n]``, dp divides the tile
    count of the named dimension, and ``0 <= bias < dp``."""
    if tile < 1 or k % tile or n % tile:
        raise ValueError(f"{name}: weight [{k}, {n}] does not split into "
                         f"tiles of {tile}")
    count = (k if divides == "K" else n) // tile
    if dp < 1 or count % dp:
        raise ValueError(f"{name}: dp={dp} does not divide the {count} "
                         f"tiles of {divides}")
    if not 0 <= bias < dp:
        raise ValueError(f"{name}: bias {bias} outside [0, {dp})")


def check_card_tile(name: str, tile: int) -> None:
    """The CUDA kernels take tiles of 64 and 128 only."""
    if tile not in CARD_TILES:
        raise ValueError(f"{name}: tile {tile} is not supported by the CUDA "
                         f"kernel (tiles {CARD_TILES})")


def tdp_matmul_plain(a, w, bias: int, *, dp: int, tile: int,
                     scale: bool = True):
    """Plain PyTorch version of ``tdp_matmul``: f32 accumulate, scale, cast."""
    mask = P.tdp_mask(w.shape[0], w.shape[1], dp, bias, tile,
                      device=w.device)
    c = a.float() @ (w.float() * mask)
    return (c * _factor(scale, dp)).to(a.dtype)


def tdp_matmul(a, w, bias: int, *, dp: int, tile: int, scale: bool = True):
    """C[M, N] = A[M, K] @ (W ∘ diagonal-TDP-mask) (×dp if ``scale``)."""
    m, kdim = a.shape
    k2, n = w.shape
    if kdim != k2:
        raise ValueError(f"tdp_matmul: shapes {a.shape} @ {w.shape}")
    check_pattern("tdp_matmul", kdim, n, dp, bias, tile)
    if a.device.type == "cpu" and w.device.type == "cpu":
        return tdp_matmul_plain(a, w, bias, dp=dp, tile=tile, scale=scale)
    check_card_tile("tdp_matmul", tile)
    check_args("tdp_matmul", (a, w), a.dtype)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0:
        return out
    bm = 16 if m <= 16 else 64
    splits, k_split = split_k(kdim // dp, -(-n // BN) * -(-m // bm))
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    err = _build.library("tdp_matmul").tdp_matmul(
        a.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), DTYPES[a.dtype], m, kdim, n,
        dp, int(bias), tile, bm, splits, k_split, _factor(scale, dp),
        torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, TDP_MATMUL.name)
    TDP_MATMUL.launches += 1
    return out
