"""Compact RDP matmuls: CUDA kernels (``csrc/rdp_matmul.cu``) + plain versions.

* ``rdp_matmul_cols`` — up/gate projection, ``C[M, N/dp] = A[M, K] @
  W[:, kept col-blocks]`` (×dp if ``scale``).  Replaces the TPU kernel
  ``rdp_matmul_cols`` (src/repro/kernels/rdp_matmul.py:90).
* ``rdp_matmul_rows`` — down projection, ``C[M, N] = Ac[M, K/dp] @
  W[kept row-blocks, :]``.  Replaces ``rdp_matmul_rows``
  (src/repro/kernels/rdp_matmul.py:133).

Kept block ``j`` is source block ``(b + j·dp) mod nb``.  Both accumulate in
f32 and cast once.  On the serving path M is a decode bucket width or a
prefill chunk, so the bound is the kept weight bytes (K·N/dp elements) over
the card's memory rate.  The kernels read only kept blocks; at M <= 16 a
GEMV-shaped kernel streams weight rows (``csrc/skinny.cuh``), above it a
shared-memory tiled one runs (``csrc/tile_gemm.cuh``), and either splits
the contraction across CTAs when the output alone would leave the card
idle.

A CUDA tensor launches the kernel (and adds one to its ``launches``) or
raises; a CPU tensor takes the plain version.  Forward only: the wrappers
refuse tensors that require grad (the backward kernels come with the
training slice).
"""
from __future__ import annotations

import torch

from ..core import patterns as P
from . import _build

RDP_COLS = _build.Kernel("rdp_matmul_cols",
                         "src/repro_torch/csrc/rdp_matmul.cu",
                         "src/repro/kernels/rdp_matmul.py:90")
RDP_ROWS = _build.Kernel("rdp_matmul_rows",
                         "src/repro_torch/csrc/rdp_matmul.cu",
                         "src/repro/kernels/rdp_matmul.py:133")

BN, BK = 64, 32                 # tiled kernels: output tile, stage depth
WARPS = 8                       # skinny kernels: warps per CTA
SKINNY_SMEM = 48 * 1024         # skinny_kernel's dynamic shared memory cap
TARGET_CTAS = 264               # two waves of the H100's 132 SMs
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def bm_for(m: int) -> int:
    """Kernel shape: 0 = skinny (decode, M <= 16), else the tiled row tile."""
    return 0 if m <= 16 else 64


def skinny_rows(m: int) -> int:
    """Rows the skinny kernels are compiled for: next power of two ≤ 16."""
    return next(r for r in (1, 2, 4, 8, 16) if m <= r)


def vec_for(n_out: int, block: int, *tensors) -> int:
    """Elements per lane load in the skinny kernels: 2 when every output
    column pair is contiguous in the weight (even runs) and aligned."""
    ok = n_out % 2 == 0 and block % 2 == 0 and all(
        t.data_ptr() % (2 * t.element_size()) == 0 for t in tensors)
    return 2 if ok else 1


def split_k(kdim: int, out_tiles: int,
            max_k: int | None = None) -> tuple[int, int]:
    """(splits, k_split): enough contraction splits that ``out_tiles *
    splits`` reaches ``TARGET_CTAS``, each a multiple of ``BK`` long and at
    most ``max_k``."""
    stages = -(-kdim // BK)
    want = max(1, min(stages, -(-TARGET_CTAS // max(out_tiles, 1))))
    k_split = -(-stages // want) * BK
    if max_k is not None:
        k_split = min(k_split, max(BK, max_k // BK * BK))
    return -(-kdim // k_split), k_split


def check_args(name: str, tensors, dtype) -> None:
    """Shared wrapper checks: device, dtype, contiguity, no autograd."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be on the same "
                             f"CUDA device, got {t.device}")
        if t.dtype != dtype or dtype not in DTYPES:
            raise TypeError(f"{name}: operands must share one dtype of "
                            f"{list(DTYPES)}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.requires_grad:
            raise RuntimeError(f"{name}: forward-only kernel called on a "
                               f"tensor that requires grad (serving runs "
                               f"under torch.inference_mode())")


def _check_pattern(name, dim, dp, bias, block):
    if block < 1 or dim % block or (dim // block) % dp:
        raise ValueError(f"{name}: dim {dim} must split into blocks of "
                         f"{block} whose count divides by dp={dp}")
    if not 0 <= bias < dim // block:
        raise ValueError(f"{name}: bias {bias} outside [0, {dim // block})")


def rdp_matmul_cols_plain(a, w, bias: int, *, dp: int, block: int,
                          scale: bool = True):
    """Plain PyTorch version of ``rdp_matmul_cols``: f32 accumulate, cast."""
    c = a.float() @ P.compact_columns(w, dp, bias, block).float()
    if scale and dp > 1:
        c = c * dp
    return c.to(a.dtype)


def rdp_matmul_rows_plain(a_compact, w, bias: int, *, dp: int, block: int,
                          scale: bool = False):
    """Plain PyTorch version of ``rdp_matmul_rows``: f32 accumulate, cast."""
    c = a_compact.float() @ P.compact_rows(w, dp, bias, block).float()
    if scale and dp > 1:
        c = c * dp
    return c.to(a_compact.dtype)


def _launch(kernel, fn, a, w, out, kdim, n_out, dims, dp, bias, block,
            scale, vec_block):
    m = a.shape[0]
    bm = bm_for(m)
    if bm == 0:
        vec = vec_for(n_out, vec_block, w)
        mt = skinny_rows(m)
        tiles = -(-n_out // (32 * vec))
        max_k = (SKINNY_SMEM // 4 - WARPS * mt * 32 * vec) // mt
        splits, k_split = split_k(kdim, tiles, max_k)
    else:
        vec = 1
        tiles = -(-n_out // BN) * -(-m // bm)
        splits, k_split = split_k(kdim, tiles)
    ws = (torch.empty((splits, m, n_out), dtype=torch.float32,
                      device=a.device) if splits > 1 else None)
    err = fn(a.data_ptr(), w.data_ptr(), out.data_ptr(),
             None if ws is None else ws.data_ptr(), DTYPES[a.dtype],
             m, *dims, dp, int(bias), block, bm, vec, splits, k_split,
             float(dp) if (scale and dp > 1) else 1.0,
             torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, kernel.name)
    kernel.launches += 1
    return out


def rdp_matmul_cols(a, w, bias: int, *, dp: int, block: int,
                    scale: bool = True):
    """C[M, N/dp] = A[M, K] @ W[:, kept col-blocks] (×dp if ``scale``)."""
    m, kdim = a.shape
    k2, n = w.shape
    if kdim != k2:
        raise ValueError(f"rdp_matmul_cols: shapes {a.shape} @ {w.shape}")
    _check_pattern("rdp_matmul_cols", n, dp, bias, block)
    if a.device.type == "cpu" and w.device.type == "cpu":
        return rdp_matmul_cols_plain(a, w, bias, dp=dp, block=block,
                                     scale=scale)
    check_args("rdp_matmul_cols", (a, w), a.dtype)
    out = torch.empty((m, n // dp), dtype=a.dtype, device=a.device)
    if m == 0:
        return out
    fn = _build.library("rdp_matmul").rdp_matmul_cols
    return _launch(RDP_COLS, fn, a, w, out, kdim, n // dp, (kdim, n), dp,
                   bias, block, scale, vec_block=block)


def rdp_matmul_rows(a_compact, w, bias: int, *, dp: int, block: int,
                    scale: bool = False):
    """C[M, N] = Ac[M, K/dp] @ W[kept row-blocks, :] (×dp if ``scale``)."""
    m, kc = a_compact.shape
    kdim, n = w.shape
    if kc * dp != kdim:
        raise ValueError(f"rdp_matmul_rows: compact {a_compact.shape} vs "
                         f"weight {w.shape} at dp={dp}")
    _check_pattern("rdp_matmul_rows", kdim, dp, bias, block)
    if a_compact.device.type == "cpu" and w.device.type == "cpu":
        return rdp_matmul_rows_plain(a_compact, w, bias, dp=dp, block=block,
                                     scale=scale)
    check_args("rdp_matmul_rows", (a_compact, w), a_compact.dtype)
    out = torch.empty((m, n), dtype=a_compact.dtype, device=a_compact.device)
    if m == 0:
        return out
    fn = _build.library("rdp_matmul").rdp_matmul_rows
    return _launch(RDP_ROWS, fn, a_compact, w, out, kc, n, (kdim, n), dp,
                   bias, block, scale, vec_block=2)
