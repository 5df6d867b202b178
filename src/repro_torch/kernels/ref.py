"""Oracles for the compact RDP kernels (gather-then-matmul) and the TDP
kernel (mask-multiply).

Twins of the JAX package's ``kernels/ref.py``: they define what each kernel
computes.  Every kernel module also keeps its own plain version (f32
accumulation, one cast), which is what the wrappers run on CPU tensors.
"""
from __future__ import annotations

from ..core import patterns as P


def rdp_matmul_cols_ref(a, w, dp: int, b: int, *, block: int,
                        scale: bool = True):
    """C = a @ w[:, kept col-blocks] (compact output ``[M, N/dp]``)."""
    c = a @ P.compact_columns(w, dp, b, block)
    if scale and dp > 1:
        c = c * dp
    return c.to(a.dtype)


def rdp_matmul_rows_ref(a_compact, w, dp: int, b: int, *, block: int,
                        scale: bool = False):
    """C = a_compact @ w[kept row-blocks, :]  (``[M, K/dp] @ [K/dp, N]``)."""
    c = a_compact @ P.compact_rows(w, dp, b, block)
    if scale and dp > 1:
        c = c * dp
    return c.to(a_compact.dtype)


def tdp_matmul_ref(a, w, dp: int, b: int, *, tile: int, scale: bool = True):
    """C = a @ (w ∘ diagonal-TDP-mask) (×dp if ``scale``)  ([M, K] @ [K, N])."""
    mask = P.tdp_mask(w.shape[0], w.shape[1], dp, b, tile, w.dtype,
                      device=w.device)
    c = a @ (w * mask)
    if scale and dp > 1:
        c = c * dp
    return c.to(a.dtype)
