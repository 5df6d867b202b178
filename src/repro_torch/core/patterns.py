"""Structured dropout patterns (the paper's §III-A/B): the RDP and TDP
index algebra.

An RDP pattern keeps every ``dp``-th block of hidden units starting at the
bias ``b`` (0-based): block ``j`` of the kept set is ``(b + j·dp) mod nb``.
Dropping a hidden unit drops a column of the up/gate projections and a row
of the down projection, so the kept weights form compact matrices and the
FFN matmuls shrink to 1/dp.  ``dp`` fixes every shape; ``b`` only moves
which blocks are read.

A TDP pattern drops ``tile × tile`` synapse tiles of one weight matrix on a
diagonal period: tile ``(i, j)`` is kept iff ``(i + j - b) % dp == 0``, so
every tile-column keeps exactly ``tr/dp`` tiles (``dp | rows/tile``).

The index helpers build int64 tensors on ``device`` (CPU unless given);
``np_kept_indices`` is the numpy twin used for host-side planning.
"""
from __future__ import annotations

import numpy as np
import torch


def num_blocks(dim: int, block: int) -> int:
    """Block count of a dimension; raises unless ``block`` divides it."""
    if dim % block != 0:
        raise ValueError(f"dim {dim} not divisible by block {block}")
    return dim // block


def kept_block_count(n_blocks: int, dp: int) -> int:
    """Number of kept blocks — bias-independent, so shapes are static."""
    if n_blocks % dp != 0:
        raise ValueError(f"n_blocks {n_blocks} not divisible by dp {dp}")
    return n_blocks // dp


def valid_periods(n_blocks: int, dp_max: int) -> list[int]:
    """Periods usable for ``n_blocks`` blocks: divisors up to ``dp_max``."""
    return [d for d in range(1, dp_max + 1) if n_blocks % d == 0]


def kept_block_indices(n_blocks: int, dp: int, b: int, *,
                       device="cpu") -> torch.Tensor:
    """Indices of kept blocks: ``(b + j·dp) % n_blocks`` for j < n/dp."""
    k = kept_block_count(n_blocks, dp)
    j = torch.arange(k, dtype=torch.int64, device=device)
    return (int(b) + j * dp) % n_blocks


def kept_unit_indices(dim: int, dp: int, b: int, block: int = 1, *,
                      device="cpu") -> torch.Tensor:
    """Flat unit indices kept by an RDP pattern at ``block`` granularity."""
    nb = num_blocks(dim, block)
    blocks = kept_block_indices(nb, dp, b, device=device)
    offs = torch.arange(block, dtype=torch.int64, device=device)
    return (blocks[:, None] * block + offs[None, :]).reshape(-1)


def rdp_mask(dim: int, dp: int, b: int, block: int = 1,
             dtype=torch.float32, *, device="cpu") -> torch.Tensor:
    """Dense 0/1 keep-mask over ``dim`` units (oracle semantics)."""
    nb = num_blocks(dim, block)
    i = torch.arange(nb, dtype=torch.int64, device=device)
    keep = ((i - int(b)) % dp) == 0
    return torch.repeat_interleave(keep.to(dtype), block)


def tdp_mask(rows: int, cols: int, dp: int, b: int, tile: int,
             dtype=torch.float32, *, device="cpu") -> torch.Tensor:
    """Dense 0/1 keep-mask over a ``(rows, cols)`` weight for TDP: tile
    ``(i, j)`` kept iff ``(i + j - b) % dp == 0`` (oracle semantics)."""
    tr, tc = num_blocks(rows, tile), num_blocks(cols, tile)
    i = torch.arange(tr, dtype=torch.int64, device=device)[:, None]
    j = torch.arange(tc, dtype=torch.int64, device=device)[None, :]
    keep = (((i + j - int(b)) % dp) == 0).to(dtype)
    return keep.repeat_interleave(tile, 0).repeat_interleave(tile, 1)


def tdp_kept_row_tile(j, slot, dp: int, b: int):
    """Row-tile index of the ``slot``-th kept tile in tile-column ``j``:
    ``(b - j) mod dp + slot·dp`` (ints or int64 tensors, broadcast)."""
    return (int(b) - j) % dp + slot * dp


def compact_columns(w: torch.Tensor, dp: int, b: int,
                    block: int) -> torch.Tensor:
    """Gather kept column-blocks of ``w`` [in, out] → [in, out/dp]."""
    idx = kept_unit_indices(w.shape[-1], dp, b, block, device=w.device)
    return w.index_select(-1, idx)


def compact_rows(w: torch.Tensor, dp: int, b: int,
                 block: int) -> torch.Tensor:
    """Gather kept row-blocks of ``w`` [in, out] → [in/dp, out]."""
    idx = kept_unit_indices(w.shape[0], dp, b, block, device=w.device)
    return w.index_select(0, idx)


def np_kept_indices(dim: int, dp: int, b: int, block: int = 1) -> np.ndarray:
    """NumPy twin of ``kept_unit_indices`` for host-side planning."""
    nb = dim // block
    blocks = (b + np.arange(nb // dp) * dp) % nb
    return (blocks[:, None] * block + np.arange(block)[None, :]).reshape(-1)
