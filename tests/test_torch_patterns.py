"""The port's RDP pattern algebra is bitwise the JAX package's.

Every (nb, dp, b) of the qwen2-1.5b SMOKE geometry (d_ff 256, nb 8 → block
32) and the full one (d_ff 8960, nb 128 → block 70): kept block and unit
index sets, dense keep-masks, compact column/row gathers, valid periods, and
the plan's strided slice (``_slice_blocks``), which must keep the same set
in the same order as ``kept_block_indices``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import patterns as JP
from repro.core.plan import _slice_blocks as j_slice_blocks

from repro_torch.core import patterns as P
from repro_torch.core.plan import _gather_blocks, _slice_blocks

GEOMETRIES = {"smoke": (256, 8), "full": (8960, 128)}


def _cases(dim, nb):
    return [(dp, b) for dp in P.valid_periods(nb, 8) for b in range(dp)]


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_kept_indices_and_masks_bitwise(geom):
    dim, nb = GEOMETRIES[geom]
    block = dim // nb
    assert P.valid_periods(nb, 8) == JP.valid_periods(nb, 8)
    for dp, b in _cases(dim, nb):
        np.testing.assert_array_equal(
            P.kept_block_indices(nb, dp, b).numpy(),
            np.asarray(JP.kept_block_indices(nb, dp, b)))
        units = P.kept_unit_indices(dim, dp, b, block).numpy()
        np.testing.assert_array_equal(
            units, np.asarray(JP.kept_unit_indices(dim, dp, b, block)))
        np.testing.assert_array_equal(units,
                                      P.np_kept_indices(dim, dp, b, block))
        np.testing.assert_array_equal(
            P.rdp_mask(dim, dp, b, block).numpy(),
            np.asarray(JP.rdp_mask(dim, dp, b, block)))


@pytest.mark.parametrize("geom", sorted(GEOMETRIES))
def test_compact_gathers_and_slices_bitwise(geom):
    dim, nb = GEOMETRIES[geom]
    block = dim // nb
    rng = np.random.default_rng(0)
    w_cols = rng.standard_normal((3, dim)).astype(np.float32)
    w_rows = rng.standard_normal((dim, 3)).astype(np.float32)
    tc, tr = torch.from_numpy(w_cols), torch.from_numpy(w_rows)
    for dp, b in _cases(dim, nb):
        cols = np.asarray(JP.compact_columns(jnp.asarray(w_cols), dp, b,
                                             block))
        rows = np.asarray(JP.compact_rows(jnp.asarray(w_rows), dp, b, block))
        np.testing.assert_array_equal(
            P.compact_columns(tc, dp, b, block).numpy(), cols)
        np.testing.assert_array_equal(
            P.compact_rows(tr, dp, b, block).numpy(), rows)
        # the plan's slice and gather helpers keep the same set, same order
        np.testing.assert_array_equal(
            _slice_blocks(tc, 1, nb, dp, b).numpy(), cols)
        np.testing.assert_array_equal(
            _gather_blocks(tr, 0, nb, dp, b).numpy(), rows)
        np.testing.assert_array_equal(
            np.asarray(j_slice_blocks(jnp.asarray(w_cols), 1, nb, dp, b)),
            cols)


def test_invalid_geometry_raises():
    with pytest.raises(ValueError):
        P.kept_unit_indices(250, 2, 0, 32)
    with pytest.raises(ValueError):
        P.kept_block_indices(6, 4, 0)
