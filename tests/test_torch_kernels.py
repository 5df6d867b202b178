"""The compact RDP kernels' plain versions against the JAX Pallas kernels.

On CPU tensors each wrapper takes its plain version (what the CUDA kernel
computes: kept blocks only, f32 accumulation, one cast); the JAX kernels run
``interpret=True`` as the JAX package's own kernel tests run them.  Inputs
are numpy draws scaled by 1/sqrt(fan-in), so outputs are O(1) and f32
agreement is held to 1e-5 absolute.  The ragged geometry (d_ff 240, nb 8 →
block 30: neither aligned nor a power of two) pins the compact→source index
map the CUDA kernels compute per element.

``test_cuda_kernels_match_plain_versions`` holds the built CUDA kernels
against the plain versions on the card; it needs a GPU and skips elsewhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
from repro.core import dropout as jdropout
from repro.kernels import ref as jref
from repro.kernels.fused_ffn import fused_ffn_fwd as j_fused
from repro.kernels.rdp_matmul import rdp_matmul_cols as j_cols
from repro.kernels.rdp_matmul import rdp_matmul_rows as j_rows

from repro_torch import kernels as K
from repro_torch.core import dropout
from repro_torch.kernels import fused_ffn, ops, rdp_matmul, ref

TOL = 1e-5
# (K = d_model, N = d_ff, nb): SMOKE geometry and a ragged block width
GEOMS = {"smoke": (64, 256, 8), "ragged": (64, 240, 8)}


def _inputs(k, n, m=8, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, fan: (rng.standard_normal(s) / np.sqrt(fan)).astype(  # noqa
        np.float32)
    return (f(m, k, fan=1), f(k, n, fan=k), f(k, n, fan=k), f(n, k, fan=n))


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _close(a, b):
    err = float(np.abs(np.asarray(a, np.float64) - np.asarray(b)).max())
    assert err <= TOL, err


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_plain_versions_match_jax_kernels(geom):
    kd, n, nb = GEOMS[geom]
    block = n // nb
    x, wu, wg, wd = _inputs(kd, n)
    tx, twu, twg, twd = _t(x, wu, wg, wd)
    K.reset_launches()
    for dp in (2, 4, 8):
        for b in range(dp):
            for scale in ((False, True) if b == 0 else (False,)):
                _close(K.rdp_matmul_cols(tx, twu, b, dp=dp, block=block,
                                         scale=scale),
                       j_cols(jnp.asarray(x), jnp.asarray(wu), jnp.int32(b),
                              dp=dp, block=block, scale=scale,
                              interpret=True))
            ac = (np.random.default_rng(b).standard_normal((8, n // dp))
                  / np.sqrt(n)).astype(np.float32)
            _close(K.rdp_matmul_rows(torch.from_numpy(ac), twd, b, dp=dp,
                                     block=block),
                   j_rows(jnp.asarray(ac), jnp.asarray(wd), jnp.int32(b),
                          dp=dp, block=block, interpret=True))
            gates = [(twg, jnp.asarray(wg))] + ([(None, None)] if b == 0
                                                else [])
            for gate, jgate in gates:
                _close(K.fused_ffn_fwd(tx, twu, gate, twd, b, dp=dp,
                                       block=block),
                       j_fused(jnp.asarray(x), jnp.asarray(wu), jgate,
                               jnp.asarray(wd), jnp.int32(b), dp=dp,
                               block=block, act=jax.nn.silu, interpret=True))
    # CPU tensors took the plain versions: no kernel was launched
    assert [k.launches for k in K.KERNELS] == [0, 0, 0]


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_ffn_ops_match_jax_oracle(geom):
    """ops.rdp_ffn / ops.fused_ffn (kernel wrappers) and the port's
    rdp_ffn_apply / rdp_ffn_oracle against the JAX mask-multiply oracle."""
    kd, n, nb = GEOMS[geom]
    block = n // nb
    x, wu, wg, wd = _inputs(kd, n, m=6, seed=1)
    tx, twu, twg, twd = _t(x, wu, wg, wd)
    for dp in (1, 2, 4, 8):
        for b in range(dp):
            ref = np.asarray(jdropout.rdp_ffn_oracle(
                jnp.asarray(x), jnp.asarray(wu), jnp.asarray(wd), dp, b,
                act=jax.nn.silu, w_gate=jnp.asarray(wg), block=block))
            for got in (
                    ops.rdp_ffn(tx, twu, twd, b, dp=dp, act=F.silu,
                                w_gate=twg, block=block),
                    ops.fused_ffn(tx, twu, twd, b, dp=dp, act=F.silu,
                                  w_gate=twg, block=block),
                    dropout.rdp_ffn_apply(tx, twu, twd, dp, b, act=F.silu,
                                          w_gate=twg, block=block),
                    dropout.rdp_ffn_oracle(tx, twu, twd, dp, b, act=F.silu,
                                           w_gate=twg, block=block)):
                _close(got, ref)


@pytest.mark.parametrize("geom", sorted(GEOMS))
def test_gather_oracles_match_jax(geom):
    """kernels/ref.py against the JAX package's kernels/ref.py."""
    kd, n, nb = GEOMS[geom]
    block = n // nb
    x, wu, _, wd = _inputs(kd, n, seed=2)
    for dp in (2, 4, 8):
        ac = (np.random.default_rng(dp).standard_normal((8, n // dp))
              / np.sqrt(n)).astype(np.float32)
        for b in range(dp):
            for scale in (False, True):
                _close(ref.rdp_matmul_cols_ref(*_t(x, wu), dp, b,
                                               block=block, scale=scale),
                       jref.rdp_matmul_cols_ref(jnp.asarray(x),
                                                jnp.asarray(wu), dp, b,
                                                block=block, scale=scale))
                _close(ref.rdp_matmul_rows_ref(*_t(ac, wd), dp, b,
                                               block=block, scale=scale),
                       jref.rdp_matmul_rows_ref(jnp.asarray(ac),
                                                jnp.asarray(wd), dp, b,
                                                block=block, scale=scale))


def test_wrappers_validate_geometry():
    x, wu, _, wd = _t(*_inputs(64, 240))
    with pytest.raises(ValueError):
        K.rdp_matmul_cols(x, wu, 0, dp=4, block=40)      # 6 blocks, dp 4
    with pytest.raises(ValueError):
        K.rdp_matmul_cols(x, wu, 8, dp=2, block=30)      # bias past nb
    with pytest.raises(ValueError):
        K.rdp_matmul_rows(x[:, :60], wd, 0, dp=2, block=30)


def test_split_k_covers_the_contraction():
    for kdim in (1, 31, 32, 1120, 1536, 4480, 8960):
        for tiles in (1, 18, 70, 280, 1000):
            for max_k in (None, 32, 100, 256, 11776):
                splits, k_split = rdp_matmul.split_k(kdim, tiles, max_k)
                assert k_split % rdp_matmul.BK == 0
                assert max_k is None or k_split <= max(32, max_k)
                assert (splits - 1) * k_split < kdim <= splits * k_split


def test_skinny_shapes_fit_their_shared_memory():
    """The host's choices for the decode-sized kernels stay inside the
    shared memory the CUDA side accepts."""
    assert [rdp_matmul.skinny_rows(m) for m in (1, 2, 3, 5, 9, 16)] == [
        1, 2, 4, 8, 16, 16]
    for m in (1, 3, 8, 16):
        for vec in (1, 2):
            mt = rdp_matmul.skinny_rows(m)
            max_k = (rdp_matmul.SKINNY_SMEM // 4
                     - rdp_matmul.WARPS * mt * 32 * vec) // mt
            _, k_split = rdp_matmul.split_k(8960, 18, max_k)
            assert 4 * (mt * k_split + rdp_matmul.WARPS * mt * 32 * vec) \
                <= rdp_matmul.SKINNY_SMEM
            assert fused_ffn.skinny_smem(m, vec, 1536) \
                <= fused_ffn.FUSED_SKINNY_SMEM


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """On the card: each kernel vs its plain version at the slice's shapes
    (bf16 within 2e-2 of max|ref|, f32 within 1e-4 of max|ref|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    kd, n, block = 1536, 8960, 70
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        wu = (torch.randn(kd, n, generator=g, device="cuda") / kd ** .5).to(dt)
        wd = (torch.randn(n, kd, generator=g, device="cuda") / n ** .5).to(dt)
        for m in (1, 3, 16, 256):
            x = torch.randn(m, kd, generator=g, device="cuda").to(dt)
            for dp in (2, 8):
                got = K.fused_ffn_fwd(x, wu, wu, wd, dp - 1, dp=dp,
                                      block=block)
                ref = K.fused_ffn_plain(x, wu, wu, wd, dp - 1, dp=dp,
                                        block=block)
                err = (got.float() - ref.float()).abs().max()
                assert err <= tol * ref.float().abs().max()
                got = K.rdp_matmul_cols(x, wu, 1, dp=dp, block=block)
                ref = K.rdp_matmul_cols_plain(x, wu, 1, dp=dp, block=block)
                err = (got.float() - ref.float()).abs().max()
                assert err <= tol * ref.float().abs().max()
