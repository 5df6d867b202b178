"""The port's backward held against the JAX package on identical inputs.

* The plain versions of the backward kernels (``kernels/rdp_matmul_bwd``)
  against the JAX Pallas kernels run ``interpret=True``, at dp 2/4/8 and
  every bias; at a ragged block of 30, the port's kernels + scatter
  against ``jax.vjp`` of the JAX gather oracles (``repro.kernels.ref``).
* The autograd Functions are what ``ops.rdp_ffn`` / ``ops.fused_ffn``
  differentiate through, on CPU tensors too: their backward calls the
  backward kernels' wrappers (which take the plain versions here).
* ``lm_loss`` gradients of qwen2-1.5b SMOKE (f32, 2 layers) on the "cuda"
  and "fused" backends against ``jax.grad(lm_loss)`` on the JAX "slice"
  backend, for every (dp, b) bucket of the SMOKE plan; dropped-block
  weight gradients exactly zero.

Inputs are numpy draws (O(1) outputs), so f32 agreement is held to 1e-5
absolute: the two frameworks sum in different orders (~1e-7 relative).

``test_cuda_backward_kernels_match_plain_versions`` holds the built CUDA
kernels against the plain versions on the card; it skips without a GPU.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_smoke as jax_smoke
from repro.core.plan import build_plan as jax_build_plan
from repro.kernels import ref as jref
from repro.kernels.rdp_matmul_bwd import (rdp_cols_dgrad as j_cols_dgrad,
                                          rdp_cols_wgrad as j_cols_wgrad,
                                          rdp_rows_dgrad as j_rows_dgrad,
                                          rdp_rows_wgrad as j_rows_wgrad)
from repro.models import init_lm as jax_init_lm
from repro.models import materialize as jax_materialize
from repro.models.transformer import lm_loss as jax_lm_loss

from repro_torch import kernels as K
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_smoke
from repro_torch.core import patterns as P
from repro_torch.core.plan import build_plan
from repro_torch.kernels import autodiff, fused_ffn, ops, rdp_matmul_bwd
from repro_torch.models import lm_loss
from repro_torch.tree import tree_leaves

TOL = 1e-5
ARCH = "qwen2_1_5b"


def _close(a, b, tol=TOL):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a.astype(np.float64) - b).max())
    assert err <= tol, err


def _draw(rng, *shape, fan):
    return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)


# --------------------------------------------------------------------------
# (a) the backward kernels' plain versions
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dp", [2, 4, 8])
def test_plain_backward_kernels_match_jax_kernels(dp):
    kd, n, nb, m = 64, 256, 8, 8
    block = n // nb
    rng = np.random.default_rng(dp)
    a, w = _draw(rng, m, kd, fan=1), _draw(rng, kd, n, fan=kd)
    wd = _draw(rng, n, kd, fan=n)
    dcc = _draw(rng, m, n // dp, fan=1)           # compact cotangent
    dcd = _draw(rng, m, kd, fan=1)                # dense cotangent
    ac = _draw(rng, m, n // dp, fan=1)            # compact activation
    t = torch.from_numpy
    for scale in (False, True):
        _close(K.rdp_cols_wgrad(t(a), t(dcc), dp=dp, block=block,
                                scale=scale),
               j_cols_wgrad(jnp.asarray(a), jnp.asarray(dcc), dp=dp,
                            block=block, scale=scale, interpret=True))
        _close(K.rdp_rows_wgrad(t(ac), t(dcd), dp=dp, block=block,
                                scale=scale),
               j_rows_wgrad(jnp.asarray(ac), jnp.asarray(dcd), dp=dp,
                            block=block, scale=scale, interpret=True))
        for b in range(dp):
            jb = jnp.int32(b)
            _close(K.rdp_cols_dgrad(t(dcc), t(w), b, dp=dp, block=block,
                                    scale=scale),
                   j_cols_dgrad(jnp.asarray(dcc), jnp.asarray(w), jb, dp=dp,
                                block=block, scale=scale, interpret=True))
            _close(K.rdp_rows_dgrad(t(dcd), t(wd), b, dp=dp, block=block,
                                    scale=scale),
                   j_rows_dgrad(jnp.asarray(dcd), jnp.asarray(wd), jb,
                                dp=dp, block=block, scale=scale,
                                interpret=True))
    # CPU tensors took the plain versions: no kernel was launched
    assert all(k.launches == 0 for k in K.KERNELS)


@pytest.mark.parametrize("dp", [2, 4, 8])
def test_ragged_backward_matches_jax_gather_oracles(dp):
    """Block 30 (d_ff 240, nb 8): the Functions' gradients — backward
    kernels + scatter — against jax.vjp of the gather-then-matmul
    oracles, dropped blocks exactly zero."""
    kd, n, nb, m = 64, 240, 8, 6
    block = n // nb
    rng = np.random.default_rng(10 + dp)
    a, w = _draw(rng, m, kd, fan=1), _draw(rng, kd, n, fan=kd)
    wd = _draw(rng, n, kd, fan=n)
    ac = _draw(rng, m, n // dp, fan=1)
    dcc = _draw(rng, m, n // dp, fan=1)
    dcd = _draw(rng, m, kd, fan=1)
    for b in range(dp):
        cols = lambda a_, w_: jref.rdp_matmul_cols_ref(  # noqa: E731
            a_, w_, dp, b, block=block, scale=True)
        rows = lambda a_, w_: jref.rdp_matmul_rows_ref(  # noqa: E731
            a_, w_, dp, b, block=block)
        for fn, tfn, x, wt, dc in (
                (cols, autodiff.rdp_matmul_cols_vjp, a, w, dcc),
                (rows, autodiff.rdp_matmul_rows_vjp, ac, wd, dcd)):
            _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(wt))
            jdx, jdw = vjp(jnp.asarray(dc))
            tx = torch.from_numpy(x).requires_grad_()
            tw = torch.from_numpy(wt).requires_grad_()
            if fn is cols:
                out = tfn(tx, tw, b, dp, block, True)
            else:
                out = tfn(tx, tw, b, dp, block)
            dx, dw = torch.autograd.grad(out, (tx, tw),
                                         torch.from_numpy(dc))
            _close(dx, jdx)
            _close(dw, jdw)
            axis = 1 if fn is cols else 0
            kept = np.zeros(n, bool)
            kept[np.asarray(P.kept_unit_indices(n, dp, b, block))] = 1
            dropped = dw.index_select(axis, torch.from_numpy(
                np.flatnonzero(~kept)))
            assert bool((dropped == 0).all())


def test_ops_backward_goes_through_the_functions(monkeypatch):
    """A backward through ops.rdp_ffn / ops.fused_ffn on CPU tensors runs
    the autograd Functions, whose backward calls each backward kernel's
    wrapper (counted here by wrapping the plain versions it takes)."""
    calls = {}
    for name in ("rdp_cols_dgrad_plain", "rdp_cols_wgrad_plain",
                 "rdp_rows_dgrad_plain", "rdp_rows_wgrad_plain"):
        orig = getattr(rdp_matmul_bwd, name)

        def counted(*args, _orig=orig, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*args, **kw)
        monkeypatch.setattr(rdp_matmul_bwd, name, counted)
    rng = np.random.default_rng(3)
    kd, n, block, dp = 64, 256, 32, 4
    x = torch.from_numpy(_draw(rng, 2, 5, kd, fan=1)).requires_grad_()
    ws = [torch.from_numpy(_draw(rng, *s, fan=s[0])).requires_grad_()
          for s in ((kd, n), (kd, n), (n, kd))]
    wu, wg, wd = ws
    for op, fn_cls in ((ops.rdp_ffn, autodiff.RdpMatmulRows),
                       (ops.fused_ffn, fused_ffn.FusedFFN)):
        calls.clear()
        y = op(x, wu, wd, 1, dp=dp, act=F.silu, w_gate=wg, block=block)
        node = y.grad_fn
        while node is not None and fn_cls.__name__ not in type(node).__name__:
            node = node.next_functions[0][0] if node.next_functions else None
        assert node is not None, (op.__name__, type(y.grad_fn).__name__)
        torch.autograd.grad(y.square().sum(), [x, *ws])
        # up + gate: two dgrads and two wgrads; down: one of each
        assert calls == {"rdp_cols_dgrad_plain": 2,
                         "rdp_cols_wgrad_plain": 2,
                         "rdp_rows_dgrad_plain": 1,
                         "rdp_rows_wgrad_plain": 1}, (op.__name__, calls)


def test_direct_wrapper_call_with_grad_is_refused_only_on_the_card():
    """The narrower guard: with grad mode on, a kernel wrapper given an
    operand that requires grad raises on the card (it has no autograd rule
    of its own).  On CPU tensors the plain version runs — PyTorch's own
    autograd covers it — and inside the Functions grad mode is off."""
    x = torch.randn(4, 64, requires_grad=True)
    w = torch.randn(64, 256)
    y = K.rdp_matmul_cols(x, w, 0, dp=2, block=32)
    assert y.requires_grad
    with torch.no_grad():
        assert not K.rdp_matmul_cols(x, w, 0, dp=2, block=32).requires_grad


# --------------------------------------------------------------------------
# (b) lm_loss gradients, every SMOKE bucket
# --------------------------------------------------------------------------

@functools.cache
def _e2e_setup():
    jcfg, cfg = jax_smoke(ARCH), get_smoke(ARCH)
    params = jax_materialize(jax.random.PRNGKey(0), jax_init_lm(jcfg)[0])
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab, (2, 32))
    labels = rng.integers(0, cfg.vocab, (2, 32))
    labels[0, :3] = -1                           # masked positions
    batch = {"tokens": tokens, "labels": labels}
    block = cfg.d_ff // cfg.pattern_nb
    jplan = jax_build_plan("rdp", 0.5, nb=cfg.pattern_nb, dp_max=8,
                           block=block)
    plan = build_plan("rdp", 0.5, nb=cfg.pattern_nb, dp_max=8, block=block)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return jcfg, cfg, params, tparams, batch, jplan, plan


_FFN_AXES = {"w_up": 2, "w_gate": 2, "w_down": 1}   # pattern axis, stacked


def _roll_ffn(tree, shift_blocks: int, nb: int):
    """Roll the stacked FFN weights' pattern axis by ``shift_blocks``."""
    stack = dict(tree["stacks"][0])
    ffn = dict(stack["ffn"])
    for name, axis in _FFN_AXES.items():
        w = ffn[name]
        ffn[name] = jnp.roll(w, shift_blocks * (w.shape[axis] // nb),
                             axis=axis)
    stack["ffn"] = ffn
    return {**tree, "stacks": [stack]}


@functools.cache
def _jax_grad_fn(dp: int):
    jcfg, _, _, _, batch, jplan, _ = _e2e_setup()
    jb = jax.tree.map(jnp.asarray, batch)
    bound = jplan.bind(dp, 0)
    return jax.jit(jax.grad(lambda p: jax_lm_loss(jcfg, p, jb, bound)[0]))


def _jax_grads(dp: int, b: int):
    """jax.grad(lm_loss) on the slice backend at bucket (dp, b): bias 0 on
    FFN weights rotated left by b blocks reads exactly the blocks, in the
    same order, that bias b reads on the originals (every layer resolves
    the pattern at layer 0), so one compiled gradient per dp serves every
    bias; the FFN gradients are rotated back."""
    jcfg, _, params, _, _, _, _ = _e2e_setup()
    nb = jcfg.pattern_nb
    g = _jax_grad_fn(dp)(_roll_ffn(params, -b, nb))
    return _roll_ffn(g, b, nb)


def _buckets():
    from repro.core import patterns as JP
    return [(dp, b) for dp in JP.valid_periods(8, 8) for b in range(dp)]


@pytest.mark.parametrize("dp,bias", _buckets())
def test_lm_loss_grads_match_jax_slice(dp, bias):
    jcfg, cfg, _, tparams, batch, jplan, plan = _e2e_setup()
    assert (dp, bias) in jplan.buckets() and (dp, bias) in plan.buckets()
    ref = params_from_jax(jax.tree.map(np.asarray, _jax_grads(dp, bias)),
                          cfg, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    block = cfg.d_ff // cfg.pattern_nb
    idx = P.kept_unit_indices(cfg.d_ff, dp, bias, block)
    dropped = torch.from_numpy(np.setdiff1d(np.arange(cfg.d_ff), idx))
    leaves = tree_leaves(tparams)
    for backend in ("cuda", "fused"):
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = lm_loss(cfg, tparams, tb,
                          plan.with_backend(backend).bind(dp, bias))
        grads = torch.autograd.grad(loss, leaves)
        for g, r in zip(grads, tree_leaves(ref)):
            _close(g, r)
        if dp > 1:
            it = iter(grads)
            gtree = {id(p): next(it) for p in leaves}
            for lp in tparams["layers"]:
                ffn = lp["ffn"]
                assert bool((gtree[id(ffn["w_down"])][dropped] == 0).all())
                for name in ("w_up", "w_gate"):
                    assert bool((gtree[id(ffn[name])][:, dropped] == 0)
                                .all())


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_backward_kernels_match_plain_versions():
    """On the card: kernels 4-7 vs their plain versions at the slice's
    shapes (f32 within 1e-4 of max|ref|, bf16 within 2e-2), and the
    narrower guard (a direct call with grad mode on raises)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    kd, n, block = 1536, 8960, 70
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        w = (torch.randn(kd, n, generator=g, device="cuda") / kd ** .5).to(dt)
        wd = (torch.randn(n, kd, generator=g, device="cuda") / n ** .5).to(dt)
        for m in (1, 100, 512):
            for dp in (2, 8):
                b = dp - 1
                dcc = torch.randn(m, n // dp, generator=g, device="cuda"
                                  ).to(dt)
                dcd = torch.randn(m, kd, generator=g, device="cuda").to(dt)
                a = torch.randn(m, kd, generator=g, device="cuda").to(dt)
                ac = torch.randn(m, n // dp, generator=g, device="cuda"
                                 ).to(dt)
                kw = dict(dp=dp, block=block)
                pairs = [
                    (K.rdp_cols_dgrad(dcc, w, b, **kw),
                     K.rdp_cols_dgrad_plain(dcc, w, b, **kw)),
                    (K.rdp_cols_wgrad(a, dcc, **kw),
                     K.rdp_cols_wgrad_plain(a, dcc, **kw)),
                    (K.rdp_rows_dgrad(dcd, wd, b, **kw),
                     K.rdp_rows_dgrad_plain(dcd, wd, b, **kw)),
                    (K.rdp_rows_wgrad(ac, dcd, **kw),
                     K.rdp_rows_wgrad_plain(ac, dcd, **kw))]
                for got, ref in pairs:
                    err = (got.float() - ref.float()).abs().max()
                    assert err <= tol * ref.float().abs().max()
    x = torch.randn(4, kd, device="cuda", requires_grad=True)
    w32 = torch.randn(kd, n, device="cuda")
    with pytest.raises(RuntimeError, match="grad mode"):
        K.rdp_matmul_cols(x, w32, 0, dp=2, block=block)
    with torch.no_grad():
        K.rdp_matmul_cols(x, w32, 0, dp=2, block=block)
