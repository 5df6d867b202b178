#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) on any error:

1. build  — compile every CUDA kernel of the serving path from
   ``src/repro_torch/csrc`` (one nvcc per source, all started together);
2. kernels — hold each kernel against its plain PyTorch version on the card
   at the serving and training paths' shapes (qwen2-1.5b: d_model 1536,
   d_ff 8960, block 70; dp 2/4/8, every bias, M 1/2/3/8/16/100/256 and the
   train step's 2048, bf16 and f32), and time kernel, plain version and a
   library matmul on pre-gathered compact weights;
3. serve  — qwen2-1.5b at full width (28 layers, bf16, random weights from a
   seed) through ``Scheduler`` + ``Server`` on the "cuda" backend (shared
   and per-member prefill) and the "fused" backend, with launch counts reset
   just before and read just after each; first-token logits of patterned
   members on both backends (and on "gather") against a "slice"-backend
   run, in bf16 and again in float32;
   per-bucket decode-step times beside the FFN-weight-bytes bound, with
   each step's device time per kernel from torch.profiler;
4. train  — the backward kernels (4-7) against their plain versions at the
   training path's shapes (dp 2/4/8, every bias, M 1/100/2048, f32 and
   bf16) and timed at M 2048, dp 2; ``lm_loss`` gradients of qwen2-1.5b at
   full width in float32 on the "cuda" and "fused" backends against
   "slice" (dp 2/4/8), dropped-block weight gradients exactly zero (f32 and
   bf16); 8 steps of ``Trainer`` + ``AdamW`` in bf16 on "cuda" and then
   "fused" (batch 4 x 512), launch counts reset just before and read just
   after each; eager train-step times per (backend, dp) with each step's
   device time per kernel class from torch.profiler.

Tile-based dropout (the "tdp" family, kernels 8-10) runs qwen2-1.5b at
``pattern_nb`` 12 (tile 1536 / 12 = 128; 12 x 70 tiles of ``w_up``), whose
plan uses dp 2/3/4/6: phase 2 holds kernels 8-10 against their plain
versions (tile 128 and 64, every bias, f32 and bf16) and times them at M 8
and 2048 beside a ``torch.bmm`` over the dp residue classes; phase 3 serves
an E = 8 ensemble on "cuda" (first-token logits against "slice", f32
held, bf16 reported) and adds TDP decode rows; phase 4 holds full-width f32
gradients against "slice" at dp 2/3/4/6 (dropped ``w_up`` tiles exactly
zero), trains 8 bf16 steps with exact launch counts and adds TDP step rows.

Prints per-phase seconds, the card's name and power limit, a
``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Exits non-zero, printing no result,
without a CUDA device or without the repository beside it.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FLOPS = {"bfloat16": 989e12,    # dense tensor-core bf16
              "float32": 67e12}      # float32 outside the tensor cores
# f32: the kernel and the plain version sum up to 8960 products in different
# orders; 1e-4 of the output scale covers that with room.  bf16: both
# accumulate in f32 and round once to bf16 (2^-8 relative), but the fused
# kernel also rounds its hidden activation to bf16 before the down product,
# as the plain version does in another order — 2e-2 of the output scale.
KERNEL_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# first-token logits after 28 bf16 layers: every layer rounds its residual,
# attention and FFN outputs to bf16 (2^-8 relative) and the backends round
# at different points (the fused kernel keeps its hidden in f32 until one
# cast), so differences compound with depth: 5e-2 of the logit scale.
LOGIT_TOL = 5e-2
# the same in float32: only summation orders differ (1e-7 relative per
# product), compounded over 28 layers — 1e-3 of the logit scale.
F32_LOGIT_TOL = 1e-3
# TDP on qwen2-1.5b: the family's tile is d_model / pattern_nb, and at the
# configured pattern_nb 128 (tile 12) it does not divide d_ff 8960; at 12
# the tile is 128 and the plan's periods are the divisors of 12 up to 8
TDP_NB = 12
TDP_DPS = (2, 3, 4, 6)


class SmokeFailure(RuntimeError):
    """A phase failed; the message says which check."""


def log(*args):
    print(*args, flush=True)


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    require(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip()


def cuda_ms(torch, fn, iters: int = 30, warmup: int = 3,
            replays: int = 5) -> float:
    """Device milliseconds of one ``fn(i)``: ``iters`` calls captured in a
    CUDA graph, replayed ``replays`` times between CUDA events.  The graph
    removes the host's launch overhead, which at decode sizes is larger
    than the kernels themselves."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound_ms(n_bytes: float, flops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ==========================================================================
# phase 2: kernels against their plain versions
# ==========================================================================

# decode widths, prefill chunks, a ragged partial tile, and a train step's
# 4 x 512 tokens (kernels 1-3 run there in the forward and, kernel 1, in the
# fused backward's remat)
FWD_M = (1, 2, 3, 8, 16, 100, 256, 2048)


def kernel_phase(torch, K, shapes):
    """Correctness sweep + timings.  Returns (records, timing table)."""
    d_model, d_ff, block = shapes
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(0)
    worst = {k.name: 0.0 for k in K.KERNELS}      # bf16 max |got - ref|
    worst_rel = {k.name: 0.0 for k in K.KERNELS}  # ... / max|ref|
    checks = 0
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        tol = KERNEL_TOL[dname]
        wu = (torch.randn(d_model, d_ff, generator=g, device=dev)
              / d_model ** 0.5).to(dt)
        wg = (torch.randn(d_model, d_ff, generator=g, device=dev)
              / d_model ** 0.5).to(dt)
        wd = (torch.randn(d_ff, d_model, generator=g, device=dev)
              / d_ff ** 0.5).to(dt)
        for m in FWD_M:
            x = torch.randn(m, d_model, generator=g, device=dev).to(dt)
            for dp in (2, 4, 8):
                ac = torch.randn(m, d_ff // dp, generator=g, device=dev
                                 ).to(dt)
                for b in range(dp):
                    pairs = (
                        (K.RDP_COLS,
                         K.rdp_matmul_cols(x, wu, b, dp=dp, block=block,
                                           scale=False),
                         K.rdp_matmul_cols_plain(x, wu, b, dp=dp,
                                                 block=block, scale=False)),
                        (K.RDP_ROWS,
                         K.rdp_matmul_rows(ac, wd, b, dp=dp, block=block),
                         K.rdp_matmul_rows_plain(ac, wd, b, dp=dp,
                                                 block=block)),
                        (K.FUSED_FFN,
                         K.fused_ffn_fwd(x, wu, wg, wd, b, dp=dp,
                                         block=block),
                         K.fused_ffn_plain(x, wu, wg, wd, b, dp=dp,
                                           block=block)))
                    torch.cuda.synchronize()
                    for kern, got, ref in pairs:
                        ref = ref.float()
                        abs_err = float((got.float() - ref).abs().max())
                        err = abs_err / float(ref.abs().max())
                        require(bool(torch.isfinite(got).all()),
                                f"{kern.name}: non-finite output")
                        require(err <= tol, f"{kern.name} {dname} M={m} "
                                f"dp={dp} b={b}: rel err {err:.3e} > {tol}")
                        if dname == "bfloat16":
                            worst[kern.name] = max(worst[kern.name],
                                                   abs_err)
                            worst_rel[kern.name] = max(worst_rel[kern.name],
                                                       err)
                        checks += 1
    log(f"[kernels] {checks} kernel-vs-plain checks passed "
        f"(f32 tol {KERNEL_TOL['float32']}, bf16 tol "
        f"{KERNEL_TOL['bfloat16']} of max|ref|)")
    log(f"[kernels] bf16 worst max-abs error {worst}, relative {worst_rel}")
    return worst, worst_rel, timing_table(torch, K, shapes, g)


def timing_table(torch, K, shapes, g):
    """bf16 times at decode, prefill and train-step M, weights rotated
    through copies that together exceed the 50 MB L2 (the decode path
    streams 28 layers of weights, so it finds them cold)."""
    from repro_torch.core.patterns import kept_unit_indices
    d_model, d_ff, block = shapes
    dev, dt = "cuda", torch.bfloat16
    n_rot = 6                      # 6 x 82.6 MB of FFN weights
    sets = [((torch.randn(d_model, d_ff, generator=g, device=dev)
              / d_model ** 0.5).to(dt),
             (torch.randn(d_model, d_ff, generator=g, device=dev)
              / d_model ** 0.5).to(dt),
             (torch.randn(d_ff, d_model, generator=g, device=dev)
              / d_ff ** 0.5).to(dt)) for _ in range(n_rot)]
    rows = []
    for dp in (2, 4, 8):
        b = 1
        idx = kept_unit_indices(d_ff, dp, b, block, device=dev)
        compact = [(wu[:, idx].contiguous(), wg[:, idx].contiguous(),
                    wd[idx].contiguous()) for wu, wg, wd in sets]
        for m in (1, 8, 16, 256, 2048):
            x = torch.randn(m, d_model, generator=g, device=dev).to(dt)
            ac = torch.randn(m, d_ff // dp, generator=g, device=dev).to(dt)
            nc = d_ff // dp
            w = lambda i: sets[i % n_rot]           # noqa: E731
            c = lambda i: compact[i % n_rot]        # noqa: E731
            cases = {
                K.RDP_COLS.name: (
                    lambda i: K.rdp_matmul_cols(x, w(i)[0], b, dp=dp,
                                                block=block, scale=False),
                    lambda i: K.rdp_matmul_cols_plain(x, w(i)[0], b, dp=dp,
                                                      block=block,
                                                      scale=False),
                    lambda i: torch.matmul(x, c(i)[0]),
                    2 * (m * d_model + d_model * nc + m * nc),
                    2 * m * d_model * nc),
                K.RDP_ROWS.name: (
                    lambda i: K.rdp_matmul_rows(ac, w(i)[2], b, dp=dp,
                                                block=block),
                    lambda i: K.rdp_matmul_rows_plain(ac, w(i)[2], b, dp=dp,
                                                      block=block),
                    lambda i: torch.matmul(ac, c(i)[2]),
                    2 * (m * nc + nc * d_model + m * d_model),
                    2 * m * nc * d_model),
                K.FUSED_FFN.name: (
                    lambda i: K.fused_ffn_fwd(x, *w(i), b, dp=dp,
                                              block=block),
                    lambda i: K.fused_ffn_plain(x, *w(i), b, dp=dp,
                                                block=block),
                    None,
                    2 * (m * d_model + 3 * d_model * nc + m * d_model),
                    6 * m * d_model * nc),
            }
            # a train step's kernels take milliseconds: fewer calls do
            it = (dict(iters=5, warmup=2, replays=3) if m > 256 else {})
            for name, (kern, plain, lib, nbytes, flops) in cases.items():
                bnd, by = bound_ms(nbytes, flops, "bfloat16")
                rec = {"name": name, "dp": dp, "M": m, "dtype": "bfloat16",
                       "ms": cuda_ms(torch, kern, **it),
                       "plain_ms": cuda_ms(torch, plain, **it),
                       "library_ms": (cuda_ms(torch, lib, **it)
                                      if lib is not None else None),
                       "bound_ms": bnd, "bound_by": by}
                rows.append(rec)
                log(f"[time] {name:16s} dp={dp} M={m:4d}: kernel "
                    f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
                    f"library {rec['library_ms'] if lib else 'n/a'} ms, "
                    f"bound {bnd:.4f} ms ({by})")
    return rows


def tdp_kernels(K):
    return [K.TDP_MATMUL, K.TDP_DGRAD, K.TDP_WGRAD]


def tdp_pair(K, kern, a, w, dc, b, **kw):
    """(kernel output, plain output) of one TDP kernel on these operands."""
    if kern is K.TDP_MATMUL:
        return K.tdp_matmul(a, w, b, **kw), K.tdp_matmul_plain(a, w, b, **kw)
    if kern is K.TDP_DGRAD:
        return K.tdp_dgrad(dc, w, b, **kw), K.tdp_dgrad_plain(dc, w, b, **kw)
    return K.tdp_wgrad(a, dc, b, **kw), K.tdp_wgrad_plain(a, dc, b, **kw)


def tdp_kernel_phase(torch, K, d_model, d_ff):
    """Kernels 8-10 against their plain versions (same tolerances as the
    RDP kernels: each output sums at most 8960 / dp products, or 2048
    tokens), then timed.  Returns (worst abs, worst rel, timing rows,
    number of checks)."""
    g = torch.Generator(device="cuda").manual_seed(2)
    rn = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    names = [k.name for k in tdp_kernels(K)]
    worst, worst_rel = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    # (kernel, K, N, tile, M values, periods): w_up of qwen2-1.5b at tile
    # 128 (12 x 70 tiles; dgrad needs dp | 70), a square K = N = d_model
    # for the dgrad at every period (12 x 12 tiles), and tile 64 (24 x 140)
    sweep = [(K.TDP_MATMUL, d_model, d_ff, 128, (1, 8, 16, 100, 2048),
              TDP_DPS),
             (K.TDP_WGRAD, d_model, d_ff, 128, (1, 100, 2048), TDP_DPS),
             (K.TDP_DGRAD, d_model, d_ff, 128, (1, 100, 2048), (2,)),
             (K.TDP_DGRAD, d_model, d_model, 128, (1, 100, 2048), TDP_DPS),
             (K.TDP_MATMUL, d_model, d_ff, 64, (100,), TDP_DPS),
             (K.TDP_WGRAD, d_model, d_ff, 64, (100,), TDP_DPS),
             (K.TDP_DGRAD, d_model, d_ff, 64, (100,), (2, 4))]
    checks = 0
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        tol = KERNEL_TOL[dname]
        weights = {}
        for kern, kd, n, tile, ms, dps in sweep:
            if (kd, n) not in weights:
                weights[kd, n] = (rn(kd, n) / kd ** 0.5).to(dt)
            w = weights[kd, n]
            for m in ms:
                a, dc = rn(m, kd).to(dt), rn(m, n).to(dt)
                for dp in dps:
                    for b in range(dp):
                        got, ref = tdp_pair(K, kern, a, w, dc, b, dp=dp,
                                            tile=tile)
                        torch.cuda.synchronize()
                        ref = ref.float()
                        abs_err = float((got.float() - ref).abs().max())
                        err = abs_err / max(float(ref.abs().max()), 1e-30)
                        require(bool(torch.isfinite(got).all()),
                                f"{kern.name}: non-finite output")
                        require(err <= tol, f"{kern.name} {dname} K={kd} "
                                f"N={n} tile={tile} M={m} dp={dp} b={b}: "
                                f"rel err {err:.3e} > {tol}")
                        if dname == "bfloat16":
                            worst[kern.name] = max(worst[kern.name], abs_err)
                            worst_rel[kern.name] = max(worst_rel[kern.name],
                                                       err)
                        checks += 1
    log(f"[kernels] {checks} TDP kernel-vs-plain checks passed (f32 tol "
        f"{KERNEL_TOL['float32']}, bf16 tol {KERNEL_TOL['bfloat16']} of "
        f"max|ref|); bf16 worst max-abs {worst}, relative {worst_rel}")
    return worst, worst_rel, tdp_timing(torch, K, d_model, d_ff, g), checks


def residue_units(torch, dim: int, tile: int, dp: int, c: int, device):
    """Unit indices of the tiles ``c, c + dp, c + 2·dp, ...`` of ``dim``."""
    t = torch.arange(c, dim // tile, dp, device=device)
    return (t[:, None] * tile + torch.arange(tile, device=device)).reshape(-1)


def tdp_timing(torch, K, d_model, d_ff, g, dp=2, b=1, tile=128):
    """bf16 times of kernels 8-10 at M 8 (a decode width, weights rotated
    through copies that exceed the 50 MB L2) and M 2048 (a train step), dp
    2: kernel, plain version, and a library yardstick.  Tile-column class q
    (j = q mod dp) keeps row-tile class (b - q) mod dp, so TDP is dp dense
    products: one ``torch.bmm`` over pre-gathered contiguous operands, A
    [dp, M, K/dp] @ W [dp, K/dp, N/dp] (the forward), dC [dp, M, N/dp] @
    Wᵀ [dp, N/dp, K/dp] (dgrad) and Aᵀ [dp, K/dp, M] @ dC (wgrad).  Every
    function reads A or dC whole, the kept W and writes one output:
    2·(M·K + M·N + K·N/dp) bytes and 2·M·K·N/dp operations."""
    dev, dt = "cuda", torch.bfloat16
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    cols = [residue_units(torch, d_ff, tile, dp, q, dev) for q in range(dp)]
    rows = [residue_units(torch, d_model, tile, dp, (b - q) % dp, dev)
            for q in range(dp)]
    n_rot = 4                        # 4 x 27.5 MB of w_up
    ws = [(rn(d_model, d_ff) / d_model ** 0.5).to(dt) for _ in range(n_rot)]
    wg = [torch.stack([w[rows[q]][:, cols[q]] for q in range(dp)])
          for w in ws]
    wgt = [x.transpose(1, 2).contiguous() for x in wg]
    out = []
    for m in (8, 2048):
        a, dc = rn(m, d_model).to(dt), rn(m, d_ff).to(dt)
        ag = torch.stack([a[:, rows[q]] for q in range(dp)])
        agt = ag.transpose(1, 2).contiguous()
        dcg = torch.stack([dc[:, cols[q]] for q in range(dp)])
        kw = dict(dp=dp, tile=tile)
        w = lambda i: ws[i % n_rot]                      # noqa: E731
        cases = {
            K.TDP_MATMUL.name: (
                lambda i: K.tdp_matmul(a, w(i), b, **kw),
                lambda i: K.tdp_matmul_plain(a, w(i), b, **kw),
                lambda i: torch.bmm(ag, wg[i % n_rot])),
            K.TDP_DGRAD.name: (
                lambda i: K.tdp_dgrad(dc, w(i), b, **kw),
                lambda i: K.tdp_dgrad_plain(dc, w(i), b, **kw),
                lambda i: torch.bmm(dcg, wgt[i % n_rot])),
            K.TDP_WGRAD.name: (
                lambda i: K.tdp_wgrad(a, dc, b, **kw),
                lambda i: K.tdp_wgrad_plain(a, dc, b, **kw),
                lambda i: torch.bmm(agt, dcg)),
        }
        nbytes = 2 * (m * d_model + m * d_ff + d_model * d_ff / dp)
        flops = 2 * m * d_model * d_ff / dp
        bnd, by = bound_ms(nbytes, flops, "bfloat16")
        it = dict(iters=5, warmup=2, replays=3) if m > 256 else {}
        for name, (kern, plain, lib) in cases.items():
            rec = {"name": name, "dp": dp, "M": m, "dtype": "bfloat16",
                   "ms": cuda_ms(torch, kern, **it),
                   "plain_ms": cuda_ms(torch, plain, **it),
                   "library_ms": cuda_ms(torch, lib, **it),
                   "bound_ms": bnd, "bound_by": by}
            out.append(rec)
            log(f"[time] {name:16s} dp={dp} M={m:4d}: kernel "
                f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
                f"library (bmm) {rec['library_ms']:.4f} ms, bound "
                f"{bnd:.4f} ms ({by})")
    return out


# ==========================================================================
# phase 3: serve qwen2-1.5b at full width
# ==========================================================================

def make_requests(rt, prompt, which="both"):
    """A dense request and an E = 8 ensemble ("both"), or the ensemble."""
    reqs = [rt.serve.Request(rid=0, prompt=prompt, max_new_tokens=SERVE_NEW,
                             ensemble=1),
            rt.serve.Request(rid=1, prompt=prompt, max_new_tokens=SERVE_NEW,
                             ensemble=SERVE_E, seed=7)]
    return reqs if which == "both" else reqs[1:]


def serve_run(torch, rt, cfg, params, plan, prompt, backend, shared=True,
              which="both"):
    """Serve ``make_requests(which)`` through ``Scheduler`` + ``Server`` on
    ``backend``; check every member's tokens and first logits.  Returns
    (output, wall seconds)."""
    import numpy as np
    sched = rt.serve.Scheduler(cfg, params, capacity=16, max_len=128,
                               plan=plan.with_backend(backend),
                               shared_prefill=shared, device="cuda")
    t = time.perf_counter()
    out = rt.serve.Server(sched, clock=rt.serve.WallClock()).run(
        make_requests(rt, prompt, which))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    reqs = make_requests(rt, prompt, which)
    for r in reqs:
        members = out["results"][r.rid]
        require(len(members) == r.ensemble,
                f"{backend}: request {r.rid} has {len(members)} members")
        for m in members:
            require(len(m["tokens"]) == SERVE_NEW,
                    f"{backend}: member {m['member']} produced "
                    f"{len(m['tokens'])} tokens, want {SERVE_NEW}")
            require(all(0 <= t < cfg.vocab for t in m["tokens"]),
                    f"{backend}: token out of vocabulary")
            fl = m["first_logits"]
            require(fl is not None and fl.shape == (cfg.vocab,)
                    and bool(np.isfinite(fl).all()),
                    f"{backend}: first logits not finite [{cfg.vocab}]")
    tel = out["telemetry"]
    require(tel["tokens_generated"]
            == SERVE_NEW * sum(r.ensemble for r in reqs),
            f"{backend}: token count {tel['tokens_generated']}")
    sched.obs.watchdog.assert_clean()
    log(f"[serve] {plan.family} backend={backend} shared_prefill={shared}: "
        f"{wall:.2f} s wall, buckets {sorted(tel['bucket_tokens'])}, "
        f"prompt tokens {tel['prompt_tokens']}")
    return out, wall


SERVE_NEW, SERVE_E = 8, 8


def serve_phase(torch, K, rt):
    cfg = rt.configs.get_config("qwen2_1_5b")
    t0 = time.perf_counter()
    params = rt.models.materialize(0, rt.models.init_lm(cfg), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in rt.tree.tree_leaves(params))
    log(f"[serve] {cfg.name}: {n_params / 1e9:.3f} B params, bf16, "
        f"{cfg.n_layers} layers, init {time.perf_counter() - t0:.1f} s")
    block = cfg.d_ff // cfg.pattern_nb
    plan = rt.core.build_plan("rdp", 0.5, nb=cfg.pattern_nb, dp_max=8,
                              block=block, backend="cuda")
    log(f"[serve] plan K={[round(k, 4) for k in plan.dist]} "
        f"buckets={len(plan.buckets())}")
    rng = __import__("numpy").random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab, 64).astype("int32")

    def run(backend, shared=True, which="both"):
        return serve_run(torch, rt, cfg, params, plan, prompt, backend,
                         shared, which)

    # main path, cuda backend: shared prefill, then per-member prefill
    K.reset_launches()
    cuda_out, w1 = run("cuda")
    _, w2 = run("cuda", shared=False, which="ensemble")
    launches = {k.name: k.launches for k in K.KERNELS}
    log(f"[serve] launches on the cuda-backend path: {launches}")
    require(launches[K.RDP_COLS.name] > 0 and launches[K.RDP_ROWS.name] > 0,
            "the cuda backend did not launch the compact matmul kernels")
    require(launches[K.FUSED_FFN.name] == 0,
            "the cuda backend launched the fused kernel")
    # main path, fused backend
    K.reset_launches()
    fused_out, w3 = run("fused")
    fused_launches = K.FUSED_FFN.launches
    log(f"[serve] launches on the fused-backend path: "
        f"{ {k.name: k.launches for k in K.KERNELS} }")
    require(fused_launches > 0, "the fused backend did not launch its kernel")
    launches[K.FUSED_FFN.name] = fused_launches
    # reference: the same trace on the slice backend (library matmuls), and
    # on gather (library matmuls on index-gathered weights)
    slice_out, _ = run("slice")
    gather_out, _ = run("gather")

    logit_errs = compare_first_logits(
        {"cuda": cuda_out, "fused": fused_out, "gather": gather_out},
        slice_out, LOGIT_TOL, "bf16")
    # the TDP path: qwen2-1.5b at pattern_nb 12, the ensemble on cuda
    tcfg = dataclasses.replace(cfg, pattern_nb=TDP_NB)
    tplan = rt.core.build_plan("tdp", 0.5, nb=TDP_NB, dp_max=8,
                               backend="cuda")
    log(f"[serve] tdp plan K={[round(k, 4) for k in tplan.dist]} "
        f"buckets={len(tplan.buckets())}")
    K.reset_launches()
    tdp_out, w4 = serve_run(torch, rt, tcfg, params, tplan, prompt, "cuda",
                            which="ensemble")
    tdp_launches = {k.name: k.launches for k in K.KERNELS}
    log(f"[serve] launches on the tdp cuda-backend path: {tdp_launches}")
    require(tdp_launches[K.TDP_MATMUL.name] > 0,
            "the tdp cuda backend did not launch tdp_matmul")
    require(all(n == 0 for k, n in tdp_launches.items()
                if k != K.TDP_MATMUL.name),
            "the tdp serving path launched another kernel")
    tdp_slice, _ = serve_run(torch, rt, tcfg, params, tplan, prompt, "slice",
                             which="ensemble")
    logit_errs += compare_first_logits({"cuda": tdp_out}, tdp_slice, None,
                                       "bf16 tdp")
    logit_errs += f32_backend_check(torch, rt, [
        ("f32", cfg, plan, ("cuda", "fused")),
        ("f32 tdp", tcfg, tplan, ("cuda",))], prompt)
    steps = decode_step_table(torch, rt, cfg, params, plan, "rdp",
                              [("cuda", dp) for dp in (1, 2, 4, 8)]
                              + [("fused", dp) for dp in (2, 4, 8)])
    steps += decode_step_table(torch, rt, tcfg, params, tplan, "tdp",
                               [("cuda", 2), ("cuda", 6)])
    return {"launches": launches, "tdp_launches": tdp_launches,
            "wall_s": {"cuda_shared": w1, "cuda_member": w2,
                       "fused_shared": w3, "tdp_cuda_shared": w4},
            "logit_errs": logit_errs, "decode_steps": steps,
            "plan_dist": list(plan.dist), "tdp_plan_dist": list(tplan.dist)}


def compare_first_logits(outs: dict, ref_out, tol, label: str):
    """First-token logits of request 1's dp > 1 members, each backend in
    ``outs`` against ``ref_out`` (the slice backend): max |Δ| / max|ref|,
    held to ``tol`` (reported only when it is None)."""
    import numpy as np
    ref = {m["member"]: m for m in ref_out["results"][1]}
    errs = []
    for be, out in outs.items():
        for got in out["results"][1]:
            r = ref[got["member"]]
            if r["dp"] <= 1:
                continue
            require((got["dp"], got["bias"]) == (r["dp"], r["bias"]),
                    f"{be}: member {got['member']} drew another bucket")
            rl = r["first_logits"].astype(np.float64)
            err = float(np.abs(got["first_logits"] - rl).max()
                        / np.abs(rl).max())
            errs.append({"dtype": label, "member": got["member"],
                         "bucket": [r["dp"], r["bias"]], "backend": be,
                         "rel_err": err, "argmax_equal": bool(
                             got["first_logits"].argmax() == rl.argmax())})
            require(tol is None or err <= tol, f"{label} {be} member "
                    f"{got['member']} bucket ({r['dp']},{r['bias']}): "
                    f"first-token logits rel err {err:.3e} > {tol} vs slice")
    require(errs, f"{label}: no dp > 1 member to compare")
    for be in outs:
        e = [x for x in errs if x["backend"] == be]
        log(f"[serve] {label} first-token logits, {be} vs slice ({len(e)} "
            f"dp>1 members): max rel err "
            f"{max(x['rel_err'] for x in e):.3e} "
            f"({'reported' if tol is None else f'tol {tol}'}), argmax equal "
            f"{sum(x['argmax_equal'] for x in e)}/{len(e)}")
    return errs


def f32_backend_check(torch, rt, cases, prompt):
    """The same ensemble request at full width in float32 (TF32 off), for
    each (label, cfg, plan, backends) case: the backends differ from slice
    only in summation order, so they must agree with it to F32_LOGIT_TOL.
    The weights do not depend on the pattern blocking, so the cases share
    one float32 copy."""
    cfg32 = dataclasses.replace(cases[0][1], dtype="float32")
    params = rt.models.materialize(0, rt.models.init_lm(cfg32),
                                   device="cuda")
    errs = []
    for label, cfg, plan, backends in cases:
        c32 = dataclasses.replace(cfg, dtype="float32")
        outs = {}
        for backend in ("slice",) + tuple(backends):
            sched = rt.serve.Scheduler(c32, params, capacity=16,
                                       max_len=128,
                                       plan=plan.with_backend(backend),
                                       device="cuda")
            outs[backend] = rt.serve.Server(sched).run([rt.serve.Request(
                rid=1, prompt=prompt, max_new_tokens=2, ensemble=SERVE_E,
                seed=7)])
        ref = outs.pop("slice")
        errs += compare_first_logits(outs, ref, F32_LOGIT_TOL, label)
    del params
    torch.cuda.empty_cache()
    return errs


def ffn_bytes_bound_ms(cfg, family: str, dp: int) -> float:
    """Least time of a decode step's FFN weight reads over the HBM rate:
    3·d·d_ff bf16 weights a layer, all layers; rdp reads 1/dp of all
    three, tdp 1/dp of w_up and all of w_gate and w_down."""
    ffn_bytes = 3 * cfg.d_model * cfg.d_ff * 2 * cfg.n_layers
    share = 1 / dp if family == "rdp" else (1 / dp + 2) / 3
    return ffn_bytes * share / HBM_BYTES_PER_S * 1e3


def decode_step_table(torch, rt, cfg, params, plan, family, configs):
    """One decode step per (backend, dp) of ``configs`` and width at
    position 64: host-clock ms of the eager step (what the scheduler pays
    today) and device ms of the same step replayed from a CUDA graph (the
    step without host launch overhead), beside the FFN-weight-bytes
    bound."""
    rows = []
    for backend, dp in configs:
        pat = (plan.with_backend(backend).bind(dp, 0) if dp > 1
               else rt.core.IDENTITY)
        for width in (1, 8):
            cache = rt.serve.init_cache(cfg, width, 128, device="cuda")
            cache["pos"] = torch.full((width,), 64, dtype=torch.int64,
                                      device="cuda")
            tok = torch.zeros((width, 1), dtype=torch.int64, device="cuda")

            def step(_i=0):
                rt.serve.decode_step_ragged(cfg, params, cache, tok, pat=pat)

            for _ in range(2):
                step()
            torch.cuda.synchronize()
            n = 5
            t = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            host_ms = (time.perf_counter() - t) / n * 1e3
            dev_ms = cuda_ms(torch, step, iters=2, warmup=1, replays=3)
            bnd = ffn_bytes_bound_ms(cfg, family, dp)
            rows.append({"family": family, "backend": backend, "dp": dp,
                         "width": width, "step_ms": host_ms,
                         "graph_step_ms": dev_ms, "ffn_bytes_bound_ms": bnd,
                         "kernels": profile_step(torch, step, host_ms)})
            log(f"[decode] {family} {backend:5s} dp={dp} width={width}: "
                f"eager {host_ms:.2f} ms/step, graph-replayed {dev_ms:.3f} "
                f"ms/step, FFN-weight bound {bnd:.3f} ms")
            log_profile(rows[-1]["kernels"])
    return rows


# kernel names in the trace: the port's own (namespaces rdp and tdp, csrc/), the
# library's matrix products (attention projections, dense FFN, unembedding;
# cuBLAS names them gemm/xmma/cutlass or nvjet), and copies (cache writes,
# casts, contiguous copies)
PORT_KERNELS = ("rdp::", "tdp::")
LIBRARY_GEMM = ("gemm", "gemv", "cutlass", "xmma", "splitk", "nvjet")


def kernel_class(name: str) -> str:
    low = name.lower()
    if any(p in name for p in PORT_KERNELS):
        return "port_ffn"
    if any(w in low for w in LIBRARY_GEMM):
        return "library_gemm"
    if "copy" in low:
        return "copy"
    return "other"


def profile_step(torch, step, eager_ms: float, n: int = 3):
    """Device time per kernel of one eager decode step, from torch.profiler
    (CUPTI) over ``n`` steps: ms per step by class and the top kernels, and
    the device's idle share of the unprofiled eager step
    (1 - device-busy ms / eager ms).  Returns None when the profiler
    recorded no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        if not str(e.device_type).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        if us > 0:
            per[e.key] = (us / 1e3 / n, e.count / n)
    if not per:
        return None
    by_class = {"port_ffn": 0.0, "library_gemm": 0.0, "copy": 0.0,
                "other": 0.0}
    for name, (ms, _) in per.items():
        by_class[kernel_class(name)] += ms
    busy = sum(by_class.values())
    top = sorted(per.items(), key=lambda kv: -kv[1][0])[:12]
    return {"busy_ms": busy, "by_class_ms": by_class,
            "idle_share_eager": max(0.0, 1 - busy / eager_ms),
            "launches_per_step": sum(c for _, c in per.values()),
            "top": [{"kernel": k[:100], "ms": ms, "calls": c}
                    for k, (ms, c) in top]}


def log_profile(prof):
    if prof is None:
        log("[profile] torch.profiler recorded no device time")
        return
    cls = ", ".join(f"{k} {v:.3f}" for k, v in prof["by_class_ms"].items())
    log(f"[profile]   device busy {prof['busy_ms']:.3f} ms/step ({cls}); "
        f"{prof['launches_per_step']:.0f} kernels/step; idle share of the "
        f"eager step {prof['idle_share_eager']:.3f}")
    for t in prof["top"][:4]:
        log(f"[profile]     {t['ms']:.3f} ms x{t['calls']:.0f} "
            f"{t['kernel'][:70]}")


# ==========================================================================
# phase 4: train qwen2-1.5b at full width
# ==========================================================================

TRAIN_M = (1, 100, 2048)      # a ragged tile, a partial one, a train step
# f32 gradients at full width: the backends differ only in summation order
# (~1e-7 relative per product), compounded through 28 layers forward and
# backward — 1e-3 of each leaf's largest gradient.
F32_GRAD_TOL = 1e-3


def backward_kernels(K):
    return [K.COLS_DGRAD, K.COLS_WGRAD, K.ROWS_DGRAD, K.ROWS_WGRAD]


def backward_kernel_phase(torch, K, shapes):
    """Kernels 4-7 against their plain versions at the training path's
    shapes (same tolerances as phase 2: the wgrads contract over up to
    2048 tokens, the dgrads over up to 4480 kept units or 1536), then timed
    at M 2048, dp 2, bf16.  Returns (worst abs, worst rel, timing rows)."""
    d_model, d_ff, block = shapes
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(1)
    names = [k.name for k in backward_kernels(K)]
    worst, worst_rel = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    checks = 0
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)  # noqa: E731
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        tol = KERNEL_TOL[dname]
        w = (rn(d_model, d_ff) / d_model ** 0.5).to(dt)
        wd = (rn(d_ff, d_model) / d_ff ** 0.5).to(dt)
        for m in TRAIN_M:
            a, dcd = rn(m, d_model).to(dt), rn(m, d_model).to(dt)
            for dp in (2, 4, 8):
                dcc, ac = rn(m, d_ff // dp).to(dt), rn(m, d_ff // dp).to(dt)
                kw = dict(dp=dp, block=block)
                cases = [
                    (K.COLS_WGRAD, lambda: K.rdp_cols_wgrad(a, dcc, **kw),
                     lambda: K.rdp_cols_wgrad_plain(a, dcc, **kw)),
                    (K.ROWS_WGRAD, lambda: K.rdp_rows_wgrad(ac, dcd, **kw),
                     lambda: K.rdp_rows_wgrad_plain(ac, dcd, **kw))]
                for b in range(dp):
                    cases += [
                        (K.COLS_DGRAD,
                         lambda b=b: K.rdp_cols_dgrad(dcc, w, b, **kw),
                         lambda b=b: K.rdp_cols_dgrad_plain(dcc, w, b, **kw)),
                        (K.ROWS_DGRAD,
                         lambda b=b: K.rdp_rows_dgrad(dcd, wd, b, **kw),
                         lambda b=b: K.rdp_rows_dgrad_plain(dcd, wd, b,
                                                            **kw))]
                for kern, fn, plain in cases:
                    got, ref = fn(), plain().float()
                    torch.cuda.synchronize()
                    abs_err = float((got.float() - ref).abs().max())
                    err = abs_err / max(float(ref.abs().max()), 1e-30)
                    require(bool(torch.isfinite(got).all()),
                            f"{kern.name}: non-finite output")
                    require(err <= tol, f"{kern.name} {dname} M={m} dp={dp}"
                            f": rel err {err:.3e} > {tol}")
                    if dname == "bfloat16":
                        worst[kern.name] = max(worst[kern.name], abs_err)
                        worst_rel[kern.name] = max(worst_rel[kern.name], err)
                    checks += 1
    log(f"[train] {checks} backward kernel-vs-plain checks passed (f32 tol "
        f"{KERNEL_TOL['float32']}, bf16 tol {KERNEL_TOL['bfloat16']} of "
        f"max|ref|); bf16 worst max-abs {worst}, relative {worst_rel}")
    return worst, worst_rel, backward_timing(torch, K, shapes, g)


def backward_timing(torch, K, shapes, g, m=2048, dp=2, b=1):
    """bf16 times at M 2048 (the train step's tokens), dp 2: kernel, plain
    version, and one library matmul on pre-gathered contiguous compact
    operands as the yardstick.  All four are bound by operations."""
    from repro_torch.core.patterns import kept_unit_indices
    d_model, d_ff, block = shapes
    dev, dt = "cuda", torch.bfloat16
    rn = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)  # noqa
    nc = d_ff // dp
    w, wd = rn(d_model, d_ff) / d_model ** 0.5, rn(d_ff, d_model) / d_ff ** .5
    idx = kept_unit_indices(d_ff, dp, b, block, device=dev)
    wc, wr = w[:, idx].contiguous(), wd[idx].contiguous()
    a, dcd, dcc, ac = rn(m, d_model), rn(m, d_model), rn(m, nc), rn(m, nc)
    kw = dict(dp=dp, block=block)
    nbytes = 2 * (m * d_model + m * nc + d_model * nc)
    flops = 2 * m * d_model * nc
    cases = {
        K.COLS_DGRAD.name: (lambda i: K.rdp_cols_dgrad(dcc, w, b, **kw),
                            lambda i: K.rdp_cols_dgrad_plain(dcc, w, b, **kw),
                            lambda i: torch.matmul(dcc, wc.t())),
        K.COLS_WGRAD.name: (lambda i: K.rdp_cols_wgrad(a, dcc, **kw),
                            lambda i: K.rdp_cols_wgrad_plain(a, dcc, **kw),
                            lambda i: torch.matmul(a.t(), dcc)),
        K.ROWS_DGRAD.name: (lambda i: K.rdp_rows_dgrad(dcd, wd, b, **kw),
                            lambda i: K.rdp_rows_dgrad_plain(dcd, wd, b,
                                                             **kw),
                            lambda i: torch.matmul(dcd, wr.t())),
        K.ROWS_WGRAD.name: (lambda i: K.rdp_rows_wgrad(ac, dcd, **kw),
                            lambda i: K.rdp_rows_wgrad_plain(ac, dcd, **kw),
                            lambda i: torch.matmul(ac.t(), dcd)),
    }
    rows = []
    for name, (kern, plain, lib) in cases.items():
        bnd, by = bound_ms(nbytes, flops, "bfloat16")
        t = lambda f: cuda_ms(torch, f, iters=5, warmup=2,  # noqa: E731
                              replays=3)
        rec = {"name": name, "dp": dp, "M": m, "dtype": "bfloat16",
               "ms": t(kern), "plain_ms": t(plain), "library_ms": t(lib),
               "bound_ms": bnd, "bound_by": by}
        rows.append(rec)
        log(f"[time] {name:16s} dp={dp} M={m}: kernel {rec['ms']:.4f} ms, "
            f"plain {rec['plain_ms']:.4f} ms, library "
            f"{rec['library_ms']:.4f} ms, bound {bnd:.4f} ms ({by})")
    return rows


def _dropped_zero(torch, params, grads, leaves, d_ff, dp, b, block):
    """Are the gradients of every layer's dropped FFN blocks exactly zero
    (and the kept ones not all zero)?"""
    from repro_torch.core.patterns import kept_unit_indices
    kept = kept_unit_indices(d_ff, dp, b, block, device="cuda")
    mask = torch.ones(d_ff, dtype=torch.bool, device="cuda")
    mask[kept] = False
    gmap = {id(p): gr for p, gr in zip(leaves, grads)}
    for lp in params["layers"]:
        ffn = lp["ffn"]
        gd = gmap[id(ffn["w_down"])]
        if bool((gd[mask] != 0).any()) or not bool((gd[kept] != 0).any()):
            return False
        for name in ("w_up", "w_gate"):
            gu = gmap[id(ffn[name])]
            if bool((gu[:, mask] != 0).any()) \
                    or not bool((gu[:, kept] != 0).any()):
                return False
    return True


def tdp_grad_parity(torch, rt, cfg, params, leaves, batch):
    """f32 lm_loss gradients under the TDP plan (pattern_nb 12) on "cuda"
    against "slice" at dp 2 (kernel 9) and 3/4/6 (the mask-multiply
    dgrad), held to F32_GRAD_TOL of each leaf's max|g|; in every layer the
    nonzero tiles of the w_up gradient are exactly the kept tiles, and the
    w_gate / w_down gradients are dense (no hidden unit without one)."""
    tcfg = dataclasses.replace(cfg, pattern_nb=TDP_NB)
    tile = cfg.d_model // TDP_NB
    tr, tc = cfg.d_model // tile, cfg.d_ff // tile
    plan = rt.core.build_plan("tdp", 0.5, nb=TDP_NB, dp_max=8)
    out = []
    for dp in TDP_DPS:
        b = dp - 1
        gs = {}
        for backend in ("slice", "cuda"):
            loss, _ = rt.models.lm_loss(tcfg, params, batch,
                                        plan.with_backend(backend).bind(dp, b))
            gs[backend] = torch.autograd.grad(loss, leaves)
        rel = max(float((x - r).abs().max()) / max(float(r.abs().max()),
                                                   1e-30)
                  for x, r in zip(gs["cuda"], gs["slice"]))
        keep = rt.core.patterns.tdp_mask(tr, tc, dp, b, 1, torch.bool,
                                         device="cuda")
        for backend, g in gs.items():
            gmap = {id(p): x for p, x in zip(leaves, g)}
            for lp in params["layers"]:
                ffn = lp["ffn"]
                nz = (gmap[id(ffn["w_up"])].reshape(tr, tile, tc, tile) != 0
                      ).any(3).any(1)
                require(torch.equal(nz, keep), f"tdp {backend} dp={dp}: the "
                        f"nonzero w_up gradient tiles are not the kept ones")
                require(bool((gmap[id(ffn["w_gate"])] != 0).any(0).all())
                        and bool((gmap[id(ffn["w_down"])] != 0).any(1).all()),
                        f"tdp {backend} dp={dp}: w_gate / w_down gradient "
                        f"not dense")
        require(rel <= F32_GRAD_TOL, f"f32 tdp cuda dp={dp}: grad rel err "
                f"{rel:.3e} > {F32_GRAD_TOL}")
        out.append({"dtype": "float32", "family": "tdp", "backend": "cuda",
                    "dp": dp, "bias": b, "max_leaf_rel_err": rel,
                    "dropped_zero": True})
        log(f"[grads] float32 tdp cuda dp={dp} b={b}: max over leaves of "
            f"max|g - g_slice| / max|g_slice| = {rel:.3e} (tol "
            f"{F32_GRAD_TOL}); w_up nonzero tiles = kept tiles, w_gate / "
            f"w_down dense")
        del gs
    return out


def grad_parity_phase(torch, rt, cfg):
    """One forward + backward of lm_loss at full width (batch 1 x 128) per
    dp in (2, 4, 8): every weight gradient on "cuda" and "fused" against
    "slice" — held to F32_GRAD_TOL of the leaf's max|g| in float32,
    reported in bf16 — and dropped blocks' gradients exactly zero in
    both; in float32 also the TDP plan (``tdp_grad_parity``)."""
    import numpy as np
    block = cfg.d_ff // cfg.pattern_nb
    plan = rt.core.build_plan("rdp", 0.5, nb=cfg.pattern_nb, dp_max=8,
                              block=block)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (1, 129))
    batch = {"tokens": torch.as_tensor(toks[:, :-1], device="cuda"),
             "labels": torch.as_tensor(toks[:, 1:], device="cuda")}
    out = []
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        params = rt.models.materialize(0, rt.models.init_lm(c),
                                       device="cuda")
        leaves = rt.tree.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)

        def grads(backend, dp, b):
            pat = plan.with_backend(backend).bind(dp, b)
            loss, _ = rt.models.lm_loss(c, params, batch, pat)
            return torch.autograd.grad(loss, leaves)

        if dtype == "float32":
            out += tdp_grad_parity(torch, rt, c, params, leaves, batch)
        for dp in (2, 4, 8):
            b = dp - 1
            ref = grads("slice", dp, b)
            for backend in ("cuda", "fused"):
                got = grads(backend, dp, b)
                rel = max(float((x.float() - r.float()).abs().max())
                          / max(float(r.float().abs().max()), 1e-30)
                          for x, r in zip(got, ref))
                zeros = _dropped_zero(torch, params, got, leaves, c.d_ff,
                                      dp, b, block)
                require(zeros, f"{dtype} {backend} dp={dp}: dropped-block "
                        f"weight gradients not exactly zero")
                if dtype == "float32":
                    require(rel <= F32_GRAD_TOL, f"f32 {backend} dp={dp}: "
                            f"grad rel err {rel:.3e} > {F32_GRAD_TOL}")
                out.append({"dtype": dtype, "family": "rdp",
                            "backend": backend, "dp": dp,
                            "bias": b, "max_leaf_rel_err": rel,
                            "dropped_zero": zeros})
                log(f"[grads] {dtype} {backend} dp={dp} b={b}: max over "
                    f"leaves of max|g - g_slice| / max|g_slice| = {rel:.3e}"
                    + (f" (tol {F32_GRAD_TOL})" if dtype == "float32"
                       else " (reported)") + "; dropped blocks exactly 0")
                del got
            del ref
        del params, leaves
        torch.cuda.empty_cache()
    return out


def train_run(torch, K, rt, cfg, plan, backend, steps=8):
    """``Trainer`` + ``AdamW`` for ``steps`` steps on ``backend`` from
    fresh seed-0 weights, launch counts reset just before and read just
    after."""
    params = rt.models.materialize(0, rt.models.init_lm(cfg), device="cuda")
    data = rt.data.SyntheticLMData(vocab=cfg.vocab, seq_len=512,
                                   global_batch=4)
    trainer = rt.train.Trainer(
        cfg, rt.optim.AdamW(), params, plan=plan.with_backend(backend),
        tcfg=rt.train.TrainerConfig(steps=steps, log_every=1),
        device="cuda")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    t = time.perf_counter()
    hist = trainer.run(data.batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = {k.name: k.launches for k in K.KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    import math
    require(len(hist) == steps, f"{backend}: {len(hist)} steps")
    require(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                for h in hist), f"{backend}: non-finite loss or grad norm")
    require(any(h["dp"] > 1 for h in hist), f"{backend}: no dp > 1 step")
    trainer.obs.watchdog.assert_clean()
    name = f"{plan.family} {backend}"
    log(f"[train] {name}: {steps} steps in {wall:.2f} s, peak "
        f"{peak_gb:.1f} GB, buckets {[(h['dp'], h['bias']) for h in hist]}")
    log(f"[train] {name}: losses {[round(h['loss'], 4) for h in hist]}, "
        f"grad norms {[round(h['grad_norm'], 3) for h in hist]}")
    log(f"[train] launches on the {name} train path: {launches}")
    del trainer, params
    torch.cuda.empty_cache()
    return {"history": hist, "wall_s": wall, "peak_gb": peak_gb,
            "launches": launches}


def train_step_bound_ms(cfg, tokens: int, dp: int, n_params: int,
                        family: str = "rdp"):
    """Least times of one train step: (matmul FLOPs — 6 per weight per
    token, the pattern's FFN weights at 1/dp (rdp: all three; tdp: w_up
    only), attention scores left out — at the bf16 peak, AdamW's state
    traffic — 24 B a parameter: bf16 param read and written, f32 grad read,
    f32 moments read and written — at the HBM rate), in ms."""
    attn = cfg.d_model * cfg.head_dim * 2 * (cfg.n_heads + cfg.n_kv_heads)
    ffn = cfg.d_model * cfg.d_ff * (3 / dp if family == "rdp"
                                    else 1 / dp + 2)
    flops = 6 * tokens * (cfg.n_layers * (attn + ffn)
                          + cfg.d_model * cfg.vocab)
    return (flops / PEAK_FLOPS["bfloat16"] * 1e3,
            24 * n_params / HBM_BYTES_PER_S * 1e3)


def train_step_table(torch, rt, cfg, plan, tcfg, tplan):
    """Eager train step (forward, backward, clip, AdamW at lr 0 so the
    weights stay put) per (family, backend, dp) at batch 4 x 512: host-clock
    ms with a synchronize, and the step's device time per kernel class from
    torch.profiler.  ``tcfg`` / ``tplan``: the TDP rows' model (pattern_nb
    12; the same weights) and plan."""
    params = rt.models.materialize(0, rt.models.init_lm(cfg), device="cuda")
    opt = rt.optim.AdamW()
    state = opt.init(params)
    batch = rt.data.SyntheticLMData(vocab=cfg.vocab, seq_len=512,
                                    global_batch=4).batch(0)
    n_params = sum(t.numel() for t in rt.tree.tree_leaves(params))
    rows = []
    configs = ([("rdp", "dense", 1)]
               + [("rdp", be, dp) for be in ("slice", "cuda", "fused")
                  for dp in (2, 4, 8)]
               + [("tdp", be, dp) for be in ("slice", "cuda") for dp in (2, 6)])
    for family, backend, dp in configs:
        c, pl = (cfg, plan) if family == "rdp" else (tcfg, tplan)
        pat = (pl.with_backend(backend).bind(dp, 0) if dp > 1
               else rt.core.IDENTITY)
        fn = rt.train.make_train_step(c, opt, pat=pat, device="cuda")

        def step(_i=0):
            fn(params, state, batch, 0.0)

        step()
        torch.cuda.synchronize()
        n = 3
        t = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t) / n * 1e3
        flop_ms, adam_ms = train_step_bound_ms(cfg, batch["tokens"].size,
                                               dp, n_params, family)
        rows.append({"family": family, "backend": backend, "dp": dp,
                     "step_ms": host_ms, "flop_bound_ms": flop_ms,
                     "adam_bytes_bound_ms": adam_ms,
                     "kernels": profile_step(torch, step, host_ms, n=1)})
        log(f"[step] {family} {backend:5s} dp={dp}: eager train step "
            f"{host_ms:.1f} ms (bounds: matmul FLOPs {flop_ms:.2f} ms + "
            f"AdamW bytes {adam_ms:.2f} ms)")
        log_profile(rows[-1]["kernels"])
    del params, state
    torch.cuda.empty_cache()
    return rows


def train_phase(torch, K, rt, shapes):
    cfg = rt.configs.get_config("qwen2_1_5b")
    worst, worst_rel, table = backward_kernel_phase(torch, K, shapes)
    grads = grad_parity_phase(torch, rt, cfg)
    block = cfg.d_ff // cfg.pattern_nb
    plan = rt.core.build_plan("rdp", 0.5, nb=cfg.pattern_nb, dp_max=8,
                              block=block, backend="cuda")
    runs = {be: train_run(torch, K, rt, cfg, plan, be)
            for be in ("cuda", "fused")}
    for be, run in runs.items():
        for k in backward_kernels(K):
            require(run["launches"][k.name] > 0, f"the {be}-backend train "
                    f"path did not launch {k.name}")
    require(runs["fused"]["launches"][K.RDP_COLS.name] > 0,
            "the fused backward did not rematerialize with rdp_matmul_cols")
    require(runs["fused"]["launches"][K.FUSED_FFN.name] > 0,
            "the fused-backend train path did not launch its forward kernel")
    # the TDP path: every dp > 1 step runs kernels 8 and 10 once a layer,
    # a dp 2 step kernel 9 too (dp | 70 tile-columns); other periods take
    # the mask-multiply dgrad
    tcfg = dataclasses.replace(cfg, pattern_nb=TDP_NB)
    tplan = rt.core.build_plan("tdp", 0.5, nb=TDP_NB, dp_max=8,
                               backend="cuda")
    run = runs["tdp_cuda"] = train_run(torch, K, rt, tcfg, tplan, "cuda")
    dps = [h["dp"] for h in run["history"]]
    want = {K.TDP_MATMUL.name: cfg.n_layers * sum(d > 1 for d in dps),
            K.TDP_WGRAD.name: cfg.n_layers * sum(d > 1 for d in dps),
            K.TDP_DGRAD.name: cfg.n_layers * dps.count(2)}
    got = {k.name: run["launches"][k.name] for k in tdp_kernels(K)}
    require(got == want, f"tdp train launches {got}, want {want}")
    require(want[K.TDP_DGRAD.name] > 0, "no dp 2 step on the tdp train path")
    require(all(run["launches"][k.name] == 0 for k in K.KERNELS
                if k not in tdp_kernels(K)),
            "the tdp train path launched an rdp kernel")
    steps = train_step_table(torch, rt, cfg, plan, tcfg, tplan)
    return {"worst": worst, "worst_rel": worst_rel, "kernel_times": table,
            "grads": grads, "runs": runs, "steps": steps}


# ==========================================================================

def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import repro_torch.configs
    import repro_torch.core
    import repro_torch.data
    import repro_torch.models
    import repro_torch.optim
    import repro_torch.serve
    import repro_torch.train
    import repro_torch.tree
    from repro_torch import kernels as K
    rt = repro_torch

    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    phase_s = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        return out

    built = timed("build", lambda: K.build_all(force=True))
    log(f"[build] {json.dumps({k: round(v, 2) for k, v in built.items()})} "
        f"in {phase_s['build']:.2f} s")

    shapes = (1536, 8960, 70)       # qwen2-1.5b: d_model, d_ff, 8960/128
    worst, worst_rel, table = timed("kernels", kernel_phase, torch, K, shapes)
    tdp_worst, tdp_worst_rel, tdp_table, tdp_checks = timed(
        "tdp_kernels", tdp_kernel_phase, torch, K, *shapes[:2])
    serve = timed("serve", serve_phase, torch, K, rt)
    train = timed("train", train_phase, torch, K, rt, shapes)
    log(f"[phases] seconds "
        f"{json.dumps({k: round(v, 1) for k, v in phase_s.items()})}")

    # launches on the main paths: serving (rdp on cuda, fused; tdp on cuda)
    # and training (rdp on cuda, fused; tdp on cuda), each counted from zero
    # just before its run
    by_path = {k.name: {"serve": serve["launches"][k.name],
                        "serve_tdp": serve["tdp_launches"][k.name],
                        **{f"train_{be}": run["launches"][k.name]
                           for be, run in train["runs"].items()}}
               for k in K.KERNELS}
    worst |= train["worst"] | tdp_worst
    worst_rel |= train["worst_rel"] | tdp_worst_rel
    # times: the forward kernels at a decode width (M 8), the backward ones
    # at a train step (M 2048), dp 2
    kernels_line = []
    for k in K.KERNELS:
        fwd_m = 8 if k in (K.RDP_COLS, K.RDP_ROWS, K.FUSED_FFN,
                           K.TDP_MATMUL) else 2048
        rec = next(r for r in table + train["kernel_times"] + tdp_table
                   if r["name"] == k.name and r["dp"] == 2
                   and r["M"] == fwd_m)
        kernels_line.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces,
            "launches": sum(by_path[k.name].values()),
            "launches_by_path": by_path[k.name],
            "max_abs_err": worst[k.name], "max_rel_err": worst_rel[k.name],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": f"times at M={rec['M']} dp={rec['dp']} bf16; errors "
                     f"over the bf16 sweep"})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "device": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": built, "phase_s": phase_s, "kernel_times": table,
        "tdp_kernel_times": tdp_table, "tdp_checks": tdp_checks,
        "serve": serve, "train": train, "kernels": kernels_line,
        "total_s": time.perf_counter() - t_start}, indent=1, default=float))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels_line}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
