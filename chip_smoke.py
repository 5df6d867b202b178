#!/usr/bin/env python3
"""On-card smoke of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each of which fails the run (exit code 1) on any error:

1. build  — compile every CUDA kernel of the serving path from
   ``src/repro_torch/csrc`` (one nvcc per source, all started together);
2. kernels — hold each kernel against its plain PyTorch version on the card
   at the serving path's shapes (qwen2-1.5b: d_model 1536, d_ff 8960, block
   70; dp 2/4/8, every bias, M 1/2/3/8/16/256, bf16 and f32), and time kernel,
   plain version and a library matmul on pre-gathered compact weights;
3. serve  — qwen2-1.5b at full width (28 layers, bf16, random weights from a
   seed) through ``Scheduler`` + ``Server`` on the "cuda" backend (shared
   and per-member prefill) and the "fused" backend, with launch counts reset
   just before and read just after each; first-token logits of patterned
   members on both backends (and on "gather") against a "slice"-backend
   run, in bf16 and again in float32;
   per-bucket decode-step times beside the FFN-weight-bytes bound, with
   each step's device time per kernel from torch.profiler.

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
as its last line ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Exits non-zero, printing no result,
without a CUDA device or without the repository beside it.
"""
from __future__ import annotations

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
        for m in (1, 2, 3, 8, 16, 256):
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
    """bf16 times at decode and prefill M, weights rotated through copies
    that together exceed the 50 MB L2 (the decode path streams 28 layers
    of weights, so it finds them cold)."""
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
        for m in (1, 8, 16, 256):
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
            for name, (kern, plain, lib, nbytes, flops) in cases.items():
                bnd, by = bound_ms(nbytes, flops, "bfloat16")
                rec = {"name": name, "dp": dp, "M": m, "dtype": "bfloat16",
                       "ms": cuda_ms(torch, kern),
                       "plain_ms": cuda_ms(torch, plain),
                       "library_ms": (cuda_ms(torch, lib) if lib is not None
                                      else None),
                       "bound_ms": bnd, "bound_by": by}
                rows.append(rec)
                log(f"[time] {name:16s} dp={dp} M={m:3d}: kernel "
                    f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, "
                    f"library {rec['library_ms'] if lib else 'n/a'} ms, "
                    f"bound {bnd:.4f} ms ({by})")
    return rows


# ==========================================================================
# phase 3: serve qwen2-1.5b at full width
# ==========================================================================

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
    S, NEW, E = 64, 8, 8

    def requests(which):
        reqs = [rt.serve.Request(rid=0, prompt=prompt, max_new_tokens=NEW,
                                 ensemble=1),
                rt.serve.Request(rid=1, prompt=prompt, max_new_tokens=NEW,
                                 ensemble=E, seed=7)]
        return reqs if which == "both" else reqs[1:]

    def run(backend, shared=True, which="both"):
        sched = rt.serve.Scheduler(cfg, params, capacity=16, max_len=128,
                                   plan=plan.with_backend(backend),
                                   shared_prefill=shared, device="cuda")
        t = time.perf_counter()
        out = rt.serve.Server(sched, clock=rt.serve.WallClock()).run(
            requests(which))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        reqs = requests(which)
        for r in reqs:
            members = out["results"][r.rid]
            require(len(members) == r.ensemble,
                    f"{backend}: request {r.rid} has {len(members)} members")
            for m in members:
                require(len(m["tokens"]) == NEW,
                        f"{backend}: member {m['member']} produced "
                        f"{len(m['tokens'])} tokens, want {NEW}")
                require(all(0 <= t < cfg.vocab for t in m["tokens"]),
                        f"{backend}: token out of vocabulary")
                fl = m["first_logits"]
                require(fl is not None and fl.shape == (cfg.vocab,)
                        and bool(__import__("numpy").isfinite(fl).all()),
                        f"{backend}: first logits not finite [{cfg.vocab}]")
        tel = out["telemetry"]
        require(tel["tokens_generated"]
                == NEW * sum(r.ensemble for r in reqs),
                f"{backend}: token count {tel['tokens_generated']}")
        sched.obs.watchdog.assert_clean()
        log(f"[serve] backend={backend} shared_prefill={shared}: "
            f"{wall:.2f} s wall, buckets {sorted(tel['bucket_tokens'])}, "
            f"prompt tokens {tel['prompt_tokens']}")
        return out, wall

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
    logit_errs += f32_backend_check(torch, rt, cfg, plan, prompt)
    steps = decode_step_table(torch, rt, cfg, params, plan)
    return {"launches": launches, "wall_s": {"cuda_shared": w1,
                                             "cuda_member": w2,
                                             "fused_shared": w3},
            "logit_errs": logit_errs, "decode_steps": steps,
            "plan_dist": list(plan.dist)}


def compare_first_logits(outs: dict, ref_out, tol: float, label: str):
    """First-token logits of request 1's dp > 1 members, each backend in
    ``outs`` against ``ref_out`` (the slice backend): max |Δ| / max|ref|."""
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
            require(err <= tol, f"{label} {be} member {got['member']} "
                    f"bucket ({r['dp']},{r['bias']}): first-token logits "
                    f"rel err {err:.3e} > {tol} vs slice")
    require(errs, f"{label}: no dp > 1 member to compare")
    for be in outs:
        e = [x for x in errs if x["backend"] == be]
        log(f"[serve] {label} first-token logits, {be} vs slice ({len(e)} "
            f"dp>1 members): max rel err "
            f"{max(x['rel_err'] for x in e):.3e} (tol {tol}), argmax equal "
            f"{sum(x['argmax_equal'] for x in e)}/{len(e)}")
    return errs


def f32_backend_check(torch, rt, cfg, plan, prompt):
    """The same ensemble request at full width in float32 (TF32 off): the
    backends differ only in summation order, so the cuda and fused paths
    must agree with slice to F32_LOGIT_TOL."""
    import dataclasses
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = rt.models.materialize(0, rt.models.init_lm(cfg32),
                                   device="cuda")
    outs = {}
    for backend in ("slice", "cuda", "fused"):
        sched = rt.serve.Scheduler(cfg32, params, capacity=16, max_len=128,
                                   plan=plan.with_backend(backend),
                                   device="cuda")
        outs[backend] = rt.serve.Server(sched).run([rt.serve.Request(
            rid=1, prompt=prompt, max_new_tokens=2, ensemble=8, seed=7)])
    ref = outs.pop("slice")
    errs = compare_first_logits(outs, ref, F32_LOGIT_TOL, "f32")
    del params
    torch.cuda.empty_cache()
    return errs


def decode_step_table(torch, rt, cfg, params, plan):
    """One decode step per (backend, dp, width) at position 64: host-clock
    ms of the eager step (what the scheduler pays today) and device ms of
    the same step replayed from a CUDA graph (the step without host launch
    overhead), beside the FFN-weight-bytes bound (3·d·d_ff·2 B per layer,
    all layers, over the HBM rate, divided by dp)."""
    ffn_bytes = 3 * cfg.d_model * cfg.d_ff * 2 * cfg.n_layers
    rows = []
    for backend in ("cuda", "fused"):
        for dp in ((1, 2, 4, 8) if backend == "cuda" else (2, 4, 8)):
            pat = (plan.with_backend(backend).bind(dp, 0) if dp > 1
                   else rt.core.IDENTITY)
            for width in (1, 8):
                cache = rt.serve.init_cache(cfg, width, 128, device="cuda")
                cache["pos"] = torch.full((width,), 64, dtype=torch.int64,
                                          device="cuda")
                tok = torch.zeros((width, 1), dtype=torch.int64,
                                  device="cuda")

                def step(_i=0):
                    rt.serve.decode_step_ragged(cfg, params, cache, tok,
                                                pat=pat)

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
                bnd = ffn_bytes / dp / HBM_BYTES_PER_S * 1e3
                rows.append({"backend": backend, "dp": dp, "width": width,
                             "step_ms": host_ms, "graph_step_ms": dev_ms,
                             "ffn_bytes_bound_ms": bnd,
                             "kernels": profile_step(torch, step, host_ms)})
                log(f"[decode] {backend:5s} dp={dp} width={width}: eager "
                    f"{host_ms:.2f} ms/step, graph-replayed {dev_ms:.3f} "
                    f"ms/step, FFN-weight bound {bnd:.3f} ms")
                log_profile(rows[-1]["kernels"])
    return rows


# kernel names in the trace: the port's own (namespace rdp, csrc/), the
# library's matrix products (attention projections, dense FFN, unembedding;
# cuBLAS names them gemm/xmma/cutlass or nvjet), and copies (cache writes,
# casts, contiguous copies)
PORT_KERNEL = "rdp::"
LIBRARY_GEMM = ("gemm", "gemv", "cutlass", "xmma", "splitk", "nvjet")


def kernel_class(name: str) -> str:
    low = name.lower()
    if PORT_KERNEL in name:
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
    import repro_torch.models
    import repro_torch.serve
    import repro_torch.tree
    from repro_torch import kernels as K
    rt = repro_torch

    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")
    t = time.perf_counter()
    built = K.build_all(force=True)
    log(f"[build] {json.dumps({k: round(v, 2) for k, v in built.items()})} "
        f"in {time.perf_counter() - t:.2f} s")

    shapes = (1536, 8960, 70)       # qwen2-1.5b: d_model, d_ff, 8960/128
    worst, worst_rel, table = kernel_phase(torch, K, shapes)
    serve = serve_phase(torch, K, rt)

    main_shape = {"dp": 2, "M": 8}
    kernels_line = []
    for k in K.KERNELS:
        rec = next(r for r in table if r["name"] == k.name
                   and r["dp"] == main_shape["dp"]
                   and r["M"] == main_shape["M"])
        kernels_line.append({
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": serve["launches"][k.name],
            "max_abs_err": worst[k.name], "max_rel_err": worst_rel[k.name],
            "ms": rec["ms"],
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": f"times at M={main_shape['M']} dp={main_shape['dp']} "
                     f"bf16; errors over the bf16 sweep"})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({
        "device": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
        "build_s": built, "kernel_times": table, "serve": serve,
        "kernels": kernels_line,
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
