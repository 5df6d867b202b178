"""PyTorch + CUDA port of the Approximate Random Dropout system.

The JAX package ``repro`` is the reference; this package mirrors its module
names (``core``, ``kernels``, ``models``, ``configs``, ``serve``, ``obs``)
so each counterpart is easy to find.  It imports ``torch`` and numpy only —
never ``jax`` and nothing of ``repro``.

What is ported (the MC-dropout serving path of the dense decoder family):

* ``core``    — pattern algebra, Alg. 1 search, the DropoutPlan registries;
* ``kernels`` — hand-written CUDA kernels for the compact RDP forward
  (``csrc/*.cu``), each beside its plain PyTorch version and a launch count;
* ``models``  — the dense transformer layers and ``materialize`` init;
* ``serve``   — engine, paged KV store with copy-on-write, scheduler, server;
* ``obs``     — metrics registry, span tracer, recompile watchdog, drift;
* ``bridge``  — the JAX parameter tree (as numpy) → this package's params.

Entry points that create tensors (``init_lm``/``materialize``,
``serve.engine.init_cache``, ``serve.Scheduler``, ``bridge.params_from_jax``)
run on the GPU unless the caller passes ``device="cpu"``; on a machine
without a GPU they raise instead of silently falling back.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
