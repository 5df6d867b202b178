"""Serving: engine (prefill/decode + caches), the paged KV cache with
copy-on-write forks (``kv``), and the continuous-batching runtime
(scheduler, telemetry, server driver)."""
from . import kv
from .engine import (decode_groups, decode_step, decode_step_ragged,
                     init_cache, prefill, prefill_extend,
                     supports_chunked_prefill, supports_paged_kv)
from .kv import BlockTable, PagedKVStore, PageError, PagePool
from .metrics import Histogram, Telemetry
from .scheduler import Request, Scheduler, Sequence
from .server import (Server, StepCostModel, VirtualClock, WallClock,
                     aggregate_ensemble, poisson_trace)

__all__ = [
    "decode_step", "decode_step_ragged", "prefill", "prefill_extend",
    "init_cache", "decode_groups", "supports_chunked_prefill",
    "supports_paged_kv", "kv", "BlockTable", "PagedKVStore", "PageError",
    "PagePool", "Histogram", "Telemetry", "Request", "Scheduler",
    "Sequence", "Server", "StepCostModel", "VirtualClock", "WallClock",
    "aggregate_ensemble", "poisson_trace",
]
