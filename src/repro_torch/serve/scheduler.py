"""Continuous-batching scheduler with pattern-bucketed MC-dropout ensembles.

Twin of ``repro.serve.scheduler`` in paged mode.  One ``step()``:

1. **admit** — pop queued requests (priority, then FCFS) once the paged KV
   pool can *reserve* their worst-case page need (deadlock-free admission);
2. **prefill** — advance ONE pending prefill by at most ``prefill_chunk``
   prompt tokens.  With ``shared_prefill`` (default) an ensemble request is
   prefilled once, densely, and its KV pages are forked copy-on-write to
   all E members; with ``shared_prefill=False`` every member prefills the
   prompt through its own (dp, b) sub-model;
3. **decode** — group running sequences by pattern bucket ``(dp, b)`` and
   run one ``engine.decode_step_ragged`` per bucket at a power-of-two batch
   width, absorbing each sequence's new KV back into its own pages.
   Finished sequences are evicted and their pages freed.

Member m of request r draws its pattern from the plan reseeded with the
request's seed at step m — the same draws as the JAX scheduler.  Members
with ``dp > 1`` run their FFNs through the plan's backend ("cuda" / "fused"
launch the compact kernels).  PyTorch runs eagerly, so the JAX package's
per-bucket compile cache becomes a first-use record per bucket key, which
the ``RecompileWatchdog`` counts as the JAX one counts compiles.

Everything is synchronous and deterministic: same (seed, arrival trace) →
same admission order → same buckets → same greedy token streams.  Steps run
under ``torch.inference_mode()``.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..core import plan as plan_mod
from ..core.plan import DropoutPlan
from ..device import resolve_device
from ..models.transformer import ModelConfig
from ..obs import Observability
from ..tree import tree_map
from . import engine
from .kv import BlockTable, PagedKVStore
from .metrics import Telemetry


@dataclasses.dataclass
class Request:
    """One user request; ``ensemble > 1`` asks for MC-dropout uncertainty."""

    rid: int
    prompt: np.ndarray              # [S] int32 token ids
    max_new_tokens: int = 16
    priority: int = 0               # lower value = more urgent
    ensemble: int = 1               # number of MC-dropout members
    seed: int = 0                   # pattern sampling seed for this request
    arrival_time: float = 0.0


@dataclasses.dataclass
class Sequence:
    """One in-flight decode stream: a request, or one ensemble member."""

    req: Request
    member: int
    dp: int = 1
    bias: int = 0
    state: str = "queued"           # queued | prefill | running | done
    bt: Optional[BlockTable] = None
    owner: object = None            # reservation key for page draws
    prefill_done: int = 0           # prompt tokens already processed
    out_tokens: list = dataclasses.field(default_factory=list)
    first_logits: Optional[np.ndarray] = None
    t_submit: float = 0.0
    t_admit: Optional[float] = None
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    t_done: Optional[float] = None

    @property
    def bucket(self) -> tuple:
        return (self.dp, self.bias)

    @property
    def prompt_len(self) -> int:
        return len(self.req.prompt)

    @property
    def pos(self) -> int:
        """Host-side cache position: the prompt plus every decoded token
        except the one about to be fed back (a forked member that has not
        produced its first token re-feeds the last prompt token at S-1)."""
        return self.prompt_len + len(self.out_tokens) - 1

    @property
    def feed_token(self) -> int:
        """Token to feed the next decode step."""
        return (self.out_tokens[-1] if self.out_tokens
                else int(self.req.prompt[-1]))

    @property
    def finished(self) -> bool:
        return len(self.out_tokens) >= self.req.max_new_tokens


@dataclasses.dataclass
class _Group:
    """One admitted shared-prefill request: E members, one prefill."""

    req: Request
    members: list
    page_need: int = 0
    bt: Optional[BlockTable] = None
    prefill_done: int = 0
    t_submit: float = 0.0


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _default_page_size(max_len: int, want: int = 16) -> int:
    """Largest divisor of ``max_len`` not exceeding ``want``."""
    for ps in range(min(want, max_len), 0, -1):
        if max_len % ps == 0:
            return ps
    return 1


class Scheduler:
    """FCFS + priority continuous-batching scheduler over a paged KV pool.

    ``device`` is where the KV pages and step inputs live (the GPU unless
    given); ``params`` must already be there.
    """

    def __init__(self, cfg: ModelConfig, params, *, capacity: int = 8,
                 max_len: int = 128, prefill_chunk: int = 16,
                 max_queue: int = 64,
                 plan: Optional[DropoutPlan] = None,
                 eos_token: Optional[int] = None,
                 telemetry: Optional[Telemetry] = None,
                 pad_buckets: bool = True,
                 obs: Optional[Observability] = None,
                 shared_prefill: bool = True,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 max_queued_pages: Optional[int] = None,
                 name: str = "replica0",
                 device=None):
        if not engine.supports_paged_kv(cfg):
            raise ValueError(f"{cfg.name}: arch does not support paged KV")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.name = name
        self._clock = None
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.max_queue = max_queue
        # the plan's nb is pinned to the model's pattern blocking
        self.plan = plan.with_nb(cfg.pattern_nb) if plan is not None else None
        self.eos_token = eos_token
        self.shared_prefill = shared_prefill

        self.page_size = page_size if page_size is not None \
            else _default_page_size(max_len)
        self.num_pages = num_pages if num_pages is not None \
            else capacity * (max_len // self.page_size)
        self.store = PagedKVStore.for_model(
            cfg, page_size=self.page_size, num_pages=self.num_pages,
            max_len=max_len, device=self.device)
        self.pool = self.store.pool
        self.max_queued_pages = max_queued_pages if max_queued_pages \
            is not None else 2 * self.num_pages
        self.capacity = capacity

        # watchdog membership is the bucket component of the first-use key;
        # shared prefill adds the dense bucket (1, 0) to the universe
        self.obs = obs if obs is not None \
            else Observability.create(plan=self.plan)
        self.obs.watchdog.project = lambda key: key[1]
        expected = set(self.possible_buckets())
        if shared_prefill:
            expected.add((1, 0))
        self.obs.watchdog.expect(expected)
        self.telemetry = telemetry if telemetry is not None \
            else Telemetry(registry=self.obs.registry)
        self.pad_buckets = pad_buckets
        self.chunked = engine.supports_chunked_prefill(cfg)

        self._queues: dict[int, collections.deque] = {}
        self._groups: list[_Group] = []         # admitted, still prefilling
        self._active: list[Sequence] = []       # admission order
        self.completed: dict[int, list[dict]] = {}
        self.last_buckets: dict[tuple, list[tuple]] = {}
        self._fns: dict = {}                    # first-use record per key
        self._reqs: dict[int, dict] = {}        # rid -> request-level state
        self._queued_pages = 0
        self._kv_synced = dataclasses.asdict(self.pool.stats)

    # ------------------------------------------------------------------
    # submission / admission control
    # ------------------------------------------------------------------

    @property
    def queued_count(self) -> int:
        n = 0
        for q in self._queues.values():
            for item in q:
                n += item.req.ensemble if isinstance(item, _Group) else 1
        return n

    @property
    def active_count(self) -> int:
        return len(self._active) + sum(len(g.members) for g in self._groups)

    @property
    def has_work(self) -> bool:
        return bool(self._active) or bool(self._groups) \
            or self.queued_count > 0

    def possible_buckets(self) -> list[tuple[int, int]]:
        """Every (dp, b) bucket this scheduler can produce."""
        return self.plan.buckets() if self.plan is not None else [(1, 0)]

    def _pattern_for(self, req: Request, member: int) -> tuple:
        """Deterministic (dp, bias) for one ensemble member: sample step
        ``member`` of the plan reseeded with the request's seed."""
        if self.plan is None or req.ensemble <= 1:
            return 1, 0
        bound = self.plan.reseed(req.seed).sample(member)
        return bound.dp, bound.bias

    def _request_page_need(self, req: Request) -> int:
        """Worst-case pages the request can allocate over its lifetime."""
        S, E = len(req.prompt), req.ensemble
        ps = self.page_size
        pf = self.store.pages_for
        hi = S + req.max_new_tokens - 1
        if not self.shared_prefill:
            return E * pf(hi)
        need = pf(S)
        for m in range(E):
            dp, _ = self._pattern_for(req, m)
            if E == 1:
                need += pf(hi) - pf(S)
            else:
                lo = S - 1 if dp > 1 else S
                if hi > lo:
                    need += -(-hi // ps) - lo // ps
        return need

    def _room_for(self, ensemble: int, need: int) -> bool:
        if self.queued_count + ensemble > self.max_queue:
            return False
        return self._queued_pages + need <= self.max_queued_pages

    def _find_victim(self, priority: int):
        """Newest fully-queued request of the lowest eligible priority."""
        for prio in sorted(self._queues, reverse=True):
            if prio <= priority:
                continue
            for item in reversed(self._queues[prio]):
                if not self._reqs.get(item.req.rid, {}).get("admitted",
                                                            False):
                    return prio, item
        return None

    def _shed(self, priority: int, ensemble: int, need: int) -> int:
        """Shed strictly-lower-priority queued requests (newest first)
        until the incoming request fits; returns requests shed."""
        shed = 0
        while not self._room_for(ensemble, need):
            found = self._find_victim(priority)
            if found is None:
                break
            prio, item = found
            q = self._queues[prio]
            rid = item.req.rid
            if isinstance(item, _Group):
                q.remove(item)
                self._queued_pages -= item.page_need
            else:
                each = self._reqs.get(rid, {}).get("need_each", 1)
                for s in [s for s in q if s.req.rid == rid]:
                    q.remove(s)
                    self._queued_pages -= each
            self._reqs.pop(rid, None)
            self.telemetry.requests_shed += 1
            shed += 1
        return shed

    def submit(self, req: Request, now: float = 0.0) -> bool:
        """Queue a request (all its ensemble members); False when admission
        control rejects it (infeasible, or the queue is saturated and no
        lower-priority work can be shed)."""
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(req.prompt) < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt+generation "
                f"({len(req.prompt)}+{req.max_new_tokens}) exceeds "
                f"max_len {self.max_len}")
        need = self._request_page_need(req)
        if need > self.num_pages:
            self.telemetry.requests_rejected += 1
            return False
        if not self._room_for(req.ensemble, need):
            self._shed(req.priority, req.ensemble, need)
        if not self._room_for(req.ensemble, need):
            self.telemetry.requests_rejected += 1
            return False

        q = self._queues.setdefault(req.priority, collections.deque())
        members = []
        for m in range(req.ensemble):
            dp, b = self._pattern_for(req, m)
            members.append(Sequence(req=req, member=m, dp=dp, bias=b,
                                    t_submit=now))
        self._reqs[req.rid] = {"t_submit": now, "ensemble": req.ensemble,
                               "first": False, "admitted": False}
        if self.shared_prefill:
            q.append(_Group(req=req, members=members, page_need=need,
                            t_submit=now))
            self._queued_pages += need
        else:
            each = need // max(req.ensemble, 1)
            self._reqs[req.rid]["need_each"] = each
            for s in members:
                s.owner = (req.rid, s.member)
                q.append(s)
                self._queued_pages += each
        return True

    # ------------------------------------------------------------------
    # one scheduler iteration
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def step(self, now: float = 0.0, clock=None) -> dict:
        """Admit → prefill one chunk → decode all buckets → evict.

        ``clock`` (optional) is re-sampled after each piece of compute so
        wall-clock TTFT/TPOT include the work that produced the token."""
        self._clock = clock
        admitted = self._admit(now)
        prefill_tokens = self._prefill(now)
        decoded = self._decode(now)
        evicted = self._evict(now)
        self._sync_kv_stats()
        return {"admitted": admitted, "prefill_tokens": prefill_tokens,
                "decoded": decoded, "evicted": evicted,
                "active": self.active_count, "queued": self.queued_count}

    def _now(self, fallback: float) -> float:
        return self._clock.now() if self._clock is not None else fallback

    def _meta(self, rid: int) -> dict:
        return self._reqs.setdefault(
            rid, {"t_submit": 0.0, "first": True, "admitted": True})

    def _sync_kv_stats(self) -> None:
        """Mirror page-pool stats into telemetry (delta-based)."""
        tel, stats = self.telemetry, dataclasses.asdict(self.pool.stats)
        last = self._kv_synced
        tel.cow_forks += stats["forks"] - last["forks"]
        tel.cow_copies += stats["cow_copies"] - last["cow_copies"]
        tel.kv_pages_allocated += stats["allocated"] - last["allocated"]
        tel.kv_pages_freed += stats["freed"] - last["freed"]
        self._kv_synced = stats
        tel.set_page_gauges(self.name, self.pool.in_use_count,
                            self.pool.free_count, self.num_pages,
                            self.page_size)

    # ------------------------------------------------------------------
    def _admit(self, now: float) -> int:
        """Admit queued work in (priority, FCFS) order while the pool can
        reserve its worst-case page need; stop at the first failure."""
        admitted = 0
        for prio in sorted(self._queues):
            q = self._queues[prio]
            while q:
                item = q[0]
                if isinstance(item, _Group):
                    if not self._admit_group(item, now):
                        return admitted
                    q.popleft()
                    admitted += len(item.members)
                else:
                    if not self._admit_member(item, now):
                        return admitted
                    q.popleft()
                    admitted += 1
        return admitted

    def _admit_group(self, g: _Group, now: float) -> bool:
        rid = g.req.rid
        if not self.pool.try_reserve(rid, g.page_need):
            return False
        g.bt = self.pool.alloc_table(0, owner=rid)
        self._queued_pages -= g.page_need
        t = self.telemetry
        t.queue_delay.record(now - g.t_submit)
        for s in g.members:
            s.owner = rid
            s.state = "prefill"
            s.t_admit = now
            t.queue_delay_member.record(now - s.t_submit)
        self._meta(rid)["admitted"] = True
        self._groups.append(g)
        return True

    def _admit_member(self, seq: Sequence, now: float) -> bool:
        """Per-member admission (shared_prefill=False)."""
        rid = seq.req.rid
        need = self._meta(rid).get("need_each", 1)
        if not self.pool.try_reserve(seq.owner, need):
            return False
        seq.bt = self.pool.alloc_table(0, owner=seq.owner)
        self._queued_pages -= need
        seq.state = "prefill"
        seq.t_admit = now
        t = self.telemetry
        t.queue_delay_member.record(now - seq.t_submit)
        meta = self._meta(rid)
        if not meta.get("admitted", True):
            meta["admitted"] = True
            t.queue_delay.record(now - meta["t_submit"])
        self._active.append(seq)
        return True

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------

    def _prefill(self, now: float) -> int:
        """Advance the oldest pending prefill by one chunk."""
        if self._groups:
            return self._prefill_group(self._groups[0], now)
        seq = next((s for s in self._active if s.state == "prefill"), None)
        if seq is None:
            return 0
        return self._prefill_member(seq, now)

    def _tokens(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    def _prefill_chunk(self, bucket, bt, prompt, done: int):
        """Run one prefill chunk of ``prompt`` from ``done`` through
        ``bucket``'s sub-model; returns (logits, new layers, lo, take)."""
        S = len(prompt)
        if self.chunked:
            take = min(self.prefill_chunk, S - done)
            cache = self.store.materialize(bt, done)
            logits, new = self._prefill_extend_fn(bucket, take)(
                self.params, cache, self._tokens(prompt[done:done + take])
                [None])
            return logits, new["layers"], done, take
        logits, new = self._prefill_full_fn(bucket, S)(
            self.params, self._tokens(prompt)[None])
        return logits, new["layers"], 0, S - done

    def _prefill_group(self, g: _Group, now: float) -> int:
        """One dense (IDENTITY-pattern) prefill chunk for a whole ensemble."""
        E = len(g.members)
        logits, layers, lo, take = self._prefill_chunk(
            (1, 0), g.bt, g.req.prompt, g.prefill_done)
        self.store.absorb(g.bt, layers, lo, g.prefill_done + take,
                          owner=g.req.rid)
        g.prefill_done += take
        self.telemetry.prefill_chunks += 1
        self.telemetry.prompt_tokens += take
        self.telemetry.prompt_tokens_members += take * E
        if g.prefill_done >= len(g.req.prompt):
            self._finish_group_prefill(g, logits, now)
        return take

    def _finish_group_prefill(self, g: _Group, logits, now: float) -> None:
        """Fork the prefilled KV to every member (CoW) and start decoding.
        Dense members take the prefill's last-token logits as their first
        token; patterned members re-feed the last prompt token through
        their own bucket at position S-1."""
        first_logits = logits[0].float().cpu().numpy()
        t = self._now(now)
        tel = self.telemetry
        for s in g.members:
            s.bt = self.store.fork(g.bt)
        self.store.free(g.bt)       # members' refs keep the pages live
        g.bt = None
        meta = self._meta(g.req.rid)
        for s in g.members:
            s.prefill_done = g.prefill_done
            s.state = "running"
            if s.dp <= 1:
                tok = self._next_token(s, first_logits)
                s.first_logits = first_logits
                s.out_tokens.append(tok)
                s.t_first = s.t_last = t
                tel.ttft_member.record(t - s.t_submit)
                if not meta["first"]:
                    meta["first"] = True
                    tel.ttft.record(t - meta["t_submit"])
                tel.record_decode_tokens(1, 0, 1)
            self._active.append(s)
        self._groups.remove(g)

    def _prefill_member(self, seq: Sequence, now: float) -> int:
        """Per-member prefill: the member computes the whole prompt with its
        own pattern (prefill cost scales with E)."""
        logits, layers, lo, take = self._prefill_chunk(
            seq.bucket, seq.bt, seq.req.prompt, seq.prefill_done)
        self.store.absorb(seq.bt, layers, lo, seq.prefill_done + take,
                          owner=seq.owner)
        seq.prefill_done += take
        self.telemetry.prefill_chunks += 1
        self.telemetry.prompt_tokens += take
        self.telemetry.prompt_tokens_members += take
        if seq.prefill_done >= seq.prompt_len:
            seq.first_logits = logits[0].float().cpu().numpy()
            tok = self._next_token(seq, seq.first_logits)
            t = self._now(now)
            seq.out_tokens.append(tok)
            seq.state = "running"
            seq.t_first = seq.t_last = t
            self.telemetry.ttft_member.record(t - seq.t_submit)
            meta = self._meta(seq.req.rid)
            if not meta["first"]:
                meta["first"] = True
                self.telemetry.ttft.record(t - meta["t_submit"])
            self.telemetry.record_decode_tokens(seq.dp, seq.bias, 1)
        return take

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def _decode(self, now: float) -> int:
        running = [s for s in self._active
                   if s.state == "running" and not s.finished]
        if not running:
            self.last_buckets = {}
            return 0
        buckets: dict[tuple, list[Sequence]] = {}
        for s in running:
            buckets.setdefault(s.bucket, []).append(s)
        self.last_buckets = {k: [(s.req.rid, s.member) for s in v]
                             for k, v in sorted(buckets.items())}

        decoded = 0
        for key in sorted(buckets):
            seqs = buckets[key]
            n = len(seqs)
            width = _next_pow2(n) if self.pad_buckets else n
            per_seq = [self.store.materialize_layers(s.bt) for s in seqs]
            per_seq += [per_seq[0]] * (width - n)   # pad slots are discarded
            layers = tree_map(lambda *a: torch.cat(a, dim=1), *per_seq)
            pos = [s.pos for s in seqs] + [seqs[0].pos] * (width - n)
            tokens = self._tokens([[s.feed_token] for s in seqs]
                                  + [[0]] * (width - n))
            logits, new = self._decode_fn(key)(
                self.params, {"layers": layers, "pos": pos}, tokens)
            logits = logits.float().cpu().numpy()   # waits for the device
            t = self._now(now)
            for i, s in enumerate(seqs):
                write_pos = s.pos
                sl = tree_map(lambda a, _i=i: a[:, _i:_i + 1],
                              new["layers"])
                self.store.absorb(s.bt, sl, write_pos, write_pos + 1,
                                  owner=s.owner)
                first = not s.out_tokens
                s.out_tokens.append(self._next_token(s, logits[i]))
                if first:
                    s.first_logits = logits[i]
                    s.t_first = t
                    self.telemetry.ttft_member.record(t - s.t_submit)
                    meta = self._meta(s.req.rid)
                    if not meta["first"]:
                        meta["first"] = True
                        self.telemetry.ttft.record(t - meta["t_submit"])
                else:
                    self.telemetry.tpot.record(t - s.t_last)
                s.t_last = t
            self.telemetry.record_decode_tokens(key[0], key[1], n)
            decoded += n
        self.telemetry.decode_steps += 1
        return decoded

    # ------------------------------------------------------------------
    def _evict(self, now: float) -> int:
        evicted = 0
        still_active = []
        for s in self._active:
            done = s.state == "running" and (
                s.finished or (self.eos_token is not None
                               and s.out_tokens
                               and s.out_tokens[-1] == self.eos_token))
            if not done:
                still_active.append(s)
                continue
            s.state = "done"
            s.t_done = now
            self.store.free(s.bt)
            s.bt = None
            self.telemetry.members_completed += 1
            members = self.completed.setdefault(s.req.rid, [])
            members.append({
                "member": s.member, "dp": s.dp, "bias": s.bias,
                "tokens": list(s.out_tokens),
                "first_logits": s.first_logits,
                "ffn_flop_fraction": 1.0 / s.dp,
                "ttft": (s.t_first - s.t_submit
                         if s.t_first is not None else None),
            })
            if not self.shared_prefill:
                self.pool.release(s.owner)
            if len(members) == s.req.ensemble:
                self.telemetry.requests_completed += 1
                if self.shared_prefill:
                    self.pool.release(s.req.rid)
                self._reqs.pop(s.req.rid, None)
            evicted += 1
        self._active = still_active
        return evicted

    # ------------------------------------------------------------------
    # warmup & telemetry lifecycle
    # ------------------------------------------------------------------

    @torch.inference_mode()
    def warmup(self, decode_widths: tuple = (1, 2, 4, 8),
               chunk_lens: Optional[tuple] = None) -> int:
        """Run every bucket's decode at each width in ``decode_widths`` and
        the prefill chunks once on dummy inputs, before taking load (first
        use builds the CUDA kernels and warms PyTorch's allocator).  Touches
        only the first-use record.  Returns the functions run."""
        if not self.chunked:
            chunk_lens = ()
        elif chunk_lens is None:
            chunk_lens = (self.prefill_chunk,)
        buckets = self.possible_buckets()
        prefill_buckets = [(1, 0)] if self.shared_prefill else buckets
        ran = 0
        for b in prefill_buckets:
            for n in sorted(set(int(x) for x in chunk_lens)):
                cache = engine.init_cache(self.cfg, 1, self.max_len,
                                          device=self.device)
                self._prefill_extend_fn(b, n)(
                    self.params, cache,
                    torch.zeros((1, n), dtype=torch.int64,
                                device=self.device))
                ran += 1
        for b in buckets:
            fn = self._decode_fn(b)
            for w in sorted(set(int(x) for x in decode_widths)):
                cache = engine.init_cache(self.cfg, w, self.max_len,
                                          device=self.device)
                cache["pos"] = [1] * w
                fn(self.params, cache,
                   torch.zeros((w, 1), dtype=torch.int64,
                               device=self.device))
                ran += 1
        return ran

    def reset_telemetry(self, telemetry: Optional[Telemetry] = None
                        ) -> Telemetry:
        """Swap in fresh telemetry (typically after ``warmup``)."""
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._kv_synced = dataclasses.asdict(self.pool.stats)
        self._sync_kv_stats()
        return self.telemetry

    # ------------------------------------------------------------------
    # sampling & per-bucket function records
    # ------------------------------------------------------------------

    def _next_token(self, seq: Sequence, logits: np.ndarray) -> int:
        """Greedy decode — deterministic, so (seed, trace) replays match."""
        return int(np.argmax(logits, -1))

    def _bucket_pat(self, bucket: tuple) -> plan_mod.BoundPlan:
        dp, b = bucket
        if dp <= 1 or self.plan is None:
            return plan_mod.IDENTITY
        return self.plan.bind(dp, b)

    def _lookup(self, key: tuple) -> bool:
        """First-use probe with per-replica hit/miss accounting."""
        hit = key in self._fns
        self.telemetry.record_compile_lookup(self.name, hit)
        if not hit:
            self.obs.watchdog.record_compile(key)
        return hit

    def _decode_fn(self, bucket: tuple):
        key = ("decode", bucket)
        if not self._lookup(key):
            self._fns[key] = functools.partial(
                engine.decode_step_ragged, self.cfg,
                pat=self._bucket_pat(bucket))
        return self._fns[key]

    def _prefill_extend_fn(self, bucket: tuple, chunk_len: int):
        key = ("prefill_extend", bucket, chunk_len)
        if not self._lookup(key):
            self._fns[key] = functools.partial(
                engine.prefill_extend, self.cfg,
                pat=self._bucket_pat(bucket))
        return self._fns[key]

    def _prefill_full_fn(self, bucket: tuple, prompt_len: int):
        key = ("prefill_full", bucket, prompt_len)
        if not self._lookup(key):
            self._fns[key] = functools.partial(
                engine.prefill, self.cfg, max_len=self.max_len,
                pat=self._bucket_pat(bucket))
        return self._fns[key]
