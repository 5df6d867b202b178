"""Refcounted page allocator with block tables, CoW forks and reservations.

A copy of the JAX package's framework-free ``repro.serve.kv.pages``.

Pure bookkeeping — no arrays.  ``PagePool`` owns every mutation so the
invariants live in one place:

* a physical page is either FREE (refcount 0, on the free list) or LIVE
  (refcount == number of block-table slots referencing it);
* ``fork`` increfs every page of a table (O(pages), no data movement);
* ``make_private`` is the copy-on-write step: a page referenced by more
  than one table is swapped for a fresh allocation before a write;
* ``try_reserve`` grants admission-time reservations: an owner that
  reserved N pages can always allocate them later, because unreserved
  allocations may never dip into the reserved balance.  This is what makes
  page-aware admission deadlock-free — an admitted request can always run
  to completion without further allocation failures.

Double free, use-after-free, foreign pages and refcount underflow all
raise ``PageError`` immediately instead of corrupting the pool.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Hashable, Optional


class PageError(RuntimeError):
    """Invariant violation: double free, use-after-free, pool exhaustion."""


@dataclasses.dataclass
class PageStats:
    allocated: int = 0      # successful page allocations
    freed: int = 0          # pages whose refcount reached zero
    failed: int = 0         # allocations that found no eligible free page
    forks: int = 0          # block-table forks (CoW shares created)
    cow_copies: int = 0     # pages privatized by copy-on-write
    high_water: int = 0     # max pages simultaneously live


class BlockTable:
    """Logical→physical page map of one sequence (mutated via the pool)."""

    __slots__ = ("pages", "live")

    def __init__(self, pages: list[int]):
        self.pages = pages
        self.live = True

    def __len__(self) -> int:
        return len(self.pages)

    def __repr__(self) -> str:
        return f"BlockTable({self.pages}{'' if self.live else ', dead'})"


class PagePool:
    """Fixed pool of refcounted pages; every mutation checks invariants."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._ref = [0] * num_pages
        # LIFO free list: the most recently freed page is reused first
        # (its backing buffers are the warmest), matching CachePool's policy
        self._free = list(range(num_pages - 1, -1, -1))
        self._reserved: dict[Hashable, int] = {}
        self.stats = PageStats()

    # ---- capacity ----------------------------------------------------------
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use_count(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def reserved_count(self) -> int:
        return sum(self._reserved.values())

    def available(self, owner: Hashable = None) -> int:
        """Pages an allocation by ``owner`` may draw on: the unreserved
        balance plus the owner's own outstanding reservation."""
        return (self.free_count - self.reserved_count
                + self._reserved.get(owner, 0))

    # ---- reservations (deadlock-free admission) ----------------------------
    def try_reserve(self, owner: Hashable, n: int) -> bool:
        """Reserve ``n`` pages for later allocation by ``owner``.

        Succeeds only against the unreserved free balance, so the sum of
        reservations never exceeds the free pages backing them."""
        if n < 0:
            raise ValueError(f"cannot reserve {n} pages")
        if self.free_count - self.reserved_count < n:
            return False
        self._reserved[owner] = self._reserved.get(owner, 0) + n
        return True

    def release(self, owner: Hashable) -> int:
        """Drop ``owner``'s remaining reservation; returns pages released."""
        return self._reserved.pop(owner, 0)

    # ---- page-level ops ----------------------------------------------------
    def alloc_page(self, owner: Hashable = None) -> Optional[int]:
        """Claim one page (refcount 1); ``None`` when none is eligible.

        Draws down ``owner``'s reservation when one exists; unreserved
        callers only see ``free_count - reserved_count`` pages."""
        reserved = self._reserved.get(owner, 0)
        if reserved > 0:
            self._reserved[owner] = reserved - 1
        elif self.free_count - self.reserved_count < 1:
            self.stats.failed += 1
            return None
        if not self._free:       # cannot happen if reservations are sound
            raise PageError("free list empty despite reservation balance")
        pid = self._free.pop()
        self._ref[pid] = 1
        self.stats.allocated += 1
        self.stats.high_water = max(self.stats.high_water, self.in_use_count)
        return pid

    def incref(self, pid: int) -> None:
        self._check_live(pid)
        self._ref[pid] += 1

    def decref(self, pid: int) -> bool:
        """Drop one reference; frees the page (returns True) at zero."""
        self._check_live(pid)
        self._ref[pid] -= 1
        if self._ref[pid] == 0:
            self._free.append(pid)
            self.stats.freed += 1
            return True
        return False

    def refcount(self, pid: int) -> int:
        self._check_bounds(pid)
        return self._ref[pid]

    def is_live(self, pid: int) -> bool:
        self._check_bounds(pid)
        return self._ref[pid] > 0

    # ---- block-table ops ---------------------------------------------------
    def alloc_table(self, n_pages: int,
                    owner: Hashable = None) -> Optional[BlockTable]:
        """Allocate an ``n_pages``-long table, all-or-nothing."""
        got: list[int] = []
        for _ in range(n_pages):
            pid = self.alloc_page(owner)
            if pid is None:
                for p in got:            # roll back, no partial tables
                    self.decref(p)
                return None
            got.append(pid)
        return BlockTable(got)

    def extend(self, bt: BlockTable, owner: Hashable = None) -> bool:
        """Append one fresh page to ``bt`` (decode growing past the table)."""
        self._check_table(bt)
        pid = self.alloc_page(owner)
        if pid is None:
            return False
        bt.pages.append(pid)
        return True

    def fork(self, bt: BlockTable) -> BlockTable:
        """Share every page of ``bt`` with a new table (refcount++ each).

        O(pages) bookkeeping, zero data movement — the copy-on-write half
        lives in ``make_private``."""
        self._check_table(bt)
        for pid in bt.pages:
            self.incref(pid)
        self.stats.forks += 1
        return BlockTable(list(bt.pages))

    def free_table(self, bt: BlockTable) -> list[int]:
        """Release every page of ``bt``; returns the physically freed ids."""
        self._check_table(bt)
        bt.live = False
        return [pid for pid in bt.pages if self.decref(pid)]

    def make_private(self, bt: BlockTable, idx: int,
                     owner: Hashable = None,
                     on_copy: Optional[Callable[[int, int], None]] = None
                     ) -> tuple[int, bool]:
        """Copy-on-write: ensure ``bt.pages[idx]`` is exclusively owned.

        Returns ``(pid, copied)``.  A page with refcount 1 is returned
        as-is; a shared page is swapped for a fresh allocation (the old
        reference dropped) and ``on_copy(old_pid, new_pid)`` lets the
        storage layer duplicate the contents."""
        self._check_table(bt)
        if not 0 <= idx < len(bt.pages):
            raise PageError(f"logical page {idx} outside table of "
                            f"{len(bt.pages)}")
        old = bt.pages[idx]
        self._check_live(old)
        if self._ref[old] == 1:
            return old, False
        new = self.alloc_page(owner)
        if new is None:
            raise PageError(
                "pool exhausted during copy-on-write — admission should "
                "have reserved this page (see Scheduler page accounting)")
        if on_copy is not None:
            on_copy(old, new)
        bt.pages[idx] = new
        self.decref(old)                 # shared, so never frees here
        self.stats.cow_copies += 1
        return new, True

    # ---- invariant checks --------------------------------------------------
    def assert_balanced(self, tables: list[BlockTable]) -> None:
        """Refcount conservation: every live page's refcount equals its
        occurrence count across ``tables``; everything else is free."""
        want = [0] * self.num_pages
        for bt in tables:
            if not bt.live:
                raise PageError(f"dead table in balance check: {bt}")
            for pid in bt.pages:
                want[pid] += 1
        if want != self._ref:
            diff = {i: (w, r) for i, (w, r) in enumerate(zip(want, self._ref))
                    if w != r}
            raise PageError(f"refcount imbalance (want, have): {diff}")
        if self.free_count + sum(1 for r in self._ref if r > 0) \
                != self.num_pages:
            raise PageError("free list / live set do not partition the pool")

    def _check_bounds(self, pid: int) -> None:
        if not 0 <= pid < self.num_pages:
            raise PageError(f"page {pid} outside pool of {self.num_pages}")

    def _check_live(self, pid: int) -> None:
        self._check_bounds(pid)
        if self._ref[pid] <= 0:
            raise PageError(f"page {pid} is not allocated "
                            f"(double free / use-after-free)")

    def _check_table(self, bt: BlockTable) -> None:
        if not bt.live:
            raise PageError(f"operation on a freed block table: {bt}")
