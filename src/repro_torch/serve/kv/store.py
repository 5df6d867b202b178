"""Paged KV storage: cache fragments per page, gather/write-back, CoW.

A *fragment* is the per-sequence cache tree restricted to one page of
sequence positions (``engine.init_cache(cfg, 1, page_size)`` layers).
Physical page *i* owns ``_frags[i]``; a sequence's logical cache is its
block table's fragments in order.

The JAX store leans on immutability twice: every free page aliases one zero
template, and a copy-on-write "copy" is an alias until the next functional
update builds a new buffer.  Here fragments are written in place, so the
store keeps two rules that make that safe:

* the template is never written: a page whose fragment is still the
  template gets its own clone before its first write;
* a copy-on-write copy is a clone, so siblings of a forked ensemble never
  share a buffer that one of them writes.

``materialize_layers`` always gathers into a new tensor, so the engine may
write the gathered cache in place without touching any page.
"""
from __future__ import annotations

from typing import Hashable, Optional

import torch

from ...tree import tree_map
from .pages import BlockTable, PageError, PagePool, PageStats


def _clone(layers):
    return tree_map(lambda a: a.clone(), layers)


class PagedKVStore:
    """Block-table-addressed KV fragments over a refcounted ``PagePool``."""

    def __init__(self, template_layers, *, page_size: int, num_pages: int,
                 max_len: int, seq_axis: int = 2):
        if max_len % page_size != 0:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"page_size {page_size}")
        self.pool = PagePool(num_pages, page_size)
        self.page_size = page_size
        self.max_len = max_len
        self.max_pages = max_len // page_size
        self.seq_axis = seq_axis
        self._template = template_layers
        self._frags = [template_layers] * num_pages   # never written

    @classmethod
    def for_model(cls, cfg, *, page_size: int, num_pages: int, max_len: int,
                  device=None) -> "PagedKVStore":
        """Build a store whose fragments match ``cfg``'s cache layout."""
        from .. import engine
        if not engine.supports_paged_kv(cfg):
            raise ValueError(f"{cfg.name}: arch does not support paged KV")
        template = engine.init_cache(cfg, 1, page_size,
                                     device=device)["layers"]
        return cls(template, page_size=page_size, num_pages=num_pages,
                   max_len=max_len)

    # ---- passthrough -------------------------------------------------------
    @property
    def stats(self) -> PageStats:
        return self.pool.stats

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` sequence positions."""
        if n_tokens <= 0:
            return 0
        return -(-n_tokens // self.page_size)

    # ---- lifecycle ---------------------------------------------------------
    def alloc(self, n_tokens: int,
              owner: Hashable = None) -> Optional[BlockTable]:
        """Table covering ``n_tokens`` positions; None when pool is full."""
        return self.pool.alloc_table(self.pages_for(n_tokens), owner)

    def fork(self, bt: BlockTable) -> BlockTable:
        """Share ``bt``'s pages with a new table (the CoW fork primitive)."""
        return self.pool.fork(bt)

    def free(self, bt: BlockTable) -> None:
        """Release a table; physically freed pages re-alias the template."""
        for pid in self.pool.free_table(bt):
            self._frags[pid] = self._template

    # ---- gather (paged read) / write-back ----------------------------------
    @torch.inference_mode()
    def materialize_layers(self, bt: BlockTable):
        """Gather ``bt``'s fragments into a new dense ``max_len`` layout."""
        from .. import engine
        frags = [self._frags[pid] for pid in bt.pages]
        frags += [self._template] * (self.max_pages - len(frags))
        return engine.page_join(frags, axis=self.seq_axis)

    def materialize(self, bt: BlockTable, pos: int) -> dict:
        """Full cache dict for the engine entry points."""
        return {"layers": self.materialize_layers(bt), "pos": int(pos)}

    @torch.inference_mode()
    def absorb(self, bt: BlockTable, layers, lo: int, hi: int,
               owner: Hashable = None) -> int:
        """Write positions ``[lo, hi)`` of a dense cache back into pages.

        Shared pages in the span are privatized copy-on-write (cloned);
        positions past the table's end extend it with fresh pages (drawing
        on ``owner``'s admission reservation).  Returns the number of pages
        newly allocated (CoW copies + extensions).
        """
        if hi <= lo:
            return 0
        if hi > self.max_len:
            raise PageError(f"absorb span [{lo}, {hi}) exceeds max_len "
                            f"{self.max_len}")
        from .. import engine
        ps = self.page_size
        new_pages = 0
        for p in range(lo // ps, -(-hi // ps)):
            if p > len(bt.pages):
                raise PageError(f"absorb would leave a hole: page {p} "
                                f"beyond table of {len(bt.pages)}")
            if p == len(bt.pages):
                if not self.pool.extend(bt, owner):
                    raise PageError(
                        "pool exhausted extending a block table — admission "
                        "should have reserved this page")
                new_pages += 1
            _, copied = self.pool.make_private(
                bt, p, owner=owner, on_copy=self._copy_frag)
            new_pages += copied
            pid = bt.pages[p]
            if self._frags[pid] is self._template:
                self._frags[pid] = _clone(self._template)
            span_lo, span_hi = max(lo, p * ps), min(hi, (p + 1) * ps)
            chunk = engine.page_slice(layers, span_lo, span_hi,
                                      axis=self.seq_axis)
            engine.page_update(self._frags[pid], chunk, span_lo - p * ps,
                               axis=self.seq_axis)
        return new_pages

    def _copy_frag(self, old: int, new: int) -> None:
        # the copy-on-write copy: the new page gets its own buffer
        self._frags[new] = _clone(self._frags[old])

    # ---- invariants --------------------------------------------------------
    def assert_balanced(self, tables: list[BlockTable]) -> None:
        self.pool.assert_balanced(tables)
