"""Paged KV cache: block-table allocator (``pages``, a copy of the JAX
package's) + copy-on-write fragment store over torch tensors (``store``)."""
from .pages import BlockTable, PageError, PagePool, PageStats
from .store import PagedKVStore

__all__ = ["BlockTable", "PageError", "PagePool", "PageStats",
           "PagedKVStore"]
