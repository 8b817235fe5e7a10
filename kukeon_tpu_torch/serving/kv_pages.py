"""Block-table KV page allocator, the port of ``kukeon_tpu/serving/kv_pages.py``
(host-only; numpy, no torch).

The legacy layout reserves ``num_slots * max_seq_len`` KV rows up front,
so a slot serving a 40-token chat pins as much device memory as one
serving a 1k-token agent context. The paged layout owns the cache as
fixed-size pages instead, and this module keeps their books:

- **Pages**: the engine's device pool is ``[L, P + 1, page_tokens, KV,
  D]``; pages are allocated and freed one at a time as requests are
  admitted, grow and finish.
- **Page 0 is scratch**: never allocated. Block-table rows of released
  slots point at it (a stale decode write lands there, not in a page
  re-issued to another request), and insert scatters send shared-prefix
  and padding pages to it, so shared pages are never written.
- **Refcounts**: a page may be held by the slot that wrote it and by any
  number of prefix-cache entries and later sessions reading it. ``alloc``
  hands out pages at refcount 1, ``ref``/``unref`` move the count, and a
  page returns to the free list only at zero.
- **Exhaustion is an outcome**: ``alloc`` raises :class:`PagePoolExhausted`
  (the ``kv.alloc`` fault point injects it); the engine then evicts prefix
  entries, preempts a request, or sheds.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from collections.abc import Iterable

import numpy as np

from kukeon_tpu_torch import faults

# The reserved scratch page: where stale writes of released slots,
# shared-prefix redirects and bucket padding go.
SCRATCH_PAGE = 0


class PagePoolExhausted(RuntimeError):
    """Not enough free KV pages for an allocation. Recoverable: pages free
    as requests finish, prefix entries are evicted or a request is
    preempted; the engine decides which."""


def pages_for(n_tokens: int, page_tokens: int) -> int:
    """Pages needed to hold ``n_tokens`` KV rows (ceil)."""
    return -(-max(0, int(n_tokens)) // int(page_tokens))


class PageAllocator:
    """Free list and refcounts over ``num_pages`` usable pages, ids
    1..num_pages (0 is :data:`SCRATCH_PAGE`, never issued). The free list
    is FIFO, so a page just freed is re-issued as late as possible.
    The engine's driver thread only; no locking."""

    def __init__(self, num_pages: int, page_tokens: int) -> None:
        if num_pages < 1:
            raise ValueError(f"need at least 1 usable page, got {num_pages}")
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        self.num_pages = int(num_pages)
        self.page_tokens = int(page_tokens)
        self._free: deque[int] = deque(range(1, self.num_pages + 1))
        self._ref: dict[int, int] = {}

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def pages_for(self, n_tokens: int) -> int:
        return pages_for(n_tokens, self.page_tokens)

    def alloc(self, n: int) -> list[int]:
        """``n`` fresh pages at refcount 1, or :class:`PagePoolExhausted`.
        All or nothing: a partial grant would leave the caller holding pages
        it cannot use. The ``kv.alloc`` fault point injects exhaustion."""
        try:
            faults.maybe_fail("kv.alloc")
        except faults.FaultInjected as e:
            raise PagePoolExhausted(str(e)) from e
        if n <= 0:
            return []
        if n > len(self._free):
            raise PagePoolExhausted(
                f"need {n} KV pages, {len(self._free)}/{self.num_pages} free")
        out = [self._free.popleft() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        return out

    def ref(self, pages: Iterable[int]) -> None:
        """Add one reference to each page (a new reader of shared pages)."""
        for p in pages:
            if p == SCRATCH_PAGE:
                continue
            if p not in self._ref:
                raise ValueError(f"ref of unallocated page {p}")
            self._ref[p] += 1

    def unref(self, pages: Iterable[int]) -> int:
        """Drop one reference from each page; pages reaching zero return to
        the free list. Returns how many were freed."""
        freed = 0
        for p in pages:
            if p == SCRATCH_PAGE:
                continue
            c = self._ref.get(p)
            if c is None:
                raise ValueError(f"unref of unallocated page {p}")
            if c <= 1:
                del self._ref[p]
                self._free.append(p)
                freed += 1
            else:
                self._ref[p] = c - 1
        return freed


@dataclasses.dataclass
class SharedPrefix:
    """One prefix-cache entry of the paged layout: a view over pool pages,
    not a copy. ``pages`` hold one reference each (taken at store time);
    ``length`` is page-aligned: a prompt's trailing partial page stays
    private to the slot that wrote it, since decode writes the rows right
    after the prompt into it."""

    tokens: np.ndarray           # the aligned prefix the pages encode (int32)
    pages: list[int]             # pool page ids, in sequence order
    length: int                  # == len(pages) * page_tokens

    def nbytes(self, page_bytes: int) -> int:
        return len(self.pages) * page_bytes
