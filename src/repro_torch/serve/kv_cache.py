"""Paged KV cache: fixed-size pages, per-slot page tables, deterministic
allocation.

Port of ``repro.serve.kv_cache``. Logical page ``j`` of a slot holds
positions ``[j·ps, (j+1)·ps)``; the page table maps logical to physical pool
pages, so physical placement never reaches the math
(``kernels/decode.py``).

  * allocation hands out the **lowest-numbered** free pages (a heap), so
    placement is a pure function of the request stream;
  * one reserved **trash page** (physical id ``n_pages``) absorbs the K/V
    writes of pad tokens and idle decode slots; the allocator never hands it
    out, but unallocated table entries point at it, and its content is never
    read by a live lane (the attention's position mask).

Host state is numpy; the device pools (``transformer.init_paged_cache``,
from ``torch.zeros``) are updated in place by the serving step.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.models import transformer as T


class PoolExhausted(RuntimeError):
    """The page pool cannot cover an allocation; carries ``(slot,
    requested, free)``."""

    def __init__(self, slot: int, requested: int, free: int):
        self.slot, self.requested, self.free = slot, requested, free
        super().__init__(
            f"paged KV pool exhausted: slot {slot} wants {requested} pages, "
            f"free {free} (admission must reserve worst-case up front)")


@dataclasses.dataclass(frozen=True)
class PagedLayout:
    """Static pool geometry (fixed per engine: shapes never depend on load)."""
    page_size: int
    n_pages: int            # allocatable pages; pools carry n_pages+1 (trash)
    n_slots: int
    max_pages_per_slot: int

    @property
    def trash_page(self) -> int:
        return self.n_pages

    def pages_for(self, n_tokens: int) -> int:
        """Worst-case page count for ``n_tokens`` positions. It covers
        speculative decoding with no extra reservation: a round clamps each
        slot's draft to ``min(spec_k, max_new - produced - 1)``, so no draft
        or verify step writes past ``prompt_len + max_new - 2``, and a
        rejected draft's K/V is overwritten by the next round before any
        query reads it (:mod:`repro_torch.serve.spec`)."""
        return -(-n_tokens // self.page_size)

    def check_spec_write(self, prompt_len: int, max_new: int,
                         position: int) -> None:
        """A draft/verify K/V write must stay inside the slot's
        admission-time reservation."""
        if position > prompt_len + max_new - 2:
            raise ValueError(
                f"speculative write at position {position} exceeds the "
                f"reserved worst case {prompt_len + max_new - 2} "
                f"(prompt {prompt_len} + max_new {max_new}); the per-slot "
                "draft clamp is broken")


class PagedKVCache:
    """Device page pools + host page tables with a deterministic allocator."""

    def __init__(self, cfg, layout: PagedLayout, device):
        self.cfg, self.layout, self.device = cfg, layout, torch.device(device)
        self.pools = T.init_paged_cache(cfg, layout.n_pages + 1,
                                        layout.page_size, self.device)
        self._free = list(range(layout.n_pages))    # heap: lowest id first
        heapq.heapify(self._free)
        self.page_table = np.full((layout.n_slots, layout.max_pages_per_slot),
                                  layout.trash_page, np.int32)
        self.pages_held = np.zeros(layout.n_slots, np.int32)

    # ------------------------------------------------------------- allocator
    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, slot: int, n_pages: int) -> None:
        """Reserve ``n_pages`` lowest-id free pages for ``slot``."""
        held = int(self.pages_held[slot])
        if n_pages > self.free_pages:
            raise PoolExhausted(slot, n_pages, self.free_pages)
        if held + n_pages > self.layout.max_pages_per_slot:
            raise ValueError(
                f"slot {slot} cannot hold {held + n_pages} pages; "
                f"max_pages_per_slot={self.layout.max_pages_per_slot}")
        for j in range(held, held + n_pages):
            self.page_table[slot, j] = heapq.heappop(self._free)
        self.pages_held[slot] = held + n_pages

    def free_slot(self, slot: int) -> None:
        """Return a slot's pages to the pool; its entries revert to trash."""
        for j in range(int(self.pages_held[slot])):
            heapq.heappush(self._free, int(self.page_table[slot, j]))
        self.page_table[slot, :] = self.layout.trash_page
        self.pages_held[slot] = 0

    # ----------------------------------------------------- fault injection
    def quarantine(self, n_pages: int) -> List[int]:
        """Withdraw the ``n_pages`` lowest-id free pages from the pool (the
        fault-injection form of memory pressure): admission and ``alloc``
        see a smaller pool; no slot's pages move. Hand them back with
        :meth:`release_quarantine`."""
        if n_pages > self.free_pages:
            raise PoolExhausted(-1, n_pages, self.free_pages)
        return [heapq.heappop(self._free) for _ in range(n_pages)]

    def release_quarantine(self, pages: List[int]) -> None:
        """Return quarantined pages to the free pool."""
        for p in pages:
            heapq.heappush(self._free, int(p))

    def write_targets(self, slot: int, positions: np.ndarray,
                      valid: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Token-major (write_pages, write_offsets) for absolute
        ``positions``; invalid (pad) tokens go to the trash page. Pad
        positions may pass the slot's capacity, so the column is clamped."""
        ps = self.layout.page_size
        cols = np.minimum(positions // ps, self.layout.max_pages_per_slot - 1)
        pages = np.where(valid, self.page_table[slot, cols],
                         self.layout.trash_page).astype(np.int32)
        offsets = (positions % ps).astype(np.int32)
        return pages, offsets
