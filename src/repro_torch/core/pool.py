"""Shared device page pool — one preallocated tensor of fixed-size pages.

The port's ``repro/core/pool.py``: the same Bitmap Page Allocator, block
<-> physical slot mapping and PSS accounting, but ``data`` is ONE
``(capacity_pages, page_elems)`` tensor on the device, allocated once
(zero-filled, as the reference's host array is) and never resized.
``gather``/``scatter``/``break_cow`` run on the ``page_copy`` kernels.
"""
from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Sequence, Set

import numpy as np
import torch

from repro_torch.core.bitmap_alloc import PAGES_PER_BLOCK, BitmapPageAllocator
from repro_torch.device import resolve_device
from repro_torch.kernels import page_copy


class PagePool:
    def __init__(self, page_elems: int, dtype=torch.float32,
                 capacity_pages: int = 1 << 16, device="cuda"):
        self.device = resolve_device(device)
        self.page_elems = page_elems
        self.dtype = dtype
        self.capacity_blocks = max(1, capacity_pages // PAGES_PER_BLOCK)
        self.data = torch.zeros((self.capacity_blocks * PAGES_PER_BLOCK,
                                 page_elems), dtype=dtype, device=self.device)
        self._free_slots: List[int] = list(range(self.capacity_blocks))[::-1]
        self._slot_of_block: Dict[int, int] = {}
        self.allocator = BitmapPageAllocator(
            max_blocks=self.capacity_blocks,
            grow=self._on_grow, release=self._on_release)
        self._owner_pages: Dict[str, Set[int]] = {}
        self._lock = threading.RLock()
        self.scatter_calls = 0

    # -- block <-> physical slot mapping ------------------------------------
    def _on_grow(self, block_id: int) -> None:
        if not self._free_slots:
            raise MemoryError("page pool: out of physical blocks")
        self._slot_of_block[block_id] = self._free_slots.pop()

    def _on_release(self, block_id: int) -> None:
        self._free_slots.append(self._slot_of_block.pop(block_id))

    def _phys(self, pages: Sequence[int]) -> np.ndarray:
        return np.array(
            [self._slot_of_block[p >> 10] * PAGES_PER_BLOCK +
             (p & (PAGES_PER_BLOCK - 1)) for p in pages], np.int64)

    def _index(self, pages: Sequence[int]) -> torch.Tensor:
        """Physical rows of ``pages`` as an int64 index on the device."""
        with self._lock:
            phys = self._phys(pages)
        return torch.from_numpy(phys).to(self.device)

    # -- allocation -----------------------------------------------------------
    def alloc(self, n: int, owner: str) -> List[int]:
        with self._lock:
            ids = self.allocator.alloc_many(n)
            self._owner_pages.setdefault(owner, set()).update(ids)
            return ids

    def share(self, pages: Iterable[int], new_owner: str) -> None:
        """COW-share existing pages with another owner."""
        pages = list(pages)
        with self._lock:
            for p in pages:
                self.allocator.incref(p)
            self._owner_pages.setdefault(new_owner, set()).update(pages)

    def refcount(self, page: int) -> int:
        with self._lock:
            return self.allocator.refcount(page)

    def break_cow(self, page: int, owner: str) -> int:
        """Copy-on-write break: a private copy of ``page`` for ``owner``
        (one gather + one scatter launch); returns the new page id."""
        with self._lock:
            new = self.alloc(1, owner)[0]
            page_copy.scatter_pages(self.data, self._index([new]),
                                    page_copy.gather_pages(
                                        self.data, self._index([page])))
            self.free([page], owner)
            return new

    def free(self, pages: Iterable[int], owner: str) -> int:
        """Decref pages for this owner; returns how many were truly freed."""
        freed = 0
        with self._lock:
            own = self._owner_pages.get(owner, set())
            for p in list(pages):
                own.discard(p)
                if self.allocator.decref(p):
                    freed += 1
        return freed

    def free_owner(self, owner: str) -> int:
        with self._lock:
            pages = list(self._owner_pages.get(owner, ()))
            n = self.free(pages, owner)
            self._owner_pages.pop(owner, None)
            return n

    # -- data movement ----------------------------------------------------------
    def gather(self, pages: Sequence[int]) -> torch.Tensor:
        """``(len(pages), page_elems)`` copy of the pages, one launch."""
        return page_copy.gather_pages(self.data, self._index(pages))

    def scatter(self, pages: Sequence[int], rows: torch.Tensor) -> None:
        """Install a contiguous batch of pages in ONE launch (the wake and
        fault path); ``rows`` may be on the host (one H2D copy)."""
        rows = rows.to(device=self.device, dtype=self.dtype).reshape(
            len(pages), self.page_elems).contiguous()
        page_copy.scatter_pages(self.data, self._index(pages), rows)
        self.scatter_calls += 1

    # -- accounting (PSS analogue) ------------------------------------------------
    @property
    def page_bytes(self) -> int:
        return self.page_elems * self.data.element_size()

    def rss_bytes(self, owner: str) -> int:
        return len(self._owner_pages.get(owner, ())) * self.page_bytes

    def pss_bytes(self, owner: str) -> float:
        tot = 0.0
        for p in self._owner_pages.get(owner, ()):
            tot += self.page_bytes / self.allocator.refcount(p)
        return tot

    @property
    def committed_bytes(self) -> int:
        return self.allocator.committed_blocks * PAGES_PER_BLOCK * \
            self.page_bytes

    @property
    def used_bytes(self) -> int:
        return self.allocator.allocated_pages * self.page_bytes
