"""Bitmap Page Allocator — faithful implementation of Figure 4 (§3.3).

Framework-free: the port's own copy of ``repro/core/bitmap_alloc.py``, so
page ids and accounting are the reference's exactly.

Layout per the paper:
  * pages are grouped into blocks of 1024; the first page of each block is
    reserved as the **control page** (so 1023 allocatable pages per block);
  * the control page holds (a) the free-list ``next`` pointer, (b) an L2
    bitmap of 16 × 64-bit words (one bit per page, 1 = free) plus an L1
    64-bit word whose bit *i* says "L2 word *i* has a free page" — a free
    page is found with exactly two find-first-set operations, O(2);
  * a 16-bit reference count per page (process clone / COW analogue: here,
    KV prefix sharing across requests).

Because no metadata lives *inside* free pages (unlike a buddy allocator's
free-list pointers), an entirely-free block can be returned to the global
heap ("madvise") with zero fix-up — that is the paper's reclamation insight.

``block_id * PAGES_PER_BLOCK + offset`` is the global page id; the control
page of any page is found by masking the low 10 bits (the paper's
"clear the least 22 bits" for 4 MB-aligned blocks).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

PAGES_PER_BLOCK = 1024
USABLE_PER_BLOCK = PAGES_PER_BLOCK - 1        # page 0 is the control page
L2_WORDS = 16

_FULL = np.uint64(0xFFFFFFFFFFFFFFFF)


def _ffs(word: int) -> int:
    """Find-first-set (index of lowest 1 bit)."""
    return (word & -word).bit_length() - 1


@dataclass
class _Block:
    """One 4 MB block: control-page state (Fig. 4)."""

    block_id: int
    next: Optional[int] = None                       # free-list "Next" pointer
    l1: np.uint64 = _FULL                            # 1 = L2 word has free pages
    l2: np.ndarray = field(default_factory=lambda: np.full(L2_WORDS, _FULL,
                                                           np.uint64))
    refcount: np.ndarray = field(default_factory=lambda: np.zeros(
        PAGES_PER_BLOCK, np.uint16))
    free_count: int = USABLE_PER_BLOCK

    def __post_init__(self):
        # page 0 (control page) is never allocatable
        self.l2 = self.l2.copy()
        self.l2[0] &= ~np.uint64(1)

    def find_free(self) -> int:
        """O(2) lookup: first set bit of L1, then of that L2 word."""
        w = _ffs(int(self.l1))
        if w < 0:
            raise RuntimeError("find_free on full block")
        b = _ffs(int(self.l2[w]))
        return w * 64 + b

    def mark_allocated(self, off: int) -> None:
        w, b = divmod(off, 64)
        self.l2[w] &= ~(np.uint64(1) << np.uint64(b))
        if self.l2[w] == 0:
            self.l1 &= ~(np.uint64(1) << np.uint64(w))
        self.free_count -= 1
        self.refcount[off] = 1

    def mark_free(self, off: int) -> None:
        w, b = divmod(off, 64)
        self.l2[w] |= (np.uint64(1) << np.uint64(b))
        self.l1 |= (np.uint64(1) << np.uint64(w))
        self.free_count += 1
        self.refcount[off] = 0

    def is_free(self, off: int) -> bool:
        w, b = divmod(off, 64)
        return bool((int(self.l2[w]) >> b) & 1)


class BitmapPageAllocator:
    """Reclamation-oriented page allocator over a growable block set.

    ``grow`` is the "allocate a 4 MB block from the global heap" hook and
    ``release`` the "return block to global heap / madvise" hook; both get
    the block id.  ``max_blocks`` bounds the heap (allocation beyond raises
    ``MemoryError`` — the platform's memory-pressure signal).
    """

    def __init__(self, max_blocks: int = 1 << 20,
                 grow: Optional[Callable[[int], None]] = None,
                 release: Optional[Callable[[int], None]] = None):
        self.max_blocks = max_blocks
        self.blocks: Dict[int, _Block] = {}
        self.free_head: Optional[int] = None        # free-list head block id
        self._next_block_id = 0
        self._grow = grow
        self._release = release
        self.stats = {"allocs": 0, "frees": 0, "blocks_grown": 0,
                      "blocks_released": 0}

    # -- free-list maintenance (linear linked list, Fig. 4) ----------------
    def _push_free(self, blk: _Block) -> None:
        blk.next = self.free_head
        self.free_head = blk.block_id

    def _pop_free(self) -> Optional[_Block]:
        if self.free_head is None:
            return None
        blk = self.blocks[self.free_head]
        return blk

    def _unlink(self, blk: _Block) -> None:
        if self.free_head == blk.block_id:
            self.free_head = blk.next
            blk.next = None
            return
        cur = self.free_head
        while cur is not None:
            c = self.blocks[cur]
            if c.next == blk.block_id:
                c.next = blk.next
                blk.next = None
                return
            cur = c.next

    # -- public API ---------------------------------------------------------
    def alloc(self) -> int:
        """Allocate one page, returning its global page id."""
        blk = self._pop_free()
        if blk is None:
            if len(self.blocks) >= self.max_blocks:
                raise MemoryError("bitmap allocator: global heap exhausted")
            blk = _Block(self._next_block_id)
            self._next_block_id += 1
            self.blocks[blk.block_id] = blk
            self._push_free(blk)
            self.stats["blocks_grown"] += 1
            if self._grow:
                self._grow(blk.block_id)
        off = blk.find_free()
        blk.mark_allocated(off)
        if blk.free_count == 0:
            self._unlink(blk)
        self.stats["allocs"] += 1
        return blk.block_id * PAGES_PER_BLOCK + off

    def alloc_many(self, n: int) -> List[int]:
        return [self.alloc() for _ in range(n)]

    def _blk_off(self, page: int):
        # control-page lookup by masking low bits — no lookup table (§3.3)
        blk_id = page >> 10
        off = page & (PAGES_PER_BLOCK - 1)
        blk = self.blocks.get(blk_id)
        if blk is None or off == 0 or blk.is_free(off):
            raise ValueError(f"page {page} not allocated")
        return blk, off

    def incref(self, page: int) -> int:
        """Lockless atomic_fetch_add analogue (COW / clone sharing)."""
        blk, off = self._blk_off(page)
        if blk.refcount[off] == np.iinfo(np.uint16).max:
            raise OverflowError("refcount overflow")
        blk.refcount[off] += 1
        return int(blk.refcount[off])

    def decref(self, page: int) -> bool:
        """Decrement; frees the page at zero.  Returns True when freed."""
        blk, off = self._blk_off(page)
        blk.refcount[off] -= 1
        if blk.refcount[off] > 0:
            return False
        was_full = blk.free_count == 0
        blk.mark_free(off)
        self.stats["frees"] += 1
        if was_full:
            self._push_free(blk)
        if blk.free_count == USABLE_PER_BLOCK:
            self._reclaim_block(blk)
        return True

    free = decref

    def refcount(self, page: int) -> int:
        blk, off = self._blk_off(page)
        return int(blk.refcount[off])

    def _reclaim_block(self, blk: _Block) -> None:
        """Entirely-free block -> return to the global heap (madvise)."""
        self._unlink(blk)
        del self.blocks[blk.block_id]
        self.stats["blocks_released"] += 1
        if self._release:
            self._release(blk.block_id)

    # -- introspection --------------------------------------------------------
    @property
    def allocated_pages(self) -> int:
        return sum(USABLE_PER_BLOCK - b.free_count
                   for b in self.blocks.values())

    @property
    def committed_blocks(self) -> int:
        return len(self.blocks)

    def free_list_blocks(self) -> List[int]:
        out, cur, seen = [], self.free_head, set()
        while cur is not None:
            assert cur not in seen, "free-list cycle"
            seen.add(cur)
            out.append(cur)
            cur = self.blocks[cur].next
        return out

    def check_invariants(self) -> None:
        """Structural invariants (used by the hypothesis property tests)."""
        for bid, blk in self.blocks.items():
            n_free = sum(int(blk.l2[w]).bit_count() for w in range(L2_WORDS))
            assert n_free == blk.free_count, (bid, n_free, blk.free_count)
            for w in range(L2_WORDS):
                has_free = int(blk.l2[w]) != 0
                l1_bit = bool((int(blk.l1) >> w) & 1)
                assert l1_bit == has_free, (bid, w)
            assert not blk.is_free(0), "control page must stay reserved"
            for off in range(PAGES_PER_BLOCK):
                if blk.is_free(off):
                    assert blk.refcount[off] == 0, (bid, off)
            assert 0 < blk.free_count <= USABLE_PER_BLOCK or \
                bid not in self.free_list_blocks()
        in_list = self.free_list_blocks()
        assert len(in_list) == len(set(in_list))
        for bid in in_list:
            assert self.blocks[bid].free_count > 0
        for bid, blk in self.blocks.items():
            if blk.free_count > 0:
                assert bid in in_list, f"block {bid} has free pages, not listed"
