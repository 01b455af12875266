"""Paged KV cache over the shared device page pool (the paper's guest
memory).

The port's ``repro/serving/paged_kv.py`` for GQA caches.  Each pool page
holds ``page_tokens`` token rows of ``(2, Hkv, D)`` f32 (K then V) and
slack; pages are bitmap-allocated, and logical keys are stable across
hibernation cycles while physical ids are not:

  ``("kv", session_id, layer, page_idx)``  one pool page of KV tokens

Sessions model multi-turn invocations: a *closed* session's pages are
"freed by the guest but not yet returned to the host" until ``trim()``.
Not yet carried over: host cache units (SSM state, cross-attention), COW
forks and the prefix registry.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass
class KVSession:
    session_id: str
    num_tokens: int = 0
    #: pages[layer][i] = page id, or None while swapped out
    pages: List[List[Optional[int]]] = field(default_factory=list)
    closed: bool = False


class PagedKVCache:
    """Per-instance paged cache.  ``token_elems`` = 2*Hkv*D elements per
    token and layer."""

    def __init__(self, instance_id: str, cfg, pool):
        self.instance_id = instance_id
        self.cfg = cfg
        self.pool = pool
        self.token_elems = 2 * cfg.num_kv_heads * cfg.head_dim
        # tokens per pool page (pool page size is global, shared by tenants)
        self.page_tokens = max(1, pool.page_elems // self.token_elems)
        self.sessions: Dict[str, KVSession] = {}

    # ------------------------------------------------------------- sessions
    def new_session(self, session_id: str) -> KVSession:
        if session_id in self.sessions:
            raise KeyError(f"session {session_id} exists")
        s = KVSession(session_id,
                      pages=[[] for _ in range(self.cfg.num_layers)])
        self.sessions[session_id] = s
        return s

    def close_session(self, session_id: str) -> None:
        """Guest 'free': pages stay committed until trim() reclaims them."""
        self.sessions[session_id].closed = True

    # ------------------------------------------------------------- writes
    def reserve_tokens(self, session_id: str, layer: int, start_tok: int,
                       n_tokens: int) -> List[Tuple]:
        """Allocate the pages that tokens ``[start_tok, start_tok +
        n_tokens)`` of a layer land in, in the order the reference's
        ``write_tokens`` does (breaking COW-shared pages); returns the keys
        a write of those tokens touches."""
        s = self.sessions[session_id]
        touched = []
        t = 0
        while t < n_tokens:
            pidx, off = divmod(start_tok + t, self.page_tokens)
            while len(s.pages[layer]) <= pidx:
                s.pages[layer].append(self.pool.alloc(1, self.instance_id)[0])
            pid = s.pages[layer][pidx]
            if pid is None:                      # swapped-out page: fault first
                raise KeyError(("kv", session_id, layer, pidx))
            if self.pool.refcount(pid) > 1:
                s.pages[layer][pidx] = self.pool.break_cow(pid,
                                                           self.instance_id)
            touched.append(("kv", session_id, layer, pidx))
            t += min(self.page_tokens - off, n_tokens - t)
        return touched

    def token_offsets(self, session_id: str, layer: int, start_tok: int,
                      n_tokens: int) -> np.ndarray:
        """Flat pool offsets (int64) of token rows ``start_tok ...``."""
        pages = self.sessions[session_id].pages[layer]
        toks = np.arange(start_tok, start_tok + n_tokens, dtype=np.int64)
        pidx, off = np.divmod(toks, self.page_tokens)
        if not n_tokens:
            return toks
        first, last = int(pidx[0]), int(pidx[-1])
        for i in range(first, last + 1):
            if i >= len(pages) or pages[i] is None:
                raise KeyError(("kv", session_id, layer, i))
        phys = self.pool._phys(pages[first:last + 1])
        return (phys[pidx - first] * self.pool.page_elems
                + off * self.token_elems).astype(np.int64)

    def _rows(self, offsets: np.ndarray) -> torch.Tensor:
        dev = self.pool.device
        cols = torch.arange(self.token_elems, device=dev)
        return torch.from_numpy(offsets).to(dev)[:, None] + cols

    def write_tokens(self, session_id: str, layer: int, data: torch.Tensor,
                     start_tok: int) -> List[Tuple]:
        """Write ``data`` ((T, token_elems)) at token offset ``start_tok``
        for one layer, allocating pages as needed (one indexed store).
        Returns the touched keys."""
        T = data.shape[0]
        touched = self.reserve_tokens(session_id, layer, start_tok, T)
        if T:
            offs = self.token_offsets(session_id, layer, start_tok, T)
            self.pool.data.view(-1)[self._rows(offs)] = data.reshape(
                T, self.token_elems).to(self.pool.device, self.pool.dtype)
        return touched

    def read_tokens(self, session_id: str, layer: int, n_tokens: int
                    ) -> torch.Tensor:
        """The first ``n_tokens`` of a layer as a dense (n, token_elems)."""
        offs = self.token_offsets(session_id, layer, 0, n_tokens)
        return self.pool.data.view(-1)[self._rows(offs)]

    def page_table(self, session_ids: Sequence[str], layer: int
                   ) -> np.ndarray:
        """(B, pages_per_seq) int32 physical pool rows of each session's
        pages in one layer, padded with row 0 (a block's never-allocated
        control page)."""
        rows = []
        for sid in session_ids:
            pids = self.sessions[sid].pages[layer]
            if None in pids:
                raise KeyError(("kv", sid, layer, pids.index(None)))
            rows.append(self.pool._phys(pids))
        table = np.zeros((len(rows), max([len(r) for r in rows] + [1])),
                         np.int32)
        for b, r in enumerate(rows):
            table[b, :len(r)] = r
        return table

    def keys_for(self, session_id: str, window_tokens: Optional[int] = None
                 ) -> List[Tuple]:
        """Every page key a request on this session will touch (pages in
        the attention window) — the fault/record set."""
        s = self.sessions[session_id]
        first_tok = 0
        if window_tokens is not None:
            first_tok = max(0, s.num_tokens - window_tokens)
        p0 = first_tok // self.page_tokens
        return [("kv", session_id, layer, pidx)
                for layer in range(self.cfg.num_layers)
                for pidx in range(p0, len(s.pages[layer]))]

    def nonresident_keys(self, keys: Sequence[Tuple]) -> List[Tuple]:
        out = []
        for k in keys:
            s = self.sessions.get(k[1])
            if s is not None and k[0] == "kv" and s.pages[k[2]][k[3]] is None:
                out.append(k)
        return out

    # ------------------------------------------------------------- hibernate
    def trim(self) -> int:
        """Deflation step 2: return closed sessions' pages to the pool."""
        n = 0
        for sid in [s for s, v in self.sessions.items() if v.closed]:
            s = self.sessions.pop(sid)
            pages = [p for layer in s.pages for p in layer if p is not None]
            n += len(pages)
            self.pool.free(pages, self.instance_id)
        return n

    def export_items(self, working_set: frozenset
                     ) -> Tuple[List[Tuple[Tuple, torch.Tensor]],
                                List[Tuple[Tuple, torch.Tensor]]]:
        """Partition resident pages into (reap, swap) item lists of host
        rows: ONE gather launch of every resident page, the region past
        each page's written tokens zeroed (identical contents export
        identically, the reference's zero-tail contract), then ONE
        device-to-host copy."""
        keys, pids, used = [], [], []
        for sid, s in self.sessions.items():
            for layer in range(len(s.pages)):
                for pidx, pid in enumerate(s.pages[layer]):
                    if pid is None:
                        continue
                    keys.append(("kv", sid, layer, pidx))
                    pids.append(pid)
                    used.append(min(max(s.num_tokens - pidx * self.page_tokens,
                                        0), self.page_tokens)
                                * self.token_elems)
        if not keys:
            return [], []
        rows = self.pool.gather(pids)
        dev = self.pool.device
        cols = torch.arange(self.pool.page_elems, device=dev)
        rows.masked_fill_(cols[None] >= torch.tensor(used, device=dev)[:, None],
                          0)
        host = rows.cpu()
        reap, swap = [], []
        for key, row in zip(keys, host):
            (reap if key in working_set else swap).append((key, row))
        return reap, swap

    def drop_pages(self) -> int:
        """Deflation step 3 tail: free every physical page but keep the
        logical page tables — the 'Not-Present' page-table entries."""
        n = 0
        for s in self.sessions.values():
            for layer in range(len(s.pages)):
                for pidx, pid in enumerate(s.pages[layer]):
                    if pid is not None:
                        self.pool.free([pid], self.instance_id)
                        s.pages[layer][pidx] = None
                        n += 1
        return n

    def apply_prefetch(self, data: Dict[Hashable, torch.Tensor]) -> int:
        """Install the KV pages of a REAP batch read."""
        return self.install_batch(
            [(k, a) for k, a in data.items() if k[0] == "kv"])

    def install_batch(self, items: Sequence[Tuple[Tuple, torch.Tensor]]
                      ) -> int:
        """Install swapped-in pages with ONE host-to-device copy and ONE
        scatter launch, allocating physical pages for Not-Present slots.
        Keys of trimmed sessions and already-resident keys are skipped (a
        resident page may hold fresher tokens).  Returns bytes installed."""
        pages: List[int] = []
        rows: List[torch.Tensor] = []
        n = 0
        for key, arr in items:
            s = self.sessions.get(key[1])
            if s is None or key[0] != "kv":
                continue
            _, _sid, layer, pidx = key
            if layer >= len(s.pages) or pidx >= len(s.pages[layer]) \
                    or s.pages[layer][pidx] is not None:
                continue
            s.pages[layer][pidx] = self.pool.alloc(1, self.instance_id)[0]
            pages.append(s.pages[layer][pidx])
            rows.append(arr.reshape(-1))
            n += arr.nbytes
        if pages:
            self.pool.scatter(pages, torch.stack(rows))
        return n

    def fault_in(self, keys: Sequence[Tuple], swap_file, reap_file) -> int:
        """Fault path: one vectored batch read per file, then one
        install (one scatter) per file."""
        swap_keys, reap_keys = [], []
        for key in keys:
            if key in swap_file:
                swap_keys.append(key)
            elif key in reap_file.extents:
                reap_keys.append(key)
            else:
                raise KeyError(f"kv unit {key} not in any swap file")
        n = 0
        for f, ks in ((swap_file, swap_keys), (reap_file, reap_keys)):
            if ks:
                n += self.install_batch(list(f.read_units(ks).items()))
        return n
