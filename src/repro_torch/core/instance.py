"""ModelInstance: one tenant's model — the "container".

The port's ``repro/core/instance.py``.  It holds the weight leaves as
device tensors (keyed by the reference's path strings), the paged KV
cache, the swap and REAP files and the REAP recorder.

Weight *resource units* are the reference's, with the same keys and
byte counts: an ordinary leaf is one unit; the embedding table is split
into row blocks of ``embed_block`` rows (it stays one tensor).  Dropping
a unit really frees device memory: a leaf's tensor is released, and the
embedding tensor is released once none of its blocks is resident
(re-allocated when the first block comes back).  Compute reads weights
only through :meth:`ModelInstance.params`, which raises while any unit is
not resident, so it never reaches a dropped unit.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

from repro_torch.core.reap import ReapRecorder
from repro_torch.core.state import ContainerState, StateMachine
from repro_torch.core.swap import ReapFile, SwapFile

EMBED_BLOCK = 4096          # embedding rows per swappable unit


@dataclass
class WeightUnit:
    key: Tuple                       # ("w", path, sub)
    path: str
    sub: int                         # -1 whole leaf; else embed block index
    nbytes: int


class ModelInstance:
    def __init__(self, instance_id: str, cfg, params: Dict[str, torch.Tensor],
                 *, pool, spool_dir: str):
        self.instance_id = instance_id
        self.cfg = cfg
        self.pool = pool
        self.sm = StateMachine()
        self.recorder = ReapRecorder()
        self.kv = None                                  # PagedKVCache, set by engine

        #: device weight leaves keyed by path; None while swapped out
        self.weights: Dict[str, Optional[torch.Tensor]] = dict(params)
        self._meta = {p: (tuple(t.shape), t.dtype, t.device)
                      for p, t in params.items()}

        vocab_rows = params["embed"].shape[0] if "embed" in params \
            else EMBED_BLOCK
        self.embed_block = min(EMBED_BLOCK, max(64, vocab_rows // 4))

        self.units: Dict[Tuple, WeightUnit] = {}
        self._units_of: Dict[str, List[Tuple]] = {}
        self._build_catalog()
        self.resident: Set[Tuple] = set(self.units)   # all resident at start

        self.swap_file = SwapFile(f"{spool_dir}/{instance_id}.swap")
        self.reap_file = ReapFile(f"{spool_dir}/{instance_id}.reap")
        #: True once the current hibernation cycle's upfront inflate ran
        #: (cleared by deflate; the manager's wake-storm guard keys off it)
        self.inflated = True
        #: serializes unit installation between the fault path and wakes
        self.install_lock = threading.RLock()

    # ------------------------------------------------------------------ catalog
    def _build_catalog(self) -> None:
        for path, arr in self.weights.items():
            nbytes = arr.numel() * arr.element_size()
            if path == "embed" and arr.shape[0] > self.embed_block:
                nblk = -(-arr.shape[0] // self.embed_block)
                per = nbytes // arr.shape[0] * self.embed_block
                units = [WeightUnit(("w", path, b), path, b, per)
                         for b in range(nblk)]
            else:
                units = [WeightUnit(("w", path, -1), path, -1, nbytes)]
            for u in units:
                self.units[u.key] = u
            self._units_of[path] = [u.key for u in units]

    def _leaf(self, path: str) -> torch.Tensor:
        arr = self.weights[path]
        if arr is None:
            raise KeyError(f"weight leaf {path!r} is not resident")
        return arr

    def _get_unit(self, u: WeightUnit) -> torch.Tensor:
        arr = self._leaf(u.path)
        if u.sub < 0:
            return arr
        eb = self.embed_block
        return arr[u.sub * eb:(u.sub + 1) * eb]

    def _set_unit(self, u: WeightUnit, val: torch.Tensor) -> None:
        """Copy a host unit into the device leaf (allocated if dropped)."""
        if self.weights[u.path] is None:
            shape, dtype, device = self._meta[u.path]
            self.weights[u.path] = torch.empty(shape, dtype=dtype,
                                               device=device)
        arr = self.weights[u.path]
        if u.sub < 0:
            arr.copy_(val.reshape(arr.shape))
        else:
            eb = self.embed_block
            arr[u.sub * eb:(u.sub + 1) * eb].copy_(val)

    def _drop_unit(self, u: WeightUnit) -> None:
        self.resident.discard(u.key)
        if not any(k in self.resident for k in self._units_of[u.path]):
            self.weights[u.path] = None          # frees the device memory

    # ------------------------------------------------------------------ params
    def params(self) -> Dict[str, torch.Tensor]:
        """The parameter dict for compute; raises if any unit is not
        resident (the engine faults units in first)."""
        missing = [k for k in self.units if k not in self.resident]
        if missing:
            raise KeyError(f"weight unit {missing[0]} is not resident")
        return dict(self.weights)

    # ------------------------------------------------------------------ swap
    def collect_weight_items(self, working_set: Optional[frozenset] = None):
        """Partition resident units into (reap, swap) lists of host copies."""
        ws = working_set or frozenset()
        reap_items, swap_items = [], []
        for u in self.units.values():
            if u.key not in self.resident:
                continue
            data = self._get_unit(u).cpu()
            (reap_items if u.key in ws else swap_items).append((u.key, data))
        return reap_items, swap_items

    def drop_weights(self) -> int:
        """Release every resident unit (post swap-out madvise)."""
        n = 0
        for u in self.units.values():
            if u.key in self.resident:
                self._drop_unit(u)
                n += u.nbytes
        return n

    def apply_prefetch(self, data: Dict[Tuple, torch.Tensor]) -> int:
        """Install weight units from a batch read (KV keys are skipped —
        :meth:`PagedKVCache.apply_prefetch` owns those)."""
        n = 0
        with self.install_lock:
            for key, arr in data.items():
                if key[0] != "w":
                    continue
                self._set_unit(self.units[key], arr)
                self.resident.add(key)
                n += arr.nbytes
        return n

    def fault_in(self, keys: Sequence[Tuple]) -> int:
        """Fault swap-in: one vectored batch read per file, then a
        host-to-device copy per unit."""
        with self.install_lock:
            swap_keys, reap_keys = [], []
            for key in keys:
                if key in self.resident:
                    continue
                if key in self.swap_file:
                    swap_keys.append(key)
                elif key in self.reap_file.extents:
                    reap_keys.append(key)
                else:
                    raise KeyError(f"unit {key} neither resident nor swapped")
            n = 0
            for f, ks in ((self.swap_file, swap_keys),
                          (self.reap_file, reap_keys)):
                for key, arr in (f.read_units(ks).items() if ks else ()):
                    u = self.units[key]
                    self._set_unit(u, arr)
                    self.resident.add(key)
                    n += u.nbytes
        return n

    # ------------------------------------------------------------------ memory
    def weight_bytes(self, resident_only: bool = True) -> int:
        """Unit bytes as the reference counts them (every embedding block at
        a full block's size)."""
        return sum(u.nbytes for k, u in self.units.items()
                   if not resident_only or k in self.resident)

    @property
    def state(self) -> ContainerState:
        return self.sm.state
