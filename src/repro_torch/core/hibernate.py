"""HibernationManager — the full deflate of §3.2, the synchronous REAP
wake and the fault path (the port's ``repro/core/hibernate.py``).

Full deflate (Warm/Woken -> Hibernate):
  1. *Pause*: SIGSTOP transition.  Working-set units still only in the
     REAP file (a pagefault-mode cycle that never touched them) are
     restored first, because the file is rewritten below.
  2. *Reclaim freed memory*: trim closed sessions' KV pages.
  3. *Swap out committed memory*: weight units (device -> host copies) and
     live KV pages (one gather launch, one device-to-host copy).  Working-
     set units go to the REAP file in one sequential write, in first-touch
     order; the rest go to the page-fault swap file.  Then the device
     weight tensors are released and the pool pages freed.

Wake: ``mode="reap"`` reads the whole REAP file in one sequential read and
installs it (weights host-to-device, KV pages with one scatter launch);
``mode="pagefault"`` restores nothing upfront, and units fault in on
access through :meth:`HibernationManager.fault`.

Not yet carried over: the MMAP_CLEAN and PARTIAL rungs, the pipelined
(streamed) wake, lookahead prefetch and the content-addressed store.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Tuple

import torch

from repro_torch.core.instance import ModelInstance
from repro_torch.core.state import Event


@dataclass
class DeflateStats:
    reap_bytes: int = 0
    swap_bytes: int = 0              # raw bytes sent to the swap file
    kv_pages_swapped: int = 0
    kv_pages_reclaimed: int = 0
    seconds: float = 0.0


@dataclass
class WakeStats:
    mode: str = "reap"
    prefetched_bytes: int = 0
    faulted_bytes: int = 0
    faults: int = 0
    #: wall time the caller was blocked, device work included
    seconds: float = 0.0
    #: time in the REAP file read
    io_seconds: float = 0.0
    #: time installing units (host-to-device copies, pool scatter)
    inflate_seconds: float = 0.0


def _sync(inst: ModelInstance) -> None:
    """Wait for the instance's device work, so stats time real work."""
    if inst.pool.device.type == "cuda":
        torch.cuda.synchronize(inst.pool.device)


class HibernationManager:
    def __init__(self):
        self.log: List[Tuple[str, str, object]] = []

    def deflate(self, inst: ModelInstance) -> DeflateStats:
        t0 = time.monotonic()
        st = DeflateStats()

        # step 1: pause.  Raises if a request is in flight.
        inst.sm.fire(Event.SIGSTOP)
        self._restore_reap_leftovers(inst)

        # step 2: reclaim freed memory — trim KV slack back to the pool
        if inst.kv is not None:
            st.kv_pages_reclaimed = inst.kv.trim()

        # step 3: swap out committed memory (weights + live KV pages)
        ws = inst.recorder.working_set
        w_reap, w_swap = inst.collect_weight_items(ws)
        kv_reap, kv_swap = ([], [])
        if inst.kv is not None:
            kv_reap, kv_swap = inst.kv.export_items(ws)
        # unconditional: an empty working set must CLEAR the REAP file, or
        # a later wake would prefetch a previous cycle's stale extents.
        # Laid out in FIRST-TOUCH order (the recorder's insertion order).
        order = {k: i for i, k in enumerate(inst.recorder.ordered_working_set)}
        items = sorted(w_reap + kv_reap,
                       key=lambda it: order.get(it[0], len(order)))
        inst.reap_file.write_batch(items)
        inst.swap_file.write_units(w_swap + kv_swap)
        inst.drop_weights()
        if inst.kv is not None:
            inst.kv.drop_pages()
        st.reap_bytes = sum(a.nbytes for _, a in w_reap + kv_reap)
        st.swap_bytes = sum(a.nbytes for _, a in w_swap + kv_swap)
        st.kv_pages_swapped = len(kv_reap) + len(kv_swap)

        inst.inflated = False
        _sync(inst)
        st.seconds = time.monotonic() - t0
        self.log.append(("deflate", inst.instance_id, st))
        return st

    def _restore_reap_leftovers(self, inst: ModelInstance) -> None:
        """Fault in working-set units still sitting only in the REAP file
        before the file is rewritten."""
        if not inst.reap_file.extents:
            return
        wkeys = [k for k in inst.reap_file.extents
                 if k[0] == "w" and k not in inst.resident]
        if wkeys:
            inst.fault_in(wkeys)
        if inst.kv is not None:
            kvkeys = inst.kv.nonresident_keys(
                [k for k in inst.reap_file.extents if k[0] == "kv"])
            if kvkeys:
                with inst.install_lock:
                    inst.kv.fault_in(kvkeys, inst.swap_file, inst.reap_file)

    def wake(self, inst: ModelInstance, mode: str = "reap",
             trigger: str = "request") -> WakeStats:
        """Inflate.  ``trigger="sigcont"`` is the predictive wake (⑤) and
        fires SIGCONT here; for ``trigger="request"`` (⑦) the engine fires
        the REQUEST transition."""
        t0 = time.monotonic()
        st = WakeStats(mode=mode)
        if mode == "reap" and inst.reap_file.extents:
            t_io = time.monotonic()
            data = inst.reap_file.read_batch()
            st.io_seconds = time.monotonic() - t_io
            t_inf = time.monotonic()
            st.prefetched_bytes += inst.apply_prefetch(data)
            if inst.kv is not None:
                st.prefetched_bytes += inst.kv.apply_prefetch(data)
            _sync(inst)
            st.inflate_seconds = time.monotonic() - t_inf
        inst.inflated = True
        if trigger == "sigcont":
            inst.sm.fire(Event.SIGCONT)
        st.seconds = time.monotonic() - t0
        self.log.append(("wake", inst.instance_id, st))
        return st

    def fault(self, inst: ModelInstance, keys) -> WakeStats:
        """Fault path for weight and KV unit keys: one vectored read per
        file for the weights, one per file plus one scatter for KV pages."""
        t0 = time.monotonic()
        st = WakeStats(mode="pagefault")
        wkeys = [k for k in keys if k and k[0] == "w"]
        kvkeys = [k for k in keys if k and k[0] == "kv"]
        st.faulted_bytes += inst.fault_in(wkeys)
        if kvkeys and inst.kv is not None:
            kvkeys_nr = inst.kv.nonresident_keys(kvkeys)
            if kvkeys_nr:
                with inst.install_lock:
                    st.faulted_bytes += inst.kv.fault_in(
                        kvkeys_nr, inst.swap_file, inst.reap_file)
        st.faults += len(wkeys) + len(kvkeys)
        st.seconds = time.monotonic() - t0
        return st
