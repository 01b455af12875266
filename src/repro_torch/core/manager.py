"""InstanceManager: the per-node control plane (the port's
``repro/core/manager.py``): cold start (①), descent to HIBERNATED (④) and
the request-driven or predictive wake (⑦/⑤) with the wake-storm guard —
concurrent wakes of one hibernating tenant share a single inflate.

Not yet carried over: the governor, the shared base-weight registry, the
content-addressed store, the prefix registry, zygotes, migration and the
intermediate ladder rungs.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict

import torch

from repro_torch.core.hibernate import HibernationManager
from repro_torch.core.instance import ModelInstance
from repro_torch.core.pool import PagePool
from repro_torch.core.state import ContainerState, Event, Rung


@dataclass
class ManagerConfig:
    """Per-node sizing and policy for one :class:`InstanceManager`."""

    #: directory of the per-instance swap and REAP files
    spool_dir: str
    #: the page pool: pages x elements; 1<<15 pages of 16384 f32 = 2 GiB
    pool_capacity_pages: int = 1 << 15
    pool_page_elems: int = 16384
    wake_mode: str = "reap"              # "reap" | "pagefault"
    device: str = "cuda"


class InstanceManager:
    def __init__(self, cfg: ManagerConfig,
                 factory: Callable[[str], tuple]):
        """``factory(arch_key) -> (model_cfg, params)`` builds a cold
        instance's weights on ``cfg.device`` — the expensive cold-start
        work."""
        self.cfg = cfg
        self.factory = factory
        self.pool = PagePool(cfg.pool_page_elems, torch.float32,
                             cfg.pool_capacity_pages, device=cfg.device)
        self.hib = HibernationManager()
        self.instances: Dict[str, ModelInstance] = {}
        self._lock = threading.RLock()                 # instance table
        self._wake_locks: Dict[str, threading.Lock] = {}
        self.wakes_performed = 0
        self.wakes_deduped = 0

    def _wake_lock(self, instance_id: str) -> threading.Lock:
        with self._lock:
            lock = self._wake_locks.get(instance_id)
            if lock is None:
                lock = self._wake_locks[instance_id] = threading.Lock()
            return lock

    def cold_start(self, instance_id: str, arch_key: str) -> ModelInstance:
        """① Admit a tenant: run the factory and enter the state graph
        through ``COLD_START``."""
        model_cfg, params = self.factory(arch_key)
        inst = ModelInstance(instance_id, model_cfg, params, pool=self.pool,
                             spool_dir=self.cfg.spool_dir)
        inst.sm.fire(Event.COLD_START)
        with self._lock:
            self.instances[instance_id] = inst
        return inst

    def descend(self, instance_id: str, rung):
        """Walk one tenant down the deflation ladder.  Only
        ``Rung.HIBERNATED`` (full deflate) is ported so far."""
        rung = Rung(rung)
        if rung != Rung.HIBERNATED:
            raise NotImplementedError(f"rung {rung.name} is not ported yet")
        return self.hib.deflate(self.instances[instance_id])

    def ensure_awake(self, instance_id: str, trigger: str = "request"):
        """Inflate a hibernating instance exactly once per storm; returns
        the :class:`WakeStats` for the thread that performed the inflate,
        ``None`` for everyone else (and in pagefault mode, where units
        fault in lazily)."""
        inst = self.instances.get(instance_id)
        if inst is None or inst.state != ContainerState.HIBERNATE:
            return None
        with self._wake_lock(instance_id):
            if inst.state != ContainerState.HIBERNATE or inst.inflated:
                self.wakes_deduped += 1        # someone else woke it first
                return None
            if trigger == "request" and self.cfg.wake_mode != "reap":
                # pagefault mode: mark the cycle woken under the wake lock
                inst.inflated = True
                return None
            self.wakes_performed += 1
            return self.hib.wake(inst, mode=self.cfg.wake_mode,
                                 trigger=trigger)

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {k: v.state.value for k, v in self.instances.items()}
