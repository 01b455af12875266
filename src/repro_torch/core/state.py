"""Container state machine — Figure 3 of the paper, extended to a
multi-rung *deflation ladder*.

Framework-free: the port's own copy of ``repro/core/state.py`` (the whole
graph; the port so far drives the WARM/RUNNING/HIBERNATE/WOKEN cycle).

The paper's spectrum between Warm and Hibernate is a ladder of rungs,
each releasing more memory and costing more to wake:

    WARM -> MMAP_CLEAN -> PARTIAL -> HIBERNATED -> TERMINATED

  * ``MMAP_CLEAN`` — file-backed mmap cleanup (§3.5): re-mappable shared
    base-weight units are decref'd; anonymous memory stays resident, so a
    request only pays a checkpoint re-read when this tenant was the last
    sharer.
  * ``PARTIAL``    — partial deflate: *cold* anonymous units (REAP-miss-
    ranked MoE experts, deep-layer KV pages) are swapped out while the
    prefill-critical prefix stays resident — wake TTFT stays near-warm.
  * ``HIBERNATE``  — the paper's full deflate (Fig. 3): everything
    anonymous on disk, zero CPU.
  * ``DEAD``       — terminated: swap refs released, metadata gone.

The classic Fig. 3 graph (COLD/WARM/RUNNING/HIBERNATE/HIBERNATE_RUNNING/
WOKEN, circled transition numbers) is preserved verbatim; the ladder adds
the two intermediate rungs plus their entry/exit events.  Every
transition is guarded; invalid events raise ``InvalidTransition`` so the
property tests can assert the machine never leaves the graph.
"""
from __future__ import annotations

import enum
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple


class ContainerState(enum.Enum):
    COLD = "cold"                        # not yet created / evicted
    WARM = "warm"                        # fully initialized, idle, inflated
    RUNNING = "running"                  # processing a request (inflated)
    MMAP_CLEAN = "mmap_clean"            # shared mmap units dropped, anon resident
    PARTIAL = "partial"                  # cold anon units swapped, prefix resident
    HIBERNATE = "hibernate"              # deflated, paused, zero CPU
    HIBERNATE_RUNNING = "hib_running"    # woken by a request, processing
    WOKEN = "woken"                      # request finished, partially inflated
    MIGRATING = "migrating"              # snapshot in transit to another node
    ZYGOTE = "zygote"                    # pre-initialized, unowned fork donor
    DEAD = "dead"                        # evicted / terminated


class Rung(enum.IntEnum):
    """Position on the deflation ladder — ordered: deflating an instance
    moves it to a strictly higher rung, waking moves it lower."""
    WARM = 0
    MMAP_CLEAN = 1
    PARTIAL = 2
    HIBERNATED = 3
    TERMINATED = 4


class Event(enum.Enum):
    COLD_START = "cold_start"            # ① platform spawns a new container
    REQUEST = "request"                  # ②⑥⑦ user request arrives
    FINISH = "finish"                    # ③⑧ request processing done
    MMAP_DROP = "mmap_drop"              # ladder rung 1: clean file-backed mmap
    PARTIAL_STOP = "partial_stop"        # ladder rung 2: swap out cold units
    SIGSTOP = "sigstop"                  # ④⑨ platform deflates (full)
    SIGCONT = "sigcont"                  # ⑤ predictive wake-up
    EVICT = "evict"                      # terminate, delete swap files
    MIGRATE = "migrate"                  # cluster: ship snapshot to a peer node
    MIGRATE_DONE = "migrate_done"        # transfer committed on the target
    MIGRATE_ABORT = "migrate_abort"      # transfer failed: state stays local
    ZYGOTE_SPAWN = "zygote_spawn"        # pool pre-initializes a fork donor
    FORK = "fork"                        # new tenant specializes a zygote


S, E = ContainerState, Event

#: (state, event) -> (next_state, paper transition number / ladder tag)
TRANSITIONS: Dict[Tuple[ContainerState, Event], Tuple[ContainerState, str]] = {
    (S.COLD, E.COLD_START):            (S.WARM, "(1)"),
    (S.WARM, E.REQUEST):               (S.RUNNING, "(2)"),
    (S.RUNNING, E.FINISH):             (S.WARM, "(3)"),
    (S.WARM, E.SIGSTOP):               (S.HIBERNATE, "(4)"),
    (S.HIBERNATE, E.SIGCONT):          (S.WOKEN, "(5)"),
    (S.WOKEN, E.REQUEST):              (S.HIBERNATE_RUNNING, "(6)"),
    (S.HIBERNATE, E.REQUEST):          (S.HIBERNATE_RUNNING, "(7)"),
    (S.HIBERNATE_RUNNING, E.FINISH):   (S.WOKEN, "(8)"),
    (S.WOKEN, E.SIGSTOP):              (S.HIBERNATE, "(9)"),
    # --- deflation ladder: each rung is reachable from every rung above
    # it (the governor may skip an empty rung), never from below
    (S.WARM, E.MMAP_DROP):             (S.MMAP_CLEAN, "(4a)"),
    # a WOKEN instance already has tail units swapped out: cleaning its
    # mmap leaves it *partially* resident, not MMAP_CLEAN-fully-resident
    (S.WOKEN, E.MMAP_DROP):            (S.PARTIAL, "(4a')"),
    (S.WARM, E.PARTIAL_STOP):          (S.PARTIAL, "(4b)"),
    (S.WOKEN, E.PARTIAL_STOP):         (S.PARTIAL, "(4b)"),
    (S.MMAP_CLEAN, E.PARTIAL_STOP):    (S.PARTIAL, "(4b)"),
    # proportional reclaim: the governor may take further bites out of an
    # already-PARTIAL instance (swap more cold units) without changing rung
    (S.PARTIAL, E.PARTIAL_STOP):       (S.PARTIAL, "(4b)"),
    (S.MMAP_CLEAN, E.SIGSTOP):         (S.HIBERNATE, "(4)"),
    (S.PARTIAL, E.SIGSTOP):            (S.HIBERNATE, "(4)"),
    # --- ladder wakes: one SIGCONT climbs back to the servable rung the
    # memory supports (MMAP_CLEAN re-maps -> fully warm; PARTIAL restores
    # in the background -> woken)
    (S.MMAP_CLEAN, E.SIGCONT):         (S.WARM, "(5a)"),
    (S.PARTIAL, E.SIGCONT):            (S.WOKEN, "(5b)"),
    # --- requests on intermediate rungs
    (S.MMAP_CLEAN, E.REQUEST):         (S.RUNNING, "(2a)"),
    (S.PARTIAL, E.REQUEST):            (S.HIBERNATE_RUNNING, "(7b)"),
    # eviction (the TERMINATED rung) is legal from any idle state
    (S.WARM, E.EVICT):                 (S.DEAD, "evict"),
    (S.MMAP_CLEAN, E.EVICT):           (S.DEAD, "evict"),
    (S.PARTIAL, E.EVICT):              (S.DEAD, "evict"),
    (S.HIBERNATE, E.EVICT):            (S.DEAD, "evict"),
    (S.WOKEN, E.EVICT):                (S.DEAD, "evict"),
    # --- cluster migration: a deflated-enough tenant (its anon state is
    # on the CAS/REAP disk tier, or about to be flushed there by
    # migrate_out) ships to a peer node.  MIGRATING is a fenced state:
    # requests block on the transfer handle (mirroring the shared wake
    # pipeline), and the governor may neither deflate nor TERMINATE it —
    # (MIGRATING, EVICT) is deliberately NOT in this table, so a stale
    # governor descent can never free swap state a transfer still reads.
    (S.MMAP_CLEAN, E.MIGRATE):         (S.MIGRATING, "(10)"),
    (S.PARTIAL, E.MIGRATE):            (S.MIGRATING, "(10)"),
    (S.HIBERNATE, E.MIGRATE):          (S.MIGRATING, "(10)"),
    (S.MIGRATING, E.MIGRATE_DONE):     (S.DEAD, "(11)"),
    (S.MIGRATING, E.MIGRATE_ABORT):    (S.HIBERNATE, "(11')"),
    # --- zygote pool: a pre-initialized, tenant-less fork donor.  A
    # ZYGOTE never serves (REQUEST is deliberately NOT legal here) — it
    # exists only to be consumed by a fork or retired by the governor.
    # The forked *tenant* enters the graph through (COLD, FORK), so its
    # history distinguishes a warm fork from a true cold start.
    (S.COLD, E.ZYGOTE_SPAWN):          (S.ZYGOTE, "(z1)"),
    (S.COLD, E.FORK):                  (S.WARM, "(z2)"),
    (S.ZYGOTE, E.FORK):                (S.DEAD, "(z3)"),
    (S.ZYGOTE, E.EVICT):               (S.DEAD, "retire"),
}

#: states in which the instance holds *no* device memory for app state
DEFLATED_STATES = frozenset({S.HIBERNATE, S.MIGRATING})
#: states in which the instance consumes zero scheduler slots ("zero CPU")
PAUSED_STATES = frozenset({S.HIBERNATE, S.MIGRATING, S.DEAD})
#: states from which a request can be served without a cold start
SERVABLE_STATES = frozenset({S.WARM, S.MMAP_CLEAN, S.PARTIAL,
                             S.HIBERNATE, S.WOKEN})

#: ladder position of every non-running state (running states keep the
#: rung of the state they will FINISH back into)
RUNG_OF: Dict[ContainerState, Rung] = {
    S.WARM: Rung.WARM,
    S.RUNNING: Rung.WARM,
    S.WOKEN: Rung.WARM,            # servable without any wake work
    S.HIBERNATE_RUNNING: Rung.WARM,
    S.MMAP_CLEAN: Rung.MMAP_CLEAN,
    S.PARTIAL: Rung.PARTIAL,
    S.HIBERNATE: Rung.HIBERNATED,
    # migrate_out flushes anon state to disk before the state flips, so a
    # MIGRATING instance holds hibernated-rung memory (metadata only)
    S.MIGRATING: Rung.HIBERNATED,
    # a zygote is fully inflated (that is its whole value); its bytes are
    # priced by the governor against fork avoidance, not wake cost
    S.ZYGOTE: Rung.WARM,
    S.DEAD: Rung.TERMINATED,
    S.COLD: Rung.TERMINATED,
}

#: the deflate event that takes an (idle, servable) state to a given rung
DEFLATE_EVENT_FOR: Dict[Rung, Event] = {
    Rung.MMAP_CLEAN: E.MMAP_DROP,
    Rung.PARTIAL: E.PARTIAL_STOP,
    Rung.HIBERNATED: E.SIGSTOP,
    Rung.TERMINATED: E.EVICT,
}


class InvalidTransition(RuntimeError):
    pass


@dataclass
class StateMachine:
    state: ContainerState = ContainerState.COLD
    history: List[Tuple[float, ContainerState, Event, ContainerState, str]] = \
        field(default_factory=list)
    hooks: Dict[Event, List[Callable]] = field(default_factory=dict)

    def can(self, event: Event) -> bool:
        return (self.state, event) in TRANSITIONS

    def fire(self, event: Event, clock: Optional[Callable[[], float]] = None
             ) -> ContainerState:
        key = (self.state, event)
        if key not in TRANSITIONS:
            raise InvalidTransition(
                f"event {event.value!r} invalid in state {self.state.value!r}")
        new, tag = TRANSITIONS[key]
        t = (clock or time.monotonic)()
        self.history.append((t, self.state, event, new, tag))
        self.state = new
        for fn in self.hooks.get(event, ()):
            fn(self)
        return new

    def on(self, event: Event, fn: Callable) -> None:
        self.hooks.setdefault(event, []).append(fn)
