"""REAP: record-and-prefetch working sets (§3.4.2).

The port's copy of ``repro/core/reap.py`` without the coldness counters
(they feed the content-addressed store's compression tiers, which the
port does not have yet).

The recorder captures which *resource units* a sample request actually
touches: ``("w", path, sub)`` weight units and ``("kv", session, layer,
page)`` KV pages.  The recorded set becomes the REAP file's scatter
io-vector, laid out in **first-touch order** (insertion-ordered dicts
used as ordered sets).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Hashable, Tuple


@dataclass
class ReapRecorder:
    recording: bool = False
    #: insertion-ordered set: key -> None, first-touch order of this session
    seen: Dict[Hashable, None] = field(default_factory=dict)
    #: survives across record sessions — the stable working set; a unit
    #: keeps the position of its FIRST touch ever
    stable: Dict[Hashable, None] = field(default_factory=dict)

    def start(self) -> None:
        self.recording = True
        self.seen = {}

    def record_many(self, keys) -> None:
        if self.recording:
            for k in keys:
                if k not in self.seen:
                    self.seen[k] = None

    def stop(self) -> FrozenSet[Hashable]:
        self.recording = False
        for k in self.seen:
            if k not in self.stable:
                self.stable[k] = None
        return frozenset(self.stable)

    @property
    def working_set(self) -> FrozenSet[Hashable]:
        return frozenset(self.stable)

    @property
    def ordered_working_set(self) -> Tuple[Hashable, ...]:
        """The stable working set in first-touch order — the REAP file's
        on-disk layout."""
        return tuple(self.stable)
