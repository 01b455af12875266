"""Latency tracing (the port's copy of ``LatencyTrace`` from
``repro/core/metrics.py``).  Thread-safe: serving threads record spans
concurrently."""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List


class LatencyTrace:
    """Named wall-clock spans, e.g. cold_start / prefill / decode."""

    def __init__(self):
        self.spans: Dict[str, List[float]] = {}
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            dt = time.monotonic() - t0
            with self._lock:
                self.spans.setdefault(name, []).append(dt)
