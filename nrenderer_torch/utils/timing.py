"""Phase timing and render statistics.

Rebuild of the reference's ad-hoc instrumentation (SURVEY.md §5.1): the
per-thread accumulating `Timer` around closestHitObject
(`simple_path_tracing/include/Timer.hpp:7-38`) and the per-run wall clock in
`ComponentManager` (`ComponentManager.hpp:30-31,50-56`).  Here phases are
named spans with accumulated wall time; `report()` renders the summary the
reference printed to stdout (`SimplePathTracer.cpp:90-94`).  A copy of
`nrenderer_tpu/utils/timing.py` without its JAX profiler span.  A phase that
times device work must end in a synchronisation (the renderers copy their
result to the host inside the phase).
"""
from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict


@dataclass
class PhaseStats:
    total_s: float = 0.0
    count: int = 0


class PhaseTimer:
    """Accumulating named-phase stopwatch (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._phases: Dict[str, PhaseStats] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                st = self._phases.setdefault(name, PhaseStats())
                st.total_s += dt
                st.count += 1

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            st = self._phases.setdefault(name, PhaseStats())
            st.total_s += seconds
            st.count += 1

    def get(self, name: str) -> PhaseStats:
        with self._lock:
            return self._phases.get(name, PhaseStats())

    def report(self) -> str:
        with self._lock:
            lines = [f"{name:24s} {st.total_s:9.3f}s  x{st.count}"
                     for name, st in sorted(self._phases.items())]
        return "\n".join(lines)

    def clear(self) -> None:
        with self._lock:
            self._phases.clear()


    def summary(self) -> str:
        """One-line phase summary for the Logger tail, e.g.
        'prep 0.12s | render 3.41s x4 | host 0.05s'."""
        with self._lock:
            parts = []
            for name, st in self._phases.items():
                cnt = f" x{st.count}" if st.count > 1 else ""
                parts.append(f"{name} {st.total_s:.2f}s{cnt}")
        return " | ".join(parts)


# process-global timer, like the reference's file-scope `timers[16]`
GLOBAL_TIMER = PhaseTimer()
