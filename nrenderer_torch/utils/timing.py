"""Phase timing, host spans and render statistics.

Rebuild of the reference's ad-hoc instrumentation (SURVEY.md §5.1): the
per-thread accumulating `Timer` around closestHitObject
(`simple_path_tracing/include/Timer.hpp:7-38`) and the per-run wall clock in
`ComponentManager` (`ComponentManager.hpp:30-31,50-56`).  A phase is a
named span: its per-name totals feed the Logger's `phases:` line, the
summary the reference printed to stdout (`SimplePathTracer.cpp:90-94`), and
the span itself (name, `time.perf_counter()` start and end, parent, render
id) goes into a bounded ring that a reader takes after the work
(`spans()`, `dropped`).  A phase that times device work must end in a
synchronisation (the renderers copy their result to the host inside the
phase).

A span's parent is the span open on its thread, or, on a thread with no
open span (the `ComponentManager`'s), the open root: the span opened with
`root=True`, the CLI's `cli.render`.  Each root starts a render id that
every span under it shares.  While a `torch.profiler` profile records, a
span also opens `torch.profiler.record_function("nr:" + name)`, so it
sits in the trace on the trace's own clock (a profile opened on the main
thread sees other threads' ranges only with `profile_all_threads`).
"""
from __future__ import annotations

import collections
import contextlib
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

# a render command records 8 spans (the progressive routes 5 a pass); a
# 51 s window of 512², 2048 spp renders ~1200, of 128², 16 spp drafts
# (~2700 renders) ~22,000
SPAN_CAPACITY = 1 << 16


@dataclass
class PhaseStats:
    total_s: float = 0.0
    count: int = 0


class Span(NamedTuple):
    name: str
    t0: float                 # time.perf_counter() seconds
    t1: float
    id: int
    parent: Optional[int]     # the enclosing span's id; None outside any
    render: Optional[int]     # the id every span of one command shares


def _profiling() -> bool:
    """Whether a torch profiler records (on any thread)."""
    torch = sys.modules.get("torch")
    return torch is not None and getattr(
        torch.autograd.profiler, "_is_profiler_enabled", False)


class PhaseTimer:
    """Accumulating named-phase stopwatch and span recorder (thread-safe).

    `PhaseTimer()` records: per-name totals and a ring of the last
    `capacity` spans, with `dropped` counting those pushed out.
    `timer.scope(prefix)` is a timer for one render: its phases are spans
    of `timer` named "<prefix>.<name>", and it keeps its own totals under
    the short names for the Logger's `summary()`."""

    def __init__(self, capacity: int = SPAN_CAPACITY, prefix: str = "",
                 into: Optional["PhaseTimer"] = None) -> None:
        self._lock = threading.Lock()
        self._phases: Dict[str, PhaseStats] = {}
        self._prefix = prefix
        self._into = into
        if into is None:
            self._ring: collections.deque = collections.deque(
                maxlen=capacity)
            self.dropped = 0
            self._ids = 0
            self._renders = 0
            self._root: Optional[tuple] = None   # (span id, render id)
            self._local = threading.local()

    def scope(self, prefix: str) -> "PhaseTimer":
        return PhaseTimer(prefix=prefix, into=self._into or self)

    @contextlib.contextmanager
    def phase(self, name: str, root: bool = False):
        rec = self._into or self
        full = f"{self._prefix}.{name}" if self._prefix else name
        token = rec._open(full, root)
        try:
            yield
        finally:
            dt = rec._close(token)
            if rec is not self:
                self._add(name, dt)

    def _open(self, name: str, root: bool) -> tuple:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        top = stack[-1] if stack else (None if root else self._root)
        parent, render = top if top is not None else (None, None)
        with self._lock:
            self._ids += 1
            sid = self._ids
            if root:
                self._renders += 1
                render = self._renders
        rf = None
        if _profiling():
            rf = sys.modules["torch"].profiler.record_function("nr:" + name)
            rf.__enter__()
        prev_root = self._root
        if root:
            self._root = (sid, render)
        stack.append((sid, render))
        return name, time.perf_counter(), sid, parent, render, root, \
            prev_root, rf

    def _close(self, token: tuple) -> float:
        t1 = time.perf_counter()
        name, t0, sid, parent, render, root, prev_root, rf = token
        if rf is not None:
            rf.__exit__(None, None, None)
        self._local.stack.pop()
        if root:
            self._root = prev_root
        self._add(name, t1 - t0, Span(name, t0, t1, sid, parent, render))
        return t1 - t0

    def _add(self, name: str, seconds: float,
             span: Optional[Span] = None) -> None:
        with self._lock:
            st = self._phases.setdefault(name, PhaseStats())
            st.total_s += seconds
            st.count += 1
            if span is not None:
                if len(self._ring) == self._ring.maxlen:
                    self.dropped += 1
                self._ring.append(span)

    def get(self, name: str) -> PhaseStats:
        with self._lock:
            return self._phases.get(name, PhaseStats())

    def spans(self) -> List[Span]:
        """The ring's spans, oldest end first."""
        with self._lock:
            return list(self._ring)

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
