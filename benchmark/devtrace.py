"""Readings of a `torch.profiler` trace: the device's busy intervals, the
time of each kernel by name, and the device's idle time by the host span
it fell in.

`spans` are the harness's own host spans, (name, start, end) in
`time.perf_counter` seconds from any thread.  They are moved onto the
trace's clock by one offset: the harness reads perf_counter as it opens
the annotation `bench:window`, whose start the trace records."""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_ANNOTATION = "bench:window"
# the host spans a gap is named by, innermost first; "loop" outside all
SPAN_ORDER = ("png", "render", "parse", "scene-prep", "cli")


def load_events(prof, path: str) -> list:
    """The complete ("X") events of a stopped profiler, through its
    Chrome trace (written to `path`, read, deleted)."""
    prof.export_chrome_trace(path)
    try:
        with open(path, encoding="utf-8") as f:
            trace = json.load(f)
    finally:
        os.unlink(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def union(intervals: Sequence[Tuple[float, float]]) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_intervals(events: list) -> list:
    """(start, end) in trace microseconds of every kernel, copy and memset."""
    return [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") in DEVICE_CATS]


def op_seconds(events: list) -> Dict[str, float]:
    """Device seconds by operation name (kernels, copies, memsets)."""
    out: Dict[str, float] = {}
    for e in events:
        if e.get("cat") in DEVICE_CATS:
            out[e["name"]] = out.get(e["name"], 0.0) + float(e["dur"]) * 1e-6
    return out


def window(events: list) -> Optional[Tuple[float, float]]:
    for e in events:
        if e.get("name") == WINDOW_ANNOTATION:
            return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    return None


def idle_by_span(busy: list, lo: float, hi: float, spans: list,
                 offset_us: float) -> Dict[str, float]:
    """Seconds of [lo, hi] (trace microseconds) in which the device was
    idle, by the innermost host span open at the time (`SPAN_ORDER`)."""
    marks = []
    for name, t0, t1 in spans:
        if name in SPAN_ORDER:
            marks.append((t0 * 1e6 + offset_us, 1, name))
            marks.append((t1 * 1e6 + offset_us, -1, name))
    idle = []
    at = lo
    for a, b in busy:
        if b <= lo or a >= hi:
            continue
        if a > at:
            idle.append((at, a))
        at = max(at, b)
    if at < hi:
        idle.append((at, hi))
    points = sorted(marks + [(a, 2, None) for a, _ in idle]
                    + [(b, -2, None) for _, b in idle],
                    key=lambda m: (m[0], m[1]))
    open_spans = {name: 0 for name in SPAN_ORDER}
    in_idle, last, out = 0, lo, {}
    for t, kind, name in points:
        if in_idle and t > last:
            label = next((n for n in SPAN_ORDER if open_spans[n] > 0), "loop")
            out[label] = out.get(label, 0.0) + (t - last) * 1e-6
        last = t
        if kind in (1, -1):
            open_spans[name] += kind
        else:
            in_idle += 1 if kind == 2 else -1
    return out


def summarize(events: list, spans: list, anchor: float) -> dict:
    """busy_s (the union of device intervals inside the window), each
    operation's device seconds, and idle seconds by host span."""
    win = window(events)
    ops = op_seconds(events)
    if win is None:
        return {"busy_s": 0.0, "ops": ops, "idle": {}}
    lo, hi = win
    busy = union(device_intervals(events))
    busy_us = sum(min(b, hi) - max(a, lo) for a, b in busy
                  if b > lo and a < hi)
    offset = lo - anchor * 1e6
    return {"busy_s": busy_us * 1e-6, "ops": ops,
            "idle": idle_by_span(busy, lo, hi, spans, offset)}


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
