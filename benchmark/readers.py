"""Arithmetic the metric files share.  A metric file, `metrics/<name>.py`,
defines `read(rec) -> float | None` over a run's record (`harness.py`);
None leaves the metric out of the run's line.

The record's renders are the window's renders in order, each with its
host-clock span around `cli.main` (`t0`, `t1`), whether it finished
(`ok`) and the renderer's `GLOBAL_TIMER` render phase it added
(`phase_s`)."""
from __future__ import annotations

import statistics
from typing import Optional

import roofline


def finished(rec) -> list:
    return [r for r in rec["renders"] if r["ok"]]


def seconds_per_render(rec) -> Optional[float]:
    """The window's time up to the end of the last finished render, over
    the finished renders."""
    done = finished(rec)
    if not done:
        return None
    return (done[-1]["t1"] - rec["window_start"]) / len(done)


def mean(values) -> Optional[float]:
    values = list(values)
    return statistics.fmean(values) if values else None


def host_ms(rec) -> Optional[float]:
    """Mean milliseconds a render spent outside the renderer's render
    phase: argv parsing, the scene parse, scene prep, tone map, PNG."""
    return mean((r["t1"] - r["t0"] - r["phase_s"]) * 1e3
                for r in finished(rec) if r.get("phase_s") is not None)


def render_phase_ms(rec) -> Optional[float]:
    return mean(r["phase_s"] * 1e3 for r in finished(rec)
                if r.get("phase_s") is not None)


def idle_pct(rec) -> Optional[float]:
    tr = rec.get("trace")
    if not tr or tr.get("busy_s", 0.0) <= 0.0 or tr["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def render_flops_bytes(rec, launches_per_render: float) -> Optional[tuple]:
    work = rec.get("work") or {}
    if not work.get("samples"):
        return None
    t = rec["traffic"]
    return roofline.render_work(
        rec["tables"]["counts"], rec["tables"]["floats"],
        t["width"] * t["height"], t["spp"],
        work["bounces"] / work["samples"], launches_per_render)


def kernel_roofline(rec, trace_name: str, counter: str) -> Optional[float]:
    """The kernel's share of its roofline over the traced window: the
    least time of every render's launches (`roofline`) over the kernel's
    device seconds (the trace's kernels whose name holds `trace_name`)."""
    tr = rec.get("trace")
    renders = len(rec["renders"])
    launches = rec.get("launches", {}).get(counter, 0)
    if not tr or not renders or not launches:
        return None
    device_s = sum(s for name, s in tr["ops"].items()
                   if trace_name in name)
    fb = render_flops_bytes(rec, launches / renders)
    if fb is None or device_s <= 0.0:
        return None
    flops, n_bytes = fb
    return 100.0 * roofline.least_seconds(flops * renders,
                                          n_bytes * renders) / device_s
