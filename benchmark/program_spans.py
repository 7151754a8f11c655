"""Readings of the program's own spans for the metric files: the spans of
`nrenderer_torch.utils.timing.GLOBAL_TIMER` (name, perf_counter start and
end, parent id, render id) that lie inside a finished render's host-clock
span (`t0`, `t1`) of the run's record, read in the benchmark's process
after the window.  A program that records no spans, or whose ring dropped
spans that ended inside the window, reads None."""
from __future__ import annotations

import bisect
from typing import Callable, List, Optional

from devtrace import union
from readers import finished


def render_spans(rec) -> Optional[List[list]]:
    """The spans inside each finished render, in the renders' order."""
    from nrenderer_torch.utils.timing import GLOBAL_TIMER
    read = getattr(GLOBAL_TIMER, "spans", None)
    done = finished(rec)
    if read is None or not done:
        return None
    spans = read()
    # the ring drops its oldest first, so nothing of the window was lost
    # while its oldest span ended before the window's first render began
    if GLOBAL_TIMER.dropped and (not spans or spans[0].t1 >= done[0]["t0"]):
        return None
    spans.sort(key=lambda s: s.t0)
    starts = [s.t0 for s in spans]
    out = []
    for r in done:
        lo = bisect.bisect_left(starts, r["t0"])
        hi = bisect.bisect_right(starts, r["t1"])
        out.append([s for s in spans[lo:hi] if s.t1 <= r["t1"]])
    return out


def span_ms(rec, keep: Callable[[str], bool]) -> Optional[float]:
    """Mean milliseconds per finished render of the spans whose name
    `keep` accepts (None where no render has one)."""
    per = render_spans(rec)
    if per is None:
        return None
    found = [s.t1 - s.t0 for spans in per for s in spans if keep(s.name)]
    return 1e3 * sum(found) / len(per) if found else None


def self_ms(rec, root: str) -> Optional[float]:
    """Mean milliseconds per finished render of the spans named `root`
    less the union of the intervals of the spans beneath them (those of
    the root's render id)."""
    per = render_spans(rec)
    if per is None:
        return None
    total, n = 0.0, 0
    for spans in per:
        for r in (s for s in spans if s.name == root):
            below = union([(max(s.t0, r.t0), min(s.t1, r.t1)) for s in spans
                           if s.render == r.render and s.id != r.id])
            total += (r.t1 - r.t0) - sum(b - a for a, b in below)
            n += 1
    return 1e3 * total / len(per) if n else None
