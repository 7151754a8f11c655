"""Mean milliseconds per finished render of `AccPathTracer.render` less
the union of its `AccPathTracer.pass-wait` spans (each pass's launch
through its film's copy to the host): the progressive loop's host work
between passes, the add into the host sum and the previews.  None where
a render has no `pass-wait` span (a program without those spans)."""
from devtrace import union
from program_spans import render_spans


def read(rec):
    per = render_spans(rec)
    if per is None:
        return None
    total = 0.0
    for spans in per:
        loops = [s for s in spans if s.name == "AccPathTracer.render"]
        if len(loops) != 1:
            return None
        loop = loops[0]
        waits = union([(max(s.t0, loop.t0), min(s.t1, loop.t1))
                       for s in spans if s.name == "AccPathTracer.pass-wait"
                       and s.render == loop.render])
        if not waits:
            return None
        total += (loop.t1 - loop.t0) - sum(b - a for a, b in waits)
    return 1e3 * total / len(per)
