"""Mean milliseconds per finished render of `AccPathTracer.render` less
the union of its `*-wait` spans, the host's waits on the device:
`mesh-pipe.reach-wait` (the mesh pipe's list of the rays its top-level
test rechecks as parallel), `mesh-pipe.count-wait` (the pipe's read of
its pack's count), `wavefront.count-wait` (the stage roulette's read of
the live count), `camera.lens-wait` (a chunk's camera rays' read of the
lens radius) and `AccPathTracer.film-wait` (the film's copy to the
host): every synchronising call of the render phase that
`torch.cuda.set_sync_debug_mode` finds.  What is left is the host
dispatching the wavefront's work.  None where a render
has no wait span (a program without those spans)."""
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
                       for s in spans if s.name.endswith("-wait")
                       and s.render == loop.render])
        if not waits:
            return None
        total += (loop.t1 - loop.t0) - sum(b - a for a, b in waits)
    return 1e3 * total / len(per)
