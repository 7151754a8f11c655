"""Mean milliseconds of the renderer's render phase a render adds to
`GLOBAL_TIMER` ("AccPathTracer.render": on the hybrid route in samples,
the staged wavefront's chunks and the film's copy to the host)."""
from readers import render_phase_ms as read  # noqa: F401
