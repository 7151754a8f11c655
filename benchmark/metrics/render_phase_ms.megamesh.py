"""Mean milliseconds of the renderer's render phase a render adds to
`GLOBAL_TIMER` ("AccPathTracer.render": on the megamesh route the loop of
its passes, each pass's launch, wait and copy to the host, the add into
the host sum and the preview)."""
from readers import render_phase_ms as read  # noqa: F401
