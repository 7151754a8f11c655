"""Mean milliseconds of the renderer's render phase a render adds to
`GLOBAL_TIMER` ("<Renderer>.render": the kernel launches and the copy of
the image to the host, synchronised)."""
from readers import render_phase_ms as read  # noqa: F401
