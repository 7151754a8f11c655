"""Mean milliseconds a render spends in the renderer's `scene-prep` span
("SimplePathTracer.scene-prep", "AccPathTracer.scene-prep"): the scene's
arrays, the static scene on the device and the camera."""
from program_spans import span_ms


def read(rec):
    return span_ms(rec, lambda name: name.endswith(".scene-prep"))
