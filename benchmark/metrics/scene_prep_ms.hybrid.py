"""Mean milliseconds a render spends in `AccPathTracer.scene-prep`: the
scene's arrays (the 81,920 faces among them), the static scene on the
device and the camera."""
from program_spans import span_ms


def read(rec):
    return span_ms(rec, lambda name: name == "AccPathTracer.scene-prep")
