"""Mean milliseconds of the program's `cli.render` span (the `render`
command) that no span beneath it covers: the renderer's set-up, the
manager thread's start and join, the log lines."""
from program_spans import self_ms


def read(rec):
    return self_ms(rec, "cli.render")
