"""Mean milliseconds a render spends in the program's `cli.png` span: the
PNG write of the finished image."""
from program_spans import span_ms


def read(rec):
    return span_ms(rec, lambda name: name == "cli.png")
