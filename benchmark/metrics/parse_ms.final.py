"""Mean milliseconds a render spends in the program's `cli.parse` span:
the device check and the scene's build (the `.scn` parse, OBJ files, an
env map's decode)."""
from program_spans import span_ms


def read(rec):
    return span_ms(rec, lambda name: name == "cli.parse")
