"""Seconds from the start of the process to the first timed render:
imports, CUDA context, the kernel and host libraries, the scene and the
warm-up render (host clock)."""


def read(rec):
    return rec["setup_s"]
