"""Mean milliseconds a render spends in `AccPathTracer.bvh-build`: the
BVH over the pool's boxes, its packing into blocks of 128 triangles and
the mesh tables' copy to the device."""
from program_spans import span_ms


def read(rec):
    return span_ms(rec, lambda name: name == "AccPathTracer.bvh-build")
