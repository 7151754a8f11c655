"""The least time the card could take for the path-tracing kernel's
work, against the published peaks of one NVIDIA H100 SXM (NVIDIA's data
sheet, at its full 700 W power limit): 67e12 FP32 operations a second
outside the tensor cores, a fused multiply-add counted as two, and 3.35e12
bytes a second of HBM.

The operation counts are those of `csrc/pt_kernel.cu` as the renderer's
chip smoke test counts them (each add, sub, mul, div, sqrt, rsqrt, sin,
cos, min/max and float compare as one; the integer hash not counted):
per sample the camera ray, the ambient term and the film add; per bounce
of a live path one test per primitive and the cheapest scatter, the
Lambertian lobe (so the BSDF form's richer lobes are not counted, and its
share reads low).  The bytes: the film read and written once a launch and
the scene table read once a launch.  A bounce is one trip of a live
path's loop, counted by the reference on the pixels it recomputes."""
from __future__ import annotations

PEAK_FP32_OPS = 67e12
PEAK_HBM_BYTES = 3.35e12

FLOPS_SAMPLE = 40
FLOPS_SPHERE, FLOPS_TRIANGLE, FLOPS_PATCH = 33, 52, 38
FLOPS_SCATTER = 80


def flops_per_bounce(counts: dict) -> int:
    """One bounce of a live path over an analytic scene of these
    primitive counts (spheres, triangles, planes, lights)."""
    return (counts["spheres"] * FLOPS_SPHERE
            + counts["triangles"] * FLOPS_TRIANGLE
            + (counts["planes"] + counts["lights"]) * FLOPS_PATCH
            + FLOPS_SCATTER)


def render_work(counts: dict, table_floats: int, n_pix: int, spp: int,
                bounces_per_sample: float, launches: float) -> tuple:
    """(operations, bytes) of one render's kernel launches."""
    samples = n_pix * spp
    flops = samples * (FLOPS_SAMPLE
                       + bounces_per_sample * flops_per_bounce(counts))
    n_bytes = launches * (2 * n_pix * 3 * 4 + table_floats * 4)
    return flops, n_bytes


def least_seconds(flops: float, n_bytes: float) -> float:
    """The larger of the operations over the FP32 peak and the bytes over
    the memory rate."""
    return max(flops / PEAK_FP32_OPS, n_bytes / PEAK_HBM_BYTES)
