"""The work of the path-tracing kernel's mesh form (B1e,
`pt_mesh_kernel<false>`) for its roofline, on `roofline.py`'s peaks and
counts.

Per sample `FLOPS_SAMPLE`; per bounce of a live path the dense pass over
the `.scn`'s spheres, planes and lights as `roofline.flops_per_bounce`
counts them (the mesh form tests no triangle there: the `.scn`'s own
triangles join the pool), the scatter, and the pool's least sweep: one
slab test a block of 128 and one block's triangle tests.  A ray that
hits the mesh needs at least that; the blocks a ray enters past its
first, and the triangle tests of those blocks, are the cull's to save,
so a better cull reads as a larger share.  The count depends on the
scene and the bounces alone (the reference counts the bounces on the
pixels it recomputes), not on the kernel.  The bytes: the film read and
written, and the scene table and the mesh tables (`table_floats`) read,
once a launch."""
from __future__ import annotations

from roofline import FLOPS_SAMPLE, FLOPS_TRIANGLE, flops_per_bounce

BLOCK = 128
# csrc/mesh_sweep.cuh `enters_block`: 6 subtractions and 6 products, 10
# min/max for the near and far distances, 3 compares and a max to enter
FLOPS_BOX = 26


def flops_per_bounce_mesh(counts: dict) -> int:
    """One bounce of a live path: the dense pass, the scatter and the
    pool's least sweep (`counts` of `reference/mesh.py`)."""
    pool = counts["triangles"] + counts["mesh_triangles"]
    return (flops_per_bounce(dict(counts, triangles=0))
            + -(-pool // BLOCK) * FLOPS_BOX
            + min(BLOCK, pool) * FLOPS_TRIANGLE)


def render_work(counts: dict, table_floats: int, n_pix: int, spp: int,
                bounces_per_sample: float, launches: float) -> tuple:
    """(operations, bytes) of one render's launches of the mesh form."""
    samples = n_pix * spp
    flops = samples * (FLOPS_SAMPLE
                       + bounces_per_sample * flops_per_bounce_mesh(counts))
    n_bytes = launches * (2 * n_pix * 3 * 4 + table_floats * 4)
    return flops, n_bytes
