"""The work of the hybrid mesh route's kernels for their rooflines, on
`roofline.py`'s peaks: the blocked sweep B2 (`mesh_sweep_kernel`) and the
streaming compactor B3a/B3b (`stream_pack_kernel`, `stream_unpack_kernel`).

The work is counted from the scene (the pool's triangles), the traffic
(pixels and samples) and the reference's counts a sample
(`reference/hybrid.py`'s `stats`), so the same work is counted whatever
implements it:

- `box_rays`: a live ray whose path reaches the pool's box before its
  analytic hit needs the pool's least sweep, as `roofline_mesh.py` counts
  it: one slab test a block of 128 and one block's triangle tests; it
  brings its origin, direction and cap (7 floats) and takes back its hit
  (t, triangle, normal, material: 6).  A better cull reads as a larger
  share.
- The compactor moves, at the least, each such ray into the sweep and
  its hit back (7 floats read and written, then 6), and at each stage
  boundary each live ray's state into the smaller buffer (origin,
  direction, throughput and its lane: 10 floats read and written) and,
  later, its radiance back to its lane (3 read and written), counted by
  `stage_rays`.  The lanes a pack scans past, the slots it clears and the
  fills an unpack writes are its own design's, not counted.

B2 is bound by its operations, the compactor by its bytes."""
from __future__ import annotations

from roofline import FLOPS_TRIANGLE
from roofline_mesh import BLOCK, FLOPS_BOX

RAY_IN, HIT_OUT = 7, 6       # floats a swept ray brings and takes back
STAGE_STATE, RADIANCE = 10, 3  # floats a ray carries across a stage


def sweep_flops_per_ray(counts: dict) -> int:
    """The pool's least sweep for one ray (`counts` of
    `reference/mesh.py`: the `.scn`'s triangles join the pool)."""
    pool = counts["triangles"] + counts["mesh_triangles"]
    return -(-pool // BLOCK) * FLOPS_BOX + min(BLOCK, pool) * FLOPS_TRIANGLE


def sweep_work(counts: dict, n_pix: int, spp: int,
               box_rays_per_sample: float) -> tuple:
    """(operations, bytes) of one render's sweeps."""
    rays = n_pix * spp * box_rays_per_sample
    return (rays * sweep_flops_per_ray(counts),
            rays * (RAY_IN + HIT_OUT) * 4)


def compact_bytes(n_pix: int, spp: int, box_rays_per_sample: float,
                  stage_rays_per_sample: float) -> float:
    """The least bytes one render's packs and unpacks read and write."""
    samples = n_pix * spp
    pipe = samples * box_rays_per_sample * 2 * (RAY_IN + HIT_OUT)
    stage = samples * stage_rays_per_sample * 2 * (STAGE_STATE + RADIANCE)
    return 4 * (pipe + stage)
