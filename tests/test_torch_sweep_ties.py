"""Exact ties in the blocked mesh sweep (B2), the cases a warp-cooperative
winner reduction can get wrong, and the sweep's schedule counts.

The pool is `chip_smoke.tie_pool()`: the cube [-4, 4]^3 with every face a
grid of 2x2 quads (axis-aligned faces, each on its block's box face), one
top-face triangle repeated 20 times, and rays in one direction octant that
hit it on edges and vertices, the last of them inside a block box's face
plane.  Every t is exact in float32, so tied hits
are equal bit for bit in any float order, XLA's fused multiply-adds
included: the port's plain sweep must pick the JAX package's winner on
every ray.  The JAX side runs the Pallas sweep in interpret mode and its
blocked oracle, with 16-triangle blocks (the Pallas interpret compile grows
with the block).  All rays share octant 0, so the Pallas kernel's
per-tile majority octant is each ray's own and both visit the blocks in
the same front-to-back order.

`test_schedule_counts_by_hand` holds `mesh_cuda.schedule_counts` on four
separated squares, a block each, against counts worked out by hand."""
import pathlib
import sys

import numpy as np
import pytest
import torch

from nrenderer_torch import build_scene_arrays
from nrenderer_torch.ops import mesh_cuda
from nrenderer_torch.ops.bvh import build_mesh_accel
from nrenderer_torch.ops.soa import V3
from nrenderer_torch.scene import model

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from chip_smoke import FACE_PLANE_RAYS, tie_pool  # noqa: E402
from test_torch_jax_native import jax_loader  # noqa: E402,F401

# the JAX package's loader loads a build of this process's own
pytestmark = pytest.mark.usefixtures("jax_loader")

T_MIN = 1e-3
BLOCK = 16
CHANNELS = [(0.25, 9.0), (1.0, 2.0)]
COPIES = set(range(192, 212)) | {160}   # the repeated triangle's pids


def _scene(pkg_model, verts, faces):
    s = pkg_model.Scene()
    s.materials += [pkg_model.Material(name="A"), pkg_model.Material(name="B")]
    s.mesh_buffer.append(pkg_model.Mesh(
        positions=verts, position_indices=faces.reshape(-1), material=1))
    s.nodes.append(pkg_model.Node(name="m", type=pkg_model.NodeType.MESH,
                                  entity=0))
    return s


def _v3(a, mk):
    return V3(*(mk(np.ascontiguousarray(a[:, i])) for i in range(3)))


@pytest.fixture(scope="module")
def ties():
    verts, faces, o, d = tie_pool()
    ma = build_mesh_accel(build_scene_arrays(_scene(model, verts, faces)),
                          CHANNELS, block=BLOCK)
    return (ma.bt, mesh_cuda.make_mesh_tables(ma.bt, "cpu"),
            _v3(o, torch.as_tensor), _v3(d, torch.as_tensor))


@pytest.fixture(scope="module")
def jax_side():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    import nrenderer_tpu as T
    from nrenderer_tpu.ops.bvh import (
        build_mesh_accel as jbuild, intersect_triangles_blocked)
    from nrenderer_tpu.ops.mesh_pallas import sweep_mesh_full
    from nrenderer_tpu.ops.soa import V3 as JV3
    from nrenderer_tpu.scene import model as jmodel
    verts, faces, o, d = tie_pool()
    bt = jbuild(T.build_scene_arrays(_scene(jmodel, verts, faces)), CHANNELS,
                block=BLOCK).bt
    jo, jd = _v3(o, jnp.asarray), _v3(d, jnp.asarray)
    out = {}
    for f2b in (False, True):
        with pltpu.force_tpu_interpret_mode():
            res = sweep_mesh_full(bt, jo, jd, T_MIN, interpret=True, f2b=f2b)
        out[f2b] = tuple(np.asarray(a) for a in res)
    blocked = intersect_triangles_blocked(bt, jo, jd, t_min=T_MIN)
    return bt, out, (np.asarray(blocked[0]), np.asarray(blocked[5]))


def test_tie_pool_layout(ties):
    """The repeated triangle sits twice or more inside one block and in
    adjacent blocks, one block is flat, the top face lies on the box face
    of every block that holds a piece of it, and the rays hit the
    copies."""
    bt, mt, o, d = ties
    pid = np.asarray(bt.pid).astype(int)
    per_block = [sum(int(p) in COPIES for p in row) for row in pid]
    holding = [b for b, k in enumerate(per_block) if k]
    assert max(per_block) >= 2
    assert any(b + 1 in holding for b in holding)
    extent = np.asarray(bt.bb_max) - np.asarray(bt.bb_min)
    assert (extent == 0).any(axis=1).sum() >= 1
    top = ((np.asarray(bt.v1z) == 4) & (np.asarray(bt.e1z) == 0)
           & (np.asarray(bt.e2z) == 0) & (pid >= 0)).any(axis=1)
    assert top.sum() >= 3 and (np.asarray(bt.bb_max)[top, 2] == 4).all()
    got = mesh_cuda.sweep_mesh_full(mt, o, d, T_MIN)
    hits = got[1].numpy()
    assert int((hits >= 0).sum()) > 1000
    assert sum(int(p) in COPIES for p in hits) >= 16


@pytest.mark.parametrize("f2b", [False, True], ids=["natural", "f2b"])
def test_ties_match_pallas_interpret(ties, jax_side, f2b):
    """t and the winner on every ray, as the Pallas sweep gives them, in
    both block orders (tied winners follow the visiting order: the first
    block at the least t, the first triangle in it)."""
    _, mt, o, d = ties
    _, pallas, _ = jax_side
    got = mesh_cuda.sweep_mesh_full(mt, o, d, T_MIN, f2b=f2b)
    t_w, idx_w = pallas[f2b][0], pallas[f2b][1]
    np.testing.assert_array_equal(got[0].numpy(), t_w)
    np.testing.assert_array_equal(got[1].numpy(), idx_w)
    for k in range(2, 6):
        np.testing.assert_array_equal(got[k].numpy(), pallas[f2b][k])


def test_ties_match_blocked_oracle(ties, jax_side):
    """The JAX blocked oracle (no culling, divides by det) picks the first
    triangle of the pool at the least t: the natural order's winner."""
    bt_p, mt, o, d = ties
    bt_j, _, (t_w, pid_w) = jax_side
    np.testing.assert_array_equal(np.asarray(bt_p.pid), np.asarray(bt_j.pid))
    got = mesh_cuda.sweep_mesh_full(mt, o, d, T_MIN)
    np.testing.assert_array_equal(got[0].numpy(), t_w)
    np.testing.assert_array_equal(got[1].numpy().astype(np.float32),
                                  np.asarray(pid_w, np.float32))


def test_face_plane_rays_hit_as_the_pallas_tile_does(ties, jax_side):
    """The tie pool's last rays run inside a block box's face plane (a
    zero direction component, the origin on the plane z = 4 or y = 4) onto
    the +x face's edge there, at t = 8.  Their own slab test gives t_far =
    0 for that block.  The Pallas sweep culls per tile, so it finds each
    hit because other rays of the tile enter the block, and loses it when
    the face-plane rays sweep alone; the port's per-ray test rechecks rays
    parallel to an axis and finds it either way, as the tile does."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    from nrenderer_tpu.ops.mesh_pallas import sweep_mesh_full
    _, mt, o, d = ties
    bt_j, pallas, _ = jax_side
    face = slice(-FACE_PLANE_RAYS, None)
    with_tile = pallas[False][0][face]
    np.testing.assert_array_equal(with_tile, np.full(FACE_PLANE_RAYS, 8.0))
    got = mesh_cuda.sweep_mesh_full(mt, o, d, T_MIN)
    np.testing.assert_array_equal(got[0].numpy()[face], with_tile)
    np.testing.assert_array_equal(got[1].numpy()[face],
                                  pallas[False][1][face])
    _, _, fo, fd = tie_pool()
    alone_o, alone_d = fo[face], fd[face]
    with pltpu.force_tpu_interpret_mode():
        res = sweep_mesh_full(bt_j, _v3(alone_o, jnp.asarray),
                              _v3(alone_d, jnp.asarray), T_MIN,
                              interpret=True)
    assert np.isinf(np.asarray(res[0])).all()
    alone = mesh_cuda.sweep_mesh_full(mt, _v3(alone_o, torch.as_tensor),
                                      _v3(alone_d, torch.as_tensor), T_MIN)
    np.testing.assert_array_equal(alone[0].numpy(), with_tile)


def test_schedule_counts_by_hand():
    """Four unit squares at x = 0, 10, 20, 30 (z = 0), two triangles a
    block, so block s is square s; 40 rays straight down: lanes 0-29 over
    square 0, lanes 30-31 over square 1 (warp 0), lanes 32-39 over square 3
    (warp 1).  By hand, with DENSE_MIN = 16 and two triangles a block (one
    32-lane pass each):
      union: warp 0 runs blocks 0 and 1, warp 1 block 3: 3 blocks x 2
             triangles x 32 slots = 192;
      coop:  warp 0, step 0: 30 lanes >= 16, a dense step, 2 x 32 = 64;
             step 1: 2 pairs; warp 1, step 3: 8 pairs; 10 pairs x 32 =
             320; 384 in all;
      entered: 40 rays x 2 triangles = 80."""
    verts, faces = [], []
    for k in range(4):
        x = 10.0 * k
        base = len(verts)
        verts += [(x, 0, 0), (x + 1, 0, 0), (x + 1, 1, 0), (x, 1, 0)]
        faces += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    bt = build_mesh_accel(build_scene_arrays(_scene(
        model, np.asarray(verts, np.float32), np.asarray(faces, np.int32))),
        CHANNELS, block=2).bt
    mt = mesh_cuda.make_mesh_tables(bt, "cpu")
    xs = [0.5] * 30 + [10.5] * 2 + [30.5] * 8
    n = len(xs)
    o = V3(torch.tensor(xs), torch.full((n,), 0.5), torch.full((n,), 5.0))
    d = V3(torch.zeros(n), torch.zeros(n), torch.full((n,), -1.0))
    stats = {"enter": []}
    got = mesh_cuda.sweep_mesh_plain(mt, o, d, T_MIN,
                                     torch.full((n,), float("inf")),
                                     stats=stats)
    np.testing.assert_array_equal(got[0].numpy(), np.full(n, 5.0, np.float32))
    enter = stats["enter"][0]
    assert enter.shape == (n, 4)
    assert mesh_cuda.DENSE_MIN == 16
    counts = mesh_cuda.schedule_counts(enter, torch.arange(n) // 32, 2)
    assert counts == {"union_slots": 192, "coop_slots": 384, "coop_pairs": 10,
                      "coop_dense_steps": 1, "entered_slots": 80}
    assert stats["tri_tests"] == 80


def test_dense_min_matches_the_kernel():
    """The plain version's schedule counts use the kernel's threshold."""
    src = (REPO / "nrenderer_torch" / "csrc" / "mesh_sweep.cuh").read_text()
    line = next(ln for ln in src.splitlines()
                if ln.startswith("constexpr int kDenseMin"))
    assert int(line.split("=")[1].strip(" ;")) == mesh_cuda.DENSE_MIN
