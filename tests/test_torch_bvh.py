"""The port's host BVH and blocked triangle pool against the JAX package's.

`build_bvh` gives the same preorder arrays as the JAX package's numpy
builder and its native C++ builder (exact); `pack_blocked_triangles` gives
the same fields as the JAX pool (exact), the MXU sweep's coefficient table
and centre among them; the torch oracle `intersect_triangles_blocked`
matches the JAX one."""
import pathlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import nrenderer_tpu as T  # noqa: E402
from nrenderer_tpu.ops import bvh as jbvh  # noqa: E402
from nrenderer_tpu.ops.intersect import (  # noqa: E402
    make_static_scene as jax_make_static_scene,
)
from nrenderer_tpu.ops.pt_core import (  # noqa: E402
    make_mat_channels as jax_make_mat_channels,
)

import nrenderer_torch as P  # noqa: E402
from nrenderer_torch.ops import bvh  # noqa: E402
from nrenderer_torch.ops.intersect import make_static_scene  # noqa: E402
from nrenderer_torch.ops.pt_core import make_mat_channels  # noqa: E402
from nrenderer_torch.ops.soa import V3  # noqa: E402
from test_torch_jax_native import jax_native  # noqa: E402,F401

# the JAX package's loader loads a build of this process's own
pytestmark = pytest.mark.usefixtures("jax_native")

torch.set_num_threads(1)

RES = pathlib.Path(__file__).resolve().parent.parent / "resource"


def _aabbs(kind):
    rng = np.random.default_rng(5)
    if kind == "random":
        mn = rng.uniform(-50, 50, (513, 3)).astype(np.float32)
        return mn, mn + rng.uniform(0.01, 5.0, (513, 3)).astype(np.float32)
    if kind == "ties":   # repeated centroids: the stable sort decides
        mn = np.repeat(rng.uniform(-5, 5, (40, 3)), 3, axis=0)
        mn = mn.astype(np.float32)
        return mn, mn + np.float32(1.0)
    a = P.build_scene_arrays(P.load_obj(str(RES / "obj" / kind)))
    v1 = np.asarray(a.tri_v1, np.float32)
    v2 = v1 + np.asarray(a.tri_e1, np.float32)
    v3 = v1 + np.asarray(a.tri_e2, np.float32)
    return (np.minimum(np.minimum(v1, v2), v3),
            np.maximum(np.maximum(v1, v2), v3))


@pytest.mark.parametrize("kind", ["random", "ties", "blob_960.obj",
                                  "ico_5120.obj"])
def test_build_bvh_matches_jax_numpy_and_native(kind, jax_native):
    mn, mx = _aabbs(kind)
    got = bvh.build_bvh(mn, mx)
    for want in (jbvh.build_bvh(mn, mx, use_native=False),
                 jax_native.build_bvh(mn, mx)):
        assert len(want) == len(got)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
            assert g.dtype == np.asarray(w).dtype
    n = mn.shape[0]
    assert got[3].shape == (2 * n - 1,)
    assert sorted(got[3][got[3] >= 0].tolist()) == list(range(n))
    empty = bvh.build_bvh(np.zeros((0, 3), np.float32),
                          np.zeros((0, 3), np.float32))
    for g, w in zip(empty, jbvh.build_bvh(np.zeros((0, 3), np.float32),
                                          np.zeros((0, 3), np.float32))):
        np.testing.assert_array_equal(g, w)


SCENES = {
    "blob": ("mesh_box.scn", ["blob_960.obj"]),
    "tex_grid": ("tex_grid.scn", ["tex_grid.obj"]),
    "grid_and_blob": ("mesh_box.scn", ["tex_grid.obj", "blob_960.obj"]),
}


def _both(scn, objs):
    out = []
    for pkg, mss, mmc in ((T, jax_make_static_scene, jax_make_mat_channels),
                          (P, make_static_scene, make_mat_channels)):
        scene = pkg.Scene()
        pkg.load_scn(str(RES / scn), scene)
        for o in objs:
            pkg.load_obj(str(RES / "obj" / o), scene,
                         material=0 if scene.materials else None)
        arrays = pkg.build_scene_arrays(scene)
        out.append((arrays, mmc(mss(arrays))))
    return out


@pytest.mark.parametrize("block", [128, 64])
@pytest.mark.parametrize("which", sorted(SCENES))
def test_pack_blocked_triangles_matches_jax(which, block):
    (ja, jch), (pa, pch) = _both(*SCENES[which])
    assert jch == pch
    want = jbvh.pack_blocked_triangles(ja, jch, block=block)
    got = bvh.pack_blocked_triangles(pa, pch, block=block)
    assert set(type(got)._fields) == set(type(want)._fields)
    for name in type(got)._fields:
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is None:
            continue
        if name == "mxu_center":    # a tuple of Python floats on both sides
            assert type(g) is tuple and g == w, (g, w)
            continue
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert (got.tex is not None) == ("grid" in which)
    ma = bvh.build_mesh_accel(pa, pch, block=block)
    np.testing.assert_array_equal(ma.bt.pid, got.pid)


def test_blocked_oracle_matches_jax():
    """`intersect_triangles_blocked` as torch ops against the JAX
    function on the same rays (exact: both divide by det in the same
    order; `t` within 1 ulp where XLA contracts)."""
    import jax.numpy as jnp
    from nrenderer_tpu.ops.soa import V3 as JV3
    (ja, jch), (pa, pch) = _both("tex_grid.scn", ["tex_grid.obj"])
    # small blocks keep the JAX scan's unrolled body quick to compile
    jbt = jbvh.pack_blocked_triangles(ja, jch, block=8)
    pbt = bvh.pack_blocked_triangles(pa, pch, block=8)
    rng = np.random.default_rng(3)
    n = 700
    o = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
                  np.full(n, 10.0)]).astype(np.float32)
    d = np.stack([rng.uniform(-0.1, 0.1, n), rng.uniform(-0.1, 0.1, n),
                  np.ones(n)]).astype(np.float32)
    d /= np.linalg.norm(d, axis=0)
    want = jbvh.intersect_triangles_blocked(
        jbt, JV3(*map(jnp.asarray, o)), JV3(*map(jnp.asarray, d)),
        t_min=1e-3, with_uv=True)
    got = bvh.intersect_triangles_blocked(
        pbt, V3(*map(torch.as_tensor, o)), V3(*map(torch.as_tensor, d)),
        t_min=1e-3, with_uv=True)
    t_w, t_g = np.asarray(want[0]), got[0].numpy()
    hit = np.isfinite(t_w)
    assert hit.mean() > 0.3
    np.testing.assert_array_equal(np.isfinite(t_g), hit)
    np.testing.assert_allclose(t_g[hit], t_w[hit], rtol=1e-6)
    for k in (1, 2, 3, 4, 5):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    for g, w in zip(got[7], want[7]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
