"""The large mesh fixtures and the megamesh route's threshold, on the CPU.

The 20,480-face icosphere (160 blocks of 128) renders through the hybrid
route's plain versions, and its film is the same bit for bit whether the
host library or its numpy versions (NR_NO_NATIVE=1) loaded the file and
built the BVH.  The CPU keeps the megamesh limit of 1024 triangles, the
card reads its own (`routes.megamesh_max_tris`), and the renderer and a
sharded render's launching process both plan with `routes.plan_route`,
whose plan the ranks render."""
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

import nrenderer_torch as P
from nrenderer_torch.ops.bvh import build_mesh_accel
from nrenderer_torch.ops.mesh_cuda import make_mesh_tables
from nrenderer_torch.ops.pt_core import make_mat_channels
from nrenderer_torch.parallel import mesh as pmesh
from nrenderer_torch.renderers import acc_pt, routes
from nrenderer_torch.renderers._wavefront import build_render_fn
from nrenderer_torch.renderers.acc_pt import AccPathTracerRenderer

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = REPO / "resource"
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO))
import make_mesh_fixtures  # noqa: E402

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def ico_20480(tmp_path_factory):
    return make_mesh_fixtures.large_icosphere(
        5, tmp_path_factory.mktemp("ico"))


def _scene(obj, size=16, spp=2, depth=2):
    scene = P.load_scn(str(RES / "mesh_box.scn"))
    P.load_obj(str(obj), scene, material=0)
    ro = scene.render_option
    ro.width = ro.height = size
    ro.samples_per_pixel, ro.depth = spp, depth
    return scene


def test_large_icosphere_is_written_once_in_place(ico_20480):
    """The subdivision-5 icosphere: 20,480 faces on ico_5120's sphere
    (radius 120, resting on the floor), written whole and only once."""
    assert ico_20480.name == "ico_20480.obj"
    mtime = ico_20480.stat().st_mtime_ns
    assert make_mesh_fixtures.large_icosphere(5, ico_20480.parent) \
        == ico_20480
    assert ico_20480.stat().st_mtime_ns == mtime
    assert not list(ico_20480.parent.glob("*.tmp"))
    big, small = (P.load_obj(str(p)).mesh_buffer[0] for p in
                  (ico_20480, RES / "obj" / "ico_5120.obj"))
    assert big.position_indices.shape == (20480 * 3,)
    for m in (big, small):
        c = m.positions.mean(axis=0)
        np.testing.assert_allclose(c, [0.0, -157.5, 1000.0], atol=1e-3)
        r = np.linalg.norm(m.positions - c, axis=1)
        np.testing.assert_allclose(r, 120.0, rtol=1e-5)


@pytest.mark.parametrize("no_native", ["0", "1"])
def test_mesh_prep_tables_are_equal(ico_20480, no_native, monkeypatch):
    """`chip_smoke.mesh_prep_seconds` (phase 32's host prep, either
    switch set before it) builds equal tables with the library and with
    the numpy versions: 160 blocks."""
    monkeypatch.setenv("NR_NO_NATIVE", no_native)
    prep = chip_smoke.mesh_prep_seconds(str(ico_20480))
    assert prep["blocks"] == 160 and prep["tables_equal"]
    assert set(prep["native"]) == {"load_obj", "scene_prep", "bvh_build"}
    assert os.environ["NR_NO_NATIVE"] == no_native   # restored


def _hybrid_film(obj, monkeypatch, no_native):
    monkeypatch.setenv("NR_NO_NATIVE", no_native)
    scene = _scene(obj)
    arrays = P.build_scene_arrays(scene)
    from nrenderer_torch.ops.camera import make_camera
    from nrenderer_torch.ops.intersect import make_static_scene
    ss = make_static_scene(arrays)
    bt = build_mesh_accel(arrays, make_mat_channels(ss)).bt
    mt = make_mesh_tables(bt, "cpu")
    ro = scene.render_option
    fn = build_render_fn(ss, make_camera(scene.camera, device="cpu"),
                         ro.width, ro.height, ro.depth, ro.samples_per_pixel,
                         tri_bvh=mt, staged=False)
    film = fn(0, 0, ro.samples_per_pixel)
    img = AccPathTracerRenderer(device="cpu").render(scene).pixels
    return bt, film, img, scene


def test_large_mesh_film_is_the_same_with_either_build(ico_20480,
                                                       monkeypatch):
    bt_n, film_n, img_n, scene = _hybrid_film(ico_20480, monkeypatch, "0")
    bt_p, film_p, img_p, _ = _hybrid_film(ico_20480, monkeypatch, "1")
    assert bt_n.n_blocks == 160
    assert chip_smoke._same_tables(bt_n, bt_p)
    assert routes.plan_route(scene, "AccPathTracer", False,
                            "cpu").kind == "hybrid"
    assert torch.isfinite(film_n).all() and float(film_n.sum()) > 0
    assert torch.equal(film_n, film_p)
    assert np.array_equal(img_n, img_p)


def test_cpu_keeps_1024_and_the_card_reads_its_own():
    assert routes.MEGAMESH_MAX_TRIS == 1024
    assert routes.megamesh_max_tris("cpu") == 1024
    assert routes.megamesh_max_tris("cuda") == routes.MEGAMESH_MAX_TRIS_CUDA
    assert routes.MEGAMESH_MAX_TRIS_CUDA >= 1024
    for dev in ("cpu", "cuda"):
        limit = routes.megamesh_max_tris(dev)
        assert not routes.takes_hybrid(limit, False, dev)
        assert routes.takes_hybrid(limit + 1, False, dev)
        assert routes.takes_hybrid(65, True, dev)   # under an env map
    with routes.pinned_megamesh_max_tris(7):
        assert routes.megamesh_max_tris("cpu") == 7
        assert routes.megamesh_max_tris("cuda") == 7
    assert routes.megamesh_max_tris("cpu") == 1024
    with pytest.raises(KeyError):
        with routes.pinned_megamesh_max_tris(0):
            raise KeyError("restored on the way out")
    assert routes.megamesh_max_tris("cuda") == routes.MEGAMESH_MAX_TRIS_CUDA


@pytest.mark.parametrize("limit", [959, 960])
def test_plan_route_agrees_with_the_renderer(limit, monkeypatch):
    """The renderer plans with `plan_route` and takes the route its plan
    names: pinned at 959 the 960-face blob takes the hybrid route, at 960
    the megamesh route, on either device type."""
    scene = _scene(RES / "obj" / "blob_960.obj", size=4, spp=1, depth=1)
    taken, plans = [], []
    monkeypatch.setattr(
        AccPathTracerRenderer, "_render_hybrid",
        lambda self, *a, **k: taken.append("hybrid") or np.zeros((4, 4, 3)))
    monkeypatch.setattr(
        AccPathTracerRenderer, "_render_megamesh",
        lambda self, *a, **k: taken.append("megamesh")
        or np.zeros((4, 4, 3)))
    monkeypatch.setattr(acc_pt, "plan_route", lambda *a, **k: plans.append(
        routes.plan_route(*a, **k)) or plans[-1])
    want = "hybrid" if limit < 960 else "megamesh"
    with routes.pinned_megamesh_max_tris(limit):
        for dev in ("cpu", "cuda"):
            assert routes.plan_route(scene, "AccPathTracer", False,
                                     dev).kind == want
        AccPathTracerRenderer(device="cpu").render(scene)
    assert [p.kind for p in plans] == taken == [want]
    # the CPU's own limit: 5120 faces take the hybrid route
    ico = _scene(RES / "obj" / "ico_5120.obj", size=4, spp=1, depth=1)
    assert routes.plan_route(ico, "AccPathTracer", False,
                             "cpu").kind == "hybrid"
    assert routes.plan_route(ico, "AccPathTracer", False, "cuda").kind == (
        "hybrid" if routes.MEGAMESH_MAX_TRIS_CUDA < 5120 else "megamesh")


def test_ranks_render_the_launching_plan():
    """`make_route` takes a given plan over its own rule, and the ranks of
    `render_sharded` render the launching process's plan: the blob, pinned
    to the hybrid route here, renders on it on two spawned CPU ranks,
    whose own limit would send it to the megamesh route."""
    scene = _scene(RES / "obj" / "blob_960.obj", size=8, spp=2, depth=2)
    plan = routes.Plan("hybrid", "samples", 2, 1, 2)
    route = routes.make_route(scene, "AccPathTracer", False, "cpu", 0, plan)
    assert route.plan == plan
    assert routes.make_route(scene, "AccPathTracer", False, "cpu",
                            0).plan.kind == "megamesh"
    with routes.pinned_megamesh_max_tris(0):
        out = pmesh.render_sharded(scene, ["cpu", "cpu"], "AccPathTracer",
                                   "samples", threads=1, timeout=300)
        one = AccPathTracerRenderer(device="cpu").render(scene)
    assert out.route == "hybrid"
    np.testing.assert_allclose(out.image, one.pixels[..., :3],
                               rtol=1e-5, atol=1e-6)


def test_phase_32_image_stats_take_a_500_wide_image():
    """`_blocks8` keeps the whole 8x8 blocks of a 500x500 image (62 x 62),
    and `_lin_stats` of an image against itself is exact."""
    px = np.random.default_rng(0).uniform(0, 1, (500, 500, 3))
    assert chip_smoke._blocks8(px).shape == (62 * 62 * 3,)
    st = chip_smoke._lin_stats(px, px)
    assert st["linear_mean_rel_diff"] == 0.0
    assert st["block_corr"] == pytest.approx(1.0)
