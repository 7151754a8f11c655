"""The dense forms' loop schedule: `pt_cuda.loop_slots` on hand-made path
lengths, worked out by hand for the nested loop, the flat loop at two
launch sizes and the persistent schedule, with a ragged last warp; and the
plain version's per-path bounce counts (`stats["path_bounces"]`), which
the schedule reads, on a small Cornell render (8x8, 3 spp, depth 4): they
sum to its "bounces", lie in [1, depth], and a render split over two calls
(the second from sp0 > 0) counts what one call counts.  CPU only; no
JAX."""
import pathlib

import pytest
import torch

from nrenderer_torch import build_scene_arrays, load_scn
from nrenderer_torch.ops import pt_cuda
from nrenderer_torch.ops.camera import make_camera
from nrenderer_torch.ops.intersect import make_static_scene
from nrenderer_torch.ops.pt_core import scene_epsilon

torch.set_num_threads(1)

RES = pathlib.Path(__file__).resolve().parent.parent / "resource"


def _hand_paths() -> torch.Tensor:
    """40 pixels (a full warp and a ragged one of 8 lanes), 4 samples:
    every path one bounce long except pixel 0's sample 0 (5), pixel 1's
    samples 1 and 2 (3 each) and pixel 33's sample 3 (7)."""
    pb = torch.ones((40, 4), dtype=torch.int32)
    pb[0, 0], pb[1, 1], pb[1, 2], pb[33, 3] = 5, 3, 3, 7
    return pb


def test_loop_slots_by_hand():
    pb = _hand_paths()
    got = pt_cuda.loop_slots(pb, 4)
    # useful: 160 single bounces plus 4 + 2 + 2 + 6 extra
    assert got["useful"] == 174
    # nested: warp 0's longest path a sample 5, 3, 3, 1; warp 1's (pixels
    # 32-39, 24 idle lanes) 1, 1, 1, 7; 32 lanes each
    assert got["nested"] == 32 * (12 + 10) == 704
    # flat, one launch of 4: warp 0's largest total 8 (pixels 0 and 1),
    # warp 1's 10 (pixel 33)
    assert got["flat"] == 32 * (8 + 10) == 576
    assert got["flat_share"] == pytest.approx(174 / 576)
    assert got["nested_share"] == pytest.approx(174 / 704)
    # flat, launches of 2: warp 0 max(6, 4) + max(2, 4), warp 1 2 + 8
    assert pt_cuda.loop_slots(pb, 2)["flat"] == 32 * ((6 + 4) + (2 + 8))
    # a launch of one sample is the nested loop
    assert pt_cuda.loop_slots(pb, 1)["flat"] == got["nested"]


def test_persistent_slots_by_hand():
    pb = _hand_paths()
    # one resident warp: lanes 0-31 take pixels 0-31 (totals 8, 8, then
    # 4); pixels 32-39 go to lanes 2-9 as they come free at 4, so lane 3
    # ends at 4 + 10 (pixel 33): 32 x 14
    got = pt_cuda.loop_slots(pb, 4, resident=32)
    assert got["persistent"] == 32 * 14
    assert got["persistent_share"] == pytest.approx(174 / 448)
    # as many lanes as pixels (rounded up to warps): the flat loop
    assert pt_cuda.loop_slots(pb, 4, resident=64)["persistent"] == 576
    # two launches of two samples, one warp: launch 1 ends at 6 (lane 0's
    # pixel 0); launch 2 at 2 + 8 (pixel 33, taken by lane 2 at 2)
    two = pt_cuda.loop_slots(pb, 2, resident=32)["persistent"]
    assert two == 32 * (6 + 10)


def test_grouped_slots_by_hand():
    """The mesh forms' grouped loop: a lane whose path ended waits until
    `regen` eighths of the lanes with samples left wait."""
    pb = _hand_paths()
    # regen 4 (the kernels'): warp 0 starts samples 1-3 with 30-31 lanes
    # waiting, then pixels 0 and 1 take turns, each starting alone as one
    # of the two lanes left: 8 iterations; warp 1 runs 3 + 7 (pixel 33)
    assert pt_cuda.loop_slots(pb, 4, regen=4)["grouped"] == 32 * (8 + 10)
    # regen 6: one waiting lane of two waits for the other: 10 + 10
    assert pt_cuda.loop_slots(pb, 4, regen=6)["grouped"] == 32 * (10 + 10)
    # regen 0 starts a sample as soon as a path ends (the flat loop), 8
    # when every lane's has (the nested loop)
    for launch in (1, 2, 4):
        assert pt_cuda.loop_slots(pb, launch, regen=0)["grouped"] \
            == pt_cuda.loop_slots(pb, launch)["flat"]
        assert pt_cuda.loop_slots(pb, launch, regen=8)["grouped"] \
            == pt_cuda.loop_slots(pb, launch)["nested"]
    assert "grouped" not in pt_cuda.loop_slots(pb, 4)
    # the model's share is the kernel's (csrc/pt_kernel.cu kRegenEighths)
    src = (RES.parent / pt_cuda.KERNEL_SOURCE).read_text()
    assert f"constexpr int kRegenEighths = {pt_cuda.MESH_REGEN_EIGHTHS};" \
        in src


@pytest.fixture(scope="module")
def cornell():
    scene = load_scn(str(RES / "cornell_box.scn"))
    ss = make_static_scene(build_scene_arrays(scene))
    return ss, make_camera(scene.camera, device="cpu")


def _counts(ss, cam, calls, depth, bsdf=False):
    st = {}
    film = torch.zeros((64, 3))
    for sp0, n in calls:
        pt_cuda.pt_accumulate_plain(film, ss, cam, 8, 8, sp0, n, depth, 2,
                                    scene_epsilon(ss), bsdf=bsdf, stats=st)
    return st, film


@pytest.mark.parametrize("bsdf", [False, True])
def test_path_bounces_sum_and_split(cornell, bsdf):
    ss, cam = cornell
    one, film_one = _counts(ss, cam, [(0, 3)], 4, bsdf)
    pb = one["path_bounces"]
    assert pb.dtype == torch.int32 and tuple(pb.shape) == (64, 3)
    assert int(pb.sum()) == one["bounces"]
    # every path runs bounce 0; none runs past the depth
    assert int(pb.min()) >= 1 and int(pb.max()) <= 4
    assert int((pb == 4).sum()) > 0 and int((pb < 4).sum()) > 0
    # split over two calls, the second from sp0 = 1: the same columns
    two, film_two = _counts(ss, cam, [(0, 1), (1, 2)], 4, bsdf)
    assert torch.equal(two["path_bounces"], pb)
    assert two["bounces"] == one["bounces"]
    assert torch.equal(film_two, film_one)
    # a later range on its own gives that range's columns
    tail, _ = _counts(ss, cam, [(1, 2)], 4, bsdf)
    assert torch.equal(tail["path_bounces"], pb[:, 1:])


def test_path_bounces_split_from_sp0(cornell):
    """A render of samples 3-5 split as 3 + (4, 5) counts what one call of
    samples 3-5 counts, and its schedule is the one call's."""
    ss, cam = cornell
    one, _ = _counts(ss, cam, [(3, 3)], 4)
    two, _ = _counts(ss, cam, [(3, 1), (4, 2)], 4)
    assert torch.equal(two["path_bounces"], one["path_bounces"])
    assert pt_cuda.loop_slots(two["path_bounces"], 3) \
        == pt_cuda.loop_slots(one["path_bounces"], 3)


def test_path_bounces_depth_zero(cornell):
    ss, cam = cornell
    st, _ = _counts(ss, cam, [(0, 2)], 0)
    assert tuple(st["path_bounces"].shape) == (64, 2)
    assert int(st["path_bounces"].sum()) == 0 and "bounces" not in st
    slots = pt_cuda.loop_slots(st["path_bounces"], 2)
    assert slots["useful"] == slots["nested"] == slots["flat"] == 0


@pytest.fixture(scope="module")
def mesh_cell():
    """The mesh cell's scene and mesh (`benchmark/configs/bvh_bunny.json`):
    `mesh_box.scn` with `ico_5120.obj`, 40 blocks of 128."""
    from nrenderer_torch import load_obj
    from nrenderer_torch.ops.bvh import build_mesh_accel
    from nrenderer_torch.ops.mesh_cuda import make_mesh_tables
    from nrenderer_torch.ops.pt_core import make_mat_channels
    bench = RES.parent / "benchmark"
    scene = load_scn(str(bench / "scenes" / "mesh_box.scn"))
    load_obj(str(bench / "obj" / "ico_5120.obj"), scene, material=0)
    arrays = build_scene_arrays(scene)
    ss = make_static_scene(arrays)
    mt = make_mesh_tables(build_mesh_accel(arrays,
                                           make_mat_channels(ss)).bt, "cpu")
    return ss, make_camera(scene.camera, device="cpu"), mt


def test_mesh_loop_slots_on_a_band(mesh_cell):
    """The mesh form's loop on a band of the mesh cell (two warps of row
    250 of 500x500, 8 spp, depth 20): the useful slots are the plain
    version's bounces, and the mesh forms' grouped loop's share of them
    lies between the nested loop's (every lane waits for the warp's
    longest path) and the flat loop's (none waits)."""
    ss, cam, mt = mesh_cell
    st = {}
    pt_cuda.pt_accumulate_plain(torch.zeros((64, 3)), ss, cam, 500, 500, 0,
                                8, 20, 0, scene_epsilon(ss), bsdf=True,
                                mesh=mt, stats=st, pix0=250 * 500, n_pix=64)
    pb = st["path_bounces"]
    assert tuple(pb.shape) == (64, 8) and int(pb.max()) <= 20
    slots = pt_cuda.loop_slots(pb, 8, regen=pt_cuda.MESH_REGEN_EIGHTHS)
    assert slots["useful"] == st["bounces"] == int(pb.sum())
    assert slots["nested_share"] < slots["grouped_share"] \
        < slots["flat_share"] <= 1.0
