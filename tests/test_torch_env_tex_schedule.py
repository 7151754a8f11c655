"""The env and texture forms on the flat loop: the plain version's per-path
bounce counts (`stats["path_bounces"]`) for the env forms, which run one
bounce even at depth 0, and for the dense texture forms; `pt_cuda.loop_slots`
on the env scene; and the wrapper's launch plan (`pt_cuda.launch_plan`:
which forms take the persistent grid and the pixel counter, their spp a
launch), as a pure function and as `_pt_accumulate_cuda` follows it, with a
stand-in for the kernel library that records each launch.  CPU only; no
JAX.

On the card the kernel forms themselves are held against the plain version
bit for bit by `tests/test_torch_pt_kernel.py` (`cuda`-marked) and
`chip_smoke.py` phases 4 and 8."""
import contextlib
import pathlib
import types

import pytest
import torch

from nrenderer_torch import build_scene_arrays, load_obj, load_scn
from nrenderer_torch.io.image import load_image
from nrenderer_torch.ops import mesh_cuda, pt_cuda
from nrenderer_torch.ops.bvh import build_mesh_accel
from nrenderer_torch.ops.camera import make_camera
from nrenderer_torch.ops.intersect import make_static_scene
from nrenderer_torch.ops.pt_core import make_mat_channels, scene_epsilon

torch.set_num_threads(1)

RES = pathlib.Path(__file__).resolve().parent.parent / "resource"


def _scene(name, obj=None):
    scene = load_scn(str(RES / name))
    if obj is not None:
        load_obj(str(RES / "obj" / obj), scene, material=0)
    arrays = build_scene_arrays(scene)
    return make_static_scene(arrays), make_camera(scene.camera,
                                                  device="cpu"), arrays


@pytest.fixture(scope="module")
def env_scene():
    ss, cam, _ = _scene("env_spheres.scn")
    env = pt_cuda.make_env_tables(
        load_image(str(RES / "env_sky.png"))[:, :, :3], "cpu")
    return ss, cam, env


@pytest.fixture(scope="module")
def quad():
    ss, cam, arrays = _scene("tex_grid.scn", "tex_quad.obj")
    return ss, cam, pt_cuda.make_tex_tables(arrays.textures, "cpu")


def _bounces(ss, cam, size, spp, depth, bsdf=False, env=None, tex=None):
    st = {}
    pt_cuda.pt_accumulate_plain(torch.zeros((size * size, 3)), ss, cam, size,
                                size, 0, spp, depth, 3, scene_epsilon(ss),
                                bsdf=bsdf, env=env, tex=tex, stats=st)
    return st


@pytest.mark.parametrize("depth", [0, 1, 5])
@pytest.mark.parametrize("bsdf", [False, True])
def test_env_path_bounces(env_scene, bsdf, depth):
    """Every env path runs bounce 0, depth 0 included, and none runs past
    max(depth, 1); the counts sum to "bounces"."""
    ss, cam, env = env_scene
    st = _bounces(ss, cam, 8, 3, depth, bsdf=bsdf, env=env)
    pb = st["path_bounces"]
    assert pb.dtype == torch.int32 and tuple(pb.shape) == (64, 3)
    assert int(pb.sum()) == st["bounces"]
    assert int(pb.min()) >= 1 and int(pb.max()) <= max(depth, 1)
    if depth <= 1:
        assert bool((pb == 1).all())
    else:   # some paths leave for the sky early, some scatter on
        assert int((pb == 1).sum()) > 0 and int((pb > 1).sum()) > 0


@pytest.mark.parametrize("env", [False, True])
def test_texture_path_bounces(env_scene, quad, env):
    """The dense texture forms count as the others do; the env map changes
    the radiance of a miss, not where a path ends."""
    ss, cam, tex = quad
    envt = env_scene[2] if env else None
    st = _bounces(ss, cam, 8, 4, 4, env=envt, tex=tex)
    pb = st["path_bounces"]
    assert int(pb.sum()) == st["bounces"]
    assert int(pb.min()) >= 1 and int(pb.max()) <= 4
    plain = _bounces(ss, cam, 8, 4, 4, tex=tex)["path_bounces"]
    assert torch.equal(pb, plain)


def test_env_loop_slots(env_scene):
    """The env scene at 16x16, 8 spp, depth 8: the useful slots are the
    counts' sum; the flat loop of 8 spp a launch wastes no more slots than
    the nested loop, which a launch of one sample is."""
    ss, cam, env = env_scene
    pb = _bounces(ss, cam, 16, 8, 8, env=env)["path_bounces"]
    one = pt_cuda.loop_slots(pb, 1)
    flat = pt_cuda.loop_slots(pb, 8, resident=64)
    assert flat["useful"] == one["useful"] == int(pb.sum())
    assert one["flat"] == one["nested"] == flat["nested"]
    assert flat["useful"] <= flat["flat"] <= flat["nested"]
    assert flat["flat_share"] >= flat["nested_share"]
    # 256 pixels: 8 warps; 64 resident lanes take them as they come free
    assert flat["useful"] <= flat["persistent"]
    assert 0.0 < flat["persistent_share"] <= 1.0


FORM_KEYS = sorted(pt_cuda.KERNELS)


@pytest.mark.parametrize("key", FORM_KEYS,
                         ids=[pt_cuda.KERNELS[k] for k in FORM_KEYS])
def test_launch_plan(key):
    """The forms without a mesh take the persistent grid and 256 spp a
    launch at 512x512 (1024 at 256x256); the mesh forms a plain grid and
    PIXEL_SAMPLES_PER_LAUNCH (32 spp at 512x512, 33 at 500x500)."""
    mesh = key[2]
    for size, dense_spp, mesh_spp in ((512, 256, 32), (500, 268, 33),
                                      (256, 1024, 128), (4096, 4, 1),
                                      (8192, 1, 1)):
        persistent, spp = pt_cuda.launch_plan(mesh, size * size)
        assert persistent is not mesh
        assert spp == (mesh_spp if mesh else dense_spp)


class _Lib:
    """The kernel library's C interface, recording each `nr_pt_render`
    launch instead of running it."""

    def __init__(self):
        self.calls = []

    def nr_pt_render(self, *a):
        self.calls.append({"pix0": a[6], "n_pix": a[7], "sp0": a[8],
                           "n_spp": a[9], "form": a[12],
                           "next_pixel": a[24] is not None,
                           "rec": a[25] is not None,
                           "loop_slots": a[26]})
        return 0


@pytest.mark.parametrize("key", FORM_KEYS,
                         ids=[pt_cuda.KERNELS[k] for k in FORM_KEYS])
def test_wrapper_follows_launch_plan(monkeypatch, env_scene, quad, key):
    """`_pt_accumulate_cuda` launches each form as `launch_plan` says: a
    pixel counter for the persistent grid, the float4 records for B1a
    alone, the spp split into its launch size, and the mesh forms' loop
    counters, one pair a device, the same at every launch."""
    bsdf, env, mesh, tex = key
    lib = _Lib()
    monkeypatch.setattr(pt_cuda, "_kernels", lambda: lib)
    monkeypatch.setattr(pt_cuda, "_LOOP_SLOTS", {})
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    if mesh:
        ss, cam, arrays = _scene("tex_grid.scn", "tex_grid.obj") if tex \
            else _scene("mesh_box.scn", "blob_960.obj")
        mt = mesh_cuda.make_mesh_tables(build_mesh_accel(
            arrays, make_mat_channels(ss)).bt, "cpu")
        tx = pt_cuda.make_tex_tables(arrays.textures, "cpu") if tex \
            else None
    else:
        ss, cam, tx = quad if tex else (*env_scene[:2], None)
        mt = None
    envt = env_scene[2] if env else None
    w, h, pix0, n_pix, spp = 512, 500, 512 * 7, 512 * 480, 1000
    film = torch.zeros((n_pix, 3))
    pt_cuda._pt_accumulate_cuda(film, ss, cam, w, h, 5, spp, 8, 0,
                                scene_epsilon(ss), pt_cuda.KERNELS[key],
                                bsdf, envt, mt, tx, pix0, n_pix)
    persistent, per = pt_cuda.launch_plan(mesh, n_pix)
    assert [(c["sp0"], c["n_spp"]) for c in lib.calls] == [
        (5 + s, min(per, spp - s)) for s in range(0, spp, per)]
    form = int(bsdf) | env << 1 | mesh << 2 | tex << 3
    for c in lib.calls:
        assert (c["pix0"], c["n_pix"], c["form"]) == (pix0, n_pix, form)
        assert c["next_pixel"] is persistent
        assert c["rec"] is (form == 0)
    counters = pt_cuda._LOOP_SLOTS.get("cpu")
    assert [c["loop_slots"] for c in lib.calls] == (
        [counters.data_ptr()] * len(lib.calls) if mesh
        else [None] * len(lib.calls))
    if mesh:
        assert counters.dtype == torch.int64 and tuple(counters.shape) == (2,)


def test_mesh_loop_slots_reader(monkeypatch):
    """The mesh forms' counter reader takes CUDA devices only, and gives
    nothing without a card or before a mesh launch on the device."""
    with pytest.raises(ValueError, match="CUDA device"):
        pt_cuda.mesh_loop_slots("cpu")
    monkeypatch.setattr(pt_cuda, "_LOOP_SLOTS", {})
    assert pt_cuda.mesh_loop_slots("cuda:0") is None
    if not torch.cuda.is_available():
        assert pt_cuda.mesh_loop_slots() is None
