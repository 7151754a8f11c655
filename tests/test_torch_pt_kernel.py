"""The slice's kernel function: the port's diffuse path tracer against the
Pallas megakernel `_pt_kernel`, and the CUDA kernel against its plain torch
version.

On the CPU `render_simple_pt(device="cpu")` runs the kernel's plain torch
version; the JAX side runs `render_simple_pt_pallas` in TPU interpret mode
(as tests/test_pt_pallas.py runs it), on the same `StaticScene` and camera
through `interop`.  Both draw the same hash uniforms, so they agree pixel by
pixel: >= 97% of pixels within 1e-4 at 1 spp and mean |d| <= 2e-3 at 16 spp
(a one-ulp difference can flip a path at an edge).  Observed on the CPU:
every pixel within 3e-6.

The `cuda` tests need a GPU and skip without one; they import no JAX, so
they run on a machine that has none:
`python -m pytest tests/test_torch_pt_kernel.py -m cuda`."""
import pathlib

import numpy as np
import pytest
import torch

import nrenderer_torch
from nrenderer_torch import build_scene_arrays, load_scn
from nrenderer_torch.interop import (
    camera_from_numpy, static_scene_from_numpy,
)
from nrenderer_torch.ops import pt_cuda
from nrenderer_torch.ops.camera import make_camera
from nrenderer_torch.ops.intersect import make_static_scene
from nrenderer_torch.ops.pt_core import hash_uniform, scene_epsilon

torch.set_num_threads(1)

SCENE = pathlib.Path(__file__).resolve().parent.parent / "resource" \
    / "cornell_box.scn"
W = H = 16
DEPTH = 3


@pytest.fixture(scope="module")
def cornell():
    """(JAX scene module, JAX Scene, JAX StaticScene, port StaticScene)."""
    pytest.importorskip("jax")
    import nrenderer_tpu as T
    from nrenderer_tpu.ops.intersect import make_static_scene as jax_mss
    scene = T.load_scn(str(SCENE))
    jss = jax_mss(T.build_scene_arrays(scene))
    return T, scene, jss, static_scene_from_numpy(jss)


@pytest.fixture(scope="module")
def port_scene():
    scene = load_scn(str(SCENE))
    return scene, make_static_scene(build_scene_arrays(scene))


def _pair(T, scene, jss, ss, spp, camera=None):
    from jax.experimental.pallas import tpu as pltpu
    from nrenderer_tpu.ops.camera import make_camera as jax_make_camera
    from nrenderer_tpu.ops.pt_pallas import render_simple_pt_pallas
    jcam = jax_make_camera(camera or scene.camera)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(render_simple_pt_pallas(jss, jcam, W, H, spp, DEPTH,
                                                  seed=0))
    got = pt_cuda.render_simple_pt(ss, camera_from_numpy(jcam, device="cpu"),
                                   W, H, spp, DEPTH, seed=0, device="cpu")
    assert tuple(got.shape) == want.shape == (H, W, 3)
    return got.numpy(), want


def _stats(got, want):
    d = np.abs(got - want)
    pix = d.max(axis=-1)
    return {"max": float(d.max()), "mean": float(d.mean()),
            "within_1e-4": float((pix <= 1e-4).mean())}


def test_plain_matches_pallas_kernel_1spp(cornell):
    got, want = _pair(*cornell, spp=1)
    st = _stats(got, want)
    print("spp=1 plain vs _pt_kernel (interpret):", st)
    assert np.isfinite(got).all()
    assert want.max() > 0.5  # some paths reach the light
    assert st["within_1e-4"] >= 0.97


def test_plain_matches_pallas_kernel_16spp(cornell):
    got, want = _pair(*cornell, spp=16)
    st = _stats(got, want)
    print("spp=16 plain vs _pt_kernel (interpret):", st)
    assert st["mean"] <= 2e-3
    assert st["within_1e-4"] >= 0.97


def test_plain_matches_pallas_kernel_thin_lens(cornell):
    """The camera's thin-lens draws (2 and 3) through both kernels."""
    T, scene = cornell[0], cornell[1]
    lens = T.Camera(**{**vars(scene.camera), "aperture": 20.0,
                       "focus_distance": 1000.0})
    got, want = _pair(*cornell, spp=4, camera=lens)
    st = _stats(got, want)
    print("spp=4 thin lens plain vs _pt_kernel (interpret):", st)
    assert st["mean"] <= 2e-3
    assert st["within_1e-4"] >= 0.97


# A scene with what the Cornell box lacks: several spheres, lights and
# materials, a tilted plane, no axis-aligned camera, a thin lens and a
# nonzero ambient constant (paths that survive the depth cap see it).
VARIETY_SCN = """
Begin Material
Material Grey
Prop diffuseColor RGB 0.6 0.6 0.6
Material Blue
Prop diffuseColor RGB 0.2 0.3 0.8
Material Orange
Prop diffuseColor RGB 0.9 0.5 0.1
End
Begin Model
Model Room
Plane Floor Grey
N 0 1 0
P -300 -100 300
U 600 0 0
V 0 0 600
Plane Back Grey
N 0 0 -1
P -300 -100 900
U 600 0 0
V 0 400 0
Plane Tilted Orange
N 0.6 0 -0.8
P -250 -100 500
U 0 200 0
V 160 0 120
Model Things
Translation 0 0 600
Sphere A Blue
P -80 -40 0
R 60
Sphere B Orange
P 90 -60 -50
R 40
Sphere C Grey
P 0 80 100
R 30
Triangle T1 Orange
V1 -150 -100 -100
V2 -50 -100 -150
V3 -100 50 -120
N 0 0.2 -0.98
Triangle T2 Blue
V1 100 0 100
V2 200 0 100
V3 150 100 50
N 0 0.45 -0.89
End
Begin Light
Area Top
IRV 20 20 20
P -150 250 450
U 300 0 0
V 0 0 300
Area Side
IRV 2 4 6
P 200 50 700
U 0 60 0
V 0 0 60
End
"""


def _variety(pkg):
    scene = pkg.parse_scn(VARIETY_SCN)
    cam = scene.camera
    cam.position, cam.look_at = (30.0, 20.0, 0.0), (0.0, 0.0, 600.0)
    cam.fov, cam.aperture, cam.focus_distance = 60.0, 8.0, 600.0
    scene.ambient.constant = (0.3, 0.4, 0.5)
    return scene


def test_plain_matches_pallas_kernel_variety_scene(cornell):
    """Several lights, spheres and materials, a thin lens and the ambient
    term, through both kernels (same bars as above)."""
    T = cornell[0]
    from nrenderer_tpu.ops.intersect import make_static_scene as jax_mss
    scene = _variety(T)
    jss = jax_mss(T.build_scene_arrays(scene))
    ss = static_scene_from_numpy(jss)
    assert len(ss.sph) == 3 and len(ss.al) == 2 and ss.ambient_constant[2]
    got, want = _pair(T, scene, jss, ss, spp=2)
    st = _stats(got, want)
    print("variety scene plain vs _pt_kernel (interpret):", st)
    assert want.mean() > 0.05
    assert st["mean"] <= 2e-3
    assert st["within_1e-4"] >= 0.97


def _cpu_setup(port_scene):
    scene, ss = port_scene
    return ss, make_camera(scene.camera, device="cpu")


def test_accumulate_in_chunks_equals_one_call(port_scene):
    """The film is a sum added sample by sample: consecutive sample ranges
    give the one-call sums bit for bit (the kernel launches in such
    chunks)."""
    ss, cam = _cpu_setup(port_scene)
    t_min = scene_epsilon(ss)
    one = pt_cuda.render_pt_linear(ss, cam, 8, 8, 7, DEPTH, seed=3,
                                   device="cpu")
    film = torch.zeros((64, 3))
    pt_cuda.pt_accumulate(film, ss, cam, 8, 8, 0, 3, DEPTH, 3, t_min)
    pt_cuda.pt_accumulate(film, ss, cam, 8, 8, 3, 4, DEPTH, 3, t_min)
    assert torch.equal(film, one)
    img = pt_cuda.render_simple_pt(ss, cam, 8, 8, 7, DEPTH, seed=3,
                                   device="cpu")
    assert torch.equal(img, torch.sqrt(one * (1.0 / 7)).reshape(8, 8, 3))


def test_pack_scene_layout(port_scene):
    """The table the kernel reads: strides, counts, float32 constants."""
    ss = port_scene[1]
    table, counts = pt_cuda.pack_scene(ss)
    assert counts == (1, 4, 11, 1, 3)
    assert table.dtype == np.float32
    assert table.size == pt_cuda.table_size(counts)
    cx, cy, cz, r, m = ss.sph[0]
    np.testing.assert_array_equal(
        table[:6], np.float32([cx, cy, cz, r * r, 1.0 / r, m]))
    np.testing.assert_array_equal(table[-3:],
                                  np.float32(ss.ambient_constant))


@pytest.mark.parametrize("scene_name", ["cornell_box.scn",
                                        "pt_glass_box.scn"])
def test_dense_records_hold_the_table(scene_name):
    """The dense forms' float4 records: each primitive's row of
    `pack_scene`'s table, in its order, padded with zeros to whole float4s
    (spheres 2, triangles, planes and lights 4)."""
    scene = load_scn(str(SCENE.parent / scene_name))
    ss = make_static_scene(build_scene_arrays(scene))
    table, counts = pt_cuda.pack_scene(ss)
    rec = pt_cuda.dense_records(table, counts)
    assert rec.dtype == np.float32 and rec.size % 4 == 0
    at_t, at_r = 0, 0
    for n, stride, recs in zip(counts[:4], (6, 13, 14, 16),
                               (pt_cuda.SPH_REC, pt_cuda.TRI_REC,
                                pt_cuda.PLN_REC, pt_cuda.AL_REC)):
        for _ in range(n):
            row = rec[at_r:at_r + 4 * recs]
            np.testing.assert_array_equal(row[:stride],
                                          table[at_t:at_t + stride])
            assert not row[stride:].any()
            at_t, at_r = at_t + stride, at_r + 4 * recs
    # the material rows and the ambient follow the primitives in the table
    assert at_t == table.size - counts[4] * pt_cuda.MAT_STRIDE - 3
    assert rec.size == at_r + 4


def test_unported_forms_refuse(port_scene):
    """What the kernel refuses: dense triangle pools past the dense
    kernel's limit and env-map mesh scenes (AccPathTracer's mesh routes take
    them: the hybrid mesh route), and the mesh form of the diffuse
    estimator (no JAX renderer sends a mesh there).  The env-map and
    texture forms exist, so an env-map ambient and textured faces
    render."""
    ss, cam = _cpu_setup(port_scene)
    uv = ((0.0, 0.0, 1.0, 0.0, 0.0, 1.0, 0, -1),) * len(ss.tri)
    tex = (np.full((2, 2, 3), 0.5, np.float32),)
    img = pt_cuda.render_simple_pt(ss._replace(tri_uv=uv), cam, 4, 4, 1, 1,
                                   textures=tex, device="cpu")
    assert torch.isfinite(img).all()
    many = ss._replace(tri=ss.tri * (pt_cuda.MAX_TRIS // len(ss.tri) + 1))
    with pytest.raises(NotImplementedError, match="hybrid mesh route"):
        pt_cuda.render_simple_pt(many, cam, 4, 4, 1, 1, device="cpu")
    for bsdf, env in ((True, True), (False, False)):
        with pytest.raises(NotImplementedError, match="hybrid mesh route"):
            pt_cuda.kernel_name(bsdf, env, mesh=True)
    env = np.ones((4, 8, 3), np.float32)
    img = pt_cuda.render_simple_pt(ss._replace(ambient_type=1), cam, 4, 4, 1,
                                   1, env_map=env, device="cpu")
    assert torch.isfinite(img).all()


def test_hash_fill_cpu_is_hash_uniform():
    """On CPU tensors the device-hash wrapper is the plain hash."""
    cols = [torch.arange(-500, 500, dtype=torch.int32) * k for k in (1, 7,
                                                                     3, -11)]
    assert torch.equal(pt_cuda.hash_uniform_fill(*cols), hash_uniform(*cols))
    with pytest.raises(ValueError, match="int32"):
        pt_cuda.hash_uniform_fill(cols[0].long(), *cols[1:])


def test_bad_film_and_device_refused(port_scene):
    ss, cam = _cpu_setup(port_scene)
    with pytest.raises(ValueError, match="film"):
        pt_cuda.pt_accumulate(torch.zeros((10, 3), dtype=torch.float64), ss,
                              cam, 4, 4, 0, 1, 1, 0, 1e-3)
    with pytest.raises(ValueError, match="unsupported device"):
        pt_cuda.check_device("meta")
    for w, h, spp, depth in ((0, 4, 1, 1), (4, -1, 1, 1), (4, 4, 0, 1),
                             (4, 4, 1, -1)):
        with pytest.raises(ValueError):
            pt_cuda.render_simple_pt(ss, cam, w, h, spp, depth, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pt_cuda.render_simple_pt(ss, cam, 4, 4, 1, 1, device="cuda")


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(port_scene, gpu):
    """chip_smoke.py phase 4 at 64x64, 16 spp, depth 4: the kernel against
    its plain torch version on the same CUDA inputs, with its bars
    (bit-exact on an H100; the bars admit a few flipped paths)."""
    scene, ss = port_scene
    cam = make_camera(scene.camera, device=gpu)
    t_min = scene_epsilon(ss)
    before = pt_cuda.KERNEL_LAUNCHES["pt_diffuse_kernel"]
    lin_k = pt_cuda.render_pt_linear(ss, cam, 64, 64, 16, 4, device=gpu)
    assert pt_cuda.KERNEL_LAUNCHES["pt_diffuse_kernel"] > before
    lin_p = pt_cuda.pt_accumulate_plain(
        torch.zeros((64 * 64, 3), device=gpu), ss, cam, 64, 64, 0, 16, 4, 0,
        t_min)
    img = lambda f: torch.sqrt(torch.clamp(f * (1.0 / 16), min=0.0))
    d = (img(lin_k) - img(lin_p)).abs()
    assert torch.isfinite(lin_k).all()
    assert float(d.mean()) <= 2e-3
    assert float((d.max(dim=1).values <= 1e-4).float().mean()) >= 0.995


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["variety", "lights only"])
def test_cuda_kernel_matches_plain_other_scenes(gpu, which):
    """The kernel's other branches (lens, ambient, several lights, a scene
    with no primitives at all) against the plain version on the card."""
    from nrenderer_torch import parse_scn
    scene = _variety(nrenderer_torch)
    if which == "lights only":
        scene = parse_scn(VARIETY_SCN.split("Begin Model")[0]
                          + "Begin Light" + VARIETY_SCN.split("Begin Light")[1])
    ss = make_static_scene(build_scene_arrays(scene))
    cam = make_camera(scene.camera, device=gpu)
    t_min = scene_epsilon(ss)
    lin_k = pt_cuda.render_pt_linear(ss, cam, 64, 48, 8, 6, seed=11,
                                     t_min=t_min, device=gpu)
    lin_p = pt_cuda.pt_accumulate_plain(
        torch.zeros((64 * 48, 3), device=gpu), ss, cam, 64, 48, 0, 8, 6, 11,
        t_min)
    img = lambda f: torch.sqrt(torch.clamp(f * (1.0 / 8), min=0.0))
    d = (img(lin_k) - img(lin_p)).abs()
    assert torch.isfinite(lin_k).all()
    assert float(img(lin_k).mean()) > 0.0
    assert float(d.mean()) <= 2e-3
    assert float((d.max(dim=1).values <= 1e-4).float().mean()) >= 0.995


@pytest.mark.cuda
def test_cuda_kernel_chunks_and_errors(port_scene, gpu):
    """Launches over consecutive sample ranges sum to one call's film; a
    film on the wrong device or of the wrong shape is refused."""
    scene, ss = port_scene
    cam = make_camera(scene.camera, device=gpu)
    t_min = scene_epsilon(ss)
    one = pt_cuda.render_pt_linear(ss, cam, 32, 24, 9, 5, seed=7,
                                   t_min=t_min, device=gpu)
    film = torch.zeros((32 * 24, 3), device=gpu)
    pt_cuda.pt_accumulate(film, ss, cam, 32, 24, 0, 4, 5, 7, t_min)
    pt_cuda.pt_accumulate(film, ss, cam, 32, 24, 4, 5, 5, 7, t_min)
    assert torch.equal(film, one)
    with pytest.raises(ValueError, match="film"):
        pt_cuda.pt_accumulate(torch.zeros((10, 3), device=gpu), ss, cam, 32,
                              24, 0, 1, 1, 0, t_min)


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 1, 6])
@pytest.mark.parametrize("bsdf", [False, True])
def test_cuda_dense_forms_bit_exact_ragged(gpu, bsdf, depth):
    """The dense forms (pt_diffuse_kernel on the Cornell box, pt_bsdf_kernel
    on pt_glass_box.scn) against the plain version bit for bit at a ragged
    shape: 61x37 pixels (no multiple of 32), 33 spp split 20 + 13 (the
    second call from sp0 = 20), a thin lens and a nonzero ambient term."""
    scene = load_scn(str(SCENE.parent / ("pt_glass_box.scn" if bsdf
                                         else "cornell_box.scn")))
    scene.camera.aperture, scene.camera.focus_distance = 20.0, 1000.0
    ss = make_static_scene(build_scene_arrays(scene))._replace(
        ambient_constant=(0.3, 0.4, 0.5))
    cam = make_camera(scene.camera, device=gpu)
    t_min = scene_epsilon(ss)
    name = pt_cuda.kernel_name(bsdf, False)
    before = pt_cuda.KERNEL_LAUNCHES[name]
    film_k = torch.zeros((61 * 37, 3), device=gpu)
    film_p = torch.zeros((61 * 37, 3), device=gpu)
    for sp0, n in ((0, 20), (20, 13)):
        pt_cuda.pt_accumulate(film_k, ss, cam, 61, 37, sp0, n, depth, 5,
                              t_min, bsdf=bsdf)
        pt_cuda.pt_accumulate_plain(film_p, ss, cam, 61, 37, sp0, n, depth,
                                    5, t_min, bsdf=bsdf)
    assert pt_cuda.KERNEL_LAUNCHES[name] >= before + 2
    assert torch.isfinite(film_k).all() and float(film_k.mean()) > 0.0
    assert torch.equal(film_k, film_p)


ENV_TEX_FORMS = [(b, e, t) for t in (False, True) for e in (True, False)
                 for b in (False, True) if e or t]


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [0, 1, 6])
@pytest.mark.parametrize(
    "form", ENV_TEX_FORMS,
    ids=[pt_cuda.kernel_name(b, e, False, t) for b, e, t in ENV_TEX_FORMS])
def test_cuda_env_tex_forms_bit_exact(gpu, form, depth):
    """The env forms (env_spheres.scn under env_sky.png) and the dense
    texture forms (tex_quad.obj, with and without the map) on the flat
    loop against the plain version bit for bit: 64x64 at 16 spp, and at
    the ragged shape above (61x37, 33 spp split 20 + 13, a thin lens, a
    nonzero ambient) and a band of pixels [100, 1099) of it."""
    from nrenderer_torch import load_obj
    from nrenderer_torch.io.image import load_image
    bsdf, env, tex = form
    name = pt_cuda.kernel_name(bsdf, env, False, tex)
    res = SCENE.parent
    emap = load_image(str(res / "env_sky.png"))[:, :, :3]
    envt = pt_cuda.make_env_tables(emap, gpu) if env else None
    for lens, w, h, calls, band in ((False, 64, 64, ((0, 16),), None),
                                    (True, 61, 37, ((0, 20), (20, 13)),
                                     None),
                                    (True, 61, 37, ((0, 20), (20, 13)),
                                     (100, 999))):
        scene = load_scn(str(res / ("tex_grid.scn" if tex
                                    else "env_spheres.scn")))
        if tex:
            load_obj(str(res / "obj" / "tex_quad.obj"), scene, material=0)
        if lens:
            scene.camera.aperture, scene.camera.focus_distance = 20.0, 1000.0
        arrays = build_scene_arrays(scene)
        ss = make_static_scene(arrays)._replace(
            ambient_constant=(0.3, 0.4, 0.5))
        cam = make_camera(scene.camera, device=gpu)
        t_min = scene_epsilon(ss)
        tx = pt_cuda.make_tex_tables(arrays.textures, gpu) if tex else None
        pix0, n_pix = band or (0, w * h)
        before = pt_cuda.KERNEL_LAUNCHES[name]
        films = []
        for fn in (pt_cuda.pt_accumulate, pt_cuda.pt_accumulate_plain):
            film = torch.zeros((n_pix, 3), device=gpu)
            for sp0, n in calls:
                fn(film, ss, cam, w, h, sp0, n, depth, 5, t_min, bsdf=bsdf,
                   env=envt, tex=tx, pix0=pix0, n_pix=n_pix)
            films.append(film)
        assert pt_cuda.KERNEL_LAUNCHES[name] == before + len(calls)
        assert torch.isfinite(films[0]).all()
        assert float(films[0].mean()) > 0.0
        assert torch.equal(films[0], films[1]), (name, w, h, band)


@pytest.mark.cuda
def test_cuda_hash_bit_exact(gpu):
    rng = np.random.default_rng(0)
    i32 = np.iinfo(np.int32)
    cols = [torch.as_tensor(rng.integers(i32.min, i32.max, 1 << 16,
                                         endpoint=True).astype(np.int32),
                            device=gpu) for _ in range(4)]
    before = pt_cuda.HASH_LAUNCHES
    assert torch.equal(pt_cuda.hash_uniform_fill(*cols),
                       hash_uniform(*cols))
    assert pt_cuda.HASH_LAUNCHES == before + 1


def test_build_staleness_counts_sources_and_headers(tmp_path):
    """The library is rebuilt when it is missing or older than any
    `csrc/*.cu` or `csrc/*.cuh`; other files do not count."""
    import os
    from nrenderer_torch import _build
    src, lib = tmp_path / "csrc", tmp_path / "lib.so"
    src.mkdir()
    for name in ("a.cu", "b.cuh", "notes.txt"):
        (src / name).write_text("")
        os.utime(src / name, (1000, 1000))
    assert _build._stale(lib, src)          # no library yet
    lib.write_text("")
    os.utime(lib, (2000, 2000))
    assert not _build._stale(lib, src)
    os.utime(src / "notes.txt", (3000, 3000))
    assert not _build._stale(lib, src)
    os.utime(src / "b.cuh", (3000, 3000))   # a header edit rebuilds
    assert _build._stale(lib, src)
    os.utime(src / "b.cuh", (1000, 1000))
    os.utime(src / "a.cu", (2000, 2000))    # not newer: rebuilt too
    assert _build._stale(lib, src)
    names = [p.name for p in _build.sources() + _build.headers()]
    assert {"pt_kernel.cu", "mesh_sweep.cu", "mesh_sweep.cuh"} <= set(names)


@pytest.mark.cuda
@pytest.mark.parametrize("tex", [False, True], ids=["plain", "textured"])
def test_cuda_mesh_loop_slots(gpu, tex):
    """The mesh forms' loop counters (`pt_cuda.mesh_loop_slots`) over two
    launches at 37x23, 5 spp, depth 6 (`blob_960.obj` in `mesh_box.scn`,
    `tex_grid.obj` in `tex_grid.scn`): the films are the plain version's
    bit for bit, the live lane slots its bounces, all the slots those of
    the CPU model of the loop (`pt_cuda.loop_slots`' "grouped") on its
    path lengths; a reset reads them and starts again from zero."""
    from nrenderer_torch import load_obj
    from nrenderer_torch.ops.bvh import build_mesh_accel
    from nrenderer_torch.ops.mesh_cuda import make_mesh_tables
    from nrenderer_torch.ops.pt_core import make_mat_channels
    res = pathlib.Path(__file__).resolve().parent.parent / "resource"
    scene = load_scn(str(res / ("tex_grid.scn" if tex else "mesh_box.scn")))
    load_obj(str(res / "obj" / ("tex_grid.obj" if tex else "blob_960.obj")),
             scene, material=0)
    arrays = build_scene_arrays(scene)
    ss = make_static_scene(arrays)
    cam = make_camera(scene.camera, device=gpu)
    t_min = scene_epsilon(ss)
    m = make_mesh_tables(build_mesh_accel(arrays, make_mat_channels(ss)).bt,
                         gpu)
    tx = pt_cuda.make_tex_tables(arrays.textures, gpu) if tex else None
    w, h = 37, 23
    kw = dict(bsdf=True, mesh=m, tex=tx)
    pt_cuda.pt_accumulate(torch.zeros((w * h, 3), device=gpu), ss, cam, w,
                          h, 0, 1, 6, 0, t_min, **kw)
    pt_cuda.mesh_loop_slots(gpu, reset=True)
    st = {}
    lin_k = torch.zeros((w * h, 3), device=gpu)
    lin_p = torch.zeros((w * h, 3), device=gpu)
    for sp0, n in ((0, 2), (2, 3)):
        pt_cuda.pt_accumulate(lin_k, ss, cam, w, h, sp0, n, 6, 0, t_min, **kw)
        pt_cuda.pt_accumulate_plain(lin_p, ss, cam, w, h, sp0, n, 6, 0, t_min,
                                    stats=st, **kw)
    got = pt_cuda.mesh_loop_slots(gpu, reset=True)
    assert torch.equal(lin_k, lin_p)
    assert got["live"] == st["bounces"] > 0
    pb = st["path_bounces"]
    assert got["slots"] == sum(
        pt_cuda.loop_slots(pb[:, c0:c1], c1 - c0,
                           regen=pt_cuda.MESH_REGEN_EIGHTHS)["grouped"]
        for c0, c1 in ((0, 2), (2, 5)))
    assert got["live_share"] == got["live"] / got["slots"]
    assert pt_cuda.mesh_loop_slots(gpu)["slots"] == 0
