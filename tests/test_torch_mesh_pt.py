"""The mesh (B1e) and texture (B1d) forms of the port's path-tracing kernel
against the Pallas megakernel `_pt_kernel`, AccPathTracer's megamesh route,
its checkpoint, the CLI's `--obj`, and the refusals that remain.

On the CPU the port runs the kernel's plain torch version; the JAX side
runs `render_bsdf_pt_pallas(..., mesh_accel=, textures=)` and
`render_simple_pt_pallas(..., textures=)` in TPU interpret mode on the same
`StaticScene`, camera, blocked pool and textures.  Both draw the same hash
uniforms, so they agree pixel by pixel up to rounding; the bars are those
of the other kernel tests: at least 99% of pixels within 1e-4 on the
gamma'd image and mean |d| <= 2e-3.  Observed: every pixel within 5e-7
(mean |d| <= 3e-9) in every form below, at 16x16, 2 spp, depth 2 (64x64,
1 spp with an env map).

The Pallas sweep unrolls a whole block, so its interpret-mode compile
grows with the block: the JAX comparisons use 16-triangle blocks (5-7 s
each; 128-triangle blocks take 40-170 s).  The 128-triangle pool of the
renderer is held against the port's own brute-force dense form on the same
scene instead (JAX's argument at `tests/test_pt_pallas.py:95-118`).

The `cuda` tests need a GPU and skip without one: `python -m pytest
tests/test_torch_mesh_pt.py -m cuda`."""
import pathlib
import sys

import numpy as np
import pytest
import torch

import nrenderer_torch as P
from nrenderer_torch import cli
from nrenderer_torch.interop import camera_from_numpy, static_scene_from_numpy
from nrenderer_torch.io.image import read_png
from nrenderer_torch.ops import mesh_cuda, pt_cuda
from nrenderer_torch.ops.bvh import build_mesh_accel
from nrenderer_torch.ops.camera import make_camera
from nrenderer_torch.ops.intersect import make_static_scene
from nrenderer_torch.ops.pt_core import make_mat_channels, scene_epsilon
from nrenderer_torch.renderers.acc_pt import AccPathTracerRenderer
from test_torch_jax_native import jax_loader  # noqa: F401

# the JAX package's loader loads a build of this process's own
pytestmark = pytest.mark.usefixtures("jax_loader")

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = REPO / "resource"
OBJ = RES / "obj"
sys.path.insert(0, str(REPO / "tools"))
SHAPE = (16, 16, 2, 2)   # width, height, spp, depth
# the env forms: a film fine enough for the Pallas kernel's per-pixel
# bounce-0 env windows (`_env_exact_args`) to hold every camera ray
ENV_SHAPE = (64, 64, 1, 2)


def _env_map() -> np.ndarray:
    from test_torch_env import make_env_sky
    return make_env_sky().astype(np.float32) / 255.0


def _spec_mtl(tmp: pathlib.Path) -> pathlib.Path:
    """tex_quad with a material carrying map_Kd and map_Ks (the `stex`
    channel)."""
    (tmp / "tex_grid.png").write_bytes((OBJ / "tex_grid.png").read_bytes())
    (tmp / "spec.mtl").write_text("newmtl grid\nKd 1 1 1\nKs 0.8 0.8 0.8\n"
                                  "map_Kd tex_grid.png\nmap_Ks tex_grid.png\n")
    text = (OBJ / "tex_quad.obj").read_text().replace("tex_grid.mtl",
                                                      "spec.mtl")
    (tmp / "spec_quad.obj").write_text(text)
    return tmp / "spec_quad.obj"


def build(pkg, which, tmp=None):
    """A test scene in package `pkg`: 'blob' (mesh_box.scn + a 120-face
    blob), a textured fixture name, or 'spec_quad' (map_Ks)."""
    s = pkg.Scene()
    if which == "blob":
        import make_mesh_fixtures
        pkg.load_scn(str(RES / "mesh_box.scn"), s)
        verts, faces, _ = make_mesh_fixtures.uv_blob(rings=6, segs=12,
                                                     radius=150.0)
        s.mesh_buffer.append(pkg.Mesh(
            positions=verts.astype(np.float32),
            position_indices=faces.reshape(-1).astype(np.int32), material=0))
        s.nodes.append(pkg.Node(name="blob", type=pkg.NodeType.MESH,
                                entity=0))
        return s
    pkg.load_scn(str(RES / "tex_grid.scn"), s)
    path = _spec_mtl(tmp) if which == "spec_quad" else OBJ / f"{which}.obj"
    pkg.load_obj(str(path), s)
    if which == "spec_quad":   # plastic: map_Kd diffuse lobe, map_Ks mirror
        s.materials[-1].type = 4
    return s


@pytest.fixture(scope="module")
def pallas(tmp_path_factory):
    """Pallas interpret renders by form: the gamma'd image (row 0 =
    bottom) and the port's inputs for the same scene."""
    pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu
    import nrenderer_tpu as T
    from nrenderer_tpu.ops.bvh import build_mesh_accel as jbuild
    from nrenderer_tpu.ops.camera import make_camera as jcam
    from nrenderer_tpu.ops.intersect import make_static_scene as jmss
    from nrenderer_tpu.ops.pt_core import make_mat_channels as jmmc
    from nrenderer_tpu.ops import pt_pallas
    tmp = tmp_path_factory.mktemp("spec")

    def render(which, bsdf, mesh, env):
        w, h, spp, depth = ENV_SHAPE if env else SHAPE
        js = build(T, which, tmp)
        ja = T.build_scene_arrays(js)
        jss, jc = jmss(ja), jcam(js.camera)
        textures = ja.textures if jss.tri_uv else None
        emap = _env_map() if env else None
        jma = jbuild(ja, jmmc(jss), block=16) if mesh else None
        if env:
            exact, _ = pt_pallas._env_exact_args(
                emap, pt_pallas._camera_tuple(jc), w, h)
            assert exact is not None   # bounce 0 resolved in-kernel
        with pltpu.force_tpu_interpret_mode():
            if bsdf:
                want = pt_pallas.render_bsdf_pt_pallas(
                    jss, jc, w, h, spp, depth, seed=0, env_map=emap,
                    mesh_accel=jma, textures=textures)
            else:
                want = pt_pallas.render_simple_pt_pallas(
                    jss, jc, w, h, spp, depth, seed=0, env_map=emap,
                    textures=textures)
        ss = static_scene_from_numpy(jss)
        pma = None
        if mesh:
            pa = P.build_scene_arrays(build(P, which, tmp))
            pma = build_mesh_accel(pa, make_mat_channels(ss), block=16)
        return (np.asarray(want), ss, camera_from_numpy(jc, device="cpu"),
                emap, pma, textures)

    return render


def _stats(got, want):
    d = np.abs(got - want)
    pix = d.max(axis=-1)
    return {"max": float(d.max()), "mean": float(d.mean()),
            "within_1e-4": float((pix <= 1e-4).mean())}


FORMS = {   # id: (scene, bsdf, mesh, env)
    "bsdf_mesh": ("blob", True, True, False),
    "bsdf_mesh_tex": ("tex_grid", True, True, False),
    "diffuse_tex": ("tex_quad", False, False, False),
    "bsdf_tex_stex": ("spec_quad", True, False, False),
    "diffuse_env_tex": ("tex_quad", False, False, True),
    "bsdf_env_tex": ("spec_quad", True, False, True),
}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_forms_match_pallas_kernel(pallas, form):
    which, bsdf, mesh, env = FORMS[form]
    want, ss, cam, emap, pma, textures = pallas(which, bsdf, mesh, env)
    w, h, spp, depth = ENV_SHAPE if env else SHAPE
    fn = pt_cuda.render_bsdf_pt if bsdf else pt_cuda.render_simple_pt
    kw = {"mesh_accel": pma} if bsdf else {}
    got = fn(ss, cam, w, h, spp, depth, seed=0, env_map=emap,
             textures=textures, device="cpu", **kw).numpy()
    st = _stats(got, want)
    print(f"{form}: plain vs _pt_kernel (interpret):", st)
    assert got.shape == want.shape == (h, w, 3)
    assert np.isfinite(got).all() and want.max() > 0.1
    assert st["within_1e-4"] >= 0.99 and st["mean"] <= 2e-3
    if textures:
        assert ss.tri_uv
        if which == "spec_quad":
            assert len(make_mat_channels(ss)[0]) == 21   # the stex channel


def test_textures_change_the_image(pallas):
    """The texture form reads the map: the textured grid's left half is
    red and its right half green, where the untextured twin is grey."""
    w, h, spp, depth = 24, 24, 16, 2
    out = {}
    for name in ("tex_grid", "tex_grid_plain"):
        scene = build(P, name)
        arrays = P.build_scene_arrays(scene)
        ss = make_static_scene(arrays)
        textures = arrays.textures if ss.tri_uv else None
        out[name] = pt_cuda.render_bsdf_pt(
            ss, make_camera(scene.camera, device="cpu"), w, h, spp, depth,
            textures=textures, device="cpu").numpy()[::-1]
    tex, plain = out["tex_grid"], out["tex_grid_plain"]
    mid = slice(h // 3, 2 * h // 3)
    left, right = tex[mid, 4:w // 2 - 2], tex[mid, w // 2 + 2:-4]
    assert left[..., 0].mean() > 1.5 * left[..., 1].mean()
    assert right[..., 1].mean() > 1.5 * right[..., 0].mean()
    grey = plain[mid, 4:-4]
    assert abs(grey[..., 0].mean() - grey[..., 1].mean()) < 0.05


def _blob_inputs(device="cpu"):
    scene = P.Scene()
    P.load_scn(str(RES / "mesh_box.scn"), scene)
    P.load_obj(str(OBJ / "blob_960.obj"), scene, material=0)
    arrays = P.build_scene_arrays(scene)
    ss = make_static_scene(arrays)
    return scene, arrays, ss, make_camera(scene.camera, device=device)


def test_mesh_form_matches_brute_force_form():
    """The renderer's 128-triangle blocks on the 960-face blob: the mesh
    form against the dense form over the same triangles (the dense test
    folds zero terms and divides by det, the sweep multiplies by its
    inverse, so a few paths may flip at triangle edges)."""
    scene, arrays, ss, cam = _blob_inputs()
    w, h, spp, depth = 20, 20, 2, 3
    ma = build_mesh_accel(arrays, make_mat_channels(ss))
    assert (ma.bt.n_blocks, ma.bt.block) == (8, 128)
    got = pt_cuda.render_bsdf_pt(ss, cam, w, h, spp, depth, mesh_accel=ma,
                                 device="cpu").numpy()
    want = pt_cuda.render_bsdf_pt(ss, cam, w, h, spp, depth,
                                  device="cpu").numpy()
    st = _stats(got, want)
    print("mesh form vs dense form, blob_960:", st)
    assert st["mean"] <= 2e-3 and st["within_1e-4"] >= 0.97
    assert got.mean() > 0.05


def _render(scene, w, h, spp, depth, **kw):
    ro = scene.render_option
    ro.width, ro.height, ro.samples_per_pixel, ro.depth = w, h, spp, depth
    return AccPathTracerRenderer(device="cpu", **kw).render(scene).pixels


def test_megamesh_passes_and_checkpoint_resume(tmp_path, monkeypatch):
    """The megamesh route renders in passes of 32 spp with seeds
    seed * 100003 + step; a --checkpoint render that dies in its third
    pass resumes and ends with the image of the uninterrupted render."""
    from nrenderer_torch.renderers import acc_pt
    assert acc_pt.megamesh_pass_spp(128) == 32
    assert acc_pt.megamesh_pass_spp(24) == 8
    assert acc_pt.megamesh_pass_spp(7) == 1
    scene = _blob_inputs()[0]
    whole = _render(scene, 10, 8, 128, 2, seed=3)
    real = acc_pt.pt_accumulate
    calls = []

    def dies_on_third(*args, **kw):
        calls.append((args[8], kw["mesh"] is not None))
        if len(calls) == 3:
            raise KeyboardInterrupt("interrupted")
        return real(*args, **kw)

    ckpt = tmp_path / "film.npz"
    monkeypatch.setattr(acc_pt, "pt_accumulate", dies_on_third)
    with pytest.raises(KeyboardInterrupt):
        _render(scene, 10, 8, 128, 2, seed=3, checkpoint_path=str(ckpt))
    assert calls == [(300009, True), (300010, True), (300011, True)]
    assert int(np.load(ckpt)["spp_done"]) == 64
    monkeypatch.setattr(acc_pt, "pt_accumulate", real)
    resumed = _render(scene, 10, 8, 128, 2, seed=3,
                      checkpoint_path=str(ckpt))
    np.testing.assert_array_equal(resumed, whole)
    assert np.isfinite(whole).all() and whole[..., :3].mean() > 0.05


def _cli(tmp_path, *args):
    out = tmp_path / "x.png"
    rc = cli.main(["render", *args, "--width", "16", "--height", "12",
                   "--spp", "4", "--depth", "2", "--device", "cpu",
                   "--out", str(out)])
    return rc, out


def test_cli_obj_renders_the_mesh_route(tmp_path, capsys):
    rc, out = _cli(tmp_path, "--scene", str(RES / "mesh_box.scn"), "--obj",
                   str(OBJ / "blob_960.obj"), "--renderer", "AccPathTracer")
    assert rc == 0
    img = read_png(str(out))
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    assert 0.02 < img.mean() < 0.9
    # SimplePathTracer on the dense textured quad: red left, green right
    rc, out = _cli(tmp_path, "--scene", str(RES / "tex_grid.scn"), "--obj",
                   str(OBJ / "tex_quad.obj"))
    assert rc == 0
    img = read_png(str(out))
    assert img[3:9, 2:6, 0].mean() > img[3:9, 2:6, 1].mean()
    assert img[3:9, 10:14, 1].mean() > img[3:9, 10:14, 0].mean()


@pytest.mark.parametrize("case", ["over_1024", "env_map"])
def test_hybrid_scenes_exit_2_naming_the_slice(tmp_path, capsys, case):
    """More than 1024 triangles, or a mesh under an env map: the hybrid
    mesh route (these scenes exited 2 before it was ported); the CLI
    renders them, exits 0, writes the PNG and logs the route."""
    from nrenderer_torch.server.registry import get_server
    args = ["--scene", str(RES / "mesh_box.scn"), "--renderer",
            "AccPathTracer"]
    if case == "over_1024":
        args += ["--obj", str(OBJ / "ico_5120.obj")]
    else:
        args += ["--obj", str(OBJ / "blob_960.obj"), "--env-map",
                 str(RES / "env_sky.png")]
    get_server().logger.clear()
    rc, out = _cli(tmp_path, *args)
    assert rc == 0 and out.exists()
    img = read_png(str(out))
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    assert 0.02 < img.mean() < 0.95
    log = " | ".join(m.content for m in get_server().logger.get())
    assert "hybrid mesh route" in log
    assert ("env map" in log) == (case == "env_map")


def test_cli_bad_obj_exits_2(tmp_path, capsys):
    bad = tmp_path / "quad.obj"
    bad.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
    rc, out = _cli(tmp_path, "--obj", str(bad))
    assert rc == 2 and "Triangulated" in capsys.readouterr().err


def test_textures_dropped_for_a_pool_without_uvs():
    """A textured material on a mesh without UVs: the pool has no UV
    tables and the render runs the untextured mesh form, as JAX drops
    the textures (`acc_pt.py:309-310`)."""
    scene, arrays, ss, cam = _blob_inputs()
    ma = build_mesh_accel(arrays, make_mat_channels(ss))
    assert ma.bt.tex is None
    tex = (np.ones((4, 4, 3), np.float32),)
    a = pt_cuda.render_bsdf_pt(ss, cam, 6, 6, 1, 2, mesh_accel=ma,
                               textures=tex, device="cpu")
    b = pt_cuda.render_bsdf_pt(ss, cam, 6, 6, 1, 2, mesh_accel=ma,
                               device="cpu")
    assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="hybrid mesh route"):
        pt_cuda.render_bsdf_pt(ss, cam, 6, 6, 1, 2, mesh_accel=ma,
                               env_map=np.ones((4, 8, 3), np.float32),
                               device="cpu")


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _gpu_form(which, gpu, tmp):
    scene = build(P, which, tmp) if which != "blob_960" else \
        _blob_inputs()[0]
    arrays = P.build_scene_arrays(scene)
    ss = make_static_scene(arrays)
    return arrays, ss, make_camera(scene.camera, device=gpu)


def _tie_box(gpu):
    """`mesh_box.scn` with `chip_smoke.tie_pool()`'s cube (a triangle of it
    repeated 20 times, faces on block boxes) scaled to the blob's place in
    place of the blob."""
    sys.path.insert(0, str(REPO))
    from chip_smoke import tie_pool
    verts, faces, _, _ = tie_pool()
    scene = _blob_inputs()[0]
    blob = scene.mesh_buffer[0].positions
    centre = (blob.max(axis=0) + blob.min(axis=0)) / 2
    size = float((blob.max(axis=0) - blob.min(axis=0)).max())
    scene.mesh_buffer[0].positions = (
        verts * (size / 16.0) + centre).astype(np.float32)
    scene.mesh_buffer[0].position_indices = faces.reshape(-1)
    arrays = P.build_scene_arrays(scene)
    ss = make_static_scene(arrays)
    return arrays, ss, make_camera(scene.camera, device=gpu)


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(pt_cuda.KERNELS.values()))
def test_cuda_forms_match_plain(gpu, tmp_path, form):
    """Every instantiation against its plain version at 64x64, 16 spp,
    depth 4 (chip_smoke.py's bars; bit-exact on an H100 so far).  The mesh
    forms bit for bit, also at 37x23 (a warp past the image's last pixel
    helps the others' sweeps) and, untextured, on the tie pool's cube."""
    key = next(k for k, v in pt_cuda.KERNELS.items() if v == form)
    bsdf, env, mesh, tex = key
    which = ("tex_grid" if mesh and tex else "blob_960" if mesh
             else "spec_quad" if tex and bsdf else "tex_quad" if tex
             else "blob")
    if not (mesh or tex):
        pytest.skip("the analytic forms are held in test_torch_acc_pt.py")
    arrays, ss, cam = _gpu_form(which, gpu, tmp_path)
    t_min = scene_epsilon(ss)
    m = (mesh_cuda.make_mesh_tables(
        build_mesh_accel(arrays, make_mat_channels(ss)).bt, gpu)
        if mesh else None)
    tx = pt_cuda.make_tex_tables(arrays.textures, gpu) if tex else None
    envt = pt_cuda.make_env_tables(_env_map(), gpu) if env else None
    before = pt_cuda.KERNEL_LAUNCHES[form]
    film = torch.zeros((64 * 64, 3), device=gpu)
    lin_k = pt_cuda.pt_accumulate(film, ss, cam, 64, 64, 0, 16, 4, 0, t_min,
                                  bsdf=bsdf, env=envt, mesh=m, tex=tx)
    assert pt_cuda.KERNEL_LAUNCHES[form] == before + 1
    lin_p = pt_cuda.pt_accumulate_plain(
        torch.zeros((64 * 64, 3), device=gpu), ss, cam, 64, 64, 0, 16, 4, 0,
        t_min, bsdf=bsdf, env=envt, mesh=m, tex=tx)
    img = lambda f: torch.sqrt(torch.clamp(f * (1.0 / 16), min=0.0))
    d = (img(lin_k) - img(lin_p)).abs()
    assert torch.isfinite(lin_k).all() and float(img(lin_k).mean()) > 0.01
    assert float(d.mean()) <= 2e-3
    assert float((d.max(dim=1).values <= 1e-4).float().mean()) >= 0.995
    if not mesh:
        return
    assert torch.equal(lin_k, lin_p)
    cases = [(arrays, ss, cam, 37, 23, 5, 6)]
    if not tex:
        cases.append((*_tie_box(gpu), 40, 30, 4, 5))
    for arrays, ss, cam, w, h, spp, depth in cases:
        t_min = scene_epsilon(ss)
        m = mesh_cuda.make_mesh_tables(
            build_mesh_accel(arrays, make_mat_channels(ss)).bt, gpu)
        films = [fn(torch.zeros((w * h, 3), device=gpu), ss, cam, w, h, 0,
                    spp, depth, 0, t_min, bsdf=bsdf, env=envt, mesh=m, tex=tx)
                 for fn in (pt_cuda.pt_accumulate,
                            pt_cuda.pt_accumulate_plain)]
        assert torch.equal(films[0], films[1]), (w, h)


@pytest.mark.cuda
def test_cuda_megamesh_route_runs_only_the_kernel(gpu):
    pt_cuda.reset_launch_counts()
    scene = _blob_inputs()[0]
    ro = scene.render_option
    ro.width, ro.height, ro.samples_per_pixel, ro.depth = 32, 24, 64, 4
    px = AccPathTracerRenderer(device="cuda").render(scene).pixels
    assert np.isfinite(px).all()
    assert pt_cuda.KERNEL_LAUNCHES["pt_bsdf_mesh_kernel"] == 2
    assert sum(pt_cuda.KERNEL_LAUNCHES.values()) == 2
