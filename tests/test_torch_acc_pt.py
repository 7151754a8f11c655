"""AccPathTracer on analytic scenes: the BSDF and env-map forms of the port's
path-tracing kernel against the Pallas megakernel `_pt_kernel`, the
renderer and the CLI, checkpoint/resume, and the refusals.

On the CPU the port runs the kernel's plain torch version; the JAX side runs
`render_bsdf_pt_pallas` / `render_simple_pt_pallas` in TPU interpret mode
(as tests/test_pt_pallas.py runs them) on the same `StaticScene`, camera and
env map.  Both draw the same hash uniforms, so they agree pixel by pixel up
to rounding: >= 97% of pixels within 1e-4 at 1 spp and mean |d| <= 2e-3 at
16 spp, the bars of tests/test_torch_pt_kernel.py.

BSDF form (`resource/pt_glass_box.scn`, 16x16, depth 3): observed every
pixel within 5e-5.

Env forms (`resource/env_spheres.scn` under `make_env_sky`, 64x64, depth
3): the bounce-0 term is compared only where the Pallas kernel resolves it
in-kernel from its per-pixel windows (`_env_exact_args(...)[0]` is not
None, asserted below); the port reads the native texel the window holds.
The Pallas env film is (sum / spp) * spp, a few ulps off the sum.  Observed:
about 1% of paths flip at 64x64 (95-97% of pixels within 1e-4 at 4 spp,
mean |d| 2.7e-4).  Their cause: a diffuse ray leaving a sphere re-hits it
at t just above t_min (~1e-3 at these coordinates), a decision made by the
last bits of |oc|^2 - r^2, which the CPU backends round differently (XLA
contracts multiply-adds).  The same paths agree bit for bit between the
CUDA kernel and its plain version on the card.

The `cuda` tests need a GPU and skip without one; they import no JAX:
`python -m pytest tests/test_torch_acc_pt.py -m cuda`."""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from nrenderer_torch import build_scene_arrays, cli, load_scn
from nrenderer_torch.interop import camera_from_numpy, static_scene_from_numpy
from nrenderer_torch.io.image import read_png
from nrenderer_torch.ops import pt_cuda
from nrenderer_torch.ops.camera import make_camera
from nrenderer_torch.ops.intersect import make_static_scene
from nrenderer_torch.ops.pt_core import scene_epsilon
from nrenderer_torch.renderers.acc_pt import AccPathTracerRenderer
from nrenderer_torch.scene.model import (
    Material, Mesh, Node, NodeType, Property, PropertyType, Texture,
)

from test_torch_env import make_env_sky

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
GLASS = REPO / "resource" / "pt_glass_box.scn"
ENV = REPO / "resource" / "env_spheres.scn"
CORNELL = REPO / "resource" / "cornell_box.scn"
ENV_PNG = REPO / "resource" / "env_sky.png"
GLASS_SHAPE = (16, 16, 3)   # width, height, depth
ENV_SHAPE = (64, 64, 3)


def _env_map() -> np.ndarray:
    return make_env_sky().astype(np.float32) / 255.0


@pytest.fixture(scope="module")
def pallas():
    """Pallas interpret renders, cached by (scene, bsdf, env, spp): the
    gamma'd (H, W, 3) image, row 0 = bottom, and the port's inputs."""
    pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu
    import nrenderer_tpu as T
    from nrenderer_tpu.ops.camera import make_camera as jax_make_camera
    from nrenderer_tpu.ops.intersect import make_static_scene as jax_mss
    from nrenderer_tpu.ops import pt_pallas
    cache = {}

    def render(path, bsdf, env, spp):
        key = (path, bsdf, env, spp)
        if key not in cache:
            w, h, depth = ENV_SHAPE if env else GLASS_SHAPE
            scene = T.load_scn(str(path))
            jss = jax_mss(T.build_scene_arrays(scene))
            jcam = jax_make_camera(scene.camera)
            emap = _env_map() if env else None
            if env:
                exact, _ = pt_pallas._env_exact_args(
                    emap, pt_pallas._camera_tuple(jcam), w, h)
                assert exact is not None  # bounce 0 resolved in-kernel
            fn = (pt_pallas.render_bsdf_pt_pallas if bsdf
                  else pt_pallas.render_simple_pt_pallas)
            with pltpu.force_tpu_interpret_mode():
                want = np.asarray(fn(jss, jcam, w, h, spp, depth, seed=0,
                                     env_map=emap))
            cache[key] = (want, static_scene_from_numpy(jss),
                          camera_from_numpy(jcam, device="cpu"), emap)
        return cache[key]

    return render


def _port(ss, cam, emap, bsdf, shape, spp):
    w, h, depth = shape
    fn = pt_cuda.render_bsdf_pt if bsdf else pt_cuda.render_simple_pt
    return fn(ss, cam, w, h, spp, depth, seed=0, env_map=emap,
              device="cpu").numpy()


def _stats(got, want):
    d = np.abs(got - want)
    pix = d.max(axis=-1)
    return {"max": float(d.max()), "mean": float(d.mean()),
            "within_1e-4": float((pix <= 1e-4).mean())}


@pytest.mark.parametrize("spp", [1, 16])
def test_bsdf_form_matches_pallas_kernel(pallas, spp):
    want, ss, cam, _ = pallas(GLASS, True, False, spp)
    assert sorted({int(m["type"]) for m in ss.mats}) == [0, 1, 2, 3, 4]
    got = _port(ss, cam, None, True, GLASS_SHAPE, spp)
    st = _stats(got, want)
    print(f"bsdf form, {spp} spp, plain vs _pt_kernel (interpret):", st)
    assert got.shape == want.shape == (16, 16, 3)
    assert np.isfinite(got).all() and want.max() > 0.5
    assert st["within_1e-4"] >= 0.97
    if spp > 1:
        assert st["mean"] <= 2e-3


@pytest.mark.parametrize("spp", [1, 16])
@pytest.mark.parametrize("bsdf", [False, True], ids=["diffuse", "bsdf"])
def test_env_forms_match_pallas_kernel(pallas, bsdf, spp):
    want, ss, cam, emap = pallas(ENV, bsdf, True, spp)
    got = _port(ss, cam, emap, bsdf, ENV_SHAPE, spp)
    st = _stats(got, want)
    print(f"env form, bsdf={bsdf}, {spp} spp, plain vs _pt_kernel:", st)
    assert np.isfinite(got).all() and want.mean() > 0.3
    if spp == 1:
        assert st["within_1e-4"] >= 0.97
    else:
        assert st["mean"] <= 2e-3


def _cli(args, timeout=300):
    return subprocess.run([sys.executable, "-m", "nrenderer_torch", "render",
                           *args], cwd=REPO, capture_output=True, text=True,
                          timeout=timeout)


@pytest.mark.parametrize("which", ["glass", "env"])
def test_cli_acc_pt_matches_pallas_image(pallas, tmp_path, which):
    """`python -m nrenderer_torch render --renderer AccPathTracer --device
    cpu` writes the Pallas kernel's image, flipped to row 0 = top and
    clipped, up to the 8-bit PNG and the flips above: at 16 spp the bar is
    mean |d| <= 2e-3 (plus half a PNG step), and since a pixel draws 16
    paths, the ~1% of flipped paths on the env scene touch ~5% of its
    pixels (observed 95.4% exact), so >= 90% of pixels must be exact."""
    env = which == "env"
    w, h, depth = ENV_SHAPE if env else GLASS_SHAPE
    want = pallas(ENV if env else GLASS, True, env, 16)[0]
    out = tmp_path / f"{which}.png"
    args = ["--scene", str(ENV if env else GLASS), "--renderer",
            "AccPathTracer", "--width", str(w), "--height", str(h), "--spp",
            "16", "--depth", str(depth), "--device", "cpu", "--out", str(out)]
    if env:
        args += ["--env-map", str(ENV_PNG)]
    proc = _cli(args)
    assert proc.returncode == 0, proc.stderr
    assert "AccPathTracer[cpu]" in proc.stdout
    got = read_png(str(out))
    ref = np.clip(want[::-1], 0.0, 1.0)
    q = lambda a: (np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.int64)
    same = (q(got) == q(ref)).all(axis=-1)
    print(which, "CLI png vs Pallas image: exact share", same.mean(),
          "mean |d|", np.abs(got - ref).mean())
    assert same.mean() >= 0.9
    assert np.abs(got - ref).mean() <= 2e-3 + 0.5 / 255


def _render(scene_path, w, h, spp, depth, env=False, **kw):
    scene = load_scn(str(scene_path))
    ro = scene.render_option
    ro.width, ro.height, ro.samples_per_pixel, ro.depth = w, h, spp, depth
    if env:
        _attach_env(scene)
    comp = AccPathTracerRenderer(device="cpu", **kw)
    return comp.render(scene).pixels


def _attach_env(scene):
    from nrenderer_torch.scene.model import AmbientType
    pixels = np.concatenate([_env_map(), np.ones((256, 512, 1), np.float32)],
                            axis=2)
    scene.ambient.environment_map = len(scene.textures)
    scene.textures.append(Texture(name="sky", pixels=pixels))
    scene.ambient.type = AmbientType.ENVIRONMENT_MAP


@pytest.mark.parametrize("env", [False, True])
def test_checkpoint_interrupted_and_resumed_equals_uninterrupted(
        tmp_path, monkeypatch, env):
    """A --checkpoint render that dies after two of its eight passes and is
    run again resumes from the saved film and ends with the image of the
    render that was never interrupted."""
    from nrenderer_torch.renderers import routes
    scene = ENV if env else GLASS
    whole = _render(scene, 12, 10, 16, 3, env=env, seed=3,
                    checkpoint_path=str(tmp_path / "whole.npz"))
    assert routes.checkpoint_pass_spp(16) == 2
    real = routes.pt_accumulate
    calls = []

    def dies_on_third(*args, **kw):
        calls.append(args[8])          # the pass's seed
        if len(calls) == 3:
            raise KeyboardInterrupt("interrupted")
        return real(*args, **kw)

    ckpt = tmp_path / "film.npz"
    monkeypatch.setattr(routes, "pt_accumulate", dies_on_third)
    with pytest.raises(KeyboardInterrupt):
        _render(scene, 12, 10, 16, 3, env=env, seed=3,
                checkpoint_path=str(ckpt))
    assert calls == [300009, 300010, 300011]   # seed * 100003 + step
    from nrenderer_torch.server.checkpoint import load_checkpoint
    assert int(np.load(ckpt)["spp_done"]) == 4
    monkeypatch.setattr(routes, "pt_accumulate", real)
    resumed = _render(scene, 12, 10, 16, 3, env=env, seed=3,
                      checkpoint_path=str(ckpt))
    np.testing.assert_array_equal(resumed, whole)
    assert load_checkpoint(str(ckpt), "not the fingerprint") is None
    # the one-pass render is the same estimator up to the passes' seeds
    assert np.isfinite(whole).all() and whole[..., :3].mean() > 0.05


def test_cli_checkpoint_route(tmp_path):
    out, ckpt = tmp_path / "c.png", tmp_path / "c.npz"
    args = ["render", "--scene", str(GLASS), "--renderer", "AccPathTracer",
            "--width", "8", "--height", "8", "--spp", "8", "--depth", "2",
            "--device", "cpu", "--checkpoint", str(ckpt), "--out", str(out)]
    assert cli.main(args) == 0
    assert ckpt.exists() and out.exists()
    assert cli.main(args) == 0   # resumes at 8/8 spp: nothing left to run


def _mesh_scene(n_tris: int, textured: bool):
    """pt_glass_box.scn plus a fan of `n_tris` triangles as one mesh,
    UV-mapped onto a texture when `textured`."""
    scene = load_scn(str(GLASS))
    k = np.arange(n_tris + 1)
    ring = np.stack([60 * np.cos(k * 0.05), 60 * np.sin(k * 0.05) - 100,
                     np.full(k.shape, 1100.0)], axis=1)
    pos = np.concatenate([[[0.0, -100.0, 1050.0]], ring]).astype(np.float32)
    idx = np.stack([np.zeros(n_tris), k[:-1] + 1, k[1:] + 1], 1).reshape(-1)
    mesh = Mesh(positions=pos, position_indices=idx.astype(np.int32),
                material=0)
    if textured:
        scene.textures.append(Texture(name="t", pixels=np.ones(
            (2, 2, 4), np.float32)))
        mat = Material(name="Tex")
        mat.register_property(Property("diffuseMap", PropertyType.TEXTURE_ID,
                                       len(scene.textures) - 1))
        scene.materials.append(mat)
        mesh.material = len(scene.materials) - 1
        mesh.uvs = np.zeros((pos.shape[0], 2), np.float32)
        mesh.uv_indices = mesh.position_indices.copy()
    scene.mesh_buffer.append(mesh)
    scene.nodes.append(Node(name="fan", type=NodeType.MESH,
                            entity=len(scene.mesh_buffer) - 1))
    ro = scene.render_option
    ro.width, ro.height, ro.samples_per_pixel, ro.depth = 4, 4, 1, 1
    return scene


def test_refusals_name_the_roadmap_item():
    """Accelerated pools of more than MEGAMESH_MAX_TRIS = 1024 triangles and
    accelerated pools under an env map take the hybrid mesh route (they
    were refused until it was ported) and render; textured faces, pools of
    65 to 1024 triangles (the megamesh route) and acc_type 2 on a small
    pool render; acc_type 0 keeps a 65-triangle pool on the dense kernel,
    as in JAX.  The dense kernel itself still refuses a pool past its
    limit, naming the mesh routes."""
    from nrenderer_torch.renderers.routes import MEGAMESH_MAX_TRIS
    comp = AccPathTracerRenderer(device="cpu")
    px = comp.render(_mesh_scene(3, textured=True)).pixels
    assert px.shape == (4, 4, 4) and np.isfinite(px).all()
    big = _mesh_scene(65, textured=False)
    assert np.isfinite(comp.render(big).pixels).all()
    one = _mesh_scene(1, textured=False)
    one.render_option.acc_type = 2     # accelerate any triangle pool
    assert np.isfinite(comp.render(one).pixels).all()
    huge = _mesh_scene(MEGAMESH_MAX_TRIS + 1, textured=False)
    px = comp.render(huge).pixels
    assert px.shape == (4, 4, 4) and np.isfinite(px).all()
    _attach_env(big)
    px = comp.render(big).pixels
    assert px.shape == (4, 4, 4) and np.isfinite(px).all()
    big = _mesh_scene(65, textured=False)
    big.render_option.acc_type = 0
    px = comp.render(big).pixels
    assert px.shape == (4, 4, 4) and np.isfinite(px).all()
    ss = make_static_scene(build_scene_arrays(_mesh_scene(3, True)))
    pt_cuda.check_supported(ss)   # textured faces: the texture form
    many = ss._replace(tri_uv=(), tri=ss.tri * 700)
    with pytest.raises(NotImplementedError, match="hybrid mesh route"):
        pt_cuda.check_supported(many)


@pytest.mark.parametrize("args", [
    ["--device", "cuda"],
    ["--env-map", "does/not/exist.png"],
    ["--obj", "does/not/exist.obj"],
])
def test_cli_errors_exit_2(tmp_path, args):
    if "cuda" in args and torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda renders there")
    base = ["render", "--scene", str(ENV), "--renderer", "AccPathTracer",
            "--width", "4", "--height", "4", "--spp", "1", "--depth", "1",
            "--device", "cpu", "--out", str(tmp_path / "x.png")]
    assert cli.main(base + args) == 2
    assert not (tmp_path / "x.png").exists()


def test_cli_refused_scene_exits_2(tmp_path):
    """65 triangles in a .scn under an env map: an accelerated pool with
    an env map, the hybrid mesh route's (it exited 2 before that route was
    ported); it renders, and without the env map the megamesh route
    renders it."""
    scn = tmp_path / "mesh.scn"
    tris = "".join(
        f"Triangle T{i} White\nV1 {i} 0 500\nV2 {i + 1} 0 500\n"
        f"V3 {i} 1 500\nN 0 0 -1\n" for i in range(65))
    scn.write_text(GLASS.read_text().replace(
        "Model Tetrahedron", f"Model Fan\n{tris}\nModel Tetrahedron"))
    out = tmp_path / "x.png"
    argv = ["render", "--scene", str(scn), "--renderer", "AccPathTracer",
            "--width", "4", "--height", "4", "--spp", "1", "--depth", "1",
            "--device", "cpu", "--out", str(out)]
    assert cli.main(argv + ["--env-map", str(ENV_PNG)]) == 0
    assert out.exists() and np.isfinite(read_png(str(out))).all()
    out.unlink()
    assert cli.main(argv) == 0 and out.exists()


def test_simple_pt_renders_env_scenes(tmp_path):
    """SimplePathTracer hands an env-map ambient to the kernel's env form
    (its result: the diffuse env form, held against Pallas above)."""
    out = tmp_path / "s.png"
    rc = cli.main(["render", "--scene", str(ENV), "--env-map", str(ENV_PNG),
                   "--renderer", "SimplePathTracer", "--width", "16",
                   "--height", "12", "--spp", "2", "--depth", "2",
                   "--device", "cpu", "--out", str(out)])
    assert rc == 0
    img = read_png(str(out))
    assert img.shape == (12, 16, 3) and img[:3].mean() > 0.7   # the sky


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _gpu_inputs(path, env, gpu):
    from nrenderer_torch.io.image import load_image
    scene = load_scn(str(path))
    ss = make_static_scene(build_scene_arrays(scene))
    emap = load_image(str(ENV_PNG))[:, :, :3] if env else None
    return ss, make_camera(scene.camera, device=gpu), emap


@pytest.mark.cuda
@pytest.mark.parametrize("form", [(GLASS, True, False), (ENV, False, True),
                                  (ENV, True, True)],
                         ids=["bsdf", "diffuse+env", "bsdf+env"])
def test_cuda_forms_match_plain(gpu, form):
    """chip_smoke.py's phase 4 at 64x64, 16 spp, depth 4 for the new
    instantiations, with its bars (bit-exact on an H100)."""
    path, bsdf, env = form
    ss, cam, emap = _gpu_inputs(path, env, gpu)
    t_min = scene_epsilon(ss)
    name = pt_cuda.kernel_name(bsdf, env)
    before = pt_cuda.KERNEL_LAUNCHES[name]
    lin_k = pt_cuda.render_pt_linear(ss, cam, 64, 64, 16, 4, bsdf=bsdf,
                                     env_map=emap, device=gpu)
    assert pt_cuda.KERNEL_LAUNCHES[name] == before + 1
    tables = pt_cuda.make_env_tables(emap, gpu) if env else None
    lin_p = pt_cuda.pt_accumulate_plain(
        torch.zeros((64 * 64, 3), device=gpu), ss, cam, 64, 64, 0, 16, 4, 0,
        t_min, bsdf=bsdf, env=tables)
    img = lambda f: torch.sqrt(torch.clamp(f * (1.0 / 16), min=0.0))
    d = (img(lin_k) - img(lin_p)).abs()
    assert torch.isfinite(lin_k).all()
    assert float(d.mean()) <= 2e-3
    assert float((d.max(dim=1).values <= 1e-4).float().mean()) >= 0.995


@pytest.mark.cuda
def test_cuda_diffuse_form_still_bit_exact(gpu):
    """The templated kernel's diffuse, no-env instantiation gives its plain
    version's film bit for bit on the Cornell box at 64x64, 16 spp, depth 4,
    as the kernel before the BSDF and env forms did."""
    ss, cam, _ = _gpu_inputs(CORNELL, False, gpu)
    t_min = scene_epsilon(ss)
    lin_k = pt_cuda.render_pt_linear(ss, cam, 64, 64, 16, 4, device=gpu)
    lin_p = pt_cuda.pt_accumulate_plain(
        torch.zeros((64 * 64, 3), device=gpu), ss, cam, 64, 64, 0, 16, 4, 0,
        t_min)
    assert torch.equal(lin_k, lin_p)


@pytest.mark.cuda
def test_cuda_acc_pt_runs_only_the_kernel(gpu):
    """AccPathTracer on the card launches the BSDF instantiations and
    nothing else renders: no plain fallback."""
    pt_cuda.reset_launch_counts()
    for path, env, name in ((GLASS, False, "pt_bsdf_kernel"),
                            (ENV, True, "pt_bsdf_env_kernel")):
        scene = load_scn(str(path))
        if env:
            _attach_env(scene)
        ro = scene.render_option
        ro.width, ro.height, ro.samples_per_pixel, ro.depth = 32, 24, 8, 4
        px = AccPathTracerRenderer(device="cuda").render(scene).pixels
        assert np.isfinite(px).all()
        assert pt_cuda.KERNEL_LAUNCHES[name] == 1
    assert pt_cuda.KERNEL_LAUNCHES["pt_diffuse_kernel"] == 0


def test_cli_material_knobs_and_env_map_reach_the_scene():
    """--roughness/--f0/--metalness override every material (as the JAX
    CLI sets RenderOption), --env-map makes the ambient an env map."""
    import argparse
    from nrenderer_torch.scene.arrays import (
        MAT_F0, MAT_METALNESS, MAT_ROUGHNESS)
    args = argparse.Namespace(scene=str(GLASS), width=8, height=6, depth=2,
                              spp=1, roughness=0.5, f0=None, metalness=0.7,
                              env_map=str(ENV_PNG))
    arrays = build_scene_arrays(cli._build_scene(args))
    assert (arrays.mat_params[:, MAT_ROUGHNESS] == 0.5).all()
    assert (arrays.mat_params[:, MAT_METALNESS] == np.float32(0.7)).all()
    assert (arrays.mat_params[:, MAT_F0] == np.float32(0.04)).all()
    assert int(np.asarray(arrays.ambient_type).reshape(())) == 1
    np.testing.assert_array_equal(arrays.env_map,
                                  make_env_sky().astype(np.float32) / 255.0)
