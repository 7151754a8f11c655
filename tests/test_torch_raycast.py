"""RayCast, GeometryPreview and Example: the port's renderers against the
JAX package's on the same scene arrays and camera.

RayCast and GeometryPreview are torch ops over the SoA intersect; JAX
runs them as one jitted XLA graph, whose fused multiply-adds move t and
the hit point by an ulp or so.  A pixel whose primary or shadow ray
passes a primitive's edge within that rounding can flip: against the
jitted JAX function the images are held at mean |d| <= 2e-3 with >= 99%
of pixels within 1e-4 (read at 48x48 on the Cornell box with a point
light: RayCast 99.5%, GeometryPreview 99.7%); against the same function
run op by op (`jax.disable_jit()`, no fusion) at >= 99.8% of pixels
within 1e-5 (read: 99.91%, 99.87%).  Example is numpy only: equal.  Mesh
decimation gives the JAX package's face lists exactly."""
import pathlib

import numpy as np
import pytest
import torch

import nrenderer_torch as P
from nrenderer_torch.interop import camera_from_numpy
from nrenderer_torch.renderers import example as port_example
from nrenderer_torch.renderers.preview import (
    GeometryPreviewRenderer, preview_scene, preview_size, render_preview,
)
from nrenderer_torch.renderers.raycast import RayCastRenderer, render_raycast
from nrenderer_torch.server.manager import ComponentManager
from test_torch_jax_native import jax_loader  # noqa: F401

# the JAX package's loader loads a build of this process's own
pytestmark = pytest.mark.usefixtures("jax_loader")

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = REPO / "resource"
CORNELL = RES / "cornell_box.scn"
# under the area light, as the reference's ray_cast_cornel.scn places its
# one point light (that scene is not in the repository)
POINT_LIGHT = dict(position=(0.0, 250.0, 1028.0), intensity=(1.2, 1.1, 1.0))


def _with_point_light(mod, scene):
    scene.point_light_buffer.append(mod.PointLight(**POINT_LIGHT))
    scene.lights.append(mod.Light(name="Point", type=mod.LightType.POINT,
                                  entity=len(scene.point_light_buffer) - 1))
    return scene


def _floor_scene(mod):
    """A single big floor quad at y=0 viewed from above
    (tests/test_raycast.py's `_floor_scene`)."""
    s = mod.Scene()
    m = mod.Material(name="white", type=0)
    m.register_property(mod.Property("diffuseColor", mod.PropertyType.RGB,
                                     (0.8, 0.8, 0.8)))
    s.materials.append(m)
    s.nodes.append(mod.Node(name="floor", type=mod.NodeType.PLANE,
                            entity=len(s.plane_buffer)))
    s.plane_buffer.append(mod.Plane(position=(-50.0, 0.0, -50.0),
                                    u=(100.0, 0.0, 0.0), v=(0.0, 0.0, 100.0),
                                    normal=(0.0, 1.0, 0.0), material=0))
    s.camera.position = (0.0, 40.0, 0.001)
    s.camera.look_at = (0.0, 0.0, 0.0)
    s.render_option.width = s.render_option.height = 24
    return s


def _directional(mod):
    s = _floor_scene(mod)
    s.directional_light_buffer.append(mod.DirectionalLight(
        direction=(0.0, -1.0, 0.0), irradiance=(1.0, 0.5, 0.25)))
    return s


def _spot(mod):
    s = _floor_scene(mod)
    s.spot_light_buffer.append(mod.SpotLight(
        position=(0.0, 20.0, 0.0), direction=(0.0, -1.0, 0.0),
        intensity=(1.0, 1.0, 1.0), hot_spot=0.15, fallout=0.35))
    return s


def _cornell(mod):
    return _with_point_light(mod, mod.load_scn(str(CORNELL)))


def _cornell_phong(mod):
    """The Cornell box with its white material turned Phong (type 1), so
    the specular term is exercised."""
    s = _cornell(mod)
    m = s.materials[0]
    m.type = 1
    m.register_property(mod.Property("specularColor", mod.PropertyType.RGB,
                                     (0.5, 0.5, 0.5)))
    m.register_property(mod.Property("specularEx", mod.PropertyType.FLOAT,
                                     8.0))
    return s


SCENES = {"cornell_point": _cornell, "cornell_phong": _cornell_phong,
          "floor_directional": _directional, "floor_spot": _spot}


def _pair(build, fn_name, w, h, eager=False):
    """(port image, JAX image), both (H, W, 3) with row 0 = bottom."""
    pytest.importorskip("jax")
    import jax
    import nrenderer_tpu as T
    from nrenderer_tpu.ops.camera import make_camera as jax_make_camera
    from nrenderer_tpu.renderers import preview as jpv, raycast as jrc
    jscene = build(T)
    jcam = jax_make_camera(jscene.camera)
    jfn = jrc.render_raycast if fn_name == "raycast" else jpv.render_preview
    arrays = T.build_scene_arrays(jscene)
    if eager:
        with jax.disable_jit():
            want = np.asarray(jfn(arrays, jcam, w, h))
    else:
        want = np.asarray(jfn(arrays, jcam, w, h))
    pfn = render_raycast if fn_name == "raycast" else render_preview
    got = pfn(P.build_scene_arrays(build(P)),
              camera_from_numpy(jcam, device="cpu"), w, h,
              device="cpu").numpy()
    return got, want


def _stats(got, want):
    d = np.abs(got - want)
    pix = d.max(axis=-1)
    return {"max": float(d.max()), "mean": float(d.mean()),
            "within_1e-4": float((pix <= 1e-4).mean()),
            "within_1e-5": float((pix <= 1e-5).mean())}


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("fn", ["raycast", "preview"])
def test_matches_jax(scene, fn):
    size = 48 if scene.startswith("cornell") else 24
    got, want = _pair(SCENES[scene], fn, size, size)
    st = _stats(got, want)
    print(scene, fn, "vs jitted JAX:", st)
    assert got.shape == want.shape == (size, size, 3)
    assert np.isfinite(got).all() and want.max() > 0.2
    assert st["mean"] <= 2e-3 and st["within_1e-4"] >= 0.99
    got, want = _pair(SCENES[scene], fn, size, size, eager=True)
    st = _stats(got, want)
    print(scene, fn, "vs JAX op by op:", st)
    assert st["within_1e-5"] >= 0.998


def test_shading_structure():
    """tests/test_raycast.py's checks on the port: directional light
    head-on gives sqrt(diffuse * irradiance); the spot cone falls off;
    a scene without point lights is black; a wide fov shades misses black,
    not NaN."""
    img = RayCastRenderer(device="cpu").render(_directional(P)).pixels
    lit = img[..., :3][img[..., :3].sum(axis=2) > 0]
    assert lit.size > 0
    np.testing.assert_allclose(lit, np.sqrt(0.8 * np.array(
        [1.0, 0.5, 0.25]))[None].repeat(len(lit), 0), atol=1e-3)
    img = RayCastRenderer(device="cpu").render(_spot(P)).pixels[..., :3]
    center = img[10:14, 10:14].mean()
    assert center > 0.2 and img[:3, :3].mean() < 0.05 * center
    s = P.load_scn(str(CORNELL))
    s.render_option.width = s.render_option.height = 8
    assert RayCastRenderer(device="cpu").render(s).pixels[..., :3].max() \
        == 0.0
    s = _cornell(P)
    s.render_option.width = s.render_option.height = 32
    s.camera.fov = 120.0
    img = RayCastRenderer(device="cpu").render(s).pixels
    assert np.isfinite(img).all()
    assert (img[..., :3].sum(axis=2) < 1e-6).any()


def test_raycast_through_the_manager():
    """Registered as "RayCast"; the image is bottom-up flipped, RGBA."""
    P._register_builtin_renderers()
    s = _cornell(P)
    s.render_option.width, s.render_option.height = 20, 16
    mgr = ComponentManager()
    mgr.exec("RayCast", s, component=RayCastRenderer(device="cpu"))
    res = mgr.wait(timeout=120)
    assert res.pixels.shape == (16, 20, 4)
    assert res.pixels[..., 3].min() == 1.0
    from nrenderer_torch.ops.camera import make_camera
    raw = render_raycast(P.build_scene_arrays(s),
                         make_camera(s.camera, device="cpu"), 20, 16,
                         device="cpu").numpy()
    np.testing.assert_array_equal(res.pixels[..., :3], raw[::-1])
    # red wall on screen-left, green on screen-right
    img = res.pixels[..., :3]
    left, right = img[6:10, 1:3].mean((0, 1)), img[6:10, -3:-1].mean((0, 1))
    assert left[0] > left[1] and right[1] > right[0]


def _mesh_scene(mod, obj="ico_5120.obj"):
    s = mod.load_scn(str(RES / "mesh_box.scn"))
    mod.load_obj(str(RES / "obj" / obj), s, material=0)
    return s


def test_decimation_matches_jax(monkeypatch):
    pytest.importorskip("jax")
    import nrenderer_tpu as T
    from nrenderer_tpu.renderers.preview import preview_scene as jax_ps
    s = P.load_scn(str(CORNELL))
    assert preview_scene(s) is s               # no meshes: shared
    for cap in (None, "700"):
        if cap:
            monkeypatch.setenv("NR_PREVIEW_MAX_FACES", cap)
        ps, js = preview_scene(_mesh_scene(P)), jax_ps(_mesh_scene(T))
        got = np.asarray(ps.mesh_buffer[-1].position_indices)
        want = np.asarray(js.mesh_buffer[-1].position_indices)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            np.asarray(ps.mesh_buffer[-1].normal_indices),
            np.asarray(js.mesh_buffer[-1].normal_indices))
        assert 0 < len(got) // 3 <= int(cap or 1024)
    src = _mesh_scene(P)
    preview_scene(src)
    assert len(src.mesh_buffer[-1].position_indices) // 3 == 5120
    blob = _mesh_scene(P, "blob_960.obj")
    monkeypatch.delenv("NR_PREVIEW_MAX_FACES")
    assert preview_scene(blob) is blob         # under the cap


@pytest.mark.parametrize("decimate", [True, False])
def test_preview_mesh_matches_jax(monkeypatch, decimate):
    """GeometryPreview of mesh_box + ico_5120 (decimated to 1024 faces,
    and whole, where the chunked intersect carries 5120 triangles)."""
    pytest.importorskip("jax")
    import nrenderer_tpu as T
    from nrenderer_tpu.renderers.preview import GeometryPreviewRenderer as JG
    if not decimate:
        monkeypatch.setenv("NR_PREVIEW_MAX_FACES", "100000")
    imgs = []
    for mod, make in ((P, lambda: GeometryPreviewRenderer(device="cpu")),
                      (T, JG)):
        s = _mesh_scene(mod)
        s.render_option.width, s.render_option.height = 40, 32
        imgs.append(make().render(s).pixels)
    st = _stats(imgs[0][..., :3], imgs[1][..., :3])
    print("mesh preview, decimate", decimate, st)
    assert imgs[0].shape == imgs[1].shape == (32, 40, 4)
    assert st["mean"] <= 2e-3 and st["within_1e-4"] >= 0.99


def test_preview_size_and_lights():
    assert preview_size(600, 300) == (256, 128)
    assert preview_size(100, 80) == (100, 80)
    assert preview_size(0, 0) == (1, 1)
    s = P.load_scn(str(CORNELL))
    s.render_option.width, s.render_option.height = 600, 300
    r = GeometryPreviewRenderer(device="cpu").render(s)
    assert (r.width, r.height) == (256, 128)
    img = np.asarray(r.pixels)
    assert np.isfinite(img).all()
    assert (img[..., :3].min(axis=2) > 0.95).any()   # the light patch
    lit = img[..., :3].sum(axis=2)
    assert ((lit > 0.5) & (lit < 2.8)).mean() > 0.3


def test_example_matches_jax(monkeypatch):
    pytest.importorskip("jax")
    import nrenderer_tpu as T
    from nrenderer_tpu.renderers.example import ExampleRenderer as JE
    monkeypatch.setattr(port_example.time, "sleep", lambda s: None)
    out = []
    for mod, make in ((P, port_example.ExampleRenderer), (T, JE)):
        s = mod.Scene()
        s.render_option.width, s.render_option.height = 7, 5
        out.append(make().render(s))
    np.testing.assert_array_equal(out[0].pixels, out[1].pixels)
    assert (out[0].width, out[0].height) == (7, 5)
    from nrenderer_torch.server.registry import get_server
    kinds = [m.type.name for m in get_server().logger.get()[-4:]]
    assert kinds[-1] == "SUCCESS"
