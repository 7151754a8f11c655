"""Sample- and pixel-sharded renders (`nrenderer_torch.parallel.mesh`) on
CPU ranks over gloo, against the port's one-device renders and against the
JAX package's sharded renders.

The port draws every random number from the hash keyed by the global
pixel, sample and seed, so:

- a world of one is the one-device film bit for bit;
- pixel bands are the one-device film's rows bit for bit;
- sample sharding is the one-device film up to the order of the final sum:
  rtol 1e-6 (at these sizes every path read 0 on the CPU, bit for bit).

JAX gives each device its own `jax.random` stream, so parity with JAX's
`render_multichip` and `build_sharded_render_pixels` (8 virtual CPU
devices) is statistical: linear means within 5% and 8x8-block correlation
>= 0.9 at 32x32, 256 spp, depth 3 (read on the CPU: 1.6% and 0.938 by
samples, 2.0% and 0.923 by pixels).

Every launch spawns its ranks (about 3 s each here); the rank functions
live in the port, so no rank imports JAX."""
import pathlib

import numpy as np
import pytest
import torch

from nrenderer_torch import load_scn
from nrenderer_torch.io.obj import load_obj
from nrenderer_torch.parallel import mesh as pm
from nrenderer_torch.renderers.acc_pt import AccPathTracerRenderer
from nrenderer_torch.renderers.simple_pt import SimplePathTracerRenderer
from nrenderer_torch.scene.model import Scene

torch.set_num_threads(2)

RES = pathlib.Path(__file__).resolve().parent.parent / "resource"
RTOL = 1e-6
THREADS = 2
LAUNCH = dict(threads=THREADS, timeout=300)

# (scene, obj, renderer, spp, route) of each sharded path, at 16x16,
# depth 3; the megamesh route shards passes of 32 spp
PATHS = {
    "spt": ("cornell_box.scn", None, "SimplePathTracer", 8, "dense"),
    "acc": ("pt_glass_box.scn", None, "AccPathTracer", 8, "megakernel"),
    "megamesh": ("mesh_box.scn", "blob_960.obj", "AccPathTracer", 64,
                 "megamesh"),
    "hybrid": ("mesh_box.scn", "ico_5120.obj", "AccPathTracer", 4,
               "hybrid"),
}


def _scene(key, w=16, h=16, spp=None, depth=3):
    scn, obj, _, n, _ = PATHS[key]
    scene = Scene()
    load_scn(str(RES / scn), scene)
    if obj:
        load_obj(str(RES / "obj" / obj), scene, material=0)
    ro = scene.render_option
    ro.width, ro.height, ro.depth = w, h, depth
    ro.samples_per_pixel = n if spp is None else spp
    return scene


_ONE = {}


def _one_device(key):
    """The one-device renderer's image (row 0 = top), made once."""
    if key not in _ONE:
        cls = (SimplePathTracerRenderer if PATHS[key][2] == "SimplePathTracer"
               else AccPathTracerRenderer)
        _ONE[key] = cls(seed=3, device="cpu").render(
            _scene(key)).pixels[..., :3]
    return _ONE[key]


def _dense_film(key):
    """The one-device linear film SUM of a dense route
    (`render_pt_linear`)."""
    from nrenderer_torch.ops.camera import make_camera
    from nrenderer_torch.ops.pt_cuda import render_pt_linear
    scene = _scene(key)
    _, ss = pm._prep(scene)
    return render_pt_linear(ss, make_camera(scene.camera, device="cpu"),
                            16, 16, 8, 3, seed=3, bsdf=key == "acc",
                            device="cpu").numpy()


@pytest.mark.parametrize("key", ["spt", "acc"])
def test_world_of_one_is_the_one_device_render(key):
    """One rank renders the route's whole range: the one-device linear film
    (`render_pt_linear`) and image, bit for bit."""
    out = pm.render_sharded(_scene(key), ["cpu"], PATHS[key][2], seed=3,
                            **LAUNCH)
    np.testing.assert_array_equal(out.film, _dense_film(key))
    np.testing.assert_array_equal(out.image, _one_device(key))
    assert out.route == PATHS[key][4] and out.spp_done == 8


@pytest.mark.parametrize("shard", ["samples", "pixels"])
@pytest.mark.parametrize("key", list(PATHS))
def test_two_ranks_match_the_one_device_render(key, shard):
    """Each route on two ranks: pixel bands give the one-device image bit
    for bit, sample shards within RTOL of its linear film; the route is
    the one the one-device renderer takes."""
    out = pm.render_sharded(_scene(key), ["cpu"] * 2, PATHS[key][2], shard,
                            seed=3, **LAUNCH)
    want = _one_device(key)
    assert out.route == PATHS[key][4]
    if shard == "pixels":
        np.testing.assert_array_equal(out.image, want)
    else:
        np.testing.assert_allclose(out.image, want, rtol=RTOL, atol=1e-7)
    if key in ("spt", "acc"):
        np.testing.assert_allclose(out.film, _dense_film(key), rtol=RTOL,
                                   atol=1e-7)
    assert np.isfinite(out.image).all() and out.image.max() > 0


@pytest.mark.parametrize("shard", ["samples", "pixels"])
def test_four_ranks(shard):
    """A world of four on SimplePathTracer: four bands of 4 rows, or four
    sample ranges of 2."""
    out = pm.render_sharded(_scene("spt"), ["cpu"] * 4, shard=shard, seed=3,
                            threads=1, timeout=300)
    want = _one_device("spt")
    if shard == "pixels":
        np.testing.assert_array_equal(out.image, want)
    else:
        np.testing.assert_allclose(out.image, want, rtol=RTOL, atol=1e-7)


def _forms():
    """(name, pt_accumulate kwargs, scene, bsdf) of every form the plain
    version takes a pixel range in."""
    from nrenderer_torch.ops.bvh import build_mesh_accel
    from nrenderer_torch.ops.mesh_cuda import make_mesh_tables
    from nrenderer_torch.ops.pt_core import make_mat_channels
    from nrenderer_torch.ops.pt_cuda import make_env_tables, make_tex_tables
    from nrenderer_torch.io.image import load_image
    env = make_env_tables(load_image(str(RES / "env_sky.png")), "cpu")

    def scene(scn, obj=None):
        s = Scene()
        load_scn(str(RES / scn), s)
        if obj:
            load_obj(str(RES / "obj" / obj), s, material=0)
        return s

    def mesh_of(s):
        arrays, ss = pm._prep(s)
        return make_mesh_tables(
            build_mesh_accel(arrays, make_mat_channels(ss)).bt, "cpu")

    tex_scene = scene("tex_grid.scn", "tex_quad.obj")
    tex = make_tex_tables(pm._prep(tex_scene)[0].textures, "cpu")
    blob = scene("mesh_box.scn", "blob_960.obj")
    return {
        "diffuse": (scene("cornell_box.scn"), {}),
        "bsdf": (scene("pt_glass_box.scn"), dict(bsdf=True)),
        "diffuse_env": (scene("env_spheres.scn"), dict(env=env)),
        "bsdf_env": (scene("env_spheres.scn"), dict(bsdf=True, env=env)),
        "diffuse_tex": (tex_scene, dict(tex=tex)),
        "bsdf_mesh": (blob, dict(bsdf=True, mesh=mesh_of(blob))),
    }


@pytest.fixture(scope="module")
def forms():
    return _forms()


@pytest.mark.parametrize("form", ["diffuse", "bsdf", "diffuse_env",
                                  "bsdf_env", "diffuse_tex", "bsdf_mesh"])
def test_plain_pixel_range_is_the_films_rows(forms, form):
    """`pt_accumulate_plain` over pixels [pix0, pix0 + n_pix): the full
    film's rows bit for bit (the hash and the camera keep the global pixel
    id), for a band of rows and a ragged range, at samples [3, 8)."""
    from nrenderer_torch.ops.camera import make_camera
    from nrenderer_torch.ops.pt_core import scene_epsilon
    from nrenderer_torch.ops.pt_cuda import pt_accumulate_plain
    scene, kw = forms[form]
    _, ss = pm._prep(scene)
    cam = make_camera(scene.camera, device="cpu")
    w, h = 12, 10
    t_min = scene_epsilon(ss)
    full = pt_accumulate_plain(torch.zeros((w * h, 3)), ss, cam, w, h, 3, 5,
                               4, 7, t_min, **kw)
    assert full.abs().sum() > 0
    for pix0, n in ((4 * w, 3 * w), (5, 37), (w * h - 1, 1)):
        band = pt_accumulate_plain(torch.zeros((n, 3)), ss, cam, w, h, 3, 5,
                                   4, 7, t_min, pix0=pix0, n_pix=n, **kw)
        assert torch.equal(band, full[pix0:pix0 + n]), (pix0, n)


def test_pixel_range_is_checked():
    """A range outside the film, or a film of another size, is refused."""
    from nrenderer_torch.ops.camera import make_camera
    from nrenderer_torch.ops.pt_cuda import pt_accumulate
    scene = _scene("spt")
    _, ss = pm._prep(scene)
    cam = make_camera(scene.camera, device="cpu")
    for pix0, n in ((-1, 4), (250, 7), (0, 0)):
        with pytest.raises(ValueError, match="pixel range"):
            pt_accumulate(torch.zeros((max(n, 1), 3)), ss, cam, 16, 16, 0,
                          1, 2, 0, 1e-4, pix0=pix0, n_pix=n)
    with pytest.raises(ValueError, match="film must be"):
        pt_accumulate(torch.zeros((256, 3)), ss, cam, 16, 16, 0, 1, 2, 0,
                      1e-4, pix0=16, n_pix=32)


@pytest.mark.parametrize("staged", [False, True], ids=["plain", "staged"])
def test_hybrid_wavefront_band_is_the_films_rows(staged):
    """The hybrid route's wavefronts over a band of rows: the full film's
    rows bit for bit (at 32x32, 1 spp, where no stage overflows its
    buffer, so the stage roulette never fires)."""
    from nrenderer_torch.ops.bvh import build_mesh_accel
    from nrenderer_torch.ops.camera import make_camera
    from nrenderer_torch.ops.mesh_cuda import make_mesh_tables
    from nrenderer_torch.ops.pt_core import make_mat_channels
    from nrenderer_torch.renderers import _wavefront
    from nrenderer_torch.renderers.acc_pt import build_render_fn
    scene = _scene("hybrid")
    arrays, ss = pm._prep(scene)
    mesh = make_mesh_tables(build_mesh_accel(arrays, make_mat_channels(ss))
                            .bt, "cpu")
    cam = make_camera(scene.camera, device="cpu")
    w = h = 32
    depth = 13 if staged else 4
    _wavefront.reset_route_counts()
    full = build_render_fn(ss, cam, w, h, depth, 1, tri_bvh=mesh,
                           staged=staged)(3, 0, 1)
    for pix0 in (0, w * h // 2):
        band = build_render_fn(ss, cam, w, h, depth, 1, tri_bvh=mesh,
                               staged=staged, pix0=pix0,
                               n_pix=w * h // 2)(3, 0, 1)
        assert torch.equal(band, full[pix0:pix0 + w * h // 2])
    assert _wavefront.ROUTE_COUNTS["roulette"] == 0
    assert _wavefront.ROUTE_COUNTS["stage_packs"] == (6 if staged else 0)


def test_refusals_before_any_rank_starts():
    """A split the route cannot take evenly is refused with its reason."""
    with pytest.raises(ValueError, match="multiple of the device count 3"):
        pm.render_sharded(_scene("spt"), ["cpu"] * 3)
    with pytest.raises(ValueError, match="height divisible"):
        pm.render_sharded(_scene("spt", h=15), ["cpu"] * 2, shard="pixels")
    with pytest.raises(ValueError, match="megamesh route shards passes"):
        pm.render_sharded(_scene("megamesh", spp=32), ["cpu"] * 2,
                          "AccPathTracer")
    with pytest.raises(ValueError, match="no sharded route"):
        pm.render_sharded(_scene("spt"), ["cpu"] * 2, "RayCast")


def _block_stats(port, jax_img):
    """(relative difference of the linear means, 8x8-block correlation) of
    two (32, 32, 3) gamma'd images."""
    lin = [np.asarray(im, np.float64) ** 2 for im in (port, jax_img)]
    rel = abs(lin[0].mean() / lin[1].mean() - 1.0)
    blocks = [im.reshape(8, 4, 8, 4, 3).mean(axis=(1, 3)).ravel()
              for im in lin]
    return rel, float(np.corrcoef(*blocks)[0, 1])


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's sample- and pixel-sharded SimplePathTracer images of
    cornell_box.scn at 32x32, 256 spp, depth 3 on 8 virtual CPU devices,
    row 0 = top."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    import nrenderer_tpu as T
    from nrenderer_tpu.ops.camera import make_camera
    from nrenderer_tpu.ops.intersect import make_static_scene
    from nrenderer_tpu.parallel.mesh import (
        build_sharded_render_pixels, make_mesh, render_multichip)
    scene = T.load_scn(str(RES / "cornell_box.scn"))
    ss = make_static_scene(T.build_scene_arrays(scene))
    cam = make_camera(scene.camera)
    mesh = make_mesh(8, devices=jax.devices("cpu"))
    samples = np.asarray(render_multichip(ss, cam, 32, 32, 256, 3,
                                          mesh=mesh, seed=1))
    fn = build_sharded_render_pixels(ss, 32, 32, 256, 3, mesh)
    pixels = np.asarray(fn(cam, jnp.arange(1, 9, dtype=jnp.int32)))
    # row 0 = top, clipped to [0, 1] as the port's images are
    return {k: np.clip(v[::-1], 0.0, 1.0)
            for k, v in (("samples", samples), ("pixels", pixels))}


@pytest.mark.parametrize("shard", ["samples", "pixels"])
def test_matches_jax_sharded_render_in_distribution(jax_sharded, shard):
    """Two ranks of the port against JAX's 8-device render of the same
    shard mode: independent estimates of one image (linear means within
    5%, 8x8-block correlation >= 0.9)."""
    out = pm.render_sharded(_scene("spt", w=32, h=32, spp=256),
                            ["cpu"] * 2, shard=shard, seed=1, **LAUNCH)
    rel, corr = _block_stats(out.image, jax_sharded[shard])
    print(f"{shard}: linear mean rel diff {rel:.4f}, block corr {corr:.4f}")
    assert rel <= 0.05 and corr >= 0.9
