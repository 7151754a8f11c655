"""The port's diffuse bounce, ambient term and camera against the JAX
package's, elementwise on the same numpy inputs.

Tolerances: rtol 1e-5 on the bounce outputs (the backends' sin/cos/rsqrt may
differ in the last ulp), compared where both sides agree on which rays hit
an object first (a one-ulp difference may flip a hit at an edge); 1e-6 on
the camera."""
import pathlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import nrenderer_tpu as T  # noqa: E402
from nrenderer_tpu.ops import camera as jcamera  # noqa: E402
from nrenderer_tpu.ops import pt_core as jcore  # noqa: E402
from nrenderer_tpu.ops.intersect import make_static_scene  # noqa: E402
from nrenderer_tpu.ops.soa import V3 as JV3  # noqa: E402

from nrenderer_torch.interop import (  # noqa: E402
    camera_from_numpy, static_scene_from_numpy,
)
from nrenderer_torch.ops import camera as tcamera  # noqa: E402
from nrenderer_torch.ops import pt_core as tcore  # noqa: E402
from nrenderer_torch.ops.soa import V3  # noqa: E402
from nrenderer_torch.scene.model import Camera  # noqa: E402

torch.set_num_threads(1)

SCENE = pathlib.Path(__file__).resolve().parent.parent / "resource" \
    / "cornell_box.scn"
N = 4096


@pytest.fixture(scope="module")
def scenes():
    jss = make_static_scene(T.build_scene_arrays(T.load_scn(str(SCENE))))
    return jss, static_scene_from_numpy(jss)


def j3(a):
    return JV3(*(jnp.asarray(c) for c in a))


def t3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def close3(got, want, mask=None, rtol=1e-5, atol=1e-6):
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        if mask is not None:
            g, w = g[mask], w[mask]
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


def bounce_inputs(seed: int):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    o = f32([rng.uniform(-270, 270, N), rng.uniform(-270, 270, N),
             rng.uniform(760, 1300, N)])
    d = rng.normal(size=(3, N))
    d = f32(d / np.linalg.norm(d, axis=0))
    thr = f32(rng.uniform(0.05, 1.0, (3, N)))
    rad = f32(rng.uniform(0.0, 2.0, (3, N)))
    alive = rng.random(N) < 0.8
    u1, u2 = f32(rng.random(N)), f32(rng.random(N))
    return o, d, thr, rad, alive, u1, u2


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_diffuse_bounce_matches_jax(scenes, seed):
    jss, ss = scenes
    o, d, thr, rad, alive, u1, u2 = bounce_inputs(seed)
    t_min = tcore.scene_epsilon(ss)
    albedo = [tuple(float(v) for v in m["diffuse"]) for m in ss.mats]
    jo, jd, jthr, jrad, jalive = jcore.diffuse_bounce(
        jss, albedo, j3(o), j3(d), j3(thr), j3(rad), jnp.asarray(alive),
        jnp.asarray(u1), jnp.asarray(u2), t_min=t_min)
    to, td, tthr, trad, talive = tcore.diffuse_bounce(
        ss, albedo, t3(o), t3(d), t3(thr), t3(rad), torch.from_numpy(alive),
        torch.from_numpy(u1), torch.from_numpy(u2), t_min=t_min)
    same = talive.numpy() == np.asarray(jalive)
    assert same.mean() >= 0.999
    assert talive.numpy().mean() > 0.5
    close3(to, jo, same, atol=1e-3)
    close3(td, jd, same)
    close3(tthr, jthr, same)
    close3(trad, jrad, same)


def test_finish_ambient_matches_jax(scenes):
    jss, ss = scenes
    _, _, thr, rad, alive, _, _ = bounce_inputs(5)
    for amb in ((0.0, 0.0, 0.0), (0.25, 0.5, 0.125)):
        want = jcore.finish_ambient(jss._replace(ambient_constant=amb),
                                    j3(thr), j3(rad), jnp.asarray(alive))
        got = tcore.finish_ambient(ss._replace(ambient_constant=amb), t3(thr),
                                   t3(rad), torch.from_numpy(alive))
        close3(got, want)


def test_hemisphere_and_onb_match_jax():
    rng = np.random.default_rng(3)
    u1 = rng.random(N).astype(np.float32)
    u2 = rng.random(N).astype(np.float32)
    close3(tcore.hemisphere_from_uv(torch.from_numpy(u1),
                                    torch.from_numpy(u2)),
           jcore.hemisphere_from_uv(jnp.asarray(u1), jnp.asarray(u2)))
    n = rng.normal(size=(3, N))
    n = (n / np.linalg.norm(n, axis=0)).astype(np.float32)
    n[:, :4] = [[1, -1, 0, 0], [0, 0, 1, 0], [0, 0, 0, -1]]  # axis normals
    v = rng.normal(size=(3, N)).astype(np.float32)
    close3(tcore.onb_local(t3(n), t3(v)), jcore.onb_local(j3(n), j3(v)))


CAMERAS = [
    Camera(),
    Camera(position=(10.0, 40.0, -30.0), look_at=(0.0, -20.0, 1000.0),
           up=(0.1, 1.0, 0.0), fov=65.0, aperture=0.5, focus_distance=2.0,
           aspect=1.5),
    Camera(fov=170.0),  # clamped to 160
]


@pytest.mark.parametrize("k", range(len(CAMERAS)))
def test_make_camera_and_shoot_match_jax(k):
    cam_t = tcamera.make_camera(CAMERAS[k], device="cpu")
    jcam_model = T.Camera(**vars(CAMERAS[k]))
    cam_j = jcamera.make_camera(jcam_model)
    for name in tcamera.CameraParams._fields:
        got = getattr(cam_t, name)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(getattr(cam_j, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    # interop hands the JAX camera over unchanged
    handed = camera_from_numpy(cam_j, device="cpu")
    for a, b in zip(handed, cam_t):
        assert torch.equal(a, b)
    rng = np.random.default_rng(k)
    s = rng.random(N).astype(np.float32)
    t = rng.random(N).astype(np.float32)
    lens = rng.uniform(-0.7, 0.7, (2, N)).astype(np.float32)
    for lens_uv in (None, lens):
        jl = None if lens_uv is None else (jnp.asarray(lens[0]),
                                           jnp.asarray(lens[1]))
        tl = None if lens_uv is None else (torch.from_numpy(lens[0]),
                                           torch.from_numpy(lens[1]))
        oj, dj = jcamera.shoot_v3(cam_j, jnp.asarray(s), jnp.asarray(t),
                                  lens_uv=jl)
        ot, dt = tcamera.shoot_v3(cam_t, torch.from_numpy(s),
                                  torch.from_numpy(t), lens_uv=tl)
        close3(ot, oj, rtol=1e-6, atol=1e-6)
        close3(dt, dj, rtol=1e-6, atol=1e-6)
