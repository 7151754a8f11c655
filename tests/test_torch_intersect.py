"""The port's unrolled intersection against the JAX package's on random rays
from inside the in-repo Cornell box.

Both evaluate the same float32 operations in the same order, so hits agree
exactly in practice; the stated tolerances allow for a one-ulp difference
between the two backends' kernels: `valid` equal on >= 99.9% of rays, and
where both hit, t within rtol 1e-5, material, channels, primitive id and
stored normals exact, sphere normals (computed from the hit point) within
1e-6."""
import pathlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import nrenderer_tpu as T  # noqa: E402
from nrenderer_tpu.ops.intersect import (  # noqa: E402
    intersect_area_lights_unrolled as jax_lights,
    intersect_scene_unrolled as jax_scene, make_static_scene,
)
from nrenderer_tpu.ops.pt_core import scene_epsilon as jax_eps  # noqa: E402
from nrenderer_tpu.ops.soa import V3 as JV3  # noqa: E402

from nrenderer_torch.interop import static_scene_from_numpy  # noqa: E402
from nrenderer_torch.ops.intersect import (  # noqa: E402
    intersect_area_lights_unrolled, intersect_scene_unrolled,
)
from nrenderer_torch.ops.pt_core import scene_epsilon  # noqa: E402
from nrenderer_torch.ops.soa import V3  # noqa: E402

torch.set_num_threads(1)

SCENE = pathlib.Path(__file__).resolve().parent.parent / "resource" \
    / "cornell_box.scn"
N_RAYS = 4096


@pytest.fixture(scope="module")
def scenes():
    jss = make_static_scene(T.build_scene_arrays(T.load_scn(str(SCENE))))
    return jss, static_scene_from_numpy(jss)


def random_rays(seed: int, n: int = N_RAYS):
    """Origins inside the wall shell, isotropic unit directions (numpy
    float32, so both packages see the same bits)."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(-270, 270, n), rng.uniform(-270, 270, n),
                  rng.uniform(760, 1300, n)]).astype(np.float32)
    d = rng.normal(size=(3, n))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    return o, d


def to_jax(a):
    return JV3(*(jnp.asarray(c) for c in a))


def to_torch(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def test_scene_epsilon_equal(scenes):
    jss, ss = scenes
    assert scene_epsilon(ss) == jax_eps(jss)


@pytest.mark.parametrize("seed", [0, 1])
def test_intersect_scene_matches_jax(scenes, seed):
    jss, ss = scenes
    o, d = random_rays(seed)
    t_min = scene_epsilon(ss)
    albedo = [tuple(float(v) for v in m["diffuse"]) for m in ss.mats]
    hj = jax_scene(jss, to_jax(o), to_jax(d), t_min=t_min,
                   mat_channels=albedo)
    ht = intersect_scene_unrolled(ss, to_torch(o), to_torch(d), t_min=t_min,
                                  mat_channels=albedo)
    vj, vt = np.asarray(hj.valid), ht.valid.numpy()
    assert (vj == vt).mean() >= 0.999
    assert vt.mean() > 0.5  # rays from inside mostly hit something
    both = vj & vt
    np.testing.assert_allclose(ht.t.numpy()[both], np.asarray(hj.t)[both],
                               rtol=1e-5)
    same = both & (ht.prim_id.numpy() == np.asarray(hj.prim_id))
    assert same.sum() == both.sum()
    # stored normals (triangles, planes) exactly; a sphere's normal is
    # computed from the hit point, where XLA may contract a multiply-add
    stored = same & (ht.prim_id.numpy() >= len(ss.sph))
    sphere = same & ~stored
    assert stored.any() and sphere.any()
    for a, b in zip(ht.normal, hj.normal):
        np.testing.assert_array_equal(a.numpy()[stored],
                                      np.asarray(b)[stored])
        np.testing.assert_allclose(a.numpy()[sphere], np.asarray(b)[sphere],
                                   rtol=0, atol=1e-6)
    for a, b in zip(ht.channels, hj.channels):
        np.testing.assert_array_equal(a.numpy()[same], np.asarray(b)[same])
    np.testing.assert_array_equal(ht.mat_id.numpy()[same],
                                  np.asarray(hj.mat_id)[same])
    for a, b in zip(ht.point, hj.point):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same],
                                   rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_intersect_area_lights_matches_jax(scenes, seed):
    jss, ss = scenes
    o, d = random_rays(seed + 10)
    # aim a quarter of the rays at the light so the hit set is not tiny
    k = N_RAYS // 4
    target = np.array([0.0, 275.0, 1028.0], np.float32)[:, None] \
        + np.random.default_rng(seed).uniform(-70, 70, (3, k)) \
        * np.array([[1.0], [0.0], [1.0]])
    v = target - o[:, :k]
    d[:, :k] = (v / np.linalg.norm(v, axis=0)).astype(np.float32)
    t_min = scene_epsilon(ss)
    tj, rj = jax_lights(jss, to_jax(o), to_jax(d), t_min=t_min)
    tt, rt = intersect_area_lights_unrolled(ss, to_torch(o), to_torch(d),
                                            t_min=t_min)
    vj = np.isfinite(np.asarray(tj))
    vt = np.isfinite(tt.numpy())
    assert (vj == vt).mean() >= 0.999
    assert vt.sum() > k // 4
    both = vj & vt
    np.testing.assert_allclose(tt.numpy()[both], np.asarray(tj)[both],
                               rtol=1e-5)
    for a, b in zip(rt, rj):
        np.testing.assert_array_equal(a.numpy()[both], np.asarray(b)[both])
