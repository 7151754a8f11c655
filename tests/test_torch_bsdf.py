"""AccPathTracer's BSDFs and bounce: the port against the JAX package,
elementwise on the same numpy inputs.

The batches hold grazing directions, rays leaving from inside glass, total
internal reflection, unnormalized normals (a triangle's stored normal is
not unit) and the clamp regimes of the microfacet lobe.

Tolerances: rtol 1e-5 / atol 1e-6 on every output, except where the
formula cancels: the conductor's r_s = (t1 - t2) / (t1 + t2) near zero
reflectance and the microfacet's half-vector at the clamps, where one ulp
of a sqrt moves the result by up to ~4e-5 relatively (rtol 1e-4 there).
The backends' sqrt, rsqrt, sin and cos may differ in the last ulp, and a
stochastic lobe choice (u < F) may flip where F lies within an ulp of the
uniform, so the directions and weights are compared where both sides chose
the same lobe (>= 99.9% of rays).  `pow5` is held bit for bit against JAX's
`x ** 5`."""
import pathlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import nrenderer_tpu as T  # noqa: E402
from nrenderer_tpu.ops import pt_core as jcore  # noqa: E402
from nrenderer_tpu.ops.intersect import make_static_scene  # noqa: E402
from nrenderer_tpu.ops.soa import V3 as JV3  # noqa: E402

from nrenderer_torch.interop import static_scene_from_numpy  # noqa: E402
from nrenderer_torch.ops import pt_core as tcore  # noqa: E402
from nrenderer_torch.ops import pt_cuda  # noqa: E402
from nrenderer_torch.ops.soa import V3  # noqa: E402

torch.set_num_threads(1)

GLASS_SCENE = pathlib.Path(__file__).resolve().parent.parent / "resource" \
    / "pt_glass_box.scn"
N = 4096


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


def _unit(rng, n):
    v = rng.normal(size=(3, n))
    return v / np.linalg.norm(v, axis=0)


def lobe_inputs(seed: int):
    """Incoming unit directions and normals (a quarter of them grazing, a
    tenth of the normals scaled off unit length), material constants and
    uniforms, float32."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    n = _unit(rng, N)
    d = _unit(rng, N)
    graze = rng.random(N) < 0.25
    # d = t + eps n with t perpendicular to n: |d . n| ~ eps
    t = d - (d * n).sum(0) * n
    t /= np.linalg.norm(t, axis=0)
    eps = rng.uniform(-1e-3, 1e-3, N)
    g = t + eps * n
    d[:, graze] = (g / np.linalg.norm(g, axis=0))[:, graze]
    n[:, rng.random(N) < 0.1] *= rng.uniform(0.5, 2.0)
    mats = dict(
        eta_r=f32(rng.uniform(0.05, 2.0, (3, N))),
        eta_i=f32(rng.uniform(0.0, 4.0, (3, N))),
        albedo=f32(rng.random((3, N))),
        diffuse=f32(rng.random((3, N))),
        absorbed=f32(rng.random((3, N))),
        ior=f32(rng.uniform(1.05, 2.5, N)),
        rough=f32(np.concatenate([rng.uniform(0.02, 1.0, N - 8),
                                  np.zeros(8)])),
        f0=f32(rng.uniform(0.0, 0.1, N)),
        metal=f32(rng.random(N)),
    )
    u = f32(rng.random((3, N)))
    u[0, :4] = [0.0, 0.9999999, 0.5, 1e-7]   # the microfacet's clamps
    return f32(d), f32(n), mats, u


def test_pow5_is_jax_integer_pow():
    x = np.random.default_rng(0).uniform(0.0, 1.0, 1 << 16).astype(
        np.float32)
    want = np.asarray(jnp.asarray(x) ** 5)
    np.testing.assert_array_equal(tcore.pow5(torch.from_numpy(x)).numpy(),
                                  want)


@pytest.mark.parametrize("seed", [0, 1])
def test_fresnel_and_conductor_match_jax(seed):
    d, n, m, _ = lobe_inputs(seed)
    cos = np.abs((d * n).sum(0)).astype(np.float32)
    close3(tcore.fresnel_conductor(torch.from_numpy(cos), t3(m["eta_r"]),
                                   t3(m["eta_i"])),
           jcore.fresnel_conductor(jnp.asarray(cos), j3(m["eta_r"]),
                                   j3(m["eta_i"])), rtol=1e-4)
    tl, tw = tcore.conductor_scatter(t3(d), t3(n), t3(m["eta_r"]),
                                     t3(m["eta_i"]), t3(m["albedo"]))
    jl, jw = jcore.conductor_scatter(j3(d), j3(n), j3(m["eta_r"]),
                                     j3(m["eta_i"]), j3(m["albedo"]))
    close3(tl, jl)
    close3(tw, jw, rtol=1e-4)


def _same_choice(tl, jl):
    """Rays whose two directions agree (both sides chose the same lobe)."""
    gap = sum(np.abs(t.numpy() - np.asarray(j)) for t, j in zip(tl, jl))
    return gap < 1e-3


@pytest.mark.parametrize("seed", [0, 1])
def test_glass_scatter_matches_jax(seed):
    d, n, m, u = lobe_inputs(seed)
    inside = (d * n).sum(0) > 0
    x_ = (1.0 - np.abs((d * n).sum(0) / np.linalg.norm(n, axis=0))) \
        * np.where(inside, m["ior"], 1.0 / m["ior"])
    assert inside.mean() > 0.3 and (x_ > 1.0).mean() > 0.05  # TIR present
    tl, tw = tcore.glass_scatter(t3(d), t3(n), torch.from_numpy(m["ior"]),
                                 t3(m["absorbed"]), torch.from_numpy(u[2]))
    jl, jw = jcore.glass_scatter(j3(d), j3(n), jnp.asarray(m["ior"]),
                                 j3(m["absorbed"]), jnp.asarray(u[2]))
    same = _same_choice(tl, jl)
    assert same.mean() >= 0.999
    close3(tl, jl, same)
    close3(tw, jw)


@pytest.mark.parametrize("seed", [0, 1])
def test_microfacet_scatter_matches_jax(seed):
    d, n, m, u = lobe_inputs(seed)
    args_t = (t3(d), t3(n), t3(m["albedo"]), torch.from_numpy(m["rough"]),
              torch.from_numpy(m["f0"]), torch.from_numpy(m["metal"]),
              torch.from_numpy(u[0]), torch.from_numpy(u[1]))
    args_j = (j3(d), j3(n), j3(m["albedo"]), jnp.asarray(m["rough"]),
              jnp.asarray(m["f0"]), jnp.asarray(m["metal"]),
              jnp.asarray(u[0]), jnp.asarray(u[1]))
    tl, tw = tcore.microfacet_scatter(*args_t)
    jl, jw = jcore.microfacet_scatter(*args_j)
    assert np.asarray(jw.x).any() and (np.asarray(jw.x) == 0).any()
    close3(tl, jl, rtol=1e-4, atol=1e-5)
    close3(tw, jw, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_plastic_scatter_matches_jax(seed):
    d, n, m, u = lobe_inputs(seed)
    tl, tw = tcore.plastic_scatter(
        t3(d), t3(n), t3(m["diffuse"]), t3(m["albedo"]),
        torch.from_numpy(m["ior"]), *(torch.from_numpy(x) for x in u))
    jl, jw = jcore.plastic_scatter(
        j3(d), j3(n), j3(m["diffuse"]), j3(m["albedo"]),
        jnp.asarray(m["ior"]), *(jnp.asarray(x) for x in u))
    same = _same_choice(tl, jl)
    assert same.mean() >= 0.999
    close3(tl, jl, same)
    close3(tw, jw, same)


@pytest.fixture(scope="module")
def glass_scenes():
    jss = make_static_scene(T.build_scene_arrays(
        T.load_scn(str(GLASS_SCENE))))
    return jss, static_scene_from_numpy(jss)


def test_mat_channels_and_lobes_match_jax(glass_scenes):
    jss, ss = glass_scenes
    assert tcore.make_mat_channels(ss) == jcore.make_mat_channels(jss)
    assert sorted({int(m["type"]) for m in ss.mats}) == [0, 1, 2, 3, 4]


def _jax_select(mtype: float, present: set) -> int:
    """The lobe JAX's select chain in `bsdf_bounce` picks for one type."""
    lobes = [0] + [t for t in (1, 2) if t in present]
    if 3 in present or not present.issubset({0, 1, 2, 3, 4}):
        lobes.append(3)
    if 4 in present:
        lobes.append(4)
    picked = lobes[0]
    for i, t in enumerate(lobes[1:], start=1):
        sel = jnp.asarray(mtype, jnp.float32) >= t - 0.5
        if i < len(lobes) - 1:
            sel = sel & (jnp.asarray(mtype, jnp.float32) < t + 0.5)
        picked = t if bool(sel) else picked
    return picked


@pytest.mark.parametrize("present", [
    {0}, {0, 1}, {2}, {0, 2, 4}, {1, 3}, {4}, {0, 7}, {-1, 2}, {0, 1, 2, 3, 4},
])
def test_effective_lobe_follows_the_select_chain(present):
    """The lobe the kernel switches on, computed on the host, is the one
    JAX's select chain gives each present type (a type outside {0..4} adds
    the microfacet lobe; the last listed lobe takes every higher type)."""
    ss = static_scene_from_numpy(make_static_scene(T.build_scene_arrays(
        T.load_scn(str(GLASS_SCENE)))))
    mats = [dict(ss.mats[0], type=t) for t in sorted(present)]
    ss = ss._replace(mats=mats, n_mats=len(mats))
    order = tcore.lobe_order(ss)
    for t in present:
        assert tcore.effective_lobe(float(t), order) == \
            _jax_select(float(t), present), (t, order)
    table, counts = pt_cuda.pack_scene(ss)
    lobes = table[-3 - pt_cuda.MAT_STRIDE * counts[4]:-3].reshape(
        counts[4], pt_cuda.MAT_STRIDE)[:, 20]   # after the 20 channels
    assert [int(x) for x in lobes] == [_jax_select(float(t), present)
                                       for t in sorted(present)]


def bounce_inputs(seed: int):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    o = f32([rng.uniform(-270, 270, N), rng.uniform(-270, 270, N),
             rng.uniform(760, 1300, N)])
    d = f32(_unit(rng, N))
    thr = f32(rng.uniform(0.05, 1.0, (3, N)))
    rad = f32(rng.uniform(0.0, 2.0, (3, N)))
    alive = rng.random(N) < 0.8
    u = f32(rng.random((3, N)))
    return o, d, thr, rad, alive, u


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("with_miss", [False, True])
def test_bsdf_bounce_matches_jax(glass_scenes, seed, with_miss):
    """One AccPathTracer bounce on the fixture with every lobe type, rays
    from random points of the box: compared where both sides agree on
    which rays hit an object first and on the chosen lobe."""
    jss, ss = glass_scenes
    o, d, thr, rad, alive, u = bounce_inputs(seed)
    t_min = tcore.scene_epsilon(ss)
    jout = jcore.bsdf_bounce(
        jss, jcore.make_mat_channels(jss), j3(o), j3(d), j3(thr), j3(rad),
        jnp.asarray(alive), *(jnp.asarray(x) for x in u), t_min=t_min,
        with_miss=with_miss)
    tout = tcore.bsdf_bounce(
        ss, tcore.make_mat_channels(ss), t3(o), t3(d), t3(thr), t3(rad),
        torch.from_numpy(alive), *(torch.from_numpy(x) for x in u),
        t_min=t_min, with_miss=with_miss)
    assert len(tout) == len(jout) == (6 if with_miss else 5)
    talive, jalive = tout[4].numpy(), np.asarray(jout[4])
    same = (talive == jalive) & _same_choice(tout[1], jout[1])
    assert same.mean() >= 0.999
    assert talive.mean() > 0.5
    close3(tout[0], jout[0], same, atol=1e-3)
    close3(tout[1], jout[1], same)
    close3(tout[2], jout[2], same)
    close3(tout[3], jout[3], same)
    if with_miss:
        np.testing.assert_array_equal(tout[5].numpy()[same],
                                      np.asarray(jout[5])[same])
