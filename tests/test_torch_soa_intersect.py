"""The SoA intersect (`ops/intersect.py`: `make_scene_soa`,
`intersect_scene`, `intersect_area_lights`, `select_mat`) and the SoA
helpers (`ops/soa.py`) against the JAX package's, on the same scene arrays
and the same random rays (numpy seeds).

JAX runs `intersect_scene` under `jax.jit`, as its RayCast and
GeometryPreview do; XLA on the CPU then fuses multiply-adds, so t agrees
at rtol 4e-6 (the sweep tests' bar for that rounding), with an atol of
2e-5 for short hits, whose rounding follows the world coordinates (~1000
units: 2e-5 is about a third of an ulp there; read: 9.5e-6 at t ~ 0.5),
not t.  The hit point,
hence a sphere's normal (p - c) / r, moves with t and with the fused
p = o + t d: normals are held within 1e-6 plus two ulps of |p| over the
smallest radius where t is bit for bit, and within that plus t's bar
over the radius elsewhere (planes and triangles carry their stored
normal).
Validity and material are exact wherever the two nearest hits are not
tied within that rtol (a tie may pick either primitive).  On exact ties
the first primitive wins on both sides.  The chunked intersect is bit for
bit the unchunked one."""
import importlib
import pathlib

import numpy as np
import pytest
import torch

import nrenderer_torch as P
from nrenderer_torch.ops import intersect as pi
from nrenderer_torch.ops.soa import (
    V3, lerp3, norm3, one_hot_argmin, reflect3, select_prim, select_prim3,
    splat, to_array, v3,
)
from test_torch_jax_native import jax_loader  # noqa: F401

# the JAX package's loader loads a build of this process's own
pytestmark = pytest.mark.usefixtures("jax_loader")

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = REPO / "resource"
RTOL = 4e-6
ATOL = 2e-5
N_RAYS = 4096


def _scene(name):
    """(JAX SceneArrays, port SceneArrays) of an in-repo scene."""
    pytest.importorskip("jax")
    import nrenderer_tpu as T
    out = []
    for mod in (T, P):
        scene = mod.load_scn(str(RES / f"{name}.scn"))
        if name == "mesh_box":
            mod.load_obj(str(RES / "obj" / "blob_960.obj"), scene,
                         material=0)
        out.append(mod.build_scene_arrays(scene))
    return out


def _rays(n, seed, origin_box=((-250, 250), (-250, 250), (760, 1290))):
    """Origins inside the Cornell shell, directions uniform on the sphere
    (float32, from a numpy seed)."""
    rng = np.random.default_rng(seed)
    o = np.stack([rng.uniform(lo, hi, n) for lo, hi in origin_box], 1)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _jax_hits(ja, o, d, t_min):
    import jax
    import jax.numpy as jnp
    from nrenderer_tpu.ops import intersect as ji
    from nrenderer_tpu.ops.soa import V3 as JV3

    @jax.jit
    def run(ja, o, d):
        s = ji.make_scene_soa(ja)
        ov = JV3(o[:, 0], o[:, 1], o[:, 2])
        dv = JV3(d[:, 0], d[:, 1], d[:, 2])
        h = ji.intersect_scene(s, ov, dv, t_min=t_min)
        tl, rad = ji.intersect_area_lights(s, ov, dv, t_min=t_min)
        return h, tl, rad

    h, tl, rad = run(ja, jnp.asarray(o), jnp.asarray(d))
    return (np.asarray(h.t), np.asarray(h.valid),
            np.stack([np.asarray(c) for c in h.normal], 1),
            np.asarray(h.mat_oh), np.asarray(tl),
            np.stack([np.asarray(c) for c in rad], 1))


def _port_hits(pa, o, d, t_min, chunk=None):
    s = pi.make_scene_soa(pa, device="cpu")
    ov = splat(torch.as_tensor(o))
    dv = splat(torch.as_tensor(d))
    h = pi.intersect_scene(s, ov, dv, t_min=t_min, chunk=chunk)
    tl, rad = pi.intersect_area_lights(s, ov, dv, t_min=t_min, chunk=chunk)
    return h, tl, rad


def _second_t(ja, o, d, t_min):
    """Each ray's second-nearest primitive distance (float64 host math
    on the JAX package's own per-type tests, run eagerly)."""
    import jax
    from nrenderer_tpu.ops import intersect as ji
    from nrenderer_tpu.ops.soa import V3 as JV3
    with jax.disable_jit():
        s = ji.make_scene_soa(ja)
        ov = JV3(*(o[:, k] for k in range(3)))
        dv = JV3(*(d[:, k] for k in range(3)))
        t_all = np.concatenate([
            np.asarray(ji._sphere_ts(s, ov, dv, t_min)),
            np.asarray(ji._triangle_ts(s, ov, dv, t_min)),
            np.asarray(ji._patch_ts(s.pln_pos, s.pln_normal, s.pln_inv0,
                                    s.pln_inv1, s.pln_valid, ov, dv,
                                    t_min))], axis=0)
    return np.sort(t_all, axis=0)[:2]


@pytest.mark.parametrize("name", ["cornell_box", "pt_glass_box",
                                  "mesh_box"])
@pytest.mark.parametrize("t_min", [pi.T_MIN_PT, pi.T_MIN_RAYCAST])
def test_intersect_matches_jax(name, t_min):
    ja, pa = _scene(name)
    o, d = _rays(N_RAYS, seed=len(name))
    jt, jvalid, jn, jmat, jtl, jrad = _jax_hits(ja, o, d, t_min)
    h, tl, rad = _port_hits(pa, o, d, t_min)
    t = h.t.numpy()
    np.testing.assert_array_equal(h.valid.numpy(), jvalid)
    fin = jvalid
    np.testing.assert_allclose(t[fin], jt[fin], rtol=RTOL, atol=ATOL)
    assert np.isinf(t[~fin]).all() and np.isinf(jt[~fin]).all()
    # material exact where the two nearest hits are not tied
    first, second = _second_t(ja, o, d, t_min)
    with np.errstate(invalid="ignore"):     # inf - inf on misses
        apart = fin & (second - first > 4 * (RTOL * np.abs(first) + ATOL))
    mat = h.mat_oh.numpy()
    np.testing.assert_array_equal(mat[:, apart], jmat[:, apart])
    np.testing.assert_array_equal(mat[:, ~fin], 0.0)
    assert apart.sum() >= 0.95 * fin.sum()
    n = np.stack([c.numpy() for c in h.normal], 1)
    # a sphere's normal (p - c) / r carries the hit point's rounding: XLA
    # fuses p = o + t d, an ulp of |p| (~1000) over r
    radii = np.asarray(pa.sph_radius)[np.asarray(pa.sph_valid)]
    p_ulp = 2.0 ** -23 * np.abs(np.stack(
        [c.numpy() for c in h.point], 1)).max(axis=1)
    ulp_r = 2 * p_ulp / (radii.min() if radii.size else 1.0)
    same_t = apart & (t == jt)
    assert (np.abs(n[same_t] - jn[same_t])
            <= 1e-6 + ulp_r[same_t, None]).all()
    tol = (RTOL * np.abs(jt) + ATOL) / (radii.min() if radii.size else 1.0)
    assert (np.abs(n[apart] - jn[apart])
            <= (1e-6 + ulp_r + tol)[apart, None]).all()
    # area lights
    lfin = np.isfinite(jtl)
    np.testing.assert_array_equal(np.isfinite(tl.numpy()), lfin)
    np.testing.assert_allclose(tl.numpy()[lfin], jtl[lfin], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(
        np.stack([c.numpy() for c in rad], 1), jrad)
    print(name, t_min, "hits", fin.mean(), "t bit for bit",
          (t[fin] == jt[fin]).mean(), "light hits", lfin.mean())


def _tie_scene(mod):
    """Two identical spheres, two identical triangles and two identical
    planes, each pair bound to different materials."""
    model = importlib.import_module(mod.__name__ + ".scene.model")
    s = mod.Scene()
    for name, rgb in (("A", (1.0, 0.0, 0.0)), ("B", (0.0, 1.0, 0.0))):
        m = mod.Material(name=name, type=0)
        m.register_property(mod.Property("diffuseColor",
                                         mod.PropertyType.RGB, rgb))
        s.materials.append(m)
    for k in range(2):
        s.nodes.append(mod.Node(name=f"s{k}", type=mod.NodeType.SPHERE,
                                entity=len(s.sphere_buffer)))
        s.sphere_buffer.append(mod.Sphere(position=(0.0, 0.0, 50.0),
                                          radius=10.0, material=k))
        s.nodes.append(mod.Node(name=f"t{k}", type=mod.NodeType.TRIANGLE,
                                entity=len(s.triangle_buffer)))
        s.triangle_buffer.append(model.Triangle(
            v1=(-40.0, -40.0, 80.0), v2=(40.0, -40.0, 80.0),
            v3=(0.0, 40.0, 80.0), normal=(0.0, 0.0, -1.0), material=k))
        s.nodes.append(mod.Node(name=f"p{k}", type=mod.NodeType.PLANE,
                                entity=len(s.plane_buffer)))
        s.plane_buffer.append(mod.Plane(
            position=(-100.0, -100.0, 120.0), u=(200.0, 0.0, 0.0),
            v=(0.0, 200.0, 0.0), normal=(0.0, 0.0, -1.0), material=k))
    return s


def test_exact_ties_first_primitive_wins():
    pytest.importorskip("jax")
    import nrenderer_tpu as T
    ja = T.build_scene_arrays(_tie_scene(T))
    pa = P.build_scene_arrays(_tie_scene(P))
    o, d = _rays(2048, seed=7, origin_box=((-5, 5), (-5, 5), (0, 1)))
    d[:, 2] = np.abs(d[:, 2]) + 2.0          # forward, into the pairs
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jt, jvalid, _, jmat, _, _ = _jax_hits(ja, o, d, pi.T_MIN_PT)
    h, _, _ = _port_hits(pa, o, d, pi.T_MIN_PT)
    mat = h.mat_oh.numpy()
    assert jvalid.all() and h.valid.numpy().all()
    np.testing.assert_array_equal(mat, jmat)
    np.testing.assert_array_equal(mat[0], 1.0)   # material A: the first
    # the three kinds of pair were all hit
    t = h.t.numpy()
    assert (t < 45).any() and ((t > 75) & (t < 81)).any() and \
        (t > 100).any()


def _leaves(x):
    """The tensors of nested tuples (HitSoA, V3), in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for c in x for t in _leaves(c)]


def test_chunked_is_unchunked_bit_for_bit():
    _, pa = _scene("mesh_box")
    o, d = _rays(3001, seed=3)
    whole = _port_hits(pa, o, d, pi.T_MIN_RAYCAST, chunk=1 << 20)
    for chunk in (1, 37, 1024):
        part = _port_hits(pa, o, d, pi.T_MIN_RAYCAST, chunk=chunk)
        for a, b in zip(_leaves(whole), _leaves(part)):
            assert torch.equal(a, b)
    assert pi.soa_chunk(965) * 965 * 4 <= pi.SOA_PLANE_BYTES
    assert pi.soa_chunk(5125) >= 1


def test_one_hot_argmin_ties_match_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from nrenderer_tpu.ops import soa as js
    rng = np.random.default_rng(0)
    t = rng.integers(0, 3, size=(6, 500)).astype(np.float32)
    t[:, :5] = np.inf                      # all-miss columns
    got = one_hot_argmin(torch.as_tensor(t)).numpy()
    want = np.asarray(js.one_hot_argmin(jnp.asarray(t)))
    np.testing.assert_array_equal(got, want)
    first = np.argmax(t == t.min(axis=0), axis=0)
    np.testing.assert_array_equal(got.argmax(axis=0), first)
    table = rng.normal(size=6).astype(np.float32)
    np.testing.assert_array_equal(
        select_prim(torch.as_tensor(got), torch.as_tensor(table)).numpy(),
        np.asarray(js.select_prim(jnp.asarray(want), jnp.asarray(table))))


def test_soa_helpers_match_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from nrenderer_tpu.ops import soa as js
    rng = np.random.default_rng(1)
    a, b = (rng.normal(size=(3, 64)).astype(np.float32) for _ in range(2))
    t = rng.uniform(size=64).astype(np.float32)
    pa_, pb = V3(*map(torch.as_tensor, a)), V3(*map(torch.as_tensor, b))
    ja_, jb = js.V3(*map(jnp.asarray, a)), js.V3(*map(jnp.asarray, b))
    arr = lambda v: np.stack([np.asarray(c) for c in v])
    np.testing.assert_allclose(arr(reflect3(pa_, pb)),
                               arr(js.reflect3(ja_, jb)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(arr(lerp3(pa_, pb, torch.as_tensor(t))),
                               arr(js.lerp3(ja_, jb, jnp.asarray(t))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(norm3(pa_).numpy(), np.asarray(js.norm3(ja_)),
                               rtol=1e-6)
    np.testing.assert_array_equal(to_array(pa_).numpy(), a.T)
    np.testing.assert_array_equal(
        arr(splat(torch.as_tensor(a.T.copy()))), a)
    oh = np.eye(3, 64, dtype=np.float32)
    np.testing.assert_array_equal(
        arr(select_prim3(torch.as_tensor(oh), v3(*a[:, :3]))),
        arr(js.select_prim3(jnp.asarray(oh), js.v3(*a[:, :3]))))
    from nrenderer_tpu.ops import intersect as ji
    moh = np.eye(4, 64, dtype=np.float32)[rng.permutation(4)]
    col = V3(*map(torch.as_tensor, a[:, :4]))
    np.testing.assert_array_equal(
        arr(pi.select_mat3(torch.as_tensor(moh), col)),
        arr(ji.select_mat3(jnp.asarray(moh), js.V3(*map(jnp.asarray,
                                                         a[:, :4])))))
