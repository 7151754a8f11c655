"""MetropolisLightTransport: the port's `renderers/mlt.py` against the JAX
package's `MLTKernel` module by module on the same numpy state vectors
(whole renders, resume and the CLI: `tests/test_torch_mlt_render.py`).

Module parity runs 64 chains at max_path 5 on `cornell_box.scn` and on
`mesh_box.scn` + `blob_960.obj` (960 faces, past MLT_BVH_THRESHOLD: the
mesh pipe; JAX's `tri_bvh` is a 16-triangle-block `build_mesh_accel`, its
Pallas sweep in interpret mode).  The state vectors u come from one numpy
seed and go to both.  Elementwise pieces (`vec_cosine`, `perturb`,
`mutate` given the same r, the eye and light starts) agree within ATOL:
sin, cos, pow, exp, log and rsqrt are rounded differently by XLA's CPU
code and by torch.  Where a piece takes paths, a chain may flip: a bounce
that hits on one side and misses, or meets another primitive, on the
other, when the rounding moves a ray across an edge.  A chain counts as
flipped where any of its values differs past RTOL; at most FLIP_MAX of the
64 may.  The combine is fed JAX's own subpaths, so only its arithmetic
(cumulative products in another order, rsqrt, sums) differs: relative
RTOL_COMBINE on every contribution, FLIP_MAX chains past it.  Measured on
both scenes: 0 flipped chains in every test; largest differences
vec_cosine 1.1e-6 (g = 999; 2.4e-7 at g = 1), mutate 6e-8, the starts
1.2e-7, the subpaths 1.2e-6 absolute, sc 5.8e-7 and the splat rows 5.9e-5
relative."""
import pathlib

import numpy as np
import pytest
import torch

import nrenderer_torch as P
from nrenderer_torch.ops import mesh_cuda
from nrenderer_torch.ops.soa import V3
from nrenderer_torch.renderers import mlt
from test_torch_jax_native import jax_loader  # noqa: F401

# the JAX package's loader loads a build of this process's own
pytestmark = pytest.mark.usefixtures("jax_loader")

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = REPO / "resource"
CHAINS = 64
MAX_PATH = 5
ATOL = 2e-6
RTOL = 1e-4
RTOL_COMBINE = 1e-4
FLIP_MAX = 2
SCENES = {"cornell": ("cornell_box.scn", ()),
          "mesh": ("mesh_box.scn", ("blob_960.obj",))}


def _scene(pkg, which, w=32, h=32, depth=MAX_PATH):
    scn, objs = SCENES[which]
    scene = pkg.Scene()
    pkg.load_scn(str(RES / scn), scene)
    for o in objs:
        pkg.load_obj(str(RES / "obj" / o), scene, material=0)
    ro = scene.render_option
    ro.width, ro.height, ro.depth = w, h, depth
    return scene


def _u(n_states, seed=5):
    return np.random.default_rng(seed).random((n_states, CHAINS),
                                              dtype=np.float32)


@pytest.fixture(scope="module")
def kernels():
    """(JAX MLTKernel, port MLTKernel) per scene, and the JAX helpers."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    import nrenderer_tpu as T
    from nrenderer_tpu.renderers import mlt as jmlt
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NR_MESH_BLOCK", "16")
        for which in SCENES:
            jk = jmlt._prepare_mlt(_scene(T, which), MAX_PATH)[0]
            pk = mlt._prepare_mlt(_scene(P, which), "cpu", MAX_PATH)[0]
            out[which] = (jk, pk)
    assert out["mesh"][0].tri_bvh is not None
    assert isinstance(out["mesh"][1].tri_bvh, mesh_cuda.MeshTables)
    assert out["cornell"][1].tri_bvh is None
    return out, jnp, pltpu


def _np(a):
    return np.asarray(a.cpu().numpy() if isinstance(a, torch.Tensor) else a)


def _flipped(got, want, rtol=RTOL, atol=ATOL):
    """Per chain (last axis): whether any value differs past the bars."""
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    bad = ~np.isclose(g, w, rtol=rtol, atol=atol, equal_nan=True)
    return bad.reshape(-1, bad.shape[-1]).any(axis=0)


def test_constants_and_scaled_scene(kernels):
    """The unit normalisation, the camera, the light and the static scene
    as the JAX `_prepare_mlt` makes them (the mesh tables from the scaled
    arrays)."""
    out, _, _ = kernels
    for which, (jk, pk) in out.items():
        assert pk.n_states == jk.n_states == 4 * (MAX_PATH + 3)
        for name in ("pos", "u", "v", "w"):
            np.testing.assert_allclose(getattr(pk.cam, name),
                                       getattr(jk.cam, name), rtol=1e-12)
        for name in ("emitted", "light_pos", "light_u", "light_v",
                     "light_normal"):
            np.testing.assert_allclose(getattr(pk, name), getattr(jk, name),
                                       rtol=1e-12)
        assert pk.light_area == pytest.approx(jk.light_area, rel=1e-12)
        assert repr(pk.ss.sph) == repr(jk.ss.sph)
        assert repr(pk.ss.pln) == repr(jk.ss.pln)
        A, B, flat = pk._conn_triangle()
        jA, jB, jflat = jk._conn_triangle()
        np.testing.assert_array_equal(A, jA)
        np.testing.assert_array_equal(flat, jflat)
    mt, jbt = out["mesh"][1].tri_bvh, out["mesh"][0].tri_bvh.bt
    assert mt.n_blocks * mt.block >= 960
    np.testing.assert_allclose(mt.bb[:, 0:3].amin(0).numpy(),
                               np.asarray(jbt.bb_min).min(0), rtol=1e-6)


def test_vec_cosine_and_mutation(kernels):
    out, jnp, _ = kernels
    from nrenderer_tpu.ops.soa import V3 as JV3
    from nrenderer_tpu.renderers import mlt as jmlt
    import jax
    rng = np.random.default_rng(2)
    n = rng.normal(size=(3, 4096)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0)
    n[:, :4] = [[0, 0, 0, 0.1], [0, 1, 0, 0], [-1, 0, 1, -0.99999999]]
    r1, r2 = rng.random((2, 4096), dtype=np.float32)
    for g in (1.0, 999.0):
        want = jmlt.vec_cosine(JV3(*map(jnp.asarray, n)), g, jnp.asarray(r1),
                               jnp.asarray(r2))
        got = mlt.vec_cosine(V3(*map(torch.as_tensor, n)), g,
                             torch.as_tensor(r1), torch.as_tensor(r2))
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), atol=ATOL)
    jk, pk = out["cornell"]
    u = _u(pk.n_states)
    key = jax.random.PRNGKey(3)
    r = np.asarray(jax.random.uniform(key, u.shape))
    for s1, s2 in ((2.0 / 64, 0.1), (1.0 / 1024, 1.0 / 64)):
        np.testing.assert_allclose(
            _np(pk.perturb(torch.as_tensor(u), torch.as_tensor(r), s1, s2)),
            _np(jk.perturb(jnp.asarray(u), jnp.asarray(r), s1, s2)),
            atol=ATOL)
    got = pk.mutate(torch.as_tensor(u), torch.as_tensor(r))
    want = jk.mutate(jnp.asarray(u), key)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL)
    assert ((_np(got) >= 0) & (_np(got) <= 1)).all()


@pytest.mark.parametrize("which", sorted(SCENES))
def test_starts_and_generate_paths(kernels, which):
    """The eye and light starts elementwise; `generate_paths` (the mesh
    scene's bounces through the mesh pipe) chain by chain, at most
    FLIP_MAX flipped chains (measured: 0 on both scenes)."""
    out, jnp, pltpu = kernels
    jk, pk = out[which]
    u = _u(pk.n_states)
    ju, tu = jnp.asarray(u), torch.as_tensor(u)
    for got, want in zip(pk._eye_start(tu) + pk._light_start(tu),
                         jk._eye_start(ju, None) + jk._light_start(ju)):
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6,
                                       atol=ATOL)
    with pltpu.force_tpu_interpret_mode():
        jeye, jlight = jk.generate_paths(ju)
    mesh_cuda.reset_route_counts()
    eye, light = pk.generate_paths(tu)
    if which == "mesh":
        assert mesh_cuda.ROUTE_COUNTS["uncompacted"] == MAX_PATH - 1
    flips = np.zeros(CHAINS, bool)
    for g_, w_ in ((eye, jeye), (light, jlight)):
        assert g_.px.shape == (MAX_PATH + 1, CHAINS)
        for a, b in zip(g_, w_):
            flips |= _flipped(a, b)
    print(which, "generate_paths flipped chains:", int(flips.sum()),
          "mean path vertices", float(eye.count.mean()),
          float(light.count.mean()))
    assert flips.sum() <= FLIP_MAX
    assert float(eye.count.mean()) > 2.0


@pytest.mark.parametrize("which", sorted(SCENES))
def test_edge_tables_and_combine_paths(kernels, which):
    """`_edge_tables` and `combine_paths` fed JAX's own subpaths, then
    `sample` from the same u end to end."""
    out, jnp, pltpu = kernels
    jk, pk = out[which]
    u = _u(pk.n_states, seed=9)
    ju = jnp.asarray(u)
    with pltpu.force_tpu_interpret_mode():
        jeye, jlight = jk.generate_paths(ju)
        jcontribs, jsc = jk.combine_paths(jeye, jlight)
        _, jsc_full = jk.sample(ju)
    to_t = lambda pb: mlt.PathBatch(*(torch.as_tensor(np.asarray(f))
                                      for f in pb))
    eye, light = to_t(jeye), to_t(jlight)
    for p, jp in ((eye, jeye), (light, jlight)):
        got, want = pk._edge_tables(p), jk._edge_tables(jp)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_allclose(_np(got[k]).astype(np.float64),
                                       _np(want[k]), rtol=1e-6, atol=1e-30,
                                       err_msg=k)
    contribs, sc = pk.combine_paths(eye, light)
    assert len(contribs) == 6
    assert contribs[0].shape == (MAX_PATH - 1, CHAINS)
    flips = _flipped(sc, jsc, rtol=RTOL_COMBINE, atol=0)
    for a, b in zip(contribs, jcontribs):
        flips |= _flipped(a, b, rtol=RTOL_COMBINE, atol=1e-12)
    print(which, "combine_paths: chains past the bar", int(flips.sum()),
          "valid rows", int(_np(contribs[5]).sum()), "sc mean",
          float(sc.mean()))
    assert flips.sum() <= FLIP_MAX
    assert _np(contribs[5]).sum() > CHAINS // 4 and float(sc.max()) > 0
    _, sc_full = pk.sample(torch.as_tensor(u))
    flips = _flipped(sc_full, jsc_full, rtol=1e-3, atol=0)
    print(which, "sample: chains past the bar", int(flips.sum()))
    assert flips.sum() <= FLIP_MAX


def test_state_uniforms_layout():
    """The counter-based draws of the module docstring."""
    from nrenderer_torch.ops.pt_core import hash_uniform
    u = mlt.state_uniforms(10, 7, 5, 3, 11, "cpu")
    assert u.shape == (10, 7) and u.dtype == torch.float32
    assert float(u[2, 4]) == float(hash_uniform(4, 5, 5, 11))
    assert ((u >= 0) & (u < 1)).all()
