"""The bilinear-form mesh sweep (B4, the MXU engine): the port's plain
version against the JAX package's `NR_MESH_MXU=1` route (the Pallas
`_sweep_kernel_mxu` in interpret mode) and against the port's blocked
sweep (B2), the engine select, the hybrid route under the switch, (on a
GPU) the CUDA kernel against its plain version, and the rays where the two
engines part on the card (`test_engines_at_shared_edges`).

The pool: `resource/mesh_box.scn` + `blob_960.obj` in 16-triangle blocks
(60 blocks; the Pallas interpreter's compile grows with the block), 5000
rays (not a multiple of the 4096-ray Pallas tile) from inside the box
towards the blob, uncapped, with per-ray caps, with half the rays dead
(zero caps) and with `n_valid` = 4500 (a partial tile).

The bars start from `tests/test_mesh_pallas.py:67-91`'s, which hold JAX's
MXU route against its blocked sweep: flipped hit/miss on at most
max(2, 0.2%) of the rays, t within rtol 1e-4 where both hit, the same
triangle on >= 99.8% of those, the winner's shading within 1e-5.  JAX sums
the forms in a float32 matrix product whose order and fused multiply-adds
are its own; the port sums them in one fixed order, so the two differ in
the last bits of det, u, v and t*det; B2 computes t by another formula.
Measured on these rays, in every case: against JAX 0 flipped rays, 0
other winners, t within 5.5e-5 relative; against B2 0 flipped rays, 0
other winners, t within 1.2e-5 relative but for one ray at 1.003e-4 (it
meets its triangle at grazing incidence, |cos| = 0.0023, where det is
small and t = ws / det is ill-conditioned in both forms); the winner's
shading equal everywhere (both read the table row).  So the bars here:
against JAX, test_mesh_pallas's with at most 2 flipped rays and every t
within rtol 1e-4; against B2, flipped rays and rays past rtol 1e-4 (the
grazing ones) together at most 2 and every t within rtol 1e-3; the same
triangle on >= 99.8% and the shading equal in both."""
import pathlib

import numpy as np
import pytest
import torch

import nrenderer_torch as P
from nrenderer_torch.ops import mesh_cuda, mesh_mxu
from nrenderer_torch.ops.bvh import build_mesh_accel
from nrenderer_torch.ops.soa import V3
from test_torch_jax_native import jax_loader  # noqa: F401

# the JAX package's loader loads a build of this process's own
pytestmark = pytest.mark.usefixtures("jax_loader")

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = REPO / "resource"
T_MIN = 1e-3
N_RAYS = 5000
BLOCK = 16
CHANNELS = [(0.725, 0.71, 0.68), (0.63, 0.065, 0.05), (0.14, 0.45, 0.091)]
# test_mesh_pallas's bars, tightened where the measurement allows (module
# docstring): at most FLIP_MAX flipped rays (its bar: max(2, 0.2%) = 10
# here); against B2 the grazing rays past T_RTOL count with the flips and
# stay within T_RTOL_GRAZING
FLIP_MAX = 2
T_RTOL = 1e-4
T_RTOL_GRAZING = 1e-3
SAME_TRI_MIN = 0.998


def _scene(pkg):
    scene = pkg.Scene()
    pkg.load_scn(str(RES / "mesh_box.scn"), scene)
    pkg.load_obj(str(RES / "obj" / "blob_960.obj"), scene, material=0)
    return scene


def _rays():
    rng = np.random.default_rng(11)
    o = np.stack([rng.uniform(-270, 270, N_RAYS), rng.uniform(-270, 270,
                                                              N_RAYS),
                  rng.uniform(760, 1300, N_RAYS)], axis=1)
    tgt = np.stack([rng.uniform(-130, 130, N_RAYS),
                    rng.uniform(-285, -10, N_RAYS),
                    rng.uniform(860, 1110, N_RAYS)], axis=1)
    d = tgt - o
    dist = np.linalg.norm(d, axis=1)
    d /= dist[:, None]
    return o.astype(np.float32), d.astype(np.float32), dist


def _cases():
    """(t_cap, n_valid) per case."""
    _, _, dist = _rays()
    inf = np.full(N_RAYS, np.inf, np.float32)
    every3 = np.where(np.arange(N_RAYS) % 3 == 0, 0.9 * dist,
                      np.inf).astype(np.float32)
    alive = np.random.default_rng(7).random(N_RAYS) < 0.5
    return {"uncapped": (inf, None), "capped": (every3, None),
            "alive": (np.where(alive, np.inf, 0.0).astype(np.float32), None),
            "n_valid": (inf, 4500)}


@pytest.fixture(scope="module")
def port():
    arrays = P.build_scene_arrays(_scene(P))
    ma = build_mesh_accel(arrays, CHANNELS, block=BLOCK)
    o, d, _ = _rays()
    return (mesh_cuda.make_mesh_tables(ma.bt, "cpu"),
            V3(*(torch.as_tensor(o[:, i]) for i in range(3))),
            V3(*(torch.as_tensor(d[:, i]) for i in range(3))))


@pytest.fixture(scope="module")
def jax_mxu():
    """JAX's MXU route on each case (Pallas in interpret mode)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    import nrenderer_tpu as T
    from nrenderer_tpu.ops.bvh import build_mesh_accel as jbuild
    from nrenderer_tpu.ops.mesh_pallas import sweep_mesh_full
    from nrenderer_tpu.ops.soa import V3 as JV3
    ma = jbuild(T.build_scene_arrays(_scene(T)), CHANNELS, block=BLOCK)
    o, d, _ = _rays()
    jo = JV3(*(jnp.asarray(o[:, i]) for i in range(3)))
    jd = JV3(*(jnp.asarray(d[:, i]) for i in range(3)))
    out = {}
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setenv("NR_MESH_MXU", "1")
        for name, (cap, n_valid) in _cases().items():
            with pltpu.force_tpu_interpret_mode():
                res = sweep_mesh_full(ma.bt, jo, jd, T_MIN,
                                      t_cap=jnp.asarray(cap),
                                      n_valid=n_valid, interpret=True)
            out[name] = tuple(np.asarray(a) for a in res)
    return out


def _port(port, case, mxu, monkeypatch):
    mt, o, d = port
    cap, n_valid = _cases()[case]
    monkeypatch.setenv("NR_MESH_MXU", "1" if mxu else "0")
    mesh_cuda.reset_route_counts()
    out = mesh_cuda.sweep_mesh_full(mt, o, d, T_MIN,
                                    t_cap=torch.as_tensor(cap),
                                    n_valid=n_valid)
    assert mesh_cuda.ENGINE_COUNTS["mxu" if mxu else "blocked"] == 1
    return tuple(a.numpy() for a in out)


def _compare(got, want, label, cap, t_outliers=0):
    """The bars of the module docstring, with at most `t_outliers` rays
    (counted with the flips) past T_RTOL; returns the measured figures."""
    t_g, t_w = got[0], want[0]
    hg, hw = np.isfinite(t_g), np.isfinite(t_w)
    both = hg & hw
    flips = int((hg != hw).sum())
    same = got[1][both] == want[1][both]
    rel = np.abs(t_g[both] - t_w[both]) / np.abs(t_w[both])
    st = {"hits": int(hw.sum()), "flips": flips,
          "same_tri": float(same.mean()), "t_rel_max": float(rel.max()),
          "t_past_rtol": int((rel > T_RTOL).sum())}
    print(label, st)
    assert hw.sum() > 0.3 * N_RAYS
    assert flips <= FLIP_MAX and st["t_past_rtol"] <= t_outliers
    assert flips + st["t_past_rtol"] <= FLIP_MAX
    assert st["t_rel_max"] < T_RTOL_GRAZING
    assert st["same_tri"] >= SAME_TRI_MIN
    for k in (2, 3, 4, 5):   # the winner's table row, read as it is
        np.testing.assert_array_equal(got[k][both][same],
                                      want[k][both][same])
    # misses: idx -1, t inf, zero shading; nothing at or past the cap
    assert (got[1][~hg] == -1).all() and (got[2][~hg] == 0).all()
    assert (t_g[hg] < cap[hg]).all()
    return st


@pytest.mark.parametrize("case", ["uncapped", "capped", "alive", "n_valid"])
def test_plain_mxu_matches_jax_mxu_route(port, jax_mxu, monkeypatch, case):
    got = _port(port, case, True, monkeypatch)
    cap, n_valid = _cases()[case]
    _compare(got, jax_mxu[case], f"B4 plain vs JAX MXU, {case}", cap)
    if n_valid is not None:
        assert (got[1][n_valid:] == -1).all()


@pytest.mark.parametrize("case", ["uncapped", "capped", "alive", "n_valid"])
def test_mxu_matches_blocked_sweep(port, monkeypatch, case):
    """B4's plain version against B2's (both the port's), at the same
    bars; with t tied exactly across the two forms nowhere."""
    got = _port(port, case, True, monkeypatch)
    want = _port(port, case, False, monkeypatch)
    _compare(got, want, f"B4 vs B2 plain, {case}", _cases()[case][0],
             t_outliers=FLIP_MAX)


def test_engine_select_and_layout(port, monkeypatch):
    """NR_MESH_MXU=1 sends untextured sweeps to B4 (f2b ignored: natural
    order) and keeps textured ones on B2; the device table is JAX's
    (4B, 16) table with features 10-15 dropped; a pool without the table
    stays on B2."""
    mt, o, d = port
    monkeypatch.setenv("NR_MESH_MXU", "1")
    mesh_cuda.reset_route_counts()
    a = mesh_cuda.sweep_mesh_full(mt, o, d, T_MIN, f2b=True)
    b = mesh_cuda.sweep_mesh_full(mt, o, d, T_MIN)
    assert mesh_cuda.ENGINE_COUNTS == {"mxu": 2, "blocked": 0,
                                       "blocked_textured_under_mxu": 0}
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    no_table = mt._replace(coef=None, center=None)
    mesh_cuda.sweep_mesh_full(no_table, o, d, T_MIN)
    assert mesh_cuda.ENGINE_COUNTS["blocked"] == 1
    with pytest.raises(ValueError, match="coefficient table"):
        mesh_mxu.sweep_mxu(mt._replace(coef=mt.coef[:, :16].contiguous()),
                           o, d, T_MIN, torch.full((N_RAYS,), np.inf))
    bt = build_mesh_accel(P.build_scene_arrays(_scene(P)), CHANNELS,
                          block=BLOCK).bt
    want = bt.mxu_coef.reshape(bt.n_blocks, 4, BLOCK, 16).transpose(
        0, 2, 1, 3)
    np.testing.assert_array_equal(
        mt.coef.numpy().reshape(bt.n_blocks, BLOCK, 4, 10), want[..., :10])
    assert mt.center == bt.mxu_center and (want[..., 10:] == 0).all()
    # a textured pool: its with_uv sweeps stay on B2
    tex = P.build_scene_arrays(P.load_obj(str(RES / "obj" / "tex_grid.obj")))
    tt = mesh_cuda.make_mesh_tables(build_mesh_accel(tex, [(1.0,)]).bt, "cpu")
    n = 64
    to = V3(torch.zeros(n), torch.linspace(-0.9, 0.9, n),
            torch.full((n,), 10.0))
    td = V3(torch.zeros(n), torch.zeros(n), torch.ones(n))
    mesh_cuda.reset_route_counts()
    uv = mesh_cuda.sweep_mesh_full(tt, to, td, T_MIN, with_uv=True)
    plain = mesh_cuda.sweep_mesh_full(tt, to, td, T_MIN)
    assert mesh_cuda.ENGINE_COUNTS == {"mxu": 1, "blocked": 0,
                                       "blocked_textured_under_mxu": 1}
    assert (uv[1] >= 0).any() and torch.equal(uv[1], plain[1])


def test_hybrid_route_under_the_switch(monkeypatch):
    """AccPathTracer's hybrid route on `ico_5120.obj` (staged, compacted
    at test sizes) with NR_MESH_MXU=1 sweeps every bounce on B4, and its
    film is within `chip_smoke.py`'s phase-4 bars of the same route on B2
    (>= 99.5% of pixels within 1e-4 on the gamma'd film, mean |d| <=
    2e-3; measured: bit for bit at 24x24, 4 spp, depth 13)."""
    from nrenderer_torch.ops.camera import make_camera
    from nrenderer_torch.ops.intersect import make_static_scene
    from nrenderer_torch.ops.pt_core import make_mat_channels
    from nrenderer_torch.renderers._wavefront import build_render_fn
    scene = P.Scene()
    P.load_scn(str(RES / "mesh_box.scn"), scene)
    P.load_obj(str(RES / "obj" / "ico_5120.obj"), scene, material=0)
    arrays = P.build_scene_arrays(scene)
    ss = make_static_scene(arrays)
    mt = mesh_cuda.make_mesh_tables(
        build_mesh_accel(arrays, make_mat_channels(ss)).bt, "cpu")
    cam = make_camera(scene.camera, device="cpu")
    monkeypatch.setattr(mesh_cuda, "MESH_COMPACT_MIN", 64)
    monkeypatch.setattr(mesh_cuda, "CAP_MIN", 128)
    monkeypatch.setattr(mesh_cuda, "CAP_ALIGN", 128)
    w, h, spp, depth = 24, 24, 4, 13
    films, engines = {}, {}
    for mxu in ("1", "0"):
        monkeypatch.setenv("NR_MESH_MXU", mxu)
        mesh_cuda.reset_route_counts()
        films[mxu] = build_render_fn(ss, cam, w, h, depth, spp, tri_bvh=mt,
                                     staged=True)(0, 0, spp)
        engines[mxu] = dict(mesh_cuda.ENGINE_COUNTS)
    assert engines["1"]["mxu"] >= 13 and engines["1"]["blocked"] == 0
    assert engines["0"]["mxu"] == 0 and engines["0"]["blocked"] >= 13
    assert mesh_cuda.ROUTE_COUNTS["compacted"] >= 1
    img = {k: torch.sqrt(torch.clamp(f * (1.0 / spp), min=0.0))
           for k, f in films.items()}
    d = (img["1"] - img["0"]).abs()
    share = float((d.max(dim=1).values <= 1e-4).float().mean())
    print("hybrid route, B4 vs B2: max |d|", float(d.max()), "mean",
          float(d.mean()), "share within 1e-4", share)
    assert torch.isfinite(films["1"]).all()
    assert share >= 0.995 and float(d.mean()) <= 2e-3
    assert float(img["1"].mean()) > 0.05


# Phase 17's rays where B4 and B2 part (`chip_smoke.py` on an H100, 2^20
# rays on ico_5120.obj): o, d, then each kernel's (t, pid) as printed
EDGE_RAYS = [
    ((-85.77082824707031, -194.42079162597656, 1075.23046875),
     (0.5424129366874695, 0.3670678734779358, -0.7556780576705933),
     (0.007068116217851639, 4277), (0.007081722840666771, 4277)),
    ((38.455352783203125, -82.3275146484375, 1095.8818359375),
     (0.2798864245414734, -0.6556538939476013, -0.7012714743614197),
     (201.9481964111328, 3475), (9.603615760803223, 1399)),
    ((37.687255859375, 248.7857666015625, 785.8261108398438),
     (-0.16050882637500763, -0.9480003118515015, 0.2748315930366516),
     (382.3536071777344, 2169), (517.8584594726562, 4558)),
]


def _surfaces(tris, t_min, o, d):
    """Along one ray, in float64 over the float32 table's triangles: (t,
    least barycentric coordinate) of the first surface it meets and the t
    of the next surface behind it."""
    v1, e1, e2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    p = np.cross(d, e2)
    det = (e1 * p).sum(1)
    tv = o - v1
    q = np.cross(tv, e1)
    u, v, t = (tv * p).sum(1) / det, (q @ d) / det, (e2 * q).sum(1) / det
    margin = np.minimum(np.minimum(u, v), 1.0 - u - v)
    t_in = np.where((margin >= 0) & (t >= t_min), t, np.inf)
    j = int(np.argmin(t_in))
    return t_in[j], margin[j], t_in[t_in > t_in[j] * 1.001 + 1e-3].min()


def test_engines_at_shared_edges(monkeypatch):
    """What parts B4 and B2 on the card: phase 17's three rays.  The port's
    plain versions give the kernels' printed answers bit for bit, and
    every engine, the JAX package's two (Pallas in interpret mode) too,
    meets either the first surface of a float64 intersection (t within
    1e-4 relative plus 1e-4) or, on a ray within 1e-5 of the edge two
    triangles share, the surface behind it: float32 tests of both forms
    can reject both triangles of an edge, and which rays slip through
    depends on each engine's roundings.  Measured: ray 0 starts on the
    ball (t 0.00708) and all meet it, B4's t 1.4e-5 short; ray 1 passes
    1.1e-6 inside an edge, and the port's B4 slips through to t 201.9
    where the port's B2 and both JAX routes meet it at 9.604; ray 2 passes
    1.7e-6 inside an edge, and the port's B2 and JAX's MXU route slip
    through to 517.9 where the port's B4 and JAX's blocked route meet it
    at 382.4.  So neither engine is watertight and B4 slips no more often
    than the JAX reference of its own form."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    import nrenderer_tpu as T
    from nrenderer_tpu.ops.bvh import build_mesh_accel as jbuild
    from nrenderer_tpu.ops.mesh_pallas import sweep_mesh_full as jsweep
    from nrenderer_tpu.ops.soa import V3 as JV3
    from nrenderer_torch.ops.intersect import make_static_scene
    from nrenderer_torch.ops.pt_core import make_mat_channels, scene_epsilon
    arrays = P.build_scene_arrays(_scene_ico(P))
    ss = make_static_scene(arrays)
    t_min, channels = scene_epsilon(ss), make_mat_channels(ss)
    mt = mesh_cuda.make_mesh_tables(build_mesh_accel(arrays, channels).bt,
                                    "cpu")
    jbt = jbuild(T.build_scene_arrays(_scene_ico(T)), channels).bt
    o = np.array([r[0] for r in EDGE_RAYS], np.float32)
    d = np.array([r[1] for r in EDGE_RAYS], np.float32)
    got = {}
    for mxu, name in (("1", "b4"), ("0", "b2")):
        monkeypatch.setenv("NR_MESH_MXU", mxu)
        out = mesh_cuda.sweep_mesh_full(
            mt, V3(*(torch.as_tensor(o[:, i]) for i in range(3))),
            V3(*(torch.as_tensor(d[:, i]) for i in range(3))), t_min)
        got[name] = (out[0].numpy(), out[1].numpy())
        with pltpu.force_tpu_interpret_mode():
            res = jsweep(jbt, JV3(*(jnp.asarray(o[:, i]) for i in range(3))),
                         JV3(*(jnp.asarray(d[:, i]) for i in range(3))),
                         t_min, interpret=True)
        got["jax_" + name] = (np.asarray(res[0]), np.asarray(res[1]))
    for k, (_, _, b4, b2) in enumerate(EDGE_RAYS):
        for name, want in (("b4", b4), ("b2", b2)):
            assert got[name][0][k] == np.float32(want[0])
            assert got[name][1][k] == want[1]
    tris = mt.tris.numpy().astype(np.float64)
    tris = tris[tris[:, 13] >= 0]
    through = {}
    for k in range(len(EDGE_RAYS)):
        near, margin, behind = _surfaces(tris, t_min, o[k].astype(np.float64),
                                         d[k].astype(np.float64))
        close = lambda t, ref: abs(t - ref) <= 1e-4 * ref + 1e-4
        for name, (t, _) in got.items():
            assert close(t[k], near) or (margin < 1e-5
                                         and close(t[k], behind)), (k, name)
            if not close(t[k], near):
                through.setdefault(k, set()).add(name)
        print(f"edge ray {k}: surface t {near:.6f} (margin {margin:.2e}), "
              f"behind {behind:.6f};", {n: float(t[k])
                                        for n, (t, _) in got.items()})
    assert through.get(1, set()) >= {"b4"} and "b2" not in through[1]
    assert through.get(2, set()) >= {"b2"} and "b4" not in through[2]
    assert 0 not in through


def _scene_ico(pkg):
    scene = pkg.Scene()
    pkg.load_scn(str(RES / "mesh_box.scn"), scene)
    pkg.load_obj(str(RES / "obj" / "ico_5120.obj"), scene, material=0)
    return scene


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["uncapped", "capped", "alive", "n_valid"])
def test_cuda_mxu_sweep_matches_plain(port, gpu, monkeypatch, case):
    """`mesh_sweep_mxu_kernel` against the plain version on the same CUDA
    rays: every output bit for bit, one launch."""
    mt, o, d = port
    bt = build_mesh_accel(P.build_scene_arrays(_scene(P)), CHANNELS,
                          block=BLOCK).bt
    mtg = mesh_cuda.make_mesh_tables(bt, gpu)
    og, dg = V3(*(a.to(gpu) for a in o)), V3(*(a.to(gpu) for a in d))
    cap, n_valid = _cases()[case]
    monkeypatch.setenv("NR_MESH_MXU", "1")
    before = mesh_mxu.KERNEL_LAUNCHES[mesh_mxu.KERNEL_NAME]
    got = mesh_cuda.sweep_mesh_full(mtg, og, dg, T_MIN,
                                    t_cap=torch.as_tensor(cap, device=gpu),
                                    n_valid=n_valid)
    assert mesh_mxu.KERNEL_LAUNCHES[mesh_mxu.KERNEL_NAME] == before + 1
    capg = torch.as_tensor(cap, device=gpu)
    if n_valid is not None:
        capg = torch.where(torch.arange(N_RAYS, device=gpu) < n_valid, capg,
                           0.0)
    plain = mesh_mxu.sweep_mxu_plain(mtg, og, dg, T_MIN, capg)
    t_p = torch.where(plain[1] >= 0, plain[0], float("inf"))
    assert torch.equal(got[0], t_p)
    assert torch.equal(got[1], plain[1].to(torch.int32))
    for k in range(2, 6):
        assert torch.equal(got[k], plain[k])
