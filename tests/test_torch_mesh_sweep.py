"""The blocked mesh sweep (B2): the port's plain version against the JAX
package's Pallas sweep in interpret mode and against its XLA blocked
oracle, with the Pallas tests' t_cap / alive / n_valid / f2b cases.

A ~200-face closed blob (a 10x11 UV sphere), blocks of 64, 5000 rays (not a
multiple of the Pallas 4096-ray tile) from a box in front of it towards
it.  `sweep_mesh_plain` follows `sweep_tile`'s float order (w = (e2 . q) *
inv_det).  Against the Pallas kernel: the same rays hit, the same winners,
shading equal, `t` within T_RTOL (XLA on the CPU fuses multiply-adds, see
T_RTOL; observed 1451 of 2756 hits bit-exact, 851 at 1 ulp, the rest up to
18 ulps).  Against `intersect_triangles_blocked`, which divides by det:
the port's torch oracle within rtol 1e-6 (the JAX tests' own bar), the
JAX one within T_RTOL.

The Pallas kernel culls a block for a whole 32x128 tile, the port per ray,
and FMA rounding can move a hit across an edge: rays that hit on one side
only or pick another winner are counted as flips, printed, and held under
0.2% of the rays (observed: none on these rays, in every case below).

The `cuda` test (a GPU; it skips without one) holds `mesh_sweep_kernel`
against the plain version: `python -m pytest tests/test_torch_mesh_sweep.py
-m cuda`."""
import pathlib
import sys

import numpy as np
import pytest
import torch

from nrenderer_torch import build_scene_arrays
from nrenderer_torch.ops import mesh_cuda
from nrenderer_torch.ops.bvh import build_mesh_accel
from nrenderer_torch.ops.soa import V3
from nrenderer_torch.scene import model
from test_torch_jax_native import jax_loader  # noqa: F401

# the JAX package's loader loads a build of this process's own
pytestmark = pytest.mark.usefixtures("jax_loader")

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

T_MIN = 1e-3
N_RAYS = 5000
# XLA's CPU code contracts a * b + c into one fused multiply-add (the
# Pallas interpreter's included); the port rounds each operation, as the
# CUDA kernel built with -fmad=false does.  At world coordinates near 1000
# the cancellations in u, v and e2 . q then move t by up to ~20 ulps
# (observed max relative 1.9e-6); hits and winners agree exactly.
T_RTOL = 4e-6
CHANNELS = [(0.25, 9.0), (1.0, 2.0)]   # two materials; the mesh uses 1


def _blob_scene(pkg_model):
    """A ~200-face blob centred on (40, -200, 920), material 1."""
    import make_mesh_fixtures
    verts, faces, centre = make_mesh_fixtures.uv_blob(rings=10, segs=11,
                                                      radius=100.0)
    verts = verts - centre + np.array([40.0, -200.0, 920.0])
    s = pkg_model.Scene()
    s.materials += [pkg_model.Material(name="A"), pkg_model.Material(name="B")]
    s.mesh_buffer.append(pkg_model.Mesh(
        positions=verts.astype(np.float32),
        position_indices=faces.reshape(-1).astype(np.int32), material=1))
    s.nodes.append(pkg_model.Node(name="blob", type=pkg_model.NodeType.MESH,
                                  entity=0))
    return s


def _rays():
    rng = np.random.default_rng(3)
    origins = rng.uniform(-400, 400, (N_RAYS, 3)).astype(np.float32)
    origins[:, 2] -= 400.0
    targets = (rng.uniform(-120, 120, (N_RAYS, 3)).astype(np.float32)
               + np.array([40.0, -200.0, 920.0], np.float32))
    d = targets - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return origins, d.astype(np.float32)


@pytest.fixture(scope="module")
def port():
    arr = build_scene_arrays(_blob_scene(model))
    ma = build_mesh_accel(arr, CHANNELS, block=64)
    o, d = _rays()
    return (ma, mesh_cuda.make_mesh_tables(ma.bt, "cpu"),
            V3(*(torch.as_tensor(o[:, i]) for i in range(3))),
            V3(*(torch.as_tensor(d[:, i]) for i in range(3))))


@pytest.fixture(scope="module")
def jax_side():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    import nrenderer_tpu as T
    from nrenderer_tpu.ops.bvh import (
        build_mesh_accel as jbuild, intersect_triangles_blocked)
    from nrenderer_tpu.ops.mesh_pallas import sweep_mesh_full
    from nrenderer_tpu.ops.soa import V3 as JV3
    from nrenderer_tpu.scene import model as jmodel
    arr = T.build_scene_arrays(_blob_scene(jmodel))
    ma = jbuild(arr, CHANNELS, block=64)
    o, d = _rays()
    jo = JV3(*(jnp.asarray(o[:, i]) for i in range(3)))
    jd = JV3(*(jnp.asarray(d[:, i]) for i in range(3)))
    cache = {}

    def sweep(**kw):
        key = tuple(sorted((k, str(v)) for k, v in kw.items()))
        if key not in cache:
            if "t_cap" in kw:
                kw["t_cap"] = jnp.asarray(kw["t_cap"])
            with pltpu.force_tpu_interpret_mode():
                out = sweep_mesh_full(ma.bt, jo, jd, T_MIN, interpret=True,
                                      **kw)
            cache[key] = tuple(np.asarray(a) for a in out)
        return cache[key]

    blocked = tuple(np.asarray(a) if not isinstance(a, tuple) else a
                    for a in intersect_triangles_blocked(ma.bt, jo, jd,
                                                         t_min=T_MIN))
    return sweep, blocked


def _ulps(a, b):
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


def _compare(got, want, label):
    """Hits and winners equal, t within T_RTOL, shading equal where the
    winner is the same; returns the number of flipped rays (a hit on one
    side only, or another winner), which may not pass 0.2% of the rays."""
    t_g, t_w = got[0].numpy(), want[0]
    hit_g, hit_w = np.isfinite(t_g), np.isfinite(t_w)
    same = hit_g & hit_w & (got[1].numpy() == want[1])
    flips = int((hit_g != hit_w).sum() + (hit_g & hit_w & ~same).sum())
    ulps = _ulps(t_g[same], t_w[same])
    print(f"{label}: {int(hit_w.sum())} hits, {flips} flipped, t off by "
          f"up to {int(ulps.max(initial=0))} ulps ({int((ulps > 1).sum())} "
          "rays past 1 ulp)")
    assert flips <= 0.002 * t_w.size
    assert (got[1].numpy()[~hit_g] == -1).all()
    np.testing.assert_allclose(t_g[same], t_w[same], rtol=T_RTOL)
    for k in range(2, 6):
        np.testing.assert_array_equal(
            np.asarray(got[k].numpy(), np.float32)[same],
            np.asarray(want[k], np.float32)[same], err_msg=f"{label} out {k}")
    return flips


def test_plain_sweep_matches_pallas_interpret(port, jax_side):
    ma, mt, o, d = port
    sweep, _ = jax_side
    want = sweep()
    got = mesh_cuda.sweep_mesh_full(mt, o, d, T_MIN)
    assert np.isfinite(want[0]).sum() > 1000
    assert got[1].dtype == torch.int32
    assert _compare(got, want, "natural order") == 0


def test_plain_sweep_matches_blocked_oracle(port, jax_side):
    """Against the blocked oracle, which divides by det where the sweep
    multiplies by its inverse: the port's torch oracle within rtol 1e-6
    (the JAX tests' bar between their two sweeps), the JAX one (XLA, fused
    multiply-adds) within T_RTOL; the same hits and winners in both."""
    from nrenderer_torch.ops.bvh import intersect_triangles_blocked
    ma, mt, o, d = port
    _, blocked = jax_side
    got = mesh_cuda.sweep_mesh_full(mt, o, d, T_MIN)
    t = got[0].numpy()
    mine = intersect_triangles_blocked(ma.bt, o, d, t_min=T_MIN)
    for want, rtol in ((tuple(a.numpy() for a in mine[:6]), 1e-6),
                       (blocked[:6], T_RTOL)):
        tb, nxb, nyb, nzb, matb, pidb = want
        hb, hp = np.isfinite(tb), np.isfinite(t)
        np.testing.assert_array_equal(hb, hp)
        np.testing.assert_allclose(t[hp], tb[hb], rtol=rtol)
        for g, w in ((got[2], nxb), (got[3], nyb), (got[4], nzb),
                     (got[5], matb), (got[1].float(), pidb)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the winners' channels from their material ids
    ch = mesh_cuda.channels_from_mat(got[5], got[1] < 0, CHANNELS)
    np.testing.assert_array_equal(ch[1].numpy()[hp], np.full(hp.sum(), 2.0))
    np.testing.assert_array_equal(ch[1].numpy(), mine[6][1].numpy())


def test_t_cap_alive_and_n_valid(port, jax_side):
    """A per-ray cap hides hits at or beyond it; a zero cap (dead rays)
    and rays past `n_valid` report nothing; exactly the uncapped sweep's
    answers otherwise, and each case as the Pallas kernel gives it."""
    ma, mt, o, d = port
    sweep, _ = jax_side
    n = N_RAYS
    tb = mesh_cuda.sweep_mesh_full(mt, o, d, T_MIN)[0].numpy()
    cap = np.where(np.arange(n) % 3 == 0, 600.0, np.inf).astype(np.float32)
    got = mesh_cuda.sweep_mesh_full(mt, o, d, T_MIN,
                                    t_cap=torch.as_tensor(cap))
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.where(tb < cap, tb, np.inf))
    assert _compare(got, sweep(t_cap=cap), "capped") == 0
    alive = np.random.default_rng(7).random(n) < 0.5
    cap = np.where(alive, np.inf, 0.0).astype(np.float32)
    got = mesh_cuda.sweep_mesh_full(mt, o, d, T_MIN,
                                    t_cap=torch.as_tensor(cap))
    np.testing.assert_array_equal(got[0].numpy(), np.where(alive, tb, np.inf))
    for n_valid in (4096, 4500):   # tile-aligned and not
        got = mesh_cuda.sweep_mesh_full(mt, o, d, T_MIN, n_valid=n_valid)
        t = got[0].numpy()
        np.testing.assert_array_equal(t[:n_valid], tb[:n_valid])
        assert not np.isfinite(t[n_valid:]).any()
        assert (got[1].numpy()[n_valid:] == -1).all()
        assert _compare(got, sweep(n_valid=n_valid), f"n_valid {n_valid}") \
            == 0


def test_front_to_back_order(port, jax_side):
    """Near-to-far block order by the ray's own octant (the Pallas kernel
    takes its tile's majority octant): the same t as the natural order,
    the same winner where t is not tied, and fewer triangle tests."""
    ma, mt, o, d = port
    sweep, _ = jax_side
    nat, f2b = {}, {}
    cap = torch.full((N_RAYS,), float("inf"))
    got_n = mesh_cuda.sweep_mesh_plain(mt, o, d, T_MIN, cap, stats=nat)
    got_f = mesh_cuda.sweep_mesh_plain(mt, o, d, T_MIN, cap, f2b=True,
                                       stats=f2b)
    np.testing.assert_array_equal(got_f[0].numpy(), got_n[0].numpy())
    np.testing.assert_array_equal(got_f[1].numpy(), got_n[1].numpy())
    assert f2b["tri_tests"] < nat["tri_tests"]
    assert nat["slab_tests"] == f2b["slab_tests"] == N_RAYS * ma.bt.n_blocks
    got = mesh_cuda.sweep_mesh_full(mt, o, d, T_MIN, f2b=True)
    assert _compare(got, sweep(f2b=True), "f2b") == 0


def test_uv_tables_interpolate_the_winner():
    """With UV tables the sweep returns the winner's (u, v, tex) in
    `sweep_tile`'s order, (uv1 + bu * ue1) + bv * ue2, bu = u * inv_det."""
    from nrenderer_torch.io.obj import load_obj
    from nrenderer_torch.ops.bvh import intersect_triangles_blocked
    arr = build_scene_arrays(load_obj(str(REPO / "resource" / "obj"
                                          / "tex_grid.obj")))
    ma = build_mesh_accel(arr, [(1.0,)], block=32)
    mt = mesh_cuda.make_mesh_tables(ma.bt, "cpu")
    rng = np.random.default_rng(1)
    n = 400
    o = V3(torch.as_tensor(rng.uniform(-1.2, 1.2, n).astype(np.float32)),
           torch.as_tensor(rng.uniform(-1.2, 1.2, n).astype(np.float32)),
           torch.full((n,), 10.0))
    d = V3(torch.zeros(n), torch.zeros(n), torch.ones(n))
    got = mesh_cuda.sweep_mesh_full(mt, o, d, T_MIN, with_uv=True)
    hit = got[1] >= 0
    assert 0.3 < float(hit.float().mean()) < 0.9
    want = intersect_triangles_blocked(ma.bt, o, d, T_MIN, with_uv=True)
    u_w, v_w, tex_w = want[7]
    np.testing.assert_allclose(got[6][hit].numpy(), u_w[hit].numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(got[7][hit].numpy(), v_w[hit].numpy(),
                               atol=1e-6)
    assert (got[8][hit] == 0).all() and (got[8][~hit] == -1).all()
    # u is 0.5 - x / 2 on the grid (vertex x = 1 - 2u)
    np.testing.assert_allclose(got[6][hit].numpy(),
                               (0.5 - o.x[hit] / 2).numpy(), atol=1e-5)
    no_uv = build_mesh_accel(build_scene_arrays(_blob_scene(model)),
                             CHANNELS).bt
    with pytest.raises(ValueError, match="UV"):
        mesh_cuda.sweep_mesh_full(mesh_cuda.make_mesh_tables(no_uv, "cpu"),
                                  o, d, T_MIN, with_uv=True)


def test_layout_and_refusals(port):
    ma, mt, o, d = port
    assert tuple(mt.tris.shape) == (ma.bt.n_blocks * 64,
                                    mesh_cuda.TRI_FLOATS)
    np.testing.assert_array_equal(mt.tris[:, 13].reshape(-1, 64).numpy(),
                                  ma.bt.pid)
    np.testing.assert_array_equal(mt.bb[:, 4:7].numpy(), ma.bt.bb_max)
    bad = mt._replace(bb=mt.bb[:, :6].contiguous())
    with pytest.raises(ValueError, match="mesh tables"):
        mesh_cuda.sweep_mesh_full(bad, o, d, T_MIN)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _tie_tables(device):
    """`chip_smoke.tie_pool()` (exact ties) in blocks of 16, and its rays."""
    sys.path.insert(0, str(REPO))
    from chip_smoke import tie_pool
    verts, faces, o, d = tie_pool()
    s = model.Scene()
    s.materials += [model.Material(name="A"), model.Material(name="B")]
    s.mesh_buffer.append(model.Mesh(positions=verts, position_indices=faces
                                    .reshape(-1), material=1))
    s.nodes.append(model.Node(name="tie", type=model.NodeType.MESH,
                              entity=0))
    bt = build_mesh_accel(build_scene_arrays(s), CHANNELS, block=16).bt
    col = lambda a: V3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]),
                                         device=device) for i in range(3)))
    return mesh_cuda.make_mesh_tables(bt, device), col(o), col(d)


@pytest.mark.cuda
@pytest.mark.parametrize("f2b", [False, True])
def test_cuda_sweep_matches_plain(port, gpu, f2b):
    """`mesh_sweep_kernel` against the plain version on the same CUDA
    rays, every output bit for bit (t and idx on every ray): the blob's
    rays, prefixes of them at ragged counts (1, 31, 33, 32 k + 5) with
    dead lanes (zero caps), and the tie pool."""
    ma, _, o, d = port
    cases = [("blob", mesh_cuda.make_mesh_tables(ma.bt, gpu),
              V3(*(a.to(gpu) for a in o)), V3(*(a.to(gpu) for a in d)),
              None)]
    for n in (1, 31, 33, 32 * 40 + 5):
        mt, og, dg = cases[0][1:4]
        cases.append((f"{n} rays", mt, V3(*(a[:n] for a in og)),
                      V3(*(a[:n] for a in dg)),
                      torch.where(torch.arange(n, device=gpu) % 3 == 1, 0.0,
                                  float("inf"))))
    cases.append(("ties", *_tie_tables(gpu), None))
    for label, mt, og, dg, cap in cases:
        n = og.x.shape[0]
        before = mesh_cuda.KERNEL_LAUNCHES[mesh_cuda.KERNEL_NAME]
        got = mesh_cuda.sweep_mesh_full(mt, og, dg, T_MIN, t_cap=cap,
                                        f2b=f2b)
        assert mesh_cuda.KERNEL_LAUNCHES[mesh_cuda.KERNEL_NAME] == before + 1
        if cap is None:
            cap = torch.full((n,), float("inf"), device=gpu)
        plain = mesh_cuda.sweep_mesh_plain(mt, og, dg, T_MIN, cap, f2b=f2b)
        t_p = torch.where(plain[1] >= 0, plain[0], float("inf"))
        assert torch.equal(got[0], t_p), label
        assert torch.equal(got[1], plain[1].to(torch.int32)), label
        for k in range(2, 6):
            assert torch.equal(got[k], plain[k]), (label, k)
