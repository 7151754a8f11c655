"""The hybrid route's bounce in two forms (`renderers/_wavefront.py`): on a
card over an untextured pool, the wavefront kernels around the mesh pipe
(`pt_cuda.wavefront_dense_hit`, `mesh_cuda.intersect_triangles_mesh`,
`pt_cuda.wavefront_shade`, state updated in place), and otherwise the
eager torch ops of `pt_cuda.bsdf_bounce_env`.

On the CPU: which form the route takes by what the scene holds, the
wrappers' checks, the route's counters, the lane numbering the shade
kernel draws by, and the fused form's plumbing (its state buffers, the
in-place update, the stage packs) through the wrappers' plain versions,
whose films equal the eager route's bit for bit.

The `cuda` tests (a GPU; they skip without one) hold the two kernels
against the eager bounce on the card bit for bit, on `mesh_box.scn` and
the five-lobe `pt_glass_box.scn` with `ico_5120.obj` as the pool, with and
without an env map, at the camera bounce, a bounce with dead lanes and
the first bounce after a stage pack: `python -m pytest
tests/test_torch_wavefront_bounce.py -m cuda`.  They import no JAX."""
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

import nrenderer_torch as P
from nrenderer_torch import cli
from nrenderer_torch.ops import mesh_cuda, pt_cuda
from nrenderer_torch.ops.bvh import build_mesh_accel
from nrenderer_torch.ops.camera import make_camera
from nrenderer_torch.ops.intersect import make_static_scene
from nrenderer_torch.ops.pt_core import (
    bounce_seed, hash_uniform, make_mat_channels, scene_epsilon,
)
from nrenderer_torch.ops.soa import V3
from nrenderer_torch.ops.stream_compact import stream_pack_channels
from nrenderer_torch.renderers import _wavefront
from nrenderer_torch.server.registry import get_server

from test_torch_acc_pt import _attach_env

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = REPO / "resource"
ICO = RES / "obj" / "ico_5120.obj"
sys.path.insert(0, str(REPO / "tools"))


def _blob_box(env: bool):
    """mesh_box.scn with a 120-face blob."""
    import make_mesh_fixtures
    s = P.Scene()
    P.load_scn(str(RES / "mesh_box.scn"), s)
    verts, faces, _ = make_mesh_fixtures.uv_blob(rings=6, segs=12,
                                                 radius=150.0)
    s.mesh_buffer.append(P.Mesh(
        positions=verts.astype(np.float32),
        position_indices=faces.reshape(-1).astype(np.int32), material=0))
    s.nodes.append(P.Node(name="blob", type=P.NodeType.MESH, entity=0))
    if env:
        _attach_env(s)
    return s


def _inputs(scene, device):
    """(scene tables, camera, mesh tables, env map or None) on `device`:
    the map only when the ambient is one, as the route takes it
    (`routes.build_route`; a constant ambient's arrays hold a 1x1 map)."""
    arrays = P.build_scene_arrays(scene)
    ss = make_static_scene(arrays)
    mt = mesh_cuda.make_mesh_tables(
        build_mesh_accel(arrays, make_mat_channels(ss)).bt, device)
    env = None
    if ss.ambient_type == 1:
        env = torch.as_tensor(np.ascontiguousarray(
            np.asarray(arrays.env_map, np.float32)[..., :3]), device=device)
    return ss, make_camera(scene.camera, device=device), mt, env


def _compact_small(monkeypatch):
    """The pipe's compaction at test sizes."""
    monkeypatch.setattr(mesh_cuda, "MESH_COMPACT_MIN", 64)
    monkeypatch.setattr(mesh_cuda, "CAP_MIN", 128)
    monkeypatch.setattr(mesh_cuda, "CAP_ALIGN", 128)


def _on(device_type):
    """A stand-in for tables on a device of this type."""
    return types.SimpleNamespace(device=torch.device(device_type))


@pytest.mark.parametrize("case,want", [
    ("cuda", "fused"), ("cuda textured", "eager"), ("cpu", "eager"),
    ("callable sweep", "eager"), ("no pool", "eager")])
def test_bounce_form_by_what_the_scene_holds(case, want):
    """A pool's tables on a card take the kernels unless textures are
    resolved; the CPU, a callable sweep (the megamesh route's plain form)
    and a wavefront without a pool take the torch ops."""
    tables = lambda dev: mesh_cuda.MeshTables(
        tris=_on(dev), uvs=None, bb=_on(dev), f2b=_on(dev), n_blocks=1,
        block=128)
    tri_bvh, textures = {
        "cuda": (tables("cuda"), None),
        "cuda textured": (tables("cuda"), (torch.zeros(4, 4, 3),)),
        "cpu": (tables("cpu"), None),
        "callable sweep": (lambda o, d, cap: None, None),
        "no pool": (None, None)}[case]
    assert _wavefront.bounce_form(tri_bvh, textures) == want


@pytest.fixture(scope="module")
def wave():
    """Tables, a wavefront of 40 rays at the blob with every fourth dead,
    the pipe's winner and the lanes of a pack, on the CPU."""
    ss, cam, mt, _ = _inputs(_blob_box(False), "cpu")
    t_min = scene_epsilon(ss)
    wt = pt_cuda.make_wave_tables(ss, t_min, None, "cpu")
    n = 40
    g = torch.Generator().manual_seed(3)
    o = V3(*(torch.zeros(n) for _ in range(3)))
    d = V3(*(torch.rand(n, generator=g) - 0.5 for _ in range(2)),
           torch.ones(n))
    alive = torch.arange(n) % 4 != 0
    cap = pt_cuda.wavefront_dense_hit(wt, o, d, alive)
    hit = mesh_cuda.intersect_triangles_mesh(mt, o, d, t_min, cap, None)
    thr = V3(*(torch.ones(n) for _ in range(3)))
    rad = V3(*(torch.zeros(n) for _ in range(3)))
    lane = torch.randperm(4 * n, generator=g)[:n].to(torch.int32)
    return wt, o, d, thr, rad, alive, hit[:5], lane


def _bad_cases():
    f64 = lambda a: a.to(torch.float64)
    strided = lambda a: torch.stack([a, a], dim=1)[:, 0]
    return {
        "float64 ray": lambda o, alive, hit, lane: (
            V3(f64(o.x), o.y, o.z), alive, hit, lane),
        "short ray": lambda o, alive, hit, lane: (
            V3(o.x[:-1], o.y, o.z), alive, hit, lane),
        "strided ray": lambda o, alive, hit, lane: (
            V3(strided(o.x), o.y, o.z), alive, hit, lane),
        "float alive": lambda o, alive, hit, lane: (
            o, alive.float(), hit, lane),
        "int64 lanes": lambda o, alive, hit, lane: (
            o, alive, hit, lane.long()),
        "short hit": lambda o, alive, hit, lane: (
            o, alive, hit[:4], lane),
        "meta device": lambda o, alive, hit, lane: (
            V3(*(x.to("meta") for x in o)), alive.to("meta"), hit, lane)}


@pytest.mark.parametrize("case", sorted(_bad_cases()))
def test_wrappers_refuse_bad_inputs(wave, case):
    """Both wrappers check dtype, shape, contiguity and device before any
    launch (the shade wrapper also its hit tuple and lanes)."""
    wt, o, d, thr, rad, alive, hit, lane = wave
    bo, balive, bhit, blane = _bad_cases()[case](o, alive, hit, lane)
    with pytest.raises(ValueError):
        pt_cuda.wavefront_shade(wt, bo, d, thr, rad, balive, bhit,
                                pt_cuda.Draws(blane, 16, 0, 0, 1), 2)
    if case not in ("int64 lanes", "short hit"):
        with pytest.raises(ValueError):
            pt_cuda.wavefront_dense_hit(wt, bo, d, balive)


def test_shade_refuses_bad_lane_numbering(wave):
    wt, o, d, thr, rad, alive, hit, lane = wave
    for n_pix, sp0, pix0 in ((0, 0, 0), (16, -1, 0), (16, 0, -2),
                             (16, 1 << 31, 0)):
        with pytest.raises(ValueError):
            pt_cuda.wavefront_shade(wt, o, d, thr, rad, alive, hit,
                                    pt_cuda.Draws(lane, n_pix, sp0, pix0, 1),
                                    2)


def test_plain_shade_is_the_eager_bounce_in_place(wave):
    """The shade wrapper's CPU version writes the eager bounce's state
    into the given tensors: the dense hit's cap, the pipe's winner and the
    packed lanes' draws, dead lanes untouched."""
    wt, o, d, thr, rad, alive, hit, lane = wave
    state = [t.clone() for t in (*o, *d, *thr, *rad)]
    lives = alive.clone()
    o2, d2, thr2, rad2 = (V3(*state[k:k + 3]) for k in (0, 3, 6, 9))
    draws = pt_cuda.Draws(lane, 16, 3, 5, 7)
    pt_cuda.wavefront_shade(wt, o2, d2, thr2, rad2, lives, hit, draws, 2)
    t, nx, ny, nz, mat = hit
    idx = torch.where(torch.isinf(t), -1, 0)
    want = pt_cuda.bsdf_bounce_env(
        wt.ss, wt.mat_ch, None, o, d, thr, rad, alive, *draws.uniforms(2),
        t_min=wt.t_min, tri_bvh=lambda o_, d_, cap: (t, idx, nx, ny, nz, mat))
    for got, w in zip((*o2, *d2, *thr2, *rad2, lives),
                      (*want[0], *want[1], *want[2], *want[3], want[4])):
        assert torch.equal(got, w)
    dead = ~alive
    assert torch.equal(o2.x[dead], o.x[dead]) and not lives[dead].any()
    assert bool(lives.any()) and not torch.equal(d2.x, d.x)


@pytest.mark.parametrize("sp0,pix0,n_pix", [(0, 0, 256), (8, 1000, 96),
                                            ((1 << 31) - 3, 7, 5)])
def test_lane_numbering_gives_the_route_draws(sp0, pix0, n_pix):
    """The shade kernel's ids, pix0 + lane % n_pix and sp0 + lane / n_pix
    in uint32 arithmetic, give the draws `bounce_uniforms(lane_samples(
    ...))` gives, for packed (permuted, sparse) lanes and sample indices
    past int32."""
    g = torch.Generator().manual_seed(sp0 % 97)
    lane = torch.randperm(64 * n_pix, generator=g)[:3000].to(torch.int32)
    lu = lane.numpy().astype(np.uint32)
    with np.errstate(over="ignore"):
        upid = np.uint32(pix0) + lu % np.uint32(n_pix)
        usp = np.uint32(sp0) + lu // np.uint32(n_pix)
    bs = bounce_seed(-123456789, 17)
    want = pt_cuda.bounce_uniforms(
        *pt_cuda.lane_samples(lane, n_pix, sp0, pix0), -123456789, 17)
    for k, w in zip((4, 5, 6), want):
        got = hash_uniform(torch.as_tensor(upid.astype(np.int64)),
                           torch.as_tensor(usp.astype(np.int64)), k, bs)
        assert torch.equal(got, w)


@pytest.mark.parametrize("env", [False, True], ids=["no_env", "env"])
@pytest.mark.parametrize("staged,depth", [(True, 13), (False, 4)],
                         ids=["staged", "plain"])
def test_fused_form_plumbing_equals_eager_route(monkeypatch, env, staged,
                                                depth):
    """The route with the fused form forced on the CPU (the wrappers' plain
    versions in place on the state buffers, the stage packs' rows, the
    pipe without channels) gives the eager route's film bit for bit, and
    the counters count each form's bounces."""
    ss, cam, mt, env_map = _inputs(_blob_box(env), "cpu")
    _compact_small(monkeypatch)
    films = {}
    for form in ("eager", "fused"):
        monkeypatch.setattr(_wavefront, "bounce_form",
                            lambda *a, form=form: form)
        _wavefront.reset_route_counts()
        films[form] = _wavefront.build_render_fn(
            ss, cam, 16, 16, depth, 4, tri_bvh=mt, env_map=env_map,
            staged=staged)(5, 8, 8)
        assert _wavefront.ROUTE_COUNTS["chunks"] == 2
        assert _wavefront.ROUTE_COUNTS[f"{form}_bounces"] == 2 * depth
        other = "eager" if form == "fused" else "fused"
        assert _wavefront.ROUTE_COUNTS[f"{other}_bounces"] == 0
    assert torch.equal(films["fused"], films["eager"])
    assert float(films["eager"].mean()) > 0.1


def test_hybrid_log_line_counts_the_bounces(tmp_path):
    """On the CPU the route's 2 chunks of depth 13 run 26 eager bounces,
    and its log line says so."""
    get_server().logger.clear()
    assert cli.main(["render", "--scene", str(RES / "mesh_box.scn"),
                     "--obj", str(ICO), "--renderer", "AccPathTracer",
                     "--width", "12", "--height", "8", "--spp", "2",
                     "--depth", "13", "--device", "cpu", "--out",
                     str(tmp_path / "a.png")]) == 0
    log = " | ".join(m.content for m in get_server().logger.get())
    assert "fused_bounces 0, eager_bounces 13" in log


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_scene(name, env):
    scene = P.Scene()
    P.load_scn(str(RES / name), scene)
    # the glass box's pool takes its microfacet material, beside the
    # conductor, glass and microfacet balls and the plastic box
    P.load_obj(str(ICO), scene, material=5 if name == "pt_glass_box.scn"
               else 0)
    if env:
        _attach_env(scene)
    return scene


def _copy(state):
    o, d, thr, rad, alive = state
    st = torch.stack([*o, *d, *thr, *rad]).clone()
    return (*(V3(st[k], st[k + 1], st[k + 2]) for k in (0, 3, 6, 9)),
            alive.clone())


def _assert_same(got, want, label):
    for name, g, w in zip(("o", "d", "thr", "rad"), got[:4], want[:4]):
        for c, a, b in zip("xyz", g, w):
            diff = float((a - b).abs().max())
            assert torch.equal(a, b), f"{label}: {name}.{c} max |d| {diff}"
    assert torch.equal(got[4], want[4]), f"{label}: alive"


def _assert_kernels_match_plain(wt, mt, state, draws, b, coherent, label):
    """Each kernel alone against its plain version on the same input: the
    dense-hit kernel's cap word for word (dead lanes 0, misses inf), and,
    given the pipe's winner, the shade kernel's state."""
    o, d, thr, rad, alive = state
    cap = pt_cuda.wavefront_dense_hit(wt, o, d, alive)
    want_cap = pt_cuda.wavefront_dense_hit_plain(wt, o, d, alive)
    diff = float((cap - want_cap).nan_to_num(0.0).abs().max())
    assert torch.equal(cap, want_cap), f"{label}: cap max |d| {diff}"
    hit = mesh_cuda.intersect_triangles_mesh(mt, o, d, wt.t_min, cap, None,
                                             sort=not coherent)[:5]
    want = pt_cuda.wavefront_shade_plain(wt, *state, hit, draws, b)
    got = _copy(state)
    pt_cuda.wavefront_shade(wt, *got, hit, draws, b)
    _assert_same(got, want, f"{label}: shade kernel alone")


@pytest.mark.cuda
@pytest.mark.parametrize("env", [False, True], ids=["no_env", "env"])
@pytest.mark.parametrize("name", ["mesh_box.scn", "pt_glass_box.scn"])
def test_cuda_kernels_match_eager_bounce(gpu, monkeypatch, name, env):
    """At the camera bounce (coherent), at bounce 3 (dead lanes) and at
    the first bounce after a stage pack (packed lanes, slots past the
    count dead), the kernels' state equals the eager bounce's bit for bit
    (o, d, throughput, radiance and alive: max |d| = 0), and each kernel
    alone equals its plain version."""
    ss, cam, mt, env_map = _inputs(_card_scene(name, env), gpu)
    t_min = scene_epsilon(ss)
    _compact_small(monkeypatch)
    wt = pt_cuda.make_wave_tables(ss, t_min, env_map, gpu)
    fused = _wavefront.make_bsdf_bounce(ss, t_min, mt, env_map)
    monkeypatch.setattr(_wavefront, "bounce_form", lambda *a: "eager")
    eager = _wavefront.make_bsdf_bounce(ss, t_min, mt, env_map)
    w, h, c = 96, 64, 4
    draws, o, d = _wavefront._camera_chunk(cam, w, h, 11, 4, c, 0, w * h)
    state = _wavefront._new_state(o, d)
    pt_cuda.reset_launch_counts()
    for b in range(8):
        want = eager(*_copy(state), draws, b, coherent=b == 0)
        if b in (0, 3):
            got = fused(*_copy(state), draws, b, coherent=b == 0)
            _assert_same(got, want, f"{name} env={env} bounce {b}")
            _assert_kernels_match_plain(wt, mt, state, draws, b, b == 0,
                                        f"{name} env={env} bounce {b}")
        state = want
        if b == 3:
            assert not bool(state[4].all()) and bool(state[4].any())
    # a stage pack of bounce 8's state into half the lanes
    o, d, thr, rad, alive = state
    cap = (w * h * c // 2) // 128 * 128
    sp_k = stream_pack_channels((*o, *d, *thr, alive.to(torch.float32),
                                 draws.lane), cap, mask_from=9)
    p = sp_k.packed
    packed = (*(V3(p[k], p[k + 1], p[k + 2]) for k in (0, 3, 6)),
              V3(*torch.zeros((3, cap), device=gpu)), p[9] > 0.0)
    pdraws = draws._replace(lane=p[10].view(torch.int32))
    assert 0 < int(sp_k.count) < cap
    want = eager(*_copy(packed), pdraws, 8)
    got = fused(*_copy(packed), pdraws, 8)
    _assert_same(got, want, f"{name} env={env} after a pack")
    _assert_kernels_match_plain(wt, mt, packed, pdraws, 8, False,
                                f"{name} env={env} after a pack")
    for k in pt_cuda.WAVEFRONT_KERNELS:
        assert pt_cuda.KERNEL_LAUNCHES[k] == 6
