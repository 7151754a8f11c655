"""AccPathTracer's hybrid mesh route: the mesh pipe
(`mesh_cuda.intersect_triangles_mesh`: top-AABB cull, the streaming pack,
the entry-cell sort, the standalone sweep, the unpack) against the JAX
package's stream engine, the staged wavefront against the port's
megamesh plain version, its own unstaged wavefront and JAX's staged
wavefront, the env-map and textured forms of the route, and the renderer
and CLI on it.

The mesh pipe: the ~200-face blob of `test_torch_mesh_sweep.py` in blocks
of 16, 5000 rays, MESH_COMPACT_MIN lowered to 64 on both sides (as
`tests/test_mesh_pallas.py:162` does), Pallas in interpret mode at
NR_STREAM_ROWS=64.  t is held at rtol 4e-6 (XLA fuses multiply-adds on the
CPU, `test_torch_mesh_sweep.T_RTOL`), ids, materials, normals and channels
equal where the winner is the same, flipped rays (a hit on one side only
or another winner) under 0.2% (observed: none).  Every branch of the port's
pipe (uncompacted, compacted with and without the sort, overflow) gives
the same answers bit for bit.

The staged wavefront draws the kernel's hash uniforms, so on a pool both
routes accept it computes the megamesh route's paths: its film is held to
the megakernel's plain version within phase 4's bars of `chip_smoke.py`
(>= 99.5% of pixels within 1e-4 on the gamma'd film, mean |d| <= 2e-3;
observed: bit for bit).  Against JAX's staged wavefront (`jax.random`
draws) the comparison is statistical, with `tests/test_staged.py`'s bars.

The `cuda` test (a GPU; it skips without one) holds the route with its
kernels against the route with the plain versions: `python -m pytest
tests/test_torch_hybrid.py -m cuda`."""
import pathlib
import sys

import numpy as np
import pytest
import torch

import nrenderer_torch as P
from nrenderer_torch import cli
from nrenderer_torch.io.image import read_png
from nrenderer_torch.ops import mesh_cuda, stream_compact
from nrenderer_torch.ops.bvh import build_mesh_accel
from nrenderer_torch.ops.camera import make_camera
from nrenderer_torch.ops.intersect import make_static_scene
from nrenderer_torch.ops.pt_core import (
    closest_hit, make_mat_channels, scene_epsilon,
)
from nrenderer_torch.ops.pt_cuda import pt_accumulate_plain
from nrenderer_torch.ops.soa import V3
from nrenderer_torch.renderers import _wavefront, routes
from nrenderer_torch.renderers._wavefront import build_render_fn
from nrenderer_torch.renderers.acc_pt import AccPathTracerRenderer
from nrenderer_torch.scene import model
from nrenderer_torch.server.registry import get_server

from test_torch_mesh_sweep import CHANNELS, N_RAYS, T_MIN, T_RTOL, \
    _blob_scene, _rays
from test_torch_jax_native import jax_loader  # noqa: F401

# the JAX package's loader loads a build of this process's own
pytestmark = pytest.mark.usefixtures("jax_loader")

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = REPO / "resource"
OBJ = RES / "obj"
sys.path.insert(0, str(REPO / "tools"))
# the Pallas sweep's interpret compile grows with the block: 16-triangle
# blocks keep the three JAX pipe runs near 20 s
PIPE_BLOCK = 16
# phase 4's bars (chip_smoke.py)
WITHIN, WITHIN_SHARE_MIN, MEAN_ABS_MAX = 1e-4, 0.995, 2e-3


def _pipe_cases():
    n = N_RAYS
    inf = np.full(n, np.inf, np.float32)
    alive = np.random.default_rng(7).random(n) < 0.5
    every3 = np.where(np.arange(n) % 3 == 0, 600.0, np.inf).astype(
        np.float32)
    return {"plain": (inf, None), "alive": (inf, alive),
            "t_dense": (every3, None)}


@pytest.fixture(scope="module")
def pipe():
    arr = P.build_scene_arrays(_blob_scene(model))
    ma = build_mesh_accel(arr, CHANNELS, block=PIPE_BLOCK)
    o, d = _rays()
    return (mesh_cuda.make_mesh_tables(ma.bt, "cpu"),
            V3(*(torch.as_tensor(o[:, i]) for i in range(3))),
            V3(*(torch.as_tensor(d[:, i]) for i in range(3))))


@pytest.fixture(scope="module")
def jax_pipe():
    """JAX's stream engine on each case, compaction lowered to 64 rays."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    import nrenderer_tpu as T
    import nrenderer_tpu.ops.mesh_pallas as mp
    from nrenderer_tpu.ops.bvh import build_mesh_accel as jbuild
    from nrenderer_tpu.ops.soa import V3 as JV3
    from nrenderer_tpu.scene import model as jmodel
    ma = jbuild(T.build_scene_arrays(_blob_scene(jmodel)), CHANNELS,
                block=PIPE_BLOCK)
    o, d = _rays()
    jo = JV3(*(jnp.asarray(o[:, i]) for i in range(3)))
    jd = JV3(*(jnp.asarray(d[:, i]) for i in range(3)))
    out = {}
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setenv("NR_STREAM_ROWS", "64")
        mpatch.setattr(mp, "MESH_COMPACT_MIN", 64)
        for name, (t_dense, alive) in _pipe_cases().items():
            with pltpu.force_tpu_interpret_mode():
                res = mp.intersect_triangles_mesh(
                    ma, jo, jd, T_MIN, jnp.asarray(t_dense), CHANNELS,
                    alive=None if alive is None else jnp.asarray(alive))
            out[name] = tuple(np.asarray(a) for a in res[:6]) + (
                tuple(np.asarray(c) for c in res[6]),)
    return out


def _port_pipe(pipe, case, **kw):
    mt, o, d = pipe
    t_dense, alive = _pipe_cases()[case]
    return mesh_cuda.intersect_triangles_mesh(
        mt, o, d, T_MIN, torch.as_tensor(t_dense), CHANNELS,
        alive=None if alive is None else torch.as_tensor(alive), **kw)


def _compare(got, want, label):
    """(t, nx, ny, nz, mat, pid, chans) of the port against JAX's."""
    t_g, t_w = got[0].numpy(), want[0]
    hit_g, hit_w = np.isfinite(t_g), np.isfinite(t_w)
    same = hit_g & hit_w & (got[5].numpy() == want[5])
    flips = int((hit_g != hit_w).sum() + (hit_g & hit_w & ~same).sum())
    print(f"{label}: {int(hit_w.sum())} hits, {flips} flipped")
    assert hit_w.sum() > 1000 and flips <= 0.002 * t_w.size
    np.testing.assert_allclose(t_g[same], t_w[same], rtol=T_RTOL)
    for k in (1, 2, 3, 4, 5):
        np.testing.assert_array_equal(got[k].numpy()[same], want[k][same])
    assert (got[5].numpy()[~hit_g] == -1).all()
    for cg, cw in zip(got[6], want[6]):
        np.testing.assert_array_equal(cg.numpy()[same], cw[same])


def _low_compaction(monkeypatch):
    monkeypatch.setattr(mesh_cuda, "MESH_COMPACT_MIN", 64)
    mesh_cuda.reset_route_counts()


@pytest.mark.parametrize("case", ["plain", "alive", "t_dense"])
def test_mesh_pipe_matches_jax_stream_engine(pipe, jax_pipe, monkeypatch,
                                             case):
    """The default cap (n / 4 rounded up to 4096): the plain case's 4223
    surviving rays overflow it (the full sweep), the others compact."""
    _low_compaction(monkeypatch)
    got = _port_pipe(pipe, case)
    want_route = "overflow_full_sweeps" if case == "plain" else "compacted"
    assert mesh_cuda.ROUTE_COUNTS[want_route] == 1
    _compare(got, jax_pipe[case], case)


@pytest.mark.parametrize("branch", ["compacted", "unsorted", "overflow"])
def test_mesh_pipe_branches_match_jax(pipe, jax_pipe, monkeypatch, branch):
    """Each branch forced: the plain case compacted into a cap that holds
    it (sorted), the alive case without the sort (the coherent camera
    bounce) and the alive case overflowing a small cap."""
    _low_compaction(monkeypatch)
    monkeypatch.setattr(mesh_cuda, "CAP_ALIGN", 128)
    # caps of 4352, 4096 and 1024 rays: CAP_MIN, or 5000 // 5 aligned
    case, kw, consts = {
        "compacted": ("plain", {}, {"CAP_MIN": 4352}),
        "unsorted": ("alive", {"sort": False}, {"CAP_MIN": 4096}),
        "overflow": ("alive", {}, {"CAP_MIN": 128,
                                   "MESH_COMPACT_FRACTION": 5})}[branch]
    for name, value in consts.items():
        monkeypatch.setattr(mesh_cuda, name, value)
    got = _port_pipe(pipe, case, **kw)
    route = "overflow_full_sweeps" if branch == "overflow" else "compacted"
    assert mesh_cuda.ROUTE_COUNTS[route] == 1
    _compare(got, jax_pipe[case], f"{case}, {branch}")


@pytest.mark.parametrize("case", ["plain", "alive", "t_dense"])
def test_compacted_equals_uncompacted_bit_for_bit(pipe, monkeypatch, case):
    """The compacted pipe (pack, sort, sweep, unsort, unpack) gives the
    uncompacted sweep's answers on every ray, bit for bit."""
    whole = _port_pipe(pipe, case)          # under MESH_COMPACT_MIN
    assert mesh_cuda.ROUTE_COUNTS["uncompacted"] >= 1
    _low_compaction(monkeypatch)
    monkeypatch.setattr(mesh_cuda, "CAP_ALIGN", 128)
    monkeypatch.setattr(mesh_cuda, "CAP_MIN", 4352)
    comp = _port_pipe(pipe, case)
    assert mesh_cuda.ROUTE_COUNTS["compacted"] == 1
    for a, b in zip(comp[:6], whole[:6]):
        assert torch.equal(a, b)
    for a, b in zip(comp[6], whole[6]):
        assert torch.equal(a, b)


def _blob_box(pkg, env=False):
    """mesh_box.scn with a 120-face blob (a pool both mesh routes take)."""
    import make_mesh_fixtures
    s = pkg.Scene()
    pkg.load_scn(str(RES / "mesh_box.scn"), s)
    verts, faces, _ = make_mesh_fixtures.uv_blob(rings=6, segs=12,
                                                 radius=150.0)
    s.mesh_buffer.append(pkg.Mesh(
        positions=verts.astype(np.float32),
        position_indices=faces.reshape(-1).astype(np.int32), material=0))
    s.nodes.append(pkg.Node(name="blob", type=pkg.NodeType.MESH, entity=0))
    if env:
        from test_torch_acc_pt import _attach_env
        _attach_env(s)
    return s


def _inputs(scene):
    arrays = P.build_scene_arrays(scene)
    ss = make_static_scene(arrays)
    mt = mesh_cuda.make_mesh_tables(
        build_mesh_accel(arrays, make_mat_channels(ss)).bt, "cpu")
    return arrays, ss, make_camera(scene.camera, device="cpu"), mt


def _gamma(film, spp):
    return torch.sqrt(torch.clamp(film * (1.0 / spp), min=0.0))


def _bars(a, b, spp, label):
    d = (_gamma(a, spp) - _gamma(b, spp)).abs()
    share = float((d.max(dim=1).values <= WITHIN).float().mean())
    print(f"{label}: max |d| {float(d.max())}, mean {float(d.mean())}, "
          f"share within {WITHIN} {share}")
    assert torch.isfinite(a).all()
    assert share >= WITHIN_SHARE_MIN and float(d.mean()) <= MEAN_ABS_MAX


def _compact_small(monkeypatch):
    """Compaction at test sizes: 1024-ray wavefronts, caps of 128s."""
    monkeypatch.setattr(mesh_cuda, "MESH_COMPACT_MIN", 64)
    monkeypatch.setattr(mesh_cuda, "CAP_MIN", 128)
    monkeypatch.setattr(mesh_cuda, "CAP_ALIGN", 128)
    mesh_cuda.reset_route_counts()
    _wavefront.reset_route_counts()


def test_staged_route_matches_megamesh_plain(monkeypatch):
    """The staged hybrid film at depth 13 against the megamesh kernel's
    plain version at the same (seed, sp0, n_spp): no stage overflows here
    (the roulette never fires), so both trace the same paths."""
    _compact_small(monkeypatch)
    _, ss, cam, mt = _inputs(_blob_box(P))
    w, h, spp, depth = 16, 16, 4, 13
    film = build_render_fn(ss, cam, w, h, depth, spp, tri_bvh=mt,
                           staged=True)(5, 8, spp)
    assert _wavefront.ROUTE_COUNTS == {"chunks": 1, "stage_packs": 2,
                                       "roulette": 0}
    assert mesh_cuda.ROUTE_COUNTS["compacted"] >= 6
    want = pt_accumulate_plain(torch.zeros((w * h, 3)), ss, cam, w, h, 8,
                               spp, depth, 5, scene_epsilon(ss), bsdf=True,
                               mesh=mt)
    _bars(film, want, spp, "staged hybrid vs megamesh plain")
    assert float(_gamma(film, spp).mean()) > 0.05


def _closed_box():
    """cornell_box.scn closed by a front wall at the box's opening, with
    the camera inside: paths die only at the light, so the alive count
    passes the 1/2 and 1/4 stage buffers."""
    text = (RES / "cornell_box.scn").read_text().replace(
        "Plane BackWall White", "Plane FrontWall White\nN 0 0 1\n"
        "P 278 278 -277\nU -556 0 0\nV 0 -556 0\nPlane BackWall White", 1)
    scene = P.Scene()
    from nrenderer_torch.io.scn import parse_scn
    parse_scn(text, scene)
    scene.camera.position = (0.0, 0.0, 800.0)
    return scene


def test_staged_roulette_matches_unstaged():
    """With the roulette firing at both stage boundaries, the staged film
    agrees with the unstaged one within `tests/test_staged.py`'s bars
    (observed at 32x32, 64 spp: image means 0.575 and 0.584, mean |d|
    0.020)."""
    scene = _closed_box()
    ss = make_static_scene(P.build_scene_arrays(scene))
    cam = make_camera(scene.camera, device="cpu")
    w, h, spp, depth = 32, 32, 64, 13
    img = {}
    for staged in (True, False):
        _wavefront.reset_route_counts()
        film = build_render_fn(ss, cam, w, h, depth, spp,
                               staged=staged)(0, 0, spp)
        img[staged] = torch.clamp(_gamma(film, spp), max=1.0).numpy()
        if staged:
            assert _wavefront.ROUTE_COUNTS == {
                "chunks": 1, "stage_packs": 2, "roulette": 2}
    a, b = img[True], img[False]
    print("roulette staged vs unstaged: means", a.mean(), b.mean(),
          "mean |d|", np.abs(a - b).mean())
    assert np.isfinite(a).all() and (a >= 0).all()
    assert abs(a.mean() - b.mean()) < 0.02
    assert np.abs(a - b).mean() < 0.06


def test_staged_matches_jax_staged_wavefront(monkeypatch):
    """JAX's AccPathTracer with NR_STAGED=1 (its staged XLA wavefront,
    `jax.random` draws) against the port's staged wavefront on
    cornell_box.scn at 48x48, 64 spp, depth 13.  The image means agree
    within 0.02 (`tests/test_staged.py`); the small light makes the film
    noisy at 64 spp (two seeds of the port differ by 0.35 mean |d| per
    pixel), so its second bar, mean |d| < 0.06, is held on 8x8-pixel block
    means (observed 0.041; two seeds of the port: 0.044)."""
    pytest.importorskip("jax")
    import nrenderer_tpu
    from nrenderer_tpu.server.manager import ComponentManager
    monkeypatch.setenv("NR_STAGED", "1")
    monkeypatch.setenv("NR_STREAM_ROWS", "64")
    nrenderer_tpu._register_builtin_renderers()
    w, h, spp, depth = 48, 48, 64, 13
    jscene = nrenderer_tpu.load_scn(str(RES / "cornell_box.scn"))
    ro = jscene.render_option
    ro.width, ro.height, ro.samples_per_pixel, ro.depth = w, h, spp, depth
    mgr = ComponentManager()
    mgr.exec("AccPathTracer", jscene)
    want = mgr.wait(timeout=600).pixels[..., :3]   # row 0 = top
    scene = P.load_scn(str(RES / "cornell_box.scn"))
    ss = make_static_scene(P.build_scene_arrays(scene))
    film = build_render_fn(ss, make_camera(scene.camera, device="cpu"), w,
                           h, depth, spp, staged=True)(0, 0, spp)
    got = np.clip(_gamma(film, spp).numpy().reshape(h, w, 3)[::-1], 0, 1)
    blocks = lambda a: a.reshape(6, 8, 6, 8, 3).mean(axis=(1, 3))
    print("port vs JAX staged: means", got.mean(), want.mean(),
          "block mean |d|", np.abs(blocks(got) - blocks(want)).mean())
    assert abs(got.mean() - want.mean()) < 0.02
    assert np.abs(blocks(got) - blocks(want)).mean() < 0.06


def test_env_route_compacted_and_staged(monkeypatch):
    """Under the env map: the unstaged route (depth 4) with the compacted
    pipe equals the uncompacted wavefront bit for bit, and the staged
    route (depth 13) agrees with the unstaged one within phase 4's bars
    when no roulette fires."""
    arrays, ss, cam, mt = _inputs(_blob_box(P, env=True))
    env = torch.as_tensor(np.asarray(arrays.env_map, np.float32)[..., :3])
    w, h, spp = 16, 16, 4
    mesh_cuda.reset_route_counts()
    whole = build_render_fn(ss, cam, w, h, 4, spp, tri_bvh=mt,
                            env_map=env)(0, 0, spp)
    assert mesh_cuda.ROUTE_COUNTS["compacted"] == 0
    _compact_small(monkeypatch)
    comp = build_render_fn(ss, cam, w, h, 4, spp, tri_bvh=mt,
                           env_map=env)(0, 0, spp)
    assert mesh_cuda.ROUTE_COUNTS["compacted"] >= 1
    assert torch.equal(comp, whole)
    assert float(_gamma(whole, spp).mean()) > 0.1
    _wavefront.reset_route_counts()
    staged = build_render_fn(ss, cam, w, h, 13, spp, tri_bvh=mt,
                             env_map=env, staged=True)(0, 0, spp)
    plain = build_render_fn(ss, cam, w, h, 13, spp, tri_bvh=mt,
                            env_map=env)(0, 0, spp)
    assert _wavefront.ROUTE_COUNTS == {"chunks": 2, "stage_packs": 2,
                                       "roulette": 0}
    _bars(staged, plain, spp, "env staged vs unstaged")


def _tiled_grid(copies: int = 9):
    """tex_grid.scn with tex_grid.obj and copies of it stacked behind it
    (128 faces each): a textured pool past MEGAMESH_MAX_TRIS."""
    import dataclasses
    scene = P.Scene()
    P.load_scn(str(RES / "tex_grid.scn"), scene)
    P.load_obj(str(OBJ / "tex_grid.obj"), scene)
    mesh, node = scene.mesh_buffer[0], scene.nodes[0]
    for k in range(1, copies):
        pos = np.asarray(mesh.positions, np.float32).copy()
        pos[:, 2] += 0.05 * k     # behind the grid, seen from the camera
        scene.mesh_buffer.append(dataclasses.replace(mesh, positions=pos))
        scene.nodes.append(dataclasses.replace(
            node, name=f"grid{k}", entity=len(scene.mesh_buffer) - 1))
        scene.models[node.model].nodes.append(len(scene.nodes) - 1)
    return scene


def test_textured_hybrid_route(monkeypatch):
    """A textured pool of 1152 faces takes the hybrid route: the pipe
    carries the winner's UVs, `texture.resolve_diffuse` gives JAX's texels
    on those hits, and the image's left half is red, its right half
    green."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from nrenderer_tpu.ops import texture as jtex
    from nrenderer_torch.ops.texture import resolve_diffuse
    scene = _tiled_grid()
    arrays, ss, cam, mt = _inputs(scene)
    assert len(ss.tri) == 1152 > routes.MEGAMESH_MAX_TRIS
    assert mt.uvs is not None
    rng = np.random.default_rng(4)
    n = 2000
    xy = [torch.as_tensor(rng.uniform(-2.5, 2.5, n).astype(np.float32))
          for _ in range(2)]
    o = V3(xy[0], xy[1], torch.full((n,), 10.0))
    d = V3(torch.zeros(n), torch.zeros(n), torch.ones(n))
    _compact_small(monkeypatch)
    mat_ch = make_mat_channels(ss)
    hit = closest_hit(ss, o, d, 1e-3, mat_ch, tri_bvh=mt, with_uv=True)
    assert mesh_cuda.ROUTE_COUNTS["compacted"] == 1
    sweep = mesh_cuda.sweep_mesh_full(mt, o, d, 1e-3, with_uv=True)
    on = sweep[1] >= 0
    assert 0.08 < float(on.float().mean()) < 0.3
    for got, want in zip(hit.uv, sweep[6:9]):
        assert torch.equal(got[on], want[on])
    textures = tuple(torch.as_tensor(np.asarray(t, np.float32)[..., :3])
                     for t in arrays.textures)
    from nrenderer_tpu.ops.soa import V3 as JV3
    grey = V3(*(torch.full((n,), 0.5) for _ in range(3)))
    got = resolve_diffuse(textures, hit.uv, grey)
    want = jtex.resolve_diffuse(
        tuple(jnp.asarray(t.numpy()) for t in textures),
        tuple(jnp.asarray(u.numpy()) for u in hit.uv),
        JV3(*(jnp.asarray(c.numpy()) for c in grey)))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert (got.x[on] != 0.5).any()
    ro = scene.render_option
    ro.width, ro.height, ro.samples_per_pixel, ro.depth = 24, 24, 16, 2
    img = AccPathTracerRenderer(device="cpu").render(scene).pixels
    mid = slice(8, 16)
    left, right = img[mid, 4:10, :3], img[mid, 14:20, :3]
    assert left[..., 0].mean() > 1.5 * left[..., 1].mean()
    assert right[..., 1].mean() > 1.5 * right[..., 0].mean()


def _ico_scene(w, h, spp, depth):
    scene = P.Scene()
    P.load_scn(str(RES / "mesh_box.scn"), scene)
    P.load_obj(str(OBJ / "ico_5120.obj"), scene, material=0)
    ro = scene.render_option
    ro.width, ro.height, ro.samples_per_pixel, ro.depth = w, h, spp, depth
    return scene


def test_cli_renders_ico_5120_on_the_hybrid_route(tmp_path):
    """`--obj ico_5120.obj` (5120 faces, past the megamesh route's 1024)
    renders on the CPU, staged at depth 13, and the log names the
    engine."""
    get_server().logger.clear()
    out = tmp_path / "ico.png"
    rc = cli.main(["render", "--scene", str(RES / "mesh_box.scn"), "--obj",
                   str(OBJ / "ico_5120.obj"), "--renderer", "AccPathTracer",
                   "--width", "16", "--height", "12", "--spp", "4",
                   "--depth", "13", "--device", "cpu", "--out", str(out)])
    assert rc == 0
    img = read_png(str(out))
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    assert 0.02 < img.mean() < 0.9
    log = " | ".join(m.content for m in get_server().logger.get())
    assert "hybrid mesh route, staged wavefront" in log
    assert "5120 triangles (40 blocks of 128)" in log
    assert "stage_packs 2, roulette 0" in log


def test_hybrid_checkpoint_resume_equals_uninterrupted(tmp_path,
                                                       monkeypatch):
    """A --checkpoint render on the hybrid route runs one call per chunk
    (samples [step * chunk, (step + 1) * chunk) at the render's seed); one
    that dies in its third chunk resumes and ends with the image of the
    render that was never interrupted."""
    monkeypatch.setitem(routes.HYBRID_BUDGET_RAYS, "cpu", 8 * 6 * 2)
    whole = AccPathTracerRenderer(
        device="cpu", seed=3, checkpoint_path=str(tmp_path / "w.npz")
    ).render(_ico_scene(8, 6, 8, 3)).pixels
    real = routes.build_render_fn
    calls = []

    def dies_on_third(*args, **kw):
        fn = real(*args, **kw)

        def render(seed, sp0, n_spp):
            calls.append((seed, sp0, n_spp))
            if len(calls) == 3:
                raise KeyboardInterrupt("interrupted")
            return fn(seed, sp0, n_spp)
        return render

    ckpt = tmp_path / "film.npz"
    monkeypatch.setattr(routes, "build_render_fn", dies_on_third)
    with pytest.raises(KeyboardInterrupt):
        AccPathTracerRenderer(device="cpu", seed=3,
                              checkpoint_path=str(ckpt)).render(
            _ico_scene(8, 6, 8, 3))
    assert calls == [(3, 0, 2), (3, 2, 2), (3, 4, 2)]
    assert int(np.load(ckpt)["spp_done"]) == 4
    monkeypatch.setattr(routes, "build_render_fn", real)
    resumed = AccPathTracerRenderer(
        device="cpu", seed=3, checkpoint_path=str(ckpt)).render(
        _ico_scene(8, 6, 8, 3)).pixels
    np.testing.assert_array_equal(resumed, whole)
    assert np.isfinite(whole).all() and whole[..., :3].mean() > 0.02


def test_stage_plan_and_pick_chunk():
    from nrenderer_torch.renderers.routes import pick_chunk
    assert _wavefront.stage_plan(20) == [(0, 1), (6, 2), (11, 4), (16, 8)]
    assert _wavefront.stage_plan(8) == [(0, 1), (6, 2)]
    assert _wavefront.stage_plan(5) == [(0, 1)]
    assert pick_chunk(500, 500, 256, 1 << 24) == 64
    assert pick_chunk(512, 512, 256, 1 << 24) == 64
    assert pick_chunk(16, 16, 7) == 7


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_hybrid_route_matches_plain_versions(gpu, monkeypatch):
    """The staged route with `mesh_sweep_kernel`, `stream_pack_kernel` and
    `stream_unpack_kernel` against the same route with their plain
    versions on the card: bit for bit, and each kernel launched."""
    scene = _ico_scene(64, 48, 4, 13)
    arrays = P.build_scene_arrays(scene)
    ss = make_static_scene(arrays)
    cam = make_camera(scene.camera, device=gpu)
    mt = mesh_cuda.make_mesh_tables(
        build_mesh_accel(arrays, make_mat_channels(ss)).bt, gpu)
    _compact_small(monkeypatch)
    fn = build_render_fn(ss, cam, 64, 48, 13, 4, tri_bvh=mt, staged=True)
    mesh_cuda.reset_launch_counts()
    stream_compact.reset_launch_counts()
    film = fn(0, 0, 4)
    assert mesh_cuda.KERNEL_LAUNCHES[mesh_cuda.KERNEL_NAME] > 0
    assert min(stream_compact.KERNEL_LAUNCHES.values()) > 0
    sc = stream_compact
    monkeypatch.setattr(sc, "stream_pack_channels", sc.stream_pack_plain)
    monkeypatch.setattr(sc, "stream_unpack_channels", sc.stream_unpack_plain)
    monkeypatch.setattr(_wavefront, "stream_pack_channels",
                        sc.stream_pack_plain)
    monkeypatch.setattr(_wavefront, "stream_unpack_channels",
                        sc.stream_unpack_plain)
    monkeypatch.setattr(
        mesh_cuda, "_sweep_cuda",
        lambda mt, o, d, t_min, cap, f2b, with_uv: mesh_cuda.sweep_mesh_plain(
            mt, o, d, t_min, cap, f2b=f2b, with_uv=with_uv))
    assert torch.equal(fn(0, 0, 4), film)
