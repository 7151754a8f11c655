"""The route layer (`renderers/routes.py`), on the CPU at 16x16.

- Every route's checkpoint fingerprint, one-device and sharded, is pinned
  to the digest an earlier build of the port wrote for the same render, so
  a checkpoint that build left still resumes.
- The names the benchmark's harness wraps (`benchmark/harness.py`
  `Spans.install`) still carry each route: the renderer's `render` holds
  the scene prep and the whole route, and the dense one-shot routes reach
  the kernel through `simple_pt.render_simple_pt` and
  `acc_pt.render_bsdf_pt`, looked up when they run.
- The import direction: nothing under `renderers/` imports `parallel/`,
  `routes.py` imports none of the renderers that call it, and
  `parallel/mesh.py` takes no private name from `renderers/`.
- The route decisions (pass sizes, pass seeds, the megamesh rule, table
  builds) are made in `routes.py` only.

World-of-one renders of every route are held against the one-device
renders in `tests/test_torch_parallel.py`."""
import ast
import contextlib
import pathlib
import time

import numpy as np
import pytest
import torch

import nrenderer_torch as P
from nrenderer_torch.io.image import load_image
from nrenderer_torch.renderers import acc_pt, routes, simple_pt
from nrenderer_torch.scene.model import AmbientType, Texture
from nrenderer_torch.server.checkpoint import render_fingerprint

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = REPO / "resource"
PORT = REPO / "nrenderer_torch"
SEED = 3


def _scene(scn, obj=None, spp=8, depth=3, env=False):
    scene = P.load_scn(str(RES / scn))
    if obj:
        P.load_obj(str(RES / "obj" / obj), scene,
                   material=0 if scene.materials else None)
    if env:
        scene.ambient.environment_map = len(scene.textures)
        scene.textures.append(Texture(name="sky", pixels=load_image(
            str(RES / "env_sky.png"))))
        scene.ambient.type = AmbientType.ENVIRONMENT_MAP
    ro = scene.render_option
    ro.width = ro.height = 16
    ro.samples_per_pixel, ro.depth = spp, depth
    return scene


# name: (renderer, scene args, route kind, the hybrid chunk budget pinned,
# sharded, the digest the port wrote before the route layer, at seed 3)
FINGERPRINTS = {
    "progressive": ("SimplePathTracer", ("cornell_box.scn",), "progressive",
                    False, False, "97bead204d681d385ab78e0890a8efd0cb04f391"),
    "progressive-env": ("SimplePathTracer",
                        ("env_spheres.scn", None, 8, 3, True), "progressive",
                        False, False,
                        "4bd5a5b6670c535edb94f4faf35408144ef2cd69"),
    "progressive-tex": ("SimplePathTracer",
                        ("tex_grid.scn", "tex_quad.obj", 4), "progressive",
                        False, False,
                        "5f4cb2a3ea37b80da8ab1e8ee23da9bf9a995fcf"),
    "megakernel": ("AccPathTracer", ("pt_glass_box.scn", None, 16),
                   "megakernel", False, False,
                   "e275e33b31c771aa9b544d8287179adae9d53f58"),
    "megakernel-env": ("AccPathTracer",
                       ("env_spheres.scn", None, 16, 3, True), "megakernel",
                       False, False,
                       "d9c4b952005da035c0b6240a942b84158e7e77b5"),
    "megamesh": ("AccPathTracer", ("mesh_box.scn", "blob_960.obj", 64),
                 "megamesh", False, False,
                 "89fb4a7e1b5a6679299f31d94d4e8ad5b7747c71"),
    "megamesh-tex": ("AccPathTracer", ("tex_grid.scn", "tex_grid.obj", 32, 2),
                     "megamesh", False, False,
                     "81273035cf622752576f0eee3691c0c44d475a60"),
    "hybrid": ("AccPathTracer", ("mesh_box.scn", "ico_5120.obj", 4),
               "hybrid", True, False,
               "4e3c1669a819968265b9dbb0ad24b7ecc5009c71"),
    "hybrid-staged": ("AccPathTracer", ("mesh_box.scn", "ico_5120.obj", 4, 12),
                      "hybrid", True, False,
                      "3004d89c361bcb786bc518236edb5ed330a495e5"),
    "sharded-progressive": ("SimplePathTracer", ("cornell_box.scn",),
                            "progressive", False, True,
                            "91db0dc3671f989df30c30407afc1f13e38cb9a9"),
    "sharded-megakernel": ("AccPathTracer", ("pt_glass_box.scn", None, 16),
                           "megakernel", False, True,
                           "7778be8a06402c6341e4ba91f006c22cf979aae8"),
    "sharded-megamesh": ("AccPathTracer",
                         ("mesh_box.scn", "blob_960.obj", 64), "megamesh",
                         False, True,
                         "0815d9a9291026edd7afd953eb0229323cfa1561"),
    "sharded-hybrid": ("AccPathTracer", ("mesh_box.scn", "ico_5120.obj", 4),
                       "hybrid", False, True,
                       "51340dc721ff59466a0a7a4e91f18423ab15fb46"),
    "sharded-hybrid-passes": ("AccPathTracer",
                              ("mesh_box.scn", "ico_5120.obj", 4), "hybrid",
                              True, True,
                              "0f75b51984c61177e93b8757d7b9fceba9fbbc89"),
}


@pytest.mark.parametrize("name", list(FINGERPRINTS))
def test_fingerprint_is_pinned(name, monkeypatch):
    """Each route's checkpoint fingerprint, built from the route as a
    resumable render builds it: the one-device render's, or the sharded
    render's on a world of one CPU rank by samples."""
    renderer, args, kind, small, sharded, digest = FINGERPRINTS[name]
    if small:   # two hybrid chunks of 2 samples
        monkeypatch.setitem(routes.HYBRID_BUDGET_RAYS, "cpu", 16 * 16 * 2)
    scene = _scene(*args)
    route = routes.make_route(scene, renderer, True, "cpu", SEED)
    assert route.plan.kind == kind
    split = None
    if sharded:
        from nrenderer_torch.parallel.mesh import pass_count
        split = ("multichip", "samples", 1, ("cpu",),
                 pass_count(route.plan, "samples", 1))
    parts, arrays = route.fingerprint(split)
    assert render_fingerprint(parts, arrays=arrays) == digest


def test_the_renderer_writes_the_pinned_fingerprint(tmp_path):
    """The one-device progressive render saves the pinned digest."""
    ckpt = tmp_path / "f.npz"
    simple_pt.SimplePathTracerRenderer(
        seed=SEED, checkpoint_path=str(ckpt), device="cpu").render(
        _scene("cornell_box.scn"))
    assert bytes(np.load(ckpt)["fingerprint"]).decode() == \
        FINGERPRINTS["progressive"][-1]


# the attributes `benchmark/harness.py` `Spans.install` wraps, by name
HARNESS_WRAPS = (
    (simple_pt.SimplePathTracerRenderer, "render", "scene-prep"),
    (acc_pt.AccPathTracerRenderer, "render", "scene-prep"),
    (simple_pt, "render_simple_pt", "render"),
    (acc_pt, "render_bsdf_pt", "render"),
    (acc_pt.AccPathTracerRenderer, "_render_megamesh", "render"),
    (acc_pt.AccPathTracerRenderer, "_render_hybrid", "render"),
)

# name: (renderer class, its keywords, scene args, route kind, unit,
# whether the harness's wraps time its render)
SEAMS = {
    "dense": (simple_pt.SimplePathTracerRenderer, {}, ("cornell_box.scn",),
              "dense", "samples", True),
    "progressive": (simple_pt.SimplePathTracerRenderer,
                    {"progressive": True}, ("cornell_box.scn",),
                    "progressive", "passes", False),
    "megakernel": (acc_pt.AccPathTracerRenderer, {}, ("pt_glass_box.scn",),
                   "megakernel", "samples", True),
    "megakernel-passes": (acc_pt.AccPathTracerRenderer, {"checkpoint": True},
                          ("pt_glass_box.scn", None, 16), "megakernel",
                          "passes", False),
    "megamesh": (acc_pt.AccPathTracerRenderer, {},
                 ("mesh_box.scn", "blob_960.obj", 32), "megamesh", "passes",
                 True),
    "hybrid": (acc_pt.AccPathTracerRenderer, {},
               ("mesh_box.scn", "ico_5120.obj", 2), "hybrid", "samples",
               True),
    "hybrid-passes": (acc_pt.AccPathTracerRenderer, {"checkpoint": True},
                      ("mesh_box.scn", "ico_5120.obj", 4), "hybrid",
                      "passes", True),
}


@contextlib.contextmanager
def _wrapped(spans):
    """The harness's wraps, each appending (name, t0, t1) to `spans`."""
    undo = []

    def wrap(owner, attr, name):
        orig = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                spans.append((name, t0, time.perf_counter()))
        setattr(owner, attr, wrapped)
        undo.append((owner, attr, orig))
    try:
        for owner, attr, name in HARNESS_WRAPS:
            wrap(owner, attr, name)
        yield
    finally:
        for owner, attr, orig in reversed(undo):
            setattr(owner, attr, orig)


@pytest.mark.parametrize("name", list(SEAMS))
def test_the_harness_seams_carry_every_route(name, tmp_path, monkeypatch):
    """Each route renders under the harness's wraps: one "scene-prep" span
    around the render, and on the routes the benchmark times one "render"
    span inside it that holds the whole route, the BVH build of a mesh
    route included; AccPathTracer plans its route with `plan_route`."""
    from nrenderer_torch.utils.timing import GLOBAL_TIMER
    cls, kw, args, kind, unit, timed = SEAMS[name]
    if name == "hybrid-passes":
        monkeypatch.setitem(routes.HYBRID_BUDGET_RAYS, "cpu", 16 * 16 * 2)
    kw = dict(kw)
    if kw.pop("checkpoint", False):
        kw["checkpoint_path"] = str(tmp_path / "c.npz")
    plans, eps = [], []
    monkeypatch.setattr(acc_pt, "plan_route", lambda *a, **k: plans.append(
        routes.plan_route(*a, **k)) or plans[-1])
    real_eps = routes.scene_epsilon
    monkeypatch.setattr(routes, "scene_epsilon", lambda ss: eps.append(
        time.perf_counter()) or real_eps(ss))
    spans = []
    with _wrapped(spans):
        img = cls(seed=SEED, device="cpu", **kw).render(
            _scene(*args)).pixels
    assert np.isfinite(img).all() and img[..., :3].max() > 0
    if cls is acc_pt.AccPathTracerRenderer:   # it plans with plan_route
        assert [(p.kind, p.unit) for p in plans] == [(kind, unit)]
    outer = [s for s in spans if s[0] == "scene-prep"]
    inner = [s for s in spans if s[0] == "render"]
    assert len(outer) == 1 and len(inner) == (1 if timed else 0)
    for _, t0, t1 in inner:
        assert outer[0][1] <= t0 <= t1 <= outer[0][2]
        if kind in ("megamesh", "hybrid"):
            bvh = [s for s in GLOBAL_TIMER.spans()
                   if s.name == "AccPathTracer.bvh-build"][-1]
            assert t0 <= bvh.t0 <= bvh.t1 <= t1
            # the span holds the pool's and the images' tables, not the
            # scene's epsilon, as `bvh_build_ms.megamesh` has read it
            assert eps and not any(bvh.t0 <= e <= bvh.t1 for e in eps)


@pytest.mark.parametrize("cls,mod,attr,args", [
    (simple_pt.SimplePathTracerRenderer, simple_pt, "render_simple_pt",
     ("cornell_box.scn",)),
    (acc_pt.AccPathTracerRenderer, acc_pt, "render_bsdf_pt",
     ("pt_glass_box.scn",)),
], ids=["dense", "megakernel"])
def test_a_patched_one_shot_kernel_entry_changes_the_image(cls, mod, attr,
                                                           args, monkeypatch):
    """The dense one-shot routes look their kernel entry up on the
    renderer's module when they run: the same entry at another seed gives
    another image (the harness's fault test plants its faults there)."""
    want = cls(seed=SEED, device="cpu").render(_scene(*args)).pixels
    orig = getattr(mod, attr)
    monkeypatch.setattr(mod, attr, lambda *a, seed=0, **k: orig(
        *a, seed=seed + 1, **k))
    got = cls(seed=SEED, device="cpu").render(_scene(*args)).pixels
    assert got.shape == want.shape and not np.array_equal(got, want)


def test_the_benchmark_pins_the_rule_through_acc_pt():
    """`benchmark/tests/test_bench_mesh.py` pins the megamesh limit with
    `acc_pt.pinned_megamesh_max_tris(acc_pt.MEGAMESH_MAX_TRIS_CUDA)`: the
    route layer's own pin and limit, so the plan follows it."""
    assert acc_pt.pinned_megamesh_max_tris is routes.pinned_megamesh_max_tris
    assert acc_pt.MEGAMESH_MAX_TRIS_CUDA == routes.MEGAMESH_MAX_TRIS_CUDA
    scene = _scene("mesh_box.scn", "ico_5120.obj", 2)
    assert routes.plan_route(scene, "AccPathTracer", False,
                             "cpu").kind == "hybrid"
    with acc_pt.pinned_megamesh_max_tris(acc_pt.MEGAMESH_MAX_TRIS_CUDA):
        assert routes.plan_route(scene, "AccPathTracer", False,
                                 "cpu").kind == "megamesh"


def _imports(path: pathlib.Path):
    """(module the import names, resolved against the port's package, or
    the absolute name; the names it takes) of every import in the file."""
    pkg = path.relative_to(REPO).with_suffix("").parts[:-1]
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, ()
        elif isinstance(node, ast.ImportFrom):
            base = pkg[:len(pkg) - node.level + 1] if node.level else ()
            mod = ".".join(base + tuple((node.module or "").split(".")))
            yield mod.strip("."), tuple(a.name for a in node.names)


def test_the_import_direction():
    """cli -> {renderers, parallel} -> renderers/routes -> ops: nothing
    under `renderers/` imports `parallel/`; `routes.py` imports only
    `ops/`, `scene/`, `server/`, `utils/` and the wavefront below it;
    `parallel/mesh.py` takes no private name from `renderers/`."""
    for path in sorted((PORT / "renderers").glob("*.py")):
        for mod, _ in _imports(path):
            assert not mod.startswith("nrenderer_torch.parallel"), \
                (path.name, mod)
    for mod, _ in _imports(PORT / "renderers" / "routes.py"):
        if mod.startswith("nrenderer_torch."):
            assert mod.split(".")[1] in ("ops", "scene", "server", "utils") \
                or mod == "nrenderer_torch.renderers._wavefront", mod
    for mod, names in _imports(PORT / "parallel" / "mesh.py"):
        if mod.startswith("nrenderer_torch.renderers"):
            assert not any(n.startswith("_") for n in names), (mod, names)
            assert not mod.split(".")[-1].startswith("_"), mod


def _code_names(path: pathlib.Path):
    """Names called and integer constants in the file's code (docstrings
    aside)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call):
            f = node.func
            yield f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", None)
        elif isinstance(node, ast.Constant) and type(node.value) is int:
            yield node.value


# what a route decides, and the modules besides routes.py that may do it:
# `render_pt_linear`, the JAX function's counterpart, builds its own
# tables; MLT builds the mesh tables of its own estimator
ROUTE_DECISIONS = {
    "pick_chunk": (), "megamesh_pass_spp": (), "checkpoint_pass_spp": (),
    "takes_hybrid": (), 100003: (), "device_textures": (),
    "make_mesh_tables": ("ops/pt_cuda.py", "renderers/mlt.py"),
    "make_env_tables": ("ops/pt_cuda.py",),
    "make_tex_tables": ("ops/pt_cuda.py",),
}


def test_route_decisions_live_in_routes_only():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT).as_posix()
        if rel == "renderers/routes.py":
            continue
        found = set(_code_names(path)) & set(ROUTE_DECISIONS)
        assert all(rel in ROUTE_DECISIONS[n] for n in found), (rel, found)
