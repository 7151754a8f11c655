"""SimplePathTracer's progressive route: passes of `pick_chunk` samples at
seeds `seed * 100003 + step`, Screen previews, and checkpoint/resume.

Each pass of the port (the plain torch version of the kernel on the CPU)
is held against the JAX package's Pallas pass `render_pt_pallas_linear` at
the same seed, run in TPU interpret mode as tests/test_pt_pallas.py runs
it, on the same StaticScene, camera and env map.  Both draw the same hash
uniforms, so the gamma'd passes agree pixel by pixel up to rounding: the
bars of tests/test_torch_pt_kernel.py, mean |d| <= 2e-3 and >= 97% of
pixels within 1e-4 (a one-ulp difference can flip a path at an edge).  On
the env scene ~1% of paths flip (a diffuse ray leaving a sphere re-hits it
just above t_min, decided by the last bits that XLA's multiply-adds round
otherwise; tests/test_torch_acc_pt.py), so a pass of 4 samples a pixel
keeps 95-97% of its pixels within 1e-4 there (read: 96.4% and 95.3%):
its share bar is 93%, and the two-pass image is held by its mean.

At 24x24 and 8 spp `pick_chunk` makes one pass of 8 samples; the pass
tests set it to 4 so the route runs two passes (the pass size is a
parameter of the route, held against JAX's `pick_chunk` below).  Resume
and the fingerprint are held bit for bit on the CPU."""
import pathlib

import numpy as np
import pytest
import torch

import nrenderer_torch as P
from nrenderer_torch.interop import camera_from_numpy, static_scene_from_numpy
from nrenderer_torch.renderers import routes, simple_pt
from nrenderer_torch.renderers.routes import pick_chunk
from nrenderer_torch.renderers.simple_pt import (
    SimplePathTracerRenderer, render_progressive,
)
from nrenderer_torch.scene.model import AmbientType, Texture
from nrenderer_torch.server.checkpoint import load_checkpoint
from nrenderer_torch.server.registry import get_server

from test_torch_env import make_env_sky

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CORNELL = REPO / "resource" / "cornell_box.scn"
ENV = REPO / "resource" / "env_spheres.scn"
W = H = 24
SPP, PASS, DEPTH, SEED = 8, 4, 3, 2


def _env_map() -> np.ndarray:
    return make_env_sky().astype(np.float32) / 255.0


def _attach_env(scene, emap):
    scene.ambient.environment_map = len(scene.textures)
    scene.textures.append(Texture(name="sky", pixels=np.concatenate(
        [emap, np.ones(emap.shape[:2] + (1,), np.float32)], axis=2)))
    scene.ambient.type = AmbientType.ENVIRONMENT_MAP


def _port_scene(path, env=False, w=W, h=H, spp=SPP, depth=DEPTH):
    scene = P.load_scn(str(path))
    if env:
        _attach_env(scene, _env_map())
    ro = scene.render_option
    ro.width, ro.height, ro.samples_per_pixel, ro.depth = w, h, spp, depth
    return scene


def _stats(got, want):
    d = np.abs(got - want)
    return {"max": float(d.max()), "mean": float(d.mean()),
            "within_1e-4": float((d.max(axis=-1) <= 1e-4).mean())}


def test_pick_chunk_is_jax_pick_chunk():
    pytest.importorskip("jax")
    from nrenderer_tpu.renderers.simple_pt import pick_chunk as jax_pick
    for w, h, spp in ((512, 512, 2048), (24, 24, 8), (128, 128, 64),
                      (500, 500, 256), (61, 37, 33), (1, 1, 7)):
        assert pick_chunk(w, h, spp) == jax_pick(w, h, spp)
    assert pick_chunk(512, 512, 2048) == 8   # the main path: 256 passes


@pytest.mark.parametrize("env", [False, True], ids=["cornell", "env"])
def test_each_pass_matches_pallas_linear(monkeypatch, env):
    """Two passes of 4 spp through `render_progressive`, each against
    `render_pt_pallas_linear(seed=SEED * 100003 + step)` in interpret
    mode, and the route's image against the two Pallas passes combined."""
    pytest.importorskip("jax")
    from jax.experimental.pallas import tpu as pltpu
    import nrenderer_tpu as T
    from nrenderer_tpu.ops import pt_pallas
    from nrenderer_tpu.ops.camera import make_camera as jax_make_camera
    from nrenderer_tpu.ops.intersect import make_static_scene as jax_mss
    path = ENV if env else CORNELL
    jscene = T.load_scn(str(path))
    jss = jax_mss(T.build_scene_arrays(jscene))
    jcam = jax_make_camera(jscene.camera)
    emap = _env_map() if env else None
    if env:
        exact, _ = pt_pallas._env_exact_args(
            emap, pt_pallas._camera_tuple(jcam), W, H)
        assert exact is not None  # bounce 0 resolved in-kernel
    want = []
    with pltpu.force_tpu_interpret_mode():
        for step in range(SPP // PASS):
            want.append(np.asarray(pt_pallas.render_pt_pallas_linear(
                jss, jcam, W, H, PASS, DEPTH, seed=SEED * 100003 + step,
                env_map=emap)))

    films = []
    real = routes.pt_accumulate

    def keep(*args, **kw):
        out = real(*args, **kw)
        films.append(out.clone().numpy())
        return out

    monkeypatch.setattr(routes, "pick_chunk", lambda w, h, spp: PASS)
    monkeypatch.setattr(routes, "pt_accumulate", keep)
    img = render_progressive(static_scene_from_numpy(jss),
                             camera_from_numpy(jcam, device="cpu"), W, H,
                             SPP, DEPTH, seed=SEED, env_map=emap)
    assert len(films) == 2
    share_min = 0.93 if env else 0.97
    gamma = lambda f, n: np.sqrt(np.maximum(f / n, 0.0))
    for step, (got, exp) in enumerate(zip(films, want)):
        st = _stats(gamma(got, PASS), gamma(exp, PASS))
        print(f"pass {step}:", st)
        assert np.isfinite(got).all() and got.max() > 0.0
        assert st["mean"] <= 2e-3
        assert st["within_1e-4"] >= share_min
    ref = np.clip(gamma(want[0] + want[1], SPP).reshape(H, W, 3)[::-1],
                  0.0, 1.0)
    st = _stats(img, ref)
    print("image:", st)
    assert st["mean"] <= 2e-3
    if not env:   # 8 samples a pixel: the env scene's flips touch more
        assert st["within_1e-4"] >= share_min


def test_route_is_one_shot_render_per_pass():
    """A one-pass progressive render is the one-shot render at the seed
    of pass 0 (seed * 100003): same kernel, same sample numbering."""
    scene = _port_scene(CORNELL, w=12, h=10, spp=4)
    prog = SimplePathTracerRenderer(seed=0, progressive=True,
                                    device="cpu").render(scene).pixels
    once = SimplePathTracerRenderer(seed=0, device="cpu").render(
        scene).pixels
    np.testing.assert_array_equal(prog, once)


def _render(scene, tmp_ckpt=None, **kw):
    return SimplePathTracerRenderer(seed=SEED, checkpoint_path=tmp_ckpt,
                                    device="cpu", **kw).render(scene).pixels


@pytest.mark.parametrize("env", [False, True], ids=["cornell", "env"])
def test_interrupted_and_resumed_equals_uninterrupted(tmp_path, monkeypatch,
                                                      env):
    """A checkpointed render that dies in its third of four passes and is
    run again resumes from the saved film and ends bit for bit on the
    render that was never interrupted."""
    monkeypatch.setattr(routes, "pick_chunk", lambda w, h, spp: 2)
    scene = _port_scene(ENV if env else CORNELL, env=env, w=12, h=10)
    whole = _render(scene, str(tmp_path / "whole.npz"))
    real = routes.pt_accumulate
    seeds = []

    def dies_on_third(*args, **kw):
        seeds.append(args[8])
        if len(seeds) == 3:
            raise KeyboardInterrupt("interrupted")
        return real(*args, **kw)

    ckpt = tmp_path / "film.npz"
    monkeypatch.setattr(routes, "pt_accumulate", dies_on_third)
    with pytest.raises(KeyboardInterrupt):
        _render(scene, str(ckpt))
    assert seeds == [SEED * 100003 + k for k in range(3)]
    assert int(np.load(ckpt)["spp_done"]) == 4
    monkeypatch.setattr(routes, "pt_accumulate", real)
    resumed = _render(scene, str(ckpt))
    np.testing.assert_array_equal(resumed, whole)
    assert np.isfinite(whole).all() and whole[..., :3].mean() > 0.02


def _passes_run(monkeypatch, scene, ckpt):
    """Passes a checkpointed render runs (0: it resumed at the end)."""
    real = routes.pt_accumulate
    n = []

    def count(*args, **kw):
        n.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(routes, "pt_accumulate", count)
    _render(scene, ckpt)
    monkeypatch.setattr(routes, "pt_accumulate", real)
    return len(n)


def test_fingerprint_refuses_changed_camera_and_env(tmp_path, monkeypatch):
    monkeypatch.setattr(routes, "pick_chunk", lambda w, h, spp: 2)
    ckpt = str(tmp_path / "f.npz")
    scene = _port_scene(ENV, env=True, w=8, h=6)
    assert _passes_run(monkeypatch, scene, ckpt) == 4
    assert _passes_run(monkeypatch, scene, ckpt) == 0   # resumed at 8/8
    moved = _port_scene(ENV, env=True, w=8, h=6)
    moved.camera.position = (0.0, 1.0, 10.0)
    assert _passes_run(monkeypatch, moved, ckpt) == 4
    _render(scene, ckpt)                                 # back to the start
    assert _passes_run(monkeypatch, scene, ckpt) == 0
    other_env = _port_scene(ENV, w=8, h=6)
    _attach_env(other_env, _env_map()[::-1].copy())
    assert _passes_run(monkeypatch, other_env, ckpt) == 4
    lens = _port_scene(ENV, env=True, w=8, h=6)
    lens.camera.aperture = 20.0
    assert _passes_run(monkeypatch, lens, ckpt) == 4
    assert load_checkpoint(ckpt, "not the fingerprint") is None


def test_previews_reach_the_screen(monkeypatch):
    """A preview every `preview_every` passes and after the last; the last
    is the returned image."""
    monkeypatch.setattr(routes, "pick_chunk", lambda w, h, spp: 1)
    scene = _port_scene(CORNELL, w=8, h=6, spp=5)
    screen = get_server().screen
    seen = []
    real_set = screen.set
    monkeypatch.setattr(screen, "set", lambda px, w, h: (
        seen.append(np.array(px)), real_set(px, w, h)))
    from nrenderer_torch.ops.camera import make_camera
    from nrenderer_torch.ops.intersect import make_static_scene
    ss = make_static_scene(P.build_scene_arrays(scene))
    cam = make_camera(scene.camera, device="cpu")
    img = render_progressive(ss, cam, 8, 6, 5, DEPTH, seed=1,
                             preview_every=2)
    assert len(seen) == 3                      # passes 2, 4 and the last
    assert all(px.shape == (6, 8, 4) for px in seen)
    np.testing.assert_array_equal(np.clip(seen[-1][..., :3], 0.0, 1.0), img)
    np.testing.assert_array_equal(screen.get_pixels()[..., :3], img)
    assert (seen[0] != seen[-1]).any()


def test_env_switches(tmp_path, monkeypatch):
    """NR_PROGRESSIVE=1 takes the progressive route; NR_CHECKPOINT=<file>
    takes it with a checkpoint, as the JAX renderer reads them."""
    monkeypatch.setattr(routes, "pick_chunk", lambda w, h, spp: 2)
    scene = _port_scene(CORNELL, w=8, h=6)
    assert not SimplePathTracerRenderer(device="cpu").progressive
    monkeypatch.setenv("NR_PROGRESSIVE", "1")
    r = SimplePathTracerRenderer(device="cpu")
    assert r.progressive and r.checkpoint_path is None
    calls = []
    real = simple_pt.render_progressive
    monkeypatch.setattr(simple_pt, "render_progressive",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    r.render(scene)
    assert calls == [1]
    monkeypatch.delenv("NR_PROGRESSIVE")
    ckpt = tmp_path / "env.npz"
    monkeypatch.setenv("NR_CHECKPOINT", str(ckpt))
    r = SimplePathTracerRenderer(device="cpu")
    assert r.progressive and r.checkpoint_path == str(ckpt)
    r.render(scene)
    assert ckpt.exists() and int(np.load(ckpt)["spp_done"]) == SPP


@pytest.mark.parametrize("depth", [0, 3])
def test_empty_scene_matches_jax(depth):
    """A scene without primitives: black at depth >= 1, the ambient at
    depth 0, as the JAX progressive route gives (its XLA engine)."""
    pytest.importorskip("jax")
    import nrenderer_tpu as T
    from nrenderer_tpu.renderers.simple_pt import (
        SimplePathTracerRenderer as JaxRenderer)
    out = []
    for mod, make in ((P, lambda: SimplePathTracerRenderer(
            progressive=True, device="cpu")),
                      (T, lambda: JaxRenderer(progressive=True))):
        scene = mod.Scene()
        scene.ambient.constant = (0.2, 0.3, 0.4)
        ro = scene.render_option
        ro.width, ro.height, ro.samples_per_pixel, ro.depth = 8, 6, 4, depth
        out.append(make().render(scene).pixels)
    np.testing.assert_array_equal(out[0], out[1])
    want = np.sqrt([0.2, 0.3, 0.4]) if depth == 0 else np.zeros(3)
    np.testing.assert_allclose(out[0][0, 0, :3], want, rtol=1e-6)


def test_thin_lens_matches_jax_in_distribution():
    """With a lens the JAX route runs its XLA engine (jax.random draws) and
    the port its kernel's lens (hash draws): independent estimates of one
    image.  At 32x32, 1024 spp, depth 3 their linear means agree within 5%
    and their 8x8-block means correlate >= 0.9 (at 256 spp three seeds
    read -5.8% to +1.9% and 0.928-0.938 on the CPU)."""
    pytest.importorskip("jax")
    import nrenderer_tpu as T
    from nrenderer_tpu.renderers.simple_pt import (
        SimplePathTracerRenderer as JaxRenderer)
    imgs = []
    for mod, make in ((P, lambda: SimplePathTracerRenderer(
            progressive=True, device="cpu")),
                      (T, lambda: JaxRenderer(progressive=True))):
        scene = mod.load_scn(str(CORNELL))
        scene.camera.aperture, scene.camera.focus_distance = 20.0, 1000.0
        ro = scene.render_option
        ro.width, ro.height, ro.samples_per_pixel, ro.depth = 32, 32, 1024, 3
        imgs.append(make().render(scene).pixels[..., :3].astype(np.float64))
    lin = [im ** 2 for im in imgs]
    rel = abs(lin[0].mean() / lin[1].mean() - 1.0)
    blocks = [im.reshape(8, 4, 8, 4, 3).mean(axis=(1, 3)).ravel()
              for im in imgs]
    corr = float(np.corrcoef(*blocks)[0, 1])
    print("thin lens, port vs JAX XLA: linear mean rel diff", rel,
          "block corr", corr)
    assert rel <= 0.05 and corr >= 0.9
