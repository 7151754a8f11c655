"""Command-line interface of the PyTorch/CUDA port.

    python -m nrenderer_torch list-renderers
    python -m nrenderer_torch render --scene resource/cornell_box.scn \
        --renderer SimplePathTracer --spp 2048 --width 512 --height 512 \
        --depth 20 --out out.png [--device cuda|cpu]
    python -m nrenderer_torch render --scene resource/env_spheres.scn \
        --env-map resource/env_sky.png --renderer AccPathTracer \
        [--checkpoint film.npz] ...
    python -m nrenderer_torch render --scene resource/mesh_box.scn \
        --obj resource/obj/blob_960.obj --renderer AccPathTracer ...
    python -m nrenderer_torch render --scene resource/cornell_box.scn \
        --renderer MetropolisLightTransport --chains 1024 --mutations 256 \
        [--checkpoint chains.npz] ...
    python -m nrenderer_torch render --scene resource/cornell_box.scn \
        --progressive [--checkpoint film.npz] [--serve [PORT]] ...
    python -m nrenderer_torch render --renderer RayCast ...
    python -m nrenderer_torch render --scene resource/cornell_box.scn \
        --devices 2 --shard samples|pixels [--checkpoint film.npz] ...
    python -m nrenderer_torch edit --scene resource/cornell_box.scn \
        --renderer SimplePathTracer --width 128 --height 128 --spp 64 ...

Render settings defaults mirror the UI's `RenderSettingsManager.hpp:20-24`
(500x500, spp=16, depth=20); the camera defaults mirror `Camera.hpp:22-29`,
and `--camera-position`, `--camera-look-at`, `--fov`, `--aperture` and
`--ambient` override the scene's.  `--device` defaults to `cuda`: without a
GPU the render fails instead of running on the CPU; pass `--device cpu`
for the plain torch version.  `--devices N` (N > 1) splits
SimplePathTracer and AccPathTracer by samples or pixel bands (`--shard`)
and MetropolisLightTransport by chains over N ranks (`parallel/`): NCCL
over N GPUs with `--device cuda`, N CPU ranks over gloo with `--device
cpu`.
"""
from __future__ import annotations

import argparse
import functools
import logging
import os
import sys
import time

import numpy as np

from .utils.timing import GLOBAL_TIMER


def _build_scene(args):
    from .io.obj import load_obj
    from .io.scn import load_scn
    from .scene.model import Scene

    scene = Scene()
    if args.scene:
        load_scn(args.scene, scene)
    # each OBJ without materials of its own takes the scene's first one
    for obj_path in getattr(args, "obj", None) or ():
        load_obj(obj_path, scene, material=0 if scene.materials else None)
    ro = scene.render_option
    ro.width = args.width
    ro.height = args.height
    ro.depth = args.depth
    ro.samples_per_pixel = args.spp
    # global microfacet knobs (reference RenderSettingsManager.hpp:15-17);
    # None = unset, per-material properties win (scene/model.RenderOption)
    if args.roughness is not None:
        ro.roughness = args.roughness
    if args.f0 is not None:
        ro.f0 = args.f0
    if args.metalness is not None:
        ro.metalness = args.metalness
    # the camera and ambient overrides (`nrenderer_tpu/cli.py:49-58`); a
    # namespace without them leaves the scene's
    cam = scene.camera
    get = lambda name: getattr(args, name, None)
    if get("camera_position"):
        cam.position = tuple(args.camera_position)
    if get("camera_look_at"):
        cam.look_at = tuple(args.camera_look_at)
    if get("fov") is not None:
        cam.fov = args.fov
    if get("aperture") is not None:
        cam.aperture = args.aperture
    if get("ambient"):
        scene.ambient.constant = tuple(args.ambient)
    if args.env_map:
        from .io.image import load_image
        from .scene.model import AmbientType, Texture
        pixels = load_image(args.env_map)
        if pixels is None:
            raise EnvMapError(f"cannot decode env map {args.env_map}")
        scene.ambient.environment_map = len(scene.textures)
        scene.textures.append(Texture(name=args.env_map, pixels=pixels))
        scene.ambient.type = AmbientType.ENVIRONMENT_MAP
    return scene


class EnvMapError(ValueError):
    pass


def _component(args, device, progressive: bool = False):
    """The renderer `args.renderer` on `device`, with the CLI's settings;
    None for a renderer the registry builds itself (Example, or an
    unknown name the manager then reports)."""
    name = args.renderer
    checkpoint = getattr(args, "checkpoint", None)
    if name == "SimplePathTracer":
        from .renderers.simple_pt import SimplePathTracerRenderer
        return SimplePathTracerRenderer(
            seed=args.seed, checkpoint_path=checkpoint,
            progressive=progressive, device=device)
    if name == "AccPathTracer":
        from .renderers.acc_pt import AccPathTracerRenderer
        return AccPathTracerRenderer(seed=args.seed,
                                     checkpoint_path=checkpoint,
                                     device=device)
    if name == "MetropolisLightTransport":
        from .renderers.mlt import MetropolisRenderer
        return MetropolisRenderer(
            seed=args.seed, chains=getattr(args, "chains", None),
            mutations=getattr(args, "mutations", None),
            checkpoint_path=checkpoint, device=device)
    if name == "RayCast":
        from .renderers.raycast import RayCastRenderer
        return RayCastRenderer(device=device)
    if name == "GeometryPreview":
        from .renderers.preview import GeometryPreviewRenderer
        return GeometryPreviewRenderer(device=device)
    return None


def _prepare(args):
    """(device, scene) for a command, or (None, exit code) after printing
    why not."""
    from .io.obj import ObjParseError
    from .io.scn import ScnParseError
    from .ops.pt_cuda import check_device
    with GLOBAL_TIMER.phase("cli.parse"):
        try:
            device = check_device(args.device)
        except (RuntimeError, ValueError) as exc:
            print(f"error: {exc}", file=sys.stderr)
            return None, 2
        try:
            return device, _build_scene(args)
        except (ScnParseError, ObjParseError) as exc:
            print(f"error: scene import failed: {exc}", file=sys.stderr)
        except EnvMapError as exc:
            print(f"error: {exc}", file=sys.stderr)
        return None, 2


def _cmd_render(args) -> int:
    import nrenderer_torch
    nrenderer_torch._register_builtin_renderers()
    from .io.image import write_png
    from .server.manager import ComponentManager
    from .server.registry import UnknownComponentError, get_server

    device, scene = _prepare(args)
    if device is None:
        return scene
    if args.devices > 1 and args.renderer in (
            "SimplePathTracer", "AccPathTracer", "MetropolisLightTransport"):
        return _render_multichip(args, scene, device)
    # SimplePathTracer renders in passes with Screen previews under
    # --progressive, --checkpoint or --serve (`nrenderer_tpu/cli.py:100-106`)
    component = _component(args, device, progressive=bool(
        args.progressive or args.checkpoint or args.serve is not None))

    mgr = ComponentManager()
    viewer = None
    if args.serve is not None:
        # live viewer: watch the previews refresh in a browser while the
        # render runs; MLT posts mid-render previews only when someone
        # watches (an explicit NR_MLT_PREVIEW_BLOCKS wins)
        os.environ.setdefault("NR_MLT_PREVIEW_BLOCKS", "1")
        from .server.viewer import ScreenViewer
        viewer = ScreenViewer(get_server().screen, port=args.serve,
                              state_fn=lambda: mgr.state.name).start()
        print(f"live view: {viewer.url}", file=sys.stderr)
    t0 = time.perf_counter()
    try:
        mgr.exec(args.renderer, scene, component=component)
    except UnknownComponentError:
        names = ", ".join(
            i.name for i in
            get_server().component_factory.get_components_info("Render"))
        print(f"error: unknown renderer {args.renderer!r}; "
              f"available: {names}", file=sys.stderr)
        if viewer is not None:
            viewer.stop()
        return 2
    try:
        result = mgr.wait()
    except NotImplementedError as exc:
        print(f"error: {exc}", file=sys.stderr)
        if viewer is not None:
            viewer.stop()
        return 2
    wall = time.perf_counter() - t0
    if result is None:
        if viewer is not None:
            viewer.stop()
        print("render failed", file=sys.stderr)
        return 1
    with GLOBAL_TIMER.phase("cli.png"):
        write_png(args.out, result.pixels)
    n_rays = args.width * args.height * max(1, args.spp)
    print(f"{args.renderer}[{device.type}]: {args.width}x{args.height} "
          f"spp={args.spp} depth={args.depth} in {wall:.2f}s "
          f"({n_rays / wall / 1e6:.1f} Mpaths/s) -> {args.out}")
    return _serve_tail(viewer, result.pixels)


def _render_multichip(args, scene, device) -> int:
    """Render split over `--devices` ranks (`nrenderer_tpu/cli.py:152-310`):
    SimplePathTracer and AccPathTracer by samples or pixel bands,
    MetropolisLightTransport by chains; `--checkpoint`, `--progressive`
    and `--serve` take the resumable route, in passes with previews."""
    from .io.image import write_png
    from .parallel.group import RankError, make_devices
    from .parallel.mesh import render_multichip_resumable, render_sharded
    from .parallel.mlt import render_mlt_sharded
    from .server.registry import get_server

    n = args.devices
    try:
        devices = make_devices(n, device.type)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    if args.shard == "pixels" and args.renderer == "MetropolisLightTransport":
        # a pixel band needs a per-pixel estimator; MLT splats across the
        # whole film, so the asked-for split is refused, not substituted
        print(f"error: --shard pixels supports SimplePathTracer / "
              f"AccPathTracer only (got {args.renderer}); use --shard "
              "samples", file=sys.stderr)
        return 2
    if args.shard == "pixels" and args.height % n:
        print(f"error: --shard pixels needs height divisible by --devices "
              f"({args.height} % {n} != 0)", file=sys.stderr)
        return 2
    viewer = None
    if args.serve is not None:
        os.environ.setdefault("NR_MLT_PREVIEW_BLOCKS", "1")
        from .server.viewer import ScreenViewer
        viewer = ScreenViewer(get_server().screen, port=args.serve).start()
        print(f"live view: {viewer.url}", file=sys.stderr)
    screen = get_server().screen
    t0 = time.perf_counter()
    try:
        if args.renderer == "MetropolisLightTransport":
            chains = args.chains or 1024
            mutations = args.mutations or 256
            out = render_mlt_sharded(scene, devices, chains=chains,
                                     mutations=mutations, seed=args.seed,
                                     checkpoint_path=args.checkpoint,
                                     screen=screen)
            what = f"{chains}x{mutations} mutations"
        elif args.checkpoint or args.progressive or args.serve is not None:
            out = render_multichip_resumable(
                scene, devices, args.renderer, args.shard, seed=args.seed,
                checkpoint_path=args.checkpoint, screen=screen)
            what = f"spp={args.spp}, {args.shard}, resumable"
        else:
            out = render_sharded(scene, devices, args.renderer, args.shard,
                                 seed=args.seed)
            what = f"spp={args.spp}, {args.shard}"
    except (ValueError, NotImplementedError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        if viewer is not None:
            viewer.stop()
        return 2
    except RankError as exc:
        print(f"render failed: {exc}", file=sys.stderr)
        if viewer is not None:
            viewer.stop()
        return 1
    wall = time.perf_counter() - t0
    img = out.image
    if img.shape[2] == 3:
        img = np.concatenate(
            [img, np.ones(img.shape[:2] + (1,), np.float32)], axis=2)
    with GLOBAL_TIMER.phase("cli.png"):
        write_png(args.out, img)
    print(f"{args.renderer}[{n} x {device.type}, {out.route}]: "
          f"{args.width}x{args.height} {what} depth={args.depth} in "
          f"{wall:.2f}s -> {args.out}")
    return _serve_tail(viewer, img)


def _serve_tail(viewer, final_img) -> int:
    """Post the finished frame to the live viewer (if any) and keep serving
    until interrupted, as the reference UI keeps its result panel open
    (`nrenderer_tpu/cli.py:312`)."""
    if viewer is None:
        return 0
    from .server.registry import get_server
    img = np.clip(np.asarray(final_img, np.float32), 0.0, 1.0)
    get_server().screen.set(img, img.shape[1], img.shape[0])
    print(f"serving final frame at {viewer.url} (Ctrl-C to exit)",
          file=sys.stderr)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    viewer.stop()
    return 0


def _cmd_edit(args) -> int:
    """Interactive edit-and-re-render loop, the headless AssetView
    (`nrenderer_tpu/cli.py:331-410`, reference `AssetView.cpp:158-641`):
    serves the editor page and the live frame; every applied edit posts a
    GeometryPreview at once, then re-renders with the chosen renderer on
    the chosen device and refreshes the browser."""
    import nrenderer_torch
    nrenderer_torch._register_builtin_renderers()
    from .io.image import write_png
    from .renderers.preview import GeometryPreviewRenderer
    from .server.editor import SceneEditor
    from .server.manager import ComponentManager
    from .server.registry import get_server
    from .server.viewer import ScreenViewer

    device, scene = _prepare(args)
    if device is None:
        return scene
    known = {i.name for i in
             get_server().component_factory.get_components_info("Render")}
    if args.renderer not in known:
        print(f"error: unknown renderer {args.renderer!r}; "
              f"available: {', '.join(sorted(known))}", file=sys.stderr)
        return 2

    editor = SceneEditor(scene)
    mgr = ComponentManager()
    viewer = ScreenViewer(get_server().screen, port=args.serve or 0,
                          state_fn=lambda: mgr.state.name,
                          routes=editor.routes).start()
    print(f"editor: {viewer.url} (Ctrl-C to exit)", file=sys.stderr)
    screen = get_server().screen
    try:
        while True:
            editor.mark_rendering(True)
            # render a snapshot, not the live scene: POST /scene mutates it
            # concurrently and a torn mid-render scene is a wrong frame
            snapshot, version = editor.snapshot()
            t0 = time.perf_counter()
            # the geometry preview first, so the browser sees framing and
            # placement while the real render runs
            try:
                pv = GeometryPreviewRenderer(device=device).render(snapshot)
                screen.set(np.clip(np.asarray(pv.pixels, np.float32),
                                   0.0, 1.0), pv.width, pv.height)
                print(f"preview v{version} in "
                      f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)
            except Exception as exc:
                print(f"preview failed: {exc!r}", file=sys.stderr)
            result = None
            try:
                mgr.exec(args.renderer, snapshot,
                         component=_component(args, device))
                result = mgr.wait()
            except Exception as exc:
                # keep the editor alive: a failing render must not lose
                # the in-memory edits
                print(f"render failed: {exc!r} (edit + apply to retry)",
                      file=sys.stderr)
            editor.mark_rendering(False)
            if result is not None:
                img = np.clip(np.asarray(result.pixels, np.float32),
                              0.0, 1.0)
                screen.set(img, img.shape[1], img.shape[0])
                if args.out:
                    write_png(args.out, result.pixels)
                print(f"rendered scene v{version} in "
                      f"{time.perf_counter() - t0:.2f}s", file=sys.stderr)
            # block until the next applied edit (short poll: Ctrl-C stays
            # responsive)
            while not editor.wait_dirty(timeout=0.5):
                pass
    except KeyboardInterrupt:
        pass
    viewer.stop()
    return 0


def _cmd_list(args) -> int:
    import nrenderer_torch
    nrenderer_torch._register_builtin_renderers()
    from .server.registry import get_server
    for info in get_server().component_factory.get_components_info("Render"):
        first = info.description.splitlines()[0] if info.description else ""
        print(f"{info.id:40s} {first}")
    return 0


@functools.lru_cache(maxsize=None)
def _parser() -> argparse.ArgumentParser:
    """The CLI's parser, built once a process: a build takes ~2 ms, which
    every command would spend outside its spans."""
    p = argparse.ArgumentParser(prog="nrenderer_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def add_shared(p):
        p.add_argument("--scene", help=".scn scene file")
        p.add_argument("--obj", action="append", default=[],
                       help="OBJ mesh file (repeatable)")
        p.add_argument("--renderer", default="SimplePathTracer")
        p.add_argument("--width", type=int, default=500)
        p.add_argument("--height", type=int, default=500)
        p.add_argument("--depth", type=int, default=20)
        p.add_argument("--spp", type=int, default=16)
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--out", default="out.png")
        p.add_argument("--camera-position", nargs=3, type=float)
        p.add_argument("--camera-look-at", nargs=3, type=float)
        p.add_argument("--fov", type=float)
        p.add_argument("--aperture", type=float,
                       help="thin-lens aperture (0: pinhole)")
        p.add_argument("--ambient", nargs=3, type=float,
                       help="constant ambient RGB")
        p.add_argument("--env-map", help="environment map image (PNG)")
        p.add_argument("--roughness", type=float,
                       help="global microfacet roughness override")
        p.add_argument("--f0", type=float,
                       help="global microfacet F0 override")
        p.add_argument("--metalness", type=float,
                       help="global microfacet metalness override")
        p.add_argument("--device", default="cuda",
                       help="'cuda' (the CUDA kernels; fails without a GPU) "
                            "or 'cpu' (the plain torch versions)")

    pr = sub.add_parser("render", help="render a scene")
    add_shared(pr)
    pr.add_argument("--progressive", action="store_true",
                    help="SimplePathTracer: render in passes with live "
                         "Screen previews")
    pr.add_argument("--serve", type=int, nargs="?", const=0, default=None,
                    metavar="PORT",
                    help="serve a live browser view of the render "
                         "(previews + final frame; PORT 0 or omitted = "
                         "auto-pick); implies --progressive for "
                         "SimplePathTracer")
    pr.add_argument("--checkpoint",
                    help="checkpoint file for resumable rendering "
                         "(SimplePathTracer and AccPathTracer: the film; "
                         "MetropolisLightTransport: the Markov chains)")
    pr.add_argument("--chains", type=int,
                    help="MLT: parallel Markov chains (default 1024)")
    pr.add_argument("--mutations", type=int,
                    help="MLT: mutations per chain (default 256)")
    pr.add_argument("--devices", type=int, default=1,
                    help="split the render over N ranks: N GPUs (NCCL) "
                         "with --device cuda, N processes (gloo) with "
                         "--device cpu")
    pr.add_argument("--shard", choices=("samples", "pixels"),
                    default="samples",
                    help="with --devices: split the sample budget (MLT: "
                         "the chains), or the film into bands of rows")
    pr.set_defaults(fn=_cmd_render)

    pe = sub.add_parser(
        "edit", help="interactive scene editor: serve an edit panel and a "
                     "live view, re-rendering on every applied change")
    add_shared(pe)
    pe.add_argument("--serve", type=int, default=0, metavar="PORT",
                    help="editor HTTP port (0 = auto-pick)")
    pe.set_defaults(fn=_cmd_edit)

    pl = sub.add_parser("list-renderers", help="list registered renderers")
    pl.set_defaults(fn=_cmd_list)

    return p


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    args = _parser().parse_args(argv)
    if args.fn is not _cmd_render:
        return args.fn(args)
    # the root of the command's spans (`utils/timing.py`)
    with GLOBAL_TIMER.phase("cli.render", root=True):
        return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
