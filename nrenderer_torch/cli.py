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

Render settings defaults mirror the UI's `RenderSettingsManager.hpp:20-24`
(500x500, spp=16, depth=20); the camera defaults mirror `Camera.hpp:22-29`.
`--device` defaults to `cuda`: without a GPU the render fails instead of
running on the CPU; pass `--device cpu` for the plain torch version.
"""
from __future__ import annotations

import argparse
import logging
import sys
import time


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


def _cmd_render(args) -> int:
    import nrenderer_torch
    nrenderer_torch._register_builtin_renderers()
    from .io.image import write_png
    from .io.obj import ObjParseError
    from .io.scn import ScnParseError
    from .ops.pt_cuda import check_device
    from .server.manager import ComponentManager
    from .server.registry import UnknownComponentError, get_server

    try:
        device = check_device(args.device)
    except (RuntimeError, ValueError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    try:
        scene = _build_scene(args)
    except (ScnParseError, ObjParseError) as exc:
        print(f"error: scene import failed: {exc}", file=sys.stderr)
        return 2
    except EnvMapError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2

    component = None
    if args.renderer == "SimplePathTracer":
        if args.checkpoint:
            print("error: --checkpoint for SimplePathTracer needs its "
                  "progressive route (ROADMAP A4), not ported yet",
                  file=sys.stderr)
            return 2
        from .renderers.simple_pt import SimplePathTracerRenderer
        component = SimplePathTracerRenderer(seed=args.seed, device=device)
    elif args.renderer == "AccPathTracer":
        from .renderers.acc_pt import AccPathTracerRenderer
        component = AccPathTracerRenderer(
            seed=args.seed, checkpoint_path=args.checkpoint, device=device)
    elif args.renderer == "MetropolisLightTransport":
        from .renderers.mlt import MetropolisRenderer
        component = MetropolisRenderer(
            seed=args.seed, chains=args.chains, mutations=args.mutations,
            checkpoint_path=args.checkpoint, device=device)

    mgr = ComponentManager()
    t0 = time.perf_counter()
    try:
        mgr.exec(args.renderer, scene, component=component)
    except UnknownComponentError:
        names = ", ".join(
            i.name for i in
            get_server().component_factory.get_components_info("Render"))
        print(f"error: unknown renderer {args.renderer!r}; "
              f"available: {names}", file=sys.stderr)
        return 2
    try:
        result = mgr.wait()
    except NotImplementedError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    wall = time.perf_counter() - t0
    if result is None:
        print("render failed", file=sys.stderr)
        return 1
    write_png(args.out, result.pixels)
    n_rays = args.width * args.height * max(1, args.spp)
    print(f"{args.renderer}[{device.type}]: {args.width}x{args.height} "
          f"spp={args.spp} depth={args.depth} in {wall:.2f}s "
          f"({n_rays / wall / 1e6:.1f} Mpaths/s) -> {args.out}")
    return 0


def _cmd_list(args) -> int:
    import nrenderer_torch
    nrenderer_torch._register_builtin_renderers()
    from .server.registry import get_server
    for info in get_server().component_factory.get_components_info("Render"):
        first = info.description.splitlines()[0] if info.description else ""
        print(f"{info.id:40s} {first}")
    return 0


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")
    p = argparse.ArgumentParser(prog="nrenderer_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene")
    pr.add_argument("--scene", help=".scn scene file")
    pr.add_argument("--obj", action="append", default=[],
                    help="OBJ mesh file (repeatable)")
    pr.add_argument("--renderer", default="SimplePathTracer")
    pr.add_argument("--width", type=int, default=500)
    pr.add_argument("--height", type=int, default=500)
    pr.add_argument("--depth", type=int, default=20)
    pr.add_argument("--spp", type=int, default=16)
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--out", default="out.png")
    pr.add_argument("--env-map", help="environment map image (PNG)")
    pr.add_argument("--roughness", type=float,
                    help="global microfacet roughness override")
    pr.add_argument("--f0", type=float,
                    help="global microfacet F0 override")
    pr.add_argument("--metalness", type=float,
                    help="global microfacet metalness override")
    pr.add_argument("--checkpoint",
                    help="checkpoint file for resumable rendering "
                         "(AccPathTracer: the film; "
                         "MetropolisLightTransport: the Markov chains)")
    pr.add_argument("--chains", type=int,
                    help="MLT: parallel Markov chains (default 1024)")
    pr.add_argument("--mutations", type=int,
                    help="MLT: mutations per chain (default 256)")
    pr.add_argument("--device", default="cuda",
                    help="'cuda' (the CUDA kernel; fails without a GPU) or "
                         "'cpu' (the plain torch version)")
    pr.set_defaults(fn=_cmd_render)

    pl = sub.add_parser("list-renderers", help="list registered renderers")
    pl.set_defaults(fn=_cmd_list)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
