"""AccPathTracer: multi-BSDF path tracing, analytic scenes and meshes.

Counterpart of `nrenderer_tpu/renderers/acc_pt.py`, the rebuild of the
acc_path_tracing plugin (`components/acc_path_tracing/`): SimplePathTracer's
estimator with material-type dispatch {0 Lambertian, 1 smooth conductor,
2 dielectric glass, 3 microfacet, 4 plastic} (`AccPathTracer.cpp:120-181`,
`ShaderCreator.hpp:17-39`).

The renderer plans its route with `routes.plan_route`, the rule the JAX
renderer keeps (`acc_type`, the megamesh limit, env maps): the
path-tracing megakernel in its BSDF form (`ops/pt_cuda.py`; the CUDA
kernel on `device="cuda"`, its plain torch version on `device="cpu"`) in
one shot or, with a checkpoint path, in passes; the megamesh route (the
kernel's mesh form, in passes); or the hybrid route (a torch wavefront
over the mesh pipe, `_wavefront.build_render_fn`).  `routes.py` holds
each route's tables, passes, seeds and checkpoint fingerprint.  A scene
without primitives runs the megakernel as well (the CUDA kernel handles
it; the JAX package sends it to its XLA wavefront).

A render in passes posts a preview to the Screen and, with a checkpoint
path, saves the linear film after each pass; an interrupted render
resumes at the next pass (`server/checkpoint.py`)."""
from __future__ import annotations

import numpy as np

from ..ops import mesh_cuda
from ..ops.camera import make_camera
from ..ops.pt_cuda import check_device, render_bsdf_pt
from ..scene.model import Scene
from ..server.component import RenderComponent, RenderResult
from ..server.registry import get_server, register_renderer
from ..utils.timing import GLOBAL_TIMER
from . import _wavefront
from .routes import (
    make_route, plan_route, prepare, progressive_loop, tone_map,
)
# `benchmark/tests/test_bench_mesh.py` pins the megamesh rule through these
from .routes import MEGAMESH_MAX_TRIS_CUDA, pinned_megamesh_max_tris  # noqa


@register_renderer("AccPathTracer", description=(
    "An accelerated path tracer.\n"
    "Multi-BSDF (Lambertian/conductor/glass/microfacet/plastic) path "
    "tracing in one CUDA kernel (plain torch on the CPU)."))
class AccPathTracerRenderer(RenderComponent):
    def __init__(self, seed: int = 0, checkpoint_path: str = None,
                 device="cuda"):
        self.seed = seed
        self.checkpoint_path = checkpoint_path
        self.device = device

    def render(self, scene: Scene) -> RenderResult:
        dev = check_device(self.device)
        # each phase is a span "AccPathTracer.<phase>" of GLOBAL_TIMER
        timer = GLOBAL_TIMER.scope("AccPathTracer")
        ro = scene.render_option
        w, h, spp, depth = (ro.width, ro.height, ro.samples_per_pixel,
                            ro.depth)
        with timer.phase("scene-prep"):
            arrays, ss = prepare(scene)
            cam = make_camera(scene.camera, device=dev)
        plan = plan_route(scene, "AccPathTracer", bool(self.checkpoint_path),
                          dev.type, arrays, ss)
        if plan.kind == "megamesh":
            img = self._render_megamesh(scene, plan, arrays, ss, cam, timer)
        elif plan.kind == "hybrid":
            img = self._render_hybrid(scene, plan, arrays, ss, cam, timer)
        elif plan.unit == "passes":
            img = self._passes(self._route(scene, plan, arrays, ss, cam), ro,
                               timer)
        else:
            if self.checkpoint_path:
                get_server().logger.warning(
                    f"--checkpoint: render fits a single pass ({spp} spp); "
                    "nothing to snapshot")
            with timer.phase("render"):
                # .cpu() waits for the device, so the phase covers the kernel
                img = render_bsdf_pt(
                    ss, cam, w, h, spp, depth, seed=self.seed,
                    env_map=arrays.env_map if ss.ambient_type == 1 else None,
                    textures=arrays.textures if ss.tri_uv else None,
                    device=dev).cpu().numpy()
            with timer.phase("host-post"):
                img = np.clip(img[::-1], 0.0, 1.0)  # row 0 top; Screen clamp
        get_server().logger.log("phases: " + timer.summary())
        get_server().logger.log("Done...")
        rgba = np.concatenate([img, np.ones((h, w, 1), np.float32)], axis=2)
        return RenderResult(pixels=rgba, width=w, height=h)

    def _route(self, scene, plan, arrays, ss, cam, timer=None):
        """The planned route's tables, on the camera's device (a mesh
        route's inside `timer`'s `bvh-build` phase)."""
        return make_route(scene, "AccPathTracer", bool(self.checkpoint_path),
                          cam.position.device, self.seed, plan, arrays, ss,
                          cam, timer)

    def _passes(self, route, ro, timer):
        """The route's passes (`progressive_loop`); the image, row 0 =
        top."""
        return progressive_loop(route, ro.width, ro.height,
                                ro.samples_per_pixel, self.seed,
                                self.checkpoint_path, timer)

    def _render_megamesh(self, scene, plan, arrays, ss, cam, timer):
        """The mesh form in passes; returns the image, row 0 = top."""
        route = self._route(scene, plan, arrays, ss, cam, timer)
        get_server().logger.log(route.log)
        return self._passes(route, scene.render_option, timer)

    def _render_hybrid(self, scene, plan, arrays, ss, cam, timer):
        """The hybrid route; returns the image, row 0 = top."""
        route = self._route(scene, plan, arrays, ss, cam, timer)
        get_server().logger.log(route.log)
        mesh_cuda.reset_route_counts()
        _wavefront.reset_route_counts()
        ro = scene.render_option
        w, h, spp = ro.width, ro.height, ro.samples_per_pixel
        if plan.unit == "passes":
            img = self._passes(route, ro, timer)
        else:
            if self.checkpoint_path:
                get_server().logger.warning(
                    f"--checkpoint: render fits a single pass ({spp} spp, "
                    f"chunk {plan.chunk}); nothing to snapshot")
            with timer.phase("render"):
                film = route.film(0, spp, 0, w * h)
                with timer.phase("film-wait"):   # held by the device
                    film = film.cpu().numpy()
            with timer.phase("host-post"):
                img = tone_map(film, spp, w, h, False)
        get_server().logger.log(
            "hybrid route: " + ", ".join(
                f"{k} {v}" for k, v in {**mesh_cuda.ROUTE_COUNTS,
                                        **mesh_cuda.ENGINE_COUNTS,
                                        **_wavefront.ROUTE_COUNTS}.items()))
        return img
