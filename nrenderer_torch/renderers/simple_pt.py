"""SimplePathTracer: diffuse Monte Carlo path tracing.

Counterpart of the one-shot render of `nrenderer_tpu/renderers/simple_pt.py`,
the rebuild of the simple_path_tracing plugin
(`components/simple_path_tracing/src/SimplePathTracer.cpp`).  Estimator per
bounce (`trace`, `SimplePathTracer.cpp:144-177`):

    depth cap          -> ambient.constant
    object before light-> Le + BRDF * Li * cos(n, wi) / pdf
    area light hit     -> its radiance
    miss               -> black

Lambertian sampling matches `shaders/Lambertian.cpp:15-46`: uniform hemisphere
about the stored (unflipped) normal via the Onb, pdf = 1/(2 pi),
BRDF = albedo / pi, so throughput *= 2 * albedo * cos.

An env-map ambient (ambient type 1) is sampled on misses, through the
kernel's env form, and faces with a diffuse map read it through the
kernel's texture form (binned 32x128 tables), as the JAX SimplePathTracer
hands `env_map` and `textures` to its Pallas route (`simple_pt.py:300-317`).
On `device="cuda"` the whole render is the hand-written CUDA kernel
(`ops/pt_cuda.py`); on `device="cpu"` it is that kernel's plain torch
version.

The progressive route (the renderer's `progressive`, `checkpoint_path`
and `preview_every`, or NR_PROGRESSIVE=1 and NR_CHECKPOINT=<file>; and
`render_progressive`, the JAX function's counterpart) renders in the
passes of `routes.progressive_plan`, as the JAX route does: each pass
one kernel call at its own seed (`routes.pass_seed`), its linear film
summed on the host, a gamma'd preview posted to the Screen every
`preview_every` passes and, with a checkpoint path, the film saved after
each pass; an interrupted render resumes at the next pass and ends on
the uninterrupted image. With a thin lens the JAX route runs its XLA
engine (`jax.random` draws), the port its kernel's lens (hash draws):
there the two agree in distribution only."""
from __future__ import annotations

import os

import numpy as np

from ..ops.camera import make_camera
from ..ops.pt_cuda import check_device, render_simple_pt
from ..scene.model import Scene
from ..server.component import RenderComponent, RenderResult
from ..server.registry import get_server, register_renderer
from ..utils.timing import GLOBAL_TIMER
from .routes import build_route, prepare, progressive_loop, progressive_plan


@register_renderer("SimplePathTracer", description=(
    "A simple path tracer.\n"
    "Diffuse Monte Carlo path tracing in one CUDA kernel (plain torch on "
    "the CPU)."))
class SimplePathTracerRenderer(RenderComponent):
    def __init__(self, seed: int = 0, checkpoint_path: str = None,
                 progressive: bool = False, preview_every: int = 1,
                 device="cuda"):
        self.seed = seed
        self.checkpoint_path = checkpoint_path or os.environ.get(
            "NR_CHECKPOINT")
        self.progressive = progressive or bool(self.checkpoint_path) or \
            os.environ.get("NR_PROGRESSIVE") == "1"
        self.preview_every = preview_every
        self.device = device

    def render(self, scene: Scene) -> RenderResult:
        dev = check_device(self.device)
        # per-render phase stats, logged like the reference's per-thread
        # intersect timing (`SimplePathTracer.cpp:90-94`); each phase is a
        # span "SimplePathTracer.<phase>" of GLOBAL_TIMER
        timer = GLOBAL_TIMER.scope("SimplePathTracer")
        ro = scene.render_option
        w, h, spp, depth = (ro.width, ro.height, ro.samples_per_pixel,
                            ro.depth)
        with timer.phase("scene-prep"):
            arrays, ss = prepare(scene)
            cam = make_camera(scene.camera, device=dev)
        env_map = arrays.env_map if ss.ambient_type == 1 else None
        textures = arrays.textures if ss.tri_uv else None
        if self.progressive:
            img = render_progressive(
                ss, cam, w, h, spp, depth, seed=self.seed, env_map=env_map,
                textures=textures, checkpoint_path=self.checkpoint_path,
                preview_every=self.preview_every, timer=timer)
        else:
            with timer.phase("render"):
                # .cpu() waits for the device, so the phase covers the kernel
                img = render_simple_pt(ss, cam, w, h, spp, depth,
                                       seed=self.seed, env_map=env_map,
                                       textures=textures,
                                       device=dev).cpu().numpy()
            with timer.phase("host-post"):
                img = img[::-1]  # bottom-up -> row 0 top
                img = np.clip(img, 0.0, 1.0)  # Screen.set clamp, Screen.cpp:63
        get_server().logger.log("phases: " + timer.summary())
        get_server().logger.log("Done...")
        rgba = np.concatenate([img, np.ones((h, w, 1), np.float32)], axis=2)
        return RenderResult(pixels=rgba, width=w, height=h)


def render_progressive(ss, cam, width, height, spp, depth, seed=0,
                       env_map=None, textures=None, checkpoint_path=None,
                       preview_every=1, timer=None):
    """Progressive render with Screen previews and checkpoint/resume on
    the camera's device (`simple_pt.py:159-222`); returns the image, row
    0 = top, clipped to [0, 1].  `env_map`: the (He, We, 3) map when the
    ambient is one; `textures`: the scene's textures when faces carry
    maps.  `timer` (by default `GLOBAL_TIMER.scope("SimplePathTracer")`)
    times the passes as `routes.progressive_loop` does."""
    route = build_route(progressive_plan(width, height, spp),
                        "SimplePathTracer", ss, cam, width, height, spp,
                        depth, seed, env_map, textures)
    return progressive_loop(route, width, height, spp, seed,
                            checkpoint_path,
                            timer or GLOBAL_TIMER.scope("SimplePathTracer"),
                            preview_every)
