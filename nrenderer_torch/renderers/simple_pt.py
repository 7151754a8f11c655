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
hands `env_map` and `textures` to its Pallas route (`simple_pt.py:300-317`).  On `device="cuda"` the whole render is the hand-written CUDA kernel
(`ops/pt_cuda.py`); on `device="cpu"` it is that kernel's plain torch
version.  Progressive rendering and checkpoint/resume are not ported yet
(ROADMAP A4)."""
from __future__ import annotations

import numpy as np

from ..ops.camera import make_camera
from ..ops.intersect import make_static_scene
from ..ops.pt_cuda import check_device, render_simple_pt
from ..scene.arrays import build_scene_arrays
from ..scene.model import Scene
from ..server.component import RenderComponent, RenderResult
from ..server.registry import get_server, register_renderer
from ..utils.timing import GLOBAL_TIMER, PhaseTimer


@register_renderer("SimplePathTracer", description=(
    "A simple path tracer.\n"
    "Diffuse Monte Carlo path tracing in one CUDA kernel (plain torch on "
    "the CPU)."))
class SimplePathTracerRenderer(RenderComponent):
    def __init__(self, seed: int = 0, device="cuda"):
        self.seed = seed
        self.device = device

    def render(self, scene: Scene) -> RenderResult:
        dev = check_device(self.device)
        # per-render phase stats, logged like the reference's per-thread
        # intersect timing (`SimplePathTracer.cpp:90-94`)
        timer = PhaseTimer()
        ro = scene.render_option
        w, h, spp, depth = (ro.width, ro.height, ro.samples_per_pixel,
                            ro.depth)
        with timer.phase("scene-prep"):
            arrays = build_scene_arrays(scene)
            ss = make_static_scene(arrays)
            cam = make_camera(scene.camera, device=dev)
        env_map = arrays.env_map if ss.ambient_type == 1 else None
        textures = arrays.textures if ss.tri_uv else None
        render_phase = f"render[{dev.type}]"
        with timer.phase(render_phase):
            # .cpu() waits for the device, so the phase covers the kernel
            img = render_simple_pt(ss, cam, w, h, spp, depth, seed=self.seed,
                                   env_map=env_map, textures=textures,
                                   device=dev).cpu().numpy()
        with timer.phase("host-post"):
            img = img[::-1]  # bottom-up -> row 0 top
            img = np.clip(img, 0.0, 1.0)  # Screen.set clamp (Screen.cpp:63)
        GLOBAL_TIMER.add("SimplePathTracer.render",
                         timer.get(render_phase).total_s)
        get_server().logger.log("phases: " + timer.summary())
        get_server().logger.log("Done...")
        rgba = np.concatenate([img, np.ones((h, w, 1), np.float32)], axis=2)
        return RenderResult(pixels=rgba, width=w, height=h)


def pick_chunk(width: int, height: int, spp: int,
               budget_rays: int = 1 << 21) -> int:
    """Largest spp-divisor chunk keeping the wavefront under ~budget rays
    (`simple_pt.py:225-233`)."""
    n_pix = max(1, width * height)
    best = 1
    for c in range(1, spp + 1):
        if spp % c == 0 and n_pix * c <= budget_rays:
            best = c
    return best
