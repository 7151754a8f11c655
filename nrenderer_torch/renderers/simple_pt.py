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

The progressive route (`render_progressive`; the renderer's `progressive`,
`checkpoint_path` and `preview_every`, or NR_PROGRESSIVE=1 and
NR_CHECKPOINT=<file>) renders in passes of `pick_chunk(w, h, spp)`
samples, as the JAX route does (`simple_pt.py:159-222`): pass `step` is
one kernel call over samples [0, chunk) at seed `seed * 100003 + step`
(the JAX Pallas branch's numbering, so a pass is `render_pt_pallas_linear`
at that seed), its linear film summed on the host, a gamma'd preview
posted to the Screen every `preview_every` passes and, with a checkpoint
path, the film saved after each pass; an interrupted render resumes at the
next pass and ends on the uninterrupted image.  With a thin lens the JAX
route runs its XLA engine (`jax.random` draws), the port its kernel's lens
(hash draws): there the two agree in distribution only."""
from __future__ import annotations

import os

import numpy as np
import torch

from ..ops.camera import make_camera
from ..ops.intersect import make_static_scene
from ..ops.pt_core import scene_epsilon
from ..ops.pt_cuda import (
    _int32, check_device, make_env_tables, make_tex_tables, pt_accumulate,
    render_simple_pt,
)
from ..scene.arrays import build_scene_arrays
from ..scene.model import Scene
from ..server.component import RenderComponent, RenderResult
from ..server.registry import get_server, register_renderer
from ..utils.timing import GLOBAL_TIMER


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
            arrays = build_scene_arrays(scene)
            ss = make_static_scene(arrays)
            cam = make_camera(scene.camera, device=dev)
        env_map = arrays.env_map if ss.ambient_type == 1 else None
        textures = arrays.textures if ss.tri_uv else None
        if self.progressive:
            img = render_progressive(
                ss, cam, w, h, spp, depth, seed=self.seed, env_map=env_map,
                textures=textures, checkpoint_path=self.checkpoint_path,
                preview_every=self.preview_every, timer=timer)
            get_server().logger.log("phases: " + timer.summary())
            get_server().logger.log("Done...")
            rgba = np.concatenate([img, np.ones((h, w, 1), np.float32)],
                                  axis=2)
            return RenderResult(pixels=rgba, width=w, height=h)
        with timer.phase("render"):
            # .cpu() waits for the device, so the phase covers the kernel
            img = render_simple_pt(ss, cam, w, h, spp, depth, seed=self.seed,
                                   env_map=env_map, textures=textures,
                                   device=dev).cpu().numpy()
        with timer.phase("host-post"):
            img = img[::-1]  # bottom-up -> row 0 top
            img = np.clip(img, 0.0, 1.0)  # Screen.set clamp (Screen.cpp:63)
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
    times the loop as `render`, every pass and preview inside it, and its
    passes as `first-pass` and `render-pass` (each holding `pass-wait`
    and `film-add`, `acc_pt.progressive_loop`), its previews as
    `host-preview`."""
    from ..server.checkpoint import camera_key
    from .acc_pt import progressive_loop
    dev = cam.position.device
    timer = timer or GLOBAL_TIMER.scope("SimplePathTracer")
    chunk = pick_chunk(width, height, spp)
    use_env = env_map is not None
    has_lens = float(cam.lens_radius) > 0.0
    t_min = scene_epsilon(ss)
    env = make_env_tables(env_map, dev) if use_env else None
    tex = make_tex_tables(textures, dev) if textures else None

    def render_step(step):
        film = torch.zeros((width * height, 3), dtype=torch.float32,
                           device=dev)
        return pt_accumulate(film, ss, cam, width, height, 0, chunk, depth,
                             _int32(seed * 100003 + step), t_min, env=env,
                             tex=tex)

    # the fingerprint covers everything that changes the estimator: the
    # scene, the camera, the film, the pass size and the env/texture pixels
    return progressive_loop(
        checkpoint_path, seed, timer, width, height, spp, chunk, render_step,
        (ss, camera_key(cam), width, height, spp, depth, seed, chunk,
         has_lens, use_env),
        ((np.asarray(env_map),) if use_env else ()) + tuple(textures or ()),
        preview_every=preview_every)


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
