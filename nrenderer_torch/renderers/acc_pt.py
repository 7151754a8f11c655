"""AccPathTracer: multi-BSDF path tracing, analytic scenes and meshes.

Counterpart of `nrenderer_tpu/renderers/acc_pt.py`, the rebuild of the
acc_path_tracing plugin (`components/acc_path_tracing/`): SimplePathTracer's
estimator with material-type dispatch {0 Lambertian, 1 smooth conductor,
2 dielectric glass, 3 microfacet, 4 plastic} (`AccPathTracer.cpp:120-181`,
`ShaderCreator.hpp:17-39`).

The routing of the JAX renderer is kept as it stands: `acc_type` (reference
`Scene.hpp:23`) 0 forces brute force (refused past `ACC_TYPE0_MAX_TRIS`
triangles), 1 (the default) accelerates when the scene has more than
`BVH_THRESHOLD` triangles, 2 accelerates any triangle pool.  A scene that
is not accelerated runs the path-tracing megakernel in its BSDF form
(`ops/pt_cuda.py`, env-map terms when the ambient is an env map, texture
terms when faces carry maps): the CUDA kernel on `device="cuda"`, its
plain torch version on `device="cpu"`.  A scene without primitives runs
the megakernel as well (the CUDA kernel handles it; the JAX package sends
it to its XLA wavefront).

An accelerated pool of at most `megamesh_max_tris(device)` triangles
without an env map takes the megamesh route (`acc_pt.py:297-341`): on the
CPU `MEGAMESH_MAX_TRIS` (1024, the JAX package's figure: the plain mesh
form is the CPU's slow path), on the card `MEGAMESH_MAX_TRIS_CUDA`
(20,480, the largest measured pool at which the megamesh route beat the
hybrid route on an H100: PERF.md §5's crossover; the JAX package's route
too depends on its backend, `acc_pt.py:297-303`).  The pool is packed
into BVH-preorder blocks (`ops/bvh.build_mesh_accel`) and the kernel's
mesh form runs the blocked sweep inside its bounce loop, in passes of
`pcall` in (32, 16, 8, 4, 2, 1) samples with Screen previews and
`--checkpoint`.  Textures are dropped when the pool carries no UVs.

Larger pools and env-map mesh scenes take the hybrid route
(`acc_pt.py:389-472`): a torch wavefront of whole-film ray batches whose
every bounce runs the mesh pipe (`mesh_cuda.intersect_triangles_mesh`:
top-AABB cull, the streaming pack B3a, an entry-cell sort, the standalone
sweep B2, the unpack B3b), in chunks of `pick_chunk(w, h, spp, budget)`
samples (a budget of 2^24 rays on the card, 2^21 on the CPU).  At depth
>= 12 the wavefront is staged (`_wavefront.build_staged_wavefront_fn`:
the ray state is packed into smaller buffers as paths die); the JAX
package stages only off the CPU, for XLA's compile time, while the port
stages on both.  An env map is looked up exactly at every miss
(`env.sample_env_map_v3`) and textures are sampled at full resolution
(`texture.resolve_diffuse`), as on the JAX package's XLA route.  The
route runs one call per chunk, with Screen previews and `--checkpoint`,
when there are more than 4 chunks or a checkpoint path.  All draws come
from the kernel's hash stream at the render's seed and each sample's
index, so a resumed render reproduces the remaining chunks exactly.

With a checkpoint path the megakernel and megamesh routes run in passes
of `pcall` samples, each with its own seed `seed * 100003 + step`,
posting a preview to the Screen and saving the linear film after each
pass; an interrupted render resumes at the next pass
(`server/checkpoint.py`)."""
from __future__ import annotations

import contextlib
from typing import Optional

import numpy as np
import torch

from ..ops import mesh_cuda
from ..ops.bvh import build_mesh_accel
from ..ops.camera import make_camera
from ..ops.env import sample_env_map_v3
from ..ops.intersect import StaticScene, make_static_scene
from ..ops.mesh_cuda import make_mesh_tables
from ..ops.pt_core import (
    bsdf_bounce, finish_ambient, make_mat_channels, scene_epsilon,
)
from ..ops.pt_cuda import (
    MAX_TRIS, check_device, check_supported, make_env_tables,
    make_tex_tables, pt_accumulate, render_bsdf_pt,
)
from ..ops.soa import V3
from ..scene.arrays import build_scene_arrays
from ..scene.model import Scene
from ..server.component import RenderComponent, RenderResult
from ..server.registry import get_server, register_renderer
from ..utils.timing import GLOBAL_TIMER
from . import _wavefront
from ._wavefront import (
    bounce_uniforms, build_staged_wavefront_fn, build_wavefront_fn,
)
from .simple_pt import pick_chunk

BVH_THRESHOLD = 64
MEGAMESH_MAX_TRIS = 1024  # the megamesh route's pools on the CPU
# and on the card: the largest measured pool at which the megamesh route's
# median CLI wall beat the hybrid route's on an H100 (500x500, 256 spp,
# depth 20: at 20,480 faces 1.241 s against 2.864 s; at 81,920 faces
# 4.153 s against 3.836 s; PERF.md §5, `tools/torch_ab.py --crossover`)
MEGAMESH_MAX_TRIS_CUDA = 20480
ACC_TYPE0_MAX_TRIS = MAX_TRIS  # acc_type=0 (brute force) refused past this
STAGED_MIN_DEPTH = 12  # the hybrid route stages its wavefront from here
HYBRID_BUDGET_RAYS = {"cuda": 1 << 24, "cpu": 1 << 21}  # rays per chunk


def accelerates(acc_type: int, n_tri: int) -> bool:
    """Whether the JAX renderer sends this triangle pool to its mesh
    engines (`acc_pt.py:261-277`)."""
    if acc_type == 0 and n_tri > ACC_TYPE0_MAX_TRIS:
        get_server().logger.warning(
            f"AccPathTracer: acc_type=0 (brute force) refused for {n_tri} "
            f"triangles (> {ACC_TYPE0_MAX_TRIS}); using the accelerated "
            "sweep")
        acc_type = 1
    if acc_type == 0:
        return False
    if acc_type == 1:
        return n_tri > BVH_THRESHOLD
    return n_tri > 0


def megamesh_max_tris(device_type: str) -> int:
    """The largest accelerated pool the megamesh route takes on a device
    of this type ("cuda" or "cpu")."""
    return MEGAMESH_MAX_TRIS_CUDA if device_type == "cuda" \
        else MEGAMESH_MAX_TRIS


def takes_hybrid(n_tri: int, env: bool, device_type: str) -> bool:
    """Whether an accelerated pool of `n_tri` triangles takes the hybrid
    route (else the megamesh route): under an env map, or past the
    device's `megamesh_max_tris`."""
    return env or n_tri > megamesh_max_tris(device_type)


@contextlib.contextmanager
def pinned_megamesh_max_tris(limit: int):
    """Both devices' megamesh limit set to `limit` for the duration: a
    route forced for a measurement (0: the hybrid route on any pool)."""
    global MEGAMESH_MAX_TRIS, MEGAMESH_MAX_TRIS_CUDA
    saved = MEGAMESH_MAX_TRIS, MEGAMESH_MAX_TRIS_CUDA
    MEGAMESH_MAX_TRIS = MEGAMESH_MAX_TRIS_CUDA = limit
    try:
        yield
    finally:
        MEGAMESH_MAX_TRIS, MEGAMESH_MAX_TRIS_CUDA = saved


def checkpoint_pass_spp(spp: int) -> int:
    """Samples per checkpointed pass: the largest divisor of spp that is at
    most spp // 8 (about 8 passes), as the JAX renderer splits it."""
    pcall = 1
    for k in range(1, spp + 1):
        if spp % k == 0 and k <= max(spp // 8, 1):
            pcall = k
    return pcall


def megamesh_pass_spp(spp: int) -> int:
    """Samples per megamesh pass: the first of 32, 16, 8, 4, 2, 1 that
    divides spp (`acc_pt.py:317-321`)."""
    for k in (32, 16, 8, 4, 2, 1):
        if spp % k == 0:
            return k
    return spp


def progressive_loop(checkpoint_path, seed, timer, w, h, spp, pcall,
                     render_step, fp_parts, fp_arrays, preview_every=1):
    """Passes of `pcall` samples with Screen previews and checkpoint/resume
    (the JAX renderer's `_progressive_loop`).  `render_step(step)` returns
    the (n_pix, 3) linear film SUM of pass `step`; passes use disjoint seeds,
    so a resume reproduces the remaining passes exactly.  A preview is
    posted to the Screen every `preview_every` passes and after the last.
    `timer` times the loop as `render` (every pass, the first included,
    with the previews and checkpoint writes between them), and inside it
    the passes as `first-pass` and `render-pass` and the previews as
    `host-preview`; inside each pass, `pass-wait` runs from the pass's
    launch through the return of its film's copy to the host, and
    `film-add` is the add of that film into the host sum.  Returns the
    image, row 0 = top."""
    from ..server.checkpoint import (
        load_checkpoint, render_fingerprint, save_checkpoint)
    film = np.zeros((w * h, 3), np.float32)
    start = 0
    fingerprint = None
    if checkpoint_path:
        fingerprint = render_fingerprint(fp_parts, arrays=fp_arrays)
        loaded = load_checkpoint(checkpoint_path, fingerprint)
        if loaded is not None:
            film, spp_done = loaded
            start = spp_done // pcall
            get_server().logger.log(
                f"resumed at {spp_done}/{spp} spp from {checkpoint_path}")
    n_steps = spp // pcall
    with timer.phase("render"):
        for step in range(start, n_steps):
            with timer.phase("first-pass" if step == start
                             else "render-pass"):
                with timer.phase("pass-wait"):
                    part = render_step(step).cpu().numpy()
                with timer.phase("film-add"):
                    film += part
            done = (step + 1) * pcall
            if (step + 1) % preview_every == 0 or step == n_steps - 1:
                with timer.phase("host-preview"):
                    img = np.sqrt(np.maximum(film / done, 0.0))
                    img = img.reshape(h, w, 3)[::-1]
                    get_server().screen.set(
                        np.concatenate([img, np.ones((h, w, 1), np.float32)],
                                       axis=2), w, h)
            if checkpoint_path:
                save_checkpoint(checkpoint_path, film, done, w, h, seed,
                                fingerprint)
    img = np.sqrt(np.maximum(film / spp, 0.0)).reshape(h, w, 3)
    return np.clip(img[::-1], 0.0, 1.0)


def _device_textures(textures, device):
    """(H, W, 3) float32 tensors of (H, W, 3+) images (the scene's textures
    or env map) on `device`."""
    return tuple(torch.as_tensor(np.ascontiguousarray(
        np.asarray(t, np.float32)[..., :3]), device=device)
        for t in textures)


def make_bsdf_bounce(ss: StaticScene, t_min: float, tri_bvh=None,
                     env_map: Optional[torch.Tensor] = None, textures=None):
    """`bounce(o, d, thr, rad, alive, u1, u2, u3, coherent=False)`: one
    `bsdf_bounce` over the scene, and with an env map its exact lookup
    added at every miss (misses keep their direction and throughput), as
    the JAX package's XLA bounce does (`acc_pt.py:69-93, :120-142`)."""
    mat_ch = make_mat_channels(ss)

    def bounce(o, d, thr, rad, alive, u1, u2, u3, coherent=False):
        out = bsdf_bounce(ss, mat_ch, o, d, thr, rad, alive, u1, u2, u3,
                          t_min=t_min, tri_bvh=tri_bvh,
                          with_miss=env_map is not None, textures=textures,
                          coherent=coherent)
        if env_map is None:
            return out
        o, d, thr, rad, alive, miss = out
        env = sample_env_map_v3(env_map, d)
        ew = miss.to(torch.float32)
        return o, d, thr, V3(rad.x + ew * thr.x * env.x,
                             rad.y + ew * thr.y * env.y,
                             rad.z + ew * thr.z * env.z), alive

    return bounce


def trace_bsdf_wavefront(ss: StaticScene, o: V3, d: V3, pid: torch.Tensor,
                         sp: torch.Tensor, seed: int, depth: int,
                         env_map=None, tri_bvh=None, t_min: float = None,
                         textures=None) -> V3:
    """The (N,)-ray wavefront of the five-lobe estimator: `depth` bounces
    drawing the kernel's uniforms for pixels `pid` and samples `sp`, then
    the depth cap's ambient; returns the radiance (`acc_pt.py:53-99`)."""
    if t_min is None:
        t_min = scene_epsilon(ss)
    bounce = make_bsdf_bounce(ss, t_min, tri_bvh, env_map, textures)
    ones = torch.ones_like(o.x)
    zeros = torch.zeros_like(o.x)
    thr, rad = V3(ones, ones, ones), V3(zeros, zeros, zeros)
    alive = torch.ones_like(o.x, dtype=torch.bool)
    for b in range(depth):
        o, d, thr, rad, alive = bounce(o, d, thr, rad, alive,
                                       *bounce_uniforms(pid, sp, seed, b))
    return finish_ambient(ss, thr, rad, alive)


def build_render_fn(ss: StaticScene, cam, width: int, height: int,
                    depth: int, chunk: int, tri_bvh=None, env_map=None,
                    textures=None, staged: bool = False, pix0: int = 0,
                    n_pix: int = None):
    """`render(seed, sp0, n_spp)`: the linear film SUM ((W*H, 3)) of
    samples [sp0, sp0 + n_spp) (of pixels [pix0, pix0 + n_pix) only, the
    film (n_pix, 3), when they are given), by the staged wavefront
    (`staged`; the camera bounce peeled off as the coherent variant when
    there is a mesh pipe) or the plain one (`acc_pt.py:102-161`).  `tri_bvh`: the mesh
    tables (`mesh_cuda.MeshTables`) whose pool runs the mesh pipe;
    `env_map`: an (He, We, 3) tensor; `textures`: (H, W, 3) tensors."""
    t_min = scene_epsilon(ss)
    if staged:
        return build_staged_wavefront_fn(
            cam, width, height, chunk,
            make_bsdf_bounce(ss, t_min, tri_bvh, env_map, textures),
            lambda thr, rad, alive: finish_ambient(ss, thr, rad, alive),
            depth, peel_first=tri_bvh is not None, pix0=pix0, n_pix=n_pix)
    return build_wavefront_fn(
        cam, width, height, chunk,
        lambda o, d, pid, sp, seed: trace_bsdf_wavefront(
            ss, o, d, pid, sp, seed, depth, env_map=env_map,
            tri_bvh=tri_bvh, t_min=t_min, textures=textures),
        pix0=pix0, n_pix=n_pix)


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
            arrays = build_scene_arrays(scene)
            ss = make_static_scene(arrays)
            cam = make_camera(scene.camera, device=dev)
        n_tri = int(np.asarray(arrays.tri_valid).sum())
        acc_type = int(getattr(ro, "acc_type", 1))
        use_env = ss.ambient_type == 1
        env_map = arrays.env_map if use_env else None
        textures = arrays.textures if ss.tri_uv else None
        if accelerates(acc_type, n_tri):
            if takes_hybrid(n_tri, use_env, dev.type):
                img = self._render_hybrid(arrays, ss, cam, dev, timer, w, h,
                                          spp, depth, env_map, textures)
            else:
                img = self._render_megamesh(arrays, ss, cam, dev, timer, w, h,
                                            spp, depth, textures)
        else:
            img = self._render_megakernel(ss, cam, dev, timer, w, h, spp,
                                          depth, env_map, textures)
        get_server().logger.log("phases: " + timer.summary())
        get_server().logger.log("Done...")
        rgba = np.concatenate([img, np.ones((h, w, 1), np.float32)], axis=2)
        return RenderResult(pixels=rgba, width=w, height=h)

    def _render_megamesh(self, arrays, ss, cam, dev, timer, w, h, spp,
                         depth, textures):
        """The mesh form in passes; returns the image, row 0 = top."""
        with timer.phase("bvh-build"):
            ma = build_mesh_accel(arrays, make_mat_channels(ss))
            if textures and ma.bt.tex is None:
                textures = None   # no per-face UVs made it into the pool
            mesh = make_mesh_tables(ma.bt, dev)
            tex = make_tex_tables(textures, dev) if textures else None
        get_server().logger.log(
            f"AccPathTracer: in-kernel mesh sweep over {len(ss.tri)} "
            f"triangles ({ma.bt.n_blocks} blocks of {ma.bt.block})")
        pcall = megamesh_pass_spp(spp)
        t_min = scene_epsilon(ss)

        def render_step(step):
            film = torch.zeros((w * h, 3), dtype=torch.float32, device=dev)
            return pt_accumulate(film, ss, cam, w, h, 0, pcall, depth,
                                 self.seed * 100003 + step, t_min, bsdf=True,
                                 mesh=mesh, tex=tex)

        from ..server.checkpoint import camera_key
        return progressive_loop(
            self.checkpoint_path, self.seed, timer, w, h, spp, pcall,
            render_step,
            (ss, camera_key(cam), w, h, spp, depth, self.seed, pcall,
             "megamesh"),
            tuple(textures or ()))

    def _render_hybrid(self, arrays, ss, cam, dev, timer, w, h, spp, depth,
                       env_map, textures):
        """The hybrid route; returns the image, row 0 = top."""
        with timer.phase("bvh-build"):
            ma = build_mesh_accel(arrays, make_mat_channels(ss))
            if textures and ma.bt.tex is None:
                textures = None   # no per-face UVs made it into the pool
            mesh = make_mesh_tables(ma.bt, dev)
            env = (_device_textures((env_map,), dev)[0]
                   if env_map is not None else None)
            tex = _device_textures(textures, dev) if textures else None
        chunk = pick_chunk(w, h, spp, budget_rays=HYBRID_BUDGET_RAYS[dev.type])
        staged = depth >= STAGED_MIN_DEPTH
        n_steps = spp // chunk
        get_server().logger.log(
            f"AccPathTracer: hybrid mesh route, "
            f"{'staged' if staged else 'plain'} wavefront in chunks of "
            f"{chunk} spp, standalone sweep over {len(ss.tri)} triangles "
            f"({ma.bt.n_blocks} blocks of {ma.bt.block}) with the streaming "
            f"compactor{', env map' if env is not None else ''}"
            f"{', textures' if tex else ''}")
        mesh_cuda.reset_route_counts()
        _wavefront.reset_route_counts()
        fn = build_render_fn(ss, cam, w, h, depth, chunk, tri_bvh=mesh,
                             env_map=env, textures=tex, staged=staged)
        if n_steps > 4 or (self.checkpoint_path and n_steps > 1):
            from ..server.checkpoint import camera_key
            img = progressive_loop(
                self.checkpoint_path, self.seed, timer, w, h, spp, chunk,
                lambda step: fn(self.seed, step * chunk, chunk),
                (ss, camera_key(cam), w, h, spp, depth, self.seed, chunk,
                 True, staged, float(cam.lens_radius) > 0.0,
                 env is not None),
                ((np.asarray(env_map),) if env is not None else ())
                + tuple(textures or ()))
        else:
            if self.checkpoint_path:
                get_server().logger.warning(
                    f"--checkpoint: render fits a single pass ({spp} spp, "
                    f"chunk {chunk}); nothing to snapshot")
            with timer.phase("render"):
                film = fn(self.seed, 0, spp).cpu().numpy()
            with timer.phase("host-post"):
                img = np.sqrt(np.maximum(film / spp, 0.0)).reshape(h, w, 3)
                img = np.clip(img[::-1], 0.0, 1.0)
        get_server().logger.log(
            "hybrid route: " + ", ".join(
                f"{k} {v}" for k, v in {**mesh_cuda.ROUTE_COUNTS,
                                        **mesh_cuda.ENGINE_COUNTS,
                                        **_wavefront.ROUTE_COUNTS}.items()))
        return img

    def _render_megakernel(self, ss, cam, dev, timer, w, h, spp, depth,
                           env_map, textures):
        """The dense forms, in one call or checkpointed passes; returns the
        image, row 0 = top."""
        use_env = env_map is not None
        check_supported(ss)
        if self.checkpoint_path and spp > 1:
            pcall = checkpoint_pass_spp(spp)
            t_min = scene_epsilon(ss)
            env = make_env_tables(env_map, dev) if use_env else None
            tex = make_tex_tables(textures, dev) if textures else None

            def render_step(step):
                film = torch.zeros((w * h, 3), dtype=torch.float32,
                                   device=dev)
                return pt_accumulate(film, ss, cam, w, h, 0, pcall, depth,
                                     self.seed * 100003 + step, t_min,
                                     bsdf=True, env=env, tex=tex)

            from ..server.checkpoint import camera_key
            return progressive_loop(
                self.checkpoint_path, self.seed, timer, w, h, spp, pcall,
                render_step,
                (ss, camera_key(cam), w, h, spp, depth, self.seed, pcall,
                 "megakernel", use_env),
                ((np.asarray(env_map),) if use_env else ())
                + tuple(textures or ()))
        if self.checkpoint_path:
            get_server().logger.warning(
                f"--checkpoint: render fits a single pass ({spp} spp); "
                "nothing to snapshot")
        with timer.phase("render"):
            # .cpu() waits for the device, so the phase covers the kernel
            img = render_bsdf_pt(ss, cam, w, h, spp, depth, seed=self.seed,
                                 env_map=env_map, textures=textures,
                                 device=dev).cpu().numpy()
        with timer.phase("host-post"):
            img = np.clip(img[::-1], 0.0, 1.0)  # row 0 top; Screen clamp
        return img
