"""The path tracers' routes, planned and built in one place.

A route is everything that decides a path-traced film besides the scene:
the kernel form and its tables, how the samples split into passes, each
pass's seed, the checkpoint fingerprint and the tone map.  SimplePathTracer
and AccPathTracer (`simple_pt.py`, `acc_pt.py`) render a route on one
device; the ranks of a sharded render (`parallel/mesh.py`) render their
share of the same route, so a world of one is the one-device render, bit
for bit.  `plan_route` picks a route and says how its work divides,
`make_route` builds it.

The routes (`Plan.kind`):

- "dense": SimplePathTracer's one-shot render, the kernel's diffuse form
  over every sample (`pt_cuda.render_simple_pt`);
- "progressive": SimplePathTracer in passes of `pick_chunk(w, h, spp)`
  samples (the JAX route, `simple_pt.py:159-222`), pass `step` at seed
  `pass_seed`, the JAX Pallas branch's numbering wrapped to int32;
- "megakernel": AccPathTracer on a scene it does not accelerate, the
  kernel's BSDF form (env-map terms when the ambient is an env map,
  texture terms when faces carry maps) in one shot
  (`pt_cuda.render_bsdf_pt`) or, with a checkpoint, in passes of
  `checkpoint_pass_spp` samples at seeds `pass_seed`;
- "megamesh": an accelerated pool of at most `megamesh_max_tris(device)`
  triangles without an env map (`acc_pt.py:297-341`): on the CPU
  `MEGAMESH_MAX_TRIS` (1024, the JAX package's figure: the plain mesh form
  is the CPU's slow path), on the card `MEGAMESH_MAX_TRIS_CUDA` (20,480,
  the pool up to which the megamesh route was measured to beat the
  hybrid route on an H100, see the constant; the JAX package's route too
  depends on its backend,
  `acc_pt.py:297-303`).  The pool is packed into
  BVH-preorder blocks (`ops/bvh.build_mesh_accel`) and the kernel's mesh
  form runs the blocked sweep inside its bounce loop, in passes of
  `megamesh_pass_spp` samples at seeds `pass_seed`.  Textures are dropped
  when the pool carries no UVs;
- "hybrid": larger pools and env-map mesh scenes (`acc_pt.py:389-472`): a
  torch wavefront of whole-film ray batches whose every bounce runs the
  mesh pipe (`_wavefront.build_render_fn`), in chunks of
  `pick_chunk(w, h, spp, budget)` samples (`HYBRID_BUDGET_RAYS`) at the
  render's seed, staged from depth `STAGED_MIN_DEPTH`; in one call per
  chunk when there are more than 4 chunks or a checkpoint.

`acc_type` (reference `Scene.hpp:23`) picks between AccPathTracer's
routes as the JAX renderer does (`accelerates`): 0 forces brute force
(refused past `ACC_TYPE0_MAX_TRIS` triangles), 1 (the default)
accelerates when the scene has more than `BVH_THRESHOLD` triangles, 2
accelerates any triangle pool.

Every random number comes from the kernel's hash keyed by the global
pixel, sample and seed, so a route renders any range of its units, or of
its pixels, as the whole render draws it."""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.bvh import build_mesh_accel
from ..ops.camera import make_camera
from ..ops.intersect import make_static_scene
from ..ops.mesh_cuda import make_mesh_tables
from ..ops.pt_core import make_mat_channels, scene_epsilon
from ..ops.pt_cuda import (
    MAX_TRIS, _int32, check_supported, gamma_image, make_env_tables,
    make_tex_tables, pt_accumulate,
)
from ..scene.arrays import build_scene_arrays
from ..server.checkpoint import (
    camera_key, load_checkpoint, render_fingerprint, save_checkpoint,
)
from ..server.registry import get_server
from ._wavefront import build_render_fn

RENDERERS = ("SimplePathTracer", "AccPathTracer")
BVH_THRESHOLD = 64
MEGAMESH_MAX_TRIS = 1024  # the megamesh route's pools on the CPU
# and on the card: the largest pool at which the megamesh route's median
# CLI wall measures below the hybrid route's on an H100 (500x500, 256
# spp, depth 20).  With the hybrid bounce in its wavefront kernels the
# crossover lies between 20,480 and 81,920 faces: 1.012 s against
# 1.263 s at 20,480, 3.088 s against 2.031 s at 81,920 (an H100 80GB
# HBM3 at 700 W, `tools/torch_ab.py --crossover`; PERF.md §6).  A limit
# past 81,920 would move the benchmark's `largemesh.hybrid` cell to the
# slower route, whose passes its `hybrid` reference does not follow
# (ROADMAP D3 item 4).
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


def pass_seed(seed: int, step: int, kind: str) -> int:
    """The seed of pass `step` of a kernel route in passes: `seed * 100003
    + step`, the JAX renderers' numbering, wrapped to int32 on the
    progressive route as its JAX Pallas branch wraps it."""
    s = seed * 100003 + step
    return _int32(s) if kind == "progressive" else s


class Plan(NamedTuple):
    """How a route's work divides: `n_units` units of `unit_spp` samples,
    summed in order (`unit` "samples" or "passes"); `chunk`: the hybrid
    route's wavefront chunk in samples."""
    kind: str
    unit: str
    n_units: int
    unit_spp: int
    chunk: int = 0


class Route(NamedTuple):
    """A route's tables on one device.  `film(u0, n, pix0, n_pix)` is the
    linear film SUM ((n_pix, 3) float32, on the route's device) of units
    [u0, u0 + n) of pixels [pix0, pix0 + n_pix), each unit summed in
    order as the one-device render sums it; `one_pass(step, pix0, n_pix)`
    is pass `step`'s film of a route in passes.  `fingerprint(split)`
    gives the checkpoint's (parts, arrays): the one-device render's, or
    with `split` (a sharded render's world) the sharded one's.  `log`:
    the renderer's line about the route ("" for none)."""
    plan: Plan
    film: Callable
    one_pass: Callable
    device_gamma: bool      # the one-device render tone-maps with torch
    fingerprint: Callable
    log: str


def progressive_plan(width: int, height: int, spp: int) -> Plan:
    """SimplePathTracer's route in passes of `pick_chunk` samples."""
    chunk = pick_chunk(width, height, spp)
    return Plan("progressive", "passes", spp // chunk, chunk)


def prepare(scene):
    """The scene's arrays and static scene (`build_scene_arrays`,
    `make_static_scene`)."""
    arrays = build_scene_arrays(scene)
    return arrays, make_static_scene(arrays)


def plan_route(scene, renderer: str, resumable: bool, device_type: str,
               arrays=None, ss=None) -> Plan:
    """The route `renderer` takes for `scene` on a device of this type
    and how its work divides; `resumable`: the render runs in
    checkpointed passes."""
    ro = scene.render_option
    w, h, spp = ro.width, ro.height, ro.samples_per_pixel
    if spp < 1:
        raise ValueError(f"spp must be at least 1, got {spp}")
    if arrays is None:
        arrays, ss = prepare(scene)
    if renderer == "SimplePathTracer":
        check_supported(ss)
        if resumable:
            return progressive_plan(w, h, spp)
        return Plan("dense", "samples", spp, 1)
    if renderer != "AccPathTracer":
        raise ValueError(f"no sharded route for {renderer!r}: use one of "
                         f"{', '.join(RENDERERS)} (MetropolisLightTransport "
                         "shards its chains: parallel/mlt.py)")
    n_tri = int(np.asarray(arrays.tri_valid).sum())
    acc_type = int(getattr(ro, "acc_type", 1))
    if accelerates(acc_type, n_tri):
        if takes_hybrid(n_tri, ss.ambient_type == 1, device_type):
            chunk = pick_chunk(w, h, spp,
                               budget_rays=HYBRID_BUDGET_RAYS[device_type])
            n_steps = spp // chunk
            if n_steps > 4 or (resumable and n_steps > 1):
                return Plan("hybrid", "passes", n_steps, chunk, chunk)
            return Plan("hybrid", "samples", spp, 1, chunk)
        pcall = megamesh_pass_spp(spp)
        return Plan("megamesh", "passes", spp // pcall, pcall)
    check_supported(ss)
    if resumable and spp > 1:
        pcall = checkpoint_pass_spp(spp)
        return Plan("megakernel", "passes", spp // pcall, pcall)
    return Plan("megakernel", "samples", spp, 1)


def make_route(scene, renderer: str, resumable: bool, device, seed: int,
               plan: Optional[Plan] = None, arrays=None, ss=None, cam=None,
               timer=None) -> Route:
    """The route `plan` names (by default `plan_route`'s) for `scene`,
    with its tables on `device`; `arrays`, `ss` and `cam`: the scene's
    (`prepare`, `make_camera`) when the caller has made them; `timer`:
    see `build_route`."""
    dev = torch.device(device)
    if arrays is None:
        arrays, ss = prepare(scene)
    if cam is None:
        cam = make_camera(scene.camera, device=dev)
    if plan is None:
        plan = plan_route(scene, renderer, resumable, dev.type, arrays, ss)
    ro = scene.render_option
    return build_route(
        plan, renderer, ss, cam, ro.width, ro.height, ro.samples_per_pixel,
        ro.depth, seed, arrays.env_map if ss.ambient_type == 1 else None,
        arrays.textures if ss.tri_uv else None, arrays, timer)


def build_route(plan: Plan, renderer: str, ss, cam, width: int, height: int,
                spp: int, depth: int, seed: int, env_map=None, textures=None,
                arrays=None, timer=None) -> Route:
    """The route `plan` names with its tables on the camera's device.
    `env_map`: the (He, We, 3+) map when the ambient is one; `textures`:
    the scene's textures when faces carry maps; `arrays`: the scene's
    arrays, which the mesh routes pack; `timer`: a mesh route's tables
    are built inside its `bvh-build` phase."""
    dev = cam.position.device
    staged = depth >= STAGED_MIN_DEPTH
    mesh_route = plan.kind in ("megamesh", "hybrid")
    with (timer.phase("bvh-build") if timer is not None and mesh_route
          else contextlib.nullcontext()):
        if mesh_route:
            ma = build_mesh_accel(arrays, make_mat_channels(ss))
            if textures and ma.bt.tex is None:
                textures = None   # no per-face UVs made it into the pool
            mesh = make_mesh_tables(ma.bt, dev)
            pool = (f"{len(ss.tri)} triangles ({ma.bt.n_blocks} blocks of "
                    f"{ma.bt.block})")
        if plan.kind == "hybrid":   # the wavefront reads the full images
            env = (device_textures((env_map,), dev)[0]
                   if env_map is not None else None)
            tex = device_textures(textures, dev) if textures else None
        else:                       # the kernel reads binned tables
            env = make_env_tables(env_map, dev) if env_map is not None \
                else None
            tex = make_tex_tables(textures, dev) if textures else None
    t_min = scene_epsilon(ss)

    def zeros(n_pix):
        return torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)

    # samples(sp0, n, pix0, n_pix): the film of samples [sp0, sp0 + n) at
    # the render's seed; one_pass(step, ...): the one-device route's pass
    if plan.kind == "hybrid":
        # each chunk's camera rays read the lens radius on the host
        # (`pt_cuda.camera_rays`): a copy held there is read without
        # waiting on the device
        cam = cam._replace(lens_radius=cam.lens_radius.cpu())
        log = (f"AccPathTracer: hybrid mesh route, "
               f"{'staged' if staged else 'plain'} wavefront in chunks of "
               f"{plan.chunk} spp, standalone sweep over {pool} with the "
               f"streaming compactor{', env map' if env is not None else ''}"
               f"{', textures' if tex else ''}")
        fns = {}

        def samples(sp0, n, pix0, n_pix):
            if (pix0, n_pix) not in fns:
                fns[(pix0, n_pix)] = build_render_fn(
                    ss, cam, width, height, depth, plan.chunk, tri_bvh=mesh,
                    env_map=env, textures=tex, staged=staged, pix0=pix0,
                    n_pix=n_pix, t_min=t_min)
            return fns[(pix0, n_pix)](seed, sp0, n)

        def one_pass(step, pix0, n_pix):   # chunks at the render's seed
            return samples(step * plan.unit_spp, plan.unit_spp, pix0, n_pix)
    else:
        kw = dict(bsdf=renderer == "AccPathTracer", env=env, tex=tex)
        log = ""
        if plan.kind == "megamesh":
            kw["mesh"] = mesh
            log = f"AccPathTracer: in-kernel mesh sweep over {pool}"

        def samples(sp0, n, pix0, n_pix, at=seed):
            return pt_accumulate(zeros(n_pix), ss, cam, width, height, sp0,
                                 n, depth, at, t_min, pix0=pix0,
                                 n_pix=n_pix, **kw)

        def one_pass(step, pix0, n_pix):   # samples [0, pcall)
            return samples(0, plan.unit_spp, pix0, n_pix,
                           pass_seed(seed, step, plan.kind))

    if plan.unit == "samples":
        film = samples
    else:
        def film(u0, n, pix0, n_pix):
            f = zeros(n_pix)
            for step in range(u0, u0 + n):   # each pass's film on its own
                f += one_pass(step, pix0, n_pix)
            return f

    def fingerprint(split: Optional[tuple] = None):
        # everything that changes the estimator: the scene, the camera,
        # the film, the passes and the env/texture pixels
        key = camera_key(cam)
        use_env = env_map is not None
        if split is not None:
            parts = split + (renderer, plan, ss, key, width, height, spp,
                             depth, seed)
        else:
            parts = (ss, key, width, height, spp, depth, seed, plan.unit_spp)
            if plan.kind == "megakernel":
                parts += ("megakernel", use_env)
            elif plan.kind == "megamesh":
                parts += ("megamesh",)
            else:
                lens = float(cam.lens_radius) > 0.0
                parts += ((lens, use_env) if plan.kind == "progressive"
                          else (True, staged, lens, use_env))
        return parts, (((np.asarray(env_map),) if use_env else ())
                       + tuple(textures or ()))

    # the dense one-shot routes tone-map with torch (`gamma_image`), the
    # others with numpy, as their renderers do
    device_gamma = plan.unit == "samples" and plan.kind != "hybrid"
    return Route(plan, film, one_pass, device_gamma, fingerprint, log)


def device_textures(textures, device):
    """(H, W, 3) float32 tensors of (H, W, 3+) images (the scene's textures
    or env map) on `device`."""
    return tuple(torch.as_tensor(np.ascontiguousarray(
        np.asarray(t, np.float32)[..., :3]), device=device)
        for t in textures)


def tone_map(film, spp: int, width: int, height: int,
             device_gamma: bool) -> np.ndarray:
    """The one-device route's image of a linear film SUM (a tensor on the
    route's device, or an array): (H, W, 3), row 0 = top, clipped to
    [0, 1].  The dense forms' `pt_cuda.gamma_image` runs on the film's
    device, as their renderers run it (a GPU's square root and the CPU's
    can differ in the last bit); the passes' tone map is numpy's."""
    if device_gamma:
        img = gamma_image(film, spp, width, height).cpu().numpy()
    else:
        f = film.cpu().numpy() if torch.is_tensor(film) else film
        img = np.sqrt(np.maximum(f / spp, 0.0)).reshape(height, width, 3)
    return np.clip(img[::-1], 0.0, 1.0)


# Passes of the progressive loop, and those whose host work (the add into
# the host sum, the preview and the checkpoint write) ended while the next
# pass was still on the card: read before and after a render to see how
# much of the loop's host work the device hid.
PASS_OVERLAP = {"passes": 0, "hidden": 0}
_COUNT_LOCK = threading.Lock()


class _Pass(NamedTuple):
    """A launched pass: `host`, its film on the host once `copied` has
    completed (the CUDA event after its copy; None for a film computed on
    the CPU, which is there already)."""
    host: torch.Tensor
    copied: Optional[torch.cuda.Event]


def progressive_loop(route: Route, width: int, height: int, spp: int,
                     seed: int, checkpoint_path, timer,
                     preview_every: int = 1) -> np.ndarray:
    """The one-device render of a route in passes, with Screen previews
    and checkpoint/resume (the JAX renderer's `_progressive_loop`): the
    passes' films (`route.one_pass`) are summed on the host in order, and
    they use disjoint seeds, so a resume under the route's one-device
    fingerprint reproduces the remaining passes exactly.  A preview is
    posted to the Screen every `preview_every` passes and after the last.

    The device runs one pass ahead of the host: pass k + 1 is queued, with
    its film's copy to the host, before pass k's film is added and
    previewed, so on a card that host work runs under pass k + 1's kernel
    (the copies land in page-locked memory from torch's caching host
    allocator; on the CPU a pass runs when it is queued).  The sums,
    previews and checkpoints are the serial loop's; when queueing pass
    k + 1 fails, pass k is finished (added, previewed, saved) before the
    error propagates, as the serial loop had finished it.  `PASS_OVERLAP`
    counts the passes.

    `timer` times the loop as `render` (every pass, the first included,
    with the previews and checkpoint writes between them), and inside it
    the passes as `first-pass` and `render-pass` and the previews as
    `host-preview`; inside each pass, `pass-wait` is the time the host is
    held by the device (the next pass's launch, and this pass's own on
    the first, through the arrival of this pass's film on the host), and
    `film-add` is the add of that film into the host sum.  Returns the
    image, row 0 = top."""
    w, h, pcall = width, height, route.plan.unit_spp
    film = np.zeros((w * h, 3), np.float32)
    start = 0
    fingerprint = None
    if checkpoint_path:
        parts, arrays = route.fingerprint()
        fingerprint = render_fingerprint(parts, arrays=arrays)
        loaded = load_checkpoint(checkpoint_path, fingerprint)
        if loaded is not None:
            film, spp_done = loaded
            start = spp_done // pcall
            get_server().logger.log(
                f"resumed at {spp_done}/{spp} spp from {checkpoint_path}")
    n_steps = spp // pcall

    def launch(step: int) -> _Pass:
        """Queue pass `step` and its film's copy to the host."""
        part = route.one_pass(step, 0, w * h)
        host = part.to("cpu", non_blocking=True)
        copied = None
        if part.is_cuda:
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(part.device))
        return _Pass(host, copied)

    img = nxt = None
    hidden = 0
    with timer.phase("render"):
        for step in range(start, n_steps):
            failed = None
            with timer.phase("first-pass" if step == start
                             else "render-pass"):
                with timer.phase("pass-wait"):
                    cur = nxt if step > start else launch(step)
                    try:
                        nxt = (launch(step + 1) if step + 1 < n_steps
                               else None)
                    except BaseException as e:   # re-raised below
                        nxt, failed = None, e
                    if cur.copied is not None:
                        cur.copied.synchronize()
                with timer.phase("film-add"):
                    film += cur.host.numpy()
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
            under = nxt is not None and nxt.copied is not None \
                and not nxt.copied.query()
            hidden += under
            with _COUNT_LOCK:
                PASS_OVERLAP["passes"] += 1
                PASS_OVERLAP["hidden"] += under
            if failed is not None:
                raise failed
    if n_steps > start:
        get_server().logger.log(
            f"passes: {n_steps - start}, {hidden} with their host work "
            "under the next pass")
    if img is None:   # resumed at the end: no pass ran
        img = np.sqrt(np.maximum(film / spp, 0.0)).reshape(h, w, 3)[::-1]
    # the last pass's preview is the image: done == spp
    return np.clip(img, 0.0, 1.0)
