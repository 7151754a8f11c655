"""Path-traced renders split across devices: sample and pixel-band sharding.

Counterpart of `nrenderer_tpu/parallel/mesh.py`.  The JAX module shards a
render over a `jax.sharding.Mesh` with `shard_map`; the port runs one rank
per device (`parallel/group.py`) and every rank runs the one-device route
the renderer would pick, on its share of the work:

- **Sample sharding** (`shard="samples"`): rank r renders its slice of
  the route's units, the film of all pixels, and one `all_reduce(SUM)` of
  the (W*H, 3) float32 linear film follows (JAX's film `psum`,
  `_build_sharded_film :87`).
- **Pixel bands** (`shard="pixels"`): rank r renders rows
  [r*H/N, (r+1)*H/N) at the full budget, and the bands are gathered to
  rank 0 (JAX's `out_specs=P(axis)`, `_build_sharded_film_pixels :133`).
  No reduction.

A route's unit is what its one-device render sums in order: samples for
the dense kernel forms (SimplePathTracer's one-shot render, AccPathTracer's
megakernel) and for the hybrid mesh route; passes of `pcall` samples at
seed `seed * 100003 + step` for the megamesh route, the checkpointed
megakernel and SimplePathTracer's progressive route; chunks of samples for
the hybrid route when it renders in passes.  AccPathTracer picks its route
by the one-device rules (`renderers/acc_pt.py`), in place of JAX's
`n_tri > 64` switch; the launching process plans the route and hands its
plan to the ranks, which render it whatever their own rules would pick.

Every random number comes from the counter-based hash keyed by the global
pixel, sample and seed, so a rank that renders a global range draws what a
one-device render draws for it (JAX gives each device its own `jax.random`
stream instead, so its sharded image depends on the device count):

- a world of one is the one-device render, bit for bit;
- a world of N is the one-device render up to the order of the final sum;
- a pixel band is the one-device film's rows, bit for bit.

`render_multichip_resumable` (`:270`) renders in host-chunked passes: after
each pass rank 0 adds the reduced or gathered pass film on the host, saves
the checkpoint and posts a preview; a resume re-runs from the first missing
pass and ends bit-identical to a straight run."""
from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .group import (
    DEFAULT_TIMEOUT_S, Rank, all_reduce_sum, barrier, broadcast_value,
    check_devices, gather_rows, launch,
)

RENDERERS = ("SimplePathTracer", "AccPathTracer")
SHARDS = ("samples", "pixels")
MAX_PASSES = 16   # the resumable route's most passes (JAX's)


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
    """A one-device route on one rank: `film(u0, n, pix0, n_pix)` is the
    linear film SUM ((n_pix, 3) float32, on the rank's device) of units
    [u0, u0 + n) of pixels [pix0, pix0 + n_pix), each unit summed in
    order as the one-device render sums it."""
    plan: Plan
    film: Callable
    device_gamma: bool      # the one-device render tone-maps with torch
    fingerprint: tuple
    fingerprint_arrays: tuple


class ShardedRender(NamedTuple):
    """A sharded render's result, on the launching process."""
    image: Optional[np.ndarray]  # (H, W, 3) gamma'd, row 0 = top, in [0, 1]
    film: np.ndarray             # (W*H, 3) linear SUM (row 0 = bottom)
    spp_done: int
    route: str
    launches: dict               # kernel launches, summed over the ranks
    seconds: dict                # rank 0's render, wait, collective, total
    backend: str                 # the process group's backend


def _prep(scene):
    from ..ops.intersect import make_static_scene
    from ..scene.arrays import build_scene_arrays
    arrays = build_scene_arrays(scene)
    return arrays, make_static_scene(arrays)


def plan_route(scene, renderer: str, resumable: bool, device_type: str,
               arrays=None, ss=None) -> Plan:
    """The route `renderer` takes for `scene` on one device and how its
    work divides; `resumable`: the render runs in checkpointed passes."""
    from ..ops.pt_cuda import check_supported
    from ..renderers import acc_pt
    from ..renderers.simple_pt import pick_chunk
    ro = scene.render_option
    w, h, spp = ro.width, ro.height, ro.samples_per_pixel
    if spp < 1:
        raise ValueError(f"spp must be at least 1, got {spp}")
    if arrays is None:
        arrays, ss = _prep(scene)
    if renderer == "SimplePathTracer":
        check_supported(ss)
        if resumable:
            chunk = pick_chunk(w, h, spp)
            return Plan("progressive", "passes", spp // chunk, chunk)
        return Plan("dense", "samples", spp, 1)
    if renderer != "AccPathTracer":
        raise ValueError(f"no sharded route for {renderer!r}: use one of "
                         f"{', '.join(RENDERERS)} (MetropolisLightTransport "
                         "shards its chains: parallel/mlt.py)")
    n_tri = int(np.asarray(arrays.tri_valid).sum())
    acc_type = int(getattr(ro, "acc_type", 1))
    if acc_pt.accelerates(acc_type, n_tri):
        if acc_pt.takes_hybrid(n_tri, ss.ambient_type == 1, device_type):
            chunk = pick_chunk(w, h, spp, budget_rays=acc_pt.
                               HYBRID_BUDGET_RAYS[device_type])
            n_steps = spp // chunk
            if n_steps > 4 or (resumable and n_steps > 1):
                return Plan("hybrid", "passes", n_steps, chunk, chunk)
            return Plan("hybrid", "samples", spp, 1, chunk)
        pcall = acc_pt.megamesh_pass_spp(spp)
        return Plan("megamesh", "passes", spp // pcall, pcall)
    check_supported(ss)
    if resumable and spp > 1:
        pcall = acc_pt.checkpoint_pass_spp(spp)
        return Plan("megakernel", "passes", spp // pcall, pcall)
    return Plan("megakernel", "samples", spp, 1)


def make_route(scene, renderer: str, resumable: bool, device,
               seed: int, plan: Optional[Plan] = None) -> Route:
    """The route `plan` names (by default `plan_route`'s), with its tables
    on `device`."""
    from ..ops.bvh import build_mesh_accel
    from ..ops.camera import make_camera
    from ..ops.mesh_cuda import make_mesh_tables
    from ..ops.pt_core import make_mat_channels, scene_epsilon
    from ..ops.pt_cuda import (
        _int32, make_env_tables, make_tex_tables, pt_accumulate,
    )
    from ..renderers.acc_pt import (
        STAGED_MIN_DEPTH, _device_textures, build_render_fn,
    )
    from ..server.checkpoint import camera_key
    dev = torch.device(device)
    arrays, ss = _prep(scene)
    if plan is None:
        plan = plan_route(scene, renderer, resumable, dev.type, arrays, ss)
    ro = scene.render_option
    w, h, depth = ro.width, ro.height, ro.depth
    cam = make_camera(scene.camera, device=dev)
    t_min = scene_epsilon(ss)
    env_map = arrays.env_map if ss.ambient_type == 1 else None
    textures = arrays.textures if ss.tri_uv else None
    bsdf = renderer == "AccPathTracer"
    fp = (renderer, plan, ss, camera_key(cam), w, h, ro.samples_per_pixel,
          depth, seed)
    fp_arrays = (((np.asarray(env_map),) if env_map is not None else ())
                 + tuple(textures or ()))

    def zeros(n_pix):
        return torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)

    if plan.kind in ("megamesh", "hybrid"):
        ma = build_mesh_accel(arrays, make_mat_channels(ss))
        if textures and ma.bt.tex is None:
            textures = None   # no per-face UVs made it into the pool
        mesh = make_mesh_tables(ma.bt, dev)
    # samples(sp0, n, pix0, n_pix): the film of samples [sp0, sp0 + n) at
    # the render's seed; one_pass(step, ...): the one-device route's pass
    if plan.kind == "hybrid":
        env = (_device_textures((env_map,), dev)[0]
               if env_map is not None else None)
        tex = _device_textures(textures, dev) if textures else None
        fns = {}

        def samples(sp0, n, pix0, n_pix):
            if (pix0, n_pix) not in fns:
                fns[(pix0, n_pix)] = build_render_fn(
                    ss, cam, w, h, depth, plan.chunk, tri_bvh=mesh,
                    env_map=env, textures=tex,
                    staged=depth >= STAGED_MIN_DEPTH, pix0=pix0,
                    n_pix=n_pix)
            return fns[(pix0, n_pix)](seed, sp0, n)

        def one_pass(step, pix0, n_pix):   # chunks at the render's seed
            return samples(step * plan.unit_spp, plan.unit_spp, pix0, n_pix)
    else:
        kw = dict(bsdf=bsdf,
                  env=make_env_tables(env_map, dev)
                  if env_map is not None else None,
                  tex=make_tex_tables(textures, dev) if textures else None)
        if plan.kind == "megamesh":
            kw["mesh"] = mesh

        def samples(sp0, n, pix0, n_pix, pass_seed=seed):
            return pt_accumulate(zeros(n_pix), ss, cam, w, h, sp0, n, depth,
                                 pass_seed, t_min, pix0=pix0, n_pix=n_pix,
                                 **kw)

        def one_pass(step, pix0, n_pix):
            # samples [0, pcall) at seed seed * 100003 + step
            pass_seed = seed * 100003 + step
            return samples(0, plan.unit_spp, pix0, n_pix,
                           _int32(pass_seed) if plan.kind == "progressive"
                           else pass_seed)

    if plan.unit == "samples":
        film = samples
    else:
        def film(u0, n, pix0, n_pix):
            f = zeros(n_pix)
            for step in range(u0, u0 + n):   # each pass's film on its own
                f += one_pass(step, pix0, n_pix)
            return f
    # the dense one-shot routes tone-map with torch (`gamma_image`), the
    # others with numpy, as their renderers do
    device_gamma = plan.unit == "samples" and plan.kind != "hybrid"
    return Route(plan, film, device_gamma, fp, fp_arrays)


def tone_map(film, spp: int, width: int, height: int,
             device_gamma: bool) -> np.ndarray:
    """The one-device route's image of a linear film SUM (a tensor on the
    rank's device, or an array): (H, W, 3), row 0 = top, clipped to
    [0, 1].  The dense forms' `pt_cuda.gamma_image` runs on the film's
    device, as their renderers run it (a GPU's square root and the CPU's
    can differ in the last bit); the passes' tone map is numpy's."""
    if device_gamma:
        from ..ops.pt_cuda import gamma_image
        img = gamma_image(film, spp, width, height).cpu().numpy()
    else:
        f = film.cpu().numpy() if torch.is_tensor(film) else film
        img = np.sqrt(np.maximum(f / spp, 0.0)).reshape(height, width, 3)
    return np.clip(img[::-1], 0.0, 1.0)


def _launch_counts() -> dict:
    from ..ops import mesh_cuda, mesh_mxu, pt_cuda, stream_compact
    out = {}
    for mod in (pt_cuda, mesh_cuda, mesh_mxu, stream_compact):
        out.update(mod.KERNEL_LAUNCHES)
    return out


def reset_launch_counts() -> None:
    """Zero the launch counters of every kernel wrapper in this process."""
    from ..ops import mesh_cuda, mesh_mxu, pt_cuda, stream_compact
    for mod in (pt_cuda, mesh_cuda, mesh_mxu, stream_compact):
        mod.reset_launch_counts()


def summed_launches(rank: Rank) -> Optional[dict]:
    """This process's kernel launches summed over the ranks, on rank 0."""
    mine = _launch_counts()
    if rank.world == 1:
        return mine
    every = [None] * rank.world if rank.rank == 0 else None
    dist.gather_object(mine, every, dst=0)
    if every is None:
        return None
    return {k: sum(c.get(k, 0) for c in every) for k in mine}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _band(rank: Rank, width: int, height: int):
    rows = height // rank.world
    return rank.rank * rows * width, rows * width


def _sharded_pass(rank: Rank, route: Route, shard: str, u0: int, n: int,
                  width: int, height: int, seconds: dict):
    """Units [u0, u0 + n) of the whole film, split over the ranks; the
    film ((W*H, 3) on the rank's device) on rank 0, None elsewhere.
    `seconds` gains rank 0's render, its wait for the slowest rank and
    the collective."""
    t0 = time.perf_counter()
    if shard == "samples":
        share = n // rank.world
        film = route.film(u0 + rank.rank * share, share, 0, width * height)
    else:
        film = route.film(u0, n, *_band(rank, width, height))
    _sync(rank.device)
    t1 = time.perf_counter()
    barrier(rank)
    t2 = time.perf_counter()
    if shard == "samples":
        film = all_reduce_sum(film, rank)
    else:
        film = gather_rows(film, rank)
    _sync(rank.device)
    for key, dt in (("render", t1 - t0), ("wait", t2 - t1),
                    ("collective", time.perf_counter() - t2)):
        seconds[key] = seconds.get(key, 0.0) + dt
    return film if rank.rank == 0 else None


def _render_rank(rank: Rank, scene, renderer: str, shard: str, seed: int,
                 plan: Optional[Plan] = None):
    """A one-shot sharded render on one rank (see the module doc), on the
    launching process's `plan`."""
    t0 = time.perf_counter()
    reset_launch_counts()
    route = make_route(scene, renderer, False, rank.device, seed, plan)
    ro = scene.render_option
    seconds = {}
    film = _sharded_pass(rank, route, shard, 0, route.plan.n_units,
                         ro.width, ro.height, seconds)
    launches = summed_launches(rank)
    if rank.rank != 0:
        return None
    spp = ro.samples_per_pixel
    img = tone_map(film, spp, ro.width, ro.height, route.device_gamma)
    film = film.cpu().numpy()
    seconds["total"] = time.perf_counter() - t0
    return ShardedRender(img, film, spp, route.plan.kind, launches, seconds,
                         rank.backend)


def check_split(plan: Plan, shard: str, world: int, height: int) -> None:
    """Refuse a split the route cannot take evenly (JAX asserts it,
    `:93`, `:146`)."""
    if shard not in SHARDS:
        raise ValueError(f"unknown shard mode {shard!r}: use one of "
                         f"{', '.join(SHARDS)}")
    if shard == "pixels" and height % world:
        raise ValueError(f"--shard pixels needs the height divisible by the "
                         f"device count ({height} % {world} != 0)")
    if shard == "samples" and plan.n_units % world:
        what = ("spp" if plan.unit == "samples" else
                f"the pass count ({plan.n_units} passes of "
                f"{plan.unit_spp} spp)")
        raise ValueError(
            f"the {plan.kind} route shards {plan.unit}: {what} must be a "
            f"multiple of the device count {world}")


def render_sharded(scene, devices: Sequence, renderer: str =
                   "SimplePathTracer", shard: str = "samples",
                   seed: int = 0, timeout: float = DEFAULT_TIMEOUT_S,
                   threads: Optional[int] = None) -> ShardedRender:
    """Render `scene` (its render option's size, spp and depth) with
    `renderer` split over one rank per entry of `devices`, by samples or
    by pixel bands."""
    devs = check_devices(devices)
    plan = plan_route(scene, renderer, False, devs[0].type)
    check_split(plan, shard, len(devs), scene.render_option.height)
    return launch(_render_rank, devs, scene, renderer, shard, seed, plan,
                  timeout=timeout, threads=threads)


def render_multichip(scene, devices: Sequence, seed: int = 0,
                     shard: str = "samples", **launch_kw) -> ShardedRender:
    """Sample- (or pixel-) sharded SimplePathTracer render (JAX's
    `render_multichip`, `build_sharded_render_pixels`)."""
    return render_sharded(scene, devices, "SimplePathTracer", shard, seed,
                          **launch_kw)


def render_multichip_acc(scene, devices: Sequence, seed: int = 0,
                         shard: str = "samples",
                         **launch_kw) -> ShardedRender:
    """Sample- (or pixel-) sharded AccPathTracer render on the route the
    one-device renderer picks (JAX's `render_multichip_acc`,
    `build_sharded_render_acc_pixels`)."""
    return render_sharded(scene, devices, "AccPathTracer", shard, seed,
                          **launch_kw)


def pass_count(plan: Plan, shard: str, world: int) -> int:
    """The resumable route's passes (`:295-300`): at most MAX_PASSES, a
    divisor of the units each rank renders."""
    units = plan.n_units // world if shard == "samples" else plan.n_units
    p = min(MAX_PASSES, units)
    while units % p:
        p -= 1
    return p


def _resumable_rank(rank: Rank, scene, renderer: str, shard: str, seed: int,
                    checkpoint_path: Optional[str], pass_limit: Optional[int],
                    plan: Plan):
    """The resumable sharded render on one rank (see
    `render_multichip_resumable`), on the launching process's `plan`."""
    from ..server.checkpoint import (
        load_checkpoint, render_fingerprint, save_checkpoint)
    t0 = time.perf_counter()
    reset_launch_counts()
    route = make_route(scene, renderer, True, rank.device, seed, plan)
    ro = scene.render_option
    w, h, spp = ro.width, ro.height, ro.samples_per_pixel
    plan = route.plan
    passes = pass_count(plan, shard, rank.world)
    upp = plan.n_units // passes
    pass_spp = spp // passes
    film = np.zeros((w * h, 3), np.float32)
    start, fingerprint = 0, None
    if rank.rank == 0 and checkpoint_path:
        fingerprint = render_fingerprint(
            ("multichip", shard, rank.world, rank.devices, passes)
            + route.fingerprint, arrays=route.fingerprint_arrays)
        loaded = load_checkpoint(checkpoint_path, fingerprint)
        if loaded is not None:
            from ..server.registry import get_server
            film, spp_done = loaded
            start = spp_done // pass_spp
            get_server().logger.log(
                f"multichip resume at {spp_done}/{spp} spp from "
                f"{checkpoint_path}")
    start = broadcast_value(start, rank)
    stop = passes if pass_limit is None else min(passes,
                                                 start + pass_limit)
    seconds = {}
    for p in range(start, stop):
        part = _sharded_pass(rank, route, shard, p * upp, upp, w, h,
                             seconds)
        if rank.rank != 0:
            continue
        film += part.cpu().numpy()
        done = (p + 1) * pass_spp
        if checkpoint_path:
            save_checkpoint(checkpoint_path, film, done, w, h, seed,
                            fingerprint)
        rank.post("preview", done, tone_map(film, done, w, h, False))
    launches = summed_launches(rank)
    if rank.rank != 0:
        return None
    done = stop * pass_spp
    img = (tone_map(film, spp, w, h, False) if stop == passes else None)
    seconds["total"] = time.perf_counter() - t0
    return ShardedRender(img, film, done, plan.kind, launches, seconds,
                         rank.backend)


def render_multichip_resumable(
        scene, devices: Sequence, renderer: str = "SimplePathTracer",
        shard: str = "samples", seed: int = 0,
        checkpoint_path: Optional[str] = None, screen=None,
        on_preview: Optional[Callable] = None,
        pass_limit: Optional[int] = None, timeout: float = DEFAULT_TIMEOUT_S,
        threads: Optional[int] = None) -> ShardedRender:
    """Host-chunked sharded render with checkpoint/resume and previews
    (`:270`): the route's units split into equal passes (at most
    MAX_PASSES); after each, rank 0 adds the pass film on the host,
    saves it to `checkpoint_path` and posts a gamma'd preview, which this
    process shows on `screen` (a `Screen`) and hands to
    `on_preview(spp_done, image)`.  A render whose checkpoint matches
    resumes at its first missing pass; the fingerprint holds the world
    size, the shard mode and the device list.  `pass_limit`: stop after
    that many passes of this call (a render taken in slices); the result's
    image is then None."""
    devs = check_devices(devices)
    plan = plan_route(scene, renderer, True, devs[0].type)
    check_split(plan, shard, len(devs), scene.render_option.height)

    def on_message(rank, kind, spp_done, img):
        if screen is not None:
            h, w = img.shape[:2]
            screen.set(np.concatenate(
                [img, np.ones((h, w, 1), np.float32)], axis=2), w, h)
        if on_preview is not None:
            on_preview(spp_done, img)

    return launch(_resumable_rank, devs, scene, renderer, shard, seed,
                  checkpoint_path, pass_limit, plan, timeout=timeout,
                  threads=threads, on_message=on_message)
