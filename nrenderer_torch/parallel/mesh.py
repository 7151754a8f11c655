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

A route's unit is what its one-device render sums in order (samples, or
passes of samples: `renderers/routes.py`, which plans and builds every
route for the one-device renderers and for the ranks alike).  The
launching process plans the route (`routes.plan_route`) and hands its
plan to the ranks, which build it (`routes.make_route`) whatever their
own rules would pick.

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

from ..renderers.routes import Plan, Route, make_route, plan_route, tone_map
from .group import (
    DEFAULT_TIMEOUT_S, Rank, all_reduce_sum, barrier, broadcast_value,
    check_devices, gather_rows, launch,
)

SHARDS = ("samples", "pixels")
MAX_PASSES = 16   # the resumable route's most passes (JAX's)


class ShardedRender(NamedTuple):
    """A sharded render's result, on the launching process."""
    image: Optional[np.ndarray]  # (H, W, 3) gamma'd, row 0 = top, in [0, 1]
    film: np.ndarray             # (W*H, 3) linear SUM (row 0 = bottom)
    spp_done: int
    route: str
    launches: dict               # kernel launches, summed over the ranks
    seconds: dict                # rank 0's render, wait, collective, total
    backend: str                 # the process group's backend


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
    passes = pass_count(plan, shard, rank.world)
    upp = plan.n_units // passes
    pass_spp = spp // passes
    film = np.zeros((w * h, 3), np.float32)
    start, fingerprint = 0, None
    if rank.rank == 0 and checkpoint_path:
        parts, arrays = route.fingerprint(
            ("multichip", shard, rank.world, rank.devices, passes))
        fingerprint = render_fingerprint(parts, arrays=arrays)
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
