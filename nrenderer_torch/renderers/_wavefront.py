"""The film loops of AccPathTracer's hybrid mesh route: the staged
(compacting) wavefront and the plain one.

Counterpart of `nrenderer_tpu/renderers/_wavefront.py` (its stream mode).
Both trace the film in chunks of `chunk` samples of every pixel: lane
L = s * n_pix + pid of a chunk is pixel `pid`'s sample `sp0 + s`.  Every
random number comes from `pt_core.hash_uniform` as the path-tracing
kernel draws it: the camera ray from draws 0-3 at `seed`
(`pt_cuda.camera_rays`), bounce b from draws 4, 5 and 6 at
`bounce_seed(seed, b)` (`bounce_uniforms`).  So a route that traces the
same paths as the kernel's mesh form gives its film up to rounding, and a
render split into calls over consecutive sample ranges gives the sums of
one call.

The staged wavefront packs the whole ray state into smaller buffers as
paths die: at the bounces of `stage_plan` (6, 11 and 16) the live rays
move into buffers of n/2, n/4 and n/8 slots through the streaming pack
(B3a), each ray carrying its lane id as an int32 word so that its draws
stay its own.  Radiance is banked BEFORE each pack, on the buffer the rays
still occupy, by unpacking it through the chain of packs (B3b) back to the
launch lanes; a ray the pack drops loses nothing already banked.  A stage
whose live rays overflow its buffer keeps each with probability
q = 0.97 * cap / n_alive and reweights the survivors by 1/q (the JAX
package's rule for a dense pack, `_wavefront.py:194-200`); otherwise
nothing is dropped.  The roulette draws `hash_uniform(pid, sample,
ROULETTE_DRAW, bounce_seed(seed, ROULETTE_BASE + stage))`: draw 7 is one
the kernel never uses, and 7000 + stage mirrors JAX's
`fold_in(k_path, 7000 + si)`.  Each stage boundary reads one count on the
host.

The functions return the linear film SUM ((n_pix, 3) float32) over the
samples asked for.  The staged film adds each ray's stage radiances lane
by lane and then the samples in order, so it equals the plain film up to
the rounding of those per-stage sums.  Built with `pix0`/`n_pix`, they
trace pixels [pix0, pix0 + n_pix) only (a band of rows, for a render
split across devices): lanes number the range's pixels, while the draws
and the camera ray keep the global pixel id, so the band is the full
film's rows."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ops.camera import CameraParams
from ..ops.pt_core import bounce_seed, hash_uniform
from ..ops.pt_cuda import camera_rays
from ..ops.soa import V3
from ..ops.stream_compact import (
    stream_lanes_needed, stream_pack_channels, stream_unpack_channels,
)

STAGE_BOUNDARIES = ((6, 2), (11, 4), (16, 8))  # (first bounce, 1/size)
ROULETTE_MARGIN = 0.97
ROULETTE_DRAW = 7
ROULETTE_BASE = 7000

# Stage packs made and stages whose roulette fired: a caller resets and
# reads them (the renderer logs them).
ROUTE_COUNTS = {"stage_packs": 0, "roulette": 0}


def reset_route_counts() -> None:
    for key in ROUTE_COUNTS:
        ROUTE_COUNTS[key] = 0


def stage_plan(depth: int):
    """(first bounce, buffer shrink) of each stage: absolute bounce
    indices, those at or past `depth` dropped (`_wavefront.py:25-36`)."""
    return [(0, 1)] + [(b, k) for b, k in STAGE_BOUNDARIES if b < depth]


def lane_samples(lane: torch.Tensor, n_pix: int, sp0: int, pix0: int = 0):
    """(global pixel id, sample index) int64 of chunk lanes over pixels
    [pix0, pix0 + n_pix)."""
    lane = lane.to(torch.int64)
    return pix0 + lane % n_pix, sp0 + lane // n_pix


def bounce_uniforms(pid: torch.Tensor, sp: torch.Tensor, seed: int, b: int):
    """Bounce b's three uniforms (draws 4, 5, 6), as the kernel draws
    them."""
    bs = bounce_seed(seed, b)
    return tuple(hash_uniform(pid, sp, k, bs) for k in (4, 5, 6))


def _film_add(film: torch.Tensor, rad: torch.Tensor, c: int,
              n_pix: int) -> None:
    """Add a chunk's (3, c * n_pix) radiance into the film, sample after
    sample, as the kernel adds."""
    for k in range(c):
        film += rad[:, k * n_pix:(k + 1) * n_pix].T


def _camera_chunk(cam: CameraParams, width: int, height: int, seed: int,
                  sp0: int, c: int, pix0: int, n_pix: int):
    lane = torch.arange(c * n_pix, dtype=torch.int32,
                        device=cam.position.device)
    pid, sp = lane_samples(lane, n_pix, sp0, pix0)
    o, d = camera_rays(cam, pid, sp, seed, width, height)
    return lane, pid, sp, o, d


def build_wavefront_fn(cam: CameraParams, width: int, height: int,
                       chunk: int, trace_fn: Callable, pix0: int = 0,
                       n_pix: int = None) -> Callable:
    """The plain film loop (`_wavefront.py:251-305`):
    `trace_fn(o, d, pid, sp, seed) -> V3` radiance of each camera ray.
    Returns `render(seed, sp0, n_spp)`, the film SUM of samples
    [sp0, sp0 + n_spp) of pixels [pix0, pix0 + n_pix) (all by default)."""
    n_pix = width * height - pix0 if n_pix is None else n_pix

    def render(seed: int, sp0: int, n_spp: int) -> torch.Tensor:
        film = torch.zeros((n_pix, 3), dtype=torch.float32,
                           device=cam.position.device)
        for c0 in range(0, n_spp, chunk):
            c = min(chunk, n_spp - c0)
            _, pid, sp, o, d = _camera_chunk(cam, width, height, seed,
                                             sp0 + c0, c, pix0, n_pix)
            rad = trace_fn(o, d, pid, sp, seed)
            _film_add(film, torch.stack(rad), c, n_pix)
        return film

    return render


def build_staged_wavefront_fn(cam: CameraParams, width: int, height: int,
                              chunk: int, bounce_fn: Callable,
                              finish_fn: Callable, depth: int,
                              peel_first: bool = False, pix0: int = 0,
                              n_pix: int = None) -> Callable:
    """The staged film loop (`_wavefront.py:39-248`, stream mode).

    `bounce_fn(o, d, thr, rad, alive, u1, u2, u3, coherent=False) -> (o, d,
    thr, rad, alive)` runs one bounce on the current buffer;
    `finish_fn(thr, rad, alive) -> V3` adds the depth cap's ambient term.
    `peel_first`: bounce 0 runs on its own as the coherent variant (the
    mesh pipe skips its sort for pixel-ordered camera rays; the draws, and
    so the film, are unchanged).  Returns `render(seed, sp0, n_spp)`, the
    film SUM of samples [sp0, sp0 + n_spp) of pixels [pix0, pix0 + n_pix)
    (all by default)."""
    n_pix = width * height - pix0 if n_pix is None else n_pix
    plan = stage_plan(depth)
    peel = peel_first and depth > 1

    def bank(acc: torch.Tensor, rad: V3, chain) -> None:
        r = (rad.x, rad.y, rad.z)
        for keep_f, sp_k in reversed(chain):
            r = stream_unpack_channels(keep_f, r, (0.0, 0.0, 0.0), sp_k)
        for k in range(3):
            acc[k] += r[k]

    def roulette(alive, cap: int, pid, sp, seed: int, si: int):
        """(keep mask, 1/q or None): every live ray when they fit."""
        n_alive = int(stream_lanes_needed(alive))
        if n_alive <= cap:
            return alive, None
        ROUTE_COUNTS["roulette"] += 1
        q = np.float32(ROULETTE_MARGIN * cap) / np.float32(n_alive)
        u = hash_uniform(pid, sp, ROULETTE_DRAW,
                         bounce_seed(seed, ROULETTE_BASE + si))
        return alive & (u < float(q)), float(np.float32(1.0) / q)

    def trace_chunk(seed: int, sp0: int, c: int) -> torch.Tensor:
        """Launch-aligned (3, c * n_pix) radiance of one chunk."""
        n_rays = c * n_pix
        lane, pid, sp, o, d = _camera_chunk(cam, width, height, seed, sp0,
                                            c, pix0, n_pix)
        ones = torch.ones_like(o.x)
        zeros = torch.zeros_like(o.x)
        thr = V3(ones, ones, ones)
        rad = V3(zeros, zeros, zeros)
        alive = torch.ones_like(o.x, dtype=torch.bool)
        acc = torch.zeros((3, n_rays), dtype=torch.float32, device=o.x.device)
        chain = []   # (keep mask as float, StreamPacked) per stage pack
        if peel:
            o, d, thr, rad, alive = bounce_fn(
                o, d, thr, rad, alive, *bounce_uniforms(pid, sp, seed, 0),
                coherent=True)
        for si, (b0, shrink) in enumerate(plan):
            b1 = plan[si + 1][0] if si + 1 < len(plan) else depth
            if si == 0 and peel:
                b0 = 1
            if si > 0:
                bank(acc, rad, chain)
                cap = max(128, (n_rays // shrink) // 128 * 128)
                keep, inv_q = roulette(alive, cap, pid, sp, seed, si)
                keep_f = keep.to(torch.float32)
                sp_k = stream_pack_channels(
                    (o.x, o.y, o.z, d.x, d.y, d.z, thr.x, thr.y, thr.z,
                     keep_f, lane), cap, mask_from=9)
                ROUTE_COUNTS["stage_packs"] += 1
                p = sp_k.packed
                o, d = V3(p[0], p[1], p[2]), V3(p[3], p[4], p[5])
                thr = V3(p[6], p[7], p[8]) if inv_q is None else V3(
                    p[6] * inv_q, p[7] * inv_q, p[8] * inv_q)
                alive = p[9] > 0.0   # slots past the count read 0: dead
                lane = p[10].view(torch.int32)
                pid, sp = lane_samples(lane, n_pix, sp0, pix0)
                zc = torch.zeros_like(p[9])
                rad = V3(zc, zc, zc)
                chain.append((keep_f, sp_k))
            for b in range(b0, b1):
                o, d, thr, rad, alive = bounce_fn(
                    o, d, thr, rad, alive,
                    *bounce_uniforms(pid, sp, seed, b))
        bank(acc, finish_fn(thr, rad, alive), chain)
        return acc

    def render(seed: int, sp0: int, n_spp: int) -> torch.Tensor:
        film = torch.zeros((n_pix, 3), dtype=torch.float32,
                           device=cam.position.device)
        for c0 in range(0, n_spp, chunk):
            c = min(chunk, n_spp - c0)
            _film_add(film, trace_chunk(seed, sp0 + c0, c), c, n_pix)
        return film

    return render
