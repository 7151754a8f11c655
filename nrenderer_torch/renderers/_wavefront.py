"""The film loops of AccPathTracer's hybrid mesh route: the staged
(compacting) wavefront and the plain one.

Counterpart of `nrenderer_tpu/renderers/_wavefront.py` (its stream mode).
Both trace the film in chunks of `chunk` samples of every pixel: lane
L = s * n_pix + pid of a chunk is pixel `pid`'s sample `sp0 + s`.  Every
random number comes from `pt_core.hash_uniform` as the path-tracing
kernel draws it: the camera ray from draws 0-3 at `seed`
(`pt_cuda.camera_rays`), bounce b from draws 4, 5 and 6 at
`bounce_seed(seed, b)` (`pt_cuda.bounce_uniforms`).  So a route that
traces the same paths as the kernel's mesh form gives its film up to
rounding, and a render split into calls over consecutive sample ranges
gives the sums of one call.

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

Tracing (`utils/timing.GLOBAL_TIMER`): both loops span each chunk as
`wavefront.chunk`; the staged loop spans each stage boundary (the bank,
the roulette's count and the pack) as `wavefront.stage`, and the host's
read of the live count inside it as `wavefront.count-wait`, the time the
host is held by the device (the mesh pipe spans its own waits as
`mesh-pipe.reach-wait` and `mesh-pipe.count-wait`).  `ROUTE_COUNTS`
counts chunks, stage packs, roulette firings and the bounces of each
form.

The functions return the linear film SUM ((n_pix, 3) float32) over the
samples asked for.  The staged film adds each ray's stage radiances lane
by lane and then the samples in order, so it equals the plain film up to
the rounding of those per-stage sums (none for the five-lobe bounce: a
path gains radiance once at most, at the light hit that ends it or from
the depth cap's ambient, so all its stage radiances but one are zero).
Built with `pix0`/`n_pix`, they trace pixels [pix0, pix0 + n_pix) only
(a band of rows, for a render split across devices): lanes number the
range's pixels, while the draws and the camera ray keep the global pixel
id, so the band is the full film's rows.

`build_render_fn` is the route's film over AccPathTracer's five-lobe
bounce (`make_bsdf_bounce`, `trace_wavefront`; the JAX renderer's
`acc_pt.py:53-161`), staged or plain.  The bounce takes one of two forms
by what the scene holds (`bounce_form`): over an untextured pool on a
card, the wavefront kernels around the mesh pipe
(`pt_cuda.wavefront_dense_hit`, the pipe, `pt_cuda.wavefront_shade`),
which update the state in place, its rows those of one buffer a chunk's
stage (`_new_state`, the stage packs); otherwise the torch ops of
`pt_cuda.bsdf_bounce_env`.  The two give the same state bit for bit on
the card.  `ROUTE_COUNTS` counts the bounces of each form."""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops.camera import CameraParams
from ..ops.intersect import StaticScene
from ..ops.mesh_cuda import MeshTables, intersect_triangles_mesh
from ..ops.pt_core import (
    bounce_seed, finish_ambient, hash_uniform, make_mat_channels,
    scene_epsilon,
)
from ..ops.pt_cuda import (
    Draws, bsdf_bounce_env, camera_rays, make_wave_tables,
    wavefront_dense_hit, wavefront_shade,
)
from ..ops.soa import V3
from ..ops.stream_compact import (
    stream_lanes_needed, stream_pack_channels, stream_unpack_channels,
)
from ..utils.timing import GLOBAL_TIMER

STAGE_BOUNDARIES = ((6, 2), (11, 4), (16, 8))  # (first bounce, 1/size)
ROULETTE_MARGIN = 0.97
ROULETTE_DRAW = 7
ROULETTE_BASE = 7000

# Chunks traced, stage packs made, stages whose roulette fired, and
# bounces run by the wavefront kernels ("fused") and by torch ops
# ("eager"): a caller resets and reads them (the renderer logs them).
ROUTE_COUNTS = {"chunks": 0, "stage_packs": 0, "roulette": 0,
                "fused_bounces": 0, "eager_bounces": 0}


def reset_route_counts() -> None:
    for key in ROUTE_COUNTS:
        ROUTE_COUNTS[key] = 0


def stage_plan(depth: int):
    """(first bounce, buffer shrink) of each stage: absolute bounce
    indices, those at or past `depth` dropped (`_wavefront.py:25-36`)."""
    return [(0, 1)] + [(b, k) for b, k in STAGE_BOUNDARIES if b < depth]


def _film_add(film: torch.Tensor, rad: torch.Tensor, c: int,
              n_pix: int) -> None:
    """Add a chunk's (3, c * n_pix) radiance into the film, sample after
    sample, as the kernel adds."""
    for k in range(c):
        film += rad[:, k * n_pix:(k + 1) * n_pix].T


def _camera_chunk(cam: CameraParams, width: int, height: int, seed: int,
                  sp0: int, c: int, pix0: int, n_pix: int):
    """(draws, o, d) of a chunk's camera rays, lane L at slot L."""
    lane = torch.arange(c * n_pix, dtype=torch.int32,
                        device=cam.position.device)
    draws = Draws(lane, n_pix, sp0, pix0, seed)
    o, d = camera_rays(cam, *draws.samples(), seed, width, height)
    return draws, o, d


def _new_state(o: V3, d: V3):
    """(o, d, thr, rad, alive) of rays starting at (o, d): throughput 1,
    radiance 0, every lane alive, the float rows those of one (12, n)
    buffer (the fused bounce writes them in place)."""
    n = d.x.shape[0]
    st = torch.empty((12, n), dtype=torch.float32, device=d.x.device)
    for k, a in enumerate((*o, *d)):
        st[k] = a
    st[6:9] = 1.0
    st[9:12] = 0.0
    rows = [V3(st[k], st[k + 1], st[k + 2]) for k in (0, 3, 6, 9)]
    return (*rows, torch.ones(n, dtype=torch.bool, device=st.device))


def trace_wavefront(bounce_fn: Callable, finish_fn: Callable, o: V3, d: V3,
                    draws: Draws, depth: int) -> V3:
    """The radiance of rays (o, d): `depth` bounces of `bounce_fn`
    (`make_bsdf_bounce`'s) drawing for `draws`, then `finish_fn(thr, rad,
    alive)`, the depth cap's term (`acc_pt.py:53-99`)."""
    o, d, thr, rad, alive = _new_state(o, d)
    for b in range(depth):
        o, d, thr, rad, alive = bounce_fn(o, d, thr, rad, alive, draws, b)
    return finish_fn(thr, rad, alive)


def build_wavefront_fn(cam: CameraParams, width: int, height: int,
                       chunk: int, trace_fn: Callable, pix0: int = 0,
                       n_pix: int = None) -> Callable:
    """The plain film loop (`_wavefront.py:251-305`):
    `trace_fn(o, d, draws) -> V3` radiance of each camera ray.
    Returns `render(seed, sp0, n_spp)`, the film SUM of samples
    [sp0, sp0 + n_spp) of pixels [pix0, pix0 + n_pix) (all by default)."""
    n_pix = width * height - pix0 if n_pix is None else n_pix

    def render(seed: int, sp0: int, n_spp: int) -> torch.Tensor:
        film = torch.zeros((n_pix, 3), dtype=torch.float32,
                           device=cam.position.device)
        for c0 in range(0, n_spp, chunk):
            c = min(chunk, n_spp - c0)
            with GLOBAL_TIMER.phase("wavefront.chunk"):
                ROUTE_COUNTS["chunks"] += 1
                draws, o, d = _camera_chunk(cam, width, height, seed,
                                            sp0 + c0, c, pix0, n_pix)
                rad = trace_fn(o, d, draws)
                _film_add(film, torch.stack(rad), c, n_pix)
        return film

    return render


def build_staged_wavefront_fn(cam: CameraParams, width: int, height: int,
                              chunk: int, bounce_fn: Callable,
                              finish_fn: Callable, depth: int,
                              peel_first: bool = False, pix0: int = 0,
                              n_pix: int = None) -> Callable:
    """The staged film loop (`_wavefront.py:39-248`, stream mode).

    `bounce_fn(o, d, thr, rad, alive, draws, b, coherent=False) -> (o, d,
    thr, rad, alive)` runs bounce b on the current buffer
    (`make_bsdf_bounce`);
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

    def roulette(alive, cap: int, draws: Draws, si: int):
        """(keep mask, 1/q or None): every live ray when they fit."""
        with GLOBAL_TIMER.phase("wavefront.count-wait"):
            n_alive = int(stream_lanes_needed(alive))
        if n_alive <= cap:
            return alive, None
        ROUTE_COUNTS["roulette"] += 1
        q = np.float32(ROULETTE_MARGIN * cap) / np.float32(n_alive)
        u = hash_uniform(*draws.samples(), ROULETTE_DRAW,
                         bounce_seed(draws.seed, ROULETTE_BASE + si))
        return alive & (u < float(q)), float(np.float32(1.0) / q)

    def trace_chunk(seed: int, sp0: int, c: int) -> torch.Tensor:
        """Launch-aligned (3, c * n_pix) radiance of one chunk."""
        n_rays = c * n_pix
        draws, o, d = _camera_chunk(cam, width, height, seed, sp0, c, pix0,
                                    n_pix)
        o, d, thr, rad, alive = _new_state(o, d)
        acc = torch.zeros((3, n_rays), dtype=torch.float32, device=o.x.device)
        chain = []   # (keep mask as float, StreamPacked) per stage pack
        if peel:
            o, d, thr, rad, alive = bounce_fn(o, d, thr, rad, alive, draws, 0,
                                              coherent=True)
        for si, (b0, shrink) in enumerate(plan):
            b1 = plan[si + 1][0] if si + 1 < len(plan) else depth
            if si == 0 and peel:
                b0 = 1
            if si > 0:
                with GLOBAL_TIMER.phase("wavefront.stage"):
                    bank(acc, rad, chain)
                    cap = max(128, (n_rays // shrink) // 128 * 128)
                    keep, inv_q = roulette(alive, cap, draws, si)
                    keep_f = keep.to(torch.float32)
                    sp_k = stream_pack_channels(
                        (*o, *d, *thr, keep_f, draws.lane), cap, mask_from=9)
                ROUTE_COUNTS["stage_packs"] += 1
                # the stage's state: the packed rows, radiance anew
                p = sp_k.packed
                if inv_q is not None:
                    p[6:9] *= inv_q
                o, d, thr = (V3(p[k], p[k + 1], p[k + 2]) for k in (0, 3, 6))
                alive = p[9] > 0.0   # slots past the count read 0: dead
                draws = draws._replace(lane=p[10].view(torch.int32))
                r = torch.zeros((3, cap), dtype=torch.float32,
                                device=p.device)
                rad = V3(r[0], r[1], r[2])
                chain.append((keep_f, sp_k))
            for b in range(b0, b1):
                o, d, thr, rad, alive = bounce_fn(o, d, thr, rad, alive,
                                                  draws, b)
        bank(acc, finish_fn(thr, rad, alive), chain)
        return acc

    def render(seed: int, sp0: int, n_spp: int) -> torch.Tensor:
        film = torch.zeros((n_pix, 3), dtype=torch.float32,
                           device=cam.position.device)
        for c0 in range(0, n_spp, chunk):
            c = min(chunk, n_spp - c0)
            with GLOBAL_TIMER.phase("wavefront.chunk"):
                ROUTE_COUNTS["chunks"] += 1
                _film_add(film, trace_chunk(seed, sp0 + c0, c), c, n_pix)
        return film

    return render


def bounce_form(tri_bvh=None, textures=None) -> str:
    """The form of the route's bounce: "fused", the wavefront kernels
    around the mesh pipe, when the pool's tables (`tri_bvh`, a
    `mesh_cuda.MeshTables`) are on a CUDA device and no textures are
    resolved; else "eager", torch ops (the CPU, a textured pool, a
    wavefront without a pipe)."""
    fused = (isinstance(tri_bvh, MeshTables) and not textures
             and tri_bvh.tris.device.type == "cuda")
    return "fused" if fused else "eager"


def make_bsdf_bounce(ss: StaticScene, t_min: float, tri_bvh=None,
                     env_map: Optional[torch.Tensor] = None, textures=None):
    """`bounce(o, d, thr, rad, alive, draws, b, coherent=False) -> (o, d,
    thr, rad, alive)`: bounce b of AccPathTracer's estimator
    (`pt_core.bsdf_bounce`) over the scene, drawing for `draws`, and with
    an env map its exact lookup added at every miss (misses keep their
    direction and throughput), as the JAX package's XLA bounce does
    (`acc_pt.py:69-93, :120-142`).  In the form `bounce_form` picks: the
    fused form writes the state in place (its float rows distinct
    contiguous tensors, as `_new_state` and the stage packs give them) and
    returns them; the eager one returns new tensors."""
    if bounce_form(tri_bvh, textures) == "fused":
        wt = make_wave_tables(ss, t_min, env_map, tri_bvh.tris.device)

        def fused(o, d, thr, rad, alive, draws, b, coherent=False):
            ROUTE_COUNTS["fused_bounces"] += 1
            cap = wavefront_dense_hit(wt, o, d, alive)
            hit = intersect_triangles_mesh(tri_bvh, o, d, t_min, cap, None,
                                           sort=not coherent)
            wavefront_shade(wt, o, d, thr, rad, alive, hit[:5], draws, b)
            return o, d, thr, rad, alive

        return fused
    mat_ch = make_mat_channels(ss)

    def eager(o, d, thr, rad, alive, draws, b, coherent=False):
        ROUTE_COUNTS["eager_bounces"] += 1
        return bsdf_bounce_env(ss, mat_ch, env_map, o, d, thr, rad, alive,
                               *draws.uniforms(b), t_min=t_min,
                               tri_bvh=tri_bvh, textures=textures,
                               coherent=coherent)

    return eager


def build_render_fn(ss: StaticScene, cam, width: int, height: int,
                    depth: int, chunk: int, tri_bvh=None, env_map=None,
                    textures=None, staged: bool = False, pix0: int = 0,
                    n_pix: int = None, t_min: float = None):
    """`render(seed, sp0, n_spp)`: the linear film SUM ((W*H, 3)) of
    samples [sp0, sp0 + n_spp) (of pixels [pix0, pix0 + n_pix) only, the
    film (n_pix, 3), when they are given), by the staged wavefront
    (`staged`; the camera bounce peeled off as the coherent variant when
    there is a mesh pipe) or the plain one (`acc_pt.py:102-161`).
    `tri_bvh`: the mesh tables (`mesh_cuda.MeshTables`) whose pool runs
    the mesh pipe; `env_map`: an (He, We, 3) tensor; `textures`: (H, W,
    3) tensors; `t_min`: the scene's epsilon, when the caller has it."""
    if t_min is None:
        t_min = scene_epsilon(ss)
    bounce = make_bsdf_bounce(ss, t_min, tri_bvh, env_map, textures)
    finish = lambda thr, rad, alive: finish_ambient(ss, thr, rad, alive)
    if staged:
        return build_staged_wavefront_fn(
            cam, width, height, chunk, bounce, finish, depth,
            peel_first=tri_bvh is not None, pix0=pix0, n_pix=n_pix)
    return build_wavefront_fn(
        cam, width, height, chunk,
        lambda o, d, draws: trace_wavefront(bounce, finish, o, d, draws,
                                            depth),
        pix0=pix0, n_pix=n_pix)
