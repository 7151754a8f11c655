"""The reference of the large-mesh configuration under the contract of
`reference/__init__.py`: the configuration's `.scn` file with its OBJ
files rendered as AccPathTracer's hybrid mesh route renders them, for the
check that decides `correct`.

It reads the files as `reference.mesh` does and reuses its OBJ reader,
BVH order, blocks of 128, bounce (`closest_hit`'s analytic primitives,
`scatter`) and blocked-sweep arithmetic (`_block_hits`); `load`, `counts`
and `table_floats` are `mesh`'s.  What it adds is the hybrid route's
sampling:

- **Chunks**: the route traces the film in chunks of the largest divisor
  of the spp whose rays fit its budget (2^24 rays on a card, 2^21 on the
  CPU), every chunk at the render's seed; with at most 4 chunks it adds
  every sample of every chunk into one film in sample order, with more
  it adds each chunk's film, summed from zero, in chunk order
  (`mesh.passes(route="hybrid")`).
- **Each path's radiance is one running sum**, then its sample joins
  the film.  At depth 12 and more the route packs its rays into smaller
  buffers at bounces 6, 11 and 16 (those below the depth) and banks each
  ray's radiance before each pack, adding the stage radiances in stage
  order from zero.  That rounds as the running sum does: a path of the
  five-lobe estimator gains radiance once at most (at the light hit that
  ends it, or from the depth cap's ambient), so all its stage radiances
  but one are zero.
- The film's mean, square root, clip and 8-bit quantisation are the
  route's host tone map (numpy float32) and the PNG writer's.

Departures:

- The stage roulette is not modelled.  The route keeps a stage's live
  rays with a probability and reweights them only when they overflow
  the stage's buffer (n/2, n/4, n/8 of the chunk's rays), which needs the
  whole chunk's count; a render in which it fires gives another film and
  fails the check.
- The route's mesh pipe culls rays against the pool's box and sweeps
  blocks near to far along each ray's octant; the reference sweeps the
  blocks in natural order, which differs only where two triangles give
  the same distance or a hit lies on a block's box face within rounding.
- The sweep is batched (`sweep`): the (ray, block) pairs whose box a ray
  can enter with its starting cap are tested together, and each ray then
  takes its pairs in natural block order against its running best, as
  the one-block-at-a-time sweep does, so every number is that sweep's.
  All of a render's samples are traced in one wavefront (each ray with
  its sample's index), only the pixels asked for are traced, and dead
  paths skip the sweep.

`stats` gains, besides `samples` and `bounces`, what the hybrid route's
rooflines read: `box_rays`, the live rays whose path reaches the pool's
box before their analytic hit, summed over bounces (the rays the mesh
pipe packs and B2 must sweep), and `stage_rays`, the live rays at the
stage boundaries, summed (the rays the stage packs move).  `dtype` runs
the same arithmetic in another float type (the control runs bfloat16).
Imports torch, numpy and its siblings only."""
from __future__ import annotations

import numpy as np
import torch

from reference import mesh, scene, tracer
from reference.mesh import counts, load, table_floats  # noqa: F401
from reference.tracer import INF, V3, where3

STAGED_MIN_DEPTH = 12
STAGE_STARTS = (6, 11, 16)
SWEEP_RAYS = 1 << 14    # rays a batch of the sweep takes
SWEEP_PAIRS = 1 << 16   # (ray, block) pairs a batch of triangle tests takes


def stage_starts(depth: int) -> list:
    """The bounces at which the route banks radiance and packs its rays
    (none below `STAGED_MIN_DEPTH`)."""
    if depth < STAGED_MIN_DEPTH:
        return []
    return [b for b in STAGE_STARTS if b < depth]


def render_values(tables: mesh.Tables, config: dict, traffic: dict, ids,
                  seed: int, device, dtype=torch.float32,
                  stats: dict = None) -> np.ndarray:
    """The float32 RGB ((n, 3), in [0, 1]) that the PNG writer receives
    for the film pixels `ids` of one render with the render seed `seed`."""
    # no float32 product of the reference may run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w, h, spp, depth = (traffic["width"], traffic["height"], traffic["spp"],
                        traffic["depth"])
    dev = torch.device(device)
    plan = mesh.passes("hybrid", w, h, spp, seed, dev.type)
    pixels = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
    film = frame_sum(tables, plan, pixels, w, h, depth, stage_starts(depth),
                     dtype, stats)
    # the route's own host arithmetic: float32 numpy
    film = film.float().cpu().numpy()
    return np.clip(np.sqrt(np.maximum(film / spp, 0.0)), 0.0, 1.0)


def render_pixels(tables: mesh.Tables, config: dict, traffic: dict, ids,
                  seed: int, device, dtype=torch.float32,
                  stats: dict = None) -> np.ndarray:
    """The contract's 8-bit RGB: `render_values` quantised as the PNG
    writer quantises."""
    img = render_values(tables, config, traffic, ids, seed, device, dtype,
                        stats)
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


# ---------------------------------------------------------------------------
# the frame: chunks of samples
# ---------------------------------------------------------------------------

def frame_sum(t: mesh.Tables, plan: list, pixels: torch.Tensor, width: int,
              height: int, depth: int, starts: list, dtype,
              stats: dict = None) -> torch.Tensor:
    """The linear film SUM ((P, 3)) of the passes `plan`: each pass's
    samples added from zero in sample order, the passes added in order."""
    dev = pixels.device
    pool = {k: torch.as_tensor(v, device=dev).to(dtype)
            for k, v in t.pool.items()}
    lo = torch.as_tensor(t.lo, device=dev).to(dtype)
    hi = torch.as_tensor(t.hi, device=dev).to(dtype)
    n_pix = pixels.numel()
    slots = [(s, sp0 + k, k == 0, k == n - 1) for s, sp0, n in plan
             for k in range(n)]
    chunk = max(1, mesh.RAYS_PER_WAVEFRONT // n_pix)
    film = torch.zeros((n_pix, 3), dtype=dtype, device=dev)
    part = None
    for c0 in range(0, len(slots), chunk):
        batch = slots[c0:c0 + chunk]
        rad = trace(t, pool, lo, hi, batch, pixels, width, height, depth,
                    starts, dtype, stats)
        for k, (_s, _sp, first, last) in enumerate(batch):
            if first:
                part = torch.zeros((n_pix, 3), dtype=dtype, device=dev)
            part += rad[k]
            if last:
                film += part
    return film


def _add(stats: dict, key: str, n) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(n)


def trace(t: mesh.Tables, pool, lo, hi, batch: list, pixels: torch.Tensor,
          width: int, height: int, depth: int, starts: list, dtype,
          stats: dict = None) -> torch.Tensor:
    """The radiance ((len(batch), P, 3)) of each (seed, sample) slot of
    `batch` at each pixel, counting the live rays at the stage boundaries
    `starts` as `stage_rays`."""
    sc = t.scene
    dev = pixels.device
    n_pix = pixels.numel()
    c = len(batch)
    seed = torch.tensor([s & tracer._M32 for s, _sp, _f, _l in batch],
                        dtype=torch.int64, device=dev).repeat_interleave(
                            n_pix)
    sp = torch.tensor([x for _s, x, _f, _l in batch], dtype=torch.int64,
                      device=dev).repeat_interleave(n_pix)
    pid = pixels.to(torch.int64).repeat(c)
    o, d = tracer.camera_rays(scene.default_camera(), pid, sp, seed, width,
                              height, dtype, dev)
    chans = tracer.mat_channels(sc, True)
    ones, zeros = torch.ones_like(o.x), torch.zeros_like(o.x)
    thr, rad = V3(ones, ones, ones), V3(zeros, zeros, zeros)
    alive = torch.ones_like(o.x, dtype=torch.bool)
    box = (lo.amin(dim=0), hi.amax(dim=0))
    for b in range(depth):
        if b in starts:   # the rays a stage pack moves
            _add(stats, "stage_rays", alive.sum())
        _add(stats, "bounces", alive.sum())
        bseed = (seed + b * -1640531535) & tracer._M32
        u1 = tracer.hash_uniform(pid, sp, 4, bseed, dtype)
        u2 = tracer.hash_uniform(pid, sp, 5, bseed, dtype)
        u3 = tracer.hash_uniform(pid, sp, 6, bseed, dtype)
        hit = closest_hit(t, pool, lo, hi, box, o, d, alive, chans, stats)
        o, d, thr, rad, alive = mesh.scatter(sc, hit, o, d, thr, rad, alive,
                                             u1, u2, u3, t.t_min)
    if any(v != 0.0 for v in sc.ambient):
        aw = alive.to(dtype)
        rad = V3(rad.x + aw * thr.x * float(sc.ambient[0]),
                 rad.y + aw * thr.y * float(sc.ambient[1]),
                 rad.z + aw * thr.z * float(sc.ambient[2]))
    _add(stats, "samples", c * n_pix)
    return torch.stack([rad.x, rad.y, rad.z], dim=-1).reshape(c, n_pix, 3)


def closest_hit(t: mesh.Tables, pool, lo, hi, box, o: V3, d: V3, alive,
                chans, stats: dict = None) -> tracer.Hit:
    """`mesh.closest_hit` by the batched `sweep`, counting the live rays
    that reach the pool's box `box` before their analytic hit."""
    dense = tracer.closest_hit(t.scene._replace(tri=[]), o, d, t.t_min,
                               chans)
    cap = torch.where(alive, dense.t, torch.zeros_like(dense.t))
    if stats is not None:
        _add(stats, "box_rays", _reaches(box, o, d, t.t_min, cap).sum())
    tb, idx, nx, ny, nz, mat = sweep(pool, lo, hi, o, d, t.t_min, cap)
    miss = idx < 0
    tb = torch.where(miss, torch.full_like(tb, INF), tb)
    closer = tb < dense.t
    tt = torch.where(closer, tb, dense.t)
    mesh_ch = mesh.channels_from_mat(mat, miss, chans)
    return tracer.Hit(
        tt, torch.isfinite(tt),
        V3(o.x + tt * d.x, o.y + tt * d.y, o.z + tt * d.z),
        where3(closer, V3(nx, ny, nz), dense.normal),
        tuple(torch.where(closer, a, b)
              for a, b in zip(mesh_ch, dense.channels)))


def _reaches(box, o: V3, d: V3, t_min: float, cap) -> torch.Tensor:
    """Which rays enter the box [lo, hi] before their cap (the blocks'
    entry rule)."""
    lo, hi = box
    near, par_near = _entry(lo[None], hi[None], o, d, t_min)
    return (torch.minimum(near, par_near)[:, 0]) < cap


# ---------------------------------------------------------------------------
# the blocked sweep, batched
# ---------------------------------------------------------------------------

def _entry(lo, hi, o: V3, d: V3, t_min: float) -> tuple:
    """((rays, boxes), (rays, boxes)): the distance max(t_near, t_min) at
    which each ray enters each box [lo, hi] ((boxes, 3)) by the slab test
    and by the recheck of rays parallel to an axis (`mesh`'s
    `_enters_parallel`), INF where the test's parts that do not depend on
    the ray's best fail.  A box is entered when either is below the
    ray's best, as `mesh._sweep_rays` enters it."""
    org = [x[:, None] for x in (o.x, o.y, o.z)]
    inv = [mesh._inv(x)[:, None] for x in (d.x, d.y, d.z)]
    t0 = [(lo[None, :, k] - org[k]) * inv[k] for k in range(3)]
    t1 = [(hi[None, :, k] - org[k]) * inv[k] for k in range(3)]
    t_near = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                         torch.minimum(t0[1], t1[1])),
                           torch.minimum(t0[2], t1[2]))
    t_far = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                        torch.maximum(t0[1], t1[1])),
                          torch.maximum(t0[2], t1[2]))
    inf = torch.full_like(t_near, INF)
    near = torch.where((t_near <= t_far) & (t_far >= t_min),
                       torch.clamp(t_near, min=t_min), inf)
    par_near = inf
    par = [torch.abs(i) == mesh.INV_PARALLEL for i in inv]
    if bool((par[0] | par[1] | par[2]).any()):
        pn = torch.full_like(t_near, -INF)
        pf = inf
        inside = torch.ones_like(t_near, dtype=torch.bool)
        for k in range(3):
            pn = torch.where(par[k], pn,
                             torch.maximum(pn, torch.minimum(t0[k], t1[k])))
            pf = torch.where(par[k], pf,
                             torch.minimum(pf, torch.maximum(t0[k], t1[k])))
            inside = inside & (~par[k] | ((lo[None, :, k] <= org[k])
                                          & (org[k] <= hi[None, :, k])))
        is_par = par[0] | par[1] | par[2]
        par_near = torch.where(is_par & inside & (pn <= pf) & (pf >= t_min),
                               torch.clamp(pn, min=t_min), inf)
    return near, par_near


def sweep(pool, lo, hi, o: V3, d: V3, t_min: float, cap: torch.Tensor):
    """`mesh.sweep`'s (t, pid, nx, ny, nz, mat), number for number: for
    each ray, the blocks it can enter with its cap, tested together, then
    taken in natural block order against the ray's running best."""
    best = [cap.clone(), torch.full_like(cap, -1.0)] + [
        torch.zeros_like(cap) for _ in range(4)]
    live = torch.nonzero(cap > t_min).flatten()
    for c0 in range(0, live.shape[0], SWEEP_RAYS):
        _sweep_rays(pool, lo, hi, o, d, t_min, live[c0:c0 + SWEEP_RAYS],
                    best)
    return tuple(best)


def _sweep_rays(pool, lo, hi, o: V3, d: V3, t_min, r, best) -> None:
    ro = V3(o.x[r], o.y[r], o.z[r])
    rd = V3(d.x[r], d.y[r], d.z[r])
    t_best = best[0][r]
    near, par_near = _entry(lo, hi, ro, rd, t_min)
    key = torch.minimum(near, par_near)
    pairs = torch.nonzero(key < t_best[:, None])   # (ray, block), in order
    if pairs.shape[0] == 0:
        return
    ray, blk = pairs[:, 0], pairs[:, 1]
    w_min = torch.empty(ray.shape, dtype=t_best.dtype, device=ray.device)
    i_min = torch.empty_like(ray)
    for p0 in range(0, ray.shape[0], SWEEP_PAIRS):
        pr, pb = ray[p0:p0 + SWEEP_PAIRS], blk[p0:p0 + SWEEP_PAIRS]
        # `_block_hits` of a tensor of blocks: one block a pair
        w = mesh._block_hits(pool, pb, (ro.x[pr], ro.y[pr], ro.z[pr]),
                             (rd.x[pr], rd.y[pr], rd.z[pr]), t_min)[0]
        i = torch.argmin(w, dim=1)
        i_min[p0:p0 + SWEEP_PAIRS] = i
        w_min[p0:p0 + SWEEP_PAIRS] = w.gather(1, i[:, None])[:, 0]
    # each ray's pairs in block order: column k holds its k-th pair
    n = t_best.shape[0]
    per = torch.bincount(ray, minlength=n)
    first = torch.cumsum(per, 0) - per
    col = torch.arange(ray.shape[0], device=ray.device) - first[ray]
    width = int(per.max())
    grid = lambda fill, v: torch.full((n, width), fill, dtype=v.dtype,
                                      device=v.device).index_put_(
                                          (ray, col), v)
    key_m = grid(INF, key[ray, blk])
    w_m = grid(INF, w_min)
    blk_m, i_m = grid(-1, blk), grid(0, i_min)
    win_blk = torch.full((n,), -1, dtype=blk.dtype, device=blk.device)
    win_i = torch.zeros_like(win_blk)
    for k in range(width):
        acc = (key_m[:, k] < t_best) & (w_m[:, k] < t_best)
        t_best = torch.where(acc, w_m[:, k], t_best)
        win_blk = torch.where(acc, blk_m[:, k], win_blk)
        win_i = torch.where(acc, i_m[:, k], win_i)
    won = torch.nonzero(win_blk >= 0).flatten()
    best[0][r] = t_best
    for k, name in enumerate(("pid", "nx", "ny", "nz", "mat"), start=1):
        best[k][r[won]] = pool[name][win_blk[won], win_i[won]]
