"""The reference of mesh configurations under the contract of
`reference/__init__.py`: the configuration's `.scn` file (`scene`) with
its OBJ files (`"obj"`) rendered as AccPathTracer's mesh routes render
them, for the check that decides `correct`.

Independent of the renderer: its own OBJ reader, its own BVH order and
block packing, its own blocked sweep, each a frozen copy of what the
renderer's plain versions compute, so that in float32 it gives the
renderer's films bit for bit on the same device type.

- **The OBJ reader** reads plain triangulated files (`v` and `f`
  records; an `f` record of exactly three corners, `a`, `a/b`, `a//c` or
  `a/b/c`, 1-based or negative); it refuses materials, groups and
  objects.  Each decimal is rounded once to float32, as `strtof` rounds
  it (rounding through float64 rounds twice where the float64 value
  lands exactly halfway between two float32 values).  A mesh takes the
  scene's first material, its face normals are the float64 cross
  product of its float64 edges, normalised and then rounded to float32,
  and its edges are rounded from float64 differences.
- **The pool**: the `.scn`'s own triangles, then each OBJ's faces, in
  file order, put in the leaf order of a BVH over their boxes
  (midpoint-median split on the largest extent of the node's bounds,
  stable sort of float32 centroids, one triangle a leaf, depth first)
  and cut into blocks of 128 with float32 box bounds; the last block is
  padded with copies that never hit.
- **The closest hit** of a bounce: the `.scn`'s spheres, planes and
  lights as `tracer` tests them, then the pool's blocks in natural order,
  each entered when the ray's slab test reaches it before its best hit
  (a ray parallel to an axis bounds nothing along it while its origin
  lies inside the box's extent), each entered block's triangles by
  Moller-Trumbore with the determinant's sign folded, the first of the
  block's least accepted distances taking the hit when it beats the
  best; a mesh hit replaces the analytic one only when strictly nearer.
- **The route's sampling** (`passes`): the megamesh route sums passes
  of 32, 16, 8, 4, 2 or 1 samples (the first that divides the spp),
  pass k with the render seed `seed * 100003 + k`, each pass's samples
  from zero in sample order, and adds each pass into the frame's float32
  sum in pass order; then the mean's square root, clipped and quantised
  as the PNG writer does.  The hybrid route (the CPU's pools past 1024
  triangles; `route="hybrid"`) sums its whole render at the render's
  seed, or in passes of its chunk when it has more than 4 of them.

Departures, none of which changes a number: all passes of a render are
traced in one wavefront of rays (each ray with its pass's seed), only
the pixels asked for are traced, and dead paths skip the sweep.  The
hybrid route's own sweep visits blocks near to far and culls rays
against the pool's box first; the reference sweeps in natural order for
both routes, which differs only where two triangles give the same
distance or a hit lies on a block's box face within rounding.

`dtype` runs the same arithmetic in another float type (the control
runs bfloat16).  Only the five-lobe estimator (`"estimator": "bsdf"`)
has mesh routes.  Imports torch, numpy and its siblings only."""
from __future__ import annotations

from fractions import Fraction
from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np
import torch

from reference import scene, tracer
from reference.tracer import INF, V3, where3

BLOCK = 128
ROUTE_BUDGET_RAYS = {"cuda": 1 << 24, "cpu": 1 << 21}   # hybrid chunks
RAYS_PER_WAVEFRONT = 1 << 20
SWEEP_CHUNK = 1 << 18   # rays a block step tests at once
FIELDS = ("v1x", "v1y", "v1z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z",
          "nx", "ny", "nz", "mat", "pid")


class MeshError(ValueError):
    pass


class Tables(NamedTuple):
    """The `.scn`'s tables, the pool in blocks and the render's t_min."""
    scene: scene.Tables
    pool: dict          # FIELDS: (n_blocks, BLOCK) float32 numpy arrays
    lo: np.ndarray      # (n_blocks, 3) float32 block boxes
    hi: np.ndarray
    mesh_triangles: int
    t_min: float


# ---------------------------------------------------------------------------
# the OBJ reader
# ---------------------------------------------------------------------------

def float32_once(tokens: Sequence[str]) -> np.ndarray:
    """Decimal strings rounded once to the nearest float32, ties to even."""
    wide = np.array([float(t) for t in tokens], np.float64)
    with np.errstate(over="ignore", invalid="ignore"):
        near = wide.astype(np.float32)
        for step in (np.float32(np.inf), np.float32(-np.inf)):
            other = np.nextafter(near, step)
            mid = (near.astype(np.float64) + other.astype(np.float64)) / 2
            for i in np.flatnonzero(wide == mid):
                exact = Fraction(tokens[i])
                half = Fraction(float(mid[i]))
                if exact != half:   # the decimal, not its float64, decides
                    above = Fraction(float(other[i])) > half
                    near[i] = other[i] if (exact > half) == above else near[i]
    return near


def read_obj(path: str) -> tuple:
    """(positions (V, 3) float32, faces (F, 3) int64 0-based) of a plain
    triangulated OBJ file."""
    with open(path, "rb") as f:
        text = f.read().decode("utf-8", errors="replace")
    probe = "\n" + text
    if any(k in probe for k in ("usemtl", "mtllib", "\no ", "\ng ")):
        raise MeshError(f"{path}: the reference reads plain triangulated "
                        "files (no materials, objects or groups)")
    coords, corners = [], []
    for line in text.splitlines():
        head = line[:2]
        if head == "v ":
            xyz = line[2:].split()[:3]
            if len(xyz) != 3:
                raise MeshError(f"{path}: bad vertex {line!r}")
            coords += xyz
        elif head == "f ":
            face = line[2:].split()
            if len(face) != 3:
                raise MeshError(f"{path}: a face of {len(face)} corners")
            corners += [int(c.split("/")[0]) for c in face]
    if not corners:
        raise MeshError(f"{path}: no faces")
    pos = float32_once(coords).reshape(-1, 3)
    idx = np.asarray(corners, np.int64).reshape(-1, 3)
    idx = np.where(idx < 0, idx + pos.shape[0], idx - 1)
    return pos, idx


def mesh_triangles(pos: np.ndarray, faces: np.ndarray) -> tuple:
    """(v1, e1, e2, n) float32 (F, 3) of a mesh at the identity placement:
    edges and normals computed in float64, then rounded."""
    p = pos.astype(np.float64)
    v1, v2, v3 = p[faces[:, 0]], p[faces[:, 1]], p[faces[:, 2]]
    n = np.cross(v2 - v1, v3 - v1)
    norm = np.linalg.norm(n, axis=-1, keepdims=True)
    n = n / np.where(norm > 0, norm, 1.0)
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return f32(v1), f32(v2 - v1), f32(v3 - v1), f32(n)


# ---------------------------------------------------------------------------
# the pool: BVH leaf order and blocks
# ---------------------------------------------------------------------------

def bvh_order(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """The leaves, depth first, of the BVH over boxes [lo, hi] (float32):
    each node splits its triangles at the middle of their stable order
    by centroid along the largest extent of the node's bounds."""
    centroid = (lo + hi) * 0.5
    out = []
    todo = [np.arange(lo.shape[0])]
    while todo:
        idx = todo.pop()
        if idx.shape[0] == 1:
            out.append(int(idx[0]))
            continue
        axis = int(np.argmax(hi[idx].max(axis=0) - lo[idx].min(axis=0)))
        idx = idx[np.argsort(centroid[idx, axis], kind="stable")]
        half = idx.shape[0] // 2
        todo += [idx[half:], idx[:half]]   # the first half comes out first
    return np.asarray(out, np.int64)


def pack(v1, e1, e2, n, mat) -> tuple:
    """(pool, lo, hi): the triangles in BVH order, in blocks of BLOCK."""
    v2, v3 = v1 + e1, v1 + e2
    tmin = np.minimum(np.minimum(v1, v2), v3)
    tmax = np.maximum(np.maximum(v1, v2), v3)
    order = bvh_order(tmin, tmax)
    n_blocks = -(-order.shape[0] // BLOCK)
    pad = n_blocks * BLOCK - order.shape[0]
    slots = np.concatenate([order, np.repeat(order[-1:], pad)])
    cols = {"v1": v1, "e1": e1, "e2": e2, "n": n}
    pool = {}
    for name in FIELDS[:-2]:
        src = cols[name[:-1]][:, "xyz".index(name[-1])]
        pool[name] = src[slots].reshape(n_blocks, BLOCK)
    pool["mat"] = mat.astype(np.float32)[slots].reshape(n_blocks, BLOCK)
    pool["pid"] = np.concatenate([order, np.full(pad, -1)]).astype(
        np.float32).reshape(n_blocks, BLOCK)   # the triangle; -1 padding
    lo = tmin[slots].reshape(n_blocks, BLOCK, 3).min(axis=1)
    hi = tmax[slots].reshape(n_blocks, BLOCK, 3).max(axis=1)
    return pool, lo, hi


# ---------------------------------------------------------------------------
# the contract
# ---------------------------------------------------------------------------

def load(config: dict, root: Path) -> Tables:
    if config.get("estimator") != "bsdf":
        raise MeshError("mesh routes run the five-lobe estimator only")
    sc = scene.load_tables(str(Path(root) / config["scene"]))
    parts = [[np.asarray(t[k], np.float32)[None] for t in sc.tri]
             for k in range(4)]
    mats = [t[4] for t in sc.tri]
    n_mesh = 0
    for path in config.get("obj", []):
        v1, e1, e2, n = mesh_triangles(*read_obj(str(Path(root) / path)))
        for k, a in enumerate((v1, e1, e2, n)):
            parts[k].append(a)
        mats += [0] * v1.shape[0]
        n_mesh += v1.shape[0]
    if not n_mesh:
        raise MeshError("a mesh configuration names at least one OBJ")
    v1, e1, e2, n = (np.concatenate(p) for p in parts)
    pool, lo, hi = pack(v1, e1, e2, n, np.asarray(mats, np.int64))
    extent = float(np.abs(np.stack([v1, v1 + e1, v1 + e2])).max())
    t_min = max(scene.scene_epsilon(sc), 2e-6 * extent)
    return Tables(sc, pool, lo, hi, n_mesh, t_min)


def counts(t: Tables) -> dict:
    """The `.scn`'s primitives (its own triangles under "triangles", which
    the renderer sweeps with the mesh) and the OBJ faces."""
    return dict(scene.primitive_counts(t.scene),
                mesh_triangles=t.mesh_triangles)


def table_floats(t: Tables) -> int:
    """The mesh form's scene table (no triangle rows: the pool holds
    them), its triangle table (16 floats a slot) and its block boxes (8
    floats a block)."""
    n_blocks = t.lo.shape[0]
    return (scene.table_floats(t.scene._replace(tri=[]))
            + 16 * n_blocks * BLOCK + 8 * n_blocks)


def passes(route: str, width: int, height: int, spp: int, seed: int,
           device_type: str = "cuda") -> list:
    """(render seed, first sample, samples) of each pass the route sums
    from zero, in the order it adds them."""
    if route == "megamesh":
        per = next(k for k in (32, 16, 8, 4, 2, 1) if spp % k == 0)
        return [(seed * 100003 + k, 0, per) for k in range(spp // per)]
    if route == "hybrid":
        budget = ROUTE_BUDGET_RAYS[device_type]
        chunk = max([c for c in range(1, spp + 1) if spp % c == 0
                     and width * height * c <= budget] or [1])
        if spp // chunk > 4:
            return [(seed, k * chunk, chunk) for k in range(spp // chunk)]
        return [(seed, 0, spp)]
    raise ValueError(f"no route {route!r}")


def render_values(tables: Tables, config: dict, traffic: dict, ids,
                  seed: int, device, dtype=torch.float32,
                  stats: dict = None, route: str = "megamesh") -> np.ndarray:
    """The float32 RGB ((n, 3), in [0, 1]) that the PNG writer receives
    for the film pixels `ids` of one render with the render seed `seed`."""
    # no float32 product of the reference may run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w, h, spp = traffic["width"], traffic["height"], traffic["spp"]
    dev = torch.device(device)
    plan = passes(route, w, h, spp, seed, dev.type)
    pixels = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
    film = frame_sum(tables, plan, pixels, w, h, traffic["depth"], dtype,
                     stats)
    # the route's own host arithmetic: float32 numpy
    film = film.float().cpu().numpy()
    return np.clip(np.sqrt(np.maximum(film / spp, 0.0)), 0.0, 1.0)


def render_pixels(tables: Tables, config: dict, traffic: dict, ids,
                  seed: int, device, dtype=torch.float32,
                  stats: dict = None, route: str = "megamesh"
                  ) -> np.ndarray:
    """The contract's 8-bit RGB: `render_values` quantised as the PNG
    writer quantises."""
    img = render_values(tables, config, traffic, ids, seed, device, dtype,
                        stats, route)
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


# ---------------------------------------------------------------------------
# the frame: passes of samples
# ---------------------------------------------------------------------------

def frame_sum(t: Tables, plan: list, pixels: torch.Tensor, width: int,
              height: int, depth: int, dtype, stats: dict = None
              ) -> torch.Tensor:
    """The linear film SUM ((P, 3)) of the passes `plan`: each pass's
    samples added from zero in sample order, the passes added in order."""
    dev = pixels.device
    pool = {k: torch.as_tensor(v, device=dev).to(dtype)
            for k, v in t.pool.items()}
    lo = torch.as_tensor(t.lo, device=dev).to(dtype)
    hi = torch.as_tensor(t.hi, device=dev).to(dtype)
    n_pix = pixels.numel()
    # one slot a sample of a pass, in the order they are added
    slots = [(s, sp0 + k, k == 0, k == n - 1) for s, sp0, n in plan
             for k in range(n)]
    chunk = max(1, RAYS_PER_WAVEFRONT // n_pix)
    film = torch.zeros((n_pix, 3), dtype=dtype, device=dev)
    part = None
    for c0 in range(0, len(slots), chunk):
        batch = slots[c0:c0 + chunk]
        rad = trace(t, pool, lo, hi, batch, pixels, width, height, depth,
                    dtype, stats)
        for k, (_s, _sp, first, last) in enumerate(batch):
            if first:
                part = torch.zeros((n_pix, 3), dtype=dtype, device=dev)
            part += rad[k]
            if last:
                film += part
    return film


def trace(t: Tables, pool, lo, hi, batch: list, pixels: torch.Tensor,
          width: int, height: int, depth: int, dtype, stats: dict = None
          ) -> torch.Tensor:
    """The radiance ((len(batch), P, 3)) of each (seed, sample) slot of
    `batch` at each pixel."""
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
    for b in range(depth):
        if stats is not None:
            stats["bounces"] = stats.get("bounces", 0) + int(alive.sum())
        bseed = (seed + b * -1640531535) & tracer._M32
        u1 = tracer.hash_uniform(pid, sp, 4, bseed, dtype)
        u2 = tracer.hash_uniform(pid, sp, 5, bseed, dtype)
        u3 = tracer.hash_uniform(pid, sp, 6, bseed, dtype)
        hit = closest_hit(t, pool, lo, hi, o, d, alive, chans)
        o, d, thr, rad, alive = scatter(sc, hit, o, d, thr, rad, alive, u1,
                                        u2, u3, t.t_min)
    if any(v != 0.0 for v in sc.ambient):
        aw = alive.to(dtype)
        rad = V3(rad.x + aw * thr.x * float(sc.ambient[0]),
                 rad.y + aw * thr.y * float(sc.ambient[1]),
                 rad.z + aw * thr.z * float(sc.ambient[2]))
    if stats is not None:
        stats["samples"] = stats.get("samples", 0) + c * n_pix
    return torch.stack([rad.x, rad.y, rad.z], dim=-1).reshape(c, n_pix, 3)


# ---------------------------------------------------------------------------
# a bounce: the closest hit and the five-lobe scatter
# ---------------------------------------------------------------------------

def closest_hit(t: Tables, pool, lo, hi, o: V3, d: V3, alive,
                chans) -> tracer.Hit:
    """The analytic primitives, then the pool capped by their hit (0, no
    sweep, for dead paths); the mesh's hit where strictly nearer."""
    dense = tracer.closest_hit(t.scene._replace(tri=[]), o, d, t.t_min,
                               chans)
    cap = torch.where(alive, dense.t, torch.zeros_like(dense.t))
    tb, idx, nx, ny, nz, mat = sweep(pool, lo, hi, o, d, t.t_min, cap)
    miss = idx < 0
    tb = torch.where(miss, torch.full_like(tb, INF), tb)
    closer = tb < dense.t
    tt = torch.where(closer, tb, dense.t)
    mesh_ch = channels_from_mat(mat, miss, chans)
    return tracer.Hit(
        tt, torch.isfinite(tt),
        V3(o.x + tt * d.x, o.y + tt * d.y, o.z + tt * d.z),
        where3(closer, V3(nx, ny, nz), dense.normal),
        tuple(torch.where(closer, a, b)
              for a, b in zip(mesh_ch, dense.channels)))


def channels_from_mat(mat, miss, chans) -> tuple:
    """Material 0's channels unless the id names another material; zeros
    on a miss."""
    out = []
    for k in range(len(chans[0])):
        v = torch.full_like(mat, float(chans[0][k]))
        for m in range(1, len(chans)):
            v = torch.where(mat == float(m), float(chans[m][k]), v)
        out.append(torch.where(miss, 0.0, v))
    return tuple(out)


def scatter(sc, hit: tracer.Hit, o, d, thr, rad, alive, u1, u2, u3, t_min):
    """`tracer.bsdf_bounce` after its closest hit: the light, then the
    material's lobe."""
    obj_first, rad = tracer._light_step(sc, hit, o, d, thr, rad, alive,
                                        t_min)
    (mtype, dr, dg, db, ar, ag, ab_, ior, absr, absg, absb,
     err, erg, erb, eir, eig, eib, rough, f0, metal) = hit.channels
    diffuse, albedo = V3(dr, dg, db), V3(ar, ag, ab_)
    order = tracer.lobe_order(sc)
    d_diff = tracer.normalize3(tracer.onb_local(
        hit.normal, tracer.hemisphere_from_uv(u1, u2)), eps=1e-20)
    cos = tracer.dot3(hit.normal, d_diff)
    lobes = [(0, d_diff, V3(diffuse.x * 2.0 * cos, diffuse.y * 2.0 * cos,
                            diffuse.z * 2.0 * cos))]
    if 1 in order:
        lobes.append((1, *tracer.conductor_scatter(
            d, hit.normal, V3(err, erg, erb), V3(eir, eig, eib), albedo)))
    if 2 in order:
        lobes.append((2, *tracer.glass_scatter(
            d, hit.normal, ior, V3(absr, absg, absb), u3)))
    if 3 in order:
        lobes.append((3, *tracer.microfacet_scatter(
            d, hit.normal, albedo, rough, f0, metal, u1, u2)))
    if 4 in order:
        lobes.append((4, *tracer.plastic_scatter(
            d, hit.normal, diffuse, albedo, ior, u1, u2, u3)))
    new_d, wt = lobes[0][1], lobes[0][2]
    for i, (type_id, ld, lw) in enumerate(lobes[1:], start=1):
        sel = mtype >= type_id - 0.5
        if i < len(lobes) - 1:
            sel = sel & (mtype < type_id + 0.5)
        new_d = where3(sel, ld, new_d)
        wt = where3(sel, lw, wt)
    thr = V3(thr.x * torch.where(obj_first, wt.x, 1.0),
             thr.y * torch.where(obj_first, wt.y, 1.0),
             thr.z * torch.where(obj_first, wt.z, 1.0))
    return (where3(obj_first, hit.point, o), where3(obj_first, new_d, d),
            thr, rad, obj_first)


# ---------------------------------------------------------------------------
# the blocked sweep
# ---------------------------------------------------------------------------

def _inv(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(x) < 1e-20, 1e-20, x)


INV_PARALLEL = float(np.float32(1.0) / np.float32(1e-20))


def sweep(pool, lo, hi, o: V3, d: V3, t_min: float, cap: torch.Tensor):
    """(t, pid, nx, ny, nz, mat) of the pool's closest hit under `cap` for
    each ray (pid: the triangle's index, the `.scn`'s triangles first):
    t stays at the cap and pid at -1 where none beats it."""
    best = [cap.clone(), torch.full_like(cap, -1.0)] + [
        torch.zeros_like(cap) for _ in range(4)]
    live = torch.nonzero(cap > t_min).flatten()
    for c0 in range(0, live.shape[0], SWEEP_CHUNK):
        _sweep_rays(pool, lo, hi, o, d, t_min, live[c0:c0 + SWEEP_CHUNK],
                    best)
    return tuple(best)


def _enters_parallel(lo, hi, o: tuple, inv: tuple, t_min: float, t_best):
    t_near = torch.full_like(o[0], -INF)
    t_far = torch.full_like(o[0], INF)
    inside = torch.ones_like(o[0], dtype=torch.bool)
    for k in range(3):
        par = torch.abs(inv[k]) == INV_PARALLEL
        t0 = (lo[k] - o[k]) * inv[k]
        t1 = (hi[k] - o[k]) * inv[k]
        t_near = torch.where(par, t_near,
                             torch.maximum(t_near, torch.minimum(t0, t1)))
        t_far = torch.where(par, t_far,
                            torch.minimum(t_far, torch.maximum(t0, t1)))
        inside &= ~par | ((lo[k] <= o[k]) & (o[k] <= hi[k]))
    return (inside & (t_near <= t_far) & (t_far >= t_min)
            & (torch.clamp(t_near, min=t_min) < t_best))


def _sweep_rays(pool, lo, hi, o, d, t_min, r, best) -> None:
    ox, oy, oz = o.x[r], o.y[r], o.z[r]
    dx, dy, dz = d.x[r], d.y[r], d.z[r]
    inv = (_inv(dx), _inv(dy), _inv(dz))
    parallel = torch.nonzero(
        (torch.abs(inv[0]) == INV_PARALLEL) | (torch.abs(inv[1])
                                              == INV_PARALLEL)
        | (torch.abs(inv[2]) == INV_PARALLEL)).flatten()
    t_best = best[0][r]
    res = [a[r] for a in best[1:]]
    for blk in range(lo.shape[0]):
        b_lo, b_hi = lo[blk], hi[blk]
        t0x = (b_lo[0] - ox) * inv[0]
        t1x = (b_hi[0] - ox) * inv[0]
        t0y = (b_lo[1] - oy) * inv[1]
        t1y = (b_hi[1] - oy) * inv[1]
        t0z = (b_lo[2] - oz) * inv[2]
        t1z = (b_hi[2] - oz) * inv[2]
        t_near = torch.maximum(torch.maximum(torch.minimum(t0x, t1x),
                                             torch.minimum(t0y, t1y)),
                               torch.minimum(t0z, t1z))
        t_far = torch.minimum(torch.minimum(torch.maximum(t0x, t1x),
                                            torch.maximum(t0y, t1y)),
                              torch.maximum(t0z, t1z))
        ent = ((t_near <= t_far) & (t_far >= t_min)
               & (torch.clamp(t_near, min=t_min) < t_best))
        if parallel.numel():
            p = parallel
            ent[p] |= _enters_parallel(
                b_lo, b_hi, (ox[p], oy[p], oz[p]),
                (inv[0][p], inv[1][p], inv[2][p]), t_min, t_best[p])
        s = torch.nonzero(ent).flatten()
        if s.numel() == 0:
            continue
        w = _block_hits(pool, blk, (ox[s], oy[s], oz[s]),
                        (dx[s], dy[s], dz[s]), t_min)
        i_best = torch.argmin(w, dim=1)
        w_best = w.gather(1, i_best[:, None])[:, 0]
        acc = w_best < t_best[s]
        if not bool(acc.any()):
            continue
        sa, ia = s[acc], i_best[acc]
        t_best[sa] = w_best[acc]
        for k, name in enumerate(("pid", "nx", "ny", "nz", "mat")):
            res[k][sa] = pool[name][blk][ia]
    best[0][r] = t_best
    for a, v in zip(best[1:], res):
        a[r] = v


def _block_hits(pool, blk: int, o: tuple, d: tuple, t_min: float):
    """(rays, BLOCK) accepted distances of the rays against block `blk`
    (inf where rejected)."""
    col = lambda name: pool[name][blk][None, :]
    sox, soy, soz = (x[:, None] for x in o)
    sdx, sdy, sdz = (x[:, None] for x in d)
    v1x, v1y, v1z = col("v1x"), col("v1y"), col("v1z")
    e1x, e1y, e1z = col("e1x"), col("e1y"), col("e1z")
    e2x, e2y, e2z = col("e2x"), col("e2y"), col("e2z")
    px = sdy * e2z - sdz * e2y
    py = sdz * e2x - sdx * e2z
    pz = sdx * e2y - sdy * e2x
    det0 = e1x * px + e1y * py + e1z * pz
    sign = torch.where(det0 > 0, 1.0, -1.0)
    det = det0 * sign
    tx = (sox - v1x) * sign
    ty = (soy - v1y) * sign
    tz = (soz - v1z) * sign
    u = tx * px + ty * py + tz * pz
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vv = sdx * qx + sdy * qy + sdz * qz
    inv_det = 1.0 / torch.where(det == 0, 1.0, det)
    w = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = ((det >= 1e-6) & (u >= 0) & (u <= det) & (vv >= 0)
          & (u + vv <= det) & (w >= t_min) & (col("pid") >= 0))
    return torch.where(ok, w, INF).to(sox.dtype)   # the sign's float32
