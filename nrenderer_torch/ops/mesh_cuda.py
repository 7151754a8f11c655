"""The blocked mesh sweep: device tables, CUDA launch wrapper, plain torch
version and launch counter.

Counterpart of `nrenderer_tpu/ops/mesh_pallas.py`: the closest triangle
per ray against the BVH-preorder blocked pool of `ops/bvh.py`, each block
slab-tested against its AABB and skipped when the ray cannot beat its best
hit inside it; the per-ray `t_cap` is the starting best (the dense hit's
t, or 0 to skip the ray).  `sweep_mesh_full` launches `mesh_sweep_kernel`
(`csrc/mesh_sweep.cu`, which replaces the Pallas `_sweep_kernel`) for rays
on a CUDA device and runs `sweep_mesh_plain` for rays on the CPU; the
path-tracing kernel's mesh form inlines the same device function
(`csrc/mesh_sweep.cuh`) in its bounce loop.

The contract, from `mesh_pallas.sweep_tile` (`:72-256`), in its float
order: inv_d = 1 / where(|d| < 1e-20, 1e-20, d); a block is entered when
(t_near <= t_far) & (t_far >= t_min) & (max(t_near, t_min) < t_best);
Möller-Trumbore with the det-sign fold, w = (e2 . q) * inv_det, accepted
when det >= 1e-6, u, v in range, t_min <= w < t_best and pid >= 0; the
winner's UV is uv1 + bu * ue1 + bv * ue2 with bu = u * inv_det.  Blocks are
visited in natural order, or near to far along the ray's own direction
octant (`f2b_ord`).  The Pallas kernel culls a block for a whole 32x128
ray tile (it sweeps when any ray of the tile enters); here each ray culls
for itself.  The two differ only where a hit lies on a block's AABB face
within rounding.  A ray parallel to an axis (|d| < 1e-20) whose origin
lies on the box's far face along it gets t_far = 0 from the slab, which
drops the block; the Pallas tile cull still tests it when another ray of
the tile enters the block.  Here such rays are rechecked with that axis
bounding nothing while the origin lies within the box's extent, faces
included (`_enters_parallel`), in the sweep and in the mesh pipe's
top-level test alike."""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.timing import GLOBAL_TIMER
from . import stream_compact
from .bvh import BlockedTris
from .soa import V3

KERNEL_SOURCE = "nrenderer_torch/csrc/mesh_sweep.cu"
REPLACES = "nrenderer_tpu/ops/mesh_pallas.py:439 _sweep_kernel"
KERNEL_NAME = "mesh_sweep_kernel"

# Launches of `mesh_sweep_kernel` made by `sweep_mesh_full`: a caller
# resets and reads it to show that a run went through the kernel.
KERNEL_LAUNCHES = {KERNEL_NAME: 0}


def reset_launch_counts() -> None:
    KERNEL_LAUNCHES[KERNEL_NAME] = 0


# Device table rows (float32); csrc/mesh_sweep.cuh reads the same layout.
TRI_FLOATS = 16   # v1[3] e1[3] e2[3] n[3] mat pid, 2 pad
UV_FLOATS = 8     # uv1[2] ue1[2] ue2[2] tex, 1 pad
BB_FLOATS = 8     # min[3], pad, max[3], pad
RAY_CHANNELS = 7  # ox oy oz dx dy dz t_cap

# rays per wavefront chunk of the plain version
PLAIN_CHUNK = 1 << 16


class MeshTables(NamedTuple):
    """A blocked pool as the sweep reads it, on one device."""
    tris: torch.Tensor            # (n_blocks * block, TRI_FLOATS)
    uvs: Optional[torch.Tensor]   # (n_blocks * block, UV_FLOATS) or None
    bb: torch.Tensor              # (n_blocks, BB_FLOATS)
    f2b: torch.Tensor             # (8, n_blocks) int32
    n_blocks: int
    block: int
    # the MXU sweep's (n_blocks * block, 40) coefficient rows (det, u, v,
    # t*det times features 0-9, `ops/mesh_mxu.py`) and the pool's centre
    coef: Optional[torch.Tensor] = None
    center: Optional[tuple] = None
    # the same rows as the MXU kernel reads them: (n_blocks, 10, block, 4),
    # each float4 of a block's triangles side by side
    coef_t: Optional[torch.Tensor] = None


def make_mesh_tables(bt: BlockedTris, device) -> MeshTables:
    """Pack `bt` into contiguous device tables, once per render.  The MXU
    coefficient table keeps features 0-9 of each of a triangle's four rows
    (`bvh.BlockedTris.mxu_coef`; features 10-15 are zero padding), and
    its kernel's form of it (`coef_t`) is built beside it."""
    n = bt.n_blocks * bt.block
    tris = np.zeros((n, TRI_FLOATS), np.float32)
    for j, f in enumerate(("v1x", "v1y", "v1z", "e1x", "e1y", "e1z", "e2x",
                           "e2y", "e2z", "nx", "ny", "nz", "mat", "pid")):
        tris[:, j] = np.asarray(getattr(bt, f), np.float32).reshape(-1)
    uvs = None
    if bt.tex is not None:
        uvs = np.zeros((n, UV_FLOATS), np.float32)
        for j, f in enumerate(("uv1x", "uv1y", "ue1x", "ue1y", "ue2x",
                               "ue2y", "tex")):
            uvs[:, j] = np.asarray(getattr(bt, f), np.float32).reshape(-1)
    bb = np.zeros((bt.n_blocks, BB_FLOATS), np.float32)
    bb[:, 0:3] = bt.bb_min
    bb[:, 4:7] = bt.bb_max
    coef = None
    if bt.mxu_coef is not None:
        c = np.asarray(bt.mxu_coef, np.float32).reshape(
            bt.n_blocks, 4, bt.block, 16).transpose(0, 2, 1, 3)
        if c[..., 10:].any():
            raise ValueError("MXU coefficients past feature 9 must be zero")
        coef = c[..., :10].reshape(n, 40)
    put = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    return MeshTables(tris=put(tris), uvs=None if uvs is None else put(uvs),
                      bb=put(bb), f2b=put(np.asarray(bt.f2b_ord, np.int32)),
                      n_blocks=bt.n_blocks, block=bt.block,
                      coef=None if coef is None else put(coef),
                      center=bt.mxu_center,
                      coef_t=None if coef is None else put(coef.reshape(
                          bt.n_blocks, bt.block, 10, 4).transpose(0, 2, 1,
                                                                  3)))


def channels_from_mat(mat: torch.Tensor, miss: torch.Tensor,
                      mat_channels) -> tuple:
    """The tracked channel tuple of the winners' material ids: a select
    chain over the material table (`mesh_pallas._channels_from_mat`,
    `:616`): material 0's channels unless the id equals another
    material's index; zeros on a miss."""
    k = len(mat_channels[0]) if mat_channels else 0
    chans = []
    for ki in range(k):
        out = torch.full_like(mat, float(mat_channels[0][ki]))
        for mi in range(1, len(mat_channels)):
            out = torch.where(mat == float(mi), float(mat_channels[mi][ki]),
                              out)
        chans.append(torch.where(miss, 0.0, out))
    return tuple(chans)


def _inv(x: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(x) < 1e-20, 1e-20, x)


INV_PARALLEL = float(np.float32(1.0) / np.float32(1e-20))


def _parallel(inv: tuple) -> torch.Tensor:
    """Which rays run parallel to an axis (`_inv` of |d| <= 1e-20)."""
    return ((torch.abs(inv[0]) == INV_PARALLEL)
            | (torch.abs(inv[1]) == INV_PARALLEL)
            | (torch.abs(inv[2]) == INV_PARALLEL))


def _enters_parallel(lo, hi, o: tuple, inv: tuple, t_min: float,
                     t_best: torch.Tensor) -> torch.Tensor:
    """The slab test of rays parallel to an axis (`csrc/mesh_sweep.cuh`
    `enters_parallel`): along such an axis the box bounds nothing while
    the origin lies within [lo, hi], faces included, and culls the ray
    otherwise; the other axes narrow [t_near, t_far] as the slab test
    does."""
    t_near = torch.full_like(o[0], -float("inf"))
    t_far = torch.full_like(o[0], float("inf"))
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


def _octant(d: V3) -> torch.Tensor:
    return ((d.x > 0).to(torch.int64) * 4 + (d.y > 0).to(torch.int64) * 2
            + (d.z > 0).to(torch.int64))


def sweep_mesh_plain(mt: MeshTables, o: V3, d: V3, t_min: float,
                     t_cap: torch.Tensor, f2b: bool = False,
                     with_uv: bool = False, stats: Optional[dict] = None):
    """The sweep kernel's plain torch version on (N,) rays (the device
    function's per-ray semantics, `sweep_tile`'s float order).  Returns
    (t_best, idx, nx, ny, nz, mat), plus (u, v, tex) with `with_uv`, all
    float32: t_best stays at the cap and idx at -1 when no triangle beats
    the cap (`sweep_tile`'s contract).  `stats` as `sweep_blocks_plain`."""
    dev = o.x.device
    with_uv = with_uv and mt.uvs is not None
    tris = mt.tris.to(dev).reshape(mt.n_blocks, mt.block, TRI_FLOATS)
    uvs = (mt.uvs.to(dev).reshape(mt.n_blocks, mt.block, UV_FLOATS)
           if with_uv else None)

    def hit_test(blk, rs, tb):
        """Moller-Trumbore of the rays `rs` against block `blk`."""
        t = tris[blk]                        # (B, TRI_FLOATS)
        col = lambda j: t[:, j][None, :]     # (1, B)
        sox, soy, soz = o.x[rs][:, None], o.y[rs][:, None], o.z[rs][:, None]
        sdx, sdy, sdz = d.x[rs][:, None], d.y[rs][:, None], d.z[rs][:, None]
        v1x, v1y, v1z = col(0), col(1), col(2)
        e1x, e1y, e1z = col(3), col(4), col(5)
        e2x, e2y, e2z = col(6), col(7), col(8)
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
              & (u + vv <= det) & (w >= t_min) & (col(13) >= 0))
        if uvs is None:
            return torch.where(ok, w, float("inf")), None

        def winner_uv(rows, ia):
            ub = uvs[blk][ia]                # (n_acc, UV_FLOATS)
            bu = u[rows, ia] * inv_det[rows, ia]
            bv = vv[rows, ia] * inv_det[rows, ia]
            return (ub[:, 0] + bu * ub[:, 2] + bv * ub[:, 4],
                    ub[:, 1] + bu * ub[:, 3] + bv * ub[:, 5], ub[:, 6])
        return torch.where(ok, w, float("inf")), winner_uv

    return sweep_blocks_plain(mt, o, d, t_min, t_cap, hit_test, f2b=f2b,
                              with_uv=with_uv, stats=stats)


def sweep_blocks_plain(mt: MeshTables, o: V3, d: V3, t_min: float,
                       t_cap: torch.Tensor, hit_test, f2b: bool = False,
                       with_uv: bool = False, stats: Optional[dict] = None):
    """The blocked sweep's frame, shared by the plain versions of both
    engines: each block's slab test, then `hit_test(blk, rs, t_best)` on
    the rays `rs` (indices into `o`, `d`) that enter it, which gives the
    (len(rs), B) accepted w (inf where rejected) and, with `with_uv`, a
    callable of the winners' (rows, triangles) returning their (u, v, tex).
    The first of the block's triangles at the least accepted w wins when
    it beats the ray's best, which is what testing them one by one with a
    strict `w < t_best` picks; the winner's (pid, n, mat) are read from
    its table row.

    `stats` (optional dict) counts "slab_tests" (rays with a positive cap,
    times blocks) and "tri_tests" (rays times the real triangles of the
    blocks they enter); with a list under "enter" it also appends the
    call's (n, n_blocks) bool matrix of which ray enters a block at which
    step of its order (`schedule_counts` reads it)."""
    n = o.x.shape[0]
    dev = o.x.device
    tris = mt.tris.to(dev).reshape(mt.n_blocks, mt.block, TRI_FLOATS)
    bb = mt.bb.to(dev)
    real = (tris[:, :, 13] >= 0).sum(dim=1).tolist()
    out = [t_cap.to(torch.float32).clone(),
           torch.full((n,), -1.0, device=dev)] + [
               torch.zeros((n,), device=dev) for _ in range(4)]
    if with_uv:
        out += [torch.zeros((n,), device=dev), torch.zeros((n,), device=dev),
                torch.full((n,), -1.0, device=dev)]
    live = out[0] > t_min
    if f2b:
        octs = _octant(d)
        groups = [(int(g), torch.nonzero(live & (octs == g)).flatten())
                  for g in range(8)]
        orders = mt.f2b.to(dev).tolist()
    else:
        groups = [(None, torch.nonzero(live).flatten())]
        orders = None
    enter = None
    if stats is not None:
        stats["slab_tests"] = (stats.get("slab_tests", 0)
                               + int(live.sum()) * mt.n_blocks)
        if "enter" in stats:
            enter = torch.zeros((n, mt.n_blocks), dtype=torch.bool,
                                device=dev)
            stats["enter"].append(enter)
    for g, rays in groups:
        for c0 in range(0, rays.shape[0], PLAIN_CHUNK):
            r = rays[c0:c0 + PLAIN_CHUNK]
            order = orders[g] if orders is not None else range(mt.n_blocks)
            _sweep_rays(tris, bb, order, real, o, d, t_min, r, out, stats,
                        hit_test, enter)
    return tuple(out)


# The warp sweep's dense-step threshold, `kDenseMin` in csrc/mesh_sweep.cuh
# (a test reads it from there).
DENSE_MIN = 16
WARP = 32


def schedule_counts(enter: torch.Tensor, group: torch.Tensor, block: int,
                    ray_batch: Optional[int] = None) -> dict:
    """Triangle tests that two schedules of the blocked sweep execute, in
    lane slots (a warp's pass over one triangle is 32 slots, busy or idle),
    from the (n, steps) matrix `enter` of `sweep_blocks_plain` and the
    (n,) int64 `group` of each row (the warp and, for the path-tracing
    kernel, the iteration its 32 lanes share):

      - "union": each lane tests its entered block alone, so a group runs
        `block` passes at every step where any of its lanes enters (the
        per-lane sweep that the warp sweep replaced);
      - "coop": the warp sweep (csrc/mesh_sweep.cuh): at a step where
        DENSE_MIN or more lanes enter, `block` passes; below it,
        ceil(block / 32) passes for each entering lane (a pair), each pair
        also paying ~18 shuffles.

    Returns both totals, the pairs and dense steps, and the needed lane
    tests (rows times the block) beside them.  With `ray_batch` (the MXU
    sweep, csrc/mesh_sweep_mxu.cu) every step is cooperative, with no
    dense step, and "coop_batches" counts its batches: ceil(lanes /
    ray_batch) a step, each reading the block's coefficients once."""
    n_groups = int(group.max()) + 1 if group.numel() else 0
    cnt = torch.zeros((n_groups, enter.shape[1]), dtype=torch.int32,
                      device=enter.device)
    cnt.index_add_(0, group, enter.to(torch.int32))
    dense = (cnt >= (DENSE_MIN if ray_batch is None else WARP + 1))
    pairs = int(torch.where(dense, 0, cnt).sum())
    n_dense = int(dense.sum())
    per_pair = -(-block // WARP) * WARP
    out = {"union_slots": int((cnt > 0).sum()) * block * WARP,
           "coop_slots": n_dense * block * WARP + pairs * per_pair,
           "coop_pairs": pairs, "coop_dense_steps": n_dense,
           "entered_slots": int(enter.sum()) * block}
    if ray_batch is not None:
        out["coop_batches"] = int(((cnt + ray_batch - 1) // ray_batch).sum())
    return out


def _sweep_rays(tris, bb, order, real, o, d, t_min, r, out, stats,
                hit_test, enter=None):
    """Sweep the rays `r` (indices) block by block, updating `out` (and
    marking `enter[ray, step]`)."""
    ox, oy, oz = o.x[r], o.y[r], o.z[r]
    inv_dx, inv_dy, inv_dz = _inv(d.x[r]), _inv(d.y[r]), _inv(d.z[r])
    parallel = torch.nonzero(_parallel((inv_dx, inv_dy, inv_dz))).flatten()
    t_best = out[0][r]
    res = [a[r] for a in out[1:]]
    for step, blk in enumerate(order):
        lo, hi = bb[blk, 0:3], bb[blk, 4:7]
        t0x = (lo[0] - ox) * inv_dx
        t1x = (hi[0] - ox) * inv_dx
        t0y = (lo[1] - oy) * inv_dy
        t1y = (hi[1] - oy) * inv_dy
        t0z = (lo[2] - oz) * inv_dz
        t1z = (hi[2] - oz) * inv_dz
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
                lo, hi, (ox[p], oy[p], oz[p]),
                (inv_dx[p], inv_dy[p], inv_dz[p]), t_min, t_best[p])
        s = torch.nonzero(ent).flatten()
        if s.numel() == 0:
            continue
        if enter is not None:
            enter[r[s], step] = True
        if stats is not None:
            stats["tri_tests"] = stats.get("tri_tests", 0) + \
                int(s.numel()) * real[blk]
        w_ok, winner_uv = hit_test(blk, r[s], t_best[s])
        i_best = torch.argmin(w_ok, dim=1)
        w_best = w_ok.gather(1, i_best[:, None])[:, 0]
        acc = w_best < t_best[s]
        if not bool(acc.any()):
            continue
        sa, ia = s[acc], i_best[acc]
        t_best[sa] = w_best[acc]
        for k, j in enumerate((13, 9, 10, 11, 12)):   # pid, n, mat
            res[k][sa] = tris[blk][ia, j]
        if winner_uv is not None:
            for k, v in enumerate(winner_uv(torch.nonzero(acc).flatten(), ia),
                                  start=5):
                res[k][sa] = v
    out[0][r] = t_best
    for a, v in zip(out[1:], res):
        a[r] = v


_bound = None


def _kernels() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        from .. import _build
        lib = _build.load_library()
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nr_mesh_sweep.argtypes = [vp, ci, ci, vp, vp, vp, vp, ci, ci,
                                      ctypes.c_float, vp, vp]
        lib.nr_mesh_sweep.restype = ci
        lib.nr_mesh_layout.argtypes = [ci]
        lib.nr_mesh_layout.restype = ci
        lib.nr_error_string.argtypes = [ci]
        lib.nr_error_string.restype = ctypes.c_char_p
        want = (TRI_FLOATS, UV_FLOATS, BB_FLOATS, RAY_CHANNELS)
        if tuple(lib.nr_mesh_layout(i) for i in range(4)) != want:
            raise RuntimeError("kernel library mesh table layout mismatch")
        _bound = lib
    return _bound


def check_tables(mt: MeshTables, device: torch.device) -> None:
    ok = (mt.tris.dtype == mt.bb.dtype == torch.float32
          and mt.f2b.dtype == torch.int32
          and tuple(mt.tris.shape) == (mt.n_blocks * mt.block, TRI_FLOATS)
          and tuple(mt.bb.shape) == (mt.n_blocks, BB_FLOATS)
          and tuple(mt.f2b.shape) == (8, mt.n_blocks)
          and mt.tris.is_contiguous() and mt.bb.is_contiguous()
          and mt.f2b.is_contiguous() and mt.tris.device == device
          and mt.bb.device == device and mt.f2b.device == device)
    if mt.uvs is not None:
        ok = ok and (mt.uvs.dtype == torch.float32
                     and tuple(mt.uvs.shape) == (mt.n_blocks * mt.block,
                                                 UV_FLOATS)
                     and mt.uvs.is_contiguous() and mt.uvs.device == device)
    if not ok:
        raise ValueError(f"mesh tables must be contiguous float32/int32 "
                         f"tensors of make_mesh_tables' layout on {device}")


def sweep_mesh_full(mt: MeshTables, o: V3, d: V3, t_min: float,
                    t_cap: Optional[torch.Tensor] = None, n_valid=None,
                    f2b: bool = False, with_uv: bool = False):
    """Closest triangle per ray (`mesh_pallas.sweep_mesh_full`, `:503`).
    `t_cap`: per-ray upper bound (hits at or beyond it are not reported; 0
    skips the ray); `n_valid`: only the leading rays are real (the rest
    get a zero cap); `f2b`: near-to-far block order by the ray's octant;
    `with_uv`: also the winner's (u, v, tex) (needs UV tables).

    Returns (t, idx, nx, ny, nz, mat[, u, v, tex]): t = +inf and idx = -1
    (int32) with zero shading on a miss.  Rays on a CUDA device go through
    `mesh_sweep_kernel`, rays on the CPU through `sweep_mesh_plain`.

    The engine select of `mesh_pallas.py:552`: under `NR_MESH_MXU=1` an
    untextured call on a pool with the MXU table takes the bilinear-form
    sweep (`mesh_mxu.sweep_mxu`, natural order, `f2b` ignored as the JAX
    engine ignores it); a textured call stays on this sweep, as the JAX
    package never sends a textured pool to its MXU engine
    (`ENGINE_COUNTS` records each)."""
    n = o.x.shape[0]
    dev = o.x.device
    if with_uv and mt.uvs is None:
        raise ValueError("with_uv needs a mesh with UV tables")
    check_tables(mt, dev)
    cap = (torch.full((n,), float("inf"), device=dev) if t_cap is None
           else t_cap.to(torch.float32))
    if n_valid is not None:
        cap = torch.where(torch.arange(n, device=dev) < int(n_valid), cap,
                          0.0)
    from . import mesh_mxu
    engine = "blocked"
    if mesh_mxu.enabled() and mt.coef is not None:
        engine = "blocked_textured_under_mxu" if with_uv else "mxu"
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    ENGINE_COUNTS[engine] += 1
    if engine == "mxu":
        out = mesh_mxu.sweep_mxu(mt, o, d, t_min, cap)
    elif dev.type == "cuda":
        out = _sweep_cuda(mt, o, d, t_min, cap, f2b, with_uv)
    else:
        out = sweep_mesh_plain(mt, o, d, t_min, cap, f2b=f2b,
                               with_uv=with_uv)
    t, idx = out[0], out[1]
    t = torch.where(idx >= 0, t, float("inf"))
    return (t, idx.to(torch.int32)) + tuple(out[2:])


def _sweep_cuda(mt, o, d, t_min, cap, f2b, with_uv):
    n = o.x.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"too many rays for one launch: {n}")
    lib = _kernels()
    rays = torch.stack([o.x, o.y, o.z, d.x, d.y, d.z, cap]).to(
        torch.float32).contiguous()
    n_out = 9 if with_uv else 6
    out = torch.empty((n_out, n), dtype=torch.float32, device=rays.device)
    with torch.cuda.device(rays.device):
        err = lib.nr_mesh_sweep(
            rays.data_ptr(), n, n_out, mt.tris.data_ptr(),
            mt.uvs.data_ptr() if with_uv else None, mt.bb.data_ptr(),
            mt.f2b.data_ptr() if f2b else None, mt.n_blocks, mt.block,
            float(t_min), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.nr_error_string(err).decode()
        raise RuntimeError(f"{KERNEL_NAME} launch failed: CUDA error {err}: "
                           f"{msg}")
    KERNEL_LAUNCHES[KERNEL_NAME] += 1
    return tuple(out[i] for i in range(n_out))


# The hybrid route's mesh pipe (`mesh_pallas.py:632-996`), with the JAX
# package's defaults as constants: the compacted buffer holds n / 4 rays,
# at least CAP_MIN, rounded up to CAP_ALIGN; wavefronts under
# MESH_COMPACT_MIN rays are swept uncompacted; the entry-cell sort
# quantises the mesh box by CELL_Q per axis.
MESH_COMPACT_FRACTION = 4
MESH_COMPACT_MIN = 64 * 1024
CAP_MIN, CAP_ALIGN = 1024, 4096
CELL_Q = 2

# Which branch each call of `intersect_triangles_mesh` took, and which
# engine each call of `sweep_mesh_full` swept with (the blocked sweep B2,
# the MXU sweep B4, or B2 for a textured call under NR_MESH_MXU=1): a
# caller resets and reads them (the renderers log them).
ROUTE_COUNTS = {"uncompacted": 0, "compacted": 0, "overflow_full_sweeps": 0}
ENGINE_COUNTS = {"blocked": 0, "mxu": 0, "blocked_textured_under_mxu": 0}


def reset_route_counts() -> None:
    for counts in (ROUTE_COUNTS, ENGINE_COUNTS):
        for key in counts:
            counts[key] = 0


def _slab(lo, hi, o: V3, d: V3):
    """(t_near, t_far) of the box [lo, hi] along the rays (the top-level
    test's float order, `mesh_pallas.py:709-719`)."""
    near, far = [], []
    for k, (oo, dd) in enumerate(((o.x, d.x), (o.y, d.y), (o.z, d.z))):
        inv = _inv(dd)
        t0 = (lo[k] - oo) * inv
        t1 = (hi[k] - oo) * inv
        near.append(torch.minimum(t0, t1))
        far.append(torch.maximum(t0, t1))
    return (torch.maximum(torch.maximum(near[0], near[1]), near[2]),
            torch.minimum(torch.minimum(far[0], far[1]), far[2]))


def top_aabb_reach(mt: MeshTables, o: V3, d: V3, t_min: float,
                   t_cap: torch.Tensor):
    """(box min, box max, reach): the pool's top-level AABB and which rays
    can reach it with a hit nearer than their cap (the in-sweep block
    test's rule, `mesh_pallas.py:704-724`).  The rays the parallel recheck
    takes are listed on the host, which waits on the device for them: the
    wait is spanned as `mesh-pipe.reach-wait`."""
    lo, hi = mt.bb[:, 0:3].amin(dim=0), mt.bb[:, 4:7].amax(dim=0)
    t_near, t_far = _slab(lo, hi, o, d)
    reach = ((t_near <= t_far) & (t_far >= t_min)
             & (torch.clamp(t_near, min=t_min) < t_cap))
    inv = (_inv(d.x), _inv(d.y), _inv(d.z))
    with GLOBAL_TIMER.phase("mesh-pipe.reach-wait"):
        p = torch.nonzero(_parallel(inv) & ~reach).flatten()
    if p.numel():
        reach[p] = _enters_parallel(lo, hi, (o.x[p], o.y[p], o.z[p]),
                                    tuple(i[p] for i in inv), t_min,
                                    t_cap[p])
    return lo, hi, reach


def entry_cell_key(lo, hi, o: V3, d: V3, t_min: float) -> torch.Tensor:
    """The sort key of a ray that enters the mesh box: its entry point's
    cell on a CELL_Q^3 grid over the box, times 8, plus its direction
    octant (`mesh_pallas.py:792-812`).  The sort only groups rays that
    sweep the same blocks; it changes no result."""
    t_near, _ = _slab(lo, hi, o, d)
    tn = torch.clamp(t_near, min=t_min)

    def q(v, k):
        cell = ((v - lo[k]) / (hi[k] - lo[k]) * CELL_Q).to(torch.int32)
        return torch.clamp(cell, 0, CELL_Q - 1).to(torch.int64)

    cell = (q(o.x + tn * d.x, 0) * CELL_Q ** 2 + q(o.y + tn * d.y, 1) * CELL_Q
            + q(o.z + tn * d.z, 2))
    return cell * 8 + _octant(d)


def intersect_triangles_mesh(mt: MeshTables, o: V3, d: V3, t_min: float,
                             t_dense: torch.Tensor, mat_channels,
                             alive: Optional[torch.Tensor] = None,
                             sort: bool = True, with_uv: bool = False):
    """The mesh pipe of the hybrid route for a whole wavefront (the stream
    engine of `mesh_pallas.intersect_triangles_mesh`).

    `t_dense`: the dense primitives' hit t per ray (a triangle must beat
    it); `alive`: rays still on their path (the others get a zero cap);
    `sort`: sort the compacted rays by entry cell (the caller passes False
    for the pixel-coherent camera bounce); `with_uv`: also the winner's
    (u, v, tex), which the sweep carries (textured pools).

    In order: the cap is t_dense (0 for dead rays); the mesh's top-level
    AABB culls every ray that cannot reach it or whose cap beats the box
    entry (zeroed cap); a wavefront under MESH_COMPACT_MIN rays is swept
    as it is; otherwise the survivors are packed (B3a) into a buffer of
    n / MESH_COMPACT_FRACTION rays, and when more survive than it holds
    the whole wavefront is swept with the zeroed caps; otherwise the
    packed rays are stably sorted by entry cell over the live prefix,
    swept front to back (B2), unsorted and unpacked (B3b) with the sweep's
    miss values.  Every branch gives each ray the same answer.  The host
    waits on the device twice a call: for the top-level test's parallel
    rays (`mesh-pipe.reach-wait`) and, when it packs, for the pack's count
    (`mesh-pipe.count-wait`); both are spans of `utils/timing.GLOBAL_TIMER`,
    the time the host is held by the device.

    Returns (t, nx, ny, nz, mat, pid, channels) as
    `intersect_triangles_blocked` does (t = inf and pid = -1 on a miss),
    plus ((u, v, tex),) with `with_uv`."""
    n = o.x.shape[0]
    t_cap = t_dense if alive is None else torch.where(alive, t_dense, 0.0)
    cap = max(CAP_MIN, n // MESH_COMPACT_FRACTION)
    cap = max(CAP_MIN, -(-cap // CAP_ALIGN) * CAP_ALIGN)
    lo, hi, reach = top_aabb_reach(mt, o, d, t_min, t_cap)
    t_cap = torch.where(reach, t_cap, 0.0)
    n_hit = None
    if n >= MESH_COMPACT_MIN and cap < n:
        # a surviving ray has t_cap > t_min >= 0, so the pack's mask is
        # `reach`; its count is read on the host: the overflow and the
        # sort window both read it
        sp = stream_compact.stream_pack_channels(
            (o.x, o.y, o.z, d.x, d.y, d.z, t_cap), cap, mask_from=6)
        with GLOBAL_TIMER.phase("mesh-pipe.count-wait"):
            n_hit = int(sp.count)
    if n_hit is not None and n_hit <= cap:
        ROUTE_COUNTS["compacted"] += 1
        out = _compacted_sweep(mt, t_min, t_cap, sp, n_hit, lo, hi, sort,
                               with_uv)
    else:
        ROUTE_COUNTS["uncompacted" if n_hit is None
                     else "overflow_full_sweeps"] += 1
        out = sweep_mesh_full(mt, o, d, t_min, t_cap=t_cap, f2b=True,
                              with_uv=with_uv)
    t, idx, nx, ny, nz, mat = out[:6]
    miss = idx < 0
    pid = torch.where(miss, -1.0, idx.to(torch.float32))
    res = (t, nx, ny, nz, mat, pid, channels_from_mat(mat, miss,
                                                      mat_channels))
    return res + (tuple(out[6:9]),) if with_uv else res


def _compacted_sweep(mt, t_min, t_cap, sp, n_hit, lo, hi, sort, with_uv):
    """Sweep the live prefix of the packed rays `sp` (sorted by entry cell
    when `sort`) and unpack the results to the lanes of `t_cap`."""
    rays, perm = sp.packed[:, :n_hit], None
    if sort and n_hit > 1:
        rays, perm = sort_rays(rays, lo, hi, t_min)
    out = sweep_mesh_full(mt, V3(rays[0], rays[1], rays[2]),
                          V3(rays[3], rays[4], rays[5]), t_min,
                          t_cap=rays[6], f2b=True, with_uv=with_uv)
    if perm is not None:
        out = unsort(out, perm)
    # the sweep's own miss values: t inf, idx -1, zero shading, uv 0, tex -1
    misses = (float("inf"), -1, 0.0, 0.0, 0.0, 0.0) + (
        (0.0, 0.0, -1.0) if with_uv else ())
    return stream_compact.stream_unpack_channels(t_cap, out, misses, sp)


def sort_rays(rays: torch.Tensor, lo, hi, t_min: float):
    """(7, k) packed rays stably sorted by `entry_cell_key`, and the
    permutation (sorted slot -> packed slot)."""
    key = entry_cell_key(lo, hi, V3(rays[0], rays[1], rays[2]),
                         V3(rays[3], rays[4], rays[5]), t_min)
    perm = torch.sort(key, stable=True).indices
    return rays[:, perm], perm


def unsort(out, perm: torch.Tensor) -> list:
    """The sweep's results back in packed-slot order."""
    res = []
    for a in out:
        u = torch.empty_like(a)
        u[perm] = a
        res.append(u)
    return res
