"""BVH build and the BVH-preorder blocked triangle pool, on the host.

Counterpart of the numpy half of `nrenderer_tpu/ops/bvh.py`, which rebuilds
the acc_path_tracing BVH (`acc_path_tracing/include/BVH.hpp:18-223`):

  - `build_bvh`: midpoint-median object split on the max-extent axis of the
    centroid bounds, stable sort, 1-primitive leaves, flattened in
    depth-first preorder with escape indices: the host library's C++
    builder (`native/nrnative.cpp`), or its numpy version here with
    `use_native=False` or under NR_NO_NATIVE=1.  The same arrays as the
    JAX package's numpy builder and its native one.
  - `pack_blocked_triangles`: the valid triangles in BVH-preorder leaf
    order, chunked into blocks of `block` (128), with per-block and
    per-sub-block AABBs, per-octant front-to-back block orders, the UV
    tables of textured faces and the bilinear coefficient table of the
    MXU sweep (`ops/mesh_mxu.py`).
  - `intersect_triangles_blocked`: the blocked sweep as torch ops over
    (N,) ray tensors, with no culling: the oracle the sweep kernel
    (`ops/mesh_cuda.py`) is held against.

Everything but the oracle is numpy: scene set-up, not render time."""
from __future__ import annotations

import sys
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import native
from .soa import V3


def build_bvh(bb_min: np.ndarray, bb_max: np.ndarray, use_native: bool = True
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Build from per-primitive AABBs; returns flat (bb_min, bb_max, skip,
    prim) numpy arrays in depth-first preorder (`prim` -1 at internal
    nodes; `skip` the node after the subtree).  `use_native`: the host
    library's builder (unless NR_NO_NATIVE=1), else the numpy version
    below, its plain version."""
    n = bb_min.shape[0]
    if n == 0:
        return (np.zeros((1, 3), np.float32), np.zeros((1, 3), np.float32),
                np.ones((1,), np.int32), np.full((1,), -1, np.int32))
    if use_native and not native.disabled():
        return native.build_bvh(np.asarray(bb_min, np.float32),
                                np.asarray(bb_max, np.float32))
    centroid = (bb_min + bb_max) * 0.5

    out_min, out_max, out_skip, out_prim = [], [], [], []

    def emit(mn, mx, prim):
        out_min.append(mn)
        out_max.append(mx)
        out_skip.append(-1)   # patched after subtree emission
        out_prim.append(prim)
        return len(out_prim) - 1

    def recurse(idx: np.ndarray) -> None:
        mn = bb_min[idx].min(axis=0)
        mx = bb_max[idx].max(axis=0)
        if idx.shape[0] == 1:
            node = emit(mn, mx, int(idx[0]))
            out_skip[node] = node + 1
            return
        node = emit(mn, mx, -1)
        axis = int(np.argmax(mx - mn))
        order = np.argsort(centroid[idx, axis], kind="stable")
        idx = idx[order]
        half = idx.shape[0] // 2
        recurse(idx[:half])
        recurse(idx[half:])
        out_skip[node] = len(out_prim)

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 64))
    try:
        recurse(np.arange(n))
    finally:
        sys.setrecursionlimit(old_limit)

    return (np.asarray(out_min, np.float32), np.asarray(out_max, np.float32),
            np.asarray(out_skip, np.int32), np.asarray(out_prim, np.int32))


class BlockedTris(NamedTuple):
    """The valid triangle pool in BVH-preorder blocks, host numpy.  Each
    per-triangle field is (n_blocks, B) float32; padding slots repeat the
    last triangle with pid -1 (never accepted)."""
    v1x: np.ndarray
    v1y: np.ndarray
    v1z: np.ndarray
    e1x: np.ndarray
    e1y: np.ndarray
    e1z: np.ndarray
    e2x: np.ndarray
    e2y: np.ndarray
    e2z: np.ndarray
    nx: np.ndarray
    ny: np.ndarray
    nz: np.ndarray
    mat: np.ndarray        # material id as float
    pid: np.ndarray        # original triangle index as float, -1 = padding
    channels: np.ndarray   # (K, n_blocks, B) the material's channels
    bb_min: np.ndarray     # (n_blocks, 3) block AABBs
    bb_max: np.ndarray
    # (n_blocks, n_sub, 3) AABBs of consecutive B // n_sub triangle runs;
    # all-padding runs get empty boxes (+inf / -inf)
    sb_min: np.ndarray
    sb_max: np.ndarray
    # (8, n_blocks) int32: row o = blocks near to far along direction
    # octant o (bit 2/1/0 = d.x/y/z > 0)
    f2b_ord: np.ndarray
    # (n_blocks, 4 * B, 16) float32: the Moller-Trumbore terms of each
    # triangle as linear forms in the ray feature f = [1, o', d, o' x d,
    # 0 x 6], o' = origin - mxu_center.  Rows [0, B) of a block give det,
    # [B, 2B) u, [2B, 3B) v, [3B, 4B) t * det; padding slots are all zero
    mxu_coef: Optional[np.ndarray] = None
    mxu_center: Optional[tuple] = None   # the pool box's centre, 3 floats
    # UV tables, None when no valid face carries a map: uv at v1, the uv
    # edges and the face's diffuse texture id (the specular map's id rides
    # the material channels)
    uv1x: Optional[np.ndarray] = None
    uv1y: Optional[np.ndarray] = None
    ue1x: Optional[np.ndarray] = None
    ue1y: Optional[np.ndarray] = None
    ue2x: Optional[np.ndarray] = None
    ue2y: Optional[np.ndarray] = None
    tex: Optional[np.ndarray] = None

    @property
    def block(self) -> int:
        return self.v1x.shape[1]

    @property
    def n_blocks(self) -> int:
        return self.v1x.shape[0]


TRI_FIELDS = ("v1x", "v1y", "v1z", "e1x", "e1y", "e1z", "e2x", "e2y", "e2z",
              "nx", "ny", "nz", "mat", "pid")
UV_FIELDS = ("uv1x", "uv1y", "ue1x", "ue1y", "ue2x", "ue2y", "tex")


def pack_blocked_triangles(scene_arrays, mat_channels, block: int = 128,
                           sub: int = 32) -> BlockedTris:
    """Chunk the valid triangle pool into BVH-preorder blocks of `block`
    (`nrenderer_tpu/ops/bvh.py:362`)."""
    a = scene_arrays
    v1 = np.asarray(a.tri_v1, np.float32)
    e1 = np.asarray(a.tri_e1, np.float32)
    e2 = np.asarray(a.tri_e2, np.float32)
    nrm = np.asarray(a.tri_normal, np.float32)
    mat = np.asarray(a.tri_mat, np.int64)
    valid = np.asarray(a.tri_valid)

    # order by BVH preorder leaves for spatial coherence
    idx = np.nonzero(valid)[0]
    v2 = v1 + e1
    v3 = v1 + e2
    bmn = np.minimum(np.minimum(v1, v2), v3)[idx]
    bmx = np.maximum(np.maximum(v1, v2), v3)[idx]
    _, _, _, prim = build_bvh(bmn, bmx)
    order = idx[prim[prim >= 0]]

    t = order.shape[0]
    n_blocks = -(-t // block)
    pad = n_blocks * block - t
    order_p = np.concatenate([order, np.repeat(order[-1:], pad)])
    pid = np.concatenate([order, np.full((pad,), -1, np.int64)])

    k = len(mat_channels[0]) if mat_channels else 0
    chan_table = np.asarray(mat_channels, np.float32).reshape(-1, k)
    channels = chan_table[mat[order_p]].T if k else np.zeros(
        (0, t + pad), np.float32)

    def blk(arr):
        return np.ascontiguousarray(arr[order_p].reshape(n_blocks, block))

    tri_mn = np.minimum(np.minimum(v1, v2), v3)[order_p].reshape(
        n_blocks, block, 3)
    tri_mx = np.maximum(np.maximum(v1, v2), v3)[order_p].reshape(
        n_blocks, block, 3)
    mn = tri_mn.min(axis=1)
    mx = tri_mx.max(axis=1)
    sub = max(1, min(sub, block))
    n_sub = -(-block // sub)
    pad_sub = n_sub * sub - block
    is_pad = (pid < 0).reshape(n_blocks, block, 1)
    smn = np.where(is_pad, np.inf, tri_mn)
    smx = np.where(is_pad, -np.inf, tri_mx)
    if pad_sub:
        smn = np.concatenate(
            [smn, np.full((n_blocks, pad_sub, 3), np.inf)], axis=1)
        smx = np.concatenate(
            [smx, np.full((n_blocks, pad_sub, 3), -np.inf)], axis=1)
    sb_mn = smn.reshape(n_blocks, n_sub, sub, 3).min(axis=2)
    sb_mx = smx.reshape(n_blocks, n_sub, sub, 3).max(axis=2)

    uv_kw = {}
    tex_col = np.asarray(getattr(a, "tri_tex", np.full(v1.shape[0], -1)),
                         np.float32)
    stex_col = np.asarray(getattr(a, "tri_stex", np.full(v1.shape[0], -1)),
                          np.float32)
    # faces carrying either map need interpolated UVs
    if (tex_col[valid] >= 0).any() or (stex_col[valid] >= 0).any():
        uv1 = np.asarray(a.tri_uv1, np.float32)
        ue1 = np.asarray(a.tri_uve1, np.float32)
        ue2 = np.asarray(a.tri_uve2, np.float32)
        uv_kw = dict(uv1x=blk(uv1[:, 0]), uv1y=blk(uv1[:, 1]),
                     ue1x=blk(ue1[:, 0]), ue1y=blk(ue1[:, 1]),
                     ue2x=blk(ue2[:, 0]), ue2y=blk(ue2[:, 1]),
                     tex=blk(tex_col))

    # the MXU sweep's bilinear coefficients (`bvh.py:440-457`): det, u, v
    # and t * det are linear in f = [1, o', d, o' x d] with o' centred on
    # the pool's box, which bounds the cancellation at world coordinates
    #   det   = (e2 x e1) . d
    #   u     = e2 . (o' x d) + (v1' x e2) . d
    #   v     = -e1 . (o' x d) + (e1 x v1') . d
    #   t*det = (e1 x e2) . o' - v1' . (e1 x e2)
    center = ((mn.min(axis=0) + mx.max(axis=0)).astype(np.float32)
              * np.float32(0.5))
    v1o, e1o, e2o = v1[order_p], e1[order_p], e2[order_p]
    v1c = (v1o - center).astype(np.float32)
    n12 = np.cross(e1o, e2o)
    coef = np.zeros((t + pad, 4, 16), np.float32)
    coef[:, 0, 4:7] = np.cross(e2o, e1o)
    coef[:, 1, 4:7] = np.cross(v1c, e2o)
    coef[:, 1, 7:10] = e2o
    coef[:, 2, 4:7] = np.cross(e1o, v1c)
    coef[:, 2, 7:10] = -e1o
    coef[:, 3, 0] = -(v1c * n12).sum(axis=-1)
    coef[:, 3, 1:4] = n12
    coef[pid < 0] = 0.0   # padding: det 0 fails the 1e-6 test
    coef = coef.reshape(n_blocks, block, 4, 16).transpose(
        0, 2, 1, 3).reshape(n_blocks, 4 * block, 16)

    # per-octant front-to-back block orders
    cent = (mn + mx) * 0.5
    f2b = np.zeros((8, n_blocks), np.int32)
    for o in range(8):
        s = np.array([1.0 if o & 4 else -1.0, 1.0 if o & 2 else -1.0,
                      1.0 if o & 1 else -1.0], np.float32)
        f2b[o] = np.argsort(cent @ s, kind="stable").astype(np.int32)

    return BlockedTris(
        v1x=blk(v1[:, 0]), v1y=blk(v1[:, 1]), v1z=blk(v1[:, 2]),
        e1x=blk(e1[:, 0]), e1y=blk(e1[:, 1]), e1z=blk(e1[:, 2]),
        e2x=blk(e2[:, 0]), e2y=blk(e2[:, 1]), e2z=blk(e2[:, 2]),
        nx=blk(nrm[:, 0]), ny=blk(nrm[:, 1]), nz=blk(nrm[:, 2]),
        mat=blk(mat.astype(np.float32)),
        pid=pid.astype(np.float32).reshape(n_blocks, block),
        channels=np.ascontiguousarray(channels.reshape(-1, n_blocks, block)),
        bb_min=np.asarray(mn, np.float32), bb_max=np.asarray(mx, np.float32),
        sb_min=np.asarray(sb_mn, np.float32),
        sb_max=np.asarray(sb_mx, np.float32),
        f2b_ord=f2b, mxu_coef=np.ascontiguousarray(coef),
        mxu_center=tuple(float(c) for c in center), **uv_kw)


class MeshAccel(NamedTuple):
    """The mesh bundle the renderers hand to the mesh forms: the blocked
    triangle pool (`nrenderer_tpu/ops/bvh.py:483`, whose flat per-triangle
    pool serves only the JAX package's XLA engines)."""
    bt: BlockedTris


def build_mesh_accel(scene_arrays, mat_channels, block: int = 128
                     ) -> MeshAccel:
    return MeshAccel(bt=pack_blocked_triangles(scene_arrays, mat_channels,
                                               block=block))


def intersect_triangles_blocked(bt: BlockedTris, o: V3, d: V3,
                                t_min: float = 1e-6, with_uv: bool = False):
    """Closest triangle hit by the blocked sweep over every triangle, no
    culling (`nrenderer_tpu/ops/bvh.py:503`, the JAX function's float
    order, which divides by det where the sweep kernel multiplies by its
    inverse).  Returns (t, nx, ny, nz, mat_id, prim_id, channels tuple);
    t = +inf on a miss.  With `with_uv` (and UV tables) the winner's
    (u, v, tex) follows."""
    n = o.x.shape[0]
    dev = o.x.device
    k = bt.channels.shape[0]
    with_uv = with_uv and bt.tex is not None
    tab = {f: torch.as_tensor(getattr(bt, f), device=dev)
           for f in TRI_FIELDS + (UV_FIELDS if with_uv else ())}
    chans_t = torch.as_tensor(bt.channels, device=dev)
    zeros = torch.zeros((n,), dtype=torch.float32, device=dev)
    t_best = torch.full((n,), float("inf"), device=dev)
    bnx, bny, bnz, bmat = zeros, zeros, zeros, zeros
    bpid = torch.full((n,), -1.0, device=dev)
    bch = tuple(zeros for _ in range(k))
    buv = (zeros, zeros, torch.full((n,), -1.0, device=dev))
    for blk in range(bt.n_blocks):
        r = {f: tab[f][blk] for f in tab}
        for i in range(bt.block):
            g = {f: float(r[f][i]) for f in r}
            px = d.y * g["e2z"] - d.z * g["e2y"]
            py = d.z * g["e2x"] - d.x * g["e2z"]
            pz = d.x * g["e2y"] - d.y * g["e2x"]
            det0 = g["e1x"] * px + g["e1y"] * py + g["e1z"] * pz
            sign = torch.where(det0 > 0, 1.0, -1.0)
            det = det0 * sign
            tx = (o.x - g["v1x"]) * sign
            ty = (o.y - g["v1y"]) * sign
            tz = (o.z - g["v1z"]) * sign
            u = tx * px + ty * py + tz * pz
            qx = ty * g["e1z"] - tz * g["e1y"]
            qy = tz * g["e1x"] - tx * g["e1z"]
            qz = tx * g["e1y"] - ty * g["e1x"]
            vv = d.x * qx + d.y * qy + d.z * qz
            safe = torch.where(det == 0, 1.0, det)
            w = (g["e2x"] * qx + g["e2y"] * qy + g["e2z"] * qz) / safe
            ok = ((det >= 1e-6) & (u >= 0) & (u <= det) & (vv >= 0)
                  & (u + vv <= det) & (w >= t_min) & (w < t_best)
                  & (g["pid"] >= 0))
            t_best = torch.where(ok, w, t_best)
            bnx = torch.where(ok, g["nx"], bnx)
            bny = torch.where(ok, g["ny"], bny)
            bnz = torch.where(ok, g["nz"], bnz)
            bmat = torch.where(ok, g["mat"], bmat)
            bpid = torch.where(ok, g["pid"], bpid)
            bch = tuple(torch.where(ok, chans_t[j, blk, i], bch[j])
                        for j in range(k))
            if with_uv:
                inv_det = 1.0 / safe
                b1 = u * inv_det
                b2 = vv * inv_det
                buv = (torch.where(ok, g["uv1x"] + b1 * g["ue1x"]
                                   + b2 * g["ue2x"], buv[0]),
                       torch.where(ok, g["uv1y"] + b1 * g["ue1y"]
                                   + b2 * g["ue2y"], buv[1]),
                       torch.where(ok, g["tex"], buv[2]))
    if with_uv:
        return t_best, bnx, bny, bnz, bmat, bpid, bch, buv
    return t_best, bnx, bny, bnz, bmat, bpid, bch
