"""The bilinear-form mesh sweep (the MXU engine): CUDA launch wrapper, plain
torch version and launch counter.

Counterpart of the JAX package's `NR_MESH_MXU=1` engine,
`nrenderer_tpu/ops/mesh_pallas.py:259-436` (`sweep_tile_mxu`,
`_sweep_kernel_mxu`): the blocked sweep's result (the closest triangle per
ray against the BVH-preorder blocked pool) with the Moller-Trumbore terms
computed as linear forms.  Per ray, the feature vector

    f = [1, o', d, o' x d]        (o' = origin - the pool's centre)

and per triangle four rows of `bvh.BlockedTris.mxu_coef` give

    det, u, v, t * det  =  sum_k coef[row][k] * f[k],  k = 0 .. 9

summed in that order in float32 (the table's features 10-15 are zero
padding and are dropped).  Then s = det >= 0 ? 1 : -1, ad = det * s, and a
triangle is accepted when ad >= 1e-6, 0 <= u s <= ad, v s >= 0,
u s + v s <= ad, ws >= t_min * ad and ws < t_best * ad (ws = t*det * s,
the block's starting t_best; a NaN compares false); w = ws / ad; the first
triangle at the block's least w wins, and only when w < t_best.  Blocks
are visited in natural order after B2's slab test (`mesh_cuda`), each ray
culling for itself; there is no front-to-back order and no UV output (the
JAX package sends textured pools elsewhere).

`mesh_cuda.sweep_mesh_full` takes this engine under `NR_MESH_MXU=1` for
untextured calls on pools with the table; rays on a CUDA device launch
`mesh_sweep_mxu_kernel` (`csrc/mesh_sweep_mxu.cu`), rays on the CPU run
`sweep_mxu_plain`.  The JAX kernel sums on the TPU's matrix unit at
HIGHEST precision; both forms here sum on float32 units in one fixed order,
so they agree with each other bit for bit and with the JAX route within
its tests' tolerance (`tests/test_torch_mxu_sweep.py`).  The kernel is
warp-cooperative: the rays of a warp that enter a block are tested
against it by the whole warp, RAY_BATCH rays for each triangle a lane
loads, and a reduction per ray picks the serial loop's winner; it reads
the table as `MeshTables.coef_t`."""
from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from .mesh_cuda import (
    BB_FLOATS, RAY_CHANNELS, TRI_FLOATS, MeshTables, sweep_blocks_plain,
)
from .soa import V3

KERNEL_SOURCE = "nrenderer_torch/csrc/mesh_sweep_mxu.cu"
REPLACES = "nrenderer_tpu/ops/mesh_pallas.py:372 _sweep_kernel_mxu"
KERNEL_NAME = "mesh_sweep_mxu_kernel"

# Launches of `mesh_sweep_mxu_kernel` made by `sweep_mxu`: a caller resets
# and reads it to show that a run went through the kernel.
KERNEL_LAUNCHES = {KERNEL_NAME: 0}

N_FEATURES = 10                  # 1, o'xyz, dxyz, (o' x d)xyz
COEF_FLOATS = 4 * N_FEATURES     # det, u, v, t*det rows of one triangle
# Entering rays the kernel tests against each triangle it loads
# (kRayBatch, which the library reports).
RAY_BATCH = 4


def reset_launch_counts() -> None:
    KERNEL_LAUNCHES[KERNEL_NAME] = 0


def enabled() -> bool:
    """The engine switch, read at each sweep as the JAX package reads it."""
    return os.environ.get("NR_MESH_MXU", "0") == "1"


def features(center, o: V3, d: V3) -> list:
    """The per-ray feature columns f[1..9] (f[0] = 1 is implicit)."""
    cx, cy, cz = center
    oxc, oyc, ozc = o.x - cx, o.y - cy, o.z - cz
    return [oxc, oyc, ozc, d.x, d.y, d.z, oyc * d.z - ozc * d.y,
            ozc * d.x - oxc * d.z, oxc * d.y - oyc * d.x]


def sweep_mxu_plain(mt: MeshTables, o: V3, d: V3, t_min: float,
                    t_cap: torch.Tensor, stats: Optional[dict] = None):
    """The MXU kernel's plain torch version on (N,) rays, elementwise in
    the kernel's float order, in the blocked sweep's frame
    (`mesh_cuda.sweep_blocks_plain`, natural order).  Returns (t_best,
    idx, nx, ny, nz, mat): t_best stays at the cap and idx at -1 when no
    triangle beats it; `stats` as there."""
    coef = mt.coef.to(o.x.device).reshape(mt.n_blocks, mt.block, 4,
                                          N_FEATURES)
    feats = features(mt.center, o, d)

    def hit_test(blk, rs, tb):
        """The four forms and the accept tests of block `blk`."""
        fs = [a[rs][:, None] for a in feats]
        cb = coef[blk]                                    # (B, 4, 10)
        rows = []
        for q in range(4):                                # det, u, v, t*det
            acc = cb[:, q, 0][None, :].expand(rs.numel(), -1)
            for k in range(1, N_FEATURES):
                acc = acc + cb[:, q, k][None, :] * fs[k - 1]
            rows.append(acc)
        det, u, v, wp = rows
        sign = torch.where(det >= 0, 1.0, -1.0)
        ad = det * sign
        t1 = u * sign
        t2 = v * sign
        ws = wp * sign
        ok = ((ad >= 1e-6) & (t1 >= 0) & (t1 <= ad) & (t2 >= 0)
              & (t1 + t2 <= ad) & (ws >= t_min * ad)
              & (ws < tb[:, None] * ad))
        w = ws / torch.where(ad == 0, 1.0, ad)
        return torch.where(ok, w, float("inf")), None

    return sweep_blocks_plain(mt, o, d, t_min, t_cap, hit_test, stats=stats)


def check_tables(mt: MeshTables, device: torch.device) -> None:
    ok = (mt.coef is not None and mt.center is not None
          and mt.coef.dtype == torch.float32
          and tuple(mt.coef.shape) == (mt.n_blocks * mt.block, COEF_FLOATS)
          and mt.coef.is_contiguous() and mt.coef.device == device
          and len(mt.center) == 3)
    if not ok:
        raise ValueError(f"the MXU sweep needs a contiguous float32 "
                         f"({mt.n_blocks * mt.block}, {COEF_FLOATS}) "
                         f"coefficient table and a centre on {device}")


def sweep_mxu(mt: MeshTables, o: V3, d: V3, t_min: float,
              cap: torch.Tensor):
    """(t_best, idx, nx, ny, nz, mat) of the rays, the cap already
    applied: `mesh_sweep_mxu_kernel` for rays on a CUDA device, the plain
    version for rays on the CPU (`mesh_cuda.sweep_mesh_full` checks the
    other tables and forms the cap)."""
    dev = o.x.device
    check_tables(mt, dev)
    if dev.type == "cuda":
        return _sweep_mxu_cuda(mt, o, d, t_min, cap)
    if dev.type == "cpu":
        return sweep_mxu_plain(mt, o, d, t_min, cap)
    raise ValueError(f"unsupported device {dev}")


_bound = None


def _kernels() -> ctypes.CDLL:
    global _bound
    if _bound is None:
        from .. import _build
        lib = _build.load_library()
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nr_mesh_sweep_mxu.argtypes = [vp, ci, vp, vp, vp, ci, ci, cf,
                                          cf, cf, cf, vp, vp]
        lib.nr_mesh_sweep_mxu.restype = ci
        lib.nr_mesh_mxu_layout.argtypes = [ci]
        lib.nr_mesh_mxu_layout.restype = ci
        lib.nr_error_string.argtypes = [ci]
        lib.nr_error_string.restype = ctypes.c_char_p
        want = (COEF_FLOATS, TRI_FLOATS, BB_FLOATS, RAY_CHANNELS, RAY_BATCH)
        if tuple(lib.nr_mesh_mxu_layout(i) for i in range(5)) != want:
            raise RuntimeError("kernel library MXU table layout mismatch")
        _bound = lib
    return _bound


def _sweep_mxu_cuda(mt, o, d, t_min, cap):
    n = o.x.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"too many rays for one launch: {n}")
    ct, shape = mt.coef_t, (mt.n_blocks, N_FEATURES, mt.block, 4)
    if (ct is None or ct.dtype != torch.float32 or not ct.is_contiguous()
            or ct.device != o.x.device or tuple(ct.shape) != shape):
        raise ValueError(f"the MXU kernel needs `coef_t` as a contiguous "
                         f"float32 {shape} tensor on {o.x.device}")
    lib = _kernels()
    rays = torch.stack([o.x, o.y, o.z, d.x, d.y, d.z, cap]).to(
        torch.float32).contiguous()
    out = torch.empty((6, n), dtype=torch.float32, device=rays.device)
    cx, cy, cz = (float(c) for c in mt.center)
    with torch.cuda.device(rays.device):
        err = lib.nr_mesh_sweep_mxu(
            rays.data_ptr(), n, mt.tris.data_ptr(), ct.data_ptr(),
            mt.bb.data_ptr(), mt.n_blocks, mt.block, cx, cy, cz,
            float(t_min), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.nr_error_string(err).decode()
        raise RuntimeError(f"{KERNEL_NAME} launch failed: CUDA error {err}: "
                           f"{msg}")
    KERNEL_LAUNCHES[KERNEL_NAME] += 1
    return tuple(out[i] for i in range(6))
