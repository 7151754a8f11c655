// The blocked mesh sweep as a device function: closest triangle for one ray
// against the BVH-preorder blocked triangle pool.
//
// Replaces the body of the TPU kernel nrenderer_tpu/ops/mesh_pallas.py:439
// _sweep_kernel (its shared engine sweep_tile, :72-256).  Two callers
// inline it: mesh_sweep_kernel (csrc/mesh_sweep.cu, the standalone sweep
// behind nrenderer_torch/ops/mesh_cuda.sweep_mesh_full) and the mesh form of
// the path-tracing kernel (csrc/pt_kernel.cu, pt_mesh_kernel<kTex>),
// which runs it in every bounce with the dense hit's t as the cap.
//
// The contract, in sweep_tile's float order (the plain torch version
// mesh_cuda.sweep_mesh_plain repeats it): inv_d = 1 / (|d| < 1e-20 ? 1e-20 :
// d); a block is entered when (t_near <= t_far) && (t_far >= t_min) &&
// (max(t_near, t_min) < t_best); Moller-Trumbore with the det-sign fold,
// w = (e2 . q) * inv_det, accepted when det >= 1e-6, 0 <= u <= det, v >= 0,
// u + v <= det, t_min <= w < t_best and pid >= 0; with UV tables the
// winner's (u, v) is uv1 + bu * ue1 + bv * ue2 with bu = u * inv_det.  The
// best t starts at the cap and stays there on a miss (idx -1).
//
// Design for the H100: a warp sweeps 32 rays, one a lane (warp_sweep).
// Pallas culls a block for a whole 32x128 ray tile; here each ray culls
// for itself, so only the blocks a ray's own slab test enters are tested
// for it (results differ from the tile cull only where a hit lies on a
// block's AABB face within rounding).  A ray parallel to an axis (|d| <
// 1e-20) whose origin lies on the box's far face along it gets t_far = 0
// from the slab, which would drop the block; the tile cull tests it when
// another ray of the tile enters, and here enters_block rechecks such rays
// with that axis bounding nothing while the origin lies within the box's
// extent, faces included (enters_parallel).  A lane that tests its entered
// block alone makes the whole warp wait for its 128 serial tests while
// the lanes that did not enter idle (0.5 to 4 entered blocks a ray against
// up to 40 blocks on the paths), and in front-to-back order the lanes'
// rows differ, so their loads are a gather.  So where few lanes enter a
// block at a step, the warp tests each entering lane's block together,
// a triangle a lane, and reduces to the winner: one block costs block / 32
// tests a lane and the rows are read as 32 consecutive 64-byte rows.
// Where many lanes enter, each tests alone as before.  The triangle table
// stays in global memory (5120 triangles x 64 bytes is 320 KB, past a
// block's shared memory), read through L1.  Bound: FP32 issue, ~53
// operations per triangle test and ~26 per block slab test (chip_smoke.py
// counts them), times the tests the rays need.  No sub-block gating (it
// never changes a result).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace nr_mesh {

// Row layouts, float32; nrenderer_torch/ops/mesh_cuda.make_mesh_tables
// writes the same.
constexpr int TRI_FLOATS = 16;  // v1[3] e1[3] e2[3] n[3] mat pid, 2 pad
constexpr int UV_FLOATS = 8;    // uv1[2] ue1[2] ue2[2] tex, 1 pad
constexpr int BB_FLOATS = 8;    // min[3], pad, max[3], pad

struct MeshArgs {
  const float4* tris;  // (n_blocks * block) rows of TRI_FLOATS
  const float4* uvs;   // (n_blocks * block) rows of UV_FLOATS, or null
  const float4* bb;    // n_blocks rows of BB_FLOATS
  const int* order;    // (8, n_blocks) near-to-far block orders, or null
  int n_blocks, block;
};

struct SweepHit {
  float t;    // the cap on a miss
  float idx;  // the winner's pid, -1 on a miss
  float nx, ny, nz, mat;
  float u, v, tex;  // with UV tables; 0, 0, -1 on a miss
};

// 1 / d of one axis, a component under 1e-20 in magnitude taken as 1e-20.
__device__ __forceinline__ float inv_axis(const float x) {
  return 1.0f / (fabsf(x) < 1e-20f ? 1e-20f : x);
}

// |1 / d| of an axis the ray runs parallel to (inv_axis of |d| <= 1e-20).
constexpr float kInvParallel = 1.0f / 1e-20f;

// Whether the ray runs parallel to an axis: the rare rays enters_block
// rechecks.
__device__ __forceinline__ bool ray_parallel(const float inv_dx,
                                             const float inv_dy,
                                             const float inv_dz) {
  return fabsf(inv_dx) == kInvParallel || fabsf(inv_dy) == kInvParallel ||
         fabsf(inv_dz) == kInvParallel;
}

// One axis of enters_parallel: a parallel axis bounds nothing while the
// origin lies within [lo, hi] and culls otherwise; another axis narrows
// [t_near, t_far] as the slab test does.
__device__ __forceinline__ bool parallel_axis(const float lo, const float hi,
                                              const float o, const float inv,
                                              float& t_near, float& t_far) {
  if (fabsf(inv) == kInvParallel) return lo <= o && o <= hi;
  const float t0 = (lo - o) * inv;
  const float t1 = (hi - o) * inv;
  t_near = fmaxf(t_near, fminf(t0, t1));
  t_far = fminf(t_far, fmaxf(t0, t1));
  return true;
}

// The slab test of a ray parallel to an axis (mesh_cuda._enters_parallel
// repeats it).
__device__ __forceinline__ bool enters_parallel(
    const float4 lo, const float4 hi, const float ox, const float oy,
    const float oz, const float inv_dx, const float inv_dy,
    const float inv_dz, const float t_min, const float t_best) {
  float t_near = -INFINITY, t_far = INFINITY;
  const bool inside = parallel_axis(lo.x, hi.x, ox, inv_dx, t_near, t_far) &
                      parallel_axis(lo.y, hi.y, oy, inv_dy, t_near, t_far) &
                      parallel_axis(lo.z, hi.z, oz, inv_dz, t_near, t_far);
  return inside && (t_near <= t_far) && (t_far >= t_min) &&
         (fmaxf(t_near, t_min) < t_best);
}

// The block slab test of both sweeps: the ray (o, 1/d) enters the AABB of
// block `blk` (rows 2 blk and 2 blk + 1 of `bb`) at or past t_min and before
// its best hit so far.  A ray parallel to an axis that fails it is
// rechecked by enters_parallel (tested here, a block at a time, so that no
// flag stays live across the sweep: a per-ray flag cost the mesh kernel
// 8 B of spill on an H100).
__device__ __forceinline__ bool enters_block(
    const float4* bb, const int blk, const float ox, const float oy,
    const float oz, const float inv_dx, const float inv_dy,
    const float inv_dz, const float t_min, const float t_best) {
  const float4 lo = bb[2 * blk];
  const float4 hi = bb[2 * blk + 1];
  const float t0x = (lo.x - ox) * inv_dx;
  const float t1x = (hi.x - ox) * inv_dx;
  const float t0y = (lo.y - oy) * inv_dy;
  const float t1y = (hi.y - oy) * inv_dy;
  const float t0z = (lo.z - oz) * inv_dz;
  const float t1z = (hi.z - oz) * inv_dz;
  const float t_near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fminf(t0z, t1z));
  const float t_far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                            fmaxf(t0z, t1z));
  const bool enters = (t_near <= t_far) && (t_far >= t_min) &&
                      (fmaxf(t_near, t_min) < t_best);
  if (enters || !ray_parallel(inv_dx, inv_dy, inv_dz)) return enters;
  return enters_parallel(lo, hi, ox, oy, oz, inv_dx, inv_dy, inv_dz, t_min,
                         t_best);
}

// One Moller-Trumbore test of the ray against the triangle row `r` (four
// float4: v1x v1y v1z e1x | e1y e1z e2x e2y | e2z nx ny nz | mat pid):
// its w when accepted (t_min <= w < t_best, pid >= 0), else +inf, which no
// comparison with a best can let win (a NaN w is rejected by w >= t_min).
// `u`, `vv` and `inv_det` are the winner's barycentric terms for the UV
// interpolation.
__device__ __forceinline__ float tri_hit(
    const float4* __restrict__ r, const float ox, const float oy,
    const float oz, const float dx, const float dy, const float dz,
    const float t_min, const float t_best, float& u, float& vv,
    float& inv_det) {
  const float4 a = r[0];  // v1x v1y v1z e1x
  const float4 b = r[1];  // e1y e1z e2x e2y
  const float e2z = r[2].x;
  const float pid = r[3].y;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w;
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det0 = e1x * px + e1y * py + e1z * pz;
  const float sign = det0 > 0.0f ? 1.0f : -1.0f;
  const float det = det0 * sign;
  const float tx = (ox - a.x) * sign;
  const float ty = (oy - a.y) * sign;
  const float tz = (oz - a.z) * sign;
  u = tx * px + ty * py + tz * pz;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  vv = dx * qx + dy * qy + dz * qz;
  inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
  const float w = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  const bool ok = (det >= 1e-6f) && (u >= 0.0f) && (u <= det) &&
                  (vv >= 0.0f) && (u + vv <= det) && (w >= t_min) &&
                  (w < t_best) && (pid >= 0.0f);
  return ok ? w : INFINITY;
}

// The winner `i` of block `blk` at `w` becomes the ray's best: its shading
// from its row and, with UV tables, its (u, v, tex).
template <bool kUv>
__device__ __forceinline__ void take_hit(const MeshArgs& m, const int blk,
                                         const int i, const float w,
                                         const float u, const float vv,
                                         const float inv_det, SweepHit& h) {
  const size_t k = (size_t)blk * m.block + i;
  const float4 c = m.tris[4 * k + 2];  // e2z nx ny nz
  const float4 e = m.tris[4 * k + 3];  // mat pid
  h.t = w;
  h.idx = e.y;
  h.nx = c.y;
  h.ny = c.z;
  h.nz = c.w;
  h.mat = e.x;
  if constexpr (kUv) {
    const float4 f = m.uvs[2 * k];
    const float4 g = m.uvs[2 * k + 1];
    const float bu = u * inv_det;
    const float bv = vv * inv_det;
    h.u = f.x + bu * f.z + bv * g.x;
    h.v = f.y + bu * f.w + bv * g.y;
    h.tex = g.z;
  }
}

// Lanes of a warp that enter a block at one step: at or above this count
// each entering lane tests its block alone (the dense step: `block` serial
// tests, the warp busy once for all of them); below it the warp tests
// each entering lane's block together (the sparse step: block / 32 tests
// a lane, plus ~18 shuffles, per entering lane).  Chosen on an H100 80GB
// HBM3 at 700 W with tools/torch_ab.py --mesh --dense-min (PERF.md):
// against 24 in the same call, 16 ran B1e's 33-spp launch in 34.86 ms
// (35.08-35.12), the textured grid's launch in 3.89 ms (4.15-4.16), B2 on
// 2048 front-to-back rays in 0.125 ms (0.161-0.189) and tied elsewhere;
// 32 was slower on every mesh form.
constexpr int kDenseMin = 16;

constexpr unsigned kFullMask = 0xffffffffu;

// Sweep one ray per lane; all 32 lanes of the warp call it converged, each
// with its own ray, a lane without one with a zero cap (no w satisfies
// t_min <= w < t_cap: it only helps the others).  `oct` >= 0 visits blocks
// in order[oct] (the ray's direction octant), -1 in natural order.
//
// At step s each lane slab-tests its s-th block against its running best
// and the warp ballots the lanes that enter.  Fewer than kDenseMin: for
// each entering lane in turn, its ray, best and block go to every lane,
// lane j tests triangles j, j + 32, ... of that block, a warp reduction
// takes the least accepted w and, among equal w, the lowest triangle, and
// the owner takes it if w beats its best strictly.  That is the winner a
// serial w < t_best loop over the block picks (the first at the least w),
// so every (lane, block) pair gives the serial sweep's result bit for bit.
template <bool kUv>
__device__ __forceinline__ void warp_sweep(const MeshArgs& m, const float ox,
                                           const float oy, const float oz,
                                           const float dx, const float dy,
                                           const float dz, const float t_min,
                                           const float t_cap, const int oct,
                                           SweepHit& h) {
  h.t = t_cap;
  h.idx = -1.0f;
  h.nx = h.ny = h.nz = h.mat = 0.0f;
  h.u = h.v = 0.0f;
  h.tex = -1.0f;
  const bool live = t_cap > t_min;
  if (__ballot_sync(kFullMask, live) == 0u) return;
  const int lane = threadIdx.x & 31;
  const float inv_dx = inv_axis(dx), inv_dy = inv_axis(dy),
              inv_dz = inv_axis(dz);
  for (int s = 0; s < m.n_blocks; ++s) {
    const int blk = oct >= 0 ? m.order[oct * m.n_blocks + s] : s;
    const bool enters = live && enters_block(m.bb, blk, ox, oy, oz, inv_dx,
                                             inv_dy, inv_dz, t_min, h.t);
    unsigned todo = __ballot_sync(kFullMask, enters);
    if (todo == 0u) continue;
    if (__popc(todo) >= kDenseMin) {  // dense step: each lane alone
      if (enters) {
        const float4* __restrict__ row = m.tris + (size_t)blk * m.block * 4;
        for (int i = 0; i < m.block; ++i) {
          float u, vv, inv_det;
          const float w = tri_hit(row + 4 * i, ox, oy, oz, dx, dy, dz, t_min,
                                  h.t, u, vv, inv_det);
          if (w < h.t) take_hit<kUv>(m, blk, i, w, u, vv, inv_det, h);
        }
      }
      continue;
    }
    while (todo != 0u) {  // sparse step: the warp tests each lane's block
      const int src = __ffs(todo) - 1;
      todo &= todo - 1u;
      const float sox = __shfl_sync(kFullMask, ox, src);
      const float soy = __shfl_sync(kFullMask, oy, src);
      const float soz = __shfl_sync(kFullMask, oz, src);
      const float sdx = __shfl_sync(kFullMask, dx, src);
      const float sdy = __shfl_sync(kFullMask, dy, src);
      const float sdz = __shfl_sync(kFullMask, dz, src);
      const float st = __shfl_sync(kFullMask, h.t, src);
      const int sblk = __shfl_sync(kFullMask, blk, src);
      const float4* __restrict__ row = m.tris + (size_t)sblk * m.block * 4;
      float bw = INFINITY;
      int bi = m.block;
      for (int i = lane; i < m.block; i += 32) {
        float u, vv, inv_det;
        const float w = tri_hit(row + 4 * i, sox, soy, soz, sdx, sdy, sdz,
                                t_min, st, u, vv, inv_det);
        if (w < bw) {  // strict: the lane's first at its least w
          bw = w;
          bi = i;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ow = __shfl_xor_sync(kFullMask, bw, off);
        const int oi = __shfl_xor_sync(kFullMask, bi, off);
        if (ow < bw || (ow == bw && oi < bi)) {
          bw = ow;
          bi = oi;
        }
      }
      if (lane == src && bw < h.t) {
        // the winner's barycentric terms, recomputed on the owner's own
        // ray with the same operations: the same bits
        float u = 0.0f, vv = 0.0f, inv_det = 0.0f;
        if constexpr (kUv) {
          tri_hit(row + 4 * bi, ox, oy, oz, dx, dy, dz, t_min, h.t, u, vv,
                  inv_det);
        }
        take_hit<kUv>(m, blk, bi, bw, u, vv, inv_det, h);
      }
    }
  }
}

}  // namespace nr_mesh
