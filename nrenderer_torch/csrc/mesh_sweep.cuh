// The blocked mesh sweep as a device function: closest triangle for one ray
// against the BVH-preorder blocked triangle pool.
//
// Replaces the body of the TPU kernel nrenderer_tpu/ops/mesh_pallas.py:439
// _sweep_kernel (its shared engine sweep_tile, :72-256).  Two callers
// inline it: mesh_sweep_kernel (csrc/mesh_sweep.cu, the standalone sweep
// behind nrenderer_torch/ops/mesh_cuda.sweep_mesh_full) and the mesh form of
// the path-tracing kernel (csrc/pt_kernel.cu, pt_kernel<.., kMesh, ..>),
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
// Design for the H100: one thread is one ray.  Pallas culls a block for a
// whole 32x128 ray tile; here each ray culls for itself, so a ray only
// tests the triangles of the blocks its own slab test enters (results
// differ from the tile cull only where a hit lies on a block's AABB face
// within rounding).  The triangle table stays in global memory (5120
// triangles x 64 bytes is 320 KB, past a block's shared memory): a triangle
// row is 16 floats, read as four aligned float4 loads, and the lanes of a
// warp that sweep the same block read the same row at once, so the loads
// are broadcasts served from L1.  Bound: FP32 issue, ~40 operations per
// triangle test and ~18 per block slab test, times the tests that the rays
// need; warps diverge where their rays enter different blocks.  No
// sub-block gating (it never changes a result).
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

// The block slab test of both sweeps: the ray (o, 1/d) enters the AABB of
// block `blk` (rows 2 blk and 2 blk + 1 of `bb`) at or past t_min and before
// its best hit so far.
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
  return (t_near <= t_far) && (t_far >= t_min) &&
         (fmaxf(t_near, t_min) < t_best);
}

// Sweep one ray.  `oct` >= 0 visits blocks in order[oct] (the ray's
// direction octant), -1 in natural order.
template <bool kUv>
__device__ __forceinline__ void mesh_sweep(const MeshArgs& m, const float ox,
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
  // no w satisfies t_min <= w < t_cap: nothing to test (a dead or padded
  // ray's zero cap)
  if (!(t_cap > t_min)) return;
  const float inv_dx = inv_axis(dx), inv_dy = inv_axis(dy),
              inv_dz = inv_axis(dz);
  for (int s = 0; s < m.n_blocks; ++s) {
    const int blk = oct >= 0 ? m.order[oct * m.n_blocks + s] : s;
    if (!enters_block(m.bb, blk, ox, oy, oz, inv_dx, inv_dy, inv_dz, t_min,
                      h.t))
      continue;
    const float4* __restrict__ row = m.tris + (size_t)blk * m.block * 4;
    for (int i = 0; i < m.block; ++i) {
      const float4 a = row[4 * i];      // v1x v1y v1z e1x
      const float4 b = row[4 * i + 1];  // e1y e1z e2x e2y
      const float4 c = row[4 * i + 2];  // e2z nx ny nz
      const float4 e = row[4 * i + 3];  // mat pid
      const float e1x = a.w, e1y = b.x, e1z = b.y;
      const float e2x = b.z, e2y = b.w, e2z = c.x;
      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float det0 = e1x * px + e1y * py + e1z * pz;
      const float sign = det0 > 0.0f ? 1.0f : -1.0f;
      const float det = det0 * sign;
      const float tx = (ox - a.x) * sign;
      const float ty = (oy - a.y) * sign;
      const float tz = (oz - a.z) * sign;
      const float u = tx * px + ty * py + tz * pz;
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float vv = dx * qx + dy * qy + dz * qz;
      const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
      const float w = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      const bool ok = (det >= 1e-6f) && (u >= 0.0f) && (u <= det) &&
                      (vv >= 0.0f) && (u + vv <= det) && (w >= t_min) &&
                      (w < h.t) && (e.y >= 0.0f);
      if (ok) {
        h.t = w;
        h.idx = e.y;
        h.nx = c.y;
        h.ny = c.z;
        h.nz = c.w;
        h.mat = e.x;
        if constexpr (kUv) {
          const float4 f = m.uvs[2 * ((size_t)blk * m.block + i)];
          const float4 g = m.uvs[2 * ((size_t)blk * m.block + i) + 1];
          const float bu = u * inv_det;
          const float bv = vv * inv_det;
          h.u = f.x + bu * f.z + bv * g.x;
          h.v = f.y + bu * f.w + bv * g.y;
          h.tex = g.z;
        }
      }
    }
  }
}

}  // namespace nr_mesh
