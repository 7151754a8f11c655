// The bilinear-form mesh sweep for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel nrenderer_tpu/ops/mesh_pallas.py:372
// _sweep_kernel_mxu (pallas_call :426, built by _build_sweep_mxu :408, tile
// body sweep_tile_mxu :259), the JAX package's NR_MESH_MXU=1 engine: the
// closest triangle per ray, with each triangle's Moller-Trumbore terms as
// linear forms in a per-ray feature vector.  The Python wrapper, the plain
// torch version and the launch counter are in
// nrenderer_torch/ops/mesh_mxu.py, which states the contract; in short:
//
//   f = [1, o', d, o' x d]  (o' = origin - the pool's centre)
//   det, u, v, t*det = sum_{k=0..9} coef[row][k] * f[k], in that order
//   s = det >= 0 ? 1 : -1; accept when |det| >= 1e-6, 0 <= u s <= |det|,
//   v s >= 0, u s + v s <= |det|, ws >= t_min |det|, ws < t_best |det|
//   (t_best at the block's start); w = ws / |det|; the first triangle at
//   the block's least w wins when w < t_best.
//
// Design: one thread is one ray, blocks in natural order after the blocked
// sweep's block slab test (nr_mesh::enters_block, mesh_sweep.cuh), each ray
// culling for itself.  A triangle's 40 coefficients (4 rows x 10 features; the JAX
// table's features 10-15 are zero and not stored) are ten aligned float4
// loads; the lanes of a warp that sweep the same block read the same rows
// at once, so the loads are broadcasts from L1.  The sums run on the FP32
// units in a fixed order, built with -fmad=false like the rest of the
// library, so the kernel gives the plain version's results bit for bit.
// The TPU kernel ran them on its matrix unit at HIGHEST precision; TF32 or
// BF16 tensor-core products would break the 1e-6 det test (8-10 mantissa
// bits), so this first kernel leaves the tensor cores alone.  Bound: FP32
// issue, ~90 operations per triangle test (the four 10-term forms and the
// accept tests) and ~26 per block slab test, times the tests the rays
// need; about twice the blocked sweep's work per triangle, with warps
// diverging where their rays enter different blocks.
//
// Rays are a (7, n) float32 array: ox oy oz dx dy dz t_cap (a zero cap skips
// the ray).  The output is (6, n) float32: t (+inf on a miss), idx (the
// winner's pid, -1 on a miss), nx ny nz mat, read from the triangle table.
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mesh_sweep.cuh"

namespace {

constexpr int RAY_CHANNELS = 7;
constexpr int N_FEATURES = 10;
constexpr int COEF_FLOATS = 4 * N_FEATURES;  // det, u, v, t*det rows

struct MxuArgs {
  const float4* tris;  // (n_blocks * block) rows of TRI_FLOATS (shading)
  const float4* coef;  // (n_blocks * block) rows of COEF_FLOATS
  const float4* bb;    // n_blocks rows of BB_FLOATS
  int n_blocks, block;
  float cx, cy, cz;    // the pool's centre
};

__device__ __forceinline__ float form(const float* c, const float* f) {
  float acc = c[0];  // f[0] = 1
#pragma unroll
  for (int k = 1; k < N_FEATURES; ++k) acc = acc + c[k] * f[k];
  return acc;
}

__global__ void __launch_bounds__(128)
mesh_sweep_mxu_kernel(const float* __restrict__ rays, const int n,
                      const MxuArgs m, const float t_min,
                      float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = rays[i], oy = rays[n + i], oz = rays[2 * n + i];
  const float dx = rays[3 * n + i], dy = rays[4 * n + i],
              dz = rays[5 * n + i];
  float t_best = rays[6 * n + i];
  float idx = -1.0f, nx = 0.0f, ny = 0.0f, nz = 0.0f, mat = 0.0f;
  // no w satisfies ws >= t_min |det| and ws < t_cap |det| when t_cap <=
  // t_min (a dead or padded ray's zero cap)
  if (t_best > t_min) {
    const float oxc = ox - m.cx, oyc = oy - m.cy, ozc = oz - m.cz;
    const float f[N_FEATURES] = {1.0f, oxc, oyc, ozc, dx, dy, dz,
                                 oyc * dz - ozc * dy, ozc * dx - oxc * dz,
                                 oxc * dy - oyc * dx};
    const float inv_dx = nr_mesh::inv_axis(dx),
                inv_dy = nr_mesh::inv_axis(dy),
                inv_dz = nr_mesh::inv_axis(dz);
    for (int blk = 0; blk < m.n_blocks; ++blk) {
      if (!nr_mesh::enters_block(m.bb, blk, ox, oy, oz, inv_dx, inv_dy,
                                 inv_dz, t_min, t_best))
        continue;
      const float4* __restrict__ rows =
          m.coef + (size_t)blk * m.block * (COEF_FLOATS / 4);
      float w_min = INFINITY;
      int i_win = -1;
      for (int t = 0; t < m.block; ++t) {
        float c[COEF_FLOATS];
#pragma unroll
        for (int q = 0; q < COEF_FLOATS / 4; ++q) {
          const float4 r4 = rows[t * (COEF_FLOATS / 4) + q];
          c[4 * q] = r4.x;
          c[4 * q + 1] = r4.y;
          c[4 * q + 2] = r4.z;
          c[4 * q + 3] = r4.w;
        }
        const float det = form(c, f);
        const float u = form(c + N_FEATURES, f);
        const float v = form(c + 2 * N_FEATURES, f);
        const float wp = form(c + 3 * N_FEATURES, f);
        const float s = det >= 0.0f ? 1.0f : -1.0f;
        const float ad = det * s;
        const float t1 = u * s;
        const float t2 = v * s;
        const float ws = wp * s;
        const bool ok = (ad >= 1e-6f) && (t1 >= 0.0f) && (t1 <= ad) &&
                        (t2 >= 0.0f) && (t1 + t2 <= ad) &&
                        (ws >= t_min * ad) && (ws < t_best * ad);
        const float w = ws / (ad == 0.0f ? 1.0f : ad);
        if (ok && w < w_min) {  // strict: the first at the least w
          w_min = w;
          i_win = t;
        }
      }
      if (w_min < t_best) {
        const size_t tri = (size_t)blk * m.block + i_win;
        const float4* row = m.tris + tri * (nr_mesh::TRI_FLOATS / 4);
        const float4 cc = row[2];  // e2z nx ny nz
        const float4 ee = row[3];  // mat pid
        t_best = w_min;
        idx = ee.y;
        nx = cc.y;
        ny = cc.z;
        nz = cc.w;
        mat = ee.x;
      }
    }
  }
  out[i] = idx >= 0.0f ? t_best : INFINITY;
  out[n + i] = idx;
  out[2 * n + i] = nx;
  out[3 * n + i] = ny;
  out[4 * n + i] = nz;
  out[5 * n + i] = mat;
}

}  // namespace

extern "C" {

// Sweeps `n` rays ((7, n) device array) against the pool's coefficient
// table in natural block order; `out` is (6, n).
int nr_mesh_sweep_mxu(const float* rays, int n, const float* tris,
                      const float* coef, const float* bb, int n_blocks,
                      int block, float cx, float cy, float cz, float t_min,
                      float* out, void* stream) {
  if (n <= 0) return 0;
  if (n_blocks < 1 || block < 1) return (int)cudaErrorInvalidValue;
  const MxuArgs m{reinterpret_cast<const float4*>(tris),
                  reinterpret_cast<const float4*>(coef),
                  reinterpret_cast<const float4*>(bb), n_blocks, block,
                  cx, cy, cz};
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  mesh_sweep_mxu_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      rays, n, m, t_min, out);
  return (int)cudaGetLastError();
}

// The table layout this library was built with: 0 coefficient row floats,
// 1 triangle row floats, 2 block-box row floats, 3 ray channels.
int nr_mesh_mxu_layout(int what) {
  switch (what) {
    case 0: return COEF_FLOATS;
    case 1: return nr_mesh::TRI_FLOATS;
    case 2: return nr_mesh::BB_FLOATS;
    case 3: return RAY_CHANNELS;
    default: return -1;
  }
}

}  // extern "C"
