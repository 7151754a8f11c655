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
// Design: a warp sweeps 32 rays, one a lane, blocks in natural order, so
// at step s every lane that enters a block enters block s.  Each lane
// makes its own slab test (nr_mesh::enters_block, mesh_sweep.cuh) against
// its own best: the per-ray cull of the plain version.  The warp ballots
// the entering lanes and tests their rays against the block together,
// kRayBatch rays at a time: lane j loads triangles j, j + 32, ... once and
// tests each ray of the batch, keeping per ray its first triangle at the
// least w; a reduction per ray takes the least w and, among equal w, the
// lowest triangle, and the owner takes it when w < t_best strictly.  That
// is the winner the plain version's serial strict-< loop picks, so every
// (ray, block) pair gives its result bit for bit.  The rays' features
// come from the warp's shared table, written once from the owners'
// registers.  The sums run on the FP32 units in the plain version's
// order, built with -fmad=false like the rest of the library.
//
// A block's coefficients are 20 KB; a batch reads them once for all of
// its rays, where a step of one ray at a time read them once a ray.  The
// table is (n_blocks, 10, block) float4, a block's triangles side by side,
// so the 32 lanes' loads of one float4 are 512 consecutive bytes (the
// contract's row-major 160-byte rows would put each lane's float4 on a
// cache line of its own, 32 lines a load).
//
// No tensor cores.  A TF32 mma.sync filter (a margin derived from TF32's
// rounding on each form, every pair it could not reject recomputed
// exactly, bit for bit) was built and measured on an H100: once the
// batched step read the coefficients once a batch, it lost on the hybrid
// chunk's sorted prefix at every threshold tried (PERF.md, PR 8).
//
// Bound: FP32 issue, ~90 operations per triangle test (the four 10-term
// forms and the accept tests) and ~26 per block slab test, times the tests
// the rays need.
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

// Entering rays a warp tests against each triangle it loads (chosen with
// tools/torch_ab.py --mxu --ray-batch; PERF.md).
constexpr int kRayBatch = 4;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// Blocks an SM that the register budget must allow (chosen with
// tools/torch_ab.py --mxu --min-blocks; PERF.md).
constexpr int kMinBlocks = 5;
constexpr int kFeatStride = 33;
constexpr unsigned kFull = 0xffffffffu;

struct MxuArgs {
  const float4* tris;  // (n_blocks * block) rows of TRI_FLOATS (shading)
  const float4* coef;  // (n_blocks, 10, block) float4 of coefficients
  const float4* bb;    // n_blocks rows of BB_FLOATS
  int n_blocks, block;
  float cx, cy, cz;    // the pool's centre
};

// One warp's shared tables.
struct WarpShared {
  float feat[N_FEATURES * kFeatStride];  // f[k] of lane L at k * 33 + L
  float tb[32];        // t_best at the block's start of entering ray c
  int ray_lane[32];    // the lane of entering ray c
};

struct Hit {
  float t, idx, nx, ny, nz, mat;
};

__device__ __forceinline__ float form(const float* c, const float* f) {
  float acc = c[0];  // f[0] = 1
#pragma unroll
  for (int k = 1; k < N_FEATURES; ++k) acc = acc + c[k] * f[k];
  return acc;
}

// The plain version's forms and accept test of one triangle (coefficients
// `c`) against features `f` and the block's starting best: w when
// accepted, else +inf.  An accepted w is never NaN (its tests would
// fail), so a serial strict-< loop over these w picks the same winner as
// over (ok && w).
__device__ __forceinline__ float exact_w(const float* c, const float* f,
                                         const float t_min, const float tb) {
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
                  (t2 >= 0.0f) && (t1 + t2 <= ad) && (ws >= t_min * ad) &&
                  (ws < tb * ad);
  const float w = ws / (ad == 0.0f ? 1.0f : ad);
  return ok ? w : INFINITY;
}

// Triangle `i` of block `blk` at `w` becomes the ray's best.
__device__ __forceinline__ void take(const MxuArgs& m, const int blk,
                                     const int i, const float w, Hit& h) {
  const size_t tri = (size_t)blk * m.block + i;
  const float4 cc = m.tris[tri * (nr_mesh::TRI_FLOATS / 4) + 2];  // nx ny nz
  const float4 ee = m.tris[tri * (nr_mesh::TRI_FLOATS / 4) + 3];  // mat pid
  h.t = w;
  h.idx = ee.y;
  h.nx = cc.y;
  h.ny = cc.z;
  h.nz = cc.w;
  h.mat = ee.x;
}

// The warp's step at block `blk` for its `cnt` entering rays (entering
// ray c is lane sm.ray_lane[c]; this lane's is `rank`, -1 if none).
__device__ __forceinline__ void block_step(const MxuArgs& m,
                                           const WarpShared& sm,
                                           const int blk, const int cnt,
                                           const int rank, const float t_min,
                                           Hit& h) {
  const int lane = threadIdx.x & 31;
  const float4* __restrict__ rows =
      m.coef + (size_t)blk * m.block * (COEF_FLOATS / 4);
  for (int r0 = 0; r0 < cnt; r0 += kRayBatch) {
    const int nr = min(kRayBatch, cnt - r0);
    float tb[kRayBatch], bw[kRayBatch];
    int bi[kRayBatch];
#pragma unroll
    for (int q = 0; q < kRayBatch; ++q) {
      tb[q] = q < nr ? sm.tb[r0 + q] : 0.0f;
      bw[q] = INFINITY;
      bi[q] = m.block;
    }
    for (int t = lane; t < m.block; t += 32) {
      float c[COEF_FLOATS];
#pragma unroll
      for (int k = 0; k < COEF_FLOATS / 4; ++k) {
        const float4 r4 = rows[k * m.block + t];
        c[4 * k] = r4.x;
        c[4 * k + 1] = r4.y;
        c[4 * k + 2] = r4.z;
        c[4 * k + 3] = r4.w;
      }
#pragma unroll
      for (int q = 0; q < kRayBatch; ++q) {
        if (q < nr) {  // the same for every lane
          const float* fl = sm.feat + sm.ray_lane[r0 + q];
          float f[N_FEATURES];
#pragma unroll
          for (int k = 0; k < N_FEATURES; ++k) f[k] = fl[k * kFeatStride];
          const float w = exact_w(c, f, t_min, tb[q]);
          if (w < bw[q]) {  // strict: the lane's first at its least w
            bw[q] = w;
            bi[q] = t;
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kRayBatch; ++q) {
      if (q < nr) {
        float w = bw[q];
        int i = bi[q];
        for (int off = 16; off > 0; off >>= 1) {
          const float ow = __shfl_xor_sync(kFull, w, off);
          const int oi = __shfl_xor_sync(kFull, i, off);
          if (ow < w || (ow == w && oi < i)) {
            w = ow;
            i = oi;
          }
        }
        if (rank == r0 + q && w < h.t) take(m, blk, i, w, h);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
mesh_sweep_mxu_kernel(const float* __restrict__ rays, const int n,
                      const MxuArgs m, const float t_min,
                      float* __restrict__ out) {
  __shared__ WarpShared shared[kWarps];
  WarpShared& sm = shared[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // a lane past the end sweeps with a zero cap: it only helps the others
  const bool has = i < n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  Hit h{0.0f, -1.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (has) {
    ox = rays[i];
    oy = rays[n + i];
    oz = rays[2 * n + i];
    dx = rays[3 * n + i];
    dy = rays[4 * n + i];
    dz = rays[5 * n + i];
    h.t = rays[6 * n + i];
  }
  // no w satisfies ws >= t_min |det| and ws < t_cap |det| when t_cap <=
  // t_min (a dead or padded ray's zero cap)
  const bool live = has && h.t > t_min;
  if (__ballot_sync(kFull, live) != 0u) {
    const float oxc = ox - m.cx, oyc = oy - m.cy, ozc = oz - m.cz;
    const float f[N_FEATURES] = {1.0f, oxc, oyc, ozc, dx, dy, dz,
                                 oyc * dz - ozc * dy, ozc * dx - oxc * dz,
                                 oxc * dy - oyc * dx};
#pragma unroll
    for (int k = 0; k < N_FEATURES; ++k)
      sm.feat[k * kFeatStride + lane] = f[k];
    const float inv_dx = nr_mesh::inv_axis(dx),
                inv_dy = nr_mesh::inv_axis(dy),
                inv_dz = nr_mesh::inv_axis(dz);
    for (int blk = 0; blk < m.n_blocks; ++blk) {
      const bool enters =
          live && nr_mesh::enters_block(m.bb, blk, ox, oy, oz, inv_dx,
                                        inv_dy, inv_dz, t_min, h.t);
      const unsigned todo = __ballot_sync(kFull, enters);
      if (todo == 0u) continue;
      // the entering rays in lane order, with their bests at the start
      const int rank = enters ? __popc(todo & ((1u << lane) - 1u)) : -1;
      __syncwarp();
      if (enters) {
        sm.ray_lane[rank] = lane;
        sm.tb[rank] = h.t;
      }
      __syncwarp();
      block_step(m, sm, blk, __popc(todo), rank, t_min, h);
    }
  }
  if (has) {
    out[i] = h.idx >= 0.0f ? h.t : INFINITY;
    out[n + i] = h.idx;
    out[2 * n + i] = h.nx;
    out[3 * n + i] = h.ny;
    out[4 * n + i] = h.nz;
    out[5 * n + i] = h.mat;
  }
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
  const int blocks = (n + kThreads - 1) / kThreads;
  mesh_sweep_mxu_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rays, n, m, t_min, out);
  return (int)cudaGetLastError();
}

// The table layout this library was built with: 0 coefficient row floats,
// 1 triangle row floats, 2 block-box row floats, 3 ray channels, 4 the
// rays a step tests against each loaded triangle (kRayBatch).
int nr_mesh_mxu_layout(int what) {
  switch (what) {
    case 0: return COEF_FLOATS;
    case 1: return nr_mesh::TRI_FLOATS;
    case 2: return nr_mesh::BB_FLOATS;
    case 3: return RAY_CHANNELS;
    case 4: return kRayBatch;
    default: return -1;
  }
}

}  // extern "C"
