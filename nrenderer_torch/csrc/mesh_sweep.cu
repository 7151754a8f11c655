// Standalone blocked mesh sweep for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel nrenderer_tpu/ops/mesh_pallas.py:439 _sweep_kernel
// (pallas_call :491, built by _build_sweep :477, called by sweep_mesh_full
// :503): the closest triangle for each ray of a batch.  One thread per ray;
// each warp runs the warp-cooperative device function nr_mesh::warp_sweep
// (csrc/mesh_sweep.cuh, which says what it computes, what bounds it and
// how it is laid out) with all 32 lanes, a lane past the end with no ray.  The
// Python wrapper, the plain torch version and the launch counter are in
// nrenderer_torch/ops/mesh_cuda.py.
//
// Rays are a (7, n) float32 array: ox oy oz dx dy dz t_cap (a zero cap skips
// the ray).  The output is (6, n) or, with UV tables, (9, n) float32:
// t (+inf on a miss), idx (the winner's pid, -1 on a miss), nx ny nz mat,
// then u v tex.  Built with -fmad=false like the path-tracing kernel, so
// it gives the plain version's results bit for bit.  Plain C interface,
// loaded with ctypes: the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mesh_sweep.cuh"

namespace {

constexpr int RAY_CHANNELS = 7;

template <bool kUv>
__global__ void __launch_bounds__(128)
mesh_sweep_kernel(const float* __restrict__ rays, const int n,
                  const nr_mesh::MeshArgs m, const float t_min,
                  const int f2b, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  // lanes past the end take part in the warp sweep with no ray
  const bool real = i < n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 1.0f;
  float cap = 0.0f;
  if (real) {
    ox = rays[i];
    oy = rays[n + i];
    oz = rays[2 * n + i];
    dx = rays[3 * n + i];
    dy = rays[4 * n + i];
    dz = rays[5 * n + i];
    cap = rays[6 * n + i];
  }
  const int oct = f2b ? (dx > 0.0f) * 4 + (dy > 0.0f) * 2 + (dz > 0.0f) : -1;
  nr_mesh::SweepHit h;
  nr_mesh::warp_sweep<kUv>(m, ox, oy, oz, dx, dy, dz, t_min, cap, oct, h);
  if (!real) return;
  out[i] = h.idx >= 0.0f ? h.t : INFINITY;
  out[n + i] = h.idx;
  out[2 * n + i] = h.nx;
  out[3 * n + i] = h.ny;
  out[4 * n + i] = h.nz;
  out[5 * n + i] = h.mat;
  if constexpr (kUv) {
    out[6 * n + i] = h.u;
    out[7 * n + i] = h.v;
    out[8 * n + i] = h.tex;
  }
}

}  // namespace

extern "C" {

// Sweeps `n` rays ((7, n) device array) against the pool; `n_out` is 6, or
// 9 with `uvs` (null for none); `order` (device, (8, n_blocks) int32) is
// null for the natural block order, else each ray visits blocks near to far
// along its own direction octant.
int nr_mesh_sweep(const float* rays, int n, int n_out, const float* tris,
                  const float* uvs, const float* bb, const int* order,
                  int n_blocks, int block, float t_min, float* out,
                  void* stream) {
  if (n <= 0) return 0;
  if (n_out != (uvs ? 9 : 6) || n_blocks < 1 || block < 1)
    return (int)cudaErrorInvalidValue;
  const nr_mesh::MeshArgs m{reinterpret_cast<const float4*>(tris),
                            reinterpret_cast<const float4*>(uvs),
                            reinterpret_cast<const float4*>(bb), order,
                            n_blocks, block};
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if (uvs) {
    mesh_sweep_kernel<true><<<blocks, threads, 0, st>>>(
        rays, n, m, t_min, order != nullptr, out);
  } else {
    mesh_sweep_kernel<false><<<blocks, threads, 0, st>>>(
        rays, n, m, t_min, order != nullptr, out);
  }
  return (int)cudaGetLastError();
}

// The table layout this library was built with: 0 triangle row floats,
// 1 UV row floats, 2 block-box row floats, 3 ray channels.
int nr_mesh_layout(int what) {
  switch (what) {
    case 0: return nr_mesh::TRI_FLOATS;
    case 1: return nr_mesh::UV_FLOATS;
    case 2: return nr_mesh::BB_FLOATS;
    case 3: return RAY_CHANNELS;
    default: return -1;
  }
}

}  // extern "C"
