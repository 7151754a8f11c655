// Diffuse path-tracing megakernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel nrenderer_tpu/ops/pt_pallas.py::_pt_kernel in its
// diffuse form (bsdf=False; no env map, no textures, no mesh sweep).  The
// Python wrapper, its plain torch version and the launch counter are in
// nrenderer_torch/ops/pt_cuda.py.
//
// What it computes, per pixel and per sample: a jittered camera ray (thin
// lens when lens_r > 0) from hash_uniform(pid, sample, draw 0..3, seed), then
// up to `depth` bounces, each drawing hash_uniform(pid, sample, 4/5,
// seed + b * 0x9E3779B1): the closest hit over spheres, triangles and planes,
// the closest area-light crossing, the light's radiance if the light comes
// first, otherwise a uniform-hemisphere Lambertian bounce (throughput *=
// 2 * albedo * cos).  A path that survives the depth cap sees the ambient
// constant.  The math and its float32 operation order are those of
// nrenderer_torch/ops/{camera,intersect,pt_core}.py, which mirror the JAX
// package.  Built with -fmad=false, the kernel gives the plain torch version's
// film bit for bit on the card (sinf/cosf/rsqrtf are the same device
// functions there); against the JAX kernel on the CPU the last ulp of the
// transcendentals differs.
//
// Design: one thread per pixel; each thread loops over its samples and their
// bounces in registers and stops a path as soon as it dies (a dead path
// changes nothing in the estimator, so stopping early is exact).  Pixel ids
// follow the JAX kernel's numbering, pid = py * W + px with py = 0 the bottom
// row, so both draw the same hash values.  The scene is a small packed
// float32 table in device memory; every thread of a warp reads the same
// address at the same time, so the reads are broadcasts served from L1.  The
// camera basis and t_min are kernel arguments.
//
// The film is a linear (W*H, 3) float32 SUM that each launch adds samples
// [sp0, sp0 + n_spp) into IN PLACE, one sample after another per pixel: a
// render split over several launches gives the same sums as one launch.  The
// wrapper scales by 1/spp and applies the sqrt gamma.
//
// What bounds it on the H100: FP32 ALU work (about 16 primitive tests per
// bounce for the Cornell box) and warp divergence as paths die at different
// bounces; memory traffic is one film read and write per pixel per launch.
// This first design does nothing about either yet: no per-scene
// specialisation, no path regeneration or compaction of dead lanes.
//
// Built with nvcc for sm_90a without --use_fast_math (the hit tests and the
// hash need IEEE division and sqrt) and with -fmad=false (see above; the
// flags are in nrenderer_torch/_build.py).  Plain C interface, loaded with
// ctypes: each launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// Packed scene table layout (float32), sections in this order; the Python
// packer (pt_cuda.pack_scene) writes the same strides.
constexpr int SPH_STRIDE = 6;   // cx cy cz r*r 1/r mat
constexpr int TRI_STRIDE = 13;  // v1[3] e1[3] e2[3] n[3] mat
constexpr int PLN_STRIDE = 14;  // pos[3] n[3] inv0[3] inv1[3] dot(pos,n) mat
constexpr int AL_STRIDE = 16;   // pos[3] n[3] inv0[3] inv1[3] dot(pos,n) rad[3]
constexpr int MAT_STRIDE = 3;   // albedo rgb
// then 3 floats of ambient constant

struct SceneCounts {
  int n_sph, n_tri, n_pln, n_al, n_mat;
};

struct CamArgs {
  float pos[3], ll[3], hor[3], ver[3], u[3], v[3];
  float lens_r, t_min, inv_w, inv_h;
};
constexpr int CAM_FLOATS = 22;

constexpr float TWO_PI = (float)(2.0 * 3.14159265358979323846);

// lowbias32-style hash of (pixel, sample, draw site, seed) -> [0, 1); the
// same bits as pt_core.hash_uniform (uint32 arithmetic wraps, shifts are
// logical).
__device__ __forceinline__ float hash_uniform(uint32_t pid, uint32_t sample,
                                              uint32_t draw, uint32_t seed) {
  uint32_t x = pid * 0x9E3779B9u + sample * 0x85EBCA6Bu + seed * 0x165667B1u +
               draw * 0x27D4EB2Fu;
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x8725E8CDu;  // int32 -2027558707 in the JAX hash
  x ^= x >> 16;
  return (float)(x >> 8) * 5.9604644775390625e-8f;  // 2^-24
}

// Parallelogram test shared by planes and area lights (the plain form's
// intersect._patch_hit).  p points at pos[3] n[3] inv0[3] inv1[3] dp.
__device__ __forceinline__ float patch_t(const float* __restrict__ p, float ox,
                                         float oy, float oz, float dx,
                                         float dy, float dz, float t_min) {
  const float nd = p[3] * dx + p[4] * dy + p[5] * dz;
  const bool parallel = (nd < 1e-7f) && (nd > -1e-8f);
  const float t = (p[12] - (p[3] * ox + p[4] * oy + p[5] * oz)) /
                  (parallel ? 1.0f : nd);
  const float rx = ox + t * dx - p[0];
  const float ry = oy + t * dy - p[1];
  const float rz = oz + t * dz - p[2];
  const float u = p[6] * rx + p[7] * ry + p[8] * rz;
  const float v = p[9] * rx + p[10] * ry + p[11] * rz;
  const bool ok = !parallel && (t >= t_min) && (u >= 0.0f) && (u <= 1.0f) &&
                  (v >= 0.0f) && (v <= 1.0f);
  return ok ? t : INFINITY;
}

__global__ void __launch_bounds__(128)
pt_diffuse_kernel(float* __restrict__ film, const float* __restrict__ scene,
                  const SceneCounts nc, const CamArgs cam, const int width,
                  const int height, const int sp0, const int n_spp,
                  const int depth, const uint32_t seed) {
  const int pid = blockIdx.x * blockDim.x + threadIdx.x;
  if (pid >= width * height) return;
  const int py = pid / width;
  const int px = pid - py * width;
  const float pxf = (float)px;
  const float pyf = (float)py;
  const uint32_t upid = (uint32_t)pid;

  const float* __restrict__ sph = scene;
  const float* __restrict__ tri = sph + nc.n_sph * SPH_STRIDE;
  const float* __restrict__ pln = tri + nc.n_tri * TRI_STRIDE;
  const float* __restrict__ al = pln + nc.n_pln * PLN_STRIDE;
  const float* __restrict__ mat = al + nc.n_al * AL_STRIDE;
  const float* __restrict__ amb = mat + nc.n_mat * MAT_STRIDE;
  const float amb_r = amb[0], amb_g = amb[1], amb_b = amb[2];

  float fr = film[3 * pid + 0];
  float fg = film[3 * pid + 1];
  float fb = film[3 * pid + 2];

  for (int k = 0; k < n_spp; ++k) {
    const uint32_t sp = (uint32_t)(sp0 + k);
    // camera ray: pixel jitter in [-1, 1] (UniformInSquare)
    const float rx = hash_uniform(upid, sp, 0u, seed) * 2.0f - 1.0f;
    const float ry = hash_uniform(upid, sp, 1u, seed) * 2.0f - 1.0f;
    const float s = (pxf + rx) * cam.inv_w;
    const float t = (pyf + ry) * cam.inv_h;
    float ox = cam.pos[0], oy = cam.pos[1], oz = cam.pos[2];
    if (cam.lens_r > 0.0f) {
      const float lr = sqrtf(hash_uniform(upid, sp, 2u, seed)) * cam.lens_r;
      const float phi = hash_uniform(upid, sp, 3u, seed) * TWO_PI;
      const float du = lr * cosf(phi);
      const float dv = lr * sinf(phi);
      ox = cam.pos[0] + du * cam.u[0] + dv * cam.v[0];
      oy = cam.pos[1] + du * cam.u[1] + dv * cam.v[1];
      oz = cam.pos[2] + du * cam.u[2] + dv * cam.v[2];
    }
    float dx = cam.ll[0] + s * cam.hor[0] + t * cam.ver[0] - ox;
    float dy = cam.ll[1] + s * cam.hor[1] + t * cam.ver[1] - oy;
    float dz = cam.ll[2] + s * cam.hor[2] + t * cam.ver[2] - oz;
    const float inv_len = rsqrtf(dx * dx + dy * dy + dz * dz);
    dx *= inv_len;
    dy *= inv_len;
    dz *= inv_len;

    float tr = 1.0f, tg = 1.0f, tb = 1.0f;
    float rr = 0.0f, rg = 0.0f, rb = 0.0f;
    bool alive = true;
    for (int b = 0; b < depth; ++b) {
      const uint32_t bseed = seed + (uint32_t)b * 0x9E3779B1u;
      const float u1 = hash_uniform(upid, sp, 4u, bseed);
      const float u2 = hash_uniform(upid, sp, 5u, bseed);

      // closest hit: spheres, triangles, planes; first strictly closer wins
      float t_best = INFINITY, nx = 0.0f, ny = 0.0f, nz = 0.0f;
      int m_best = 0;
      for (int i = 0; i < nc.n_sph; ++i) {
        const float* p = sph + i * SPH_STRIDE;
        const float ocx = ox - p[0], ocy = oy - p[1], ocz = oz - p[2];
        const float bq = ocx * dx + ocy * dy + ocz * dz;
        const float c = ocx * ocx + ocy * ocy + ocz * ocz - p[3];
        const float a = dx * dx + dy * dy + dz * dz;
        const float disc = bq * bq - a * c;
        const float sq = sqrtf(fmaxf(disc, 0.0f));
        const float inv_a = 1.0f / a;
        const float t1 = (-bq - sq) * inv_a;
        const float t2 = (-bq + sq) * inv_a;
        const bool ok = disc > 0.0f;
        const float th = (ok && t1 >= cam.t_min)
                             ? t1
                             : ((ok && t2 >= cam.t_min) ? t2 : INFINITY);
        if (th < t_best) {
          t_best = th;
          nx = (ox + th * dx - p[0]) * p[4];
          ny = (oy + th * dy - p[1]) * p[4];
          nz = (oz + th * dz - p[2]) * p[4];
          m_best = (int)p[5];
        }
      }
      for (int i = 0; i < nc.n_tri; ++i) {
        const float* p = tri + i * TRI_STRIDE;
        const float e1x = p[3], e1y = p[4], e1z = p[5];
        const float e2x = p[6], e2y = p[7], e2z = p[8];
        // P = d x e2; Moller-Trumbore with the det-sign fold
        const float qpx = e2z * dy - e2y * dz;
        const float qpy = -e2z * dx + e2x * dz;
        const float qpz = e2y * dx - e2x * dy;
        const float det0 = e1x * qpx + e1y * qpy + e1z * qpz;
        const float sign = det0 > 0.0f ? 1.0f : -1.0f;
        const float det = det0 * sign;
        const float tx = (ox - p[0]) * sign;
        const float ty = (oy - p[1]) * sign;
        const float tz = (oz - p[2]) * sign;
        const float u = tx * qpx + ty * qpy + tz * qpz;
        const float qx = e1z * ty - e1y * tz;
        const float qy = -e1z * tx + e1x * tz;
        const float qz = e1y * tx - e1x * ty;
        const float v = dx * qx + dy * qy + dz * qz;
        const float w =
            (e2x * qx + e2y * qy + e2z * qz) / (det == 0.0f ? 1.0f : det);
        const bool ok = (det >= 1e-6f) && (u >= 0.0f) && (u <= det) &&
                        (v >= 0.0f) && (u + v <= det) && (w >= cam.t_min);
        if (ok && w < t_best) {
          t_best = w;
          nx = p[9];
          ny = p[10];
          nz = p[11];
          m_best = (int)p[12];
        }
      }
      for (int i = 0; i < nc.n_pln; ++i) {
        const float* p = pln + i * PLN_STRIDE;
        const float th = patch_t(p, ox, oy, oz, dx, dy, dz, cam.t_min);
        if (th < t_best) {
          t_best = th;
          nx = p[3];
          ny = p[4];
          nz = p[5];
          m_best = (int)p[13];
        }
      }
      float t_l = INFINITY, lr_ = 0.0f, lg_ = 0.0f, lb_ = 0.0f;
      for (int i = 0; i < nc.n_al; ++i) {
        const float* p = al + i * AL_STRIDE;
        const float th = patch_t(p, ox, oy, oz, dx, dy, dz, cam.t_min);
        if (th < t_l) {
          t_l = th;
          lr_ = p[13];
          lg_ = p[14];
          lb_ = p[15];
        }
      }

      const bool obj_first = (t_best < INFINITY) && (t_best < t_l);
      if (!obj_first) {
        if (t_l < INFINITY) {  // the light comes first
          rr += tr * lr_;
          rg += tg * lg_;
          rb += tb * lb_;
        }
        alive = false;
        break;
      }

      // Lambertian bounce: uniform hemisphere about the stored normal
      const float hr = sqrtf(fmaxf(0.0f, 1.0f - u1 * u1));
      const float phi = TWO_PI * u2;
      const float lx = cosf(phi) * hr, ly = sinf(phi) * hr, lz = u1;
      // Onb (Onb.hpp:17-27): a = big_x ? (0,1,0) : (1,0,0)
      const bool big_x = fabsf(nx) > 0.9f;
      const float ax_ = big_x ? 0.0f : 1.0f, ay_ = big_x ? 1.0f : 0.0f;
      float vx = ny * 0.0f - nz * ay_;
      float vy = nz * ax_ - nx * 0.0f;
      float vz = nx * ay_ - ny * ax_;
      const float vinv =
          rsqrtf(fmaxf(vx * vx + vy * vy + vz * vz, 1.2e-38f));
      vx *= vinv;
      vy *= vinv;
      vz *= vinv;
      const float ux = ny * vz - nz * vy;
      const float uy = nz * vx - nx * vz;
      const float uz = nx * vy - ny * vx;
      float ndx = lx * ux + ly * vx + lz * nx;
      float ndy = lx * uy + ly * vy + lz * ny;
      float ndz = lx * uz + ly * vz + lz * nz;
      const float dinv =
          rsqrtf(fmaxf(ndx * ndx + ndy * ndy + ndz * ndz, 1.2e-38f));
      ndx *= dinv;
      ndy *= dinv;
      ndz *= dinv;
      const float scale = 2.0f * (nx * ndx + ny * ndy + nz * ndz);
      const float* alb = mat + m_best * MAT_STRIDE;
      tr = tr * (alb[0] * scale);
      tg = tg * (alb[1] * scale);
      tb = tb * (alb[2] * scale);
      ox = ox + t_best * dx;
      oy = oy + t_best * dy;
      oz = oz + t_best * dz;
      dx = ndx;
      dy = ndy;
      dz = ndz;
    }
    if (alive) {  // depth cap: ambient constant
      rr += tr * amb_r;
      rg += tg * amb_g;
      rb += tb * amb_b;
    }
    fr += rr;
    fg += rg;
    fb += rb;
  }
  film[3 * pid + 0] = fr;
  film[3 * pid + 1] = fg;
  film[3 * pid + 2] = fb;
}

__global__ void hash_fill_kernel(const int32_t* __restrict__ pid,
                                 const int32_t* __restrict__ sample,
                                 const int32_t* __restrict__ draw,
                                 const int32_t* __restrict__ seed,
                                 float* __restrict__ out, const int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = hash_uniform((uint32_t)pid[i], (uint32_t)sample[i],
                        (uint32_t)draw[i], (uint32_t)seed[i]);
}

}  // namespace

extern "C" {

// Adds samples [sp0, sp0 + n_spp) of every pixel into `film` ((W*H, 3)
// float32, device) in place.  `counts` (host): n_sph n_tri n_pln n_al n_mat;
// `cam` (host): the 22 floats of CamArgs.
int nr_pt_diffuse(float* film, const float* scene, const int* counts,
                  const float* cam, int width, int height, int sp0, int n_spp,
                  int depth, int seed, void* stream) {
  SceneCounts nc{counts[0], counts[1], counts[2], counts[3], counts[4]};
  CamArgs ca;
  const float* c = cam;
  for (int i = 0; i < 3; ++i) {
    ca.pos[i] = c[i];
    ca.ll[i] = c[3 + i];
    ca.hor[i] = c[6 + i];
    ca.ver[i] = c[9 + i];
    ca.u[i] = c[12 + i];
    ca.v[i] = c[15 + i];
  }
  ca.lens_r = c[18];
  ca.t_min = c[19];
  ca.inv_w = c[20];
  ca.inv_h = c[21];
  const int n_pix = width * height;
  const int threads = 128;
  const int blocks = (n_pix + threads - 1) / threads;
  pt_diffuse_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      film, scene, nc, ca, width, height, sp0, n_spp, depth, (uint32_t)seed);
  return (int)cudaGetLastError();
}

// out[i] = hash_uniform(pid[i], sample[i], draw[i], seed[i]) with the
// kernel's own device function; all arrays on the device.
int nr_hash_uniform_fill(const int32_t* pid, const int32_t* sample,
                         const int32_t* draw, const int32_t* seed, float* out,
                         int n, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  if (n > 0) {
    hash_fill_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        pid, sample, draw, seed, out, n);
  }
  return (int)cudaGetLastError();
}

int nr_cam_floats() { return CAM_FLOATS; }

const char* nr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
