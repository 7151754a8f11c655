// Path-tracing megakernels for NVIDIA Hopper (sm_90a), in ten forms.
//
// Replaces the TPU kernel nrenderer_tpu/ops/pt_pallas.py:123 _pt_kernel in
// its forms bsdf=False / bsdf=True, each without or with the env-map terms
// (env_rows / env_exact), the mesh form (mesh=(n_blocks, b): the blocked
// triangle sweep inline in the bounce loop) and the texture form (n_tex > 0,
// mesh_uv: binned surface textures).  pt_dense_kernel<kBsdf, kEnv, kTex,
// kRange> is instantiated for the eight forms without a mesh, each for the
// whole film and for a range of pixels: pt_diffuse_kernel <false, false,
// false> (SimplePathTracer's main path), pt_bsdf_kernel <true, false,
// false> (AccPathTracer on analytic scenes), pt_diffuse_env_kernel and
// pt_bsdf_env_kernel (kEnv), pt_diffuse_tex_kernel and pt_bsdf_tex_kernel
// (kTex), pt_diffuse_env_tex_kernel and pt_bsdf_env_tex_kernel (both);
// pt_mesh_kernel<kTex> twice: pt_bsdf_mesh_kernel (AccPathTracer's
// megamesh route, no env map) and pt_bsdf_mesh_tex_kernel.  Beside them,
// wavefront_dense_hit_kernel and wavefront_shade_kernel run one bounce of
// the hybrid route's wavefront around its standalone mesh pipe (see their
// comment).  The Python wrappers, their plain torch versions and the
// launch counters are in nrenderer_torch/ops/pt_cuda.py.
//
// What it computes, per pixel and per sample: a jittered camera ray (thin
// lens when lens_r > 0) from hash_uniform(pid, sample, draw 0..3, seed), then
// up to `depth` bounces, each drawing hash_uniform(pid, sample, 4/5,
// seed + b * 0x9E3779B1): the closest hit over spheres, triangles and planes,
// the closest area-light crossing, the light's radiance if the light comes
// first, otherwise a scatter.  The diffuse form scatters Lambertian (uniform
// hemisphere, throughput *= 2 * albedo * cos).  The BSDF form switches on
// the material's effective lobe, computed on the host by the JAX select
// chain's rule (pt_core.effective_lobe): Lambertian, conductor (complex
// Fresnel mirror), glass (one of reflect/refract chosen by Schlick F with
// the draw-6 uniform), GGX microfacet, plastic (mirror or diffuse chosen by
// Schlick F with the draw-6 uniform).  The JAX select chain returns one
// lobe's values unchanged, so evaluating only that lobe is exact.  A path
// that survives the depth cap sees the ambient constant.
//
// The env form: a path that misses everything at bounce 0 adds throughput * the
// native-resolution texel of its direction; a later miss adds throughput * the
// bin of its direction in the mean-pooled 32x128 bin table (the Pallas kernel
// records the miss and looks the bin up after the bounce loop; a path dies at
// its miss and its radiance is 0 until then, so looking up at the miss adds the
// same float).  Both index with the Pallas kernel's polynomial atan2/asin.  The
// Pallas kernel reads the bounce-0 texel from per-pixel PxP windows gathered on
// the host because Mosaic cannot gather; here it is a direct read of the map,
// the same texel whenever the window fits.  As the Pallas kernel peels bounce
// 0, the env form runs it even at depth 0.
//
// The mesh form: the dense pass tests spheres and planes only (the wrapper
// packs no triangles); then the warp-cooperative sweep nr_mesh::warp_sweep
// (csrc/mesh_sweep.cuh) runs over the blocked triangle pool with the dense
// hit's t as its cap, in natural block order (the Pallas mesh form passes
// no ord_ref), and a triangle that beats the cap wins.  Its material row is
// the one the JAX select chain over the material table gives its id
// (mesh_mat_row).  The warp sweep needs all 32 lanes at every call, so the
// mesh forms have a kernel of their own (pt_mesh_kernel).
//
// The texture form: a hit carries (u, v, texture id), from the winning
// dense triangle's UV row (uv1 + (bu * ue1 + bv * ue2), the dense
// intersector's order) or from the sweep; tex_lookup wraps u and v into
// [0, 1], takes column int(u * 128) and row int((1 - v) * 32), both
// clipped, in the texture whose index is within 0.5 of the id, from the
// binned (n_tex, 3, 32, 128) table.  The texel replaces the diffuse
// colour; in the BSDF form the material's specular-map id (M_STEX) does the
// same for the albedo.
//
// The math and its float32 operation order are those of
// nrenderer_torch/ops/{camera,intersect,pt_core,env,texture,mesh_cuda}.py,
// which mirror the JAX package (x ** 5 is spelled x * ((x * x) * (x * x)),
// JAX's integer_pow).  Built with -fmad=false, the kernel gives the plain torch
// version's film bit for bit on the card (sinf/cosf/sqrtf/rsqrtf are the
// same device functions there); against the JAX kernel on the CPU the last
// ulp of the transcendentals differs.
//
// Design (pt_dense_kernel, pt_mesh_kernel): one flat loop per thread whose
// iteration is one bounce of whichever sample the thread is on; the iteration
// that ends a path adds the sample into the pixel's sum and starts the next
// sample (path regeneration), so the lanes of a warp stay in the loop body
// together instead of idling at a bounce loop's exit until the warp's longest
// path ends (on the Cornell box 35.7% of the nested loop's lane slots were
// bounces, 89% of the flat loop's at launches of 256 spp: pt_cuda.loop_slots).
// On short paths the lanes that end a path build the next camera ray while
// others scatter, nearly every iteration: at 1.5 bounces a sample the env
// forms ran 1.04-1.15x faster than a nested loop on an H100, the textured quad
// (97% of a nested loop's slots useful already) 1.4x slower (PERF.md §6).  The
// dense pool's grid is persistent: as many blocks as fit on the card at
// once, each thread taking its next pixel from a counter.  The mesh forms
// keep a plain grid, and a lane whose path ended waits until half the
// warp's lanes with samples left have ended theirs, and they start their
// next samples together: the warp sweep needs all 32 lanes at every call,
// and rays that start together enter the same blocks (pt_mesh_kernel).
// Pixel ids follow the JAX kernel's numbering, pid = py * W + px with
// py = 0 the bottom row, so both draw the same hash values.  The scene is a
// small packed float32 table in device memory; every thread of a warp reads
// the same address at the same time, so the reads are broadcasts served
// from L1.  The env map and its bin table are read per miss (at most two
// reads per sample).  The camera basis and t_min are kernel arguments.
//
// The film is a linear (W*H, 3) float32 SUM that each launch adds samples
// [sp0, sp0 + n_spp) into IN PLACE, one sample after another per pixel: a
// render split over several launches gives the same sums as one launch.  A
// launch may cover a range of pixels [pix0, pix0 + n_pix) only (a band of
// rows, for a render split across devices): its film holds those rows,
// while the hash and the camera ray keep the global pixel id, so the band
// is the full film's rows bit for bit.  The wrapper scales by 1/spp and
// applies the sqrt gamma.
//
// What bounds it on the H100: FP32 issue (about 16 primitive tests per bounce
// for the Cornell box, plus the lobe's math), with the table's loads beside it,
// and warp divergence, as lanes of a warp take different lobes of the
// material switch or start a sample (or look up a texel) while others
// scatter; memory traffic is one film read and write per pixel per launch
// plus a few env texels per sample.
// The mesh form adds per bounce a slab test per block and ~53 operations
// per triangle of each entered block (the sweep's bound, mesh_sweep.cuh);
// the warp sweep tests a block few lanes enter with the whole warp, so
// lanes that enter different blocks no longer serialise 128 tests each.
// The texture form adds one or two texel reads per hit.  Not done:
// per-scene specialisation; sorting of rays by material; FMA contraction
// (about 11% faster, but not bit for bit with the plain version).
//
// Built with nvcc for sm_90a without --use_fast_math (the hit tests and the
// hash need IEEE division and sqrt) and with -fmad=false (see above; the
// flags are in nrenderer_torch/_build.py).  Plain C interface, loaded with
// ctypes: the launcher returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mesh_sweep.cuh"

namespace {

// Packed scene table layout (float32), sections in this order; the Python
// packer (pt_cuda.pack_scene) writes the same strides.
constexpr int SPH_STRIDE = 6;   // cx cy cz r*r 1/r mat
constexpr int TRI_STRIDE = 13;  // v1[3] e1[3] e2[3] n[3] mat
constexpr int PLN_STRIDE = 14;  // pos[3] n[3] inv0[3] inv1[3] dot(pos,n) mat
constexpr int AL_STRIDE = 16;   // pos[3] n[3] inv0[3] inv1[3] dot(pos,n) rad[3]
// A material row: the first 20 floats of pt_core.make_mat_channels, then
// the effective lobe, then the specular-map texture id (-1 = none): type,
// diffuse rgb, albedo rgb, ior, absorbed rgb, eta_r rgb, eta_i rgb,
// roughness, f0, metalness, lobe, stex.
constexpr int MAT_STRIDE = 22;
constexpr int M_DIFFUSE = 1, M_ALBEDO = 4, M_IOR = 7, M_ABSORBED = 8,
              M_ETA_R = 11, M_ETA_I = 14, M_ROUGH = 17, M_F0 = 18,
              M_METAL = 19, M_LOBE = 20, M_STEX = 21;
// then 3 floats of ambient constant, then (texture forms) one UV row per
// triangle: uv1[2] ue1[2] ue2[2] tex (tex -1 for a face without UVs)
constexpr int UV_STRIDE = 7;

// Binned surface textures (n_tex, 3, TEX_ROWS, TEX_LANES), ops/texture.py.
constexpr int TEX_ROWS = 32;
constexpr int TEX_LANES = 128;

// Binned env table (3, ENV_ROWS, ENV_LANES), pt_cuda.EnvTables.bins.
constexpr int ENV_ROWS = 32;
constexpr int ENV_LANES = 128;

struct SceneCounts {
  int n_sph, n_tri, n_pln, n_al, n_mat;
};

struct CamArgs {
  float pos[3], ll[3], hor[3], ver[3], u[3], v[3];
  float lens_r, t_min, inv_w, inv_h;
};
constexpr int CAM_FLOATS = 22;

constexpr double PI_D = 3.14159265358979323846;
constexpr float TWO_PI = (float)(2.0 * PI_D);
constexpr float HALF_PI_F = (float)(0.5 * PI_D);
constexpr float PI_F = (float)PI_D;
constexpr float INV_2PI_F = (float)(0.5 / PI_D);
constexpr float INV_PI_F = (float)(1.0 / PI_D);

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

struct F3 {
  float x, y, z;
};

__device__ __forceinline__ float dot3(const F3 a, const F3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// soa.normalize3(a, eps=1e-20 or 1e-12): both floors fall to 1.2e-38
__device__ __forceinline__ F3 normalize3(const F3 a) {
  const float inv = rsqrtf(fmaxf(dot3(a, a), 1.2e-38f));
  return F3{a.x * inv, a.y * inv, a.z * inv};
}

__device__ __forceinline__ F3 reflect3(const F3 d, const F3 n) {
  const float k = 2.0f * dot3(d, n);
  return F3{d.x - k * n.x, d.y - k * n.y, d.z - k * n.z};
}

// x ** 5 as JAX's integer_pow computes it
__device__ __forceinline__ float pow5(const float x) {
  const float x2 = x * x;
  return x * (x2 * x2);
}

// pt_core.hemisphere_from_uv
__device__ __forceinline__ F3 hemisphere(const float u1, const float u2) {
  const float r = sqrtf(fmaxf(0.0f, 1.0f - u1 * u1));
  const float phi = TWO_PI * u2;
  return F3{cosf(phi) * r, sinf(phi) * r, u1};
}

// pt_core.onb_local: the reference Onb about w applied to `vec`
__device__ __forceinline__ F3 onb_local(const F3 w, const F3 vec) {
  const bool big_x = fabsf(w.x) > 0.9f;
  const float ax = big_x ? 0.0f : 1.0f, ay = big_x ? 1.0f : 0.0f;
  const F3 v = normalize3(F3{w.y * 0.0f - w.z * ay, w.z * ax - w.x * 0.0f,
                             w.x * ay - w.y * ax});
  const F3 u{w.y * v.z - w.z * v.y, w.z * v.x - w.x * v.z,
             w.x * v.y - w.y * v.x};
  return F3{vec.x * u.x + vec.y * v.x + vec.z * w.x,
            vec.x * u.y + vec.y * v.y + vec.z * w.y,
            vec.x * u.z + vec.y * v.z + vec.z * w.z};
}

// pt_core.fresnel_conductor, one channel
__device__ __forceinline__ float fresnel_chan(const float cos_i,
                                              const float cos2,
                                              const float sin2,
                                              const float sin4, const float er,
                                              const float ei) {
  const float temp1 = er * er - ei * ei - sin2;
  const float a2pb2 =
      sqrtf(fmaxf(temp1 * temp1 + 4.0f * ei * ei * er * er, 0.0f));
  const float a = sqrtf(fmaxf(0.5f * (a2pb2 + temp1), 0.0f));
  const float t1 = a2pb2 + cos2;
  const float t2 = 2.0f * cos_i * a;
  const float t3 = a2pb2 * cos2 + sin4;
  const float t4 = t2 * sin2;
  const float r_s = (t1 - t2) / (t1 + t2);
  const float r_p = r_s * (t3 - t4) / (t3 + t4);
  return 0.5f * (r_s + r_p);
}

// pt_core._smith_g1
__device__ __forceinline__ float smith_g1(const F3 v, const F3 h, const F3 n,
                                          const float alpha2) {
  const float cos_vn = dot3(v, n);
  const bool bad = cos_vn * dot3(v, h) <= 0.0f;
  const float cos2 = cos_vn * cos_vn;
  const float tan2 = (1.0f - cos2) / fmaxf(cos2, 1e-12f);
  float g = 2.0f / (1.0f + sqrtf(1.0f + alpha2 * tan2));
  g = (fabsf(cos_vn - 1.0f) < 1e-7f) ? 1.0f : g;
  return bad ? 0.0f : g;
}

// One BSDF scatter (pt_core.bsdf_bounce's selected lobe) at a hit with
// stored normal `nrm`, incoming direction `d` and material row `mt`: the new
// direction and the throughput weight.  `u3` is drawn only by the lobes
// that use it.
// `df` and `al` point at the diffuse and albedo colours: the row's, or
// texels in the texture forms.
__device__ __forceinline__ void bsdf_scatter(
    const float* __restrict__ mt, const float* __restrict__ df,
    const float* __restrict__ al, const F3 d, const F3 nrm, const float u1, const float u2,
    const uint32_t upid, const uint32_t sp, const uint32_t bseed, F3* new_d,
    F3* w) {
  switch ((int)mt[M_LOBE]) {
    case 1: {  // conductor_scatter
      const F3 n = normalize3(nrm);
      const F3 l = normalize3(reflect3(d, n));
      const float cos_l = fabsf(dot3(l, n));
      const float cos2 = cos_l * cos_l;
      const float sin2 = 1.0f - cos2;
      const float sin4 = sin2 * sin2;
      const float* er = mt + M_ETA_R;
      const float* ei = mt + M_ETA_I;
      *new_d = l;
      *w = F3{fresnel_chan(cos_l, cos2, sin2, sin4, er[0], ei[0]) * cos_l *
                  al[0],
              fresnel_chan(cos_l, cos2, sin2, sin4, er[1], ei[1]) * cos_l *
                  al[1],
              fresnel_chan(cos_l, cos2, sin2, sin4, er[2], ei[2]) * cos_l *
                  al[2]};
      return;
    }
    case 2: {  // glass_scatter
      const float u3 = hash_uniform(upid, sp, 6u, bseed);
      const float ior = mt[M_IOR];
      const F3 n0 = normalize3(nrm);
      const bool inside = dot3(d, n0) > 0.0f;
      const F3 n = inside ? F3{-n0.x, -n0.y, -n0.z} : n0;
      const float ior_rel = inside ? 1.0f / ior : ior;
      const F3 reflex = normalize3(reflect3(d, n));
      const float n12 = (ior_rel - 1.0f) / (ior_rel + 1.0f);
      const float f0 = n12 * n12;
      const float vdotn = fabsf(dot3(d, n));
      const float one_m = 1.0f - vdotn;
      const float f = f0 + (1.0f - f0) * pow5(one_m);
      const float x_ = one_m / ior_rel;
      const bool choose_reflect = (x_ > 1.0f) || (u3 < f);
      if (choose_reflect) {
        *new_d = reflex;
      } else {
        const F3 xa =
            normalize3(F3{reflex.x + d.x, reflex.y + d.y, reflex.z + d.z});
        const F3 ya{-n.x, -n.y, -n.z};
        const float y_ = sqrtf(fmaxf(1.0f - x_ * x_, 0.0f));
        *new_d = normalize3(F3{xa.x * x_ + ya.x * y_, xa.y * x_ + ya.y * y_,
                               xa.z * x_ + ya.z * y_});
      }
      *w = F3{mt[M_ABSORBED], mt[M_ABSORBED + 1], mt[M_ABSORBED + 2]};
      return;
    }
    case 3: {  // microfacet_scatter
      const F3 n = normalize3(nrm);
      const float rough = mt[M_ROUGH];
      const float alpha2 = rough * rough;
      const float phi = TWO_PI * u2;
      const float tan_theta2 = alpha2 * u1 / fmaxf(1.0f - u1, 1e-12f);
      const float cos_theta = 1.0f / sqrtf(1.0f + tan_theta2);
      const float sin_theta =
          sqrtf(fmaxf(1.0f - cos_theta * cos_theta, 0.0f));
      const F3 h = normalize3(onb_local(
          n, F3{sin_theta * cosf(phi), sin_theta * sinf(phi), cos_theta}));
      const F3 l = normalize3(reflect3(d, h));
      const F3 v{-d.x, -d.y, -d.z};
      const float cos_i = dot3(l, n);
      const bool valid = (dot3(d, n) < 0.0f) && (cos_i > 0.0f);
      const float f0 = mt[M_F0], metal = mt[M_METAL];
      const float ldoth = fabsf(dot3(l, h));
      const float om = pow5(1.0f - ldoth);
      const float g = smith_g1(l, h, n, alpha2) * smith_g1(v, h, n, alpha2);
      const float cos_o = fabsf(dot3(n, v));
      const float wt = valid ? g * ldoth / fmaxf(cos_o, 1e-12f) : 0.0f;
      float fr[3];
      for (int c = 0; c < 3; ++c) {
        const float spec_f0 = (1.0f - metal) * f0 + metal * al[c];
        fr[c] = spec_f0 + (1.0f - spec_f0) * om;
      }
      *new_d = l;
      *w = F3{fr[0] * wt * al[0], fr[1] * wt * al[1], fr[2] * wt * al[2]};
      return;
    }
    case 4: {  // plastic_scatter
      const float u3 = hash_uniform(upid, sp, 6u, bseed);
      const float ior = mt[M_IOR];
      const F3 n = normalize3(nrm);
      const float cos_i = fabsf(dot3(d, n));
      const float n12 = (ior - 1.0f) / (ior + 1.0f);
      const float f0 = n12 * n12;
      const float f = f0 + (1.0f - f0) * pow5(1.0f - cos_i);
      if (u3 < f) {
        *new_d = normalize3(reflect3(d, n));
        *w = F3{al[0], al[1], al[2]};
      } else {
        const F3 dd = normalize3(onb_local(n, hemisphere(u1, u2)));
        const float cos_d = dot3(n, dd);
        *new_d = dd;
        *w = F3{df[0] * 2.0f * cos_d, df[1] * 2.0f * cos_d,
                df[2] * 2.0f * cos_d};
      }
      return;
    }
    default: {  // Lambertian lobe about the stored normal
      const F3 dd = normalize3(onb_local(nrm, hemisphere(u1, u2)));
      const float cos_d = dot3(nrm, dd);
      *new_d = dd;
      *w = F3{df[0] * 2.0f * cos_d, df[1] * 2.0f * cos_d,
              df[2] * 2.0f * cos_d};
      return;
    }
  }
}

// The Pallas kernel's polynomial atan2 (pt_pallas._atan2_approx)
__device__ __forceinline__ float atan2_approx(const float y, const float x) {
  const float ax = fabsf(x), ay = fabsf(y);
  const float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  const float a = mn / fmaxf(mx, 1e-30f);
  const float s = a * a;
  float r = a * (0.99997726f +
                 s * (-0.33262347f +
                      s * (0.19354346f +
                           s * (-0.11643287f +
                                s * (0.05265332f - 0.01172120f * s)))));
  r = (ay > ax) ? HALF_PI_F - r : r;
  r = (x < 0.0f) ? PI_F - r : r;
  return (y < 0.0f) ? -r : r;
}

// equirect (u, v) of a unit direction, with the polynomial angles
__device__ __forceinline__ void env_uv(const float dx, const float dy,
                                       const float dz, float* u, float* v) {
  const float yc = fminf(fmaxf(dy, -1.0f), 1.0f);
  const float asin_y =
      atan2_approx(yc, sqrtf(fmaxf(1.0f - yc * yc, 0.0f)));
  *u = 0.5f + atan2_approx(dz, dx) * INV_2PI_F;
  *v = 0.5f - asin_y * INV_PI_F;
}

__device__ __forceinline__ int clamp_index(const float x, const int n) {
  return min(max((int)x, 0), n - 1);
}

// The binned texel of (tu, tv) in the texture whose index is within 0.5 of
// `tid` (ops/texture.make_tex_resolver); false when no texture matches.
__device__ __forceinline__ bool tex_lookup(const float* __restrict__ tex_tab,
                                           const int n_tex, const float tu,
                                           const float tv, const float tid,
                                           float* out) {
  int hit = -1;
  for (int i = 0; i < n_tex; ++i) {
    if (tid > (float)i - 0.5f && tid < (float)i + 0.5f) hit = i;
  }
  if (hit < 0) return false;
  const float u = (tu < 0.0f || tu > 1.0f) ? tu - floorf(tu) : tu;
  const float v = (tv < 0.0f || tv > 1.0f) ? tv - floorf(tv) : tv;
  const int col = clamp_index(u * TEX_LANES, TEX_LANES);
  const int row = clamp_index((1.0f - v) * TEX_ROWS, TEX_ROWS);
  const float* t = tex_tab + (size_t)hit * 3 * TEX_ROWS * TEX_LANES +
                   row * TEX_LANES + col;
  out[0] = t[0];
  out[1] = t[TEX_ROWS * TEX_LANES];
  out[2] = t[2 * TEX_ROWS * TEX_LANES];
  return true;
}

// The material row of a mesh hit's id, as the JAX select chain over the
// material table picks it (mesh_pallas._channels_from_mat): the id's row
// when it equals a material index above 0, else row 0.
__device__ __forceinline__ int mesh_mat_row(const float mat, const int n_mat) {
  const int mi = (int)mat;
  return ((float)mi == mat && mi >= 1 && mi < n_mat) ? mi : 0;
}

// The mesh forms (B1e and its texture form): the BSDF bounce around the
// warp sweep.  Their scene table holds no triangles (the
// launcher checks), so the dense pass is spheres and planes.

// A jittered camera ray of sample `sp` of pixel (pxf, pyf) (thin lens when
// lens_r > 0), normalised, in the plain version's order.
__device__ __forceinline__ void camera_ray(const CamArgs& cam,
                                           const uint32_t upid,
                                           const uint32_t sp,
                                           const uint32_t seed,
                                           const float pxf, const float pyf,
                                           float& ox, float& oy, float& oz,
                                           float& dx, float& dy, float& dz) {
  const float rx = hash_uniform(upid, sp, 0u, seed) * 2.0f - 1.0f;
  const float ry = hash_uniform(upid, sp, 1u, seed) * 2.0f - 1.0f;
  const float s = (pxf + rx) * cam.inv_w;
  const float t = (pyf + ry) * cam.inv_h;
  ox = cam.pos[0];
  oy = cam.pos[1];
  oz = cam.pos[2];
  if (cam.lens_r > 0.0f) {
    const float lr = sqrtf(hash_uniform(upid, sp, 2u, seed)) * cam.lens_r;
    const float phi = hash_uniform(upid, sp, 3u, seed) * TWO_PI;
    const float du = lr * cosf(phi);
    const float dv = lr * sinf(phi);
    ox = cam.pos[0] + du * cam.u[0] + dv * cam.v[0];
    oy = cam.pos[1] + du * cam.u[1] + dv * cam.v[1];
    oz = cam.pos[2] + du * cam.u[2] + dv * cam.v[2];
  }
  dx = cam.ll[0] + s * cam.hor[0] + t * cam.ver[0] - ox;
  dy = cam.ll[1] + s * cam.hor[1] + t * cam.ver[1] - oy;
  dz = cam.ll[2] + s * cam.hor[2] + t * cam.ver[2] - oz;
  const float inv_len = rsqrtf(dx * dx + dy * dy + dz * dz);
  dx *= inv_len;
  dy *= inv_len;
  dz *= inv_len;
}

// The closest hit over spheres and planes (the dense pass without
// triangles): t (INFINITY on a miss), normal and material row.
__device__ __forceinline__ float sphere_plane_hit(
    const float* __restrict__ sph, const float* __restrict__ pln,
    const SceneCounts& nc, const float t_min, const float ox, const float oy,
    const float oz, const float dx, const float dy, const float dz,
    float& nx, float& ny, float& nz, int& m_best) {
  float t_best = INFINITY;
  nx = ny = nz = 0.0f;
  m_best = 0;
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
    const float th = (ok && t1 >= t_min) ? t1
                                         : ((ok && t2 >= t_min) ? t2
                                                                : INFINITY);
    if (th < t_best) {
      t_best = th;
      nx = (ox + th * dx - p[0]) * p[4];
      ny = (oy + th * dy - p[1]) * p[4];
      nz = (oz + th * dz - p[2]) * p[4];
      m_best = (int)p[5];
    }
  }
  for (int i = 0; i < nc.n_pln; ++i) {
    const float* p = pln + i * PLN_STRIDE;
    const float th = patch_t(p, ox, oy, oz, dx, dy, dz, t_min);
    if (th < t_best) {
      t_best = th;
      nx = p[3];
      ny = p[4];
      nz = p[5];
      m_best = (int)p[13];
    }
  }
  return t_best;
}

// The BSDF estimator with the blocked pool swept by the warp sweep, one
// thread a pixel on a plain grid, in one flat loop per thread: an
// iteration is one bounce of whichever sample the lane is on.  The warp
// sweep needs all 32 lanes at every call, so every lane runs every
// iteration while any lane of the warp has samples left; a lane with no
// path (its path ended, its pixel done, or past the range) sweeps with no
// ray, a helper with cap -inf.  A lane whose path ends adds the sample
// into its pixel's sum and waits; the waiting lanes start their next
// samples together once kRegenEighths / 8 of the lanes with samples left
// wait.  Measured on the mesh cell's launch (ico_5120, 40 blocks, 500x500,
// 32 spp, depth 20) on an H100 (PERF.md §6):
//   - the nested loop this replaced (samples around bounces, every lane
//     waiting for the warp's longest path): 35% of lane slots live, 47.3-
//     47.9 ms; each iteration pays the sweep's slab step for each block;
//   - each lane starting its next sample at once (kRegenEighths 0): 77-79%
//     live, yet 46.2-47.1 ms: the lanes' rays drift apart in bounce, so
//     fewer lanes enter a block together and the sweep takes 46% more
//     blocks a lane at a time (its sparse steps, each a serial chain of
//     shuffles);
//   - half (4): 65% live, camera rays starting together, 41.5-42.3 ms;
//     3, 5 and 6 were up to 1.5% slower, 8 (the nested schedule) 49.1 ms;
//   - a persistent grid, lanes taking pixels from a counter, lost the
//     coherence of a warp's 32 neighbouring pixels (2-3% slower); warps
//     taking 32 pixels at a time matched the plain grid.
// The loop's one exit is its test: a branch inside the body rejoins at the
// body's end.  The film is read once and written once per pixel, the
// samples added in order, each with the plain version's float operations
// and hash arguments: its sums bit for bit.  The launch bound leaves the
// loop 79 registers (85 textured) and no spill; ptxas took 72 and spilled
// 8 B without it, at 6 blocks an SM 77: 1-3% slower each.
//
// `loop_slots` (two counters, device): each warp adds at its exit the lane
// slots it ran (32 a loop iteration) and those of lanes with a path
// (the bounces), from the loop's own ballots (pt_cuda.mesh_loop_slots;
// pt_cuda.loop_slots' "grouped" model gives the same slots).
constexpr int kRegenEighths = 4;

template <bool kTex>
__global__ void __launch_bounds__(128, 5)
pt_mesh_kernel(float* __restrict__ film, const float* __restrict__ scene,
               const SceneCounts nc, const CamArgs cam, const int width,
               const int pix0, const int pix_end, const int sp0,
               const int n_spp, const int depth, const uint32_t seed,
               const nr_mesh::MeshArgs mesh,
               const float* __restrict__ tex_tab, const int n_tex,
               unsigned long long* __restrict__ loop_slots) {
  const int pid = pix0 + blockIdx.x * blockDim.x + threadIdx.x;
  if (n_spp <= 0) return;

  const float* __restrict__ sph = scene;
  const float* __restrict__ pln = sph + nc.n_sph * SPH_STRIDE;
  const float* __restrict__ al = pln + nc.n_pln * PLN_STRIDE;
  const float* __restrict__ mat = al + nc.n_al * AL_STRIDE;
  const float* __restrict__ amb = mat + nc.n_mat * MAT_STRIDE;

  if (depth <= 0) {  // every sample is the ambient term alone
    if (pid >= pix_end) return;
    float fr = film[3 * pid + 0];
    float fg = film[3 * pid + 1];
    float fb = film[3 * pid + 2];
    for (int k = 0; k < n_spp; ++k) {
      const float tr = 1.0f, tg = 1.0f, tb = 1.0f;
      float rr = 0.0f, rg = 0.0f, rb = 0.0f;
      rr += tr * amb[0];
      rg += tg * amb[1];
      rb += tb * amb[2];
      fr += rr;
      fg += rg;
      fb += rb;
    }
    film[3 * pid + 0] = fr;
    film[3 * pid + 1] = fg;
    film[3 * pid + 2] = fb;
    return;
  }

  bool has_px = pid < pix_end;  // the lane has a pixel with samples left
  bool alive = has_px;          // and a path at its bounce b
  const int py = pid / width;
  const int px = pid - py * width;
  float fr = 0.0f, fg = 0.0f, fb = 0.0f;
  if (has_px) {
    fr = film[3 * pid + 0];
    fg = film[3 * pid + 1];
    fb = film[3 * pid + 2];
  }
  int k = 0;  // the sample, from sp0
  int b = 0;  // its bounce
  float ox, oy, oz, dx, dy, dz;
  camera_ray(cam, (uint32_t)pid, (uint32_t)sp0, seed, (float)px, (float)py,
             ox, oy, oz, dx, dy, dz);
  float tr = 1.0f, tg = 1.0f, tb = 1.0f;
  unsigned iters = 0, live = 0;  // the warp's loop iterations, live lanes
  for (unsigned work; (work = __ballot_sync(nr_mesh::kFullMask, has_px));) {
    // lanes whose path has ended start their next sample together, once
    // kRegenEighths / 8 of the lanes with work wait
    const unsigned waiting =
        __ballot_sync(nr_mesh::kFullMask, has_px && !alive);
    if (waiting != 0u &&
        8 * __popc(waiting) >= kRegenEighths * __popc(work) && !alive &&
        has_px) {
      b = 0;
      camera_ray(cam, (uint32_t)pid, (uint32_t)(sp0 + k), seed, (float)px,
                 (float)py, ox, oy, oz, dx, dy, dz);
      tr = 1.0f;
      tg = 1.0f;
      tb = 1.0f;
      alive = true;
    }
    ++iters;
    live += __popc(__ballot_sync(nr_mesh::kFullMask, alive));
    const uint32_t upid = (uint32_t)pid;
    const uint32_t sp = (uint32_t)(sp0 + k);
    const uint32_t bseed = seed + (uint32_t)b * 0x9E3779B1u;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f;
    int m_best = 0;
    float t_best = -INFINITY;
    if (alive) {
      t_best = sphere_plane_hit(sph, pln, nc, cam.t_min, ox, oy, oz, dx, dy,
                                dz, nx, ny, nz, m_best);
    }
    nr_mesh::SweepHit sh;
    nr_mesh::warp_sweep<kTex>(mesh, ox, oy, oz, dx, dy, dz, cam.t_min,
                              t_best, -1, sh);
    if (!alive) continue;
    float hu = 0.0f, hv = 0.0f, htex = -1.0f;
    if (sh.idx >= 0.0f) {
      t_best = sh.t;
      nx = sh.nx;
      ny = sh.ny;
      nz = sh.nz;
      m_best = mesh_mat_row(sh.mat, nc.n_mat);
      if constexpr (kTex) {
        hu = sh.u;
        hv = sh.v;
        htex = sh.tex;
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
    // the sample's radiance, added into the pixel's sum when its path ends
    float rr = 0.0f, rg = 0.0f, rb = 0.0f;
    if ((t_best < INFINITY) && (t_best < t_l)) {
      const float u1 = hash_uniform(upid, sp, 4u, bseed);
      const float u2 = hash_uniform(upid, sp, 5u, bseed);
      const float* mt = mat + m_best * MAT_STRIDE;
      const float* df = mt + M_DIFFUSE;
      const float* alb = mt + M_ALBEDO;
      float tdf[3], tal[3];
      if constexpr (kTex) {
        if (tex_lookup(tex_tab, n_tex, hu, hv, htex, tdf)) df = tdf;
        if (tex_lookup(tex_tab, n_tex, hu, hv, mt[M_STEX], tal)) alb = tal;
      }
      F3 nd, w;
      bsdf_scatter(mt, df, alb, F3{dx, dy, dz}, F3{nx, ny, nz}, u1, u2, upid,
                   sp, bseed, &nd, &w);
      tr = tr * w.x;
      tg = tg * w.y;
      tb = tb * w.z;
      ox = ox + t_best * dx;
      oy = oy + t_best * dy;
      oz = oz + t_best * dz;
      dx = nd.x;
      dy = nd.y;
      dz = nd.z;
      alive = ++b < depth;
      if (!alive) {  // depth cap: ambient constant
        rr += tr * amb[0];
        rg += tg * amb[1];
        rb += tb * amb[2];
      }
    } else {
      if (t_l < INFINITY) {  // the light comes first
        rr += tr * lr_;
        rg += tg * lg_;
        rb += tb * lb_;
      }
      alive = false;
    }
    if (!alive) {  // the path ended: its sample into the pixel's sum
      fr += rr;
      fg += rg;
      fb += rb;
      if (++k == n_spp) {  // the pixel is done
        film[3 * pid + 0] = fr;
        film[3 * pid + 1] = fg;
        film[3 * pid + 2] = fb;
        has_px = false;
      }
    }
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(loop_slots, 32ull * iters);
    atomicAdd(loop_slots + 1, (unsigned long long)live);
  }
}

// The dense pool, one kernel: B1a (pt_diffuse_kernel), B1b
// (pt_bsdf_kernel), B1c (the env forms, kEnv) and B1d's dense texture
// forms (kTex, with or without kEnv), each form's estimator in one flat
// loop per thread.  An iteration is one bounce of whichever sample the
// thread is on; the iteration that ends a path (a miss, a light hit, or
// the depth cap with the ambient term) adds the sample into the pixel's sum
// and builds the next sample's camera ray, so a lane whose path ended early
// goes on with its next sample instead of waiting for the warp's longest
// path.  Each sample's float operations, the hash arguments and the order
// in which samples are added are the plain version's
// (pt_cuda.pt_accumulate_plain), and the film is read once when a pixel
// starts and written once when it is done: the same sums bit for bit.
//
// The env forms run at least one bounce (the Pallas kernel peels bounce
// 0).  A path that misses everything adds throughput * a texel and ends:
// at bounce 0 the map's native texel, later the binned one, looked up at
// the miss itself.  A path's radiance is 0 until it ends, so 0 + thr * bin
// is the plain version's deferred sum (bins looked up after the bounce
// loop) bit for bit, and no miss record stays live across the loop.  The
// texture forms keep the winning triangle and its barycentrics through the
// light test and resolve its UV row and texels when the path scatters.
//
// Persistent: the grid holds only the blocks that fit on the card at once
// (kDenseMinBlocks blocks of 128 an SM), and a thread that has done its
// pixel takes the next from a counter (`next_pixel`, zeroed before each
// launch), a warp's free lanes together with one atomicAdd.  A thread
// still owns each pixel it takes whole, for the launch's samples.
//
// B1a reads the primitives from `rec`: each primitive's row of the scene
// table padded to whole float4s (pt_cuda.dense_records: spheres 2,
// triangles, planes and lights 4), in float4 loads, a quarter of the load
// instructions.  The other forms read the table itself: with records B1b's
// lobe math spilled and it ran slower (PERF.md §6), and the diffuse env and
// texture forms spilled 28-56 B at no gain.
constexpr int kDenseMinBlocks = 8;
constexpr int SPH_REC = 2, TRI_REC = 4, PLN_REC = 4, AL_REC = 4;

// `n` float4 records from `r` into `q`
__device__ __forceinline__ void load_records(float* q,
                                             const float4* __restrict__ r,
                                             const int n) {
  for (int j = 0; j < n; ++j) {
    const float4 v = r[j];
    q[4 * j + 0] = v.x;
    q[4 * j + 1] = v.y;
    q[4 * j + 2] = v.z;
    q[4 * j + 3] = v.w;
  }
}

// The next pixel of a thread that has done one: `first` past the counter's
// value, the lanes of the warp that ask at once taking consecutive ones.
__device__ __forceinline__ int take_pixel(int* __restrict__ next_pixel,
                                          const int first) {
  const unsigned mask = __activemask();
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(next_pixel, __popc(mask));
  base = __shfl_sync(mask, base, leader);
  return first + base + __popc(mask & ((1u << lane) - 1u));
}

// kRange: the launch covers pixels [pix0, pix_end) only.  `film` is then
// indexed by the global pixel id, as in the mesh forms, while the loop
// counts the range's pixels (pid, rows of `band`) and adds pix0 for the
// hash and the camera (a global loop index cost 4 B more spill loads on an
// H100).  A whole-film launch takes the loop without the range, which is
// the main path's code as it was (the range's arithmetic cost the BSDF
// form a register and 1-2% of its launch time on an H100, PERF.md).
template <bool kBsdf, bool kEnv, bool kTex, bool kRange>
__global__ void __launch_bounds__(128, kDenseMinBlocks)
pt_dense_kernel(float* __restrict__ film, const float* __restrict__ scene,
                const SceneCounts nc, const CamArgs cam, const int width,
                const int height, const int pix0, const int pix_end,
                const int sp0, const int n_spp, const int depth,
                const uint32_t seed, int* __restrict__ next_pixel,
                const float4* __restrict__ rec,
                const float* __restrict__ env_bin,
                const float* __restrict__ env_map, const int env_h,
                const int env_w, const float* __restrict__ tex_tab,
                const int n_tex) {
  const int p0 = kRange ? pix0 : 0;
  const int n_lanes = gridDim.x * blockDim.x;
  const int n_pix = kRange ? pix_end - pix0 : width * height;
  float* __restrict__ band = kRange ? film + 3 * pix0 : film;
  int pid = blockIdx.x * blockDim.x + threadIdx.x;
  if (pid >= n_pix || n_spp <= 0) return;

  const float* __restrict__ sph = scene;
  const float* __restrict__ tri = sph + nc.n_sph * SPH_STRIDE;
  const float* __restrict__ pln = tri + nc.n_tri * TRI_STRIDE;
  const float* __restrict__ al = pln + nc.n_pln * PLN_STRIDE;
  const float* __restrict__ mat = al + nc.n_al * AL_STRIDE;
  const float* __restrict__ amb = mat + nc.n_mat * MAT_STRIDE;
  const float* __restrict__ uvtab = amb + 3;  // texture forms only
  const float4* __restrict__ sph_r = rec;
  const float4* __restrict__ tri_r = sph_r + nc.n_sph * SPH_REC;
  const float4* __restrict__ pln_r = tri_r + nc.n_tri * TRI_REC;
  const float4* __restrict__ al_r = pln_r + nc.n_pln * PLN_REC;
  constexpr bool kRec = !(kBsdf || kEnv || kTex);
  // the env forms peel bounce 0, so they run it even at depth 0
  const int n_bounces = (kEnv && depth < 1) ? 1 : depth;

  if (n_bounces <= 0) {  // every sample is the ambient term alone
    for (; pid < n_pix; pid += n_lanes) {
      float fr = band[3 * pid + 0];
      float fg = band[3 * pid + 1];
      float fb = band[3 * pid + 2];
      for (int k = 0; k < n_spp; ++k) {
        const float tr = 1.0f, tg = 1.0f, tb = 1.0f;
        float rr = 0.0f, rg = 0.0f, rb = 0.0f;
        rr += tr * amb[0];
        rg += tg * amb[1];
        rb += tb * amb[2];
        fr += rr;
        fg += rg;
        fb += rb;
      }
      band[3 * pid + 0] = fr;
      band[3 * pid + 1] = fg;
      band[3 * pid + 2] = fb;
    }
    return;
  }

  int py = (pid + p0) / width;
  int px = (pid + p0) - py * width;
  float fr = band[3 * pid + 0];
  float fg = band[3 * pid + 1];
  float fb = band[3 * pid + 2];
  int k = 0;  // the sample, from sp0
  int b = 0;  // its bounce
  float ox, oy, oz, dx, dy, dz;
  camera_ray(cam, (uint32_t)(pid + p0), (uint32_t)sp0, seed, (float)px,
             (float)py, ox, oy, oz, dx, dy, dz);
  float tr = 1.0f, tg = 1.0f, tb = 1.0f;
  // The loop's one exit is its test: a branch inside the body rejoins at
  // the body's end, so the lanes that start a sample and those that
  // scatter run the next bounce together (a `break` in the body would
  // keep them apart until the loop ends).
  while (pid < n_pix) {
    const uint32_t upid = (uint32_t)(pid + p0);
    const uint32_t sp = (uint32_t)(sp0 + k);
    const uint32_t bseed = seed + (uint32_t)b * 0x9E3779B1u;
    const float u1 = hash_uniform(upid, sp, 4u, bseed);
    const float u2 = hash_uniform(upid, sp, 5u, bseed);

    // closest hit: spheres, triangles, planes; first strictly closer wins
    float t_best = INFINITY, nx = 0.0f, ny = 0.0f, nz = 0.0f;
    int m_best = 0;
    int tri_best = -1;           // texture forms: the winning triangle
    float bu = 0.0f, bv = 0.0f;  // and its barycentrics
    for (int i = 0; i < nc.n_sph; ++i) {
      float q[4 * SPH_REC];
      const float* p = sph + i * SPH_STRIDE;
      if constexpr (kRec) {
        load_records(q, sph_r + i * SPH_REC, SPH_REC);
        p = q;
      }
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
        if constexpr (kTex) tri_best = -1;
      }
    }
    for (int i = 0; i < nc.n_tri; ++i) {
      float q[4 * TRI_REC];
      const float* p = tri + i * TRI_STRIDE;
      if constexpr (kRec) {
        load_records(q, tri_r + i * TRI_REC, TRI_REC);
        p = q;
      }
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
        if constexpr (kTex) {
          const float inv_det = 1.0f / (det == 0.0f ? 1.0f : det);
          tri_best = i;
          bu = u * inv_det;
          bv = v * inv_det;
        }
      }
    }
    for (int i = 0; i < nc.n_pln; ++i) {
      float q[4 * PLN_REC];
      const float* p = pln + i * PLN_STRIDE;
      if constexpr (kRec) {
        load_records(q, pln_r + i * PLN_REC, PLN_REC);
        p = q;
      }
      const float th = patch_t(p, ox, oy, oz, dx, dy, dz, cam.t_min);
      if (th < t_best) {
        t_best = th;
        nx = p[3];
        ny = p[4];
        nz = p[5];
        m_best = (int)p[13];
        if constexpr (kTex) tri_best = -1;
      }
    }
    float t_l = INFINITY, lr_ = 0.0f, lg_ = 0.0f, lb_ = 0.0f;
    for (int i = 0; i < nc.n_al; ++i) {
      float q[4 * AL_REC];
      const float* p = al + i * AL_STRIDE;
      if constexpr (kRec) {
        load_records(q, al_r + i * AL_REC, AL_REC);
        p = q;
      }
      const float th = patch_t(p, ox, oy, oz, dx, dy, dz, cam.t_min);
      if (th < t_l) {
        t_l = th;
        lr_ = p[13];
        lg_ = p[14];
        lb_ = p[15];
      }
    }

    // the sample's radiance, added into the pixel's sum when its path ends
    float rr = 0.0f, rg = 0.0f, rb = 0.0f;
    bool ended = true;
    if ((t_best < INFINITY) && (t_best < t_l)) {
      // the hit's texture coordinates: (0, 0, -1) unless a textured face
      float hu = 0.0f, hv = 0.0f, htex = -1.0f;
      if constexpr (kTex) {
        if (tri_best >= 0) {
          const float* q = uvtab + tri_best * UV_STRIDE;
          hu = q[0] + (bu * q[2] + bv * q[4]);
          hv = q[1] + (bu * q[3] + bv * q[5]);
          htex = q[6];
        }
      }
      if constexpr (kBsdf) {
        const float* mt = mat + m_best * MAT_STRIDE;
        const float* dfp = mt + M_DIFFUSE;
        const float* alp = mt + M_ALBEDO;
        float tdf[3], tal[3];
        if constexpr (kTex) {
          if (tex_lookup(tex_tab, n_tex, hu, hv, htex, tdf)) dfp = tdf;
          if (tex_lookup(tex_tab, n_tex, hu, hv, mt[M_STEX], tal)) alp = tal;
        }
        F3 nd, w;
        bsdf_scatter(mt, dfp, alp, F3{dx, dy, dz}, F3{nx, ny, nz}, u1, u2,
                     upid, sp, bseed, &nd, &w);
        tr = tr * w.x;
        tg = tg * w.y;
        tb = tb * w.z;
        ox = ox + t_best * dx;
        oy = oy + t_best * dy;
        oz = oz + t_best * dz;
        dx = nd.x;
        dy = nd.y;
        dz = nd.z;
      } else {
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
        const float* alb = mat + m_best * MAT_STRIDE + M_DIFFUSE;
        float ar = alb[0], ag = alb[1], ab = alb[2];
        if constexpr (kTex) {
          float t[3];
          if (tex_lookup(tex_tab, n_tex, hu, hv, htex, t)) {
            ar = t[0];
            ag = t[1];
            ab = t[2];
          }
        }
        tr = tr * (ar * scale);
        tg = tg * (ag * scale);
        tb = tb * (ab * scale);
        ox = ox + t_best * dx;
        oy = oy + t_best * dy;
        oz = oz + t_best * dz;
        dx = ndx;
        dy = ndy;
        dz = ndz;
      }
      ended = ++b == n_bounces;
      if (ended) {  // depth cap: ambient constant
        rr += tr * amb[0];
        rg += tg * amb[1];
        rb += tb * amb[2];
      }
    } else if (t_l < INFINITY) {  // the light comes first
      rr += tr * lr_;
      rg += tg * lg_;
      rb += tb * lb_;
    } else if constexpr (kEnv) {  // a miss: the native texel at bounce 0,
      float u, v;                 // the binned one after it
      env_uv(dx, dy, dz, &u, &v);
      const bool native = b == 0;
      const float* e =
          native ? env_map + 3 * (clamp_index(v * env_h, env_h) * env_w +
                                  clamp_index(u * env_w, env_w))
                 : env_bin + (clamp_index(v * ENV_ROWS, ENV_ROWS) *
                                  ENV_LANES +
                              clamp_index(u * ENV_LANES, ENV_LANES));
      const int c = native ? 1 : ENV_ROWS * ENV_LANES;  // channel stride
      rr += tr * e[0];
      rg += tg * e[c];
      rb += tb * e[2 * c];
    }
    if (ended) {
      fr += rr;
      fg += rg;
      fb += rb;
      if (++k == n_spp) {  // the pixel is done
        band[3 * pid + 0] = fr;
        band[3 * pid + 1] = fg;
        band[3 * pid + 2] = fb;
        pid = take_pixel(next_pixel, n_lanes);
        if (pid < n_pix) {
          py = (pid + p0) / width;
          px = (pid + p0) - py * width;
          fr = band[3 * pid + 0];
          fg = band[3 * pid + 1];
          fb = band[3 * pid + 2];
          k = 0;
        }
      }
      b = 0;
      camera_ray(cam, (uint32_t)(pid + p0), (uint32_t)(sp0 + k), seed,
                 (float)px, (float)py, ox, oy, oz, dx, dy, dz);
      tr = 1.0f;
      tg = 1.0f;
      tb = 1.0f;
    }
  }
}

// One launch's arguments (host side).
struct DenseArgs {
  float* film;
  const float* scene;
  SceneCounts nc;
  CamArgs cam;
  int width, height, pix0, pix_end, sp0, n_spp, depth;
  uint32_t seed;
  int* next_pixel;
  const float4* rec;
  const float* env_bin;
  const float* env_map;
  int env_h, env_w;
  const float* tex_tab;
  int n_tex;
};

// One launch of a dense-pool form: a persistent grid of the blocks that
// fit on the card at once, and the pixel counter cleared first.
template <bool kBsdf, bool kEnv, bool kTex, bool kRange>
int launch_dense(const DenseArgs& a, const int blocks, const int threads,
                 cudaStream_t st) {
  const auto kernel = pt_dense_kernel<kBsdf, kEnv, kTex, kRange>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, 0);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(a.next_pixel, 0, sizeof(int), st);
  if (e != cudaSuccess) return (int)e;
  const int grid =
      (per_sm * sms >= 1 && per_sm * sms < blocks) ? per_sm * sms : blocks;
  kernel<<<grid, threads, 0, st>>>(
      a.film, a.scene, a.nc, a.cam, a.width, a.height, a.pix0, a.pix_end,
      a.sp0, a.n_spp, a.depth, a.seed, a.next_pixel, a.rec, a.env_bin,
      a.env_map, a.env_h, a.env_w, a.tex_tab, a.n_tex);
  return (int)cudaGetLastError();
}

// A form's launch: its whole-film instantiation when the launch covers the
// film, else its range one.
template <bool kBsdf, bool kEnv, bool kTex>
int launch_form(const DenseArgs& a, const bool whole, const int blocks,
                const int threads, cudaStream_t st) {
  return whole ? launch_dense<kBsdf, kEnv, kTex, false>(a, blocks, threads,
                                                         st)
               : launch_dense<kBsdf, kEnv, kTex, true>(a, blocks, threads,
                                                        st);
}

// The hybrid route's bounce (renderers/_wavefront.py on a card): the
// wavefront's state lives in SoA rows in device memory between bounces,
// and each bounce is two launches around the mesh pipe
// (mesh_cuda.intersect_triangles_mesh, unchanged): the dense-hit kernel
// writes the cap the pipe takes, and the shade kernel, given the pipe's
// winner, does the rest of pt_core.bsdf_bounce for each lane in place.
// Both read the mesh forms' scene table (spheres, planes, lights,
// materials: a pool's triangles are the pipe's).  Each lane's float
// operations are the plain bounce's, in its order: under -fmad=false the
// state is the eager bounce's bit for bit (pt_cuda.wavefront_shade).
//
// A dead lane is left as it is.  The eager bounce adds 0 * thr * x to its
// radiance and multiplies its throughput by 1, which leaves both unchanged
// while the throughput is finite.

// A wavefront's state: 12 float32 rows (ox oy oz dx dy dz tx ty tz rx ry
// rz) of n lanes and the alive flags (one byte a lane, 0 or 1).
struct WaveState {
  float* f[12];
  uint8_t* alive;
};

// The mesh pipe's winner of each lane: t (inf on a miss), normal, material
// id.
struct WaveHit {
  const float* t;
  const float* nx;
  const float* ny;
  const float* nz;
  const float* mat;
};

// The dense primitives' closest t of each live lane, 0 for a dead one: the
// cap of the mesh pipe (pt_core.closest_hit's t_cap).
__global__ void __launch_bounds__(256)
wavefront_dense_hit_kernel(const float* __restrict__ scene,
                           const SceneCounts nc, const float t_min,
                           const WaveState s, float* __restrict__ cap,
                           const int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float t = 0.0f;
  if (s.alive[i]) {
    const float* __restrict__ pln = scene + nc.n_sph * SPH_STRIDE;
    float nx, ny, nz;
    int m;
    t = sphere_plane_hit(scene, pln, nc, t_min, s.f[0][i], s.f[1][i],
                         s.f[2][i], s.f[3][i], s.f[4][i], s.f[5][i], nx, ny,
                         nz, m);
  }
  cap[i] = t;
}

// ops/env.sample_env_map_v3 as torch computes it on the card: the
// direction normalised with the floor of eps 1e-12, atan2f and asinf, and
// each division by a constant a product with its float reciprocal (torch
// divides a tensor by a scalar that way on CUDA).
__device__ __forceinline__ void env_exact(const float* __restrict__ env,
                                          const int he, const int we,
                                          const float dx, const float dy,
                                          const float dz, float* out) {
  const float inv =
      rsqrtf(fmaxf(dx * dx + dy * dy + dz * dz, (float)1e-24));
  const float x = dx * inv, y = dy * inv, z = dz * inv;
  const float inv_2pi = 1.0f / (float)(2.0 * PI_D);
  const float inv_pi = 1.0f / (float)PI_D;
  const float u = 0.5f + atan2f(z, x) * inv_2pi;
  const float v = 0.5f - asinf(fminf(fmaxf(y, -1.0f), 1.0f)) * inv_pi;
  const long long xi = min(max((long long)(u * (float)we), 0LL),
                           (long long)we - 1);
  const long long yi = min(max((long long)(v * (float)he), 0LL),
                           (long long)he - 1);
  const float* p = env + 3 * (yi * we + xi);
  out[0] = p[0];
  out[1] = p[1];
  out[2] = p[2];
}

// pt_core.bsdf_bounce for each live lane after the mesh pipe: the dense
// hit again, merged with the pipe's winner (closer = t_mesh < t_dense),
// the material row of the winner, the area-light test, the draws 4-6 at
// `bseed` keyed by the lane's pixel and sample (slot i holds chunk lane
// lane[i]: pixel pix0 + lane % n_pix, sample sp0 + lane / n_pix), the
// effective lobe's scatter, and the state's update in place; with `env`,
// a miss adds throughput * the map's exact texel.
__global__ void __launch_bounds__(256)
wavefront_shade_kernel(const float* __restrict__ scene, const SceneCounts nc,
                       const float t_min, const WaveState s, const WaveHit h,
                       const int32_t* __restrict__ lane, const int n,
                       const int n_pix, const int pix0, const int sp0,
                       const uint32_t bseed, const float* __restrict__ env,
                       const int env_h, const int env_w) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !s.alive[i]) return;
  const float* __restrict__ pln = scene + nc.n_sph * SPH_STRIDE;
  const float* __restrict__ al = pln + nc.n_pln * PLN_STRIDE;
  const float* __restrict__ mat = al + nc.n_al * AL_STRIDE;
  const float ox = s.f[0][i], oy = s.f[1][i], oz = s.f[2][i];
  const float dx = s.f[3][i], dy = s.f[4][i], dz = s.f[5][i];
  float nx, ny, nz;
  int m;
  float t = sphere_plane_hit(scene, pln, nc, t_min, ox, oy, oz, dx, dy, dz,
                             nx, ny, nz, m);
  const float tm = h.t[i];
  if (tm < t) {
    t = tm;
    nx = h.nx[i];
    ny = h.ny[i];
    nz = h.nz[i];
    m = mesh_mat_row(h.mat[i], nc.n_mat);
  }
  float t_l = INFINITY, lr_ = 0.0f, lg_ = 0.0f, lb_ = 0.0f;
  for (int k = 0; k < nc.n_al; ++k) {
    const float* p = al + k * AL_STRIDE;
    const float th = patch_t(p, ox, oy, oz, dx, dy, dz, t_min);
    if (th < t_l) {
      t_l = th;
      lr_ = p[13];
      lg_ = p[14];
      lb_ = p[15];
    }
  }
  const float tr = s.f[6][i], tg = s.f[7][i], tb = s.f[8][i];
  if ((t < INFINITY) && (t < t_l)) {  // the object comes first: scatter
    // the plain form's int64 ids mod 2^32 (lanes are nonnegative)
    const uint32_t li = (uint32_t)lane[i];
    const uint32_t upid = (uint32_t)pix0 + li % (uint32_t)n_pix;
    const uint32_t sp = (uint32_t)sp0 + li / (uint32_t)n_pix;
    const float u1 = hash_uniform(upid, sp, 4u, bseed);
    const float u2 = hash_uniform(upid, sp, 5u, bseed);
    const float* mt = mat + m * MAT_STRIDE;
    F3 nd, w;
    bsdf_scatter(mt, mt + M_DIFFUSE, mt + M_ALBEDO, F3{dx, dy, dz},
                 F3{nx, ny, nz}, u1, u2, upid, sp, bseed, &nd, &w);
    s.f[0][i] = ox + t * dx;
    s.f[1][i] = oy + t * dy;
    s.f[2][i] = oz + t * dz;
    s.f[3][i] = nd.x;
    s.f[4][i] = nd.y;
    s.f[5][i] = nd.z;
    s.f[6][i] = tr * w.x;
    s.f[7][i] = tg * w.y;
    s.f[8][i] = tb * w.z;
    return;
  }
  s.alive[i] = 0;
  float e[3];
  if (t_l < INFINITY) {  // the light comes first
    e[0] = lr_;
    e[1] = lg_;
    e[2] = lb_;
  } else if (env != nullptr) {  // a miss under the env map
    env_exact(env, env_h, env_w, dx, dy, dz, e);
  } else {
    return;
  }
  s.f[9][i] = s.f[9][i] + tr * e[0];
  s.f[10][i] = s.f[10][i] + tg * e[1];
  s.f[11][i] = s.f[11][i] + tb * e[2];
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

// Adds samples [sp0, sp0 + n_spp) of pixels [pix0, pix0 + n_pix) into
// `film` ((n_pix, 3) float32, device; row i is pixel pix0 + i) in place,
// with the instantiation `form` selects: bit 0 BSDF, bit 1 env map, bit 2
// mesh, bit 3 textures (the ten combinations pt_cuda.KERNELS lists; others
// return cudaErrorInvalidValue).  `counts`
// (host): n_sph n_tri n_pln n_al n_mat; `cam` (host): the 22 floats of
// CamArgs; `env_bin` (device): the (3, ENV_ROWS, ENV_LANES) bin table and
// `env_map` (device): the (env_h, env_w, 3) map; `mesh_tris`, `mesh_uvs`,
// `mesh_bb` (device): the blocked pool's tables (csrc/mesh_sweep.cuh;
// `mesh_uvs` with textures); `tex_tab` (device): n_tex binned textures;
// `next_pixel` (device, one int; every form but the mesh ones): the pixel
// counter, zeroed here before the launch; `dense_rec` (device; form 0):
// the primitive records (pt_cuda.dense_records); `loop_slots` (device, two
// counters; the mesh forms): their loop's lane slots and live ones,
// added to.
int nr_pt_render(float* film, const float* scene, const int* counts,
                 const float* cam, int width, int height, int pix0,
                 int n_pix, int sp0, int n_spp,
                 int depth, int seed, int form, const float* env_bin,
                 const float* env_map, int env_h, int env_w,
                 const float* mesh_tris, const float* mesh_uvs,
                 const float* mesh_bb, int n_blocks, int block,
                 const float* tex_tab, int n_tex, int* next_pixel,
                 const float* dense_rec, unsigned long long* loop_slots,
                 void* stream) {
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
  const nr_mesh::MeshArgs mesh{reinterpret_cast<const float4*>(mesh_tris),
                               reinterpret_cast<const float4*>(mesh_uvs),
                               reinterpret_cast<const float4*>(mesh_bb),
                               nullptr, n_blocks, block};
  const bool has_env = env_bin != nullptr && env_map != nullptr;
  const bool has_mesh = mesh_tris != nullptr && mesh_bb != nullptr &&
                        n_blocks > 0 && block > 0;
  const bool has_tex = tex_tab != nullptr && n_tex > 0;
  if (((form & 2) != 0) != has_env || ((form & 4) != 0) != has_mesh ||
      ((form & 8) != 0) != has_tex ||
      ((form & 4) && (form & 8) && mesh_uvs == nullptr))
    return (int)cudaErrorInvalidValue;
  // the mesh forms' dense pass has no triangles (pt_cuda.pack_scene)
  if ((form & 4) && nc.n_tri != 0) return (int)cudaErrorInvalidValue;
  if (pix0 < 0 || n_pix < 1 || pix0 > width * height - n_pix)
    return (int)cudaErrorInvalidValue;
  // The kernels index the film by the global pixel id, which also keys
  // the hash and the camera ray: shifted by the range's first pixel, the
  // film pointer makes row pid - pix0 pixel pid's (host pointer
  // arithmetic only; no row outside the range is read or written).
  film -= 3 * (ptrdiff_t)pix0;
  const int pix_end = pix0 + n_pix;
  const int threads = 128;
  const int blocks = (n_pix + threads - 1) / threads;
  cudaStream_t st = (cudaStream_t)stream;
  if ((form & 4) == 0) {  // the dense pool: the flat loop, persistent
    if (next_pixel == nullptr || (form == 0 && dense_rec == nullptr))
      return (int)cudaErrorInvalidValue;
    const DenseArgs a{film, scene, nc, ca, width, height, pix0, pix_end,
                      sp0, n_spp, depth, (uint32_t)seed, next_pixel,
                      reinterpret_cast<const float4*>(dense_rec), env_bin,
                      env_map, env_h, env_w, tex_tab, n_tex};
    const bool whole = pix0 == 0 && n_pix == width * height;
    switch (form) {
      case 0: return launch_form<false, false, false>(a, whole, blocks,
                                                       threads, st);
      case 1: return launch_form<true, false, false>(a, whole, blocks,
                                                      threads, st);
      case 2: return launch_form<false, true, false>(a, whole, blocks,
                                                      threads, st);
      case 3: return launch_form<true, true, false>(a, whole, blocks,
                                                     threads, st);
      case 8: return launch_form<false, false, true>(a, whole, blocks,
                                                      threads, st);
      case 9: return launch_form<true, false, true>(a, whole, blocks,
                                                     threads, st);
      case 10: return launch_form<false, true, true>(a, whole, blocks,
                                                      threads, st);
      case 11: return launch_form<true, true, true>(a, whole, blocks,
                                                     threads, st);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  // the mesh forms: pt_mesh_kernel on a plain grid
  if ((form != 5 && form != 13) || loop_slots == nullptr)
    return (int)cudaErrorInvalidValue;
  const auto mesh_kernel =
      form == 13 ? pt_mesh_kernel<true> : pt_mesh_kernel<false>;
  mesh_kernel<<<blocks, threads, 0, st>>>(film, scene, nc, ca, width, pix0,
                                          pix_end, sp0, n_spp, depth,
                                          (uint32_t)seed, mesh, tex_tab,
                                          n_tex, loop_slots);
  return (int)cudaGetLastError();
}

// The hybrid route's bounce, launch 1 of 2: `cap[i]` (device, n floats) =
// the dense primitives' closest t of lane i (0 when dead).  `scene`
// (device): the mesh forms' table (no triangles); `counts` (host): n_sph
// n_tri n_pln n_al n_mat; `state` (host array of 12 device pointers): the
// rows of WaveState, of which o and d are read; `alive` (device, n bytes).
int nr_wavefront_dense_hit(const float* scene, const int* counts,
                           float t_min, float* const* state,
                           uint8_t* alive, float* cap, int n, void* stream) {
  const SceneCounts nc{counts[0], counts[1], counts[2], counts[3],
                       counts[4]};
  if (nc.n_tri != 0 || n < 0) return (int)cudaErrorInvalidValue;
  WaveState s;
  for (int k = 0; k < 12; ++k) s.f[k] = state[k];
  s.alive = alive;
  const int threads = 256;
  if (n > 0) {
    wavefront_dense_hit_kernel<<<(n + threads - 1) / threads, threads, 0,
                                 (cudaStream_t)stream>>>(scene, nc, t_min, s,
                                                         cap, n);
  }
  return (int)cudaGetLastError();
}

// The hybrid route's bounce, launch 2 of 2: one pt_core.bsdf_bounce of
// every live lane, given the mesh pipe's winner `hit` (host array of 5
// device pointers: t nx ny nz mat), written into `state` and `alive` in
// place.  `lane` (device, n int32): each slot's chunk lane, whose pixel
// pix0 + lane % n_pix and sample sp0 + lane / n_pix key the draws at
// `bseed`; `env` (device, (env_h, env_w, 3) float32, or null): the map a
// miss looks up.
int nr_wavefront_shade(const float* scene, const int* counts, float t_min,
                       float* const* state, uint8_t* alive,
                       const float* const* hit, const int32_t* lane, int n,
                       int n_pix, int pix0, int sp0, int bseed,
                       const float* env, int env_h, int env_w,
                       void* stream) {
  const SceneCounts nc{counts[0], counts[1], counts[2], counts[3],
                       counts[4]};
  if (nc.n_tri != 0 || n < 0 || n_pix < 1 || pix0 < 0 || sp0 < 0 ||
      nc.n_mat < 1 || (env != nullptr && (env_h < 1 || env_w < 1)))
    return (int)cudaErrorInvalidValue;
  WaveState s;
  for (int k = 0; k < 12; ++k) s.f[k] = state[k];
  s.alive = alive;
  const WaveHit h{hit[0], hit[1], hit[2], hit[3], hit[4]};
  const int threads = 256;
  if (n > 0) {
    wavefront_shade_kernel<<<(n + threads - 1) / threads, threads, 0,
                             (cudaStream_t)stream>>>(
        scene, nc, t_min, s, h, lane, n, n_pix, pix0, sp0, (uint32_t)bseed,
        env, env_h, env_w);
  }
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

// The table layout this library was built with: 0 camera floats,
// 1 material stride, 2 env bin rows, 3 env bin lanes, 4 dense UV stride,
// 5 texture rows, 6 texture lanes.
int nr_layout(int what) {
  switch (what) {
    case 0: return CAM_FLOATS;
    case 1: return MAT_STRIDE;
    case 2: return ENV_ROWS;
    case 3: return ENV_LANES;
    case 4: return UV_STRIDE;
    case 5: return TEX_ROWS;
    case 6: return TEX_LANES;
    default: return -1;
  }
}

const char* nr_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
