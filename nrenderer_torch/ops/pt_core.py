"""Path-tracing bounces on torch tensors.

Counterpart of `nrenderer_tpu/ops/pt_core.py`: the reference's per-bounce
estimators as elementwise torch ops over `(N,)` ray batches, the diffuse
one (`SimplePathTracer.cpp:144-177`) and AccPathTracer's five-lobe one
(`AccPathTracer.cpp:120-181`), over the unrolled dense primitives and,
when given one, a mesh sweep; binned surface textures; and the
counter-based hash that every random draw of the renderer comes from.  The
CUDA kernel (`csrc/pt_kernel.cu`) computes the same functions per thread;
these are its plain form.

Float order follows the JAX module operation by operation.  A Python-int
power there, `x ** 5`, is JAX's `integer_pow`, i.e. repeated squaring:
`pow5` spells out the same products (`torch.pow` rounds differently)."""
from __future__ import annotations

from typing import Tuple

import torch

from .intersect import (
    StaticScene, intersect_area_lights_unrolled, intersect_scene_unrolled,
)
from .soa import V3, cross3, dot3, normalize3, where3

PI = 3.14159265358979323846

_M32 = 0xFFFFFFFF


def scene_epsilon(ss: StaticScene, base: float = 1e-6) -> float:
    """Scale-aware self-intersection epsilon: max(base, 2e-6 * extent).

    The reference's fixed 1e-6 (`SimplePathTracer.cpp:108`) is below the
    float32 ulp at Cornell-box coordinates (~1600 units), so a respawned ray
    could re-hit its own surface; ~3e-3 for the stock Cornell."""
    extent = 1.0
    for (cx, cy, cz, r, _m) in ss.sph:
        extent = max(extent, abs(cx) + r, abs(cy) + r, abs(cz) + r)
    for (v1, e1, e2, _n, _m) in ss.tri:
        for k in range(3):
            extent = max(extent, abs(float(v1[k])),
                         abs(float(v1[k] + e1[k])),
                         abs(float(v1[k] + e2[k])))
    for (pos, _n, _i0, _i1, _m) in ss.pln:
        for k in range(3):
            extent = max(extent, abs(float(pos[k])))
    return max(base, 2e-6 * extent)


def _u32(x) -> torch.Tensor:
    """An int (or int tensor) as its uint32 bit pattern in an int64."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return torch.tensor(int(x) & _M32, dtype=torch.int64)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for a in [0, 2**32) and a constant c: split c into
    16-bit halves so no int64 product overflows."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def hash_uniform(pixel_id, sample, draw, seed) -> torch.Tensor:
    """Stateless counter-based uniform in [0,1): a lowbias32-style integer
    hash of (pixel, sample, draw-site, seed), bit-exact with
    `nrenderer_tpu.ops.pt_core.hash_uniform`.

    JAX multiplies in wrapping int32 and shifts logically; here every value
    is its uint32 pattern held in an int64 (so `>>` is logical) and every
    product is reduced mod 2**32.  The multipliers are the uint32 patterns
    of the JAX function's int32 constants.  Arguments are ints or int
    tensors (any int dtype; int32 negatives wrap as in JAX)."""
    x = (_mul32(_u32(pixel_id), 0x9E3779B9)
         + _mul32(_u32(sample), 0x85EBCA6B)
         + _mul32(_u32(seed), 0x165667B1)
         + _mul32(_u32(draw), 0x27D4EB2F)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x8725E8CD)   # int32 -2027558707, the JAX constant
    x = x ^ (x >> 16)
    # top 24 bits -> [0,1)
    return (x >> 8).to(torch.float32) * (2.0 ** -24)


def bounce_seed(seed: int, b: int) -> int:
    """Per-bounce seed `seed + b * 0x9E3779B1` in wrapping int32, as the
    Pallas kernel forms it (`seed + b * int32(-1640531535)`)."""
    s = (int(seed) + int(b) * -1640531535) & _M32
    return s - (1 << 32) if s >= 1 << 31 else s


def hemisphere_from_uv(u1: torch.Tensor, u2: torch.Tensor) -> V3:
    """Uniform hemisphere about +z from two uniforms; pdf = 1/(2 pi).
    Exactly the reference's map (`Hemisphere.hpp:25-32`)."""
    r = torch.sqrt(torch.clamp(1.0 - u1 * u1, min=0.0))
    phi = 2.0 * PI * u2
    return V3(torch.cos(phi) * r, torch.sin(phi) * r, u1)


def onb_local(normal: V3, vec: V3) -> V3:
    """Reference Onb (`Onb.hpp:17-27`) applied to `vec`."""
    w = normal
    big_x = torch.abs(w.x) > 0.9
    zeros = torch.zeros_like(w.x)
    ones = torch.ones_like(w.x)
    a = V3(torch.where(big_x, zeros, ones), torch.where(big_x, ones, zeros),
           zeros)
    v = normalize3(cross3(w, a), eps=1e-20)
    u = cross3(w, v)
    return V3(vec.x * u.x + vec.y * v.x + vec.z * w.x,
              vec.x * u.y + vec.y * v.y + vec.z * w.y,
              vec.x * u.z + vec.y * v.z + vec.z * w.z)


def closest_hit(ss: StaticScene, o: V3, d: V3, t_min: float, mat_channels,
                tri_bvh=None, alive=None, with_uv: bool = False,
                coherent: bool = False, unique_pids: bool = False):
    """Closest hit: the unrolled dense primitives, or, with `tri_bvh`, the
    dense primitives without triangles and then the triangle pool
    (`pt_core.py:110-207`), in one of two forms:

      - `mesh_cuda.MeshTables` (the counterpart of the JAX `MeshAccel`
        branch): the hybrid route's mesh pipe,
        `mesh_cuda.intersect_triangles_mesh`, capped by the dense hit and
        `alive`; `coherent` (pixel-coherent camera rays) skips its
        entry-cell sort;
      - a callable `tri_bvh(o, d, t_cap)` returning the sweep's winner
        tuple (t_best, idx, nx, ny, nz, mat[, u, v, tex]) with t_best at
        the cap on a miss, the cap being the dense hit's t, 0 for dead rays
        (the megamesh route's plain form); the winner's channels come from
        its material id (`mesh_cuda.channels_from_mat`).

    The XLA engines' other `tri_bvh` forms (the blocked scan, the BVH
    cursor walk) are not ported.

    `unique_pids`: the mesh ids (triangle-array indices) are offset past
    the dense pass's own ids (spheres, then planes), so callers that
    compare prim ids across hits (MLT's visibility test) see one id space
    (`pt_core.py:119-124, :182-185`)."""
    if tri_bvh is None:
        return intersect_scene_unrolled(ss, o, d, t_min=t_min,
                                        mat_channels=mat_channels,
                                        with_uv=with_uv)
    from .mesh_cuda import MeshTables, channels_from_mat, \
        intersect_triangles_mesh
    ss_nt = ss._replace(tri=[], tri_uv=())
    hit = intersect_scene_unrolled(ss_nt, o, d, t_min=t_min,
                                   mat_channels=mat_channels,
                                   with_uv=with_uv)
    uvb = None
    if isinstance(tri_bvh, MeshTables):
        out = intersect_triangles_mesh(tri_bvh, o, d, t_min, hit.t,
                                       mat_channels, alive=alive,
                                       sort=not coherent, with_uv=with_uv)
        tb, nxb, nyb, nzb, matb, pidb, chb = out[:7]
        if with_uv:
            uvb = out[7]
    else:
        t_cap = hit.t
        if alive is not None:
            t_cap = torch.where(alive, t_cap, torch.zeros_like(t_cap))
        out = tri_bvh(o, d, t_cap)
        tb, idxb, nxb, nyb, nzb, matb = out[:6]
        missb = idxb < 0
        tb = torch.where(missb, torch.full_like(tb, float("inf")), tb)
        chb = channels_from_mat(matb, missb, mat_channels)
        pidb = torch.where(missb, -1.0, idxb)
        matb = torch.where(missb, 0.0, matb)
        if with_uv and len(out) > 6:
            uvb = (out[6], out[7], torch.where(missb, -1.0, out[8]))
    if unique_pids:
        n_dense = len(ss.sph) + len(ss.pln)
        pidb = torch.where(pidb >= 0, pidb + float(n_dense), pidb)
    closer = tb < hit.t
    t = torch.where(closer, tb, hit.t)
    normal = V3(torch.where(closer, nxb, hit.normal.x),
                torch.where(closer, nyb, hit.normal.y),
                torch.where(closer, nzb, hit.normal.z))
    chans = tuple(torch.where(closer, cb, ch)
                  for cb, ch in zip(chb, hit.channels))
    point = V3(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z)
    uv = hit.uv
    if with_uv:
        if uvb is None:
            uvb = (torch.zeros_like(t), torch.zeros_like(t),
                   torch.full_like(t, -1.0))
        uv = tuple(torch.where(closer, ub, hb)
                   for ub, hb in zip(uvb, hit.uv))
    return hit._replace(t=t, valid=torch.isfinite(t), point=point,
                        normal=normal,
                        mat_id=torch.where(closer, matb, hit.mat_id),
                        prim_id=torch.where(closer, pidb, hit.prim_id),
                        channels=chans, uv=uv)


def diffuse_bounce(ss: StaticScene, albedo_ch, o: V3, d: V3, throughput: V3,
                   radiance: V3, alive, u1, u2, t_min: float = 1e-6,
                   tri_bvh=None, with_miss: bool = False, textures=None
                   ) -> Tuple[V3, V3, V3, V3, torch.Tensor]:
    """One bounce of the diffuse estimator; returns updated
    (o, d, throughput, radiance, alive), plus the miss mask (alive rays
    that hit neither an object nor a light: env-map candidates, whose
    o/d/throughput are left untouched) when `with_miss`.

    `u1, u2`: uniforms in [0,1) shaped like o.x (hemisphere sampling).
    `alive`: boolean mask of rays still carrying throughput.
    `tri_bvh`: a mesh sweep (see `closest_hit`).  `textures`: a resolver
    `(uv, colour) -> V3` (`texture.make_tex_resolver`) replacing the
    albedo at textured hits."""
    hit = closest_hit(ss, o, d, t_min, albedo_ch, tri_bvh, alive=alive,
                      with_uv=bool(textures))
    t_l, light_rad = intersect_area_lights_unrolled(ss, o, d, t_min=t_min)

    obj_first = alive & hit.valid & (hit.t < t_l)
    light_hit = alive & ~obj_first & (t_l < float("inf"))

    lw = light_hit.to(o.x.dtype)
    radiance = V3(radiance.x + lw * throughput.x * light_rad.x,
                  radiance.y + lw * throughput.y * light_rad.y,
                  radiance.z + lw * throughput.z * light_rad.z)

    ax, ay, az = hit.channels
    if textures:
        alb = textures(hit.uv, V3(ax, ay, az))
        ax, ay, az = alb.x, alb.y, alb.z
    local = hemisphere_from_uv(u1, u2)
    new_d = normalize3(onb_local(hit.normal, local), eps=1e-20)
    cos = dot3(hit.normal, new_d)
    # attenuation * cos / pdf = (albedo/pi) * cos * 2pi = 2 albedo cos
    scale = 2.0 * cos
    throughput = V3(throughput.x * torch.where(obj_first, ax * scale, 1.0),
                    throughput.y * torch.where(obj_first, ay * scale, 1.0),
                    throughput.z * torch.where(obj_first, az * scale, 1.0))
    o = where3(obj_first, hit.point, o)
    d = where3(obj_first, new_d, d)
    if with_miss:
        return o, d, throughput, radiance, obj_first, (alive & ~obj_first
                                                       & ~light_hit)
    return o, d, throughput, radiance, obj_first


# ---------------------------------------------------------------------------
# AccPathTracer BSDFs (`acc_path_tracing/src/shaders/*`), elementwise.
# ---------------------------------------------------------------------------

def pow5(x: torch.Tensor) -> torch.Tensor:
    """x ** 5 as JAX's `integer_pow` computes it: x * ((x * x) * (x * x))."""
    x2 = x * x
    return x * (x2 * x2)


def reflect3_(d: V3, n: V3) -> V3:
    k = 2.0 * dot3(d, n)
    return V3(d.x - k * n.x, d.y - k * n.y, d.z - k * n.z)


def fresnel_conductor(cos_i, eta_r: V3, eta_i: V3) -> V3:
    """Exact complex-IOR Fresnel, componentwise RGB
    (`Conductor.cpp:12-33` / `Microfacet.cpp:34-59`)."""
    cos2 = cos_i * cos_i
    sin2 = 1.0 - cos2
    sin4 = sin2 * sin2

    def chan(er, ei):
        temp1 = er * er - ei * ei - sin2
        a2pb2 = torch.sqrt(torch.clamp(
            temp1 * temp1 + 4.0 * ei * ei * er * er, min=0.0))
        a = torch.sqrt(torch.clamp(0.5 * (a2pb2 + temp1), min=0.0))
        t1 = a2pb2 + cos2
        t2 = 2.0 * cos_i * a
        t3 = a2pb2 * cos2 + sin4
        t4 = t2 * sin2
        r_s = (t1 - t2) / (t1 + t2)
        r_p = r_s * (t3 - t4) / (t3 + t4)
        return 0.5 * (r_s + r_p)

    return V3(chan(eta_r.x, eta_i.x), chan(eta_r.y, eta_i.y),
              chan(eta_r.z, eta_i.z))


def conductor_scatter(d: V3, normal: V3, eta_r: V3, eta_i: V3, albedo: V3):
    """Perfect mirror with complex Fresnel (`Conductor.cpp:6-42`).
    Returns (L, attenuation V3)."""
    n = normalize3(normal, eps=1e-20)
    l = normalize3(reflect3_(d, n), eps=1e-20)
    cos_l = torch.abs(dot3(l, n))
    f = fresnel_conductor(cos_l, eta_r, eta_i)
    att = V3(f.x * cos_l * albedo.x, f.y * cos_l * albedo.y,
             f.z * cos_l * albedo.z)
    return l, att


def glass_scatter(d: V3, normal: V3, ior, absorbed: V3, u_choice):
    """Dielectric reflect/refract (`Glass.cpp:15-57`), one lobe chosen with
    probability F (Schlick) so the wavefront stays single-ray; the weight
    over the probability cancels to `absorbed`, and total internal
    reflection reflects with full weight.  The refraction direction is the
    reference's (non-Snell) construction.  Returns (L, weight V3)."""
    n0 = normalize3(normal, eps=1e-20)
    v = d  # the reference uses the (already unit) ray direction
    vdotn0 = dot3(v, n0)
    inside = vdotn0 > 0
    n = where3(inside, V3(-n0.x, -n0.y, -n0.z), n0)
    ior_rel = torch.where(inside, 1.0 / ior, ior)

    reflex = normalize3(reflect3_(v, n), eps=1e-20)
    n12 = (ior_rel - 1.0) / (ior_rel + 1.0)
    f0 = n12 * n12
    vdotn = torch.abs(dot3(v, n))
    one_m = 1.0 - vdotn
    f = f0 + (1.0 - f0) * pow5(one_m)

    x_axis = normalize3(V3(reflex.x + v.x, reflex.y + v.y, reflex.z + v.z),
                        eps=1e-20)
    y_axis = V3(-n.x, -n.y, -n.z)
    x_ = one_m / ior_rel
    y_ = torch.sqrt(torch.clamp(1.0 - x_ * x_, min=0.0))
    refraction = normalize3(
        V3(x_axis.x * x_ + y_axis.x * y_, x_axis.y * x_ + y_axis.y * y_,
           x_axis.z * x_ + y_axis.z * y_), eps=1e-20)

    tir = x_ > 1.0
    choose_reflect = tir | (u_choice < f)
    l = where3(choose_reflect, reflex, refraction)
    return l, absorbed


def _smith_g1(v: V3, h: V3, n: V3, alpha2):
    cos_vn = dot3(v, n)
    bad = cos_vn * dot3(v, h) <= 0.0
    cos2 = cos_vn * cos_vn
    tan2 = (1.0 - cos2) / torch.clamp(cos2, min=1e-12)
    g = 2.0 / (1.0 + torch.sqrt(1.0 + alpha2 * tan2))
    g = torch.where(torch.abs(cos_vn - 1.0) < 1e-7, 1.0, g)
    return torch.where(bad, 0.0, g)


def microfacet_scatter(d: V3, normal: V3, albedo: V3, roughness, f0,
                       metalness, u1, u2):
    """GGX-style microfacet (`Microfacet.cpp:93-225`) with the hash
    uniforms in place of the reference's fixed-seed sampler; D cancels
    against the pdf, so attenuation = F G |d.H| / cos_o * albedo.
    Returns (L, attenuation V3)."""
    n = normalize3(normal, eps=1e-20)
    alpha2 = roughness * roughness
    phi = 2.0 * PI * u2
    tan_theta2 = alpha2 * u1 / torch.clamp(1.0 - u1, min=1e-12)
    cos_theta = 1.0 / torch.sqrt(1.0 + tan_theta2)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    local = V3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
               cos_theta)
    h = normalize3(onb_local(n, local), eps=1e-20)

    l = normalize3(reflect3_(d, h), eps=1e-20)
    v = V3(-d.x, -d.y, -d.z)
    cos_i = dot3(l, n)
    valid = (dot3(d, n) < 0.0) & (cos_i > 0.0)

    spec_f0 = V3((1.0 - metalness) * f0 + metalness * albedo.x,
                 (1.0 - metalness) * f0 + metalness * albedo.y,
                 (1.0 - metalness) * f0 + metalness * albedo.z)
    ldoth = torch.abs(dot3(l, h))
    om = pow5(1.0 - ldoth)
    fr = V3(spec_f0.x + (1.0 - spec_f0.x) * om,
            spec_f0.y + (1.0 - spec_f0.y) * om,
            spec_f0.z + (1.0 - spec_f0.z) * om)
    g = _smith_g1(l, h, n, alpha2) * _smith_g1(v, h, n, alpha2)
    cos_o = torch.abs(dot3(n, v))
    w = torch.where(valid, g * ldoth / torch.clamp(cos_o, min=1e-12), 0.0)
    att = V3(fr.x * w * albedo.x, fr.y * w * albedo.y, fr.z * w * albedo.z)
    return l, att


def plastic_scatter(d: V3, normal: V3, diffuse: V3, specular: V3, ior,
                    u1, u2, u3):
    """Plastic (type 4), the JAX package's own definition (the reference
    ships the template but no renderer implements it): Schlick Fresnel with
    F0 = ((ior-1)/(ior+1))^2 picks the mirror lobe (weight specularColor,
    carried in the albedo slots) with probability F, else the uniform
    hemisphere diffuse lobe (weight 2 cos * diffuseColor).
    Returns (L, weight V3)."""
    n = normalize3(normal, eps=1e-20)
    cos_i = torch.abs(dot3(d, n))
    n12 = (ior - 1.0) / (ior + 1.0)
    f0 = n12 * n12
    f = f0 + (1.0 - f0) * pow5(1.0 - cos_i)

    d_spec = normalize3(reflect3_(d, n), eps=1e-20)
    local = hemisphere_from_uv(u1, u2)
    d_diff = normalize3(onb_local(n, local), eps=1e-20)
    cos_d = dot3(n, d_diff)

    choose_spec = u3 < f
    l = where3(choose_spec, d_spec, d_diff)
    w = where3(choose_spec, specular,
               V3(diffuse.x * 2.0 * cos_d, diffuse.y * 2.0 * cos_d,
                  diffuse.z * 2.0 * cos_d))
    return l, w


N_MAT_CHANNELS = 20


def make_mat_channels(ss: StaticScene):
    """Per-material constant tuples for the unrolled channel tracker:
    (type, diffuse rgb, albedo rgb, ior, absorbed rgb, eta_r rgb, eta_i rgb,
    roughness, f0, metalness) = 20 channels; +1 `stex` channel (the
    material's specular-map texture id, -1 = none) only when the scene has
    textured faces and some material has a specular map, as the JAX
    function decides it."""
    with_stex = bool(ss.tri_uv) and any(
        float(m.get("stex", -1.0)) >= 0.0 for m in ss.mats)
    ch = []
    for m in ss.mats:
        ch.append((float(m["type"]),)
                  + tuple(float(x) for x in m["diffuse"])
                  + tuple(float(x) for x in m["albedo"])
                  + (float(m["ior"]),)
                  + tuple(float(x) for x in m["absorbed"])
                  + tuple(float(x) for x in m["eta_r"])
                  + tuple(float(x) for x in m["eta_i"])
                  + (float(m["roughness"]), float(m["f0"]),
                     float(m["metalness"]))
                  + ((float(m.get("stex", -1.0)),) if with_stex else ()))
    return ch


def lobe_order(ss: StaticScene) -> list:
    """The lobes `bsdf_bounce` evaluates for this scene, in its order:
    Lambertian always, then each of conductor (1), glass (2), microfacet (3)
    and plastic (4) whose type is present; a type outside {0..4} adds the
    microfacet lobe."""
    present = {int(m["type"]) for m in ss.mats}
    lobes = [0]
    if 1 in present:
        lobes.append(1)
    if 2 in present:
        lobes.append(2)
    if 3 in present or not present.issubset({0, 1, 2, 3, 4}):
        lobes.append(3)
    if 4 in present:
        lobes.append(4)
    return lobes


def effective_lobe(mtype: float, lobes: list) -> int:
    """The lobe `bsdf_bounce`'s select chain gives a material of type
    `mtype`: each listed lobe after the first takes the types within 0.5 of
    its id, and the last listed one takes every higher type too."""
    lobe = lobes[0]
    for i, type_id in enumerate(lobes[1:], start=1):
        sel = mtype >= type_id - 0.5
        if i < len(lobes) - 1:
            sel = sel and mtype < type_id + 0.5
        if sel:
            lobe = type_id
    return lobe


def bsdf_bounce(ss: StaticScene, mat_ch, o: V3, d: V3, throughput: V3,
                radiance: V3, alive, u1, u2, u3, t_min: float = 1e-6,
                tri_bvh=None, with_miss: bool = False, textures=None,
                coherent: bool = False
                ) -> Tuple[V3, V3, V3, V3, torch.Tensor]:
    """One bounce of the AccPathTracer estimator
    (`AccPathTracer.cpp:120-181`): closest hit, light hit, then the
    material-type select chain over the lobes present (`lobe_order`).
    `with_miss`: also return the env-candidate miss mask; `tri_bvh`: see
    closest_hit; `textures`: the binned resolver of diffuse_bounce, or a
    tuple of (H, W, 3) textures sampled at full resolution
    (`texture.resolve_diffuse`, the XLA route's); with an `stex` channel
    the specular map replaces the albedo too.  `coherent`: the rays are
    pixel-coherent camera rays (the mesh pipe skips its sort)."""
    hit = closest_hit(ss, o, d, t_min, mat_ch, tri_bvh, alive=alive,
                      with_uv=bool(textures), coherent=coherent)
    t_l, light_rad = intersect_area_lights_unrolled(ss, o, d, t_min=t_min)

    obj_first = alive & hit.valid & (hit.t < t_l)
    light_hit = alive & ~obj_first & (t_l < float("inf"))

    lw = light_hit.to(o.x.dtype)
    radiance = V3(radiance.x + lw * throughput.x * light_rad.x,
                  radiance.y + lw * throughput.y * light_rad.y,
                  radiance.z + lw * throughput.z * light_rad.z)

    (mtype, dr, dg, db, ar, ag, ab_, ior, absr, absg, absb,
     err, erg, erb, eir, eig, eib, rough, f0, metal) = hit.channels[:20]
    stex = hit.channels[20] if len(hit.channels) > 20 else None
    diffuse = V3(dr, dg, db)
    albedo = V3(ar, ag, ab_)
    if textures:
        if callable(textures):
            diffuse = textures(hit.uv, diffuse)
            if stex is not None:
                albedo = textures((hit.uv[0], hit.uv[1], stex), albedo)
        else:
            from .texture import resolve_diffuse
            diffuse = resolve_diffuse(textures, hit.uv, diffuse)
            if stex is not None:
                albedo = resolve_diffuse(
                    textures, (hit.uv[0], hit.uv[1], stex), albedo)
    absorbed = V3(absr, absg, absb)
    eta_r = V3(err, erg, erb)
    eta_i = V3(eir, eig, eib)

    order = lobe_order(ss)
    lobes = []  # (type id, direction V3, weight V3)
    local = hemisphere_from_uv(u1, u2)
    d_diff = normalize3(onb_local(hit.normal, local), eps=1e-20)
    cos = dot3(hit.normal, d_diff)
    lobes.append((0, d_diff, V3(diffuse.x * 2.0 * cos, diffuse.y * 2.0 * cos,
                                diffuse.z * 2.0 * cos)))
    if 1 in order:
        lobes.append((1, *conductor_scatter(d, hit.normal, eta_r, eta_i,
                                            albedo)))
    if 2 in order:
        lobes.append((2, *glass_scatter(d, hit.normal, ior, absorbed, u3)))
    if 3 in order:
        lobes.append((3, *microfacet_scatter(d, hit.normal, albedo, rough,
                                             f0, metal, u1, u2)))
    if 4 in order:
        lobes.append((4, *plastic_scatter(d, hit.normal, diffuse, albedo,
                                          ior, u1, u2, u3)))

    new_d, w = lobes[0][1], lobes[0][2]
    for i, (type_id, ld, lwt) in enumerate(lobes[1:], start=1):
        sel = mtype >= type_id - 0.5
        if i < len(lobes) - 1:  # last listed lobe catches higher types
            sel = sel & (mtype < type_id + 0.5)
        new_d = where3(sel, ld, new_d)
        w = where3(sel, lwt, w)

    throughput = V3(throughput.x * torch.where(obj_first, w.x, 1.0),
                    throughput.y * torch.where(obj_first, w.y, 1.0),
                    throughput.z * torch.where(obj_first, w.z, 1.0))
    o = where3(obj_first, hit.point, o)
    d = where3(obj_first, new_d, d)
    if with_miss:
        return o, d, throughput, radiance, obj_first, (alive & ~obj_first
                                                       & ~light_hit)
    return o, d, throughput, radiance, obj_first


def finish_ambient(ss: StaticScene, throughput: V3, radiance: V3,
                   alive) -> V3:
    """Depth-cap contribution: surviving paths see ambient.constant
    (`trace` line 145)."""
    if any(c != 0.0 for c in ss.ambient_constant):
        aw = alive.to(radiance.x.dtype)
        radiance = V3(
            radiance.x + aw * throughput.x * float(ss.ambient_constant[0]),
            radiance.y + aw * throughput.y * float(ss.ambient_constant[1]),
            radiance.z + aw * throughput.z * float(ss.ambient_constant[2]))
    return radiance
