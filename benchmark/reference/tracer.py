"""The reference path tracer: plain torch, any device, any float type.

A frozen copy of the renderer's plain path tracer for analytic scenes
(the diffuse estimator of SimplePathTracer and the five-lobe one of
AccPathTracer), written operation for operation as the renderer's plain
version computes it, so that in float32 it gives the renderer's films bit
for bit on the same device type.  Every random number comes from the
counter-based hash of (pixel, sample, draw, seed), so any pixels can be
recomputed on their own: `render_pixels` traces only the pixels asked
for, sums each pixel's samples in sample order, tone-maps and quantises
as the renderer's one-shot render and PNG writer do.

`dtype` runs the same arithmetic in another float type (the control runs
bfloat16); the hash's integer arithmetic stays int64.  Imports torch and
numpy only."""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .scene import Camera, Tables, scene_epsilon

PI = 3.14159265358979323846
_M32 = 0xFFFFFFFF
INF = float("inf")


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def dot3(a: V3, b: V3) -> torch.Tensor:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross3(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def normalize3(a: V3, eps: float = 0.0) -> V3:
    n2 = dot3(a, a)
    if eps:
        n2 = torch.clamp(n2, min=max(eps * eps, 1.2e-38))
    inv = torch.rsqrt(n2)
    return V3(a.x * inv, a.y * inv, a.z * inv)


def where3(cond, a: V3, b: V3) -> V3:
    return V3(torch.where(cond, a.x, b.x), torch.where(cond, a.y, b.y),
              torch.where(cond, a.z, b.z))


# ---------------------------------------------------------------------------
# the hash every draw comes from
# ---------------------------------------------------------------------------

def _u32(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return torch.tensor(int(x) & _M32, dtype=torch.int64)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def hash_uniform(pixel_id, sample, draw, seed,
                 dtype=torch.float32) -> torch.Tensor:
    """A uniform in [0, 1): a lowbias32-style hash of (pixel, sample,
    draw, seed) in uint32 arithmetic, its top 24 bits over 2^24."""
    x = (_mul32(_u32(pixel_id), 0x9E3779B9)
         + _mul32(_u32(sample), 0x85EBCA6B)
         + _mul32(_u32(seed), 0x165667B1)
         + _mul32(_u32(draw), 0x27D4EB2F)) & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x8725E8CD)
    x = x ^ (x >> 16)
    return ((x >> 8).to(torch.float32) * (2.0 ** -24)).to(dtype)


def bounce_seed(seed: int, b: int) -> int:
    """seed + b * 0x9E3779B1 in wrapping int32."""
    s = (int(seed) + int(b) * -1640531535) & _M32
    return s - (1 << 32) if s >= 1 << 31 else s


def int32(x: int) -> int:
    """A render seed as the kernel receives it: wrapped to int32."""
    return (int(x) + (1 << 31)) % (1 << 32) - (1 << 31)


# ---------------------------------------------------------------------------
# intersection: the primitive loop unrolled, zero terms folded
# ---------------------------------------------------------------------------

def _is_zero(v) -> bool:
    return isinstance(v, (int, float)) and float(v) == 0.0


def _lin3(c, x, y, z):
    terms = []
    for cc, v in ((float(c[0]), x), (float(c[1]), y), (float(c[2]), z)):
        if cc == 0.0 or _is_zero(v):
            continue
        terms.append(v if cc == 1.0 else cc * v)
    if not terms:
        return 0.0
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _dota(pairs):
    terms = [a * b for a, b in pairs if not (_is_zero(a) or _is_zero(b))]
    if not terms:
        return 0.0
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _full(v, like: torch.Tensor) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.full_like(like, float(v))


def np_dot(a, b) -> float:
    return float(a[0] * b[0] + a[1] * b[1] + a[2] * b[2])


class Hit(NamedTuple):
    t: torch.Tensor
    valid: torch.Tensor
    point: V3
    normal: V3
    channels: tuple


def _patch_hit(pos, nrm, inv0, inv1, o: V3, d: V3, t_min: float):
    nd = _full(_lin3(nrm, d.x, d.y, d.z), o.x)
    parallel = (nd < 1e-7) & (nd > -1e-8)
    dp = float(np_dot(pos, nrm))
    t = (dp - _lin3(nrm, o.x, o.y, o.z)) / torch.where(parallel, 1.0, nd)
    rx = o.x + t * d.x - float(pos[0]) if pos[0] else o.x + t * d.x
    ry = o.y + t * d.y - float(pos[1]) if pos[1] else o.y + t * d.y
    rz = o.z + t * d.z - float(pos[2]) if pos[2] else o.z + t * d.z
    u = _full(_lin3(inv0, rx, ry, rz), o.x)
    v = _full(_lin3(inv1, rx, ry, rz), o.x)
    ok = (~parallel & (t >= t_min) & (u >= 0) & (u <= 1) & (v >= 0)
          & (v <= 1))
    return ok, t


def closest_hit(sc: Tables, o: V3, d: V3, t_min: float, mat_channels) -> Hit:
    """The closest sphere, triangle or plane: Moller-Trumbore with the
    determinant's sign folded, both sphere roots in order, the
    parallelogram test through the precomputed inverse."""
    k = len(mat_channels[0])
    t_best = torch.full_like(o.x, INF)
    nx, ny, nz = (torch.zeros_like(o.x) for _ in range(3))
    chans = tuple(torch.zeros_like(o.x) for _ in range(k))
    state = [t_best, nx, ny, nz, chans]

    def upd(hit_mask, t, nxx, nyy, nzz, m):
        t_best, nx, ny, nz, chans = state
        closer = hit_mask & (t < t_best)
        state[:] = [torch.where(closer, t, t_best),
                    torch.where(closer, nxx, nx),
                    torch.where(closer, nyy, ny),
                    torch.where(closer, nzz, nz),
                    tuple(torch.where(closer, float(mat_channels[m][i]),
                                      chans[i]) for i in range(k))]

    for (cx, cy, cz, r, m) in sc.sph:
        ocx, ocy, ocz = o.x - cx, o.y - cy, o.z - cz
        b = ocx * d.x + ocy * d.y + ocz * d.z
        c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        a = dot3(d, d)
        disc = b * b - a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        inv_a = 1.0 / a
        t1 = (-b - sq) * inv_a
        t2 = (-b + sq) * inv_a
        ok = disc > 0
        t = torch.where(ok & (t1 >= t_min), t1,
                        torch.where(ok & (t2 >= t_min), t2, INF))
        inv_r = 1.0 / r
        px = o.x + t * d.x
        py = o.y + t * d.y
        pz = o.z + t * d.z
        upd(torch.isfinite(t), t, (px - cx) * inv_r, (py - cy) * inv_r,
            (pz - cz) * inv_r, m)

    for (v1, e1, e2, nrm, m) in sc.tri:
        px = _lin3((0.0, e2[2], -e2[1]), d.x, d.y, d.z)
        py = _lin3((-e2[2], 0.0, e2[0]), d.x, d.y, d.z)
        pz = _lin3((e2[1], -e2[0], 0.0), d.x, d.y, d.z)
        det0 = _full(_lin3(e1, px, py, pz), o.x)
        sign = torch.where(det0 > 0, 1.0, -1.0)
        det = det0 * sign
        tx = (o.x - v1[0]) * sign
        ty = (o.y - v1[1]) * sign
        tz = (o.z - v1[2]) * sign
        u = _full(_dota([(tx, px), (ty, py), (tz, pz)]), o.x)
        qx = _lin3((0.0, e1[2], -e1[1]), tx, ty, tz)
        qy = _lin3((-e1[2], 0.0, e1[0]), tx, ty, tz)
        qz = _lin3((e1[1], -e1[0], 0.0), tx, ty, tz)
        v = _full(_dota([(d.x, qx), (d.y, qy), (d.z, qz)]), o.x)
        w = _lin3(e2, qx, qy, qz) / torch.where(det == 0, 1.0, det)
        ok = ((det >= 1e-6) & (u >= 0) & (u <= det) & (v >= 0)
              & (u + v <= det) & (w >= t_min))
        upd(ok, torch.where(ok, w, INF), float(nrm[0]), float(nrm[1]),
            float(nrm[2]), m)

    for (pos, nrm, inv0, inv1, m) in sc.pln:
        ok, t = _patch_hit(pos, nrm, inv0, inv1, o, d, t_min)
        upd(ok, torch.where(ok, t, INF), float(nrm[0]), float(nrm[1]),
            float(nrm[2]), m)

    t_best, nx, ny, nz, chans = state
    valid = torch.isfinite(t_best)
    t_pt = torch.where(valid, t_best, 0.0)
    point = V3(o.x + t_pt * d.x, o.y + t_pt * d.y, o.z + t_pt * d.z)
    return Hit(t_best, valid, point, V3(nx, ny, nz), chans)


def closest_light(sc: Tables, o: V3, d: V3, t_min: float):
    t_best = torch.full_like(o.x, INF)
    rx, ry, rz = (torch.zeros_like(o.x) for _ in range(3))
    for (pos, nrm, inv0, inv1, rad) in sc.al:
        ok, t = _patch_hit(pos, nrm, inv0, inv1, o, d, t_min)
        closer = ok & (t < t_best)
        t_best = torch.where(closer, t, t_best)
        rx = torch.where(closer, float(rad[0]), rx)
        ry = torch.where(closer, float(rad[1]), ry)
        rz = torch.where(closer, float(rad[2]), rz)
    return t_best, V3(rx, ry, rz)


# ---------------------------------------------------------------------------
# scattering
# ---------------------------------------------------------------------------

def hemisphere_from_uv(u1, u2) -> V3:
    r = torch.sqrt(torch.clamp(1.0 - u1 * u1, min=0.0))
    phi = 2.0 * PI * u2
    return V3(torch.cos(phi) * r, torch.sin(phi) * r, u1)


def onb_local(normal: V3, vec: V3) -> V3:
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


def pow5(x):
    x2 = x * x
    return x * (x2 * x2)


def reflect3(d: V3, n: V3) -> V3:
    k = 2.0 * dot3(d, n)
    return V3(d.x - k * n.x, d.y - k * n.y, d.z - k * n.z)


def fresnel_conductor(cos_i, eta_r: V3, eta_i: V3) -> V3:
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


def conductor_scatter(d, normal, eta_r, eta_i, albedo):
    n = normalize3(normal, eps=1e-20)
    l = normalize3(reflect3(d, n), eps=1e-20)
    cos_l = torch.abs(dot3(l, n))
    f = fresnel_conductor(cos_l, eta_r, eta_i)
    return l, V3(f.x * cos_l * albedo.x, f.y * cos_l * albedo.y,
                 f.z * cos_l * albedo.z)


def glass_scatter(d, normal, ior, absorbed, u_choice):
    n0 = normalize3(normal, eps=1e-20)
    v = d
    inside = dot3(v, n0) > 0
    n = where3(inside, V3(-n0.x, -n0.y, -n0.z), n0)
    ior_rel = torch.where(inside, 1.0 / ior, ior)
    reflex = normalize3(reflect3(v, n), eps=1e-20)
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
    choose_reflect = (x_ > 1.0) | (u_choice < f)
    return where3(choose_reflect, reflex, refraction), absorbed


def _smith_g1(v, h, n, alpha2):
    cos_vn = dot3(v, n)
    bad = cos_vn * dot3(v, h) <= 0.0
    cos2 = cos_vn * cos_vn
    tan2 = (1.0 - cos2) / torch.clamp(cos2, min=1e-12)
    g = 2.0 / (1.0 + torch.sqrt(1.0 + alpha2 * tan2))
    g = torch.where(torch.abs(cos_vn - 1.0) < 1e-7, 1.0, g)
    return torch.where(bad, 0.0, g)


def microfacet_scatter(d, normal, albedo, roughness, f0, metalness, u1, u2):
    n = normalize3(normal, eps=1e-20)
    alpha2 = roughness * roughness
    phi = 2.0 * PI * u2
    tan_theta2 = alpha2 * u1 / torch.clamp(1.0 - u1, min=1e-12)
    cos_theta = 1.0 / torch.sqrt(1.0 + tan_theta2)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    local = V3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
               cos_theta)
    h = normalize3(onb_local(n, local), eps=1e-20)
    l = normalize3(reflect3(d, h), eps=1e-20)
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
    return l, V3(fr.x * w * albedo.x, fr.y * w * albedo.y,
                 fr.z * w * albedo.z)


def plastic_scatter(d, normal, diffuse, specular, ior, u1, u2, u3):
    n = normalize3(normal, eps=1e-20)
    cos_i = torch.abs(dot3(d, n))
    n12 = (ior - 1.0) / (ior + 1.0)
    f0 = n12 * n12
    f = f0 + (1.0 - f0) * pow5(1.0 - cos_i)
    d_spec = normalize3(reflect3(d, n), eps=1e-20)
    d_diff = normalize3(onb_local(n, hemisphere_from_uv(u1, u2)), eps=1e-20)
    cos_d = dot3(n, d_diff)
    choose_spec = u3 < f
    return (where3(choose_spec, d_spec, d_diff),
            where3(choose_spec, specular,
                   V3(diffuse.x * 2.0 * cos_d, diffuse.y * 2.0 * cos_d,
                      diffuse.z * 2.0 * cos_d)))


def lobe_order(sc: Tables) -> list:
    present = {int(m["type"]) for m in sc.mats}
    lobes = [0]
    for lobe in (1, 2):
        if lobe in present:
            lobes.append(lobe)
    if 3 in present or not present.issubset({0, 1, 2, 3, 4}):
        lobes.append(3)
    if 4 in present:
        lobes.append(4)
    return lobes


def mat_channels(sc: Tables, bsdf: bool) -> list:
    """Per material the constants a hit carries: the diffuse colour, or
    (type, diffuse, albedo, ior, absorbed, eta_r, eta_i, roughness, f0,
    metalness) for the five-lobe estimator."""
    if not bsdf:
        return [tuple(float(v) for v in m["diffuse"]) for m in sc.mats]
    return [(float(m["type"]),) + tuple(float(x) for x in m["diffuse"])
            + tuple(float(x) for x in m["albedo"]) + (float(m["ior"]),)
            + tuple(float(x) for x in m["absorbed"])
            + tuple(float(x) for x in m["eta_r"])
            + tuple(float(x) for x in m["eta_i"])
            + (float(m["roughness"]), float(m["f0"]), float(m["metalness"]))
            for m in sc.mats]


def _light_step(sc, hit, o, d, thr, rad, alive, t_min):
    t_l, light_rad = closest_light(sc, o, d, t_min)
    obj_first = alive & hit.valid & (hit.t < t_l)
    light_hit = alive & ~obj_first & (t_l < INF)
    lw = light_hit.to(o.x.dtype)
    rad = V3(rad.x + lw * thr.x * light_rad.x,
             rad.y + lw * thr.y * light_rad.y,
             rad.z + lw * thr.z * light_rad.z)
    return obj_first, rad


def diffuse_bounce(sc, chans, o, d, thr, rad, alive, u1, u2, t_min):
    hit = closest_hit(sc, o, d, t_min, chans)
    obj_first, rad = _light_step(sc, hit, o, d, thr, rad, alive, t_min)
    ax, ay, az = hit.channels
    local = hemisphere_from_uv(u1, u2)
    new_d = normalize3(onb_local(hit.normal, local), eps=1e-20)
    scale = 2.0 * dot3(hit.normal, new_d)
    thr = V3(thr.x * torch.where(obj_first, ax * scale, 1.0),
             thr.y * torch.where(obj_first, ay * scale, 1.0),
             thr.z * torch.where(obj_first, az * scale, 1.0))
    return (where3(obj_first, hit.point, o), where3(obj_first, new_d, d),
            thr, rad, obj_first)


def bsdf_bounce(sc, chans, o, d, thr, rad, alive, u1, u2, u3, t_min):
    hit = closest_hit(sc, o, d, t_min, chans)
    obj_first, rad = _light_step(sc, hit, o, d, thr, rad, alive, t_min)
    (mtype, dr, dg, db, ar, ag, ab_, ior, absr, absg, absb,
     err, erg, erb, eir, eig, eib, rough, f0, metal) = hit.channels
    diffuse, albedo = V3(dr, dg, db), V3(ar, ag, ab_)
    order = lobe_order(sc)
    d_diff = normalize3(onb_local(hit.normal, hemisphere_from_uv(u1, u2)),
                        eps=1e-20)
    cos = dot3(hit.normal, d_diff)
    lobes = [(0, d_diff, V3(diffuse.x * 2.0 * cos, diffuse.y * 2.0 * cos,
                            diffuse.z * 2.0 * cos))]
    if 1 in order:
        lobes.append((1, *conductor_scatter(d, hit.normal, V3(err, erg, erb),
                                            V3(eir, eig, eib), albedo)))
    if 2 in order:
        lobes.append((2, *glass_scatter(d, hit.normal, ior,
                                        V3(absr, absg, absb), u3)))
    if 3 in order:
        lobes.append((3, *microfacet_scatter(d, hit.normal, albedo, rough,
                                             f0, metal, u1, u2)))
    if 4 in order:
        lobes.append((4, *plastic_scatter(d, hit.normal, diffuse, albedo,
                                          ior, u1, u2, u3)))
    new_d, w = lobes[0][1], lobes[0][2]
    for i, (type_id, ld, lwt) in enumerate(lobes[1:], start=1):
        sel = mtype >= type_id - 0.5
        if i < len(lobes) - 1:
            sel = sel & (mtype < type_id + 0.5)
        new_d = where3(sel, ld, new_d)
        w = where3(sel, lwt, w)
    thr = V3(thr.x * torch.where(obj_first, w.x, 1.0),
             thr.y * torch.where(obj_first, w.y, 1.0),
             thr.z * torch.where(obj_first, w.z, 1.0))
    return (where3(obj_first, hit.point, o), where3(obj_first, new_d, d),
            thr, rad, obj_first)


# ---------------------------------------------------------------------------
# films of chosen pixels
# ---------------------------------------------------------------------------

def camera_rays(cam: Camera, pid, sp, seed, width, height, dtype, device):
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                  device=device).to(dtype)
    pos, ll, hz, vt = (f(x) for x in cam)
    py = pid // width
    pxf = (pid - py * width).to(dtype)
    pyf = py.to(dtype)
    rx = hash_uniform(pid, sp, 0, seed, dtype) * 2.0 - 1.0
    ry = hash_uniform(pid, sp, 1, seed, dtype) * 2.0 - 1.0
    s = (pxf + rx) * (1.0 / width)
    t = (pyf + ry) * (1.0 / height)
    o = V3(pos[0].expand(s.shape), pos[1].expand(s.shape),
           pos[2].expand(s.shape))
    d = normalize3(V3(ll[0] + s * hz[0] + t * vt[0] - o.x,
                      ll[1] + s * hz[1] + t * vt[1] - o.y,
                      ll[2] + s * hz[2] + t * vt[2] - o.z))
    return o, d


RAYS_PER_WAVEFRONT = 1 << 20


def accumulate(sc: Tables, cam: Camera, pixels: torch.Tensor, width: int,
               height: int, sp0: int, n_spp: int, depth: int, seed: int,
               bsdf: bool, dtype=torch.float32, stats: dict = None
               ) -> torch.Tensor:
    """The linear film SUM ((P, 3), from zero, in sample order) of samples
    [sp0, sp0 + n_spp) of the global pixel ids `pixels` (row 0 of the film
    at the bottom).  `stats` gains "samples" and "bounces" (bounce
    iterations of live paths, the kernel's loop trips)."""
    dev = pixels.device
    seed = int32(seed)
    t_min = scene_epsilon(sc)
    chans = mat_channels(sc, bsdf)
    n_pix = pixels.numel()
    film = torch.zeros((n_pix, 3), dtype=dtype, device=dev)
    chunk = max(1, min(n_spp, RAYS_PER_WAVEFRONT // n_pix))
    pid1 = pixels.to(torch.int64)
    for c0 in range(0, n_spp, chunk):
        c = min(chunk, n_spp - c0)
        sp = torch.arange(sp0 + c0, sp0 + c0 + c, dtype=torch.int64,
                          device=dev).repeat_interleave(n_pix)
        pid = pid1.repeat(c)
        o, d = camera_rays(cam, pid, sp, seed, width, height, dtype, dev)
        ones, zeros = torch.ones_like(o.x), torch.zeros_like(o.x)
        thr, rad = V3(ones, ones, ones), V3(zeros, zeros, zeros)
        alive = torch.ones_like(o.x, dtype=torch.bool)
        for b in range(depth):
            if stats is not None:
                stats["bounces"] = stats.get("bounces", 0) + int(alive.sum())
            bseed = bounce_seed(seed, b)
            u1 = hash_uniform(pid, sp, 4, bseed, dtype)
            u2 = hash_uniform(pid, sp, 5, bseed, dtype)
            if bsdf:
                u3 = hash_uniform(pid, sp, 6, bseed, dtype)
                o, d, thr, rad, alive = bsdf_bounce(
                    sc, chans, o, d, thr, rad, alive, u1, u2, u3, t_min)
            else:
                o, d, thr, rad, alive = diffuse_bounce(
                    sc, chans, o, d, thr, rad, alive, u1, u2, t_min)
        if any(v != 0.0 for v in sc.ambient):
            aw = alive.to(dtype)
            rad = V3(rad.x + aw * thr.x * float(sc.ambient[0]),
                     rad.y + aw * thr.y * float(sc.ambient[1]),
                     rad.z + aw * thr.z * float(sc.ambient[2]))
        if stats is not None:
            stats["samples"] = stats.get("samples", 0) + c * n_pix
        samples = torch.stack([rad.x, rad.y, rad.z], dim=-1).reshape(
            c, n_pix, 3)
        for k in range(c):   # one sample after another, as the kernel adds
            film += samples[k]
    return film


def film_pixels(width: int, height: int, count: int,
                gen: np.random.Generator) -> tuple:
    """`count` distinct pixels drawn with `gen`: their (row, col) in the
    PNG (row 0 at the top) and their film ids (row 0 at the bottom)."""
    flat = gen.choice(width * height, size=min(count, width * height),
                      replace=False)
    rows, cols = flat // width, flat % width
    return rows, cols, (height - 1 - rows) * width + cols


def render_pixels(sc: Tables, cam: Camera, film_ids: Sequence[int],
                  width: int, height: int, spp: int, depth: int, seed: int,
                  bsdf: bool, parts: int = 1, dtype=torch.float32,
                  device="cpu", stats: dict = None) -> np.ndarray:
    """The PNG's 8-bit RGB of the film pixels `film_ids` of a one-shot
    render: the samples split into `parts` equal ranges, each summed from
    zero (a sample-sharded render's ranks), the parts summed in rank
    order, the mean's square root, clipped and quantised as the PNG
    writer does: uint8(clip(v, 0, 1) * 255 + 0.5)."""
    if spp % parts:
        raise ValueError(f"{spp} samples do not split into {parts} parts")
    pixels = torch.as_tensor(np.asarray(film_ids, np.int64), device=device)
    share = spp // parts
    film = None
    for r in range(parts):
        part = accumulate(sc, cam, pixels, width, height, r * share, share,
                          depth, seed, bsdf, dtype, stats)
        film = part if film is None else film + part
    img = torch.sqrt(torch.clamp(film * (1.0 / spp), min=0.0))
    img = np.clip(img.float().cpu().numpy(), 0.0, 1.0)   # the renderer's
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)  # writer's
