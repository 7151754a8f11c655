"""Diffuse path-tracing bounce on torch tensors.

Counterpart of the diffuse subset of `nrenderer_tpu/ops/pt_core.py`: the
reference's per-bounce estimator (`SimplePathTracer.cpp:144-177`) as
elementwise torch ops over `(N,)` ray batches, plus the counter-based hash
that every random draw of the renderer comes from.  The CUDA kernel
(`csrc/pt_kernel.cu`) computes the same functions per thread; these are its
plain form."""
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


def closest_hit(ss: StaticScene, o: V3, d: V3, t_min: float, mat_channels):
    """Closest hit against the unrolled dense primitives (the JAX
    function's `tri_bvh is None` branch; the mesh routes come with the
    mesh slice)."""
    return intersect_scene_unrolled(ss, o, d, t_min=t_min,
                                    mat_channels=mat_channels)


def diffuse_bounce(ss: StaticScene, albedo_ch, o: V3, d: V3, throughput: V3,
                   radiance: V3, alive, u1, u2, t_min: float = 1e-6
                   ) -> Tuple[V3, V3, V3, V3, torch.Tensor]:
    """One bounce of the diffuse estimator; returns updated
    (o, d, throughput, radiance, alive).

    `u1, u2`: uniforms in [0,1) shaped like o.x (hemisphere sampling).
    `alive`: boolean mask of rays still carrying throughput."""
    hit = closest_hit(ss, o, d, t_min, albedo_ch)
    t_l, light_rad = intersect_area_lights_unrolled(ss, o, d, t_min=t_min)

    obj_first = alive & hit.valid & (hit.t < t_l)
    light_hit = alive & ~obj_first & (t_l < float("inf"))

    lw = light_hit.to(o.x.dtype)
    radiance = V3(radiance.x + lw * throughput.x * light_rad.x,
                  radiance.y + lw * throughput.y * light_rad.y,
                  radiance.z + lw * throughput.z * light_rad.z)

    ax, ay, az = hit.channels
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
