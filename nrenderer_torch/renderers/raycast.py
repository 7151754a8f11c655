"""RayCast renderer: single-bounce Phong/Lambert direct lighting.

Counterpart of `nrenderer_tpu/renderers/raycast.py`, the rebuild of the
ray_cast plugin (`components/ray_cast/src/RayCastRenderer.cpp`): a shadow
ray with epsilon 0.01, Phong/Lambert shading by material type {0:
Lambertian, 1: Phong} (`ray_cast/include/shaders/ShaderCreator.hpp:15-30`),
clamp + sqrt gamma, and the bottom-up pixel write folded into a final flip.

The whole image is one batch of (H*W,) torch ops in component-SoA layout:
primary rays, the SoA closest hit (`ops.intersect.intersect_scene`, in ray
chunks), one shadow-ray pass per light and branchless material shading.
There is no path-tracing kernel here (the JAX package runs it as plain XLA
ops too): on `device="cuda"` these ops run on the card, on `device="cpu"`
on the host."""
from __future__ import annotations

import numpy as np
import torch

from ..ops.camera import CameraParams, make_camera, shoot_v3
from ..ops.intersect import (
    T_MIN_RAYCAST, intersect_scene, make_scene_soa, select_mat, select_mat3,
)
from ..ops.pt_cuda import check_device
from ..ops.soa import V3, dot3, normalize3, reflect3, to_array
from ..scene.arrays import SceneArrays, build_scene_arrays
from ..scene.model import Scene
from ..server.component import RenderComponent, RenderResult
from ..server.registry import get_server, register_renderer
from ..utils.timing import GLOBAL_TIMER


def pixel_grid(width: int, height: int, offset: float, device):
    """Film coordinates (s, t) of every pixel in row-major order (row 0 =
    bottom), at `offset` within the pixel."""
    jj = torch.arange(width, dtype=torch.float32, device=device).repeat(
        height)
    ii = torch.arange(height, dtype=torch.float32,
                      device=device).repeat_interleave(width)
    if offset:
        jj, ii = jj + offset, ii + offset
    return jj / width, ii / height


def render_raycast(scene_arrays: SceneArrays, cam: CameraParams,
                   width: int, height: int, *, device) -> torch.Tensor:
    """Returns an (H, W, 3) image on `device`, row 0 = BOTTOM (caller
    flips).

    Lighting: the reference shades `pointLightBuffer[0]` ONLY
    (`RayCastRenderer.cpp:70`); the rebuild sums every valid point,
    directional, and spot light with per-light shadow rays (the JAX
    package's documented divergence: the reference declares the structs
    in `Light.hpp:52-67` and the `.scn` grammar parses them, but no
    shipped renderer reads them).  Identical to the reference on the
    stock one-point-light scenes."""
    dev = check_device(device)
    sa = scene_arrays
    scene = make_scene_soa(sa, device=dev)
    o, d = shoot_v3(cam, *pixel_grid(width, height, 0.0, dev))

    hit = intersect_scene(scene, o, d, t_min=T_MIN_RAYCAST)
    # ray_cast normalizes normals in its intersections; do it at shading time
    n = normalize3(hit.normal, eps=1e-12)
    neg_d = V3(-d.x, -d.y, -d.z)

    # branchless Phong/Lambert over the material table
    mt = scene.mat
    diffuse_c = select_mat3(hit.mat_oh, mt.diffuse)
    specular_c = select_mat3(hit.mat_oh, mt.specular)
    spec_ex = select_mat(hit.mat_oh, mt.specular_ex)
    is_phong = select_mat(hit.mat_oh, (mt.type == 1).to(torch.float32))
    f32 = lambda x: torch.as_tensor(np.float32(x), device=dev)

    def shade(out, lit_mask, valid, radiance, scale=1.0):
        """Phong/Lambert response to light arriving along -`out`."""
        cos_on = dot3(out, n)
        facing = cos_on > 0
        r = reflect3(out, n)
        vr = dot3(neg_d, r)
        # |pow(v.r, ex)| (`Phong.cpp:29-30`); |v.r|^ex avoids the NaN
        # that C++ pow(negative, fractional) would produce
        spec_w = torch.pow(torch.clamp(torch.abs(vr), min=1e-30), spec_ex)
        w = (hit.valid & facing & lit_mask & bool(valid)).to(
            torch.float32) * scale
        return V3(*(w * f32(radiance[k]) * (dc * cos_on
                                             + is_phong * sc * spec_w)
                    for k, dc, sc in zip(range(3), diffuse_c, specular_c)))

    def occluded_within(out, dist):
        shadow = intersect_scene(scene, hit.point, out, t_min=T_MIN_RAYCAST)
        return (~shadow.valid) | (shadow.t > dist)

    def toward(lp):
        """Unit vector and distance from each hit point to `lp`."""
        to_light = V3(f32(lp[0]) - hit.point.x, f32(lp[1]) - hit.point.y,
                      f32(lp[2]) - hit.point.z)
        dist = torch.sqrt(dot3(to_light, to_light))
        return V3(to_light.x / dist, to_light.y / dist,
                  to_light.z / dist), dist

    zero = torch.zeros_like(hit.point.x)
    acc = V3(zero, zero, zero)
    add = lambda a, c: V3(a.x + c.x, a.y + c.y, a.z + c.z)

    def inv_len(v):
        v = [f32(x) for x in v]
        return 1.0 / torch.sqrt(torch.clamp(
            v[0] ** 2 + v[1] ** 2 + v[2] ** 2, min=1e-20))

    for i in range(sa.pl_valid.shape[0]):
        out, dist = toward(sa.pl_pos[i])
        acc = add(acc, shade(out, occluded_within(out, dist),
                             sa.pl_valid[i], sa.pl_intensity[i]))

    for i in range(sa.dl_valid.shape[0]):
        dd = sa.dl_dir[i]
        inv = inv_len(dd)
        out = V3(*((-f32(dd[k]) * inv).expand(zero.shape) for k in range(3)))
        acc = add(acc, shade(out, occluded_within(out, float("inf")),
                             sa.dl_valid[i], sa.dl_irradiance[i]))

    for i in range(sa.sl_valid.shape[0]):
        out, dist = toward(sa.sl_pos[i])
        sd = sa.sl_dir[i]
        sinv = inv_len(sd)
        # cone falloff: smooth between hotSpot (full) and fallout (zero),
        # angles in radians (`Light.hpp:64-65` defaults pi/4, pi/3)
        cos_theta = -(out.x * f32(sd[0]) + out.y * f32(sd[1])
                      + out.z * f32(sd[2])) * sinv
        cos_hot = torch.cos(f32(sa.sl_cone[i][0]))
        cos_fall = torch.cos(f32(sa.sl_cone[i][1]))
        cone = torch.clamp((cos_theta - cos_fall)
                           / torch.clamp(cos_hot - cos_fall, min=1e-6),
                           0.0, 1.0)
        acc = add(acc, shade(out, occluded_within(out, dist),
                             sa.sl_valid[i], sa.sl_intensity[i],
                             scale=cone))

    color = V3(*(torch.sqrt(torch.clamp(c, 0.0, 1.0)) for c in acc))
    return to_array(color).reshape(height, width, 3)


@register_renderer("RayCast", description=(
    "A simple ray cast renderer.\n"
    "Phong/Lambertian direct lighting from one point light, with shadows."))
class RayCastRenderer(RenderComponent):
    def __init__(self, device="cuda"):
        self.device = device

    def render(self, scene: Scene) -> RenderResult:
        dev = check_device(self.device)
        timer = GLOBAL_TIMER.scope("RayCast")
        w = scene.render_option.width
        h = scene.render_option.height
        with timer.phase("scene-prep"):
            arrays = build_scene_arrays(scene)
            cam = make_camera(scene.camera, device=dev)
        with timer.phase("render"):
            # .cpu() waits for the device, so the phase covers the ops
            img = render_raycast(arrays, cam, w, h, device=dev).cpu().numpy()
        img = img[::-1]  # bottom-up scan -> row 0 = top
        get_server().logger.log("phases: " + timer.summary())
        rgba = np.concatenate([img, np.ones((h, w, 1), np.float32)], axis=2)
        return RenderResult(pixels=rgba, width=w, height=h)
