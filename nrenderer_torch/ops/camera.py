"""Camera ray generation (pinhole + thin lens), batched.

Counterpart of `nrenderer_tpu/ops/camera.py`, the reference's RT-in-one-weekend
camera (`simple_path_tracing/include/Camera.hpp:16-64`):

    w = normalize(position - lookAt);  u = normalize(cross(up, w));  v = cross(w, u)
    halfHeight = tan(radians(clamp(fov, 20, 160)) / 2);  halfWidth = aspect * halfHeight
    lowerLeft  = position - halfWidth*fd*u - halfHeight*fd*v - fd*w
    shoot(s,t) = Ray(position + lensOffset,
                     normalize(lowerLeft + s*horizontal + t*vertical - position - lensOffset))

The basis is float64 host math, stored as float32 tensors on the device the
caller names."""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..scene.model import Camera
from .soa import V3, normalize3


class CameraParams(NamedTuple):
    """Precomputed camera basis, float32 tensors on one device."""
    position: torch.Tensor    # (3,)
    lower_left: torch.Tensor  # (3,)
    horizontal: torch.Tensor  # (3,)
    vertical: torch.Tensor    # (3,)
    u: torch.Tensor           # (3,)
    v: torch.Tensor           # (3,)
    w: torch.Tensor           # (3,)
    lens_radius: torch.Tensor  # ()
    half_height: torch.Tensor  # ()
    focus_distance: torch.Tensor  # ()


def make_camera(camera: Camera, aspect: Optional[float] = None, *,
                device) -> CameraParams:
    """Host-side camera basis computation (float64, then float32 on
    `device`)."""
    position = np.asarray(camera.position, np.float64)
    look_at = np.asarray(camera.look_at, np.float64)
    up = np.asarray(camera.up, np.float64)
    vfov = float(np.clip(camera.fov, 20.0, 160.0))
    theta = np.radians(vfov)
    half_height = np.tan(theta / 2.0)
    asp = camera.aspect if aspect is None else aspect
    half_width = asp * half_height
    w = position - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    fd = float(camera.focus_distance)
    lower_left = position - half_width * fd * u - half_height * fd * v - fd * w
    horizontal = 2.0 * half_width * fd * u
    vertical = 2.0 * half_height * fd * v
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return CameraParams(
        position=f(position), lower_left=f(lower_left),
        horizontal=f(horizontal), vertical=f(vertical), u=f(u), v=f(v),
        w=f(w), lens_radius=f(camera.aperture / 2.0),
        half_height=f(half_height), focus_distance=f(fd),
    )


def shoot_v3(cam: CameraParams, s: torch.Tensor, t: torch.Tensor,
             lens_uv=None):
    """SoA ray generation: returns (origin V3, direction V3) of (N,) tensors.
    `lens_uv`: optional (u, v) pair of (N,) unit-disk samples."""
    cx, cy, cz = cam.position[0], cam.position[1], cam.position[2]
    if lens_uv is None:
        ox = cx.expand(s.shape)
        oy = cy.expand(s.shape)
        oz = cz.expand(s.shape)
    else:
        lu, lv = lens_uv
        rx = lu * cam.lens_radius
        ry = lv * cam.lens_radius
        ox = cx + rx * cam.u[0] + ry * cam.v[0]
        oy = cy + rx * cam.u[1] + ry * cam.v[1]
        oz = cz + rx * cam.u[2] + ry * cam.v[2]
    dx = cam.lower_left[0] + s * cam.horizontal[0] + t * cam.vertical[0] - ox
    dy = cam.lower_left[1] + s * cam.horizontal[1] + t * cam.vertical[1] - oy
    dz = cam.lower_left[2] + s * cam.horizontal[2] + t * cam.vertical[2] - oz
    d = normalize3(V3(dx, dy, dz))
    return V3(ox, oy, oz), d
