"""GeometryPreview: render-free scene/geometry preview.

Counterpart of `nrenderer_tpu/renderers/preview.py`, the headless analogue
of the reference viewport's PREVIEW wireframe mode
(`code/app/src/ui/views/ScreenView.cpp:11-52,224-306`): a camera-matched
view shown before or without running a renderer, so the user can check
framing and geometry placement at once.  It is a single-pass depth+normal
raycast:

  - one `intersect_scene` batch (no lights, no shadows, no bounces) shades
    every hit as headlit normal color tinted per MATERIAL index (distinct
    materials get distinct hues, the stand-in for the wireframe's
    selection-highlight palette);
  - area lights render as emissive white patches (the reference previews
    lights as star/loop figures, `Asset.cpp:125-135`);
  - resolution is capped (default 256 on the long side) and meshes are
    face-decimated to NR_PREVIEW_MAX_FACES (default 1024), so the pass
    stays quick across edits.

The `edit` CLI posts this to the Screen on every applied edit before the
full re-render starts.  Like RayCast it is torch ops on the chosen device
(`device="cuda"` by default), with the SoA intersect in ray chunks."""
from __future__ import annotations

import copy
import os

import numpy as np
import torch

from ..ops.camera import CameraParams, make_camera, shoot_v3
from ..ops.intersect import (T_MIN_RAYCAST, intersect_area_lights,
                             intersect_scene, make_scene_soa, select_mat3)
from ..ops.pt_cuda import check_device
from ..ops.soa import V3, dot3, normalize3, to_array
from ..scene.arrays import SceneArrays, build_scene_arrays
from ..scene.model import Mesh, Scene
from ..server.component import RenderComponent, RenderResult
from ..server.registry import register_renderer
from .raycast import pixel_grid

MAX_SIDE = 256          # preview framebuffer cap (long side)
MAX_FACES_DEFAULT = 1024  # per-mesh face cap before decimation


def render_preview(scene_arrays: SceneArrays, cam: CameraParams,
                   width: int, height: int, *, device) -> torch.Tensor:
    """(H, W, 3) headlit normal/material-tint preview on `device`, row 0 =
    BOTTOM."""
    dev = check_device(device)
    scene = make_scene_soa(scene_arrays, device=dev)
    o, d = shoot_v3(cam, *pixel_grid(width, height, 0.5, dev))

    hit = intersect_scene(scene, o, d, t_min=T_MIN_RAYCAST)
    n = normalize3(hit.normal, eps=1e-12)
    ndl = dot3(n, d)
    # two-sided: flip normals facing away from the camera
    flip = torch.where(ndl > 0, -1.0, 1.0)
    n = V3(n.x * flip, n.y * flip, n.z * flip)
    headlight = torch.abs(ndl)

    # per-material tint: golden-ratio hue walk over the material table
    midx = torch.arange(scene.mat.type.shape[0], dtype=torch.float32,
                        device=dev)
    h6 = (midx * 0.618034 % 1.0) * 6.0
    tint = V3(torch.clamp(torch.abs(h6 - 3.0) - 1.0, 0.3, 1.0),
              torch.clamp(2.0 - torch.abs(h6 - 2.0), 0.3, 1.0),
              torch.clamp(2.0 - torch.abs(h6 - 4.0), 0.3, 1.0))
    tint = select_mat3(hit.mat_oh, tint)

    lit = 0.35 + 0.65 * headlight
    w = hit.valid.to(torch.float32)
    base = V3(*(w * lit * (0.55 * (0.5 + 0.5 * c) + 0.45 * t)
                for c, t in zip(n, tint)))

    # area lights draw as emissive white patches when nearer than geometry
    t_l, _ = intersect_area_lights(scene, o, d, t_min=T_MIN_RAYCAST)
    lt = (t_l < hit.t) & torch.isfinite(t_l)
    bg = 0.08  # miss: dark background
    color = V3(*(torch.where(lt, 1.0, torch.where(hit.valid, c, bg))
                 for c in base))
    color = V3(*(torch.sqrt(torch.clamp(c, 0.0, 1.0)) for c in color))
    return to_array(color).reshape(height, width, 3)


def _decimate_mesh(mesh: Mesh, max_faces: int) -> Mesh:
    idx = np.asarray(mesh.position_indices).reshape(-1, 3)
    faces = idx.shape[0]
    if faces <= max_faces:
        return mesh
    k = -(-faces // max_faces)  # every k-th face keeps the silhouette
    take = lambda a: (np.asarray(a).reshape(-1, 3)[::k].reshape(-1)
                      if len(a) else a)
    return Mesh(positions=mesh.positions, normals=mesh.normals,
                uvs=mesh.uvs, position_indices=take(mesh.position_indices),
                normal_indices=take(mesh.normal_indices),
                uv_indices=take(mesh.uv_indices), material=mesh.material)


def preview_scene(scene: Scene) -> Scene:
    """Shallow preview copy: meshes decimated to the face cap; everything
    else shared.  Returns `scene` itself when nothing needs decimating."""
    max_faces = int(os.environ.get("NR_PREVIEW_MAX_FACES",
                                   str(MAX_FACES_DEFAULT)))
    if all(len(m.position_indices) // 3 <= max_faces
           for m in scene.mesh_buffer):
        return scene
    s = copy.copy(scene)
    s.mesh_buffer = [_decimate_mesh(m, max_faces) for m in scene.mesh_buffer]
    return s


def preview_size(width: int, height: int, cap: int = MAX_SIDE):
    long_side = max(width, height, 1)
    if long_side <= cap:
        return max(width, 1), max(height, 1)
    return (max(1, round(width * cap / long_side)),
            max(1, round(height * cap / long_side)))


@register_renderer("GeometryPreview", description=(
    "Instant render-free geometry preview.\n"
    "Depth/normal raycast with per-material tint; the headless analogue "
    "of the viewport's wireframe PREVIEW mode."))
class GeometryPreviewRenderer(RenderComponent):
    def __init__(self, device="cuda"):
        self.device = device

    def render(self, scene: Scene) -> RenderResult:
        dev = check_device(self.device)
        w, h = preview_size(scene.render_option.width,
                            scene.render_option.height)
        arrays = build_scene_arrays(preview_scene(scene))
        cam = make_camera(scene.camera, device=dev)
        img = render_preview(arrays, cam, w, h, device=dev).cpu().numpy()
        img = img[::-1]
        rgba = np.concatenate([img, np.ones((h, w, 1), np.float32)], axis=2)
        return RenderResult(pixels=rgba, width=w, height=h)
