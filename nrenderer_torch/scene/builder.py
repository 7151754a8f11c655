"""SceneBuilder: validated scene snapshotting.

Rebuild of the reference `SceneBuilder` (`app/src/asset/SceneBuilder.cpp`):
snapshots the editable asset state + render settings into the flat Scene
handed to renderers, validating that every node has a material.  The
reference composes an error message but never logs it and silently returns
nullptr (`SceneBuilder.cpp:100-110`), which the UI then passes to exec
unchecked — a latent crash (SURVEY.md §5.3).  Here validation errors raise
`SceneBuildError` with the full list of offending nodes.

A copy of `nrenderer_tpu/scene/builder.py` (it imports no JAX; the port keeps its
own copy)."""
from __future__ import annotations

import copy
from typing import List, Optional

from .model import (
    Ambient, AmbientType, Camera, NodeType, RenderOption, Scene,
)


class SceneBuildError(ValueError):
    pass


_ENTITY_BUFFERS = {
    NodeType.SPHERE: "sphere_buffer",
    NodeType.TRIANGLE: "triangle_buffer",
    NodeType.PLANE: "plane_buffer",
    NodeType.MESH: "mesh_buffer",
}


def validate_scene(scene: Scene) -> List[str]:
    """Returns a list of problems ('' clean). Mirrors the reference's
    every-node-has-a-material check plus index-consistency checks."""
    problems = []
    n_mats = len(scene.materials)
    for i, node in enumerate(scene.nodes):
        buf = getattr(scene, _ENTITY_BUFFERS[node.type])
        if not (0 <= node.entity < len(buf)):
            problems.append(f"node {i} ({node.name!r}): entity index "
                            f"{node.entity} out of range")
            continue
        ent = buf[node.entity]
        if not (0 <= ent.material < n_mats):
            problems.append(
                f"node {i} ({node.name!r}): no material assigned"
                if ent.material < 0 else
                f"node {i} ({node.name!r}): material {ent.material} "
                f"out of range")
        if not (-1 <= node.model < len(scene.models)):
            problems.append(f"node {i} ({node.name!r}): model index "
                            f"{node.model} out of range")
    for i, light in enumerate(scene.lights):
        from .model import LightType
        buf = {LightType.POINT: scene.point_light_buffer,
               LightType.AREA: scene.area_light_buffer,
               LightType.DIRECTIONAL: scene.directional_light_buffer,
               LightType.SPOT: scene.spot_light_buffer}[light.type]
        if not (0 <= light.entity < len(buf)):
            problems.append(f"light {i} ({light.name!r}): entity index "
                            f"{light.entity} out of range")
    return problems


def build_scene(scene: Scene, render_option: Optional[RenderOption] = None,
                camera: Optional[Camera] = None,
                ambient: Optional[Ambient] = None) -> Scene:
    """Deep-copy snapshot with settings applied (the reference copies all
    buffers by value, `SceneBuilder.cpp:14-83`).  Raises SceneBuildError on
    validation failure instead of returning nullptr."""
    problems = validate_scene(scene)
    if problems:
        raise SceneBuildError("; ".join(problems))
    snap = copy.deepcopy(scene)
    if render_option is not None:
        snap.render_option = copy.deepcopy(render_option)
    if camera is not None:
        snap.camera = copy.deepcopy(camera)
    if ambient is not None:
        snap.ambient = copy.deepcopy(ambient)
    return snap
