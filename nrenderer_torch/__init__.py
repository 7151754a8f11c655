"""nrenderer_torch — the PyTorch/CUDA port of nrenderer_tpu.

The same pluggable offline renderer (the `.scn` scene DSL, the renderer
registry, the renderers), written as PyTorch ops with hand-written CUDA
kernels for an NVIDIA H100 in place of the JAX package's Pallas TPU kernels.
Module paths and public names mirror `nrenderer_tpu`.  This package imports
torch, numpy and the standard library only; it never imports JAX.
"""
__version__ = "0.1.0"

from .scene.model import (  # noqa: F401
    Ambient, AmbientType, AreaLight, Camera, DirectionalLight, Light,
    LightType, Material, Mesh, Model, Node, NodeType, Plane, PointLight,
    Property, PropertyType, RenderOption, Scene, Sphere, SpotLight, Texture,
)
from .scene.arrays import SceneArrays, build_scene_arrays  # noqa: F401
from .scene.builder import SceneBuildError, build_scene, validate_scene  # noqa: F401
from .scene.templates import make_material, template_names  # noqa: F401
from .io.scn import load_scn, parse_scn, ScnParseError  # noqa: F401
from .io.obj import load_obj, ObjParseError  # noqa: F401


def _register_builtin_renderers() -> None:
    """Import renderer modules for their registration side effects (the
    analogue of the reference's DLL scan + static-initializer registration,
    `ComponentManager.cpp:15-30`)."""
    from .renderers import (example, raycast, simple_pt, acc_pt, mlt,  # noqa: F401
                            preview)  # noqa: F401
