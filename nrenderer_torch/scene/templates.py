"""Material templates: built-in material schemas for authoring.

Rebuild of `MaterialTemplates` (`app/include/templates/MaterialTemplates.hpp:42-66`):
the five built-in material types with their expected property sets, used to
instantiate editable materials programmatically (the reference's UI "add
material from template" flow).

A copy of `nrenderer_tpu/scene/templates.py` (it imports no JAX; the port keeps its
own copy)."""
from __future__ import annotations

from typing import Dict, List, Tuple

from .model import Material, Property, PropertyType

# (type id, [(key, PropertyType, default), ...]) — mirrors the reference's
# template table; type meaning is per-renderer, like the reference.
TEMPLATES: Dict[str, Tuple[int, List[Tuple[str, PropertyType, object]]]] = {
    "Lambertian": (0, [
        ("diffuseColor", PropertyType.RGB, (1.0, 1.0, 1.0)),
    ]),
    "Phong": (1, [
        ("diffuseColor", PropertyType.RGB, (1.0, 1.0, 1.0)),
        ("specularColor", PropertyType.RGB, (1.0, 1.0, 1.0)),
        ("specularEx", PropertyType.FLOAT, 1.0),
    ]),
    "Dielectric": (2, [
        ("ior", PropertyType.FLOAT, 1.5),
        ("absorbed", PropertyType.RGB, (1.0, 1.0, 1.0)),
    ]),
    "Conductor": (3, [
        ("reflect", PropertyType.RGB, (1.0, 1.0, 1.0)),
    ]),
    # Plastic is template-only in the reference (no renderer implements
    # type 4); this rebuild DEFINES it as Fresnel-weighted diffuse+specular
    # (`ops/pt_core.plastic_scatter`).  `refractIndex` is the reference's
    # property name (`MaterialTemplates.hpp:65`); the importer also accepts
    # `ior` as an alias (scene/arrays.py).
    "Plastic": (4, [
        ("diffuseColor", PropertyType.RGB, (1.0, 1.0, 1.0)),
        ("specularColor", PropertyType.RGB, (1.0, 1.0, 1.0)),
        ("refractIndex", PropertyType.FLOAT, 1.5),
    ]),
}


def make_material(template: str, name: str = "") -> Material:
    """Instantiate a material from a named template with default props."""
    type_id, props = TEMPLATES[template]
    mat = Material(name=name or template, type=type_id)
    for key, ptype, default in props:
        mat.register_property(Property(key, ptype, default))
    return mat


def template_names() -> List[str]:
    return list(TEMPLATES.keys())
