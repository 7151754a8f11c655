"""Interactive scene editing over HTTP: the headless analogue of the
reference's AssetView scene editor
(`code/app/src/ui/views/AssetView.cpp:158-641`), which
lets the user tweak camera / materials / entities / lights / render
settings in an ImGui panel and re-render.

Here the editable state is a JSON *document* derived from the live
`Scene` dataclasses:

  - `scene_doc(scene)`   -> plain-JSON dict of every editable leaf
  - `apply_doc(scene, doc)` -> diff the submitted doc against the current
    one and write changed leaves back into the Scene objects (with type
    coercion + validation), returning the list of changed paths

and `SceneEditor` packages that as HTTP routes for `ScreenViewer`:

  - `GET  /scene`  current document + version + render state
  - `POST /scene`  submit an edited document; changed leaves are applied
                   and a re-render is requested (the CLI `edit` loop waits
                   on `wait_dirty()`)
  - `GET  /`       combined live-view + editor page (replaces the plain
                   viewer page)

Scope mirrors what the reference panel edits in place: camera, render
option, ambient, material type + properties (add/remove/change), model
transforms, entity geometry parameters and material bindings, and all
four light types.  APPENDING entities and lights is supported (the
panel's "add node"/"add light" buttons, AssetView.cpp:158-233): extra
list entries create the entity + its Node wiring exactly like the
importer does (`io/scn.py::new_node`); the next render rebuilds the
scene tables from the edited Scene.  REMOVAL is a `null`
list entry (the panel's delete buttons): the entity/light/material is
dropped with full node-index compaction.  New MATERIALS append either
from a named template (`scene/templates.py`, the panel's template-driven
creation AssetView.cpp:372-641) or as bare {name, type, properties};
new TEXTURES append as {"name", "path"} and are decoded host-side
(TextureImporter analogue).

The `edit` CLI posts a GeometryPreview on every applied edit before the
full render; `render_option` in the doc is live.

A copy of `nrenderer_tpu/server/editor.py` (it imports no JAX; the port
keeps its own copy), importing the port's scene and image modules.
"""
from __future__ import annotations

import copy
import json
import threading
from typing import Any, Dict, List, Tuple

from ..scene.model import (Ambient, AmbientType, AreaLight, Camera,
                           DirectionalLight, Light, LightType, Material,
                           Node, NodeType, Plane, PointLight, Property,
                           PropertyType, RenderOption, Scene, Sphere,
                           SpotLight, Texture, Triangle)

# ---------------------------------------------------------------------------
# Scene -> editable JSON document
# ---------------------------------------------------------------------------

_CAMERA_FIELDS = ("position", "up", "look_at", "fov", "aperture",
                  "focus_distance", "aspect")
_OPTION_FIELDS = ("width", "height", "depth", "samples_per_pixel",
                  "acc_type", "roughness", "f0", "metalness")
_SPHERE_FIELDS = ("position", "radius", "direction", "material")
_TRIANGLE_FIELDS = ("v1", "v2", "v3", "material")
_PLANE_FIELDS = ("normal", "position", "u", "v", "material")
_MODEL_FIELDS = ("translation", "scale")
_LIGHT_FIELDS = {
    "point": ("intensity", "position"),
    "area": ("radiance", "position", "u", "v"),
    "directional": ("irradiance", "direction"),
    "spot": ("intensity", "position", "direction", "hot_spot", "fallout"),
}
_LIGHT_BUFFERS = {
    "point": "point_light_buffer",
    "area": "area_light_buffer",
    "directional": "directional_light_buffer",
    "spot": "spot_light_buffer",
}


def _leaf(v):
    """Dataclass field value -> JSON leaf (tuples become lists)."""
    if isinstance(v, tuple):
        return [float(x) for x in v]
    return v


def _fields_doc(obj, fields) -> Dict[str, Any]:
    return {f: _leaf(getattr(obj, f)) for f in fields}


def scene_doc(scene: Scene) -> Dict[str, Any]:
    """Editable JSON document for `scene` (see module doc for scope)."""
    doc: Dict[str, Any] = {
        "camera": _fields_doc(scene.camera, _CAMERA_FIELDS),
        "render_option": _fields_doc(scene.render_option, _OPTION_FIELDS),
        "ambient": {
            "type": scene.ambient.type.name,
            "constant": _leaf(scene.ambient.constant),
        },
        "materials": [
            {
                "name": m.name,
                "type": m.type,
                "properties": {p.key: _leaf(p.value) for p in m.properties},
            }
            for m in scene.materials
        ],
        "models": [
            dict(name=m.name, **_fields_doc(m, _MODEL_FIELDS))
            for m in scene.models
        ],
        "spheres": [_fields_doc(s, _SPHERE_FIELDS)
                    for s in scene.sphere_buffer],
        "triangles": [_fields_doc(t, _TRIANGLE_FIELDS)
                      for t in scene.triangle_buffer],
        "planes": [_fields_doc(p, _PLANE_FIELDS)
                   for p in scene.plane_buffer],
        # mesh geometry is bulk data; only the material binding is editable
        "meshes": [{"material": m.material,
                    "faces": int(len(m.position_indices) // 3)}
                   for m in scene.mesh_buffer],
        "lights": {
            kind: [_fields_doc(lt, _LIGHT_FIELDS[kind])
                   for lt in getattr(scene, buf)]
            for kind, buf in _LIGHT_BUFFERS.items()
        },
        # existing textures are read-only metadata; NEW entries may be
        # appended as {"name":..., "path": "/file.png"} (TextureImporter
        # analogue, `app/src/importer/TextureImporter.cpp:7-21`)
        "textures": [{"name": t.name, "width": t.width, "height": t.height}
                     for t in scene.textures],
    }
    return doc


# ---------------------------------------------------------------------------
# Document -> Scene (diff + coerced write-back)
# ---------------------------------------------------------------------------

class EditError(ValueError):
    """A submitted edit failed validation; nothing past it was applied."""


def _coerce_like(cur, new, path: str, optional: bool = False):
    """Coerce JSON leaf `new` to the python type of the current value.

    `optional` marks Optional[float] knobs (RenderOption roughness/f0/
    metalness): null resets them to None even once a float is set.
    """
    try:
        if optional and new is None:
            return None
        if isinstance(cur, tuple):
            if not isinstance(new, (list, tuple)) or len(new) != len(cur):
                raise EditError(f"{path}: expected {len(cur)} numbers")
            return tuple(float(x) for x in new)
        if isinstance(cur, bool):  # before int (bool is an int subclass)
            return bool(new)
        if isinstance(cur, int):
            return int(new)
        if isinstance(cur, float):
            return float(new)
        if cur is None:  # Optional[float] knobs (roughness/f0/metalness)
            return None if new is None else float(new)
    except (TypeError, ValueError):
        raise EditError(f"{path}: bad value {new!r}")
    raise EditError(f"{path}: field is not editable")


_PROP_COERCE = {
    PropertyType.INT: lambda v: int(v),
    PropertyType.FLOAT: lambda v: float(v),
    PropertyType.TEXTURE_ID: lambda v: int(v),
    PropertyType.RGB: lambda v: tuple(float(x) for x in v),
    PropertyType.VEC3: lambda v: tuple(float(x) for x in v),
    PropertyType.RGBA: lambda v: tuple(float(x) for x in v),
    PropertyType.VEC4: lambda v: tuple(float(x) for x in v),
}
_PROP_ARITY = {PropertyType.RGB: 3, PropertyType.VEC3: 3,
               PropertyType.RGBA: 4, PropertyType.VEC4: 4}


def _infer_prop(key: str, value, path: str) -> Property:
    """New property (key not on the material yet): infer a type the way the
    reference panel's typed 'add property' buttons do (AssetView.cpp:330+)."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        t = PropertyType.FLOAT if isinstance(value, float) else PropertyType.INT
        return Property(key, t, _PROP_COERCE[t](value))
    if isinstance(value, (list, tuple)) and len(value) == 3:
        return Property(key, PropertyType.RGB,
                        tuple(float(x) for x in value))
    if isinstance(value, (list, tuple)) and len(value) == 4:
        return Property(key, PropertyType.RGBA,
                        tuple(float(x) for x in value))
    raise EditError(f"{path}: cannot infer property type")


def _apply_material(mat: Material, mdoc: Dict[str, Any],
                    path: str, changed: List[str]) -> None:
    if not isinstance(mdoc, dict):
        raise EditError(f"{path}: expected an object")
    if "type" in mdoc:
        try:
            new_type = int(mdoc["type"])
        except (TypeError, ValueError):
            raise EditError(f"{path}.type: bad value {mdoc['type']!r}")
        if new_type != mat.type:
            mat.type = new_type
            changed.append(f"{path}.type")
    if "name" in mdoc and str(mdoc["name"]) != mat.name:
        mat.name = str(mdoc["name"])
        changed.append(f"{path}.name")
    props = mdoc.get("properties", None)
    if props is None:
        return
    if not isinstance(props, dict):
        raise EditError(f"{path}.properties: expected an object")
    for key, val in props.items():
        ppath = f"{path}.properties.{key}"
        existing = next((p for p in mat.properties if p.key == key), None)
        if val is None:  # null deletes (reference panel's remove button)
            if existing is not None:
                mat.remove_property(key)
                changed.append(ppath)
            continue
        if existing is None:
            mat.register_property(_infer_prop(key, val, ppath))
            changed.append(ppath)
            continue
        arity = _PROP_ARITY.get(existing.type)
        if arity is not None and (not isinstance(val, (list, tuple))
                                  or len(val) != arity):
            raise EditError(f"{ppath}: expected {arity} numbers")
        try:
            new = _PROP_COERCE[existing.type](val)
        except (TypeError, ValueError):
            raise EditError(f"{ppath}: bad value for {existing.type.value}")
        if new != existing.value:
            existing.value = new
            changed.append(ppath)
    # keys absent from the submitted dict are left alone (partial docs OK)


def _apply_fields(obj, odoc: Dict[str, Any], fields, path: str,
                  changed: List[str], optional=()) -> None:
    if not isinstance(odoc, dict):
        raise EditError(f"{path}: expected an object")
    for f in fields:
        if f not in odoc:
            continue
        cur = getattr(obj, f)
        new = _coerce_like(cur, odoc[f], f"{path}.{f}", optional=f in optional)
        if new != cur:
            setattr(obj, f, new)
            changed.append(f"{path}.{f}")


def _apply_list(items, docs, fields, path: str, changed: List[str],
                factory=None, remover=None) -> None:
    """Apply docs entry-by-entry; extra entries are CREATED via `factory`
    (the AssetView 'add node'/'add light' flow) when one is provided, and
    `null` entries are REMOVED via `remover` (the panel's delete buttons,
    AssetView.cpp:209-370) — removal happens after all edits so indices in
    the submitted doc always refer to the pre-edit list."""
    if not isinstance(docs, list):
        raise EditError(f"{path}: expected a list")
    if len(docs) < len(items):
        raise EditError(f"{path}: a shorter list is ambiguous; mark "
                        "removed entries with null instead")
    if len(docs) > len(items) and factory is None:
        raise EditError(f"{path}: length {len(docs)} != {len(items)} "
                        "(adding entries is not supported here)")
    n_existing = len(items)
    to_remove: List[int] = []
    for i, odoc in enumerate(docs):
        if odoc is None:
            if remover is None:
                raise EditError(f"{path}[{i}]: removing entries is not "
                                "supported here")
            if i >= n_existing:
                continue  # added-then-nulled in one doc: a no-op
            to_remove.append(i)
            continue
        if i < n_existing:
            obj = items[i]
        else:
            if not isinstance(odoc, dict):
                raise EditError(f"{path}[{i}]: expected an object")
            obj = factory(odoc, i)
            changed.append(f"{path}[{i}] (added)")
        _apply_fields(obj, odoc, fields, f"{path}[{i}]", changed)
    for i in reversed(to_remove):  # descending: indices stay valid
        remover(i)
        changed.append(f"{path}[{i}] (removed)")


_ENTITY_KINDS = {
    # doc key -> (entity class, node type, scene buffer attr)
    "spheres": (Sphere, NodeType.SPHERE, "sphere_buffer"),
    "triangles": (Triangle, NodeType.TRIANGLE, "triangle_buffer"),
    "planes": (Plane, NodeType.PLANE, "plane_buffer"),
    # meshes: removable + material-editable; bulk geometry is import-only
    "meshes": (None, NodeType.MESH, "mesh_buffer"),
}
_LIGHT_CLASSES = {"point": (PointLight, LightType.POINT),
                  "area": (AreaLight, LightType.AREA),
                  "directional": (DirectionalLight, LightType.DIRECTIONAL),
                  "spot": (SpotLight, LightType.SPOT)}


def _entity_factory(scene: Scene, key: str):
    """Create-and-wire a new geometry entity the way the importer does
    (`io/scn.py::new_node`): buffer slot + Node + optional Model link."""
    cls, ntype, buf_attr = _ENTITY_KINDS[key]

    def make(odoc: Dict[str, Any], i: int):
        if "material" not in odoc:
            raise EditError(f"{key}[{i}]: a new entity needs a "
                            "'material' index")
        try:
            model = int(odoc.get("model", -1))
        except (TypeError, ValueError):
            raise EditError(f"{key}[{i}]: bad model {odoc.get('model')!r}")
        if model >= len(scene.models):
            raise EditError(f"{key}[{i}]: model {model} out of range")
        buf = getattr(scene, buf_attr)
        node = Node(name=str(odoc.get("name", f"edit_{key}_{i}")),
                    type=ntype, entity=len(buf), model=model)
        if model >= 0:
            scene.models[model].nodes.append(len(scene.nodes))
        scene.nodes.append(node)
        ent = cls()
        buf.append(ent)
        return ent

    return make


def _light_factory(scene: Scene, kind: str):
    cls, ltype = _LIGHT_CLASSES[kind]

    def make(odoc: Dict[str, Any], i: int):
        buf = getattr(scene, _LIGHT_BUFFERS[kind])
        scene.lights.append(Light(name=str(odoc.get("name",
                                                    f"edit_{kind}_{i}")),
                                  type=ltype, entity=len(buf)))
        lt = cls()
        buf.append(lt)
        return lt

    return make


def _entity_remover(scene: Scene, key: str):
    """Remove entity i of `key` with full index compaction (the panel's
    delete button, AssetView.cpp:209-370): drops the buffer slot, its Node,
    fixes later same-type Node.entity indices, and renumbers every
    Model.nodes entry past the dropped node."""
    _, ntype, buf_attr = _ENTITY_KINDS[key]

    def remove(i: int) -> None:
        buf = getattr(scene, buf_attr)
        del buf[i]
        j = next((k for k, nd in enumerate(scene.nodes)
                  if nd.type is ntype and nd.entity == i), None)
        if j is not None:
            del scene.nodes[j]
            for mdl in scene.models:
                mdl.nodes = [k - 1 if k > j else k
                             for k in mdl.nodes if k != j]
        for nd in scene.nodes:
            if nd.type is ntype and nd.entity > i:
                nd.entity -= 1

    return remove


def _light_remover(scene: Scene, kind: str):
    _, ltype = _LIGHT_CLASSES[kind]

    def remove(i: int) -> None:
        buf = getattr(scene, _LIGHT_BUFFERS[kind])
        del buf[i]
        j = next((k for k, lt in enumerate(scene.lights)
                  if lt.type is ltype and lt.entity == i), None)
        if j is not None:
            del scene.lights[j]
        for lt in scene.lights:
            if lt.type is ltype and lt.entity > i:
                lt.entity -= 1

    return remove


_ENTITY_BUFFERS = ("sphere_buffer", "triangle_buffer", "plane_buffer",
                   "mesh_buffer")


def _remove_material(scene: Scene, i: int) -> None:
    """Remove material i; rejects while any entity still binds it, then
    renumbers later material indices on every entity."""
    for buf_attr in _ENTITY_BUFFERS:
        for k, obj in enumerate(getattr(scene, buf_attr)):
            if obj.material == i:
                raise EditError(
                    f"materials[{i}]: still bound by "
                    f"{buf_attr.replace('_buffer', 's')}[{k}]")
    del scene.materials[i]
    for buf_attr in _ENTITY_BUFFERS:
        for obj in getattr(scene, buf_attr):
            if obj.material > i:
                obj.material -= 1


def _material_factory(mdoc: Dict[str, Any], path: str) -> Material:
    """New material: either from a named template (the reference panel's
    template-driven creation, AssetView.cpp:372-641 + MaterialTemplates)
    or a bare {name, type}; properties in the doc are applied on top."""
    from ..scene.templates import TEMPLATES, make_material
    if "template" in mdoc:
        tname = str(mdoc["template"])
        if tname not in TEMPLATES:
            names = ", ".join(TEMPLATES)
            raise EditError(f"{path}.template: one of {names}")
        return make_material(tname, str(mdoc.get("name", "")))
    try:
        type_id = int(mdoc.get("type", 0))
    except (TypeError, ValueError):
        raise EditError(f"{path}.type: bad value {mdoc.get('type')!r}")
    return Material(name=str(mdoc.get("name", "")), type=type_id)


def _import_texture(scene: Scene, tdoc: Dict[str, Any], path: str) -> None:
    """TextureImporter analogue (`TextureImporter.cpp:7-21`): appended
    texture entries carry a file `path` that is decoded host-side."""
    if not isinstance(tdoc, dict) or "path" not in tdoc:
        raise EditError(f"{path}: a new texture needs a file 'path'")
    from ..io.image import load_image
    fpath = str(tdoc["path"])
    pixels = load_image(fpath)
    if pixels is None:
        raise EditError(f"{path}: cannot load image {fpath!r}")
    scene.textures.append(Texture(name=str(tdoc.get("name", fpath)),
                                  pixels=pixels))


def apply_doc(scene: Scene, doc: Dict[str, Any]) -> List[str]:
    """Apply an edited document to `scene`; returns the changed paths.

    Partial documents are fine — only keys present are considered, and
    only leaves that differ from the current value are written.  Raises
    `EditError` on malformed input; edits before the failing leaf may
    already be applied (the CLI loop re-renders regardless, so a partial
    apply is visible, not silent).
    """
    if not isinstance(doc, dict):
        raise EditError("document root must be an object")
    changed: List[str] = []
    if "camera" in doc:
        _apply_fields(scene.camera, doc["camera"], _CAMERA_FIELDS,
                      "camera", changed)
    if "render_option" in doc:
        _apply_fields(scene.render_option, doc["render_option"],
                      _OPTION_FIELDS, "render_option", changed,
                      optional=("roughness", "f0", "metalness"))
    if "ambient" in doc:
        adoc = doc["ambient"]
        if not isinstance(adoc, dict):
            raise EditError("ambient: expected an object")
        if "type" in adoc:
            try:
                new_t = AmbientType[str(adoc["type"])]
            except KeyError:
                names = ", ".join(t.name for t in AmbientType)
                raise EditError(f"ambient.type: one of {names}")
            if new_t != scene.ambient.type:
                if (new_t is AmbientType.ENVIRONMENT_MAP
                        and scene.ambient.environment_map < 0):
                    raise EditError("ambient.type: no environment map loaded")
                scene.ambient.type = new_t
                changed.append("ambient.type")
        _apply_fields(scene.ambient, adoc, ("constant",), "ambient", changed)
    if "materials" in doc:
        mdocs = doc["materials"]
        if not isinstance(mdocs, list):
            raise EditError("materials: expected a list")
        if len(mdocs) < len(scene.materials):
            raise EditError("materials: a shorter list is ambiguous; mark "
                            "removed entries with null instead")
        n_existing = len(scene.materials)
        mats_to_remove: List[int] = []
        for i, mdoc in enumerate(mdocs):
            mpath = f"materials[{i}]"
            if mdoc is None:
                if i < n_existing:
                    mats_to_remove.append(i)
                continue
            if i < n_existing:
                _apply_material(scene.materials[i], mdoc, mpath, changed)
            else:
                mat = _material_factory(mdoc, mpath)
                scene.materials.append(mat)
                changed.append(f"{mpath} (added)")
                _apply_material(mat, {k: v for k, v in mdoc.items()
                                      if k != "template"}, mpath, changed)
        for i in reversed(mats_to_remove):
            _remove_material(scene, i)
            changed.append(f"materials[{i}] (removed)")
    if "models" in doc:
        _apply_list(scene.models, doc["models"], _MODEL_FIELDS,
                    "models", changed)
    if "spheres" in doc:
        _apply_list(scene.sphere_buffer, doc["spheres"], _SPHERE_FIELDS,
                    "spheres", changed, _entity_factory(scene, "spheres"),
                    _entity_remover(scene, "spheres"))
    if "triangles" in doc:
        _apply_list(scene.triangle_buffer, doc["triangles"],
                    _TRIANGLE_FIELDS, "triangles", changed,
                    _entity_factory(scene, "triangles"),
                    _entity_remover(scene, "triangles"))
    if "planes" in doc:
        _apply_list(scene.plane_buffer, doc["planes"], _PLANE_FIELDS,
                    "planes", changed, _entity_factory(scene, "planes"),
                    _entity_remover(scene, "planes"))
    if "meshes" in doc:
        _apply_list(scene.mesh_buffer, doc["meshes"], ("material",),
                    "meshes", changed,
                    remover=_entity_remover(scene, "meshes"))
    if "lights" in doc:
        ldoc = doc["lights"]
        if not isinstance(ldoc, dict):
            raise EditError("lights: expected an object")
        for kind, buf in _LIGHT_BUFFERS.items():
            if kind in ldoc:
                _apply_list(getattr(scene, buf), ldoc[kind],
                            _LIGHT_FIELDS[kind], f"lights.{kind}", changed,
                            _light_factory(scene, kind),
                            _light_remover(scene, kind))
    if "textures" in doc:
        tdocs = doc["textures"]
        if not isinstance(tdocs, list) or len(tdocs) < len(scene.textures):
            raise EditError(f"textures: expected a list of at least "
                            f"{len(scene.textures)} (existing entries are "
                            "read-only)")
        for i, tdoc in enumerate(tdocs):
            if i < len(scene.textures):
                continue  # existing textures: read-only metadata
            _import_texture(scene, tdoc, f"textures[{i}]")
            changed.append(f"textures[{i}] (imported)")
    # validate material bindings stay in range
    n_mat = len(scene.materials)
    for group in (scene.sphere_buffer, scene.triangle_buffer,
                  scene.plane_buffer, scene.mesh_buffer):
        for obj in group:
            if not (-1 <= obj.material < n_mat):
                raise EditError(f"material index {obj.material} out of "
                                f"range (0..{n_mat - 1})")
    return changed


# ---------------------------------------------------------------------------
# HTTP surface
# ---------------------------------------------------------------------------

_EDIT_PAGE = b"""<!doctype html>
<html><head><title>nrenderer-tpu editor</title><style>
body { background:#181818; color:#ccc; font-family:monospace; margin:0;
       display:flex; height:100vh; }
#left { flex:1; display:flex; flex-direction:column; align-items:center;
        padding:8px; overflow:auto; }
#right { width:44%; display:flex; flex-direction:column; padding:8px;
         border-left:1px solid #333; }
img { image-rendering:pixelated; border:1px solid #444; max-width:100%;
      max-height:80vh; }
textarea { flex:1; background:#111; color:#9c9; border:1px solid #333;
           font-family:monospace; font-size:12px; }
button { margin-top:6px; padding:6px; background:#264; color:#eee;
         border:1px solid #486; cursor:pointer; }
#msg { color:#c96; min-height:2em; white-space:pre-wrap; }
</style></head><body>
<div id="left"><h3 id="st">waiting...</h3><img id="frame"/>
<pre id="log" style="font-size:11px;color:#897;max-height:14vh;
     overflow:auto;width:95%"></pre></div>
<div id="right">
  <div>scene document (edit + apply to re-render)</div>
  <textarea id="doc" spellcheck="false"></textarea>
  <button id="apply">apply + re-render</button>
  <button id="reload">reload from server</button>
  <div id="msg"></div>
</div>
<script>
let last = -1, version = -1;
async function loadDoc() {
  const r = await fetch('/scene');
  const s = await r.json();
  version = s.version;
  document.getElementById('doc').value = JSON.stringify(s.doc, null, 2);
}
async function tick() {
  try {
    const r = await fetch('/status');
    const s = await r.json();
    document.getElementById('st').textContent =
      `${s.width}x${s.height}  frame ${s.frame}  state ${s.state}`;
    if (s.frame !== last && s.frame > 0) {
      last = s.frame;
      document.getElementById('frame').src = '/frame.png?f=' + s.frame;
    }
    const lg = await (await fetch('/log')).json();
    document.getElementById('log').textContent =
      lg.map(m => `[${m.type}] ${m.content}`).join('\\n');
  } catch (e) {}
  setTimeout(tick, 500);
}
document.getElementById('apply').onclick = async () => {
  const msg = document.getElementById('msg');
  try {
    const r = await fetch('/scene', {method: 'POST',
      body: document.getElementById('doc').value});
    const s = await r.json();
    msg.textContent = s.error ? ('error: ' + s.error)
      : (s.changed.length ? 'applied: ' + s.changed.join(', ')
                          : 'no changes');
  } catch (e) { msg.textContent = 'request failed: ' + e; }
};
document.getElementById('reload').onclick = loadDoc;
loadDoc(); tick();
</script></body></html>"""


class SceneEditor:
    """Owns the editable scene + the dirty flag the render loop waits on.

    Thread contract: `routes` handlers run on the HTTP server threads;
    `wait_dirty` / `mark_rendering` / `snapshot` run on the render loop
    thread.  The scene is only MUTATED under `_lock`; the render loop
    renders a `snapshot()` (a deep copy taken under the same lock), so a
    POST /scene landing mid-render can never tear the frame being traced
    — the edit simply re-triggers via the dirty flag.
    """

    def __init__(self, scene: Scene):
        self._scene = scene
        self._lock = threading.Lock()
        self._dirty = threading.Event()
        self._version = 0
        self._rendering = False

    # -- render-loop side --------------------------------------------------

    def wait_dirty(self, timeout: float = None) -> bool:
        if self._dirty.wait(timeout):
            self._dirty.clear()
            return True
        return False

    def mark_rendering(self, flag: bool) -> None:
        self._rendering = flag

    def snapshot(self) -> Tuple[Scene, int]:
        """Deep-copied scene + its version, taken atomically under the
        edit lock.  The render loop traces the copy, so concurrent POSTs
        can't produce a torn frame (an entity appended between node and
        buffer writes, a half-updated camera, ...)."""
        with self._lock:
            return copy.deepcopy(self._scene), self._version

    @property
    def version(self) -> int:
        return self._version

    # -- HTTP side -----------------------------------------------------------

    def _get_scene(self, method, body) -> Tuple[int, str, bytes]:
        with self._lock:
            payload = {"version": self._version,
                       "rendering": self._rendering,
                       "doc": scene_doc(self._scene)}
        return 200, "application/json", json.dumps(payload).encode()

    def _post_scene(self, body: bytes) -> Tuple[int, str, bytes]:
        try:
            doc = json.loads(body.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError) as exc:
            return 400, "application/json", json.dumps(
                {"error": f"bad JSON: {exc}"}).encode()
        with self._lock:
            try:
                changed = apply_doc(self._scene, doc)
            except EditError as exc:
                return 400, "application/json", json.dumps(
                    {"error": str(exc)}).encode()
            if changed:
                self._version += 1
                self._dirty.set()
            payload = {"version": self._version, "changed": changed}
        return 200, "application/json", json.dumps(payload).encode()

    def _scene_route(self, method: str, body: bytes):
        if method == "POST":
            return self._post_scene(body)
        return self._get_scene(method, body)

    @property
    def routes(self):
        """Route table for `ScreenViewer(..., routes=...)`."""
        return {
            "/": lambda m, b: (200, "text/html", _EDIT_PAGE),
            "/scene": self._scene_route,
        }
