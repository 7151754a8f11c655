"""Parser for the `.scn` scene DSL.

Grammar reimplemented from the reference's hand-rolled parser
(`code/app/src/importer/ScnImporter.cpp:1-536` in civilizwa/nrenderer):

    Begin Material|Model|Light ... End   sections
    '#'-prefixed lines are comments; blank lines ignored
    Material <name> [type]               (type defaults to 0)
    Prop <key> <Int|Float|Vec3|Vec4|RGB|RGBA> <values...>
    Model <name> / Translation x y z / Scale x y z
    Sphere|Triangle|Plane <name> <materialName>   (sets a current-node-type cursor)
    R / N / V1 V2 V3 / P / U / V         fields resolved against the cursor
    Point|Spot|Directional|Area <name>   lights with IRV/P/D/HotSpot/Fallout/U/V

Error semantics match the reference: unknown token -> "Syntax Error!", unknown
material name -> error, duplicate material name -> error, and a failed import
rolls back ALL buffers (`ScnImporter.cpp:516-532`) — here the rollback is
trivially achieved by parsing into a fresh Scene and only merging on success.

Numeric extraction mimics C++ `istream >> float` so that malformed tokens in the
stock scenes (e.g. ``0.065,`` in `path_tracing_cornel.scn`) produce the same
values as the reference: the longest valid prefix is consumed, and a failed
extraction yields 0.0 for that and all later components of the same line.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

from ..scene.model import (
    AreaLight, DirectionalLight, Light, LightType, Material, Node, NodeType,
    Plane, PointLight, Property, PropertyType, Model, Scene, Sphere, SpotLight,
    Triangle,
)


class ScnParseError(Exception):
    """Raised on malformed .scn input (reference: lastErrorInfo + rollback)."""


_FLOAT_RE = re.compile(r"[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?")
_INT_RE = re.compile(r"[+-]?\d+")


class _LineStream:
    """Mimics a C++ stringstream over one line: whitespace-separated tokens,
    with C-stream numeric extraction (longest-prefix parse; failure => 0 and
    the stream enters a failed state so later extractions also return 0)."""

    def __init__(self, line: str):
        self.tokens = line.split()
        self.pos = 0
        self.failed = False
        self._partial: Optional[str] = None  # remainder of a partially-consumed token

    def word(self) -> str:
        if self._partial is not None:
            t, self._partial = self._partial, None
            return t
        if self.pos >= len(self.tokens):
            self.failed = True
            return ""
        t = self.tokens[self.pos]
        self.pos += 1
        return t

    def _next_raw(self) -> Optional[str]:
        if self._partial is not None:
            t, self._partial = self._partial, None
            return t
        if self.pos >= len(self.tokens):
            return None
        t = self.tokens[self.pos]
        self.pos += 1
        return t

    def number(self, pattern=_FLOAT_RE, cast=float):
        if self.failed:
            return cast(0)
        tok = self._next_raw()
        if tok is None:
            self.failed = True
            return cast(0)
        m = pattern.match(tok)
        if m is None or m.start() != 0:
            self.failed = True
            return cast(0)
        rest = tok[m.end():]
        if rest:
            self._partial = rest
        return cast(m.group(0))

    def f(self) -> float:
        return self.number(_FLOAT_RE, float)

    def i(self) -> int:
        return self.number(_INT_RE, int)

    def vec3(self) -> Tuple[float, float, float]:
        return (self.f(), self.f(), self.f())

    def vec4(self) -> Tuple[float, float, float, float]:
        return (self.f(), self.f(), self.f(), self.f())

    def uint(self) -> int:
        # `unsigned int type; if (!ss.eof()) ss>>type;` with default 0
        if self.pos >= len(self.tokens) and self._partial is None:
            return 0
        v = self.number(_INT_RE, int)
        return 0 if self.failed else v


def _iter_content_lines(lines: List[str], start: int):
    """Yield (index, stream) for non-blank, non-comment lines from `start`."""
    for idx in range(start, len(lines)):
        stripped = lines[idx].strip()
        if not stripped or stripped.startswith("#"):
            continue
        yield idx, _LineStream(lines[idx])


def _parse_materials(scene: Scene, lines: List[str], start: int,
                     mtl_map: Dict[str, int]) -> int:
    """Parse a `Begin Material` section; returns index after its `End`."""
    current: Optional[Material] = None
    for idx, ls in _iter_content_lines(lines, start):
        token = ls.word()
        if token == "Material":
            name = ls.word()
            if name in mtl_map:
                raise ScnParseError(f"Duplicated Material Key:{name}")
            current = Material(name=name, type=ls.uint())
            mtl_map[name] = len(scene.materials)
            scene.materials.append(current)
        elif token == "Prop":
            key, ptype = ls.word(), ls.word()
            if current is None:
                raise ScnParseError("Prop outside Material")
            if ptype == "Int":
                current.register_property(Property(key, PropertyType.INT, ls.i()))
            elif ptype == "Float":
                current.register_property(Property(key, PropertyType.FLOAT, ls.f()))
            elif ptype == "Vec3":
                current.register_property(Property(key, PropertyType.VEC3, ls.vec3()))
            elif ptype == "Vec4":
                current.register_property(Property(key, PropertyType.VEC4, ls.vec4()))
            elif ptype == "RGB":
                current.register_property(Property(key, PropertyType.RGB, ls.vec3()))
            elif ptype == "RGBA":
                current.register_property(Property(key, PropertyType.RGBA, ls.vec4()))
            # unknown prop types are silently ignored (reference behavior)
        elif token == "End":
            return idx + 1
        else:
            raise ScnParseError("Syntax Error!")
    return len(lines)


def _last(buffer: list):
    """Cursor access to the most recent entity of a section.  A field line
    arriving before any entity (`R` before a `Sphere`, `U` before an `Area`)
    is a malformed file: raise ScnParseError like every other grammar error
    so the CLI's handler reports it cleanly (the reference indexes [-1] into
    an empty vector here — UB we do not reproduce)."""
    if not buffer:
        raise ScnParseError("Syntax Error!")
    return buffer[-1]


def _parse_models(scene: Scene, lines: List[str], start: int,
                  mtl_map: Dict[str, int]) -> int:
    """Parse a `Begin Model` section (reference `ScnImporter::parseMdl`)."""
    curr_node_type = 0  # 0 sphere, 1 triangle, 2 plane — the field cursor

    def last_model() -> Model:
        if not scene.models:
            raise ScnParseError("Syntax Error!")
        return scene.models[-1]

    def new_node(ls: _LineStream, ntype: NodeType, buffer: list, entity) -> None:
        name = ls.word()
        mtl_name = ls.word()
        if mtl_name not in mtl_map:
            raise ScnParseError("Invalid material name.")
        entity.material = mtl_map[mtl_name]
        node = Node(name=name, type=ntype, entity=len(buffer),
                    model=len(scene.models) - 1)
        last_model().nodes.append(len(scene.nodes))
        scene.nodes.append(node)
        buffer.append(entity)

    for idx, ls in _iter_content_lines(lines, start):
        token = ls.word()
        if token == "Model":
            scene.models.append(Model(name=ls.word()))
        elif token == "Translation":
            last_model().translation = ls.vec3()
        elif token == "Scale":
            last_model().scale = ls.vec3()
        elif token == "Sphere":
            curr_node_type = 0
            new_node(ls, NodeType.SPHERE, scene.sphere_buffer, Sphere())
        elif token == "Triangle":
            curr_node_type = 1
            new_node(ls, NodeType.TRIANGLE, scene.triangle_buffer,
                     Triangle(normal=(0.0, 0.0, 0.0)))
        elif token == "Plane":
            curr_node_type = 2
            new_node(ls, NodeType.PLANE, scene.plane_buffer, Plane())
        elif token == "R":
            _last(scene.sphere_buffer).radius = ls.f()
        elif token == "N":
            n = ls.vec3()
            if curr_node_type == 0:
                _last(scene.sphere_buffer).direction = n
            elif curr_node_type == 1:
                _last(scene.triangle_buffer).normal = n
            else:
                _last(scene.plane_buffer).normal = n
        elif token in ("V1", "V2", "V3"):
            v = ls.vec3()
            tri = _last(scene.triangle_buffer)
            setattr(tri, {"V1": "v1", "V2": "v2", "V3": "v3"}[token], v)
        elif token == "P":
            p = ls.vec3()
            if curr_node_type == 0:
                _last(scene.sphere_buffer).position = p
            elif curr_node_type == 2:
                _last(scene.plane_buffer).position = p
            # triangles have no P field (reference ignores it)
        elif token == "U":
            _last(scene.plane_buffer).u = ls.vec3()
        elif token == "V":
            _last(scene.plane_buffer).v = ls.vec3()
        elif token == "End":
            return idx + 1
        else:
            raise ScnParseError("Syntax Error!")
    return len(lines)


def _parse_lights(scene: Scene, lines: List[str], start: int) -> int:
    """Parse a `Begin Light` section (reference `ScnImporter::parseLgt`)."""
    curr = -1  # 0 point, 1 area, 2 directional, 3 spot

    def new_light(ls: _LineStream, ltype: LightType, buffer: list, entity) -> None:
        light = Light(name=ls.word(), type=ltype, entity=len(buffer))
        scene.lights.append(light)
        buffer.append(entity)

    for idx, ls in _iter_content_lines(lines, start):
        token = ls.word()
        if token == "Point":
            curr = 0
            new_light(ls, LightType.POINT, scene.point_light_buffer, PointLight())
        elif token == "Area":
            curr = 1
            new_light(ls, LightType.AREA, scene.area_light_buffer, AreaLight())
        elif token == "Directional":
            curr = 2
            new_light(ls, LightType.DIRECTIONAL, scene.directional_light_buffer,
                      DirectionalLight())
        elif token == "Spot":
            curr = 3
            new_light(ls, LightType.SPOT, scene.spot_light_buffer, SpotLight())
        elif token == "IRV":
            v = ls.vec3()
            if curr == 0:
                _last(scene.point_light_buffer).intensity = v
            elif curr == 1:
                _last(scene.area_light_buffer).radiance = v
            elif curr == 2:
                _last(scene.directional_light_buffer).irradiance = v
            elif curr == 3:
                _last(scene.spot_light_buffer).intensity = v
        elif token == "P":
            p = ls.vec3()
            if curr == 0:
                _last(scene.point_light_buffer).position = p
            elif curr == 1:
                _last(scene.area_light_buffer).position = p
            elif curr == 3:
                _last(scene.spot_light_buffer).position = p
        elif token == "D":
            d = ls.vec3()
            # NOTE: the reference writes a Spot's D into the *directional* light
            # buffer (`ScnImporter.cpp:395-398`, an out-of-bounds bug when no
            # directional light exists). We set the spot's own direction.
            if curr == 2:
                _last(scene.directional_light_buffer).direction = d
            elif curr == 3:
                _last(scene.spot_light_buffer).direction = d
        elif token == "HotSpot":
            _last(scene.spot_light_buffer).hot_spot = ls.f()
        elif token == "Fallout":
            _last(scene.spot_light_buffer).fallout = ls.f()
        elif token == "U":
            _last(scene.area_light_buffer).u = ls.vec3()
        elif token == "V":
            _last(scene.area_light_buffer).v = ls.vec3()
        elif token == "End":
            return idx + 1
        else:
            raise ScnParseError("Syntax Error!")
    return len(lines)


def parse_scn(text: str, scene: Optional[Scene] = None) -> Scene:
    """Parse `.scn` text into a Scene. On error raises ScnParseError without
    mutating a passed-in scene (all-or-nothing, reference rollback semantics)."""
    staged = Scene()
    mtl_map: Dict[str, int] = {}
    # pre-existing materials are visible by name (reference passes a fresh
    # mtlMap per import, so names resolve only within one file — match that)
    lines = text.splitlines()
    idx = 0
    while idx < len(lines):
        stripped = lines[idx].strip()
        if not stripped or stripped.startswith("#"):
            idx += 1
            continue
        ls = _LineStream(lines[idx])
        token = ls.word()
        if token != "Begin":
            raise ScnParseError("Syntax Error!")
        section = ls.word()
        if section == "Material":
            idx = _parse_materials(staged, lines, idx + 1, mtl_map)
        elif section == "Model":
            idx = _parse_models(staged, lines, idx + 1, mtl_map)
        elif section == "Light":
            idx = _parse_lights(staged, lines, idx + 1)
        else:
            raise ScnParseError("Syntax Error!")

    if scene is None:
        return staged
    # merge into existing scene with index remapping (success path)
    _merge(scene, staged)
    return scene


def _merge(dst: Scene, src: Scene) -> None:
    mat_off = len(dst.materials)
    node_off = len(dst.nodes)
    sph_off, tri_off = len(dst.sphere_buffer), len(dst.triangle_buffer)
    pln_off, msh_off = len(dst.plane_buffer), len(dst.mesh_buffer)
    model_off = len(dst.models)
    pnt_off, area_off = len(dst.point_light_buffer), len(dst.area_light_buffer)
    dir_off, spt_off = (len(dst.directional_light_buffer),
                        len(dst.spot_light_buffer))

    dst.materials.extend(src.materials)
    for m in src.models:
        m.nodes = [n + node_off for n in m.nodes]
        dst.models.append(m)
    ent_off = {NodeType.SPHERE: sph_off, NodeType.TRIANGLE: tri_off,
               NodeType.PLANE: pln_off, NodeType.MESH: msh_off}
    for n in src.nodes:
        n.entity += ent_off[n.type]
        n.model += model_off
        dst.nodes.append(n)
    for buf_name in ("sphere_buffer", "triangle_buffer", "plane_buffer",
                     "mesh_buffer"):
        for e in getattr(src, buf_name):
            e.material += mat_off
            getattr(dst, buf_name).append(e)
    lt_off = {LightType.POINT: pnt_off, LightType.AREA: area_off,
              LightType.DIRECTIONAL: dir_off, LightType.SPOT: spt_off}
    for l in src.lights:
        l.entity += lt_off[l.type]
        dst.lights.append(l)
    dst.point_light_buffer.extend(src.point_light_buffer)
    dst.area_light_buffer.extend(src.area_light_buffer)
    dst.directional_light_buffer.extend(src.directional_light_buffer)
    dst.spot_light_buffer.extend(src.spot_light_buffer)


def load_scn(path: str, scene: Optional[Scene] = None) -> Scene:
    try:
        with open(path, "r", encoding="utf-8") as f:
            text = f.read()
    except OSError as exc:
        raise ScnParseError("File does not exist!") from exc
    return parse_scn(text, scene)
