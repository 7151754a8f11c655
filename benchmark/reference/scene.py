"""The reference's own scene: a `.scn` parser and the primitive tables.

A frozen copy of what the renderer does between the scene file and its
path tracer, for analytic scenes (spheres, triangles, parallelogram
planes, area lights, a constant ambient): the parser's C-stream number
extraction (`0.065,` reads as 0.065 and zeroes the rest of its line), the
model transform, the material table with its defaults and aliases, and
the host tables the tracer unrolls.  Numbers are rounded to float32 where
the renderer rounds them, so the tracer's float32 results are the
renderer's own.  Meshes, textures and environment maps are refused: no
configuration of this benchmark has them.  Imports numpy only."""
from __future__ import annotations

import re
from typing import NamedTuple, Optional

import numpy as np

_FLOAT_RE = re.compile(r"[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?")
_INT_RE = re.compile(r"[+-]?\d+")


class SceneError(ValueError):
    pass


class _Line:
    """One line as a C++ stringstream reads it: whitespace tokens; a number
    takes the longest valid prefix of its token, and a failed extraction
    gives 0 for it and every later number of the line."""

    def __init__(self, line: str):
        self.tokens = line.split()
        self.pos = 0
        self.failed = False
        self.partial: Optional[str] = None

    def _raw(self) -> Optional[str]:
        if self.partial is not None:
            t, self.partial = self.partial, None
            return t
        if self.pos >= len(self.tokens):
            return None
        self.pos += 1
        return self.tokens[self.pos - 1]

    def word(self) -> str:
        t = self._raw()
        if t is None:
            self.failed = True
            return ""
        return t

    def number(self, pattern=_FLOAT_RE, cast=float):
        if self.failed:
            return cast(0)
        tok = self._raw()
        m = None if tok is None else pattern.match(tok)
        if m is None:
            self.failed = True
            return cast(0)
        if tok[m.end():]:
            self.partial = tok[m.end():]
        return cast(m.group(0))

    def vec3(self) -> tuple:
        return (self.number(), self.number(), self.number())

    def uint(self) -> int:
        if self.pos >= len(self.tokens) and self.partial is None:
            return 0
        v = self.number(_INT_RE, int)
        return 0 if self.failed else v


class Parsed(NamedTuple):
    materials: list   # [(name, type, {key: (ptype, value)})]
    models: list      # [{"translation", "scale"}]
    nodes: list       # [(kind, model index, {fields})] in file order
    area_lights: list  # [{"radiance", "position", "u", "v"}]


def parse_scn(text: str) -> Parsed:
    """Parse `.scn` text (Material, Model and Light sections)."""
    materials, models, nodes, lights = [], [], [], []
    mat_index = {}
    section, cursor, light_kind = None, None, None
    for raw in text.splitlines():
        s = raw.strip()
        if not s or s.startswith("#"):
            continue
        ls = _Line(raw)
        tok = ls.word()
        if section is None:
            if tok != "Begin":
                raise SceneError(f"expected Begin, got {tok!r}")
            section = ls.word()
            if section not in ("Material", "Model", "Light"):
                raise SceneError(f"unknown section {section!r}")
            continue
        if tok == "End":
            section = None
            continue
        if section == "Material":
            if tok == "Material":
                name = ls.word()
                if name in mat_index:
                    raise SceneError(f"duplicated material {name}")
                mat_index[name] = len(materials)
                materials.append((name, ls.uint(), {}))
            elif tok == "Prop":
                key, ptype = ls.word(), ls.word()
                props = materials[-1][2]
                if ptype == "Float":
                    value = ls.number()
                elif ptype == "Int":
                    value = ls.number(_INT_RE, int)
                elif ptype in ("Vec3", "RGB"):
                    value = ls.vec3()
                elif ptype in ("Vec4", "RGBA"):
                    value = ls.vec3() + (ls.number(),)
                else:
                    continue
                props.setdefault(key, (ptype, value))   # first one wins
            else:
                raise SceneError(f"syntax error: {raw!r}")
        elif section == "Model":
            if tok == "Model":
                models.append({"translation": (0.0, 0.0, 0.0),
                               "scale": (1.0, 1.0, 1.0)})
            elif tok in ("Translation", "Scale"):
                models[-1][tok.lower()] = ls.vec3()
            elif tok in ("Sphere", "Triangle", "Plane"):
                ls.word()
                mname = ls.word()
                if mname not in mat_index:
                    raise SceneError(f"unknown material {mname}")
                fields = {"Sphere": {"P": (0.0, 0.0, 0.0), "R": 1.0},
                          "Triangle": {"V1": (0.0, 0.0, 0.0),
                                       "V2": (0.0, 0.0, 0.0),
                                       "V3": (0.0, 0.0, 0.0),
                                       "N": (0.0, 0.0, 0.0)},
                          "Plane": {"N": (0.0, 1.0, 0.0),
                                    "P": (0.0, 0.0, 0.0),
                                    "U": (1.0, 0.0, 0.0),
                                    "V": (0.0, 0.0, 1.0)}}[tok]
                fields["mat"] = mat_index[mname]
                cursor = (tok, len(models) - 1, fields)
                nodes.append(cursor)
            elif tok == "R":
                cursor[2]["R"] = ls.number()
            elif tok in ("N", "V1", "V2", "V3", "P", "U", "V"):
                v = ls.vec3()
                kind = cursor[0]
                if tok == "N" and kind == "Sphere":
                    continue
                if tok == "P" and kind == "Triangle":
                    continue
                cursor[2][tok] = v
            else:
                raise SceneError(f"syntax error: {raw!r}")
        else:
            if tok in ("Point", "Spot", "Directional"):
                raise SceneError(f"{tok} lights are not in the reference")
            if tok == "Area":
                lights.append({"radiance": (1.0, 1.0, 1.0),
                               "position": (0.0, 0.0, 0.0),
                               "u": (0.0, 0.0, 0.0), "v": (0.0, 0.0, 0.0)})
                light_kind = tok
            elif tok in ("IRV", "P", "U", "V") and light_kind == "Area":
                key = {"IRV": "radiance", "P": "position", "U": "u",
                       "V": "v"}[tok]
                lights[-1][key] = ls.vec3()
            else:
                raise SceneError(f"syntax error: {raw!r}")
    return Parsed(materials, models, nodes, lights)


class Tables(NamedTuple):
    """The tracer's scene: float32 numpy rows and Python numbers."""
    sph: list    # (cx, cy, cz, r, mat)
    tri: list    # (v1, e1, e2, n, mat)
    pln: list    # (pos, n, inv0, inv1, mat)
    al: list     # (pos, n, inv0, inv1, radiance)
    mats: list   # per material: dict of float32 parameters and "type"
    ambient: tuple


def _inv_columns(u, v) -> np.ndarray:
    """Inverse of the matrix with columns [u, v, u x v] (float64), with
    entries under 1e-12 of its largest set to exactly 0."""
    m = np.stack([u, v, np.cross(u, v)], axis=-1)
    try:
        inv = np.linalg.inv(m)
    except np.linalg.LinAlgError:
        return np.eye(3)
    scale = np.abs(inv).max() or 1.0
    inv[np.abs(inv) < 1e-12 * scale] = 0.0
    return inv


def _material(mtype: int, props: dict) -> dict:
    def get(key, *types):
        p = props.get(key)
        return p[1] if p is not None and p[0] in types else None

    ior = get("ior", "Float")
    if ior is None:
        ior = get("refractIndex", "Float")
    albedo = get("albedo", "RGB") or get("reflect", "RGB") or (1.0, 1.0, 1.0)
    if mtype == 4 and get("albedo", "RGB") is None:
        albedo = get("specularColor", "RGB") or (1.0, 1.0, 1.0)
    rough, f0, metal = (get("roughness", "Float"), get("F0", "Float"),
                        get("metalness", "Float"))
    f32 = lambda x: np.asarray(x, np.float64).astype(np.float32)
    return {
        "type": int(mtype),
        "diffuse": f32(get("diffuseColor", "RGB") or (1.0, 1.0, 1.0)),
        "albedo": f32(albedo),
        "ior": f32(1.5 if ior is None else ior),
        "absorbed": f32(get("absorbed", "RGB") or (1.0, 1.0, 1.0)),
        "eta_r": f32(get("eta_r", "Vec3") or (0.0, 0.0, 0.0)),
        "eta_i": f32(get("eta_i", "Vec3") or (0.0, 0.0, 0.0)),
        "roughness": f32(0.2 if rough is None else rough),
        "f0": f32(0.04 if f0 is None else f0),
        "metalness": f32(0.2 if metal is None else metal),
    }


def build_tables(parsed: Parsed) -> Tables:
    """The tables of a parsed scene: each model's translation and scale
    applied in float64, then rounded to float32."""
    f32 = lambda x: np.asarray(x, np.float64).astype(np.float32)
    sph, tri, pln = [], [], []
    for kind, mi, fl in parsed.nodes:
        model = parsed.models[mi]
        sc = np.asarray(model["scale"], np.float64)
        tr = np.asarray(model["translation"], np.float64)
        place = lambda p: np.asarray(p, np.float64) * sc + tr
        if kind == "Sphere":
            p = f32(place(fl["P"]))
            r = f32(float(fl["R"]) * float(sc[0]))
            sph.append((float(p[0]), float(p[1]), float(p[2]), float(r),
                        fl["mat"]))
        elif kind == "Triangle":
            v1, v2, v3 = (place(fl[k]) for k in ("V1", "V2", "V3"))
            tri.append((f32(v1), f32(v2 - v1), f32(v3 - v1), f32(fl["N"]),
                        fl["mat"]))
        else:
            u = np.asarray(fl["U"], np.float64) * sc
            v = np.asarray(fl["V"], np.float64) * sc
            inv = f32(_inv_columns(u, v))
            pln.append((f32(place(fl["P"])), f32(fl["N"]), inv[0], inv[1],
                        fl["mat"]))
    al = []
    for light in parsed.area_lights:
        u = np.asarray(light["u"], np.float64)
        v = np.asarray(light["v"], np.float64)
        inv = f32(_inv_columns(u, v))
        al.append((f32(light["position"]), f32(np.cross(u, v)), inv[0],
                   inv[1], f32(light["radiance"])))
    if not parsed.materials:
        raise SceneError("a scene without materials is not in the reference")
    mats = [_material(t, props) for _, t, props in parsed.materials]
    return Tables(sph, tri, pln, al, mats, (0.0, 0.0, 0.0))


def load_tables(path: str) -> Tables:
    with open(path, encoding="utf-8") as f:
        return build_tables(parse_scn(f.read()))


class Camera(NamedTuple):
    """The camera basis as float64 host vectors (the renderer's defaults:
    at (0, 0, 10) looking at (0, 0, 1000), up +y, fov 40, aspect 1,
    pinhole, focus distance 0.1)."""
    position: np.ndarray
    lower_left: np.ndarray
    horizontal: np.ndarray
    vertical: np.ndarray


def default_camera() -> Camera:
    position = np.array([0.0, 0.0, 10.0])
    look_at = np.array([0.0, 0.0, 1000.0])
    up = np.array([0.0, 1.0, 0.0])
    half_height = np.tan(np.radians(40.0) / 2.0)
    half_width = 1.0 * half_height
    w = position - look_at
    w = w / np.linalg.norm(w)
    u = np.cross(up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    fd = 0.1
    lower_left = position - half_width * fd * u - half_height * fd * v \
        - fd * w
    return Camera(position, lower_left, 2.0 * half_width * fd * u,
                  2.0 * half_height * fd * v)


def scene_epsilon(t: Tables, base: float = 1e-6) -> float:
    """max(base, 2e-6 x the scene's extent), as the renderer sets t_min."""
    extent = 1.0
    for (cx, cy, cz, r, _m) in t.sph:
        extent = max(extent, abs(cx) + r, abs(cy) + r, abs(cz) + r)
    for (v1, e1, e2, _n, _m) in t.tri:
        for k in range(3):
            extent = max(extent, abs(float(v1[k])),
                         abs(float(v1[k] + e1[k])),
                         abs(float(v1[k] + e2[k])))
    for (pos, _n, _i0, _i1, _m) in t.pln:
        for k in range(3):
            extent = max(extent, abs(float(pos[k])))
    return max(base, 2e-6 * extent)


def table_floats(t: Tables) -> int:
    """Floats of the kernel's scene table for these tables (the renderer's
    row strides: sphere 6, triangle 13, plane 14, light 16, material 22,
    ambient 3), for the roofline's bytes."""
    return (6 * len(t.sph) + 13 * len(t.tri) + 14 * len(t.pln)
            + 16 * len(t.al) + 22 * len(t.mats) + 3)


def primitive_counts(t: Tables) -> dict:
    return {"spheres": len(t.sph), "triangles": len(t.tri),
            "planes": len(t.pln), "lights": len(t.al)}
