"""Wavefront OBJ (+ MTL subset) importer.

A copy of `nrenderer_tpu/io/obj.py`, which reimplements the reference's
`ObjImporter` (`code/app/src/importer/ObjImporter.cpp:1-421` in
civilizwa/nrenderer):

  - directives: `mtllib`, `usemtl`, `v`, `vt`, `vn`, `o`/`g`, `f`
  - `f` variants: ``v``, ``v/t``, ``v//n``, ``v/t/n`` — triangulated faces only
    (the reference raises "Only Triangulated mesh is supported!")
  - per-object index remapping: global OBJ indices are compacted into
    per-mesh position/uv/normal pools (reference `ObjImporter.cpp:192-196`)
  - MTL subset: `newmtl`, `Kd`, `Ks`, `Ns`, `map_Kd`, `map_Ks`,
    `map_bump`/`bump`; a nonzero `Ks` makes the material Phong-typed
    (type=1, `ObjImporter.cpp:52-61`); unknown keys ignored.  `map_Kd`
    feeds the diffuse lobes and `map_Ks` the specular lobes; `map_bump` is
    stored but not shaded.  A missing `.mtl` is skipped.

Plain triangulated files (no `mtllib`, `usemtl`, `o` or `g`) take the
host library's scan (`native.obj_scan`, the C++ scan of the JAX package's
native route, `nrenderer_tpu/io/obj.py:119-172`), or under NR_NO_NATIVE=1
its numpy version `_scan_plain`, and build one mesh that keeps the file's
whole `v` pool, where the line parser compacts the pool per mesh.  Both
scans round each coordinate once, as `strtof` does.  All buffers land in
the same Scene structures the `.scn` parser fills, so the two importers
compose."""
from __future__ import annotations

import os
from decimal import Decimal
from typing import Dict, List, Optional

import numpy as np

from .. import native
from ..scene.model import (
    Material, Mesh, Model, Node, NodeType, Property, PropertyType, Scene,
    Texture,
)
from .image import load_image


class ObjParseError(Exception):
    pass


def _parse_face_vertex(tok: str):
    """Return (v, t, n) 1-based indices; absent -> -1. Mirrors the reference's
    first/last '/' split (`ObjImporter.cpp:322-339`)."""
    first = tok.find("/")
    last = tok.rfind("/")
    try:
        if first == -1:
            return int(tok), -1, -1
        if first == last:
            a, b = tok.split("/")
            return int(a), int(b), -1
        if first + 1 == last:
            a, _, c = tok.split("/")
            return int(a), -1, int(c)
        a, b, c = tok.split("/")
        return int(a), int(b), int(c)
    except ValueError as exc:
        raise ObjParseError(f"Bad face vertex: {tok!r}") from exc


def _load_map(scene: Scene, mtl_path: str, tex_name: str,
              material: Material, prop_name: str) -> None:
    """Decode a texture referenced from an MTL line and attach it to
    `material` as a TEXTURE_ID property; silently skipped when the image
    is missing/undecodable (reference behavior for a bad stb load)."""
    tex_path = os.path.join(os.path.dirname(mtl_path), tex_name)
    pixels = load_image(tex_path)
    if pixels is None:
        return
    tex_idx = len(scene.textures)
    scene.textures.append(
        Texture(name=os.path.basename(tex_path), pixels=pixels))
    material.register_property(Property(
        prop_name, PropertyType.TEXTURE_ID, tex_idx))


def _parse_mtl(scene: Scene, path: str, mtl_map: Dict[str, int]) -> None:
    if not os.path.exists(path):
        return  # reference silently skips a missing .mtl
    current: Optional[Material] = None
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            key = parts[0].lower()
            if key == "newmtl":
                name = parts[1] if len(parts) > 1 else ""
                # Lambertian until a nonzero Ks appears: type 1 means
                # Phong to RayCast but CONDUCTOR to the acc plugin
                # (`acc/ShaderCreator.hpp:25-27`), so a diffuse-only MTL
                # tagged Phong would render black in the path tracers
                current = Material(name=name, type=0)
                mtl_map[name] = len(scene.materials)
                scene.materials.append(current)
            elif current is None:
                continue
            elif key == "kd" and len(parts) >= 4:
                current.register_property(Property(
                    "diffuseColor", PropertyType.RGB,
                    (float(parts[1]), float(parts[2]), float(parts[3]))))
            elif key == "ks" and len(parts) >= 4:
                ks = (float(parts[1]), float(parts[2]), float(parts[3]))
                current.register_property(Property(
                    "specularColor", PropertyType.RGB, ks))
                if any(v > 0.0 for v in ks):
                    current.type = 1  # Phong
            elif key == "ns" and len(parts) >= 2:
                current.register_property(Property(
                    "specularEx", PropertyType.FLOAT, float(parts[1])))
            elif key == "map_kd" and len(parts) >= 2:
                _load_map(scene, path, parts[-1], current, "diffuseMap")
            elif key == "map_ks" and len(parts) >= 2:
                # reference `ObjImporter.cpp:56-58` loads map_Ks the same way
                _load_map(scene, path, parts[-1], current, "specularMap")
            elif key in ("map_bump", "bump") and len(parts) >= 2:
                # reference `ObjImporter.cpp:59-61`; stored, not yet shaded
                _load_map(scene, path, parts[-1], current, "bumpMap")


def _needs_line_parser(data: bytes) -> bool:
    """Whether a file has the directives the plain route refuses
    (`nrenderer_tpu/io/obj.py:130-140`), matched the same way: anywhere
    in the file."""
    probe = b"\n" + data
    return (b"usemtl" in probe or b"mtllib" in probe or b"\no " in probe
            or b"\ng " in probe)


# float32's largest finite value plus half its last step: the point at
# which rounding to nearest overflows to infinity
_F32_OVERFLOW = float(np.finfo(np.float32).max) + 2.0 ** 103


def _float32(tokens: List[str]) -> np.ndarray:
    """Decimal strings rounded once to float32, as `strtof` rounds them.
    Rounding through float64 rounds twice, and goes wrong where the
    float64 value lands exactly on a point halfway between two float32
    values that the decimal is not on: there the decimal decides.
    Raises ValueError on a token `float` refuses."""
    wide = np.array([float(t) for t in tokens], np.float64)
    with np.errstate(over="ignore", invalid="ignore"):
        near = wide.astype(np.float32)
        # the float32 on wide's other side of near, and the point halfway
        other = np.nextafter(near, np.where(wide > near, np.float32(np.inf),
                                            np.float32(-np.inf)))
        half = (near.astype(np.float64) + other.astype(np.float64)) * 0.5
    half = np.where(np.isinf(near) & np.isfinite(wide),
                    np.copysign(_F32_OVERFLOW, wide), half)
    for i in np.flatnonzero(wide == half):
        exact, mid = Decimal(tokens[i]), Decimal(float(half[i]))
        if exact != mid:   # on the midpoint the tie goes to even, as in near
            lo, hi = sorted((near[i], other[i]))
            near[i] = hi if exact > mid else lo
    return near


def _scan_plain(path: str):
    """The numpy version of `native.obj_scan` (`nrnative.cpp`
    `nr_obj_parse`) for a plain OBJ file: a record is keyed by its first
    two characters (`v `, `vt`, `vn`, `f `); a face must have exactly
    three corners; each coordinate is rounded once to float32.  Returns
    (positions (V, 3), uvs (T, 2), normals (N, 3) float32, and the (F, 3)
    int64 face position, uv and normal indices, 1-based as in the file,
    0 = absent), or None when the file has directives that need the line
    parser, no face, or a record that does not parse."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if _needs_line_parser(data):
        return None
    v, vt, vn, faces = [], [], [], []
    for line in data.decode("utf-8", errors="replace").splitlines():
        head = line[:2]
        if head == "v ":
            v.append(line[2:].split()[:3])
        elif head == "vt":
            vt.append(line[3:].split()[:2])
        elif head == "vn":
            vn.append(line[3:].split()[:3])
        elif head == "f ":
            corners = line[2:].split()
            if len(corners) != 3:
                return None
            faces.append(corners)
    if not faces:
        return None

    def floats(rows, n):
        if any(len(r) != n for r in rows):
            return None
        try:
            return _float32([x for r in rows for x in r]).reshape(-1, n)
        except ValueError:
            return None

    pos, uvs, nrm = floats(v, 3), floats(vt, 2), floats(vn, 3)
    if pos is None or uvs is None or nrm is None:
        return None
    fidx = np.zeros((len(faces), 3, 3), np.int64)
    try:
        for i, corners in enumerate(faces):
            for j, tok in enumerate(corners):
                parts = tok.split("/")
                fidx[i, j, 0] = int(parts[0])
                for k in (1, 2):
                    if len(parts) > k and parts[k]:
                        fidx[i, j, k] = int(parts[k])
    except ValueError:
        return None
    return pos, uvs, nrm, fidx[:, :, 0], fidx[:, :, 1], fidx[:, :, 2]


def scan_plain_file(path: str):
    """The records of a plain triangulated file (`_scan_plain`'s result),
    read by the host library, or by `_scan_plain` under NR_NO_NATIVE=1;
    None when the file needs the line parser."""
    if native.disabled():
        return _scan_plain(path)
    try:
        with open(path, "rb") as f:
            if _needs_line_parser(f.read()):
                return None
    except OSError:
        return None
    scanned = native.obj_scan(path)
    if scanned is None or scanned[3].shape[0] == 0:
        return None
    return scanned


def _load_obj_plain(path: str, scene: Scene,
                    material: Optional[int]) -> Optional[Scene]:
    """Plain triangulated files: one mesh over the file's whole `v` pool,
    the Scene of the JAX package's native route.  Returns None to fall
    back to the line parser."""
    scanned = scan_plain_file(path)
    if scanned is None:
        return None
    v, vt, vn, fv, ft, fn = scanned
    model = Model(name=os.path.splitext(os.path.basename(path))[0])
    model_idx = len(scene.models)
    scene.models.append(model)
    mesh = Mesh()
    # resolve 1-based (and negative = relative) indices
    nv = v.shape[0]
    mesh.positions = v
    mesh.position_indices = np.where(fv < 0, fv + nv, fv - 1).astype(
        np.int32).reshape(-1)
    if vn.shape[0] and (fn != 0).all():
        mesh.normals = vn
        mesh.normal_indices = np.where(fn < 0, fn + vn.shape[0],
                                       fn - 1).astype(np.int32).reshape(-1)
    if vt.shape[0] and (ft != 0).all():
        mesh.uvs = vt
        mesh.uv_indices = np.where(ft < 0, ft + vt.shape[0],
                                   ft - 1).astype(np.int32).reshape(-1)
    mesh.material = material if material is not None else -1
    node = Node(name="Undefined", type=NodeType.MESH,
                entity=len(scene.mesh_buffer), model=model_idx)
    model.nodes.append(len(scene.nodes))
    scene.nodes.append(node)
    scene.mesh_buffer.append(mesh)
    return scene


def load_obj(path: str, scene: Optional[Scene] = None,
             material: Optional[int] = None) -> Scene:
    """Import an OBJ file into `scene` (or a fresh Scene).

    `material`: optional material index to assign when the OBJ has no
    usemtl/mtllib (the reference leaves the mesh material handle invalid
    and the UI assigns one).

    Plain triangulated files take `_load_obj_plain`; files with materials
    or groups use the line parser below."""
    if scene is None:
        scene = Scene()
    plain = _load_obj_plain(path, scene, material)
    if plain is not None:
        return plain

    positions: List[List[float]] = []
    uvs: List[List[float]] = []
    normals: List[List[float]] = []
    mtl_map: Dict[str, int] = {}

    model = Model(name=os.path.splitext(os.path.basename(path))[0])
    model_idx = len(scene.models)
    scene.models.append(model)

    mesh: Optional[Mesh] = None
    # staging pools for the current mesh
    p_map: Dict[int, int] = {}
    t_map: Dict[int, int] = {}
    n_map: Dict[int, int] = {}
    pool_p: List[List[float]] = []
    pool_t: List[List[float]] = []
    pool_n: List[List[float]] = []
    idx_p: List[int] = []
    idx_t: List[int] = []
    idx_n: List[int] = []
    mesh_name = "Undefined"
    current_material = material if material is not None else -1

    def flush_mesh():
        nonlocal mesh
        if mesh is None:
            return
        mesh.positions = np.asarray(pool_p, np.float32).reshape(-1, 3)
        mesh.uvs = np.asarray(pool_t, np.float32).reshape(-1, 2)
        mesh.normals = np.asarray(pool_n, np.float32).reshape(-1, 3)
        mesh.position_indices = np.asarray(idx_p, np.int32)
        mesh.uv_indices = np.asarray(idx_t, np.int32)
        mesh.normal_indices = np.asarray(idx_n, np.int32)
        mesh.material = current_material
        mesh = None

    def start_mesh():
        nonlocal mesh
        p_map.clear(); t_map.clear(); n_map.clear()
        pool_p.clear(); pool_t.clear(); pool_n.clear()
        idx_p.clear(); idx_t.clear(); idx_n.clear()
        mesh = Mesh()
        node = Node(name=mesh_name, type=NodeType.MESH,
                    entity=len(scene.mesh_buffer), model=model_idx)
        model.nodes.append(len(scene.nodes))
        scene.nodes.append(node)
        scene.mesh_buffer.append(mesh)

    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            for line in f:
                parts = line.split()
                if not parts or parts[0].startswith("#"):
                    continue
                key = parts[0]
                if key == "v":
                    positions.append([float(x) for x in parts[1:4]])
                elif key == "vt":
                    uvs.append([float(x) for x in parts[1:3]])
                elif key == "vn":
                    normals.append([float(x) for x in parts[1:4]])
                elif key in ("o", "g"):
                    flush_mesh()
                    mesh_name = parts[1] if len(parts) > 1 else "Undefined"
                elif key == "mtllib" and len(parts) > 1:
                    _parse_mtl(scene, os.path.join(os.path.dirname(path),
                                                   parts[1]), mtl_map)
                elif key == "usemtl" and len(parts) > 1:
                    current_material = mtl_map.get(parts[1], current_material)
                elif key == "f":
                    if len(parts) != 4:
                        raise ObjParseError(
                            "Only Triangulated mesh is supported!")
                    if mesh is None:
                        start_mesh()
                    for tok in parts[1:4]:
                        v, t, n = _parse_face_vertex(tok)
                        if v != -1:
                            if v not in p_map:
                                p_map[v] = len(pool_p)
                                pool_p.append(positions[v - 1])
                            idx_p.append(p_map[v])
                        if t != -1:
                            if t not in t_map:
                                t_map[t] = len(pool_t)
                                pool_t.append(uvs[t - 1])
                            idx_t.append(t_map[t])
                        if n != -1:
                            if n not in n_map:
                                n_map[n] = len(pool_n)
                                pool_n.append(normals[n - 1])
                            idx_n.append(n_map[n])
    except OSError as exc:
        raise ObjParseError(f"File does not exist: {path}") from exc

    flush_mesh()
    return scene
