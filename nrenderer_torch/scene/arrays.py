"""SceneArrays: the flat SoA scene representation (host numpy).

The replacement for the reference's `Scene` of AoS C++ structs
(`code/include/scene/Scene.hpp:40-66`): every entity buffer becomes a padded
SoA numpy array.  A copy of `nrenderer_tpu/scene/arrays.py` without its JAX
import; the renderers turn these arrays into the `StaticScene` tables their
kernels read.  Host-side precomputation folds in:

  - VertexTransformer's model-transform bake (`ray_cast/src/VertexTransformer.cpp:6-27`
    translates; we additionally honor `Model.scale`, which the reference
    ignores for .scn entities and hard-codes for the bunny meshes in
    `acc_path_tracing/src/VertexTransformer.cpp:25-51`)
  - mesh -> triangle expansion with recomputed face normals
    (`simple_path_tracing/src/SimplePathTracer.cpp:57-78`)
  - per-plane inverse parallelogram matrices (the reference inverts
    `Mat3x3{u, v, cross(u,v)}` per ray in `intersections.cpp:68-70`; it is
    ray-independent, so we precompute it once)
  - the dense material-parameter table replacing per-material shader objects
    (`ShaderCreator.hpp` hierarchies -> branchless shading)

All buffers are padded to at least one (degenerate, masked-out) entry so that
shapes are static and reductions never see empty axes.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np

from .model import (
    Ambient, AmbientType, Camera, NodeType, PropertyType, RenderOption, Scene,
)

# Material parameter table layout (columns of `mat_params`).
MAT_DIFFUSE = slice(0, 3)        # diffuseColor   (Lambertian/Phong), default 1,1,1
MAT_SPECULAR = slice(3, 6)       # specularColor  (Phong), default 1,1,1
MAT_SPECULAR_EX = 6              # specularEx     (Phong), default 1
MAT_IOR = 7                      # ior            (Glass), default 1.5
MAT_ABSORBED = slice(8, 11)      # absorbed       (Glass), default 1,1,1
MAT_ETA_R = slice(11, 14)        # eta_r          (Conductor), default 0,0,0
MAT_ETA_I = slice(14, 17)        # eta_i          (Conductor), default 0,0,0
MAT_ALBEDO = slice(17, 20)       # albedo         (Conductor/Microfacet), default 1,1,1
MAT_ROUGHNESS = 20               # roughness      (Microfacet), default 0.2
MAT_F0 = 21                      # F0             (Microfacet), default 0.04
MAT_METALNESS = 22               # metalness      (Microfacet), reference file-const 0.2
MAT_DIFFUSE_MAP = 23             # diffuseMap texture id, -1 = none
MAT_SPECULAR_MAP = 24            # specularMap (map_Ks) texture id, -1 = none
MAT_BUMP_MAP = 25                # bumpMap (map_bump) texture id, -1 = none
MAT_NPARAMS = 26


class SceneArrays(NamedTuple):
    """Frozen SoA scene. Leading-dim sizes are static per scene.

    Fields are HOST numpy arrays: they are consumed by host-side prep
    (`ops.intersect.make_static_scene`), which builds the device tables."""
    # spheres
    sph_pos: np.ndarray        # (S, 3)
    sph_radius: np.ndarray     # (S,)
    sph_mat: np.ndarray        # (S,) int32
    sph_valid: np.ndarray      # (S,) bool
    # triangles (incl. mesh-expanded)
    tri_v1: np.ndarray         # (T, 3)
    tri_e1: np.ndarray         # (T, 3)  v2 - v1
    tri_e2: np.ndarray         # (T, 3)  v3 - v1
    tri_normal: np.ndarray     # (T, 3)  stored normal (NOT renormalized)
    tri_mat: np.ndarray        # (T,) int32
    tri_valid: np.ndarray      # (T,) bool
    # per-triangle texture coordinates (mesh-flattened; zeros + tex=-1 when
    # the face has no UVs or its material has no diffuseMap).  The reference
    # imports UVs and plumbs textures into its shaders but never samples
    # them (`Shader.hpp:22`, SURVEY.md) — the rebuild completes the path.
    tri_uv1: np.ndarray        # (T, 2)  uv at v1
    tri_uve1: np.ndarray       # (T, 2)  uv(v2) - uv(v1)
    tri_uve2: np.ndarray       # (T, 2)  uv(v3) - uv(v1)
    tri_tex: np.ndarray        # (T,) int32 diffuseMap texture id, -1 = none
    tri_stex: np.ndarray       # (T,) int32 specularMap texture id, -1 = none
    # planes (parallelogram patches)
    pln_pos: np.ndarray        # (P, 3)
    pln_normal: np.ndarray     # (P, 3)
    pln_inv: np.ndarray        # (P, 3, 3) inverse of columns [u, v, u x v]
    pln_mat: np.ndarray        # (P,) int32
    pln_valid: np.ndarray      # (P,) bool
    # area lights
    al_pos: np.ndarray         # (A, 3)
    al_u: np.ndarray           # (A, 3)
    al_v: np.ndarray           # (A, 3)
    al_normal: np.ndarray      # (A, 3) = cross(u, v), unnormalized
    al_inv: np.ndarray         # (A, 3, 3)
    al_radiance: np.ndarray    # (A, 3)
    al_valid: np.ndarray       # (A,) bool
    # point / directional / spot lights
    pl_pos: np.ndarray         # (L, 3)
    pl_intensity: np.ndarray   # (L, 3)
    pl_valid: np.ndarray       # (L,) bool
    dl_dir: np.ndarray         # (D, 3)
    dl_irradiance: np.ndarray  # (D, 3)
    dl_valid: np.ndarray       # (D,) bool
    sl_pos: np.ndarray         # (Q, 3)
    sl_dir: np.ndarray         # (Q, 3)
    sl_intensity: np.ndarray   # (Q, 3)
    sl_cone: np.ndarray        # (Q, 2)  hotSpot, fallout
    sl_valid: np.ndarray       # (Q,) bool
    # materials
    mat_type: np.ndarray       # (M,) int32
    mat_params: np.ndarray     # (M, MAT_NPARAMS) float32
    # ambient
    ambient_type: np.ndarray   # () int32: 0 constant, 1 env map
    ambient_constant: np.ndarray  # (3,)
    env_map: np.ndarray        # (He, We, 3) float32; (1,1,3) black if none
    # scene textures as a static-length tuple of (H, W, 3) float32 arrays
    # ((1, 1, 3) placeholder for slots with no pixel data)
    textures: tuple


def _vec(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float64)


def _pad_rows(arr: np.ndarray, min_rows: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a (N, ...) array to at least min_rows rows; return (padded, valid)."""
    n = arr.shape[0]
    valid = np.ones((max(n, min_rows),), dtype=bool)
    if n >= min_rows:
        return arr, valid
    pad_shape = (min_rows - n,) + arr.shape[1:]
    valid[n:] = False
    return np.concatenate([arr, np.zeros(pad_shape, arr.dtype)], axis=0), valid


def _safe_inv_columns(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Inverse of the 3x3 matrix with columns [u, v, u x v]; identity if
    singular (the entry is masked out anyway)."""
    w = np.cross(u, v)
    m = np.stack([u, v, w], axis=-1)  # columns
    try:
        inv = np.linalg.inv(m)
    except np.linalg.LinAlgError:
        return np.eye(3)
    # snap numerical dust to exact zero so the unrolled kernels can
    # trace-time-fold the term away (axis-aligned patches -> 1 multiply)
    scale = np.abs(inv).max() or 1.0
    inv[np.abs(inv) < 1e-12 * scale] = 0.0
    return inv


def _pack_material(mat, textures=(),
                   overrides=None) -> Tuple[int, np.ndarray]:
    """`overrides`: the RenderOption's global roughness/f0/metalness knobs
    (None fields = unset).  The reference surfaces these as UI-global
    RenderSettings (`RenderSettingsManager.hpp:9-29`) that its shipped
    shaders never read; here a SET knob overrides the per-material value
    (tested in test_builder.py) so the config surface is live, and an unset
    knob preserves the reference shader constants (Microfacet.cpp:10-12)."""
    p = np.zeros((MAT_NPARAMS,), dtype=np.float64)
    p[MAT_DIFFUSE] = _vec(mat.get_property("diffuseColor", PropertyType.RGB)
                          or (1.0, 1.0, 1.0))
    p[MAT_SPECULAR] = _vec(mat.get_property("specularColor", PropertyType.RGB)
                           or (1.0, 1.0, 1.0))
    spec_ex = mat.get_property("specularEx", PropertyType.FLOAT)
    p[MAT_SPECULAR_EX] = 1.0 if spec_ex is None else spec_ex
    # `ior` (Dielectric template); `refractIndex` is the Plastic template's
    # name for the same quantity (`MaterialTemplates.hpp:62-65`)
    ior = (mat.get_property("ior", PropertyType.FLOAT)
           if mat.get_property("ior", PropertyType.FLOAT) is not None
           else mat.get_property("refractIndex", PropertyType.FLOAT))
    p[MAT_IOR] = 1.5 if ior is None else ior
    p[MAT_ABSORBED] = _vec(mat.get_property("absorbed", PropertyType.RGB)
                           or (1.0, 1.0, 1.0))
    p[MAT_ETA_R] = _vec(mat.get_property("eta_r", PropertyType.VEC3)
                        or (0.0, 0.0, 0.0))
    p[MAT_ETA_I] = _vec(mat.get_property("eta_i", PropertyType.VEC3)
                        or (0.0, 0.0, 0.0))
    # Conductor/Microfacet albedo; `reflect` (conductors.scn) is accepted as an
    # alias since the stock scene stores tint there.
    albedo = (mat.get_property("albedo", PropertyType.RGB)
              or mat.get_property("reflect", PropertyType.RGB)
              or (1.0, 1.0, 1.0))
    # Plastic (type 4, `MaterialTemplates.hpp:62-65`) carries its
    # specularColor in the albedo slots: albedo is only read by the
    # conductor/microfacet lobes (types 1/3) and a material has one type,
    # so type 4 reuses the channels instead of widening every hit carry
    if mat.type == 4 and mat.get_property("albedo", PropertyType.RGB) is None:
        albedo = (mat.get_property("specularColor", PropertyType.RGB)
                  or (1.0, 1.0, 1.0))
    p[MAT_ALBEDO] = _vec(albedo)
    rough = mat.get_property("roughness", PropertyType.FLOAT)
    p[MAT_ROUGHNESS] = 0.2 if rough is None else rough
    f0 = mat.get_property("F0", PropertyType.FLOAT)
    p[MAT_F0] = 0.04 if f0 is None else f0
    metal = mat.get_property("metalness", PropertyType.FLOAT)
    p[MAT_METALNESS] = 0.2 if metal is None else metal  # acc Microfacet.cpp:11
    if overrides is not None:
        if overrides.roughness is not None:
            p[MAT_ROUGHNESS] = overrides.roughness
        if overrides.f0 is not None:
            p[MAT_F0] = overrides.f0
        if overrides.metalness is not None:
            p[MAT_METALNESS] = overrides.metalness

    def tex_id(prop_name: str) -> float:
        tid = mat.get_property(prop_name, PropertyType.TEXTURE_ID)
        if (tid is None or not (0 <= int(tid) < len(textures))
                or textures[int(tid)].pixels is None):
            return -1.0
        return float(int(tid))

    p[MAT_DIFFUSE_MAP] = tex_id("diffuseMap")
    p[MAT_SPECULAR_MAP] = tex_id("specularMap")
    p[MAT_BUMP_MAP] = tex_id("bumpMap")
    return mat.type, p


def build_scene_arrays(scene: Scene, dtype=np.float32) -> SceneArrays:
    """Flatten an editable Scene into host SceneArrays."""
    models = scene.models

    def transform_point(pt, model_idx: int) -> np.ndarray:
        pt = _vec(pt)
        if model_idx < 0 or model_idx >= len(models):
            return pt
        m = models[model_idx]
        return pt * _vec(m.scale) + _vec(m.translation)

    def scale_of(model_idx: int) -> np.ndarray:
        if model_idx < 0 or model_idx >= len(models):
            return np.ones(3)
        return _vec(models[model_idx].scale)

    sph_pos, sph_rad, sph_mat = [], [], []
    tri_v1, tri_v2, tri_v3, tri_n, tri_mat = [], [], [], [], []
    tri_uv1, tri_uve1, tri_uve2, tri_tex, tri_stex = [], [], [], [], []
    pln_pos, pln_n, pln_u, pln_v, pln_mat = [], [], [], [], []

    def _mat_tex(mat_idx: int, prop_name: str = "diffuseMap") -> int:
        """Texture id of `prop_name` on material `mat_idx`, -1 if unusable."""
        if not (0 <= mat_idx < len(scene.materials)):
            return -1
        tid = scene.materials[mat_idx].get_property(
            prop_name, PropertyType.TEXTURE_ID)
        if tid is None or not (0 <= int(tid) < len(scene.textures)):
            return -1
        if scene.textures[int(tid)].pixels is None:
            return -1
        return int(tid)

    def _no_uv(count: int = 1):
        tri_uv1.extend([np.zeros(2)] * count)
        tri_uve1.extend([np.zeros(2)] * count)
        tri_uve2.extend([np.zeros(2)] * count)
        tri_tex.extend([-1] * count)
        tri_stex.extend([-1] * count)

    for node in scene.nodes:
        if node.type == NodeType.SPHERE:
            s = scene.sphere_buffer[node.entity]
            sph_pos.append(transform_point(s.position, node.model))
            sph_rad.append(float(s.radius) * float(scale_of(node.model)[0]))
            sph_mat.append(s.material)
        elif node.type == NodeType.TRIANGLE:
            t = scene.triangle_buffer[node.entity]
            tri_v1.append(transform_point(t.v1, node.model))
            tri_v2.append(transform_point(t.v2, node.model))
            tri_v3.append(transform_point(t.v3, node.model))
            tri_n.append(_vec(t.normal) if t.normal is not None
                         else t.computed_normal())
            tri_mat.append(t.material)
            _no_uv()
        elif node.type == NodeType.PLANE:
            p = scene.plane_buffer[node.entity]
            pln_pos.append(transform_point(p.position, node.model))
            sc = scale_of(node.model)
            pln_u.append(_vec(p.u) * sc)
            pln_v.append(_vec(p.v) * sc)
            pln_n.append(_vec(p.normal))
            pln_mat.append(p.material)
        elif node.type == NodeType.MESH:
            # mesh -> triangle expansion with recomputed face normals
            # (`SimplePathTracer.cpp:57-78`), with the model transform applied
            # as scene config rather than acc's hard-coded bunny constants.
            mesh = scene.mesh_buffer[node.entity]
            pos = np.asarray(mesh.positions, dtype=np.float64)
            pos = pos * scale_of(node.model) + _vec(
                models[node.model].translation if 0 <= node.model < len(models)
                else (0.0, 0.0, 0.0))
            idx = np.asarray(mesh.position_indices, dtype=np.int64).reshape(-1, 3)
            v1, v2, v3 = pos[idx[:, 0]], pos[idx[:, 1]], pos[idx[:, 2]]
            n = np.cross(v2 - v1, v3 - v1)
            norm = np.linalg.norm(n, axis=-1, keepdims=True)
            n = n / np.where(norm > 0, norm, 1.0)
            tri_v1.extend(v1); tri_v2.extend(v2); tri_v3.extend(v3)
            tri_n.extend(n)
            tri_mat.extend([mesh.material] * idx.shape[0])
            tex_id = _mat_tex(mesh.material)
            stex_id = _mat_tex(mesh.material, "specularMap")
            uvs = np.asarray(mesh.uvs, np.float64).reshape(-1, 2)
            uvi = np.asarray(mesh.uv_indices, np.int64).reshape(-1)
            if ((tex_id >= 0 or stex_id >= 0) and uvs.shape[0]
                    and uvi.shape[0] == idx.size):
                uvi = uvi.reshape(-1, 3)
                u1 = uvs[uvi[:, 0]]
                tri_uv1.extend(u1)
                tri_uve1.extend(uvs[uvi[:, 1]] - u1)
                tri_uve2.extend(uvs[uvi[:, 2]] - u1)
                tri_tex.extend([tex_id] * idx.shape[0])
                tri_stex.extend([stex_id] * idx.shape[0])
            else:
                _no_uv(idx.shape[0])

    def rows(lst, width=3):
        if not lst:
            return np.zeros((0, width), dtype=np.float64)
        return np.stack([np.asarray(x, dtype=np.float64) for x in lst])

    sph_pos_a, sph_valid = _pad_rows(rows(sph_pos))
    sph_rad_a, _ = _pad_rows(np.asarray(sph_rad, np.float64).reshape(-1))
    sph_mat_a, _ = _pad_rows(np.asarray(sph_mat, np.int32).reshape(-1))

    tri_v1_a, tri_valid = _pad_rows(rows(tri_v1))
    tri_v2_a, _ = _pad_rows(rows(tri_v2))
    tri_v3_a, _ = _pad_rows(rows(tri_v3))
    tri_n_a, _ = _pad_rows(rows(tri_n))
    tri_mat_a, _ = _pad_rows(np.asarray(tri_mat, np.int32).reshape(-1))
    tri_uv1_a, _ = _pad_rows(rows(tri_uv1, width=2))
    tri_uve1_a, _ = _pad_rows(rows(tri_uve1, width=2))
    tri_uve2_a, _ = _pad_rows(rows(tri_uve2, width=2))
    tri_tex_a, _ = _pad_rows(np.asarray(tri_tex, np.int32).reshape(-1))
    if tri_tex_a.shape[0] > len(tri_tex):  # padded rows have no texture
        tri_tex_a = tri_tex_a.copy()
        tri_tex_a[len(tri_tex):] = -1
    tri_stex_a, _ = _pad_rows(np.asarray(tri_stex, np.int32).reshape(-1))
    if tri_stex_a.shape[0] > len(tri_stex):
        tri_stex_a = tri_stex_a.copy()
        tri_stex_a[len(tri_stex):] = -1

    pln_pos_a, pln_valid = _pad_rows(rows(pln_pos))
    pln_n_a, _ = _pad_rows(rows(pln_n))
    pln_u_a, _ = _pad_rows(rows(pln_u))
    pln_v_a, _ = _pad_rows(rows(pln_v))
    pln_mat_a, _ = _pad_rows(np.asarray(pln_mat, np.int32).reshape(-1))
    pln_inv = np.stack([_safe_inv_columns(u, v)
                        for u, v in zip(pln_u_a, pln_v_a)]) \
        if pln_u_a.shape[0] else np.zeros((0, 3, 3))

    # area lights
    al = scene.area_light_buffer
    al_pos_a, al_valid = _pad_rows(rows([a.position for a in al]))
    al_u_a, _ = _pad_rows(rows([a.u for a in al]))
    al_v_a, _ = _pad_rows(rows([a.v for a in al]))
    al_rad_a, _ = _pad_rows(rows([a.radiance for a in al]))
    al_n = np.cross(al_u_a, al_v_a)
    al_inv = np.stack([_safe_inv_columns(u, v)
                       for u, v in zip(al_u_a, al_v_a)])

    pl = scene.point_light_buffer
    pl_pos_a, pl_valid = _pad_rows(rows([p.position for p in pl]))
    pl_int_a, _ = _pad_rows(rows([p.intensity for p in pl]))

    dl = scene.directional_light_buffer
    dl_dir_a, dl_valid = _pad_rows(rows([d.direction for d in dl]))
    dl_irr_a, _ = _pad_rows(rows([d.irradiance for d in dl]))

    sl = scene.spot_light_buffer
    sl_pos_a, sl_valid = _pad_rows(rows([s.position for s in sl]))
    sl_dir_a, _ = _pad_rows(rows([s.direction for s in sl]))
    sl_int_a, _ = _pad_rows(rows([s.intensity for s in sl]))
    sl_cone_a, _ = _pad_rows(rows([(s.hot_spot, s.fallout) for s in sl],
                                  width=2))

    # materials
    if scene.materials:
        packed = [_pack_material(m, scene.textures, scene.render_option)
                  for m in scene.materials]
        mat_type = np.asarray([t for t, _ in packed], np.int32)
        mat_params = np.stack([p for _, p in packed])
    else:
        mat_type = np.zeros((1,), np.int32)
        mat_params = np.zeros((1, MAT_NPARAMS))
        mat_params[0, MAT_DIFFUSE] = 1.0
        mat_params[0, MAT_DIFFUSE_MAP] = -1.0
        mat_params[0, MAT_SPECULAR_MAP] = -1.0
        mat_params[0, MAT_BUMP_MAP] = -1.0

    # ambient / environment map
    amb = scene.ambient
    if (amb.type == AmbientType.ENVIRONMENT_MAP
            and 0 <= amb.environment_map < len(scene.textures)
            and scene.textures[amb.environment_map].pixels is not None):
        env = np.asarray(scene.textures[amb.environment_map].pixels,
                         np.float64)[:, :, :3]
        amb_type = 1
    else:
        env = np.zeros((1, 1, 3))
        amb_type = 0 if amb.type == AmbientType.CONSTANT else 1

    textures = tuple(
        np.asarray(t.pixels, np.float64)[:, :, :3] if t.pixels is not None
        else np.zeros((1, 1, 3)) for t in scene.textures)

    # SceneArrays stays on the host (numpy); the renderers upload what
    # their kernels read.
    f = lambda x: np.ascontiguousarray(np.asarray(x, dtype=np.dtype(dtype)))
    i32 = lambda x: np.ascontiguousarray(np.asarray(x, dtype=np.int32))
    b = lambda x: np.ascontiguousarray(np.asarray(x, dtype=np.bool_))

    return SceneArrays(
        sph_pos=f(sph_pos_a), sph_radius=f(sph_rad_a),
        sph_mat=i32(sph_mat_a), sph_valid=b(sph_valid),
        tri_v1=f(tri_v1_a), tri_e1=f(tri_v2_a - tri_v1_a),
        tri_e2=f(tri_v3_a - tri_v1_a), tri_normal=f(tri_n_a),
        tri_mat=i32(tri_mat_a), tri_valid=b(tri_valid),
        tri_uv1=f(tri_uv1_a), tri_uve1=f(tri_uve1_a),
        tri_uve2=f(tri_uve2_a), tri_tex=i32(tri_tex_a),
        tri_stex=i32(tri_stex_a),
        pln_pos=f(pln_pos_a), pln_normal=f(pln_n_a), pln_inv=f(pln_inv),
        pln_mat=i32(pln_mat_a), pln_valid=b(pln_valid),
        al_pos=f(al_pos_a), al_u=f(al_u_a), al_v=f(al_v_a),
        al_normal=f(al_n), al_inv=f(al_inv), al_radiance=f(al_rad_a),
        al_valid=b(al_valid),
        pl_pos=f(pl_pos_a), pl_intensity=f(pl_int_a), pl_valid=b(pl_valid),
        dl_dir=f(dl_dir_a), dl_irradiance=f(dl_irr_a), dl_valid=b(dl_valid),
        sl_pos=f(sl_pos_a), sl_dir=f(sl_dir_a), sl_intensity=f(sl_int_a),
        sl_cone=f(sl_cone_a), sl_valid=b(sl_valid),
        mat_type=i32(mat_type), mat_params=f(mat_params),
        ambient_type=i32(amb_type), ambient_constant=f(_vec(amb.constant)),
        env_map=f(env),
        textures=tuple(f(t) for t in textures),
    )
