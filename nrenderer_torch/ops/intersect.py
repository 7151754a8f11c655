"""Ray-primitive intersection over an unrolled static scene, on torch tensors.

Counterpart of the dense path of `nrenderer_tpu/ops/intersect.py`
(`StaticScene`, `make_static_scene`, `intersect_scene_unrolled`,
`intersect_area_lights_unrolled`), which ports the reference's PT
intersection routines (`simple_path_tracing/src/intersections/intersections.cpp:1-95`):

  - triangle: Möller-Trumbore with det-sign folding, parallel reject at
    det < 1e-6, `t >= tMin` acceptance, stored (unnormalized) normal returned
  - sphere: both quadratic roots tried in order, normal = (p-c)/r
  - plane: parallelogram patch via the precomputed inverse of [u, v, u x v],
    near-parallel reject at (nd < 1e-7) & (nd > -1e-8)
  - area light: the plane test on (position, u, v) with normal cross(u, v)

The primitive loop runs in Python over the host-side `StaticScene`, with
each primitive's constants as Python floats and zero terms dropped before
any tensor op (`_lin3`, `_dota`), in the same order as the JAX module: the
float32 results are the ones the JAX functions compute.  This is the plain
torch form; the CUDA kernel (`ops/pt_cuda.py`) evaluates the same tests per
thread from a packed table.

The SoA form (`SceneSoA`, `make_scene_soa`, `intersect_scene`,
`intersect_area_lights`) is the JAX module's other path, which RayCast and
GeometryPreview run: every primitive of a type against every ray as one
(P, N) matrix, then the first minimum along P.  XLA fuses those matrices
away; eager torch materialises each one, so both functions split the ray
batch into chunks whose (P, chunk) float32 planes stay under
`SOA_PLANE_BYTES` (rays are independent: chunking changes no result).
The winner's attributes are read by its index instead of the JAX module's
one-hot products, which select the same values."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..scene.arrays import (
    MAT_ABSORBED, MAT_ALBEDO, MAT_DIFFUSE, MAT_ETA_I, MAT_ETA_R, MAT_F0,
    MAT_IOR, MAT_METALNESS, MAT_ROUGHNESS, MAT_SPECULAR, MAT_SPECULAR_EX,
    MAT_SPECULAR_MAP, SceneArrays,
)
from .soa import V3, cross3, dot3, splat, where3

T_MIN_PT = 1e-6       # PT epsilon (`SimplePathTracer.cpp:108`)
T_MIN_RAYCAST = 0.01  # ray_cast epsilon (`RayCastRenderer.cpp:70`)
# The SoA intersect's ray chunk: one (P, chunk) float32 plane of at most
# this many bytes (the triangle test holds about a dozen such planes).
SOA_PLANE_BYTES = 1 << 27


class StaticScene(NamedTuple):
    """Host-side (numpy) scene view: the primitive lists the renderers
    unroll (plain form) or pack into a device table (kernel)."""
    sph: list    # (cx, cy, cz, r, mat)
    tri: list    # (v1, e1, e2, n, mat) tuples of np arrays
    pln: list    # (pos, n, inv0, inv1, mat)
    al: list     # (pos, n, inv0, inv1, radiance)
    mats: list   # per-material dict of params (numpy)
    ambient_type: int
    ambient_constant: tuple
    n_mats: int
    # per-tri texture coords, parallel to `tri`: (u1x, u1y, e1x, e1y,
    # e2x, e2y, tex_id, stex_id) plain-float tuples; () when the scene has
    # no textured faces
    tri_uv: tuple = ()


def make_static_scene(scene_arrays: SceneArrays) -> StaticScene:
    a = scene_arrays
    f = lambda x: np.asarray(x)
    sph = [(float(p[0]), float(p[1]), float(p[2]), float(r), int(m))
           for p, r, m, v in zip(f(a.sph_pos), f(a.sph_radius), f(a.sph_mat),
                                 f(a.sph_valid)) if v]
    tri = [(f(v1), f(e1), f(e2), f(n), int(m))
           for v1, e1, e2, n, m, v in zip(f(a.tri_v1), f(a.tri_e1),
                                          f(a.tri_e2), f(a.tri_normal),
                                          f(a.tri_mat), f(a.tri_valid)) if v]
    pln = [(f(p), f(n), f(i)[0], f(i)[1], int(m))
           for p, n, i, m, v in zip(f(a.pln_pos), f(a.pln_normal),
                                    f(a.pln_inv), f(a.pln_mat),
                                    f(a.pln_valid)) if v]
    al = [(f(p), f(n), f(i)[0], f(i)[1], f(r))
          for p, n, i, r, v in zip(f(a.al_pos), f(a.al_normal), f(a.al_inv),
                                   f(a.al_radiance), f(a.al_valid)) if v]
    mats = []
    mp = f(a.mat_params)
    for mi in range(mp.shape[0]):
        mats.append({
            "type": int(f(a.mat_type)[mi]),
            "diffuse": mp[mi, MAT_DIFFUSE],
            "specular": mp[mi, MAT_SPECULAR],
            "specular_ex": float(mp[mi, MAT_SPECULAR_EX]),
            "ior": float(mp[mi, MAT_IOR]),
            "absorbed": mp[mi, MAT_ABSORBED],
            "eta_r": mp[mi, MAT_ETA_R],
            "eta_i": mp[mi, MAT_ETA_I],
            "albedo": mp[mi, MAT_ALBEDO],
            "roughness": float(mp[mi, MAT_ROUGHNESS]),
            "f0": float(mp[mi, MAT_F0]),
            "metalness": float(mp[mi, MAT_METALNESS]),
            "stex": (float(mp[mi, MAT_SPECULAR_MAP])
                     if mp.shape[1] > MAT_SPECULAR_MAP else -1.0),
        })
    tri_uv = ()
    valid = f(a.tri_valid)
    if np.any((f(a.tri_tex)[valid] >= 0) | (f(a.tri_stex)[valid] >= 0)):
        tri_uv = tuple(
            (float(u1[0]), float(u1[1]), float(e1[0]), float(e1[1]),
             float(e2[0]), float(e2[1]), int(tx), int(sx))
            for u1, e1, e2, tx, sx, v in zip(f(a.tri_uv1), f(a.tri_uve1),
                                             f(a.tri_uve2), f(a.tri_tex),
                                             f(a.tri_stex), valid) if v)
    return StaticScene(sph=sph, tri=tri, pln=pln, al=al, mats=mats,
                       ambient_type=int(np.asarray(a.ambient_type).reshape(())),
                       ambient_constant=tuple(f(a.ambient_constant)),
                       n_mats=mp.shape[0], tri_uv=tri_uv)


def _is_zero(v) -> bool:
    return isinstance(v, (int, float)) and float(v) == 0.0


def _lin3(c, x, y, z):
    """c[0]*x + c[1]*y + c[2]*z for Python-float `c`, with zero terms
    dropped and unit factors skipped before any tensor op (the JAX module's
    trace-time fold, kept so the float32 results match).  Operands may be
    literal 0.0 from an earlier fold."""
    terms = []
    for cc, v in ((float(c[0]), x), (float(c[1]), y), (float(c[2]), z)):
        if cc == 0.0 or _is_zero(v):
            continue
        terms.append(v if cc == 1.0 else cc * v)
    if not terms:
        return 0.0
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _dota(pairs):
    """Sum of a*b products with literal-zero operands folded away."""
    terms = [a * b for a, b in pairs if not (_is_zero(a) or _is_zero(b))]
    if not terms:
        return 0.0
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def _full(v, like: torch.Tensor) -> torch.Tensor:
    """A folded-away literal as a tensor shaped like the rays."""
    if isinstance(v, torch.Tensor):
        return v
    return torch.full_like(like, float(v))


class HitUnrolled(NamedTuple):
    t: torch.Tensor       # (N,), +inf on miss
    valid: torch.Tensor   # (N,) bool
    point: V3
    normal: V3
    mat_id: torch.Tensor  # (N,) float material id of the hit (0 if miss)
    prim_id: torch.Tensor  # (N,) float primitive id (enumeration order:
    #                        spheres, triangles, planes; -1 if miss)
    channels: tuple       # per-ray tracked material constants ((N,) each)
    uv: tuple = None      # (tu, tv, tex_id) per ray, only with `with_uv`


def intersect_scene_unrolled(ss: StaticScene, o: V3, d: V3,
                             t_min: float = T_MIN_PT,
                             mat_channels=None,
                             with_uv: bool = False) -> HitUnrolled:
    """Closest hit with the primitive loop unrolled in Python.

    Running per-ray state: best t, best normal, and the material constants
    the caller needs: `mat_channels` is a list over materials of k-tuples
    (e.g. the albedo rgb), updated with each closer prim's constants.
    `with_uv`: also the hit's (u, v, texture id), interpolated from the
    winning triangle's UVs when it has a map, else (0, 0, -1)."""
    inf = float("inf")
    k = len(mat_channels[0]) if mat_channels else 0
    t_best = torch.full_like(o.x, inf)
    nx = torch.zeros_like(o.x)
    ny = torch.zeros_like(o.x)
    nz = torch.zeros_like(o.x)
    mid = torch.zeros_like(o.x)  # material id as float
    pid_best = torch.full_like(o.x, -1.0)  # primitive id as float
    chans = tuple(torch.zeros_like(o.x) for _ in range(k))
    uv_state = (torch.zeros_like(o.x), torch.zeros_like(o.x),
                torch.full_like(o.x, -1.0)) if with_uv else None
    prim_counter = [0]

    def upd(hit_mask, t, nxx, nyy, nzz, m, state, uv_vals=None):
        t_best, nx, ny, nz, mid, pid_best, chans, uv_state = state
        pid = prim_counter[0]
        prim_counter[0] += 1
        closer = hit_mask & (t < t_best)
        new_chans = tuple(
            torch.where(closer, float(mat_channels[m][i]), chans[i])
            for i in range(k))
        if uv_state is not None:
            if uv_vals is None:
                uv_vals = (0.0, 0.0, -1.0)
            uv_state = tuple(torch.where(closer, v, s)
                             for v, s in zip(uv_vals, uv_state))
        return (torch.where(closer, t, t_best), torch.where(closer, nxx, nx),
                torch.where(closer, nyy, ny), torch.where(closer, nzz, nz),
                torch.where(closer, float(m), mid),
                torch.where(closer, float(pid), pid_best), new_chans,
                uv_state)

    state = (t_best, nx, ny, nz, mid, pid_best, chans, uv_state)

    for (cx, cy, cz, r, m) in ss.sph:
        ocx, ocy, ocz = o.x - cx, o.y - cy, o.z - cz
        b = ocx * d.x + ocy * d.y + ocz * d.z
        c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        a = dot3(d, d)
        disc = b * b - a * c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        inv_a = 1.0 / a
        t1 = (-b - sq) * inv_a
        t2 = (-b + sq) * inv_a
        ok = disc > 0
        t = torch.where(ok & (t1 >= t_min), t1,
                        torch.where(ok & (t2 >= t_min), t2, inf))
        inv_r = 1.0 / r
        px = o.x + t * d.x
        py = o.y + t * d.y
        pz = o.z + t * d.z
        state = upd(torch.isfinite(t), t, (px - cx) * inv_r,
                    (py - cy) * inv_r, (pz - cz) * inv_r, m, state)

    for ti, (v1, e1, e2, nrm, m) in enumerate(ss.tri):
        # P = d x e2 (e2 constant -> linear in d; zero terms folded)
        px = _lin3((0.0, e2[2], -e2[1]), d.x, d.y, d.z)
        py = _lin3((-e2[2], 0.0, e2[0]), d.x, d.y, d.z)
        pz = _lin3((e2[1], -e2[0], 0.0), d.x, d.y, d.z)
        det0 = _full(_lin3(e1, px, py, pz), o.x)
        sign = torch.where(det0 > 0, 1.0, -1.0)
        det = det0 * sign
        tx = (o.x - v1[0]) * sign
        ty = (o.y - v1[1]) * sign
        tz = (o.z - v1[2]) * sign
        u = _full(_dota([(tx, px), (ty, py), (tz, pz)]), o.x)
        qx = _lin3((0.0, e1[2], -e1[1]), tx, ty, tz)
        qy = _lin3((-e1[2], 0.0, e1[0]), tx, ty, tz)
        qz = _lin3((e1[1], -e1[0], 0.0), tx, ty, tz)
        v = _full(_dota([(d.x, qx), (d.y, qy), (d.z, qz)]), o.x)
        w = _lin3(e2, qx, qy, qz) / torch.where(det == 0, 1.0, det)
        ok = ((det >= 1e-6) & (u >= 0) & (u <= det) & (v >= 0)
              & (u + v <= det) & (w >= t_min))
        uv_vals = None
        if with_uv and ti < len(ss.tri_uv) and (
                ss.tri_uv[ti][6] >= 0 or ss.tri_uv[ti][7] >= 0):
            u1x, u1y, ue1x, ue1y, ue2x, ue2y, tex = ss.tri_uv[ti][:7]
            inv_det = 1.0 / torch.where(det == 0, 1.0, det)
            b1 = u * inv_det
            b2 = v * inv_det
            uv_vals = (_full(u1x + _dota([(b1, ue1x), (b2, ue2x)]), o.x),
                       _full(u1y + _dota([(b1, ue1y), (b2, ue2y)]), o.x),
                       float(tex))
        state = upd(ok, torch.where(ok, w, inf), float(nrm[0]),
                    float(nrm[1]), float(nrm[2]), m, state, uv_vals=uv_vals)

    for (pos, nrm, inv0, inv1, m) in ss.pln:
        ok, t = _patch_hit(pos, nrm, inv0, inv1, o, d, t_min)
        state = upd(ok, torch.where(ok, t, inf), float(nrm[0]),
                    float(nrm[1]), float(nrm[2]), m, state)

    t_best, nx, ny, nz, mid, pid_best, chans, uv_state = state
    valid = torch.isfinite(t_best)
    # fold miss t=inf to the origin so masked shading never computes
    # 0 * inf = NaN
    t_pt = torch.where(valid, t_best, 0.0)
    point = V3(o.x + t_pt * d.x, o.y + t_pt * d.y, o.z + t_pt * d.z)
    return HitUnrolled(t=t_best, valid=valid, point=point,
                       normal=V3(nx, ny, nz), mat_id=mid, prim_id=pid_best,
                       channels=chans, uv=uv_state)


def _patch_hit(pos, nrm, inv0, inv1, o: V3, d: V3, t_min: float):
    """Parallelogram test shared by planes and area lights: (ok, t)."""
    nd = _full(_lin3(nrm, d.x, d.y, d.z), o.x)
    parallel = (nd < 1e-7) & (nd > -1e-8)
    dp = float(np_dot(pos, nrm))
    t = (dp - _lin3(nrm, o.x, o.y, o.z)) / torch.where(parallel, 1.0, nd)
    rx = o.x + t * d.x - float(pos[0]) if pos[0] else o.x + t * d.x
    ry = o.y + t * d.y - float(pos[1]) if pos[1] else o.y + t * d.y
    rz = o.z + t * d.z - float(pos[2]) if pos[2] else o.z + t * d.z
    u = _full(_lin3(inv0, rx, ry, rz), o.x)
    v = _full(_lin3(inv1, rx, ry, rz), o.x)
    ok = (~parallel & (t >= t_min) & (u >= 0) & (u <= 1) & (v >= 0)
          & (v <= 1))
    return ok, t


def intersect_area_lights_unrolled(ss: StaticScene, o: V3, d: V3,
                                   t_min: float = T_MIN_PT):
    """Unrolled `closestHitLight`; returns (t, radiance V3)."""
    inf = float("inf")
    t_best = torch.full_like(o.x, inf)
    rx = torch.zeros_like(o.x)
    ry = torch.zeros_like(o.x)
    rz = torch.zeros_like(o.x)
    for (pos, nrm, inv0, inv1, rad) in ss.al:
        ok, t = _patch_hit(pos, nrm, inv0, inv1, o, d, t_min)
        closer = ok & (t < t_best)
        t_best = torch.where(closer, t, t_best)
        rx = torch.where(closer, float(rad[0]), rx)
        ry = torch.where(closer, float(rad[1]), ry)
        rz = torch.where(closer, float(rad[2]), rz)
    return t_best, V3(rx, ry, rz)


def np_dot(a, b) -> float:
    """Dot product in the arrays' own precision (float32 for scene
    arrays), as the JAX module computes the plane offset."""
    return float(a[0] * b[0] + a[1] * b[1] + a[2] * b[2])


# ---------------------------------------------------------------------------
# SoA form: every primitive of a type against every ray as a (P, N) matrix
# ---------------------------------------------------------------------------

class MatTable(NamedTuple):
    """Material parameter table in SoA columns ((M,) each)."""
    type: torch.Tensor
    diffuse: V3
    specular: V3
    specular_ex: torch.Tensor
    ior: torch.Tensor
    absorbed: V3
    eta_r: V3
    eta_i: V3
    albedo: V3
    roughness: torch.Tensor
    f0: torch.Tensor
    metalness: torch.Tensor


class SceneSoA(NamedTuple):
    """The scene as float32 tensors on one device."""
    # spheres
    sph_pos: V3
    sph_radius: torch.Tensor
    sph_valid: torch.Tensor
    # triangles
    tri_v1: V3
    tri_e1: V3
    tri_e2: V3
    tri_valid: torch.Tensor
    # planes
    pln_pos: V3
    pln_normal: V3
    pln_inv0: V3       # row 0 of inv([u v uxv]) -> u coordinate
    pln_inv1: V3       # row 1 -> v coordinate
    pln_valid: torch.Tensor
    # combined per-prim tables, order [spheres | triangles | planes]
    prim_normal: V3    # zeros for sphere rows (computed from hit point)
    prim_is_sphere: torch.Tensor
    prim_sph_pos: V3   # sphere center per row (zeros elsewhere)
    prim_sph_inv_r: torch.Tensor
    prim_mat: torch.Tensor     # (P_total,) int64 material index
    # area lights
    al_pos: V3
    al_normal: V3
    al_inv0: V3
    al_inv1: V3
    al_radiance: V3
    al_valid: torch.Tensor
    # materials / ambient
    mat: MatTable
    ambient_type: int
    ambient_constant: V3
    env_map: np.ndarray


class HitSoA(NamedTuple):
    t: torch.Tensor        # (N,), +inf on miss
    valid: torch.Tensor    # (N,) bool
    point: V3              # (N,)
    normal: V3             # (N,) raw, NOT renormalized (PT convention)
    mat_oh: torch.Tensor   # (M, N) float one-hot of the hit material


def make_scene_soa(scene: SceneArrays, *, device) -> SceneSoA:
    """The scene arrays as float32 (masks bool) tensors on `device`."""
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    b = lambda x: torch.as_tensor(np.asarray(x, bool), device=device)
    i = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=device)
    tri_n = splat(f(scene.tri_normal))
    pln_n = splat(f(scene.pln_normal))
    sph_pos = splat(f(scene.sph_pos))
    s = scene.sph_valid.shape[0]
    t, p = scene.tri_valid.shape[0], scene.pln_valid.shape[0]
    zs = torch.zeros((s,), dtype=torch.float32, device=device)
    zt = torch.zeros((t + p,), dtype=torch.float32, device=device)
    cat = torch.cat
    radius = f(scene.sph_radius)
    mp = f(scene.mat_params)
    mat = MatTable(
        type=i(scene.mat_type),
        diffuse=splat(mp[:, MAT_DIFFUSE]),
        specular=splat(mp[:, MAT_SPECULAR]),
        specular_ex=mp[:, MAT_SPECULAR_EX],
        ior=mp[:, MAT_IOR],
        absorbed=splat(mp[:, MAT_ABSORBED]),
        eta_r=splat(mp[:, MAT_ETA_R]),
        eta_i=splat(mp[:, MAT_ETA_I]),
        albedo=splat(mp[:, MAT_ALBEDO]),
        roughness=mp[:, MAT_ROUGHNESS],
        f0=mp[:, MAT_F0],
        metalness=mp[:, MAT_METALNESS],
    )
    return SceneSoA(
        sph_pos=sph_pos, sph_radius=radius, sph_valid=b(scene.sph_valid),
        tri_v1=splat(f(scene.tri_v1)), tri_e1=splat(f(scene.tri_e1)),
        tri_e2=splat(f(scene.tri_e2)), tri_valid=b(scene.tri_valid),
        pln_pos=splat(f(scene.pln_pos)), pln_normal=pln_n,
        pln_inv0=splat(f(scene.pln_inv)[:, 0, :]),
        pln_inv1=splat(f(scene.pln_inv)[:, 1, :]),
        pln_valid=b(scene.pln_valid),
        prim_normal=V3(cat([zs, tri_n.x, pln_n.x]),
                       cat([zs, tri_n.y, pln_n.y]),
                       cat([zs, tri_n.z, pln_n.z])),
        prim_is_sphere=cat([torch.ones_like(zs), zt]),
        prim_sph_pos=V3(cat([sph_pos.x, zt]), cat([sph_pos.y, zt]),
                        cat([sph_pos.z, zt])),
        prim_sph_inv_r=cat([1.0 / torch.clamp(radius, min=1e-20), zt]),
        prim_mat=i(np.concatenate([np.asarray(scene.sph_mat),
                                   np.asarray(scene.tri_mat),
                                   np.asarray(scene.pln_mat)])),
        al_pos=splat(f(scene.al_pos)), al_normal=splat(f(scene.al_normal)),
        al_inv0=splat(f(scene.al_inv)[:, 0, :]),
        al_inv1=splat(f(scene.al_inv)[:, 1, :]),
        al_radiance=splat(f(scene.al_radiance)), al_valid=b(scene.al_valid),
        mat=mat,
        ambient_type=int(np.asarray(scene.ambient_type).reshape(())),
        ambient_constant=splat(f(scene.ambient_constant)),
        env_map=scene.env_map,
    )


def _col(v: V3) -> V3:
    """Lift per-prim (P,) components to (P, 1) for broadcasting against
    (N,)."""
    return V3(v.x[:, None], v.y[:, None], v.z[:, None])


def _row(v: V3) -> V3:
    return V3(v.x[None, :], v.y[None, :], v.z[None, :])


def _sphere_ts(s: SceneSoA, o: V3, d: V3, t_min: float) -> torch.Tensor:
    """(S, N) hit distances, +inf on miss (`intersections.cpp:31-55`)."""
    pos = _col(s.sph_pos)
    on, dn = _row(o), _row(d)
    oc = V3(on.x - pos.x, on.y - pos.y, on.z - pos.z)
    a = dot3(d, d)[None, :]
    b = oc.x * dn.x + oc.y * dn.y + oc.z * dn.z
    c = dot3(oc, oc) - (s.sph_radius ** 2)[:, None]
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inv_a = 1.0 / a
    t1 = (-b - sq) * inv_a
    t2 = (-b + sq) * inv_a
    ok = (disc > 0) & s.sph_valid[:, None]
    inf = float("inf")
    return torch.where(ok & (t1 >= t_min), t1,
                       torch.where(ok & (t2 >= t_min), t2, inf))


def _triangle_ts(s: SceneSoA, o: V3, d: V3, t_min: float) -> torch.Tensor:
    """(T, N) distances (Möller-Trumbore with det-sign fold,
    `intersections.cpp:5-30`)."""
    e1 = _col(s.tri_e1)
    e2 = _col(s.tri_e2)
    dn = _row(d)
    p = cross3(dn, e2)                       # (T, N)
    det0 = dot3(e1, p)
    sign = torch.where(det0 > 0, 1.0, -1.0)
    det = det0 * sign
    v1 = _col(s.tri_v1)
    on = _row(o)
    tvec = V3((on.x - v1.x) * sign, (on.y - v1.y) * sign,
              (on.z - v1.z) * sign)
    u = dot3(tvec, p)
    q = cross3(tvec, e1)
    v = dot3(dn, q)
    w = dot3(e2, q) / torch.where(det == 0, 1.0, det)
    ok = ((det >= 1e-6) & (u >= 0) & (u <= det) & (v >= 0) & (u + v <= det)
          & (w >= t_min) & s.tri_valid[:, None])
    return torch.where(ok, w, float("inf"))


def _patch_ts(pos: V3, normal: V3, inv0: V3, inv1: V3, valid: torch.Tensor,
              o: V3, d: V3, t_min: float) -> torch.Tensor:
    """(P, N) distances for parallelogram patches (planes & area lights,
    `intersections.cpp:56-92`)."""
    pc = _col(pos)
    nc = _col(normal)
    on, dn = _row(o), _row(d)
    nd = nc.x * dn.x + nc.y * dn.y + nc.z * dn.z
    parallel = (nd < 1e-7) & (nd > -1e-8)
    num = dot3(pos, normal)[:, None] - (nc.x * on.x + nc.y * on.y
                                        + nc.z * on.z)
    t = num / torch.where(parallel, 1.0, nd)
    rel = V3(on.x + t * dn.x - pc.x, on.y + t * dn.y - pc.y,
             on.z + t * dn.z - pc.z)
    i0 = _col(inv0)
    i1 = _col(inv1)
    u = i0.x * rel.x + i0.y * rel.y + i0.z * rel.z
    v = i1.x * rel.x + i1.y * rel.y + i1.z * rel.z
    ok = (~parallel & (t >= t_min) & (u >= 0) & (u <= 1) & (v >= 0)
          & (v <= 1) & valid[:, None])
    return torch.where(ok, t, float("inf"))


def soa_chunk(n_prims: int) -> int:
    """Rays per chunk: one (n_prims, chunk) float32 plane within
    SOA_PLANE_BYTES."""
    return max(1, SOA_PLANE_BYTES // (4 * max(n_prims, 1)))


def _chunked(fn, n_prims: int, o: V3, d: V3, chunk):
    """`fn(o, d)` over slices of the ray batch; each output (a tensor, a
    V3, or a tuple of those) concatenated along its last axis."""
    n = o.x.shape[0]
    chunk = soa_chunk(n_prims) if chunk is None else chunk
    if n <= chunk:
        return fn(o, d)
    sl = lambda v, a, b: V3(v.x[a:b], v.y[a:b], v.z[a:b])
    parts = [fn(sl(o, a, a + chunk), sl(d, a, a + chunk))
             for a in range(0, n, chunk)]

    def join(xs):
        if isinstance(xs[0], torch.Tensor):
            return torch.cat(xs, dim=-1)
        parts = [join(list(c)) for c in zip(*xs)]
        kind = type(xs[0])
        return kind(*parts) if hasattr(kind, "_fields") else tuple(parts)

    return join(parts)


def _first_min(t_all: torch.Tensor):
    """(min over axis 0, its first index): `torch.argmin` documents that
    the first of tied minima wins, as `soa.one_hot_argmin` needs."""
    idx = torch.argmin(t_all, dim=0)
    return t_all.gather(0, idx[None, :])[0], idx


def intersect_scene(s: SceneSoA, o: V3, d: V3, t_min: float = T_MIN_PT,
                    chunk: int = None) -> HitSoA:
    """Closest hit against spheres + triangles + planes for a ray batch;
    `chunk` rays at a time (default `soa_chunk` of the primitive count)."""
    n_prims = s.prim_is_sphere.shape[0]
    return _chunked(lambda o, d: _intersect_scene(s, o, d, t_min), n_prims,
                    o, d, chunk)


def _intersect_scene(s: SceneSoA, o: V3, d: V3, t_min: float) -> HitSoA:
    ts = _sphere_ts(s, o, d, t_min)
    tt = _triangle_ts(s, o, d, t_min)
    tp = _patch_ts(s.pln_pos, s.pln_normal, s.pln_inv0, s.pln_inv1,
                   s.pln_valid, o, d, t_min)
    t, idx = _first_min(torch.cat([ts, tt, tp], dim=0))  # (P_total, N)
    valid = torch.isfinite(t)
    # miss rays carry t=inf; fold them to the origin so downstream
    # masked shading never computes 0 * inf = NaN
    t_pt = torch.where(valid, t, 0.0)
    point = V3(o.x + t_pt * d.x, o.y + t_pt * d.y, o.z + t_pt * d.z)

    zero = torch.zeros((), dtype=torch.float32, device=t.device)
    pick = lambda col: torch.where(valid, col[idx], zero)
    n_static = V3(pick(s.prim_normal.x), pick(s.prim_normal.y),
                  pick(s.prim_normal.z))
    w_sph = pick(s.prim_is_sphere)
    c_sel = V3(pick(s.prim_sph_pos.x), pick(s.prim_sph_pos.y),
               pick(s.prim_sph_pos.z))
    inv_r = pick(s.prim_sph_inv_r)
    n_sph = V3((point.x - c_sel.x) * inv_r, (point.y - c_sel.y) * inv_r,
               (point.z - c_sel.z) * inv_r)
    normal = where3(w_sph > 0.5, n_sph, n_static)

    m = s.mat.type.shape[0]
    mid = s.prim_mat[idx]
    iota = torch.arange(m, dtype=mid.dtype, device=t.device)
    mat_oh = ((iota[:, None] == mid[None, :]) & valid[None, :]).to(
        torch.float32)                                # (M, N)
    return HitSoA(t=t, valid=valid, point=point, normal=normal,
                  mat_oh=mat_oh)


def intersect_area_lights(s: SceneSoA, o: V3, d: V3,
                          t_min: float = T_MIN_PT, chunk: int = None):
    """`closestHitLight` (`SimplePathTracer.cpp:131-142`): nearest
    area-light crossing.  Returns (t, radiance V3); t = +inf if none."""
    def one(o, d):
        ta = _patch_ts(s.al_pos, s.al_normal, s.al_inv0, s.al_inv1,
                       s.al_valid, o, d, t_min)
        t, idx = _first_min(ta)
        ok = torch.isfinite(t)
        zero = torch.zeros((), dtype=torch.float32, device=t.device)
        rad = V3(*(torch.where(ok, c[idx], zero) for c in s.al_radiance))
        return t, rad

    return _chunked(one, s.al_valid.shape[0], o, d, chunk)


def select_mat(mat_oh: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """(M, N) one-hot x (M,) material column -> (N,) values."""
    return torch.sum(mat_oh * col[:, None], dim=0)


def select_mat3(mat_oh: torch.Tensor, col: V3) -> V3:
    return V3(select_mat(mat_oh, col.x), select_mat(mat_oh, col.y),
              select_mat(mat_oh, col.z))
