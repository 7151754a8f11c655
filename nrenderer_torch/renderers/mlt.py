"""MetropolisLightTransport: Kelemen-style primary-sample-space MLT over a
bidirectional path tracer.

Counterpart of `nrenderer_tpu/renderers/mlt.py`, the rebuild of the
reference's flagship plugin (`components/metropolis_light_transport/`):

  - primary sample space chains: a vector u of NumStates uniforms drives
    the whole bidirectional sample (`TMarkovChian.hpp:9-29`);
  - mutations: a large step (fresh uniforms) with probability 0.3, else
    `perturb` with exponential-scale wraparound; the pixel dimensions use
    (2/(w+h), 0.1), the rest (1/1024, 1/64) (`Metropolis.hpp:103-147`);
  - bidirectional path generation: an eye path from a pinhole camera and a
    light path from the first area light with a g=999 cosine-power lobe,
    diffuse bounces by `VecCosine(n, 1, ...)` (`Metropolis.hpp:443-525`);
  - CombinePaths: every (eye prefix, light prefix) connection for path
    lengths 3..max_path, weighted by the balance heuristic;
  - Kelemen accumulation with deferred splats, and the exposure tone map
    pow(1 - exp(-x s), 1/2.2) (`Metropolis.cpp:49-57, 110-124`).

Thousands of chains run in lockstep as (C,)-lane tensors; the mutation
loop is a Python loop over steps (the JAX package's `lax.scan`), the
combine is vectorised over the static connection triangle exactly as the
JAX module lays it out, and the scene is normalised to unit scale.  The
reference quirks and deliberate divergences the JAX module marks
(REFQUIRK, DIVERGENCE) are kept as they are.

Mesh scenes: a triangle pool over MLT_BVH_THRESHOLD triangles goes through
`pt_core.closest_hit` with the port's mesh tables, i.e. the mesh pipe
(`mesh_cuda.intersect_triangles_mesh`) and so the blocked sweep B2, or the
MXU sweep B4 under NR_MESH_MXU=1; mesh ids are offset past the dense
primitives (`unique_pids`) so the visibility test compares one id space.

Random numbers: JAX's chains draw from `jax.random`; the port draws from
the counter-based `pt_core.hash_uniform(chain, step, draw, seed')`, so
parity with JAX is statistical, the CPU and the card draw the same
numbers, and a resumed render is exact without saving generator state.
The streams (`ns` = the state's length, 4 * (max_path + 3)):

  - b-estimate batch i:   u[k] = hash(chain, i, k, bounce_seed(seed, 1))
  - chain init:           u[k] = hash(chain, 0, k, bounce_seed(seed, 2))
  - mutation step g (0, 1, ... over the whole render), seed bounce_seed(
    seed, 3): draws [0, ns) the fresh state of a large step, [ns, 2 ns) the
    perturbation's r, 2 ns the large-step draw, 2 ns + 1 the accept draw.
"""
from __future__ import annotations

import hashlib
import os
from typing import NamedTuple

import numpy as np
import torch

from ..ops.intersect import (
    StaticScene, intersect_area_lights_unrolled, intersect_scene_unrolled,
    make_static_scene,
)
from ..ops.pt_core import bounce_seed, closest_hit, hash_uniform
from ..ops.pt_cuda import check_device
from ..ops.soa import V3, dot3, normalize3, where3
from ..scene.arrays import SceneArrays, build_scene_arrays
from ..scene.model import Scene
from ..server.component import RenderComponent, RenderResult
from ..server.registry import get_server, register_renderer
from ..utils.timing import GLOBAL_TIMER

PI = float(np.pi)
LIGHT_ID = -3.0
CAMERA_ID = -2.0
UNSET_ID = -1.0
MIN_PATH_LENGTH = 3      # `PathContribution.hpp:13`
LARGE_STEP_PROB = 0.3
T_MIN = 1e-4             # the scene is unit-normalised
MLT_BVH_THRESHOLD = 64   # triangle pools past this run the mesh pipe
SEED_B, SEED_INIT, SEED_MUTATE = 1, 2, 3   # bounce_seed phases (see above)


class MLTCamera(NamedTuple):
    """The MLT camera view (`mlt/include/Camera.hpp:16-73`): position, the
    (u, v, w) basis and tan(vfov / 2), as Python floats."""
    pos: tuple
    u: tuple
    v: tuple
    w: tuple
    half_height: float


def _floats(a) -> tuple:
    return tuple(float(x) for x in a)


def _mlt_camera(camera) -> MLTCamera:
    position = np.asarray(camera.position, np.float64)
    look_at = np.asarray(camera.look_at, np.float64)
    up = np.asarray(camera.up, np.float64)
    vfov = float(np.clip(camera.fov, 20.0, 160.0))
    half_height = float(np.tan(np.radians(vfov) / 2.0))
    w = position - look_at
    w /= np.linalg.norm(w)
    u = np.cross(up, w)
    u /= np.linalg.norm(u)
    v = np.cross(w, u)
    return MLTCamera(pos=_floats(position), u=_floats(u), v=_floats(v),
                     w=_floats(w), half_height=half_height)


def _onb_pixar(n: V3) -> tuple:
    """The reference's `onb(base, n)` basis (`Metropolis.hpp:186-200`):
    base.x*u + base.y*n + base.z*w with the z < -0.9999999 branch."""
    flip = n.z < -0.9999999
    a = 1.0 / (1.0 + torch.where(flip, 1.0, n.z))
    b = -n.x * n.y * a
    ux = torch.where(flip, 0.0, 1.0 - n.x * n.x * a)
    uy = torch.where(flip, -1.0, b)
    uz = torch.where(flip, 0.0, -n.x)
    wx = torch.where(flip, -1.0, b)
    wy = torch.where(flip, 0.0, 1.0 - n.y * n.y * a)
    wz = torch.where(flip, 0.0, -n.y)
    return V3(ux, uy, uz), V3(wx, wy, wz)


def vec_cosine(n: V3, g: float, r1, r2) -> V3:
    """`VecCosine` (`src/Metropolis.cpp:217-224`): cosine-power lobe about
    n, exponent g (1 diffuse, 999 the area-laser)."""
    temp1 = 2.0 * PI * r1
    temp2 = torch.pow(r2, 1.0 / (g + 1.0))
    s = torch.sin(temp1)
    c = torch.cos(temp1)
    t = torch.sqrt(torch.clamp(1.0 - temp2 * temp2, min=0.0))
    u, w = _onb_pixar(n)
    bx, by, bz = s * t, temp2, c * t
    return V3(bx * u.x + by * n.x + bz * w.x,
              bx * u.y + by * n.y + bz * w.y,
              bx * u.z + by * n.z + bz * w.z)


class PathBatch(NamedTuple):
    """(V, C) tensors, row i = vertex i; cr/cg/cb the vertex's `getColor`
    resolved at trace time (diffuse colour at a primitive, the emitted
    radiance at a light vertex, zero at the camera or unset)."""
    px: torch.Tensor
    py: torch.Tensor
    pz: torch.Tensor
    nx: torch.Tensor
    ny: torch.Tensor
    nz: torch.Tensor
    pid: torch.Tensor    # float ids: LIGHT_ID / CAMERA_ID / UNSET_ID or prim
    cr: torch.Tensor
    cg: torch.Tensor
    cb: torch.Tensor
    count: torch.Tensor  # (C,) float: the number of valid vertices


def _full3(vals, c: int, like: torch.Tensor) -> V3:
    return V3(*(torch.full((c,), float(v), dtype=like.dtype,
                           device=like.device) for v in vals))


def _trace_path(ss: StaticScene, mat_ch, o: V3, d: V3, u_rows: torch.Tensor,
                v_max: int, depth: int, first_vert, light_normal: V3,
                emitted, first_color: V3, tri_bvh=None) -> PathBatch:
    """The eye and light path tracer (`src/Metropolis.cpp:188-214`,
    `mlt.py:164-256`): diffuse bounces driven by the state's uniforms
    `u_rows` ((2 * (min(depth, v_max) - 1), C)); a light hit ends the path.
    `first_vert` = (p V3, n V3, id (C,)).  DIVERGENCE (as JAX): light-hit
    vertices store the normalised light normal."""
    c = o.x.shape[0]
    zeros = torch.zeros_like(o.x)
    zeros3 = V3(zeros, zeros, zeros)
    rows_p, rows_n = [first_vert[0]], [first_vert[1]]
    rows_id, rows_c = [first_vert[2]], [first_color]
    count = torch.ones_like(o.x)
    alive = torch.ones_like(o.x, dtype=torch.bool)
    em = _full3(emitted, c, o.x)
    for cur_depth in range(1, min(depth, v_max)):
        if tri_bvh is None:
            hit = intersect_scene_unrolled(ss, o, d, t_min=T_MIN,
                                           mat_channels=mat_ch)
        else:
            hit = closest_hit(ss, o, d, T_MIN, mat_ch, tri_bvh=tri_bvh,
                              alive=alive, unique_pids=True)
        t_l, _ = intersect_area_lights_unrolled(ss, o, d, t_min=T_MIN)
        obj_first = alive & hit.valid & (hit.t < t_l)
        light_hit = alive & ~obj_first & (t_l < float("inf"))

        n_hit = normalize3(hit.normal, eps=1e-20)
        flip = dot3(n_hit, d) < 0   # against the ray (`Metropolis.cpp:196`)
        n_hit = where3(flip, n_hit, V3(-n_hit.x, -n_hit.y, -n_hit.z))

        lp = V3(o.x + t_l * d.x, o.y + t_l * d.y, o.z + t_l * d.z)
        vert_p = where3(obj_first, hit.point, lp)
        vert_n = where3(obj_first, n_hit, light_normal)
        vert_id = torch.where(obj_first, hit.prim_id,
                              torch.where(light_hit, LIGHT_ID, UNSET_ID))
        vert_c = where3(obj_first, V3(*hit.channels), em)
        appended = obj_first | light_hit
        rows_p.append(where3(appended, vert_p, zeros3))
        rows_n.append(where3(appended, vert_n, zeros3))
        rows_id.append(torch.where(appended, vert_id, UNSET_ID))
        rows_c.append(where3(appended, vert_c, zeros3))
        count = count + appended.to(torch.float32)

        r0 = u_rows[(cur_depth - 1) * 2]
        r1 = u_rows[(cur_depth - 1) * 2 + 1]
        new_d = vec_cosine(n_hit, 1.0, r0, r1)
        o = where3(obj_first, hit.point, o)
        d = where3(obj_first, new_d, d)
        alive = obj_first

    unset = torch.full_like(zeros, UNSET_ID)
    while len(rows_p) < v_max:
        rows_p.append(zeros3)
        rows_n.append(zeros3)
        rows_id.append(unset)
        rows_c.append(zeros3)

    stack = lambda rows, k: torch.stack([r[k] for r in rows])
    return PathBatch(
        px=stack(rows_p, 0), py=stack(rows_p, 1), pz=stack(rows_p, 2),
        nx=stack(rows_n, 0), ny=stack(rows_n, 1), nz=stack(rows_n, 2),
        pid=torch.stack(rows_id), cr=stack(rows_c, 0),
        cg=stack(rows_c, 1), cb=stack(rows_c, 2), count=count)


class MLTKernel:
    """The scene, camera and shape of a chain population, and the pieces
    of one Kelemen step over (C,)-lane tensors on `device`."""

    def __init__(self, ss: StaticScene, cam: MLTCamera, width: int,
                 height: int, max_path: int, emitted, light_pos, light_u,
                 light_v, light_area: float, device, tri_bvh=None):
        self.ss = ss
        self.tri_bvh = tri_bvh   # mesh_cuda.MeshTables, or None
        self.cam = cam
        self.width = width
        self.height = height
        self.max_path = max_path
        self.v_max = max_path + 1
        self.nss = (self.v_max + 2) * 2          # NumStatesSubpath
        self.n_states = self.nss * 2
        self.emitted = _floats(emitted)          # 2x the scene radiance
        self.light_pos = _floats(light_pos)
        self.light_u = _floats(light_u)
        self.light_v = _floats(light_v)
        self.light_area = float(light_area)
        ln = np.cross(light_u, light_v)
        self.light_normal = _floats(ln / np.linalg.norm(ln))
        self.mat_ch = [_floats(m["diffuse"]) for m in ss.mats]
        self.device = torch.device(device)
        self._idx = {}
        self._tri = self._conn_triangle()

    def _wh(self, wh):
        return wh if wh is not None else (float(self.width),
                                          float(self.height))

    def _index(self, key, values) -> torch.Tensor:
        """A static index array as a device tensor, made once."""
        if key not in self._idx:
            self._idx[key] = torch.as_tensor(np.asarray(values, np.int64),
                                             device=self.device)
        return self._idx[key]

    # -- path generation ---------------------------------------------------

    def _eye_start(self, u: torch.Tensor, wh=None):
        """Camera-sample ray and first vertex (`Metropolis.hpp:490-499`)."""
        c = u.shape[1]
        cam = self.cam
        w_, h_ = self._wh(wh)
        dist = h_ / (2.0 * cam.half_height)
        r1, r2 = u[0], u[1]
        sx = -(0.5 - r1) * w_
        sy = (0.5 - r2) * h_
        dx = cam.u[0] * sx + cam.v[0] * sy - cam.w[0] * dist
        dy = cam.u[1] * sx + cam.v[1] * sy - cam.w[1] * dist
        dz = cam.u[2] * sx + cam.v[2] * sy - cam.w[2] * dist
        d = normalize3(V3(dx, dy, dz), eps=1e-20)
        return _full3(cam.pos, c, u), d, _full3(cam.w, c, u)

    def _light_start(self, u: torch.Tensor):
        """Light-sample ray and first vertex.  REFQUIRK: the direction
        reuses the position's uniforms (`Metropolis.hpp:443-463`)."""
        c = u.shape[1]
        r1, r2 = u[self.nss], u[self.nss + 1]
        lp, lu, lv = self.light_pos, self.light_u, self.light_v
        o = V3(lp[0] + r1 * lu[0] + r2 * lv[0],
               lp[1] + r1 * lu[1] + r2 * lv[1],
               lp[2] + r1 * lu[2] + r2 * lv[2])
        n = _full3(self.light_normal, c, u)
        return o, vec_cosine(n, 999.0, r1, r2), n

    def _u_rows(self, u: torch.Tensor, base: int) -> torch.Tensor:
        return u[base:base + 2 * (min(self.max_path, self.v_max) - 1)]

    def generate_paths(self, u: torch.Tensor, wh=None):
        """The eye and light subpaths as one 2C-lane `_trace_path` batch
        (`mlt.py:349-380`); returns (eye, light) PathBatches."""
        c = u.shape[1]
        oe, de, ne = self._eye_start(u, wh)
        ol, dl, nl = self._light_start(u)
        cat = lambda a, b: torch.cat([a, b])
        cat3 = lambda a, b: V3(cat(a.x, b.x), cat(a.y, b.y), cat(a.z, b.z))
        o = cat3(oe, ol)
        first_id = cat(torch.full_like(u[0], CAMERA_ID),
                       torch.full_like(u[0], LIGHT_ID))
        zc = torch.zeros_like(u[0])
        first_color = cat3(V3(zc, zc, zc), _full3(self.emitted, c, u))
        u_rows = torch.cat([self._u_rows(u, 2),
                            self._u_rows(u, self.nss + 4)], dim=1)
        both = _trace_path(self.ss, self.mat_ch, o, cat3(de, dl), u_rows,
                           self.v_max, self.max_path,
                           (o, cat3(ne, nl), first_id),
                           _full3(self.light_normal, 2 * c, u), self.emitted,
                           first_color, tri_bvh=self.tri_bvh)
        eye = PathBatch(*(f[..., :c] for f in both))
        light = PathBatch(*(f[..., c:] for f in both))
        return eye, light

    # -- connections ---------------------------------------------------------

    @staticmethod
    def _edge_tables(p: PathBatch) -> dict:
        """Per-edge physics of one subpath, (V-1, C) each; edge i joins
        vertex i to i + 1 (`mlt.py:386-417`).  `fwd` is the pdf of sampling
        the head from the tail, `bwd` the reverse."""
        dvx = p.px[1:] - p.px[:-1]
        dvy = p.py[1:] - p.py[:-1]
        dvz = p.pz[1:] - p.pz[:-1]
        d2 = dvx * dvx + dvy * dvy + dvz * dvz
        d2s = torch.where(d2 < 1e-20, 1e-20, d2)
        inv_len = torch.rsqrt(d2s)
        dup = d2 == 0.0
        cos_tail = p.nx[:-1] * dvx + p.ny[:-1] * dvy + p.nz[:-1] * dvz
        cos_head = p.nx[1:] * dvx + p.ny[1:] * dvy + p.nz[1:] * dvz
        pdf_tail = torch.abs(cos_tail) * inv_len / PI
        pdf_head = torch.abs(cos_head) * inv_len / PI
        d2a_head = torch.abs(cos_head) * inv_len / d2s
        d2a_tail = torch.abs(cos_tail) * inv_len / d2s
        return dict(dvx=dvx, dvy=dvy, dvz=dvz, d2s=d2s, inv_len=inv_len,
                    dup=dup, cos_tail=cos_tail, cos_head=cos_head,
                    fwd=pdf_tail * d2a_head, bwd=pdf_head * d2a_tail,
                    d2a_head=d2a_head)

    def _conn_triangle(self):
        """Static index maps of the packed (s-1, t-1) connection triangle
        (`mlt.py:419-433`): row r pairs eye vertex A[r] with light vertex
        B[r]; FLAT[a, b] = r (-1 unused)."""
        v = self.v_max
        pairs = [(a, b) for a in range(v) for b in range(v - 1 - a)]
        A = np.array([p[0] for p in pairs], np.int64)
        B = np.array([p[1] for p in pairs], np.int64)
        flat = np.full((v, v), -1, np.int64)
        flat[A, B] = np.arange(len(pairs))
        return A, B, flat

    def _combo_index(self, L: int, flat: np.ndarray) -> dict:
        """The static gathers of path length L over its splits s = 1..L+1
        (t = L + 1 - s), clipped as `mlt.py:668-747` clips them, as device
        tensors made once."""
        key = ("combo", L)
        if key not in self._idx:
            v = self.v_max
            s = np.arange(1, L + 2)
            t = (L + 1) - s
            dev = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                            device=self.device)
            self._idx[key] = {
                "fi": dev(flat[s - 1, t - 1]), "s": dev(s), "t": dev(t),
                "s-1": dev(np.clip(s - 1, 0, v - 1)),
                "s-2": dev(np.clip(s - 2, 0, v - 2)),
                "s-3": dev(np.clip(s - 3, 0, v - 2)),
                "t-2": dev(np.clip(t - 2, 0, v - 2)),
                "t-3": dev(np.clip(t - 3, 0, v - 2)),
                "pe s": dev(np.clip(s, 0, v)),
                "pe s-1": dev(np.clip(s - 1, 0, v)),
                "pe s-2": dev(np.clip(s - 2, 0, v)),
                "lf t": dev(np.clip(t, 0, v - 1)),
                "lf t-1": dev(np.clip(t - 1, 0, v - 1)),
                "lf t-2": dev(np.clip(t - 2, 0, v - 1))}
        return self._idx[key]

    def _shadow(self, o: V3, d: V3):
        """(valid, prim id) of the closest hits along the connections."""
        if self.tri_bvh is None:
            sh = intersect_scene_unrolled(self.ss, o, d, t_min=T_MIN)
            return sh.valid, sh.prim_id
        shape = o.x.shape
        fl = lambda a: a.reshape(-1)
        sh = closest_hit(self.ss, V3(fl(o.x), fl(o.y), fl(o.z)),
                         V3(fl(d.x), fl(d.y), fl(d.z)), T_MIN, self.mat_ch,
                         tri_bvh=self.tri_bvh, unique_pids=True)
        return sh.valid.reshape(shape), sh.prim_id.reshape(shape)

    def combine_paths(self, eye: PathBatch, light: PathBatch, wh=None):
        """Every BPT connection (`CombinePaths`, `Metropolis.hpp:544-608`),
        factorised as the JAX module does (`mlt.py:435-779`): per-subpath
        edge tables, the triangle-packed connection grid with one shadow
        batch, prefix tables and two first-order recurrences for the
        balance-heuristic sums, then each path length L vectorised over its
        s = 1..L+1 splits.  Returns ((px, py, r, g, b, valid) splat rows,
        sc (C,)): row i < n_L is the s = 1 connection of length MIN + i,
        the last row the pre-summed s >= 2 connections, which all land on
        the chain's eye pixel."""
        v = self.v_max
        c = eye.px.shape[1]
        cam = self.cam
        w_, h_ = self._wh(wh)
        dist = h_ / (2.0 * cam.half_height)
        ix = self._index
        n_eye, n_light = eye.count, light.count

        d_cam = normalize3(V3(eye.px[1] - eye.px[0], eye.py[1] - eye.py[0],
                              eye.pz[1] - eye.pz[0]), eps=1e-20)
        ddw_c = (d_cam.x * -cam.w[0] + d_cam.y * -cam.w[1]
                 + d_cam.z * -cam.w[2])
        k_c = dist / torch.where(torch.abs(ddw_c) < 1e-12, 1e-12, ddw_c)
        spx_c = d_cam.x * k_c + cam.w[0] * dist
        spy_c = d_cam.y * k_c + cam.w[1] * dist
        spz_c = d_cam.z * k_c + cam.w[2] * dist
        px_cam = (cam.u[0] * spx_c + cam.u[1] * spy_c + cam.u[2] * spz_c
                  + w_ * 0.5)
        py_cam = (-cam.v[0] * spx_c - cam.v[1] * spy_c - cam.v[2] * spz_c
                  + h_ * 0.5)

        # per-sample tables
        E = self._edge_tables(eye)
        Lt = self._edge_tables(light)
        inv_wh = 1.0 / (w_ * h_)
        cos0 = -(E["dvx"][0] * cam.w[0] + E["dvy"][0] * cam.w[1]
                 + E["dvz"][0] * cam.w[2]) * E["inv_len"][0]
        ds2 = (dist / torch.where(torch.abs(cos0) < 1e-12, 1e-12, cos0)) ** 2
        camE = (inv_wh / (cos0 / ds2)) * E["d2a_head"][0]          # (C,)

        zrow = torch.zeros_like(E["dup"][:1])
        dupE_next = torch.cat([E["dup"][1:], zrow])
        dupL_prev = torch.cat([zrow, Lt["dup"][:-1]])
        dupL_next = torch.cat([Lt["dup"][1:], zrow])
        gfwdE = torch.where(E["dup"][1:] | E["dup"][:-1], 1.0, E["fwd"][1:])
        gbwdL = torch.where(Lt["dup"] | dupL_next, 1.0, Lt["bwd"])
        gfwdL = torch.where(Lt["dup"] | dupL_prev, 1.0, Lt["fwd"])
        gbwdE = torch.where(E["dup"] | dupE_next, 1.0, E["bwd"])

        ones1 = torch.ones_like(camE)[None]
        EYEF = torch.cat([ones1, torch.cumprod(gfwdE, dim=0)])    # (V-1, C)
        PEterm = torch.cat([ones1, ones1, camE[None] * EYEF[:v - 1]])
        inv_area = 1.0 / self.light_area
        LF = torch.cat([ones1, ones1 * inv_area,
                        inv_area * Lt["fwd"][0][None]
                        * torch.cat([ones1,
                                     torch.cumprod(gfwdL[1:v - 2], dim=0)])])
        qe = [torch.zeros_like(camE)]
        ql = [gbwdL[0] * LF[0]]
        for m in range(1, v - 1):
            qe.append(gbwdE[m] * (qe[-1] + PEterm[m]))
            ql.append(gbwdL[m] * (ql[-1] + LF[m]))
        QE = torch.stack(qe)                                       # (V-1, C)
        QL = torch.stack(ql)

        # throughput middle-term prefix tables (`Metropolis.hpp:239-293`)
        geoE = (E["cos_tail"] * E["cos_tail"]) / (E["d2s"] * E["d2s"])
        okE = torch.isfinite(geoE) & (geoE > 1e-30)
        geoL = (Lt["cos_head"] * Lt["cos_head"]) / (Lt["d2s"] * Lt["d2s"])
        okL = torch.isfinite(geoL) & (geoL > 1e-30)
        ones2 = torch.cat([ones1, ones1])
        me = lambda col: torch.cat([ones2, torch.cumprod(
            torch.where(okE, col[:-1] * (1.0 / PI) * geoE, 1.0)[1:], dim=0)])
        ml = lambda col: torch.cat([ones2, torch.cumprod(
            torch.where(okL, col[1:] * (1.0 / PI) * geoL, 1.0),
            dim=0)[:v - 2]])
        MEtab = (me(eye.cr), me(eye.cg), me(eye.cb))
        MLtab = (ml(light.cr), ml(light.cg), ml(light.cb))

        # the connection grid over the packed (eye vertex, light vertex)
        # triangle, with one shadow batch
        A_np, B_np, FLAT = self._tri
        A, B = ix("A", A_np), ix("B", B_np)
        epx, epy, epz = eye.px[A], eye.py[A], eye.pz[A]
        cx = light.px[B] - epx                                     # (F, C)
        cy = light.py[B] - epy
        cz = light.pz[B] - epz
        d2c = cx * cx + cy * cy + cz * cz
        d2cs = torch.where(d2c < 1e-20, 1e-20, d2c)
        invc = torch.rsqrt(d2cs)
        dupcF = d2c == 0.0
        cosO = eye.nx[A] * cx + eye.ny[A] * cy + eye.nz[A] * cz
        cosT = light.nx[B] * cx + light.ny[B] * cy + light.nz[B] * cz
        connFwdF = ((torch.abs(cosO) * invc / PI)
                    * (torch.abs(cosT) * invc / d2cs))
        connBwdF = ((torch.abs(cosT) * invc / PI)
                    * (torch.abs(cosO) * invc / d2cs))
        geoC = (cosO * cosO) / (d2cs * d2cs)
        okC = torch.isfinite(geoC) & (geoC > 1e-30)
        mCF = tuple(torch.where(okC, col[A] * (1.0 / PI) * geoC, 1.0)
                    for col in (eye.cr, eye.cg, eye.cb))
        # REFQUIRK: visibility by id equality; a t = 1 connection targets
        # the light sample vertex (id -3) and always fails
        conn_d = normalize3(V3(cx, cy, cz), eps=1e-20)
        sh_valid, sh_pid = self._shadow(V3(epx, epy, epz), conn_d)
        visF = sh_valid & (sh_pid == light.pid[B])
        c0 = slice(0, v - 1)   # the a = 0 block: eye vertex 0, the camera
        cos0c = -(cx[c0] * cam.w[0] + cy[c0] * cam.w[1]
                  + cz[c0] * cam.w[2]) * invc[c0]
        ds2c = (dist / torch.where(torch.abs(cos0c) < 1e-12, 1e-12,
                                   cos0c)) ** 2
        camConn = ((inv_wh / (cos0c / ds2c))
                   * (torch.abs(cosT[c0]) * invc[c0] / d2cs[c0]))  # (T, C)
        ddw1 = (conn_d.x[c0] * -cam.w[0] + conn_d.y[c0] * -cam.w[1]
                + conn_d.z[c0] * -cam.w[2])
        k1 = dist / torch.where(torch.abs(ddw1) < 1e-12, 1e-12, ddw1)
        spx1 = conn_d.x[c0] * k1 + cam.w[0] * dist
        spy1 = conn_d.y[c0] * k1 + cam.w[1] * dist
        spz1 = conn_d.z[c0] * k1 + cam.w[2] * dist
        pxconn = (cam.u[0] * spx1 + cam.u[1] * spy1 + cam.u[2] * spz1
                  + w_ * 0.5)
        pyconn = (-cam.v[0] * spx1 - cam.v[1] * spy1 - cam.v[2] * spz1
                  + h_ * 0.5)
        in_cam = ((px_cam >= 0) & (px_cam < w_)
                  & (py_cam >= 0) & (py_cam < h_))

        # per-L assembly over the static arrangement
        outs = []
        zc = torch.zeros_like(camE)
        red_r, red_g, red_b = zc, zc, zc
        red_any = torch.zeros_like(in_cam)
        sc = zc
        for L in range(MIN_PATH_LENGTH, self.max_path + 1):
            g = self._combo_index(L, FLAT)
            fi, s_col, t_col = g["fi"], g["s"][:, None], g["t"][:, None]
            s_ge = lambda k: s_col >= k
            t_ge = lambda k: t_col >= k
            ok0 = (s_col <= n_eye[None]) & (t_col <= n_light[None])

            dupc_g = dupcF[fi]
            dupE_s2 = E["dup"][g["s-2"]]
            dupL_t2 = Lt["dup"][g["t-2"]]
            bwdE_s2 = E["bwd"][g["s-2"]]
            bwdL_t2 = Lt["bwd"][g["t-2"]]

            C1 = torch.where(
                t_ge(2), torch.where(dupc_g | dupL_t2, 1.0, connBwdF[fi]),
                torch.where(t_ge(1), connBwdF[fi], inv_area))
            C2 = torch.where(t_ge(1),
                             torch.where(dupE_s2 | dupc_g, 1.0, bwdE_s2),
                             bwdE_s2)
            D1 = torch.where(s_ge(2),
                             torch.where(dupc_g | dupE_s2, 1.0,
                                         connFwdF[fi]), 1.0)
            D2 = torch.where(dupL_t2 | dupc_g, 1.0, bwdL_t2)

            pe_s = PEterm[g["pe s"]]
            pe_s1 = PEterm[g["pe s-1"]]
            pe_s2 = PEterm[g["pe s-2"]]
            qe_s3 = QE[g["s-3"]]
            lf_t = LF[g["lf t"]]
            lf_t1 = LF[g["lf t-1"]]
            lf_t2 = LF[g["lf t-2"]]
            ql_t3 = QL[g["t-3"]]
            EPc = torch.where(s_ge(2), pe_s, camConn[L - 1])

            p_st = pe_s * lf_t
            sum_lt = torch.where(s_ge(2), lf_t * C1 * (
                pe_s1 + torch.where(s_ge(3), C2 * (
                    pe_s2 + torch.where(s_ge(4), qe_s3, 0.0)), 0.0)), 0.0)
            sum_gt = torch.where(t_ge(1), EPc * D1 * (
                lf_t1 + torch.where(t_ge(2), D2 * (
                    lf_t2 + torch.where(t_ge(3), ql_t3, 0.0)), 0.0)), 0.0)
            p_all = sum_lt + p_st + sum_gt
            w_mis = torch.where((p_st > 0) & (p_all > 0),
                                torch.clamp(p_st / p_all, 0.0, 1.0), 0.0)

            # throughput: prefix-table lookups
            cam_g = torch.where(s_ge(2), camE, camConn[L - 1])
            has_conn = s_ge(2) & (s_col <= L)
            # the last vertex must be the light (t = 0: the eye path ended
            # on it)
            end_ok = t_ge(1) | (eye.pid[L] == LIGHT_ID)[None]
            me_i, ml_i = g["s-1"], g["lf t"]
            f = []
            for ch in range(3):
                mc = torch.where(has_conn, mCF[ch][fi], 1.0)
                f.append(cam_g * MEtab[ch][me_i] * mc * MLtab[ch][ml_i]
                         * torch.where(end_ok, self.emitted[ch] / PI, 0.0))

            # visibility and the pixel
            eyepid_g = eye.pid[me_i]
            vis = torch.where(t_col == 0, eyepid_g == LIGHT_ID, visF[fi])
            s1 = s_col == 1
            px = torch.where(s1, pxconn[L - 1], px_cam)
            py = torch.where(s1, pyconn[L - 1], py_cam)
            vis = vis & torch.where(s1, (px >= 0) & (px < w_) & (py >= 0)
                                    & (py < h_), in_cam)

            inv_p = torch.where(p_st > 0, 1.0 / p_st, 0.0)
            cr = f[0] * w_mis * inv_p
            cgc = f[1] * w_mis * inv_p
            cb = f[2] * w_mis * inv_p
            cmax = torch.maximum(cr, torch.maximum(cgc, cb))
            valid = (ok0 & vis & (w_mis > 0) & (p_st > 0) & (cmax > 0)
                     & torch.isfinite(cmax))
            cr = torch.where(valid, cr, 0.0)
            cgc = torch.where(valid, cgc, 0.0)
            cb = torch.where(valid, cb, 0.0)
            sc = torch.maximum(sc, torch.amax(torch.where(valid, cmax, 0.0),
                                              dim=0))
            outs.append((px[0], py[0], cr[0], cgc[0], cb[0], valid[0]))
            red_r = red_r + torch.sum(cr[1:], dim=0)
            red_g = red_g + torch.sum(cgc[1:], dim=0)
            red_b = red_b + torch.sum(cb[1:], dim=0)
            red_any = red_any | torch.any(valid[1:], dim=0)

        outs.append((px_cam, py_cam, red_r, red_g, red_b, red_any))
        contribs = tuple(torch.stack([o[i] for o in outs]) for i in range(6))
        return contribs, sc

    def sample(self, u: torch.Tensor, wh=None):
        """A state vector (n_states, C) -> (splat rows, sc)."""
        eye, light = self.generate_paths(u, wh)
        return self.combine_paths(eye, light, wh)

    # -- the mutation (`Metropolis.hpp:103-147`) ----------------------------

    @staticmethod
    def perturb(value, r, s1, s2):
        lo = r < 0.5
        r1 = torch.where(lo, r * 2.0, (r - 0.5) * 2.0)
        delta = s2 * torch.exp(-float(np.log(s2 / s1)) * r1)
        up = value + delta
        up = torch.where(up > 1.0, up - 1.0, up)
        down = value - delta
        down = torch.where(down < 0.0, down + 1.0, down)
        return torch.where(lo, up, down)

    def mutate(self, u: torch.Tensor, r: torch.Tensor, wh=None):
        """The small step, given the uniforms `r` (shaped like u)."""
        w_, h_ = self._wh(wh)
        s1_pix = 2.0 / (w_ + h_)
        pix = self.perturb(u[:2], r[:2], s1_pix, 0.1)
        rest = self.perturb(u[2:], r[2:], 1.0 / 1024.0, 1.0 / 64.0)
        return torch.cat([pix, rest])


def _scaled_arrays(arrays: SceneArrays, f: float) -> SceneArrays:
    """The scene's geometry scaled by f (`mlt.py:809-833`, numpy): the unit
    normalisation that keeps ~20-edge pdf products inside float32 range;
    a path's contribution is scale-invariant."""
    a = arrays
    n = np.asarray
    inv_scaled = n(a.pln_inv).copy()
    inv_scaled[:, 0:2, :] /= f
    inv_scaled[:, 2, :] /= f * f
    al_inv_scaled = n(a.al_inv).copy()
    al_inv_scaled[:, 0:2, :] /= f
    al_inv_scaled[:, 2, :] /= f * f
    return a._replace(
        sph_pos=n(a.sph_pos) * f, sph_radius=n(a.sph_radius) * f,
        tri_v1=n(a.tri_v1) * f, tri_e1=n(a.tri_e1) * f,
        tri_e2=n(a.tri_e2) * f,
        pln_pos=n(a.pln_pos) * f, pln_inv=inv_scaled,
        al_pos=n(a.al_pos) * f, al_u=n(a.al_u) * f, al_v=n(a.al_v) * f,
        al_normal=n(a.al_normal) * (f * f), al_inv=al_inv_scaled,
    )


def _scene_extent(a: SceneArrays) -> float:
    """The largest |coordinate| over all scene geometry: sphere bounds,
    triangle vertices, plane corners and area-light corners
    (`mlt.py:840-871`)."""
    pts = [np.zeros((1, 3))]
    sv = np.asarray(a.sph_valid)
    sph = np.asarray(a.sph_pos)[sv]
    if sph.size:
        rad = np.asarray(a.sph_radius)[sv][:, None]
        pts += [sph + rad, sph - rad]
    tv = np.asarray(a.tri_valid)
    v1 = np.asarray(a.tri_v1)[tv]
    if v1.size:
        pts += [v1, v1 + np.asarray(a.tri_e1)[tv],
                v1 + np.asarray(a.tri_e2)[tv]]
    pv = np.asarray(a.pln_valid)
    pp = np.asarray(a.pln_pos)[pv]
    if pp.size:
        pts.append(pp)
        try:   # the columns of pln_inv^-1 are [u, v, u x v]
            m = np.linalg.inv(np.asarray(a.pln_inv)[pv])
            pts.append(pp + m[:, :, 0] + m[:, :, 1])
        except np.linalg.LinAlgError:
            pass
    av = np.asarray(a.al_valid)
    ap = np.asarray(a.al_pos)[av]
    if ap.size:
        pts += [ap, ap + np.asarray(a.al_u)[av] + np.asarray(a.al_v)[av]]
    return max(1.0, float(np.abs(np.concatenate(pts, axis=0)).max()))


def _prepare_mlt(scene: Scene, device, max_path: int = None):
    """Scene prep (`mlt.py:874-918`): unit-scale normalisation, the light,
    the mesh tables of a pool over MLT_BVH_THRESHOLD triangles (built from
    the SCALED arrays), the kernel.  Returns (kern, width, height), or None
    when the scene has no area light (the reference renders black)."""
    from ..ops.bvh import build_mesh_accel
    from ..ops.mesh_cuda import make_mesh_tables
    ro = scene.render_option
    width, height = ro.width, ro.height
    max_path = max_path if max_path is not None else min(ro.depth, 20)
    arrays = build_scene_arrays(scene)
    if not scene.area_light_buffer:
        return None
    f = 1.0 / _scene_extent(arrays)
    scaled = _scaled_arrays(arrays, f)
    ss = make_static_scene(scaled)
    tri_bvh = None
    if int(np.sum(np.asarray(arrays.tri_valid))) > MLT_BVH_THRESHOLD:
        mat_ch = [tuple(m["diffuse"]) for m in ss.mats]
        tri_bvh = make_mesh_tables(build_mesh_accel(scaled, mat_ch).bt,
                                   device)
    al = scene.area_light_buffer[0]
    light_pos = np.asarray(al.position, np.float64) * f
    light_u = np.asarray(al.u, np.float64) * f
    light_v = np.asarray(al.v, np.float64) * f
    light_area = float(np.linalg.norm(np.cross(light_u, light_v)))
    # REFQUIRK: emitted = 2x the scene radiance (`Metropolis.hpp:34`)
    emitted = 2.0 * np.asarray(al.radiance, np.float64)
    camera = _mlt_camera(scene.camera)
    camera = camera._replace(pos=_floats(np.asarray(camera.pos) * f))
    kern = MLTKernel(ss, camera, width, height, max_path, emitted, light_pos,
                     light_u, light_v, light_area, device, tri_bvh=tri_bvh)
    return kern, width, height


def film_bucket(n_pix: int) -> int:
    """The film's capacity for a pixel count: the next power of two, at
    least 1024 (`mlt.py:921-926`); slot `capacity` takes dropped splats."""
    return max(1024, 1 << (int(n_pix) - 1).bit_length())


def state_uniforms(n_draws: int, chains: int, step: int, draw0: int,
                   seed: int, device, chain0: int = 0) -> torch.Tensor:
    """(n_draws, chains) uniforms hash(chain, step, draw0 + k, seed) of
    the chains [chain0, chain0 + chains)."""
    chain = torch.arange(chain0, chain0 + chains, dtype=torch.int64,
                         device=device)[None, :]
    draw = torch.arange(draw0, draw0 + n_draws, dtype=torch.int64,
                        device=device)[:, None]
    return hash_uniform(chain, step, draw, seed)


def _splat(film: torch.Tensor, contribs, weight: torch.Tensor, width: int,
           height: int) -> None:
    """Add each valid row's colour times the chain's weight to its pixel
    (`index_add_`; invalid or off-film rows go to the drop slot)."""
    cap = film.shape[0] - 1
    px, py, cr, cg, cb, valid = contribs
    ix = px.to(torch.int32)
    iy = py.to(torch.int32)
    ok = valid & (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
    flat = torch.where(ok, iy.to(torch.int64) * width + ix, cap)
    w = weight[None, :]
    vals = torch.stack([cr * w, cg * w, cb * w], dim=-1)
    film.index_add_(0, flat.reshape(-1), vals.reshape(-1, 3))


class _Chains(NamedTuple):
    """The chain population's state between mutation steps."""
    film: torch.Tensor      # (film_bucket + 1, 3) linear splat sums
    u: torch.Tensor         # (n_states, C) the current states
    contribs: tuple         # the current states' splat rows
    sc: torch.Tensor        # (C,) their scalar contributions
    w_acc: torch.Tensor     # (C,) their deferred Kelemen weights


def mutation_step(kern: MLTKernel, ch: _Chains, step: int, b: float,
                  seed: int, chain0: int = 0) -> _Chains:
    """One Kelemen step of every chain (`mlt.py:1017-1056`): propose (a
    large step with probability 0.3, else a perturbation), weight the
    proposal and the current state, accept with probability a, and splat
    the state that leaves the chain with its accumulated weight.  `ch`
    holds the chains [chain0, chain0 + C) of the render."""
    ns, c = kern.n_states, ch.u.shape[1]
    wh = (float(kern.width), float(kern.height))
    draws = state_uniforms(2 * ns + 2, c, step, 0, seed, ch.u.device,
                           chain0)
    is_large = draws[2 * ns] <= LARGE_STEP_PROB
    u_mut = kern.mutate(ch.u, draws[ns:2 * ns], wh)
    u_prop = torch.where(is_large[None, :], draws[:ns], u_mut)
    prop_contribs, sc_prop = kern.sample(u_prop, wh)

    sc_cur = ch.sc
    a = torch.where(sc_cur > 0, torch.clamp(
        sc_prop / torch.where(sc_cur > 0, sc_cur, 1.0), 0.0, 1.0), 1.0)
    ilf = is_large.to(torch.float32)
    w_prop = torch.where(sc_prop > 0,
                         (a + ilf) / (sc_prop / b + LARGE_STEP_PROB), 0.0)
    w_cur_step = torch.where(sc_cur > 0,
                             (1.0 - a) / (sc_cur / b + LARGE_STEP_PROB), 0.0)
    w_acc = ch.w_acc + w_cur_step
    accept = draws[2 * ns + 1] <= a

    # deferred splat: the replaced current state, or the rejected proposal
    aw = accept.to(torch.float32)
    splat_w = aw * w_acc + (1.0 - aw) * w_prop
    _splat(ch.film, tuple(torch.where(accept[None, :], cc, p)
                          for cc, p in zip(ch.contribs, prop_contribs)),
           splat_w, kern.width, kern.height)
    return _Chains(
        film=ch.film,
        u=torch.where(accept[None, :], u_prop, ch.u),
        contribs=tuple(torch.where(accept[None, :], p, cc)
                       for cc, p in zip(ch.contribs, prop_contribs)),
        sc=torch.where(accept, sc_prop, sc_cur),
        w_acc=torch.where(accept, w_prop, w_acc))


def _save_checkpoint(path: str, ch: _Chains, b: float, blocks_done: int,
                     fingerprint: str) -> None:
    """Atomic snapshot of the chains and the brightness estimate."""
    leaves = [ch.film, ch.u, *ch.contribs, ch.sc, ch.w_acc]
    tmp = path + ".tmp.npz"
    np.savez(tmp, b=np.float64(b), blocks_done=np.int64(blocks_done),
             fingerprint=np.bytes_(fingerprint.encode()),
             **{f"leaf_{i}": t.cpu().numpy() for i, t in enumerate(leaves)})
    os.replace(tmp, path)


def _load_checkpoint(path: str, fingerprint: str, device):
    """(chains, b, blocks_done) from a matching snapshot at `path`, else
    None (missing, unreadable, or another render's fingerprint)."""
    if not path or not os.path.exists(path):
        return None
    try:
        data = np.load(path)
        if bytes(data["fingerprint"]).decode(errors="replace") \
                != fingerprint:
            return None
        leaves = [torch.as_tensor(data[f"leaf_{i}"], device=device)
                  for i in range(10)]
    except (OSError, ValueError, KeyError):
        return None
    ch = _Chains(film=leaves[0], u=leaves[1], contribs=tuple(leaves[2:8]),
                 sc=leaves[8], w_acc=leaves[9])
    return ch, float(data["b"]), int(data["blocks_done"])


def tonemap(film: np.ndarray, width: int, height: int, chains: int,
            mut_done: int) -> np.ndarray:
    """The exposure tone map (`Metropolis.cpp:110-124`): s = w h / the
    mutations done so far, so a partial film previews at full brightness;
    returns (H, W, 4) float32 RGBA, row 0 = top."""
    s = float(width * height) / float(max(1, chains * mut_done))
    rgb = np.power(np.clip(1.0 - np.exp(-film * s), 0.0, 1.0), 1.0 / 2.2)
    return np.concatenate([rgb, np.ones((height, width, 1), np.float32)],
                          axis=2).astype(np.float32)


def render_mlt(scene: Scene, chains: int = 1024, mutations: int = 256,
               n_init: int = 10000, seed: int = 0, max_path: int = None,
               checkpoint_path: str = None, device="cuda") -> np.ndarray:
    """The full MLT render (`mlt.py:929-1260`); returns (H, W, 4) float RGBA,
    row 0 = top.  The b-estimate, the chain init, then the mutations in
    blocks of min(mutations, NR_MLT_BLOCK = 128) steps: with
    `checkpoint_path` the chains and b are saved after each block, so an
    interrupted render resumes exactly; NR_MLT_PREVIEW_BLOCKS = k posts the
    tone-mapped partial film to the Screen after every k-th block.  Runs
    on the card unless `device` names the CPU."""
    dev = check_device(device)
    prep = _prepare_mlt(scene, dev, max_path)
    if prep is None:
        ro = scene.render_option
        return np.zeros((ro.height, ro.width, 4), np.float32)
    kern, width, height = prep
    ns = kern.n_states
    cap = film_bucket(width * height)
    block = min(mutations, int(os.environ.get("NR_MLT_BLOCK", "128")))
    n_blocks = max(1, mutations // block)
    from ..ops import mesh_cuda, mesh_mxu
    mesh_cuda.reset_route_counts()
    fingerprint = hashlib.sha1(repr(
        (kern.ss, kern.cam, kern.max_path, kern.emitted, kern.light_pos,
         kern.light_u, kern.light_v, kern.tri_bvh is not None,
         mesh_mxu.enabled(), chains, n_init, block, cap, width, height,
         mutations, seed)).encode()).hexdigest()
    logger = get_server().logger
    # each phase is a span "MetropolisLightTransport.<phase>" of GLOBAL_TIMER
    timer = GLOBAL_TIMER.scope("MetropolisLightTransport")
    wh = (float(width), float(height))
    with timer.phase("render"):
        loaded = (_load_checkpoint(checkpoint_path, fingerprint, dev)
                  if checkpoint_path else None)
        if loaded is not None:
            ch, b, start = loaded
            logger.log(f"MLT: resumed at block {start}/{n_blocks} "
                       f"(b = {b:.6g}) from {checkpoint_path}")
        else:
            start = 0
            with timer.phase("b-estimate"):
                steps = max(1, n_init // chains)
                total = 0.0
                for i in range(steps):
                    u = state_uniforms(ns, chains, i, 0,
                                       bounce_seed(seed, SEED_B), dev)
                    total += float(kern.sample(u, wh)[1].sum())
                b = total / (steps * chains)
            if not np.isfinite(b) or b <= 0:
                logger.warning("MLT: brightness estimate b <= 0")
                return np.zeros((height, width, 4), np.float32)
            logger.log(f"MLT: b = {b:.6g}")
            with timer.phase("chain-init"):
                u = state_uniforms(ns, chains, 0, 0,
                                   bounce_seed(seed, SEED_INIT), dev)
                contribs, sc = kern.sample(u, wh)
                zc = torch.zeros((chains,), device=dev)
                ch = _Chains(film=torch.zeros((cap + 1, 3), device=dev),
                             u=u, contribs=contribs, sc=sc, w_acc=zc)

        preview_every = int(os.environ.get("NR_MLT_PREVIEW_BLOCKS", "0"))
        m_seed = bounce_seed(seed, SEED_MUTATE)
        for i in range(start, n_blocks):
            with timer.phase("mutate-blocks"):
                for j in range(block):
                    ch = mutation_step(kern, ch, i * block + j, b, m_seed)
            if checkpoint_path:
                _save_checkpoint(checkpoint_path, ch, b, i + 1, fingerprint)
            if (preview_every > 0 and i + 1 < n_blocks
                    and (i + 1 - start) % preview_every == 0):
                with timer.phase("preview"):
                    part = _flush(ch, width, height)
                    get_server().screen.set(
                        tonemap(part, width, height, chains, (i + 1) * block),
                        width, height)
        with timer.phase("film-flush"):
            film = _flush(ch, width, height)
    total_mut = n_blocks * block
    # the flush waits for the device, so these phases cover the mutations
    dt = (timer.get("mutate-blocks").total_s
          + timer.get("film-flush").total_s)
    rate = chains * (total_mut - start * block) / max(dt, 1e-9) / 1e3
    logger.log(f"phases: {timer.summary()} ({rate:.1f} Kmut/s)")
    if kern.tri_bvh is not None:
        logger.log("MLT mesh sweeps: " + ", ".join(
            f"{k} {v}" for k, v in mesh_cuda.ENGINE_COUNTS.items()))
    return tonemap(film, width, height, chains, total_mut)


def _flush(ch: _Chains, width: int, height: int) -> np.ndarray:
    """The film with the current states splatted at their deferred
    weights, (H, W, 3) float32 on the host; the chains are unchanged."""
    film = ch.film.clone()
    _splat(film, ch.contribs, ch.w_acc, width, height)
    return film[:width * height].cpu().numpy().reshape(height, width, 3)


@register_renderer("MetropolisLightTransport", description=(
    "Metropolis Light Transport.\n"
    "Kelemen primary-sample-space MLT over bidirectional path tracing with "
    "MIS, as thousands of lockstep Markov chains in torch."))
class MetropolisRenderer(RenderComponent):
    def __init__(self, seed: int = 0, chains: int = None,
                 mutations: int = None, checkpoint_path: str = None,
                 device="cuda"):
        self.seed = seed
        self.chains = chains
        self.mutations = mutations
        self.checkpoint_path = checkpoint_path
        self.device = device

    def render(self, scene: Scene) -> RenderResult:
        dev = check_device(self.device)
        ro = scene.render_option
        chains = self.chains or int(os.environ.get("NR_MLT_CHAINS", "1024"))
        mutations = self.mutations or int(
            os.environ.get("NR_MLT_MUTATIONS", "256"))
        pixels = render_mlt(scene, chains=chains, mutations=mutations,
                            seed=self.seed,
                            checkpoint_path=self.checkpoint_path, device=dev)
        get_server().logger.log("Done...")
        return RenderResult(pixels=pixels, width=ro.width, height=ro.height)
