"""The path-tracing kernel: CUDA launch wrapper, plain torch version and
launch counters, for the kernel's ten forms.

Counterpart of `nrenderer_tpu/ops/pt_pallas.py` (`render_simple_pt_pallas`,
`render_pt_pallas_linear`, `render_bsdf_pt_pallas`): the diffuse estimator
(SimplePathTracer) or the five-lobe BSDF one (AccPathTracer), each without
or with an environment map; the BSDF one with the blocked mesh sweep in its
bounce loop (`mesh_accel`, AccPathTracer's megamesh route); and each of
those five with binned surface textures (`textures`).  The kernel,
`csrc/pt_kernel.cu`, replaces the Pallas `_pt_kernel` in those forms; its
source header says what it computes and how.  Every form without a mesh
(the dense, env and texture forms) runs one flat bounce loop per pixel with
path regeneration on a persistent grid (`pt_dense_kernel`), in launches of
`DENSE_PIXEL_SAMPLES_PER_LAUNCH`; the mesh forms run a flat loop around
the warp sweep whose lanes start their next samples in groups
(`pt_mesh_kernel`, `MESH_REGEN_EIGHTHS`), on a plain grid, in launches of
`PIXEL_SAMPLES_PER_LAUNCH` (`launch_plan`).  `loop_slots` counts the
loops' lane slots from the plain version's per-path bounce counts; on the
card the mesh forms count their own (`mesh_loop_slots`).

`pt_accumulate` is the wrapper: for a film tensor on a CUDA device it
launches the kernel instantiation the form needs (and raises if the build or
the launch fails); for a film on the CPU it runs `pt_accumulate_plain`, the
same estimator as torch ops over an (N,)-ray wavefront built from
`ops.camera`, `ops.intersect`, `ops.pt_core` and `ops.env`.  Both draw every
random number from `pt_core.hash_uniform` with the Pallas kernel's (pixel,
sample, draw, seed) numbering, so kernel, plain version and the JAX kernel
agree pixel by pixel up to float rounding.

Env-map form: a path that misses at bounce 0 reads the map's native texel
(the Pallas kernel's exact bounce-0 term); a later miss records its
throughput and direction, and one lookup in the mean-pooled 32x128 bin table
per sample follows the bounce loop, as in the Pallas kernel (the CUDA
kernel looks the bin up at the miss: the same sum).  Both index
with the Pallas kernel's polynomial angles (`ops.env`).

Mesh form: the dense pass runs without triangles and the sweep
(`mesh_cuda`) runs over the mesh tables with the dense hit's t as its cap,
in natural block order; on the card its kernel (`pt_mesh_kernel`) runs
the warp-cooperative sweep, with the same film.  Texture form: hits carry
(u, v, texture id), from a dense triangle's UV row or from the sweep,
resolved against the binned (n_tex, 3, 32, 128) tables
(`ops/texture.py`).  The mesh and texture
tables are packed once per render (`make_mesh_tables`, `make_tex_tables`),
like the env tables.

Both add into a linear film SUM in place and sample by sample, so a render
split into several calls over consecutive sample ranges gives the same sums
as one call.  Entry points return the JAX contract: `render_simple_pt` /
`render_bsdf_pt` an (H, W, 3) gamma'd image with row 0 = bottom,
`render_pt_linear` the (W*H, 3) linear SUM."""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from .camera import CameraParams, shoot_v3
from .env import (
    ENV_LANES, ENV_ROWS, bin_env_map, env_bin_lookup, env_native_lookup,
    sample_env_map_v3,
)
from .intersect import StaticScene, intersect_scene_unrolled, np_dot
from .mesh_cuda import WARP, MeshTables, check_tables, make_mesh_tables, \
    schedule_counts, sweep_mesh_plain
from .pt_core import (
    PI, bounce_seed, bsdf_bounce, diffuse_bounce, effective_lobe,
    finish_ambient, hash_uniform, lobe_order, make_mat_channels,
    scene_epsilon,
)
from .soa import V3, normalize3
from .texture import TEX_LANES, TEX_ROWS, make_tex_resolver, tex_tables

KERNEL_SOURCE = "nrenderer_torch/csrc/pt_kernel.cu"
_PALLAS = "nrenderer_tpu/ops/pt_pallas.py:123 _pt_kernel"

# The kernel's instantiations by (bsdf, env, mesh, textures), and the
# Pallas form each replaces.  The mesh form exists with the BSDF estimator
# only (the JAX renderers send meshes to the megakernel from AccPathTracer
# alone) and without an env map (the JAX kernel refuses env + mesh).
KERNELS = {
    (False, False, False, False): "pt_diffuse_kernel",
    (True, False, False, False): "pt_bsdf_kernel",
    (False, True, False, False): "pt_diffuse_env_kernel",
    (True, True, False, False): "pt_bsdf_env_kernel",
    (True, False, True, False): "pt_bsdf_mesh_kernel",
    (False, False, False, True): "pt_diffuse_tex_kernel",
    (True, False, False, True): "pt_bsdf_tex_kernel",
    (False, True, False, True): "pt_diffuse_env_tex_kernel",
    (True, True, False, True): "pt_bsdf_env_tex_kernel",
    (True, False, True, True): "pt_bsdf_mesh_tex_kernel",
}
_FORM = {
    (False, False, False): "bsdf=False",
    (True, False, False): "bsdf=True",
    (False, True, False): "bsdf=False, env_rows/env_exact",
    (True, True, False): "bsdf=True, env_rows/env_exact",
    (True, False, True): "bsdf=True, mesh=(n_blocks, b)",
}
REPLACES = {
    name: f"{_PALLAS}, {_FORM[key[:3]]}"
    + (", n_tex > 0" + (", mesh_uv" if key[2] else "") if key[3] else "")
    for key, name in KERNELS.items()}

# The hybrid route's bounce on a card: the kernels `wavefront_dense_hit`
# and `wavefront_shade` launch around the mesh pipe.
WAVEFRONT_KERNELS = ("wavefront_dense_hit_kernel", "wavefront_shade_kernel")

# Kernel launches made by `pt_accumulate` (one per spp chunk), by
# instantiation name (the texture forms counted apart), by the wavefront
# wrappers (one a call) and by `hash_uniform_fill`.  Plain integers: a
# caller resets and reads them to show that a run went through the
# kernels.
KERNEL_LAUNCHES = {name: 0 for name in (*KERNELS.values(),
                                        *WAVEFRONT_KERNELS)}
HASH_LAUNCHES = 0


def reset_launch_counts() -> None:
    global HASH_LAUNCHES
    for name in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[name] = 0
    HASH_LAUNCHES = 0


# One launch of the mesh forms covers at most this many pixel-samples (a
# 500x500 film takes 33 spp per launch); the plain version traces at most
# this many rays per wavefront.
PIXEL_SAMPLES_PER_LAUNCH = 1 << 23
PLAIN_RAYS_PER_WAVEFRONT = 1 << 20
# The launch size of the forms without a mesh (pt_dense_kernel's flat
# loop): 256 spp of a 512x512 film.  The loop sums each pixel's samples in
# one lane, so more samples a launch even out the warp's lanes (89% of lane
# slots useful at 256 spp, 77% at 32 on the Cornell box); 512 measured no
# faster than 256 on an H100 (PERF.md §6).
DENSE_PIXEL_SAMPLES_PER_LAUNCH = 1 << 26

# The dense pass's size limit: the kernel tests dense triangles one by one,
# so a scene past this count belongs to the mesh engines.  The JAX
# package's brute-force limit (its AccPathTracer's ACC_TYPE0_MAX_TRIS).
MAX_TRIS = 2048

# Packed scene-table strides; csrc/pt_kernel.cu reads the same layout.  A
# material row is the first 20 `make_mat_channels` floats, its effective
# lobe and its specular-map id; a dense UV row (texture forms) is uv1, the
# two uv edges and the texture id.
SPH_STRIDE, TRI_STRIDE, PLN_STRIDE, AL_STRIDE, MAT_STRIDE = 6, 13, 14, 16, 22
UV_STRIDE = 7
CAM_FLOATS = 22

_bound = None


def kernel_name(bsdf: bool, env: bool, mesh: bool = False,
                tex: bool = False) -> str:
    key = (bool(bsdf), bool(env), bool(mesh), bool(tex))
    if key not in KERNELS:
        raise NotImplementedError(
            "the path-tracing kernel's mesh form runs the BSDF estimator "
            "without an env map: env-map mesh scenes take the hybrid mesh "
            "route (renderers/acc_pt.py, the staged wavefront with the "
            "standalone sweep and the streaming compactor)")
    return KERNELS[key]


def check_device(device) -> torch.device:
    """`device` as a torch.device; raises for CUDA without a usable GPU
    (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False: no GPU to run the path-tracing kernel on")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def check_supported(ss: StaticScene, mesh: bool = False) -> None:
    """Refuse scenes that need a kernel form the port lacks: a dense pass
    past MAX_TRIS triangles (without a mesh sweep to take them)."""
    if not mesh and len(ss.tri) > MAX_TRIS:
        raise NotImplementedError(
            f"{len(ss.tri)} triangles is past the dense kernel's limit "
            f"of {MAX_TRIS}: such pools take AccPathTracer's mesh routes "
            "(renderers/acc_pt.py; past 1024 triangles the hybrid mesh "
            "route)")


class EnvTables(NamedTuple):
    """An env map as the kernel reads it, float32 on one device."""
    bins: torch.Tensor    # (3, ENV_ROWS, ENV_LANES) mean-pooled bin table
    native: torch.Tensor  # (He, We, 3) the map itself


def make_env_tables(env_map, device) -> EnvTables:
    """`env_map` ((He, We, 3) float array) -> EnvTables on `device`."""
    e = np.ascontiguousarray(np.asarray(env_map, np.float32)[..., :3])
    if e.ndim != 3 or e.shape[0] < 1 or e.shape[1] < 1 \
            or e.size >= 1 << 31:
        raise ValueError(f"unsupported env map shape {e.shape}")
    return EnvTables(
        bins=torch.as_tensor(bin_env_map(e, ENV_ROWS, ENV_LANES),
                             device=device),
        native=torch.as_tensor(e, device=device))


def pack_scene(ss: StaticScene, mesh: bool = False, with_uv: bool = False):
    """The kernel's float32 scene table and its counts
    (n_sph, n_tri, n_pln, n_al, n_mat).  Constants are rounded to float32
    exactly where the plain form rounds them: r*r and 1/r in double, the
    plane offset dot(pos, n) in float32 (`intersect.np_dot`).  Each
    material row ends with its effective lobe (`pt_core.effective_lobe`),
    so the kernel switches on one integer, and the specular-map id of the
    `stex` channel (-1 without one).  A primitive's material id is the row
    the plain form's `mat_channels[m]` reads (a negative id counts from
    the end, as Python indexes).

    `mesh`: the mesh form's dense pass, without triangles.  `with_uv`: a
    UV row per triangle follows the ambient (the texture forms)."""
    n_mat = len(ss.mats)
    row_of = lambda m: m + n_mat if m < 0 else m
    tris = [] if mesh else ss.tri
    rows = []
    for (cx, cy, cz, r, m) in ss.sph:
        rows.append([cx, cy, cz, r * r, 1.0 / r, row_of(m)])
    for (v1, e1, e2, n, m) in tris:
        rows.append([*v1, *e1, *e2, *n, row_of(m)])
    for (pos, n, inv0, inv1, m) in ss.pln:
        rows.append([*pos, *n, *inv0, *inv1, np_dot(pos, n), row_of(m)])
    for (pos, n, inv0, inv1, rad) in ss.al:
        rows.append([*pos, *n, *inv0, *inv1, np_dot(pos, n), *rad])
    lobes = lobe_order(ss)
    for ch in make_mat_channels(ss):
        stex = ch[20] if len(ch) > 20 else -1.0
        rows.append([*ch[:20], effective_lobe(ch[0], lobes), stex])
    rows.append(list(ss.ambient_constant))
    if with_uv:
        for ti in range(len(tris)):
            uv = ss.tri_uv[ti] if ti < len(ss.tri_uv) else None
            if uv is not None and (uv[6] >= 0 or uv[7] >= 0):
                rows.append(list(uv[:7]))
            else:
                rows.append([0.0] * 6 + [-1.0])
    table = np.asarray([float(x) for row in rows for x in row], np.float32)
    counts = (len(ss.sph), len(tris), len(ss.pln), len(ss.al), n_mat)
    return table, counts


# The diffuse form's primitive records (csrc/pt_kernel.cu reads them in
# float4 loads): each primitive's table row padded to whole float4s (4
# floats each), spheres, triangles, planes, lights.
SPH_REC, TRI_REC, PLN_REC, AL_REC = 2, 4, 4, 4


def dense_records(table: np.ndarray, counts) -> np.ndarray:
    """The primitive rows of `pack_scene`'s table (without mesh or UV
    rows), each padded with zeros to SPH_REC / TRI_REC / PLN_REC / AL_REC
    float4s, as one float32 array (at least one record)."""
    n_sph, n_tri, n_pln, n_al, _ = counts
    out, at = [], 0
    for n, stride, recs in ((n_sph, SPH_STRIDE, SPH_REC),
                            (n_tri, TRI_STRIDE, TRI_REC),
                            (n_pln, PLN_STRIDE, PLN_REC),
                            (n_al, AL_STRIDE, AL_REC)):
        rows = np.zeros((n, 4 * recs), np.float32)
        rows[:, :stride] = table[at:at + n * stride].reshape(n, stride)
        out.append(rows.reshape(-1))
        at += n * stride
    out.append(np.zeros(4, np.float32))
    return np.concatenate(out)


def table_size(counts, with_uv: bool = False) -> int:
    n_sph, n_tri, n_pln, n_al, n_mat = counts
    return (n_sph * SPH_STRIDE + n_tri * TRI_STRIDE + n_pln * PLN_STRIDE
            + n_al * AL_STRIDE + n_mat * MAT_STRIDE + 3
            + (n_tri * UV_STRIDE if with_uv else 0))


def make_tex_tables(textures, device) -> torch.Tensor:
    """(H, W, 3) textures -> the binned (n_tex, 3, TEX_ROWS, TEX_LANES)
    float32 tables on `device`, once per render."""
    return torch.as_tensor(tex_tables(textures), device=device)


def camera_floats(cam: CameraParams, width: int, height: int,
                  t_min: float) -> list:
    """The kernel's camera arguments: basis, lens radius, t_min, 1/W, 1/H."""
    vals = []
    for v in (cam.position, cam.lower_left, cam.horizontal, cam.vertical,
              cam.u, cam.v):
        vals += [float(x) for x in v.detach().cpu().reshape(-1).tolist()]
    vals += [float(cam.lens_radius), float(t_min), 1.0 / width,
             1.0 / height]
    assert len(vals) == CAM_FLOATS
    return vals


def _int32(x: int) -> int:
    return (int(x) + (1 << 31)) % (1 << 32) - (1 << 31)


def _kernels() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    global _bound
    if _bound is None:
        from .. import _build
        lib = _build.load_library()
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nr_pt_render.argtypes = [
            vp, vp, ctypes.POINTER(ci), ctypes.POINTER(ctypes.c_float),
            ci, ci, ci, ci, ci, ci, ci, ci, ci, vp, vp, ci, ci, vp, vp, vp,
            ci, ci, vp, ci, vp, vp, vp, vp]
        lib.nr_pt_render.restype = ci
        lib.nr_hash_uniform_fill.argtypes = [vp, vp, vp, vp, vp, ci, vp]
        lib.nr_hash_uniform_fill.restype = ci
        lib.nr_wavefront_dense_hit.argtypes = [
            vp, ctypes.POINTER(ci), ctypes.c_float, ctypes.POINTER(vp), vp,
            vp, ci, vp]
        lib.nr_wavefront_dense_hit.restype = ci
        lib.nr_wavefront_shade.argtypes = [
            vp, ctypes.POINTER(ci), ctypes.c_float, ctypes.POINTER(vp), vp,
            ctypes.POINTER(vp), vp, ci, ci, ci, ci, ci, vp, ci, ci, vp]
        lib.nr_wavefront_shade.restype = ci
        lib.nr_layout.argtypes = [ci]
        lib.nr_layout.restype = ci
        lib.nr_error_string.argtypes = [ci]
        lib.nr_error_string.restype = ctypes.c_char_p
        want = (CAM_FLOATS, MAT_STRIDE, ENV_ROWS, ENV_LANES, UV_STRIDE,
                TEX_ROWS, TEX_LANES)
        if tuple(lib.nr_layout(i) for i in range(len(want))) != want:
            raise RuntimeError("kernel library table layout mismatch")
        _bound = lib
    return _bound


def _check_launch(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.nr_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err}: {msg}")


def _check_sizes(width, height, sp0, n_spp, depth) -> None:
    """Sizes the kernel can index with int32 (film index 3 * pid, sample
    ids up to sp0 + n_spp)."""
    if width < 1 or height < 1 or 3 * width * height >= 1 << 31:
        raise ValueError(f"unsupported film size {width}x{height}")
    if sp0 < 0 or n_spp < 0 or depth < 0 or sp0 + n_spp >= 1 << 31:
        raise ValueError(f"unsupported sample range [{sp0}, {sp0 + n_spp}) "
                         f"or depth {depth}")


def pixel_range(width: int, height: int, pix0: int,
                n_pix: Optional[int]) -> int:
    """The pixel count of the range [pix0, pix0 + n_pix) of a W x H film
    (all of it from pix0 when `n_pix` is None); raises if it leaves the
    film or is empty."""
    n = width * height - pix0 if n_pix is None else n_pix
    if pix0 < 0 or n < 1 or pix0 + n > width * height:
        raise ValueError(f"pixel range [{pix0}, {pix0 + n}) is not inside "
                         f"a {width}x{height} film")
    return n


def _check_film(film: torch.Tensor, n_pix: int) -> None:
    if film.dtype != torch.float32 or tuple(film.shape) != (n_pix, 3) \
            or not film.is_contiguous():
        raise ValueError(
            f"film must be a contiguous float32 ({n_pix}, 3) tensor, got "
            f"{film.dtype} {tuple(film.shape)}")


def _check_env(env: EnvTables, device: torch.device) -> None:
    bins, native = env
    ok = (bins.dtype == native.dtype == torch.float32
          and tuple(bins.shape) == (3, ENV_ROWS, ENV_LANES)
          and native.dim() == 3 and native.shape[2] == 3
          and bins.is_contiguous() and native.is_contiguous()
          and bins.device == native.device == device)
    if not ok:
        raise ValueError("env tables must be contiguous float32 (3, "
                         f"{ENV_ROWS}, {ENV_LANES}) and (He, We, 3) tensors "
                         f"on the film's device {device}")


def _check_tex(tex: torch.Tensor, device: torch.device) -> None:
    if (tex.dtype != torch.float32 or tex.dim() != 4
            or tuple(tex.shape[1:]) != (3, TEX_ROWS, TEX_LANES)
            or tex.shape[0] < 1 or not tex.is_contiguous()
            or tex.device != device):
        raise ValueError(f"texture tables must be a contiguous float32 "
                         f"(n_tex, 3, {TEX_ROWS}, {TEX_LANES}) tensor with "
                         f"n_tex >= 1 on the film's device {device}")


def pt_accumulate(film: torch.Tensor, ss: StaticScene, cam: CameraParams,
                  width: int, height: int, sp0: int, n_spp: int, depth: int,
                  seed: int, t_min: float, bsdf: bool = False,
                  env: Optional[EnvTables] = None,
                  mesh: Optional[MeshTables] = None,
                  tex: Optional[torch.Tensor] = None, *, pix0: int = 0,
                  n_pix: Optional[int] = None) -> torch.Tensor:
    """Add samples [sp0, sp0 + n_spp) of every pixel into the linear film
    ((W*H, 3) float32) IN PLACE; returns `film`.  With `pix0`/`n_pix` only
    pixels [pix0, pix0 + n_pix) are traced and `film` is (n_pix, 3), row i
    pixel pix0 + i: the hash and the camera keep the global pixel id, so a
    range equals those rows of the full film bit for bit.  `bsdf`:
    AccPathTracer's five-lobe estimator instead of the diffuse one; `env`:
    env-map misses; `mesh`: the triangle pool goes through the blocked sweep (`ss`'s
    triangles are that pool and the dense pass skips them); `tex`: binned
    texture tables (`make_tex_tables`).  With a mesh, textures need its UV
    tables.  A CUDA film goes through the kernel, a CPU film through the
    plain version."""
    name = kernel_name(bsdf, env is not None, mesh is not None,
                       tex is not None)
    check_supported(ss, mesh=mesh is not None)
    _check_sizes(width, height, sp0, n_spp, depth)
    n_pix = pixel_range(width, height, pix0, n_pix)
    _check_film(film, n_pix)
    if env is not None:
        _check_env(env, film.device)
    if mesh is not None:
        check_tables(mesh, film.device)
        if tex is not None and mesh.uvs is None:
            raise ValueError("textures on a mesh need its UV tables")
    if tex is not None:
        _check_tex(tex, film.device)
    if film.device.type == "cuda":
        _pt_accumulate_cuda(film, ss, cam, width, height, sp0, n_spp, depth,
                            seed, t_min, name, bsdf, env, mesh, tex, pix0,
                            n_pix)
    elif film.device.type == "cpu":
        pt_accumulate_plain(film, ss, cam, width, height, sp0, n_spp, depth,
                            seed, t_min, bsdf=bsdf, env=env, mesh=mesh,
                            tex=tex, pix0=pix0, n_pix=n_pix)
    else:
        raise ValueError(f"unsupported film device {film.device}")
    return film


def launch_plan(mesh: bool, n_pix: int) -> tuple:
    """(persistent, spp a launch) of a wrapper call over `n_pix` pixels:
    the forms without a mesh run the flat loop on a persistent grid, with
    a pixel counter cleared before each launch, in launches of
    DENSE_PIXEL_SAMPLES_PER_LAUNCH pixel-samples; the mesh forms a plain
    grid of PIXEL_SAMPLES_PER_LAUNCH.  At least one sample a launch."""
    per = PIXEL_SAMPLES_PER_LAUNCH if mesh else DENSE_PIXEL_SAMPLES_PER_LAUNCH
    return not mesh, max(1, per // n_pix)


# The mesh forms' regeneration share (csrc/pt_kernel.cu kRegenEighths): a
# lane whose path ended waits until this many eighths of the warp's lanes
# with samples left wait, then they start their next samples together.
MESH_REGEN_EIGHTHS = 4

# The mesh forms' loop counters, one (2,) int64 tensor a device, allocated
# at the first mesh launch there: the lane slots the loop ran and those
# of lanes with a path, added by each warp as it leaves.
_LOOP_SLOTS = {}
_LOOP_SLOTS_LOCK = threading.Lock()


def _loop_slot_counters(device: torch.device) -> torch.Tensor:
    with _LOOP_SLOTS_LOCK:
        key = str(device)
        if key not in _LOOP_SLOTS:
            _LOOP_SLOTS[key] = torch.zeros(2, dtype=torch.int64,
                                           device=device)
        return _LOOP_SLOTS[key]


def mesh_loop_slots(device="cuda", reset: bool = False) -> Optional[dict]:
    """The mesh forms' loop counters on a CUDA `device` since the first
    mesh launch there (or the last reset): "slots", the lane slots their
    loop ran (32 a warp iteration), "live", those of lanes with a path
    (the bounces, as the plain version's stats count them), and
    "live_share".  Synchronises the device; None without a card or before
    any mesh launch there.  `reset` zeroes them after reading.  Raises
    ValueError for a device that is not CUDA."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the loop counters live on a CUDA device, not "
                         f"{dev}")
    if not torch.cuda.is_available():
        return None
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    counters = _LOOP_SLOTS.get(str(dev))
    if counters is None:
        return None
    torch.cuda.synchronize(dev)
    slots, live = (int(x) for x in counters.tolist())
    if reset:
        counters.zero_()
    return {"slots": slots, "live": live,
            "live_share": live / slots if slots else 0.0}


def _pt_accumulate_cuda(film, ss, cam, width, height, sp0, n_spp, depth,
                        seed, t_min, name, bsdf, env, mesh, tex, pix0,
                        n_pix) -> None:
    lib = _kernels()
    with_uv = tex is not None
    table, counts = pack_scene(ss, mesh=mesh is not None, with_uv=with_uv)
    if table.size != table_size(counts, with_uv):
        raise ValueError("scene table size does not match its counts")
    tab = torch.as_tensor(table, device=film.device)
    cnt = (ctypes.c_int * 5)(*counts)
    camf = (ctypes.c_float * CAM_FLOATS)(
        *camera_floats(cam, width, height, t_min))
    if env is None:
        env_bin = env_map = None
        env_h = env_w = 0
    else:
        env_bin, env_map = env.bins.data_ptr(), env.native.data_ptr()
        env_h, env_w = env.native.shape[0], env.native.shape[1]
    if mesh is None:
        m_tris = m_uvs = m_bb = None
        n_blocks = block = 0
    else:
        m_tris, m_bb = mesh.tris.data_ptr(), mesh.bb.data_ptr()
        m_uvs = mesh.uvs.data_ptr() if with_uv else None
        n_blocks, block = mesh.n_blocks, mesh.block
    tex_ptr, n_tex = (None, 0) if tex is None else (tex.data_ptr(),
                                                    tex.shape[0])
    form = (int(bool(bsdf)) | (env is not None) << 1
            | (mesh is not None) << 2 | with_uv << 3)
    persistent, per_launch = launch_plan(mesh is not None, n_pix)
    # the persistent grid's pixel counter, and B1a's primitive records
    next_pixel = torch.zeros(1, dtype=torch.int32, device=film.device) \
        if persistent else None
    rec = torch.as_tensor(dense_records(table, counts), device=film.device) \
        if form == 0 else None
    slots = None if mesh is None else _loop_slot_counters(film.device)
    with torch.cuda.device(film.device):
        stream = torch.cuda.current_stream().cuda_stream
        for c0 in range(0, n_spp, per_launch):
            n = min(per_launch, n_spp - c0)
            err = lib.nr_pt_render(film.data_ptr(), tab.data_ptr(), cnt,
                                   camf, width, height, pix0, n_pix,
                                   sp0 + c0, n, depth,
                                   _int32(seed), form, env_bin, env_map,
                                   env_h, env_w, m_tris, m_uvs, m_bb,
                                   n_blocks, block, tex_ptr, n_tex,
                                   None if next_pixel is None
                                   else next_pixel.data_ptr(),
                                   None if rec is None else rec.data_ptr(),
                                   None if slots is None
                                   else slots.data_ptr(), stream)
            _check_launch(lib, err, name)
            KERNEL_LAUNCHES[name] += 1


def camera_rays(cam: CameraParams, pid: torch.Tensor, sp: torch.Tensor,
                 seed: int, width: int, height: int):
    """Jittered camera rays with the Pallas kernel's draws (0-3) and op
    order, for pixel ids `pid` and sample indices `sp`."""
    py = pid // width
    pxf = (pid - py * width).to(torch.float32)
    pyf = py.to(torch.float32)
    rx = hash_uniform(pid, sp, 0, seed) * 2.0 - 1.0
    ry = hash_uniform(pid, sp, 1, seed) * 2.0 - 1.0
    s = (pxf + rx) * (1.0 / width)
    t = (pyf + ry) * (1.0 / height)
    lens_r = float(cam.lens_radius)
    if lens_r <= 0.0:
        return shoot_v3(cam, s, t)
    # thin lens: uniform disk via polar map, offset along the camera's u, v
    lr = torch.sqrt(hash_uniform(pid, sp, 2, seed)) * lens_r
    phi = hash_uniform(pid, sp, 3, seed) * (2.0 * PI)
    du = lr * torch.cos(phi)
    dv = lr * torch.sin(phi)
    p, u, v = cam.position, cam.u, cam.v
    o = V3(p[0] + du * u[0] + dv * v[0], p[1] + du * u[1] + dv * v[1],
           p[2] + du * u[2] + dv * v[2])
    ll, h, vt = cam.lower_left, cam.horizontal, cam.vertical
    d = normalize3(V3(ll[0] + s * h[0] + t * vt[0] - o.x,
                      ll[1] + s * h[1] + t * vt[1] - o.y,
                      ll[2] + s * h[2] + t * vt[2] - o.z))
    return o, d


def pt_accumulate_plain(film: torch.Tensor, ss: StaticScene,
                        cam: CameraParams, width: int, height: int, sp0: int,
                        n_spp: int, depth: int, seed: int, t_min: float,
                        bsdf: bool = False, env: Optional[EnvTables] = None,
                        mesh: Optional[MeshTables] = None,
                        tex: Optional[torch.Tensor] = None,
                        stats: Optional[dict] = None, *, pix0: int = 0,
                        n_pix: Optional[int] = None) -> torch.Tensor:
    """The kernel's plain torch version, on any device: adds samples
    [sp0, sp0 + n_spp) into `film` in place, in sample order, for pixels
    [pix0, pix0 + n_pix) (all by default; `film` holds that range's rows).

    With `env`, bounce 0 runs first on its own and its misses add
    throughput * the native texel; later misses record throughput and
    direction, and one binned lookup per sample follows the loop (the
    Pallas kernel's env bookkeeping, `pt_pallas.py:292-345`).  The env form
    runs bounce 0 even at depth 0, as the Pallas kernel peels it.

    With `mesh`, each bounce's closest hit runs the dense primitives
    without triangles, then `mesh_cuda.sweep_mesh_plain` capped by the
    dense hit (`pt_core.closest_hit`); with `tex`, hits resolve their
    colours through `texture.make_tex_resolver`.

    `stats` (a dict, optional) counts the work the kernel does on these
    inputs: "samples" and "bounces" (bounce iterations of live paths),
    "path_bounces" (each path's bounce iterations, an (n_pix, samples)
    int32 tensor in sample order; a later call's columns follow an earlier
    one's; `loop_slots` reads it), and
    with a mesh the sweep's "slab_tests" and "tri_tests"; with a mesh and a
    list under "enter", "schedule" holds `mesh_cuda.schedule_counts` of
    the sweeps grouped as two loops would run them: "lockstep" (the warp's
    lanes at the same sample and bounce, ended paths waiting for the
    warp's longest: the nested loop) and "flat" (each lane at its own
    bounce count, starting its next sample as soon as a path ends)."""
    dev = film.device
    cam = CameraParams(*(x.to(dev) for x in cam))
    n_pix = pixel_range(width, height, pix0, n_pix)
    if bsdf:
        mat_ch = make_mat_channels(ss)
    else:
        mat_ch = [tuple(float(v) for v in m["diffuse"]) for m in ss.mats]
    textures = None if tex is None else make_tex_resolver(tex.to(dev))
    tri_bvh = None
    if mesh is not None:
        def tri_bvh(o, d, t_cap):
            return sweep_mesh_plain(mesh, o, d, t_min, t_cap,
                                    with_uv=textures is not None,
                                    stats=stats)
    n_bounces = max(depth, 1) if env is not None else depth
    chunk = max(1, min(n_spp, PLAIN_RAYS_PER_WAVEFRONT // n_pix))
    pid1 = torch.arange(pix0, pix0 + n_pix, dtype=torch.int64, device=dev)
    sched = [] if mesh is not None and stats is not None \
        and "enter" in stats else None
    it0 = torch.zeros(n_pix, dtype=torch.int64, device=dev)
    for c0 in range(0, n_spp, chunk):
        c = min(chunk, n_spp - c0)
        sp = torch.arange(sp0 + c0, sp0 + c0 + c, dtype=torch.int64,
                          device=dev).repeat_interleave(n_pix)
        pid = pid1.repeat(c)
        o, d = camera_rays(cam, pid, sp, seed, width, height)
        ones = torch.ones_like(o.x)
        zeros = torch.zeros_like(o.x)
        thr = V3(ones, ones, ones)
        rad = V3(zeros, zeros, zeros)
        thr_m = V3(zeros, zeros, zeros)   # throughput at a miss (b > 0)
        d_m = V3(zeros, zeros, ones)      # direction at that miss
        alive = torch.ones_like(o.x, dtype=torch.bool)
        alive_at = []
        path_nb = None if stats is None else torch.zeros(
            c * n_pix, dtype=torch.int32, device=dev)
        for b in range(n_bounces):
            if stats is not None:
                stats["bounces"] = stats.get("bounces", 0) + int(alive.sum())
                path_nb += alive
            if sched is not None:
                alive_at.append(alive)
            bseed = bounce_seed(seed, b)
            u1 = hash_uniform(pid, sp, 4, bseed)
            u2 = hash_uniform(pid, sp, 5, bseed)
            if bsdf:
                u3 = hash_uniform(pid, sp, 6, bseed)
                out = bsdf_bounce(ss, mat_ch, o, d, thr, rad, alive, u1, u2,
                                  u3, t_min=t_min, tri_bvh=tri_bvh,
                                  with_miss=env is not None,
                                  textures=textures)
            else:
                out = diffuse_bounce(ss, mat_ch, o, d, thr, rad, alive, u1,
                                     u2, t_min=t_min, tri_bvh=tri_bvh,
                                     with_miss=env is not None,
                                     textures=textures)
            if env is None:
                o, d, thr, rad, alive = out
                continue
            o, d, thr, rad, alive, miss = out
            mw = miss.to(torch.float32)
            if b == 0:   # misses keep their camera d and throughput
                e0 = env_native_lookup(env.native, d)
                rad = V3(rad.x + mw * thr.x * e0.x,
                         rad.y + mw * thr.y * e0.y,
                         rad.z + mw * thr.z * e0.z)
            else:
                thr_m = V3(thr_m.x + mw * thr.x, thr_m.y + mw * thr.y,
                           thr_m.z + mw * thr.z)
                keep = 1.0 - mw
                d_m = V3(d_m.x * keep + mw * d.x, d_m.y * keep + mw * d.y,
                         d_m.z * keep + mw * d.z)
        if env is not None:
            e = env_bin_lookup(env.bins, d_m)
            rad = V3(rad.x + thr_m.x * e.x, rad.y + thr_m.y * e.y,
                     rad.z + thr_m.z * e.z)
        rad = finish_ambient(ss, thr, rad, alive)
        if sched is not None:
            enters = [stats["enter"].pop() for _ in alive_at][::-1]
            it0 = _sweep_groups(sched, enters, alive_at, it0, c0, c, n_pix,
                                n_spp, n_bounces)
        if stats is not None:
            stats["samples"] = stats.get("samples", 0) + c * n_pix
            cols = path_nb.reshape(c, n_pix).T
            prev = stats.get("path_bounces")
            stats["path_bounces"] = (cols.contiguous() if prev is None
                                     else torch.cat([prev, cols], dim=1))
        samples = torch.stack([rad.x, rad.y, rad.z], dim=-1).reshape(
            c, n_pix, 3)
        for k in range(c):  # one sample after another, as the kernel adds
            film += samples[k]
    if sched:
        enter = torch.cat([e for e, _, _ in sched])
        stats["schedule"] = {
            name: schedule_counts(enter, torch.cat([g[j] for _, *g in sched]),
                                  mesh.block)
            for j, name in enumerate(("lockstep", "flat"))}
    return film


def _sweep_groups(sched: list, enters: list, alive_at: list,
                  it0: torch.Tensor, c0: int, c: int, n_pix: int, n_spp: int,
                  n_bounces: int) -> torch.Tensor:
    """Append to `sched` each live ray's sweep steps of one wavefront chunk
    (samples c0 .. c0 + c, one `enters` matrix per bounce) with its two
    groups: lockstep (sample, bounce, warp) and flat (warp, iteration),
    where a lane's iteration counts the bounces of its earlier samples
    (`it0` before the chunk; returned after it)."""
    alive = torch.stack(alive_at)                      # (bounces, c * n_pix)
    nb = alive.sum(dim=0).reshape(c, n_pix)
    start = it0[None, :] + torch.cumsum(nb, dim=0) - nb
    n_warps = -(-n_pix // WARP)
    for b, enter in enumerate(enters):
        rows = torch.nonzero(alive[b]).flatten()
        k, p = rows // n_pix, rows % n_pix
        lockstep = ((c0 + k) * n_bounces + b) * n_warps + p // WARP
        flat = (p // WARP) * (n_spp * n_bounces) + start[k, p] + b
        sched.append((enter[rows], lockstep, flat))
    return it0 + nb.sum(dim=0)


def loop_slots(path_bounces: torch.Tensor, launch_spp: int,
               resident: Optional[int] = None,
               regen: Optional[int] = None) -> dict:
    """Lane slots (one lane for one bounce iteration) of the path-tracing
    kernel's bounce loops, from each path's bounce count (`path_bounces`,
    the (n_pix, n_spp) tensor of `pt_accumulate_plain`'s stats), with pixel
    p in lane p % 32 of warp p // 32; a ragged last warp's missing lanes
    count as idle slots.  A slot is one iteration of one lane whether or
    not it has a path: in the mesh forms every lane of a warp runs every
    iteration (the warp sweep needs all 32), so their slots are the
    warp's iterations times 32 in the same way:

    - "useful": the bounces themselves, the sum of the counts;
    - "nested": a loop over samples around a loop over bounces, the warp's
      lanes at one sample (the kernel before the flat loop): per warp and
      sample, 32 x the warp's longest path;
    - "flat": one loop whose iteration is a bounce of whichever sample a
      lane is on, `launch_spp` samples a launch: per warp and launch, 32 x
      the largest total over the warp's lanes;
    - "persistent", with `resident` lanes (a multiple of 32): the flat loop
      with each lane taking its next pixel from a counter when it has done
      one, in the order lanes become free (ties by lane); per warp and
      launch, 32 x the largest total over its lanes;
    - "grouped", with `regen` (eighths; the mesh forms'
      MESH_REGEN_EIGHTHS): the mesh forms' loop, where a lane whose path
      ended waits and the waiting lanes start their next samples together
      once 8 x waiting >= regen x (lanes with samples left), per warp and
      launch (regen 0 is the flat loop, 8 the nested one).

    "<loop>_share" is useful / slots."""
    n_pix, n_spp = path_bounces.shape
    n_warps = -(-n_pix // WARP)
    pb = torch.zeros((n_warps * WARP, n_spp), dtype=torch.int64)
    pb[:n_pix] = path_bounces.cpu()
    per_warp = pb.reshape(n_warps, WARP, n_spp)
    out = {"useful": int(pb.sum()),
           "nested": WARP * int(per_warp.amax(dim=1).sum()), "flat": 0}
    if resident is not None:
        out["persistent"] = 0
    if regen is not None:
        out["grouped"] = 0
    for s0 in range(0, n_spp, launch_spp):
        if regen is not None:
            out["grouped"] += _grouped_slots(
                per_warp[:, :, s0:s0 + launch_spp], regen)
        tot = pb[:, s0:s0 + launch_spp].sum(dim=1)
        out["flat"] += WARP * int(tot.reshape(n_warps, WARP).amax(dim=1)
                                  .sum())
        if resident is not None:
            out["persistent"] += _persistent_slots(tot[:n_pix].tolist(),
                                                   resident)
    for loop in ("nested", "flat", "persistent", "grouped"):
        if loop in out:
            out[f"{loop}_share"] = out["useful"] / max(out[loop], 1)
    return out


def _grouped_slots(pb: torch.Tensor, regen: int) -> int:
    """Lane slots of one launch of the mesh forms' loop (pt_mesh_kernel)
    over the (n_warps, 32, samples) path lengths `pb`, all warps stepped
    together; a lane whose counts are all 0 has no pixel."""
    n = pb.shape[2]
    if n == 0:
        return 0
    k = torch.zeros(pb.shape[:2], dtype=torch.int64)
    has = pb[:, :, 0] > 0          # a pixel with samples left
    rem = pb[:, :, 0].clone()      # bounces left in the lane's path
    alive = has.clone()
    slots = 0
    while bool(has.any()):
        waiting = has & ~alive
        n_wait = waiting.sum(dim=1, keepdim=True)
        go = (n_wait > 0) & (8 * n_wait >= regen * has.sum(dim=1,
                                                          keepdim=True))
        start = waiting & go
        rem = torch.where(start, pb.gather(2, k.clamp(max=n - 1)[..., None])
                          [..., 0], rem)
        alive = alive | start
        slots += WARP * int(has.any(dim=1).sum())
        rem = rem - alive.long()
        ended = alive & (rem == 0)
        alive = alive & ~ended
        k = k + ended.long()
        has = has & ~(ended & (k == n))
    return slots


def _persistent_slots(work: list, resident: int) -> int:
    """Lane slots of one launch of the persistent schedule: `resident`
    lanes, each taking the next pixel (its `work` in bounces) whenever it
    is free."""
    import heapq
    ends = work[:resident] + [0] * max(0, resident - len(work))
    heap = [(t, lane) for lane, t in enumerate(ends)]
    heapq.heapify(heap)
    for w in work[resident:]:
        t, lane = heap[0]
        ends[lane] = t + w
        heapq.heapreplace(heap, (t + w, lane))
    return WARP * sum(max(ends[i:i + WARP]) for i in range(0, resident, WARP))


def render_pt_linear(ss: StaticScene, cam: CameraParams, width: int,
                     height: int, spp: int, depth: int, seed: int = 0,
                     t_min: float = None, bsdf: bool = False, env_map=None,
                     mesh_accel=None, textures=None, *,
                     device) -> torch.Tensor:
    """Linear film SUM over `spp` samples, (W*H, 3) float32 on `device`
    (counterpart of `render_pt_pallas_linear`).  `env_map`: (He, We, 3)
    equirect radiance for env-map misses; `mesh_accel`: a
    `bvh.MeshAccel` whose pool the sweep runs inside the bounce loop;
    `textures`: (H, W, 3) surface textures, resolved from binned tables.
    Textures are dropped for a mesh pool without UV tables, as the JAX
    function drops them (`pt_pallas.py:739-744`)."""
    dev = check_device(device)
    mesh = None
    if mesh_accel is not None:
        if textures and mesh_accel.bt.tex is None:
            textures = None
        mesh = make_mesh_tables(mesh_accel.bt, dev)
    kernel_name(bsdf, env_map is not None, mesh is not None, bool(textures))
    check_supported(ss, mesh=mesh is not None)
    _check_sizes(width, height, 0, spp, depth)
    if t_min is None:
        t_min = scene_epsilon(ss)
    env = None if env_map is None else make_env_tables(env_map, dev)
    tex = make_tex_tables(textures, dev) if textures else None
    film = torch.zeros((width * height, 3), dtype=torch.float32, device=dev)
    return pt_accumulate(film, ss, cam, width, height, 0, spp, depth, seed,
                         t_min, bsdf=bsdf, env=env, mesh=mesh, tex=tex)


def gamma_image(film: torch.Tensor, spp: int, width: int,
                height: int) -> torch.Tensor:
    """Linear film SUM -> (H, W, 3) sqrt-gamma image of the mean."""
    return torch.sqrt(torch.clamp(film * (1.0 / spp), min=0.0)).reshape(
        height, width, 3)


def render_simple_pt(ss: StaticScene, cam: CameraParams, width: int,
                     height: int, spp: int, depth: int, seed: int = 0,
                     t_min: float = None, env_map=None, textures=None, *,
                     device) -> torch.Tensor:
    """Full diffuse-PT render: (H, W, 3) gamma'd image, row 0 = BOTTOM
    (counterpart of `render_simple_pt_pallas`)."""
    if spp < 1:
        raise ValueError(f"spp must be at least 1, got {spp}")
    film = render_pt_linear(ss, cam, width, height, spp, depth, seed=seed,
                            t_min=t_min, env_map=env_map, textures=textures,
                            device=device)
    return gamma_image(film, spp, width, height)


def render_bsdf_pt(ss: StaticScene, cam: CameraParams, width: int,
                   height: int, spp: int, depth: int, seed: int = 0,
                   t_min: float = None, env_map=None, mesh_accel=None,
                   textures=None, *, device) -> torch.Tensor:
    """AccPathTracer's five-lobe estimator: (H, W, 3) gamma'd image, row 0 =
    BOTTOM (counterpart of `render_bsdf_pt_pallas`)."""
    if spp < 1:
        raise ValueError(f"spp must be at least 1, got {spp}")
    film = render_pt_linear(ss, cam, width, height, spp, depth, seed=seed,
                            t_min=t_min, bsdf=True, env_map=env_map,
                            mesh_accel=mesh_accel, textures=textures,
                            device=device)
    return gamma_image(film, spp, width, height)


def hash_uniform_fill(pid: torch.Tensor, sample: torch.Tensor,
                      draw: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """`hash_uniform` elementwise over four same-shaped int32 tensors: on a
    CUDA device through the kernel library's own device function (to check
    it bit for bit), on the CPU through `pt_core.hash_uniform`."""
    global HASH_LAUNCHES
    args = (pid, sample, draw, seed)
    for a in args:
        if a.dtype != torch.int32 or a.shape != pid.shape \
                or a.device != pid.device:
            raise ValueError("hash_uniform_fill takes four int32 tensors of "
                             "one shape on one device")
    if pid.device.type == "cpu":
        return hash_uniform(pid, sample, draw, seed)
    if pid.device.type != "cuda":
        raise ValueError(f"unsupported device {pid.device}")
    lib = _kernels()
    args = tuple(a.contiguous() for a in args)
    out = torch.empty(pid.shape, dtype=torch.float32, device=pid.device)
    with torch.cuda.device(pid.device):
        err = lib.nr_hash_uniform_fill(
            *(a.data_ptr() for a in args), out.data_ptr(), out.numel(),
            torch.cuda.current_stream().cuda_stream)
    _check_launch(lib, err, "hash_fill_kernel")
    HASH_LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# The hybrid route's bounce: a wavefront held in SoA rows, one bounce as the
# dense-hit kernel, the mesh pipe and the shade kernel
# ---------------------------------------------------------------------------

def lane_samples(lane: torch.Tensor, n_pix: int, sp0: int, pix0: int = 0):
    """(global pixel id, sample index) int64 of chunk lanes over pixels
    [pix0, pix0 + n_pix): lane L is pixel pix0 + L % n_pix's sample
    sp0 + L // n_pix (`wavefront_shade_kernel` forms the same ids mod
    2**32, which is all the hash reads of them)."""
    lane = lane.to(torch.int64)
    return pix0 + lane % n_pix, sp0 + lane // n_pix


def bounce_uniforms(pid: torch.Tensor, sp: torch.Tensor, seed: int, b: int):
    """Bounce b's three uniforms (draws 4, 5, 6), as the kernel draws
    them."""
    bs = bounce_seed(seed, b)
    return tuple(hash_uniform(pid, sp, k, bs) for k in (4, 5, 6))


class Draws(NamedTuple):
    """The chunk lanes a wavefront's slots hold, which key their draws:
    slot i holds lane `lane[i]` (int32), pixel pix0 + lane % n_pix's
    sample sp0 + lane // n_pix, drawn at `seed`."""
    lane: torch.Tensor
    n_pix: int
    sp0: int
    pix0: int
    seed: int

    def samples(self):
        """(global pixel id, sample index) int64 of each slot."""
        return lane_samples(self.lane, self.n_pix, self.sp0, self.pix0)

    def uniforms(self, b: int):
        """Bounce b's three uniforms of each slot."""
        return bounce_uniforms(*self.samples(), self.seed, b)


def bsdf_bounce_env(ss: StaticScene, mat_ch, env: Optional[torch.Tensor],
                    o: V3, d: V3, thr: V3, rad: V3, alive, u1, u2, u3,
                    t_min: float, tri_bvh=None, textures=None,
                    coherent: bool = False):
    """`pt_core.bsdf_bounce` with, under an env map ((He, We, 3) float32),
    its exact lookup added at every miss (misses keep their direction and
    throughput), as the JAX package's XLA bounce does (`acc_pt.py:69-93,
    :120-142`): the plain version of the hybrid route's bounce.  Returns
    (o, d, thr, rad, alive)."""
    out = bsdf_bounce(ss, mat_ch, o, d, thr, rad, alive, u1, u2, u3,
                      t_min=t_min, tri_bvh=tri_bvh, with_miss=env is not None,
                      textures=textures, coherent=coherent)
    if env is None:
        return out
    o, d, thr, rad, alive, miss = out
    e = sample_env_map_v3(env, d)
    ew = miss.to(torch.float32)
    return o, d, thr, V3(rad.x + ew * thr.x * e.x, rad.y + ew * thr.y * e.y,
                         rad.z + ew * thr.z * e.z), alive


class WaveTables(NamedTuple):
    """A hybrid-route scene as the wavefront kernels read it, on one
    device: the mesh forms' table (`pack_scene(ss, mesh=True)`: spheres,
    planes, lights and materials; the pool's triangles are the mesh
    pipe's) and its counts, the scene's epsilon, the env map of the exact
    lookup, and the scene and material channels the plain versions read."""
    table: torch.Tensor
    counts: tuple
    t_min: float
    env: Optional[torch.Tensor]   # (He, We, 3) float32, or None
    ss: StaticScene
    mat_ch: list


def make_wave_tables(ss: StaticScene, t_min: float,
                     env: Optional[torch.Tensor], device) -> WaveTables:
    """The wavefront kernels' tables on `device`, once per render; `env`:
    the (He, We, 3) float32 map on that device, or None."""
    dev = torch.device(device)
    if env is not None and (env.dtype != torch.float32 or env.dim() != 3
                            or env.shape[2] != 3 or not env.is_contiguous()
                            or env.device != dev or env.numel() >= 1 << 31):
        raise ValueError(f"the env map must be a contiguous float32 (He, "
                         f"We, 3) tensor on {dev}")
    table, counts = pack_scene(ss, mesh=True)
    tab = torch.as_tensor(table)
    if dev.type == "cuda":
        # the route builds these inside its render phase: a pinned,
        # non-blocking copy keeps the host from waiting on the card there
        tab = tab.pin_memory().to(dev, non_blocking=True)
    return WaveTables(tab, counts, float(t_min), env, ss,
                      make_mat_channels(ss))


def _check_wave(wt: WaveTables, rows, alive, lane=None) -> torch.device:
    """The wavefront's device, after checking that `rows` are float32,
    `alive` bool and `lane` int32 (n,) contiguous tensors on the tables'
    device, a CUDA or CPU one."""
    dev = alive.device
    n = alive.shape[0] if alive.dim() == 1 else -1
    typed = [(r, torch.float32) for r in rows] + (
        [] if lane is None else [(lane, torch.int32)])
    ok = (alive.dtype == torch.bool and alive.is_contiguous()
          and 0 <= n < 1 << 31 and wt.table.device == dev
          and (wt.env is None or wt.env.device == dev)
          and all(r.dtype == dt and tuple(r.shape) == (n,)
                  and r.is_contiguous() and r.device == dev
                  for r, dt in typed))
    if not ok:
        raise ValueError(
            "the wavefront takes contiguous (n,) tensors on the tables' "
            "device: float32 rays, state and hits, bool alive, int32 lanes")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def wavefront_dense_hit_plain(wt: WaveTables, o: V3, d: V3,
                              alive: torch.Tensor) -> torch.Tensor:
    """`wavefront_dense_hit` as torch ops, on any device: the closest hit
    over the scene less its pool (`pt_core.closest_hit`'s dense part), 0
    where `alive` is False."""
    hit = intersect_scene_unrolled(wt.ss._replace(tri=[], tri_uv=()), o, d,
                                   t_min=wt.t_min, mat_channels=wt.mat_ch)
    return torch.where(alive, hit.t, 0.0)


def wavefront_dense_hit(wt: WaveTables, o: V3, d: V3,
                        alive: torch.Tensor) -> torch.Tensor:
    """The dense primitives' closest t of each lane (spheres and planes),
    0 where `alive` is False: the cap `mesh_cuda.intersect_triangles_mesh`
    takes (`pt_core.closest_hit`'s).  On a CUDA device through
    `wavefront_dense_hit_kernel`, on the CPU `wavefront_dense_hit_plain`;
    the two agree bit for bit on the card."""
    dev = _check_wave(wt, [*o, *d], alive)
    if dev.type == "cpu":
        return wavefront_dense_hit_plain(wt, o, d, alive)
    lib = _kernels()
    cap = torch.empty_like(o.x)
    state = (ctypes.c_void_p * 12)(*(r.data_ptr() for r in (*o, *d)))
    with torch.cuda.device(dev):
        err = lib.nr_wavefront_dense_hit(
            wt.table.data_ptr(), (ctypes.c_int * 5)(*wt.counts), wt.t_min,
            state, alive.data_ptr(), cap.data_ptr(), cap.numel(),
            torch.cuda.current_stream().cuda_stream)
    _check_launch(lib, err, WAVEFRONT_KERNELS[0])
    KERNEL_LAUNCHES[WAVEFRONT_KERNELS[0]] += 1
    return cap


def wavefront_shade_plain(wt: WaveTables, o: V3, d: V3, thr: V3, rad: V3,
                          alive: torch.Tensor, hit, draws: Draws, b: int):
    """`wavefront_shade` as torch ops, on any device, returning the new
    (o, d, thr, rad, alive): `bsdf_bounce_env` over the dense primitives
    and the pipe's winner `hit`, drawing for `draws` at bounce `b`."""
    t, nx, ny, nz, mat = hit
    idx = torch.where(torch.isinf(t), -1, 0)   # the pipe's miss: t inf
    return bsdf_bounce_env(
        wt.ss, wt.mat_ch, wt.env, o, d, thr, rad, alive, *draws.uniforms(b),
        t_min=wt.t_min, tri_bvh=lambda o_, d_, cap: (t, idx, nx, ny, nz, mat))


def wavefront_shade(wt: WaveTables, o: V3, d: V3, thr: V3, rad: V3,
                    alive: torch.Tensor, hit, draws: Draws, b: int) -> None:
    """The rest of bounce `b` of the hybrid route's wavefront after its
    mesh pipe, IN PLACE on (o, d, thr, rad, alive): `pt_core.bsdf_bounce`
    over the dense primitives and the pipe's winner `hit` (t, nx, ny, nz,
    mat: `intersect_triangles_mesh`'s first five), with the env map's
    exact lookup at misses when the tables hold one (`bsdf_bounce_env`).
    Slot i holds chunk lane `draws.lane[i]` (nonnegative), whose pixel and
    sample (`Draws.samples`) key the draws 4-6 at
    `bounce_seed(draws.seed, b)`.  On a CUDA device through
    `wavefront_shade_kernel`, on the CPU `wavefront_shade_plain`; the two
    agree bit for bit on the card."""
    hit = tuple(hit)
    if len(hit) != 5:
        raise ValueError("hit is the pipe's (t, nx, ny, nz, mat)")
    n_pix, sp0, pix0 = draws.n_pix, draws.sp0, draws.pix0
    if n_pix < 1 or pix0 < 0 or sp0 < 0 or max(pix0, sp0) >= 1 << 31:
        raise ValueError(f"unsupported lane numbering: n_pix {n_pix}, "
                         f"pix0 {pix0}, sp0 {sp0}")
    dev = _check_wave(wt, [*o, *d, *thr, *rad, *hit], alive, draws.lane)
    if dev.type == "cpu":
        out = wavefront_shade_plain(wt, o, d, thr, rad, alive, hit, draws, b)
        for dst, src in zip((*o, *d, *thr, *rad, alive),
                            (*out[0], *out[1], *out[2], *out[3], out[4])):
            dst.copy_(src)
        return
    lib = _kernels()
    state = (ctypes.c_void_p * 12)(*(r.data_ptr()
                                     for r in (*o, *d, *thr, *rad)))
    hits = (ctypes.c_void_p * 5)(*(h.data_ptr() for h in hit))
    env, env_h, env_w = (None, 0, 0) if wt.env is None else (
        wt.env.data_ptr(), wt.env.shape[0], wt.env.shape[1])
    with torch.cuda.device(dev):
        err = lib.nr_wavefront_shade(
            wt.table.data_ptr(), (ctypes.c_int * 5)(*wt.counts), wt.t_min,
            state, alive.data_ptr(), hits, draws.lane.data_ptr(),
            alive.numel(), n_pix, pix0, sp0, bounce_seed(draws.seed, b), env,
            env_h, env_w, torch.cuda.current_stream().cuda_stream)
    _check_launch(lib, err, WAVEFRONT_KERNELS[1])
    KERNEL_LAUNCHES[WAVEFRONT_KERNELS[1]] += 1
