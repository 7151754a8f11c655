"""The diffuse path tracer's kernel: CUDA launch wrapper, plain torch version
and launch counter.

Counterpart of `nrenderer_tpu/ops/pt_pallas.py` in its diffuse form
(`render_simple_pt_pallas`, `render_pt_pallas_linear`).  The kernel,
`csrc/pt_kernel.cu`, replaces the Pallas `_pt_kernel`; its source header says
what it computes and how.

`pt_accumulate` is the wrapper: for a film tensor on a CUDA device it
launches the kernel (and raises if the build or the launch fails); for a
film on the CPU it runs `pt_accumulate_plain`, the same estimator as torch
ops over an (N,)-ray wavefront built from `ops.camera`, `ops.intersect` and
`ops.pt_core`.  Both draw every random number from `pt_core.hash_uniform`
with the Pallas kernel's (pixel, sample, draw, seed) numbering, so kernel,
plain version and the JAX kernel agree pixel by pixel up to float rounding.

Both add into a linear film SUM in place and sample by sample, so a render
split into several calls over consecutive sample ranges gives the same sums
as one call.  Entry points return the JAX contract: `render_simple_pt` an
(H, W, 3) gamma'd image with row 0 = bottom, `render_pt_linear` the
(W*H, 3) linear SUM."""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .camera import CameraParams, shoot_v3
from .intersect import StaticScene, np_dot
from .pt_core import (
    PI, bounce_seed, diffuse_bounce, finish_ambient, hash_uniform,
    scene_epsilon,
)
from .soa import V3, normalize3

# Kernel launches made by `pt_accumulate` (one per spp chunk), and by
# `hash_uniform_fill`.  Plain integers: a caller resets and reads them to
# show that a run went through the kernels.
KERNEL_LAUNCHES = 0
HASH_LAUNCHES = 0

KERNEL_SOURCE = "nrenderer_torch/csrc/pt_kernel.cu"
REPLACES = "nrenderer_tpu/ops/pt_pallas.py:123"

# One kernel launch covers at most this many pixel-samples (a 512x512 film
# takes 32 spp per launch); the plain version traces at most this many rays
# per wavefront.
PIXEL_SAMPLES_PER_LAUNCH = 1 << 23
PLAIN_RAYS_PER_WAVEFRONT = 1 << 20

# Packed scene-table strides; csrc/pt_kernel.cu reads the same layout.
SPH_STRIDE, TRI_STRIDE, PLN_STRIDE, AL_STRIDE, MAT_STRIDE = 6, 13, 14, 16, 3
CAM_FLOATS = 22

_bound = None


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


def check_supported(ss: StaticScene) -> None:
    """Refuse scenes that need a kernel form this slice lacks."""
    if ss.ambient_type == 1:
        raise NotImplementedError(
            "environment-map ambient (ambient_type 1) needs the env-map form "
            "of the path-tracing kernel (ROADMAP B1c), not ported yet")
    if ss.tri_uv:
        raise NotImplementedError(
            "textured faces need the texture form of the path-tracing "
            "kernel (ROADMAP B1d), not ported yet")


def pack_scene(ss: StaticScene):
    """The kernel's float32 scene table and its counts
    (n_sph, n_tri, n_pln, n_al, n_mat).  Constants are rounded to float32
    exactly where the plain form rounds them: r*r and 1/r in double, the
    plane offset dot(pos, n) in float32 (`intersect.np_dot`)."""
    rows = []
    for (cx, cy, cz, r, m) in ss.sph:
        rows.append([cx, cy, cz, r * r, 1.0 / r, m])
    for (v1, e1, e2, n, m) in ss.tri:
        rows.append([*v1, *e1, *e2, *n, m])
    for (pos, n, inv0, inv1, m) in ss.pln:
        rows.append([*pos, *n, *inv0, *inv1, np_dot(pos, n), m])
    for (pos, n, inv0, inv1, rad) in ss.al:
        rows.append([*pos, *n, *inv0, *inv1, np_dot(pos, n), *rad])
    for m in ss.mats:
        rows.append(list(m["diffuse"]))
    rows.append(list(ss.ambient_constant))
    table = np.asarray([float(x) for row in rows for x in row], np.float32)
    counts = (len(ss.sph), len(ss.tri), len(ss.pln), len(ss.al),
              len(ss.mats))
    return table, counts


def table_size(counts) -> int:
    n_sph, n_tri, n_pln, n_al, n_mat = counts
    return (n_sph * SPH_STRIDE + n_tri * TRI_STRIDE + n_pln * PLN_STRIDE
            + n_al * AL_STRIDE + n_mat * MAT_STRIDE + 3)


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
        lib.nr_pt_diffuse.argtypes = [
            vp, vp, ctypes.POINTER(ci), ctypes.POINTER(ctypes.c_float),
            ci, ci, ci, ci, ci, ci, vp]
        lib.nr_pt_diffuse.restype = ci
        lib.nr_hash_uniform_fill.argtypes = [vp, vp, vp, vp, vp, ci, vp]
        lib.nr_hash_uniform_fill.restype = ci
        lib.nr_cam_floats.argtypes = []
        lib.nr_cam_floats.restype = ci
        lib.nr_error_string.argtypes = [ci]
        lib.nr_error_string.restype = ctypes.c_char_p
        if lib.nr_cam_floats() != CAM_FLOATS:
            raise RuntimeError("kernel library camera layout mismatch")
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


def _check_film(film: torch.Tensor, n_pix: int) -> None:
    if film.dtype != torch.float32 or tuple(film.shape) != (n_pix, 3) \
            or not film.is_contiguous():
        raise ValueError(
            f"film must be a contiguous float32 ({n_pix}, 3) tensor, got "
            f"{film.dtype} {tuple(film.shape)}")


def pt_accumulate(film: torch.Tensor, ss: StaticScene, cam: CameraParams,
                  width: int, height: int, sp0: int, n_spp: int, depth: int,
                  seed: int, t_min: float) -> torch.Tensor:
    """Add samples [sp0, sp0 + n_spp) of every pixel into the linear film
    ((W*H, 3) float32) IN PLACE; returns `film`.  A CUDA film goes through
    the kernel, a CPU film through the plain version."""
    check_supported(ss)
    _check_sizes(width, height, sp0, n_spp, depth)
    _check_film(film, width * height)
    if film.device.type == "cuda":
        _pt_accumulate_cuda(film, ss, cam, width, height, sp0, n_spp, depth,
                            seed, t_min)
    elif film.device.type == "cpu":
        pt_accumulate_plain(film, ss, cam, width, height, sp0, n_spp, depth,
                            seed, t_min)
    else:
        raise ValueError(f"unsupported film device {film.device}")
    return film


def _pt_accumulate_cuda(film, ss, cam, width, height, sp0, n_spp, depth,
                        seed, t_min) -> None:
    global KERNEL_LAUNCHES
    lib = _kernels()
    table, counts = pack_scene(ss)
    if table.size != table_size(counts):
        raise ValueError("scene table size does not match its counts")
    tab = torch.as_tensor(table, device=film.device)
    cnt = (ctypes.c_int * 5)(*counts)
    camf = (ctypes.c_float * CAM_FLOATS)(
        *camera_floats(cam, width, height, t_min))
    n_pix = width * height
    per_launch = max(1, PIXEL_SAMPLES_PER_LAUNCH // n_pix)
    with torch.cuda.device(film.device):
        stream = torch.cuda.current_stream().cuda_stream
        for c0 in range(0, n_spp, per_launch):
            n = min(per_launch, n_spp - c0)
            err = lib.nr_pt_diffuse(film.data_ptr(), tab.data_ptr(), cnt,
                                    camf, width, height, sp0 + c0, n, depth,
                                    _int32(seed), stream)
            _check_launch(lib, err, "pt_diffuse_kernel")
            KERNEL_LAUNCHES += 1


def _camera_rays(cam: CameraParams, pid: torch.Tensor, sp: torch.Tensor,
                 seed: int, width: int, height: int):
    """Jittered camera rays with the Pallas kernel's draws and op order."""
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
                        n_spp: int, depth: int, seed: int,
                        t_min: float) -> torch.Tensor:
    """The kernel's plain torch version, on any device: adds samples
    [sp0, sp0 + n_spp) into `film` in place, in sample order."""
    dev = film.device
    cam = CameraParams(*(x.to(dev) for x in cam))
    n_pix = width * height
    albedo_ch = [tuple(float(v) for v in m["diffuse"]) for m in ss.mats]
    chunk = max(1, min(n_spp, PLAIN_RAYS_PER_WAVEFRONT // n_pix))
    pid1 = torch.arange(n_pix, dtype=torch.int64, device=dev)
    for c0 in range(0, n_spp, chunk):
        c = min(chunk, n_spp - c0)
        sp = torch.arange(sp0 + c0, sp0 + c0 + c, dtype=torch.int64,
                          device=dev).repeat_interleave(n_pix)
        pid = pid1.repeat(c)
        o, d = _camera_rays(cam, pid, sp, seed, width, height)
        ones = torch.ones_like(o.x)
        zeros = torch.zeros_like(o.x)
        thr = V3(ones, ones, ones)
        rad = V3(zeros, zeros, zeros)
        alive = torch.ones_like(o.x, dtype=torch.bool)
        for b in range(depth):
            bseed = bounce_seed(seed, b)
            u1 = hash_uniform(pid, sp, 4, bseed)
            u2 = hash_uniform(pid, sp, 5, bseed)
            o, d, thr, rad, alive = diffuse_bounce(
                ss, albedo_ch, o, d, thr, rad, alive, u1, u2, t_min=t_min)
        rad = finish_ambient(ss, thr, rad, alive)
        samples = torch.stack([rad.x, rad.y, rad.z], dim=-1).reshape(
            c, n_pix, 3)
        for k in range(c):  # one sample after another, as the kernel adds
            film += samples[k]
    return film


def render_pt_linear(ss: StaticScene, cam: CameraParams, width: int,
                     height: int, spp: int, depth: int, seed: int = 0,
                     t_min: float = None, *, device) -> torch.Tensor:
    """Linear film SUM over `spp` samples, (W*H, 3) float32 on `device`
    (counterpart of `render_pt_pallas_linear`)."""
    dev = check_device(device)
    check_supported(ss)
    _check_sizes(width, height, 0, spp, depth)
    if t_min is None:
        t_min = scene_epsilon(ss)
    film = torch.zeros((width * height, 3), dtype=torch.float32, device=dev)
    return pt_accumulate(film, ss, cam, width, height, 0, spp, depth, seed,
                         t_min)


def render_simple_pt(ss: StaticScene, cam: CameraParams, width: int,
                     height: int, spp: int, depth: int, seed: int = 0,
                     t_min: float = None, *, device) -> torch.Tensor:
    """Full diffuse-PT render: (H, W, 3) gamma'd image, row 0 = BOTTOM
    (counterpart of `render_simple_pt_pallas`)."""
    if spp < 1:
        raise ValueError(f"spp must be at least 1, got {spp}")
    film = render_pt_linear(ss, cam, width, height, spp, depth, seed=seed,
                            t_min=t_min, device=device)
    return torch.sqrt(torch.clamp(film * (1.0 / spp), min=0.0)).reshape(
        height, width, 3)


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
