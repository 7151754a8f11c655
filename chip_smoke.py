#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without a result line:

  1. toolchain: nvidia-smi name and power limit, torch, CUDA, nvcc, device;
  2. build the kernel library from `nrenderer_torch/csrc` with nvcc;
  3. the kernel's device hash against the plain torch `hash_uniform`, bit
     for bit, over a grid of (pixel, sample, draw, seed) with negative and
     wrapping seeds;
  4. each instantiation of the path-tracing kernel against its plain torch
     version on the same CUDA inputs, at 64x64, 16 spp, depth 4 and at its
     main path's own shapes (512x512, a few spp, the path's depth), with
     times for both and the least time the card could take (the bound):
     the diffuse form on the Cornell box, the BSDF form on
     `resource/pt_glass_box.scn`, the diffuse and BSDF env forms on
     `resource/env_spheres.scn` under `resource/env_sky.png`;
  5. the main path, `nrenderer_torch.cli.main(["render", ...])` at 512x512,
     2048 spp, depth 20 on the GPU: once to warm up, once timed with its
     kernel launches counted; the image must be finite, in [0, 1], within a
     plausible brightness band and bright where the light is;
  6. the AccPathTracer path: `cli.main` on `pt_glass_box.scn` at 512x512,
     2048 spp, depth 20, checked the same way;
  7. the env-map paths: `cli.main --env-map` on `env_spheres.scn` at
     512x512, 1024 spp, depth 8, with AccPathTracer and SimplePathTracer;
     the image must be finite, in [0, 1], in its band, and the sky bright;
  8. the mesh and texture forms against their plain versions, as phase 4:
     `pt_bsdf_mesh_kernel` on `resource/mesh_box.scn` + `blob_960.obj` at
     64x64/16/4 and 500x500/4/20, the texture forms on `tex_quad.obj` (the
     dense forms, with and without `env_sky.png`) and `tex_grid.obj` (the
     mesh form) at 64x64/16/4 and 256x256/4/6;
  9. `mesh_sweep_kernel` on `ico_5120.obj` against its plain version, 2^20
     rays aimed at the mesh, natural and front-to-back block order: t bit
     for bit, ids equal where t is untied;
 10. the mesh path: AccPathTracer `--obj blob_960.obj` on `mesh_box.scn`
     at 500x500, 256 spp, depth 20 (the megamesh route); the blob must be
     brighter than the floor in its shadow;
 11. the textured paths: AccPathTracer on `tex_grid.obj` at 256x256, 512
     spp, depth 6, and on its untextured twin (the ratio of their times is
     printed); the dense textured quad with SimplePathTracer and
     AccPathTracer, without and with the env map; the grid's left half
     must be red and its right half green.

Each of phases 5-7, 10 and 11 sets every launch count to 0 just before its
run and reads the counts just after; a kernel its path runs must have
launched.  The last two lines are the kernels' JSON record and
`{"ok": true, "device": {...}}`.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
RES = os.path.join(ROOT, "resource")
SCENE = os.path.join(RES, "cornell_box.scn")
GLASS_SCENE = os.path.join(RES, "pt_glass_box.scn")
ENV_SCENE = os.path.join(RES, "env_spheres.scn")
ENV_MAP = os.path.join(RES, "env_sky.png")
MESH_SCENE = os.path.join(RES, "mesh_box.scn")
TEX_SCENE = os.path.join(RES, "tex_grid.scn")
OBJ = os.path.join(RES, "obj")
BLOB = os.path.join(OBJ, "blob_960.obj")
ICO = os.path.join(OBJ, "ico_5120.obj")
TEX_GRID = os.path.join(OBJ, "tex_grid.obj")
TEX_GRID_PLAIN = os.path.join(OBJ, "tex_grid_plain.obj")
TEX_QUAD = os.path.join(OBJ, "tex_quad.obj")
OUT_PNG = os.path.join(ROOT, "build", "smoke_cornell.png")

# Phase-4 bars on the gamma'd film.  Kernel and plain version draw the same
# hash uniforms and, with the kernel built without FMA contraction, round
# every operation alike: on an H100 they agreed bit for bit (max |d| = 0).
# A rounding difference would move a few hits across a primitive's edge and
# flip those paths; an FMA build flipped 0.3% of pixels at 64x64/16/4 (mean
# |d| 1.1e-3).  The bars admit that much and no more.
MEAN_ABS_MAX = 2e-3
WITHIN = 1e-4
WITHIN_SHARE_MIN = 0.995

# Image bars: a converged render of resource/cornell_box.scn has a mean
# near 0.45 (plain version on the CPU, 128x128, 512 spp), pt_glass_box.scn
# near 0.42 (64x64, 256 spp, depth 20), env_spheres.scn under env_sky.png
# near 0.67 with AccPathTracer and 0.66 with SimplePathTracer, its top-left
# corner (sky) near 0.82 (64x64, 256 spp, depth 8).
MEAN_BAND = (0.25, 0.75)
GLASS_MEAN_BAND = (0.25, 0.65)
ENV_MEAN_BAND = (0.45, 0.85)
SKY_MIN = 0.7
# mesh_box.scn + blob_960.obj near 0.39 (64x64, 128 spp, depth 10; the
# blob's lit body 0.33, the floor in its shadow 0.07), the textured grid
# near 0.19, its untextured twin 0.30, the textured quad 0.19 and under
# env_sky.png 0.64 (64x64, 256 spp, depth 6): plain version on the CPU.
MESH_MEAN_BAND = (0.28, 0.55)
GRID_MEAN_BAND = (0.1, 0.3)
PLAIN_GRID_MEAN_BAND = (0.2, 0.4)
QUAD_ENV_MEAN_BAND = (0.5, 0.8)

# The card's peaks for the bound (NVIDIA's H100 SXM data sheet, at the full
# 700 W power limit): FP32 outside the tensor cores and HBM bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# FP32 operations the kernel does, counted from csrc/pt_kernel.cu (each
# add, sub, mul, div, sqrt, rsqrt, sin, cos, min/max and float compare as
# one; the integer hash not counted): per sample (camera ray, ambient, film
# add), per bounce of a live path (one test per primitive, plus the
# cheapest scatter, the Lambertian lobe), and per env lookup.
FLOPS_SAMPLE = 40
FLOPS_SPHERE, FLOPS_TRIANGLE, FLOPS_PATCH = 33, 52, 38
FLOPS_SCATTER = 80
FLOPS_ENV_LOOKUP = 45
# the blocked sweep (csrc/mesh_sweep.cuh): one block slab test, one
# triangle test of an entered block
FLOPS_SLAB, FLOPS_MESH_TRI = 26, 53


def gpu_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_toolchain() -> str:
    print("== phase 1: toolchain")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this smoke "
                           "test needs an NVIDIA GPU")
    gpu = gpu_name_power()
    from nrenderer_torch import _build
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[-1]
    print(f"nvidia-smi: {gpu}")
    print(f"torch {torch.__version__}, torch.version.cuda "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    print(f"nvcc: {nvcc}")
    print(f"device: {torch.cuda.get_device_name(0)} "
          f"(count {torch.cuda.device_count()})")
    return gpu


def phase_build() -> None:
    print("== phase 2: build")
    from nrenderer_torch import _build
    from nrenderer_torch.ops import pt_cuda
    t0 = time.perf_counter()
    pt_cuda._kernels()
    secs = time.perf_counter() - t0
    nvcc_s = _build.build_seconds
    how = ("up to date, not rebuilt" if nvcc_s is None
           else f"nvcc {nvcc_s:.2f} s")
    print(f"loaded {_build.LIB_PATH.relative_to(ROOT)} in {secs:.2f} s "
          f"({how})")
    for line in _build.LOG_PATH.read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())


def phase_hash() -> None:
    print("== phase 3: device hash vs torch hash_uniform")
    from nrenderer_torch.ops.pt_core import bounce_seed, hash_uniform
    from nrenderer_torch.ops.pt_cuda import hash_uniform_fill
    rng = np.random.default_rng(0)
    n = 1 << 20
    i32 = np.iinfo(np.int32)
    pid = rng.integers(0, 512 * 512, n)
    sample = rng.integers(0, 4096, n)
    draw = rng.integers(0, 7, n)
    seeds = np.array([0, 1, -1, 7, i32.max, i32.min, 123456789, -987654321]
                     + [bounce_seed(s, b) for s in (0, -5, i32.max)
                        for b in range(20)])
    seed = np.concatenate([seeds, rng.integers(i32.min, i32.max, n,
                                               endpoint=True)])[:n]
    pid[:4] = [0, i32.max, 262143, 1]
    cols = [torch.as_tensor(a.astype(np.int32), device="cuda")
            for a in (pid, sample, draw, seed)]
    got = hash_uniform_fill(*cols)
    want = hash_uniform(*cols)
    torch.cuda.synchronize()
    n_diff = int((got != want).sum())
    print(f"{n} draws, {n_diff} differ")
    if n_diff:
        raise AssertionError(f"device hash differs from hash_uniform on "
                             f"{n_diff} of {n} draws")


def _setup(device, scene_path=SCENE, env=False, objs=()):
    from nrenderer_torch import build_scene_arrays, load_obj, load_scn
    from nrenderer_torch.io.image import load_image
    from nrenderer_torch.ops.camera import make_camera
    from nrenderer_torch.ops.intersect import make_static_scene
    scene = load_scn(scene_path)
    for obj in objs:
        load_obj(obj, scene, material=0 if scene.materials else None)
    arrays = build_scene_arrays(scene)
    ss = make_static_scene(arrays)
    env_map = load_image(ENV_MAP)[:, :, :3] if env else None
    return ss, make_camera(scene.camera, device=device), env_map, arrays


def _time_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(flops: float, n_bytes: float) -> tuple:
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def _table_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def bound_ms(ss, n_pix: int, work: dict, env_map, mesh=None,
             tex=None) -> tuple:
    """The least time the card could take for one kernel call: the larger
    of its FP32 operations over the FP32 peak and the bytes it must move
    (film read and written, scene, env, mesh and texture tables read once)
    over the memory rate.  `work` is the plain version's count of samples,
    of bounces of live paths and, with a mesh, of the sweep's block slab
    tests and triangle tests of entered blocks, on the same inputs
    (data-dependent).  The mesh form's dense pass has no triangles."""
    from nrenderer_torch.ops.pt_cuda import pack_scene
    n_tri = 0 if mesh is not None else len(ss.tri)
    per_bounce = (len(ss.sph) * FLOPS_SPHERE + n_tri * FLOPS_TRIANGLE
                  + (len(ss.pln) + len(ss.al)) * FLOPS_PATCH + FLOPS_SCATTER)
    flops = (work["samples"] * FLOPS_SAMPLE + work["bounces"] * per_bounce
             + work.get("slab_tests", 0) * FLOPS_SLAB
             + work.get("tri_tests", 0) * FLOPS_MESH_TRI)
    n_bytes = (2 * n_pix * 3 * 4
               + pack_scene(ss, mesh=mesh is not None,
                            with_uv=tex is not None)[0].nbytes)
    if env_map is not None:
        flops += work["samples"] * FLOPS_ENV_LOOKUP
        n_bytes += env_map.size * 4 + 3 * 32 * 128 * 4
    if mesh is not None:
        n_bytes += _table_bytes(mesh.tris, mesh.bb,
                                mesh.uvs if tex is not None else None)
    n_bytes += _table_bytes(tex)
    return _bound(flops, n_bytes)


def phase_parity(width, height, spp, depth, seed=0, scene=SCENE,
                 bsdf=False, env=False, objs=(), mesh=False, tex=False,
                 phase=4) -> dict:
    from nrenderer_torch.ops.bvh import build_mesh_accel
    from nrenderer_torch.ops.mesh_cuda import make_mesh_tables
    from nrenderer_torch.ops.pt_core import make_mat_channels, scene_epsilon
    from nrenderer_torch.ops.pt_cuda import (
        kernel_name, make_env_tables, make_tex_tables, pt_accumulate,
        pt_accumulate_plain)
    name = kernel_name(bsdf, env, mesh, tex)
    what = " + ".join(os.path.basename(p) for p in (scene, *objs))
    print(f"== phase {phase}: {name} vs plain, {what}, "
          f"{width}x{height}, {spp} spp, depth {depth}")
    ss, cam, env_map, arrays = _setup("cuda", scene, env, objs)
    t_min = scene_epsilon(ss)
    n_pix = width * height
    tables = make_env_tables(env_map, "cuda") if env else None
    mesh_t = (make_mesh_tables(build_mesh_accel(
        arrays, make_mat_channels(ss)).bt, "cuda") if mesh else None)
    tex_t = make_tex_tables(arrays.textures, "cuda") if tex else None
    work = {}

    def kernel():
        film = torch.zeros((n_pix, 3), dtype=torch.float32, device="cuda")
        return pt_accumulate(film, ss, cam, width, height, 0, spp, depth,
                             seed, t_min, bsdf=bsdf, env=tables, mesh=mesh_t,
                             tex=tex_t)

    def plain(stats=None):
        film = torch.zeros((n_pix, 3), dtype=torch.float32, device="cuda")
        return pt_accumulate_plain(film, ss, cam, width, height, 0, spp,
                                   depth, seed, t_min, bsdf=bsdf, env=tables,
                                   mesh=mesh_t, tex=tex_t, stats=stats)

    lin_k = kernel()
    lin_p = plain(work)
    torch.cuda.synchronize()
    img = lambda f: torch.sqrt(torch.clamp(f * (1.0 / spp), min=0.0))
    diff = (img(lin_k) - img(lin_p)).abs()
    pix = diff.max(dim=1).values
    b_ms, b_by = bound_ms(ss, n_pix, work, env_map, mesh_t, tex_t)
    st = {
        "kernel": name,
        "max_abs_err": float(diff.max()),
        "mean_abs_err": float(diff.mean()),
        "share_within_1e-4": float((pix <= WITHIN).float().mean()),
        "share_within_1e-3": float((pix <= 1e-3).float().mean()),
        "finite": bool(torch.isfinite(lin_k).all()),
        "kernel_ms": _time_ms(kernel, 3),
        "plain_ms": _time_ms(plain, 1),
        "bound_ms": b_ms, "bound_by": b_by,
        "bounces_per_sample": work["bounces"] / work["samples"],
        **({"slab_tests": work["slab_tests"],
            "tri_tests": work.get("tri_tests", 0)} if mesh else {}),
    }
    print(json.dumps({"shape": [width, height, spp, depth], **st}))
    if not st["finite"]:
        raise AssertionError(f"{name} film has non-finite values")
    if st["mean_abs_err"] > MEAN_ABS_MAX:
        raise AssertionError(f"{name}: mean |kernel - plain| "
                             f"{st['mean_abs_err']} > {MEAN_ABS_MAX}")
    if st["share_within_1e-4"] < WITHIN_SHARE_MIN:
        raise AssertionError(
            f"{name}: only {st['share_within_1e-4']:.4f} of pixels within "
            f"{WITHIN} (need {WITHIN_SHARE_MIN})")
    return st


def _cli_argv(scene, renderer, width, height, spp, depth, out, env=False,
              objs=()):
    argv = ["render", "--scene", scene, "--renderer", renderer,
            "--width", str(width), "--height", str(height), "--spp",
            str(spp), "--depth", str(depth), "--device", "cuda",
            "--out", out]
    for obj in objs:
        argv += ["--obj", obj]
    return argv + (["--env-map", ENV_MAP] if env else [])


def phase_cli(phase, label, argv, kernels, width, height, spp, depth,
              band, check) -> dict:
    """One path through `cli.main`: a warm-up run, then a timed run with
    every launch count set to 0 just before it and read just after."""
    print(f"== phase {phase}: {label}, cli render {width}x{height}, "
          f"{spp} spp, depth {depth}")
    from nrenderer_torch import cli
    from nrenderer_torch.ops import mesh_cuda, pt_cuda
    from nrenderer_torch.server.registry import get_server
    out = argv[argv.index("--out") + 1]
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise AssertionError(f"{label}: warm-up render failed")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    pt_cuda.reset_launch_counts()
    mesh_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {**pt_cuda.KERNEL_LAUNCHES, **mesh_cuda.KERNEL_LAUNCHES}
    if rc != 0:
        raise AssertionError(f"{label}: timed render failed")
    for name in kernels:
        if launches[name] <= 0:
            raise AssertionError(f"{label} launched no {name}")

    px = get_server().screen.get_pixels()[:, :, :3]
    if px.shape != (height, width, 3):
        raise AssertionError(f"{label}: image shape {px.shape}")
    if not np.isfinite(px).all() or px.min() < 0.0 or px.max() > 1.0:
        raise AssertionError(f"{label}: image not finite or outside [0, 1]")
    mean = float(px.mean())
    if not band[0] <= mean <= band[1]:
        raise AssertionError(f"{label}: image mean {mean} outside {band}")
    region, region_min = check(px, mean)
    if not os.path.getsize(out) > 0:
        raise AssertionError(f"{label}: no PNG written")
    st = {"path": label, "seconds": secs, "warmup_seconds": warm_s,
          "launches": launches, "spp_per_s": spp / secs,
          "mbounce_rays_per_s": width * height * spp * depth / secs / 1e6,
          "image_mean": mean, "check_region_mean": region,
          "check_region_above": region_min}
    print(json.dumps(st))
    if not region > region_min:
        raise AssertionError(f"{label}: checked region {region} not above "
                             f"{region_min}")
    return st


def _light_brighter(px, mean):
    """The area light's region of the Cornell image, against the mean."""
    h, w = px.shape[:2]
    light = float(px[int(0.09 * h):int(0.14 * h),
                     int(0.45 * w):int(0.55 * w)].mean())
    return light, mean


def _sky_bright(px, mean):
    """The top-left corner of the env image sees the sky."""
    h, w = px.shape[:2]
    return float(px[:h // 8, :w // 8].mean()), SKY_MIN


def phase_main_path(width=512, height=512, spp=2048, depth=20) -> dict:
    argv = _cli_argv(SCENE, "SimplePathTracer", width, height, spp, depth,
                     OUT_PNG)
    return phase_cli(5, "main path (SimplePathTracer)", argv,
                     ["pt_diffuse_kernel"], width, height, spp, depth,
                     MEAN_BAND, _light_brighter)


def phase_acc_path(width=512, height=512, spp=2048, depth=20) -> dict:
    out = os.path.join(ROOT, "build", "smoke_glass.png")
    argv = _cli_argv(GLASS_SCENE, "AccPathTracer", width, height, spp,
                     depth, out)
    return phase_cli(6, "AccPathTracer", argv, ["pt_bsdf_kernel"], width,
                     height, spp, depth, GLASS_MEAN_BAND, _light_brighter)


def phase_env_paths(width=512, height=512, spp=1024, depth=8) -> tuple:
    runs = []
    for renderer, kernel in (("AccPathTracer", "pt_bsdf_env_kernel"),
                             ("SimplePathTracer", "pt_diffuse_env_kernel")):
        out = os.path.join(ROOT, "build", f"smoke_env_{renderer}.png")
        argv = _cli_argv(ENV_SCENE, renderer, width, height, spp, depth, out,
                         env=True)
        runs.append(phase_cli(7, f"env map ({renderer})", argv, [kernel],
                              width, height, spp, depth, ENV_MEAN_BAND,
                              _sky_bright))
    return tuple(runs)


def phase_sweep(n_rays=1 << 20, seed=0) -> dict:
    """`mesh_sweep_kernel` against its plain version on rays from the
    Cornell box's interior aimed at `ico_5120.obj`, a tenth of them with a
    zero cap (dead), in natural and front-to-back block order."""
    from nrenderer_torch.ops.bvh import build_mesh_accel
    from nrenderer_torch.ops.mesh_cuda import (
        KERNEL_NAME, make_mesh_tables, sweep_mesh_full, sweep_mesh_plain)
    from nrenderer_torch.ops.pt_core import make_mat_channels, scene_epsilon
    from nrenderer_torch.ops.soa import V3
    ss, _, _, arrays = _setup("cuda", MESH_SCENE, objs=(ICO,))
    bt = build_mesh_accel(arrays, make_mat_channels(ss)).bt
    mt = make_mesh_tables(bt, "cuda")
    t_min = scene_epsilon(ss)
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(
        n_rays, generator=g, device="cuda")
    o = V3(u(-270.0, 270.0), u(-270.0, 270.0), u(760.0, 1300.0))
    tgt = V3(u(-150.0, 150.0), u(-278.0, -7.0), u(850.0, 1150.0))
    dv = torch.stack([tgt.x - o.x, tgt.y - o.y, tgt.z - o.z])
    dv = dv / torch.linalg.vector_norm(dv, dim=0)
    d = V3(dv[0].contiguous(), dv[1].contiguous(), dv[2].contiguous())
    cap = torch.where(torch.rand(n_rays, generator=g, device="cuda") < 0.1,
                      0.0, float("inf"))
    runs = {}
    for f2b in (False, True):
        label = "f2b" if f2b else "natural"
        print(f"== phase 9: {KERNEL_NAME} vs plain, ico_5120.obj "
              f"({bt.n_blocks} blocks of {bt.block}), {n_rays} rays, "
              f"{label} order")
        work = {}
        got = sweep_mesh_full(mt, o, d, t_min, t_cap=cap, f2b=f2b)
        raw = sweep_mesh_plain(mt, o, d, t_min, cap, f2b=f2b, stats=work)
        torch.cuda.synchronize()
        t_p = torch.where(raw[1] >= 0, raw[0], float("inf"))
        idx_p = raw[1].to(torch.int32)
        t_diff = int((got[0] != t_p).sum())
        idx_diff = int((got[1] != idx_p).sum())
        untied = int(((got[1] != idx_p) & (got[0] != t_p)).sum())
        hit = got[1] >= 0
        flops = (work["slab_tests"] * FLOPS_SLAB
                 + work["tri_tests"] * FLOPS_MESH_TRI)
        n_bytes = n_rays * 4 * (7 + 6) + _table_bytes(mt.tris, mt.bb)
        b_ms, b_by = _bound(flops, n_bytes)
        st = {"kernel": KERNEL_NAME, "order": label, "rays": n_rays,
              "hits": int(hit.sum()), "t_differ": t_diff,
              "idx_differ": idx_diff, "idx_differ_t_untied": untied,
              "max_abs_err": float((got[0][hit] - t_p[hit]).abs().max()),
              "finite": bool(torch.isfinite(got[0][hit]).all()),
              "kernel_ms": _time_ms(lambda: sweep_mesh_full(
                  mt, o, d, t_min, t_cap=cap, f2b=f2b), 5),
              "plain_ms": _time_ms(lambda: sweep_mesh_plain(
                  mt, o, d, t_min, cap, f2b=f2b), 1),
              "bound_ms": b_ms, "bound_by": b_by,
              "slab_tests": work["slab_tests"],
              "tri_tests": work["tri_tests"]}
        print(json.dumps(st))
        if t_diff or untied or not st["finite"] or st["hits"] < n_rays // 10:
            raise AssertionError(f"{KERNEL_NAME} ({label}) disagrees with "
                                 f"its plain version: {st}")
        runs[label] = (st, got)
    moved = int((runs["natural"][1][0] != runs["f2b"][1][0]).sum())
    print(f"natural vs f2b order: t differs on {moved} rays; triangle "
          f"tests {runs['natural'][0]['tri_tests']} -> "
          f"{runs['f2b'][0]['tri_tests']}")
    return runs["natural"][0]


def _blob_lit(px, mean):
    """The blob's lit body against the floor in its shadow, just below
    its base in the image."""
    h, w = px.shape[:2]
    blob = float(px[int(0.58 * h):int(0.7 * h),
                    int(0.42 * w):int(0.58 * w)].mean())
    shadow = float(px[int(0.88 * h):int(0.92 * h),
                      int(0.45 * w):int(0.55 * w)].mean())
    return blob, shadow


def _red_left(px, mean):
    """The grid's left half red, its right half green: returns the
    smaller of the two margins, held above 0."""
    h, w = px.shape[:2]
    rows = slice(int(0.3 * h), int(0.7 * h))
    left = px[rows, int(0.2 * w):int(0.45 * w)].mean(axis=(0, 1))
    right = px[rows, int(0.55 * w):int(0.8 * w)].mean(axis=(0, 1))
    return float(min(left[0] - left[1], right[1] - right[0])), 0.0


def phase_mesh_path(width=500, height=500, spp=256, depth=20) -> dict:
    out = os.path.join(ROOT, "build", "smoke_blob.png")
    argv = _cli_argv(MESH_SCENE, "AccPathTracer", width, height, spp, depth,
                     out, objs=(BLOB,))
    return phase_cli(10, "mesh path (AccPathTracer, blob_960)", argv,
                     ["pt_bsdf_mesh_kernel"], width, height, spp, depth,
                     MESH_MEAN_BAND, _blob_lit)


def phase_tex_paths(width=256, height=256, spp=512, depth=6) -> tuple:
    runs = []
    for label, renderer, obj, kernel, env, band, check in (
            ("textured grid", "AccPathTracer", TEX_GRID,
             "pt_bsdf_mesh_tex_kernel", False, GRID_MEAN_BAND, _red_left),
            ("untextured twin", "AccPathTracer", TEX_GRID_PLAIN,
             "pt_bsdf_mesh_kernel", False, PLAIN_GRID_MEAN_BAND,
             lambda px, mean: (mean, 0.0)),
            ("textured quad", "SimplePathTracer", TEX_QUAD,
             "pt_diffuse_tex_kernel", False, GRID_MEAN_BAND, _red_left),
            ("textured quad", "AccPathTracer", TEX_QUAD,
             "pt_bsdf_tex_kernel", False, GRID_MEAN_BAND, _red_left),
            ("textured quad, env map", "SimplePathTracer", TEX_QUAD,
             "pt_diffuse_env_tex_kernel", True, QUAD_ENV_MEAN_BAND,
             _red_left),
            ("textured quad, env map", "AccPathTracer", TEX_QUAD,
             "pt_bsdf_env_tex_kernel", True, QUAD_ENV_MEAN_BAND,
             _red_left)):
        out = os.path.join(ROOT, "build",
                           f"smoke_{kernel.replace('_kernel', '')}.png")
        argv = _cli_argv(TEX_SCENE, renderer, width, height, spp, depth,
                         out, env=env, objs=(obj,))
        runs.append(phase_cli(11, f"{label} ({renderer})", argv, [kernel],
                              width, height, spp, depth, band, check))
    print(f"textured grid / untextured twin: "
          f"{runs[0]['seconds'] / runs[1]['seconds']:.3f}x "
          f"({runs[0]['seconds']:.3f} s / {runs[1]['seconds']:.3f} s)")
    return tuple(runs)


def main() -> int:
    gpu = phase_toolchain()
    phase_build()
    phase_hash()
    # (kernel name, its main path's parity shape) -> stats
    parity = {}
    for scene, bsdf, env, depth in ((SCENE, False, False, 20),
                                    (GLASS_SCENE, True, False, 20),
                                    (ENV_SCENE, False, True, 8),
                                    (ENV_SCENE, True, True, 8)):
        phase_parity(64, 64, 16, 4, scene=scene, bsdf=bsdf, env=env)
        st = phase_parity(512, 512, 4, depth, scene=scene, bsdf=bsdf,
                          env=env)
        parity[st["kernel"]] = st
    for scene, objs, bsdf, env, mesh, tex, size, depth in (
            (MESH_SCENE, (BLOB,), True, False, True, False, 500, 20),
            (TEX_SCENE, (TEX_QUAD,), False, False, False, True, 256, 6),
            (TEX_SCENE, (TEX_QUAD,), True, False, False, True, 256, 6),
            (TEX_SCENE, (TEX_QUAD,), False, True, False, True, 256, 6),
            (TEX_SCENE, (TEX_QUAD,), True, True, False, True, 256, 6),
            (TEX_SCENE, (TEX_GRID,), True, False, True, True, 256, 6)):
        kw = dict(scene=scene, objs=objs, bsdf=bsdf, env=env, mesh=mesh,
                  tex=tex, phase=8)
        phase_parity(64, 64, 16, 4, **kw)
        st = phase_parity(size, size, 4, depth, **kw)
        parity[st["kernel"]] = st
    sweep = phase_sweep()
    paths = [phase_main_path(), phase_acc_path(), *phase_env_paths(),
             phase_mesh_path(), *phase_tex_paths()]
    launches = {}
    for run in paths:
        for name, n in run["launches"].items():
            if n:
                launches[name] = launches.get(name, 0) + n
    from nrenderer_torch.ops import mesh_cuda, pt_cuda
    for run in paths:
        print(f"{run['path']}: {run['seconds']:.3f} s, "
              f"{run['spp_per_s']:.1f} spp/s, "
              f"{run['mbounce_rays_per_s']:.1f} Mbounce-rays/s on {gpu}")
    print(gpu)
    kernels = [{
        "name": name, "route": "cuda", "source": pt_cuda.KERNEL_SOURCE,
        "replaces": pt_cuda.REPLACES[name],
        "launches": launches.get(name, 0),
        "max_abs_err": st["max_abs_err"],
        "ms": st["kernel_ms"], "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "library_ms": None} for name, st in parity.items()]
    # the standalone sweep is the hybrid route's (not driven here); its
    # device function runs inline in the mesh forms' launches
    kernels.append({
        "name": mesh_cuda.KERNEL_NAME, "route": "cuda",
        "source": mesh_cuda.KERNEL_SOURCE, "replaces": mesh_cuda.REPLACES,
        "launches": launches.get(mesh_cuda.KERNEL_NAME, 0),
        "max_abs_err": sweep["max_abs_err"], "ms": sweep["kernel_ms"],
        "plain_ms": sweep["plain_ms"], "bound_ms": sweep["bound_ms"],
        "bound_by": sweep["bound_by"], "library_ms": None,
        "inlined_in": ["pt_bsdf_mesh_kernel", "pt_bsdf_mesh_tex_kernel"],
        "inlined_launches": launches.get("pt_bsdf_mesh_kernel", 0)
        + launches.get("pt_bsdf_mesh_tex_kernel", 0)})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
