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
     the image must be finite, in [0, 1], in its band, and the sky bright.

Each of phases 5-7 sets every launch count to 0 just before its run and
reads the counts just after; a kernel its path runs must have launched.
The last two lines are the kernels' JSON record and
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


def _setup(device, scene_path=SCENE, env=False):
    from nrenderer_torch import build_scene_arrays, load_scn
    from nrenderer_torch.io.image import load_image
    from nrenderer_torch.ops.camera import make_camera
    from nrenderer_torch.ops.intersect import make_static_scene
    scene = load_scn(scene_path)
    ss = make_static_scene(build_scene_arrays(scene))
    env_map = load_image(ENV_MAP)[:, :, :3] if env else None
    return ss, make_camera(scene.camera, device=device), env_map


def _time_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ss, n_pix: int, work: dict, env_map) -> tuple:
    """The least time the card could take for one kernel call: the larger
    of its FP32 operations over the FP32 peak and the bytes it must move
    (film read and written, scene table and env tables read once) over the
    memory rate.  `work` is the plain version's count of samples and of
    bounces of live paths on the same inputs (data-dependent)."""
    from nrenderer_torch.ops.pt_cuda import pack_scene
    per_bounce = (len(ss.sph) * FLOPS_SPHERE + len(ss.tri) * FLOPS_TRIANGLE
                  + (len(ss.pln) + len(ss.al)) * FLOPS_PATCH + FLOPS_SCATTER)
    flops = work["samples"] * FLOPS_SAMPLE + work["bounces"] * per_bounce
    n_bytes = 2 * n_pix * 3 * 4 + pack_scene(ss)[0].nbytes
    if env_map is not None:
        flops += work["samples"] * FLOPS_ENV_LOOKUP
        n_bytes += env_map.size * 4 + 3 * 32 * 128 * 4
    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def phase_parity(width, height, spp, depth, seed=0, scene=SCENE,
                 bsdf=False, env=False) -> dict:
    from nrenderer_torch.ops.pt_core import scene_epsilon
    from nrenderer_torch.ops.pt_cuda import (
        kernel_name, make_env_tables, pt_accumulate, pt_accumulate_plain)
    name = kernel_name(bsdf, env)
    print(f"== phase 4: {name} vs plain, {os.path.basename(scene)}, "
          f"{width}x{height}, {spp} spp, depth {depth}")
    ss, cam, env_map = _setup("cuda", scene, env)
    t_min = scene_epsilon(ss)
    n_pix = width * height
    tables = make_env_tables(env_map, "cuda") if env else None
    work = {}

    def kernel():
        film = torch.zeros((n_pix, 3), dtype=torch.float32, device="cuda")
        return pt_accumulate(film, ss, cam, width, height, 0, spp, depth,
                             seed, t_min, bsdf=bsdf, env=tables)

    def plain(stats=None):
        film = torch.zeros((n_pix, 3), dtype=torch.float32, device="cuda")
        return pt_accumulate_plain(film, ss, cam, width, height, 0, spp,
                                   depth, seed, t_min, bsdf=bsdf, env=tables,
                                   stats=stats)

    lin_k = kernel()
    lin_p = plain(work)
    torch.cuda.synchronize()
    img = lambda f: torch.sqrt(torch.clamp(f * (1.0 / spp), min=0.0))
    diff = (img(lin_k) - img(lin_p)).abs()
    pix = diff.max(dim=1).values
    b_ms, b_by = bound_ms(ss, n_pix, work, env_map)
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


def _cli_argv(scene, renderer, width, height, spp, depth, out, env=False):
    argv = ["render", "--scene", scene, "--renderer", renderer,
            "--width", str(width), "--height", str(height), "--spp",
            str(spp), "--depth", str(depth), "--device", "cuda",
            "--out", out]
    return argv + (["--env-map", ENV_MAP] if env else [])


def phase_cli(phase, label, argv, kernels, width, height, spp, depth,
              band, check) -> dict:
    """One path through `cli.main`: a warm-up run, then a timed run with
    every launch count set to 0 just before it and read just after."""
    print(f"== phase {phase}: {label}, cli render {width}x{height}, "
          f"{spp} spp, depth {depth}")
    from nrenderer_torch import cli
    from nrenderer_torch.ops import pt_cuda
    from nrenderer_torch.server.registry import get_server
    out = argv[argv.index("--out") + 1]
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise AssertionError(f"{label}: warm-up render failed")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    pt_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(pt_cuda.KERNEL_LAUNCHES)
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
          "image_mean": mean, "check_region_mean": region}
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
    paths = [phase_main_path(), phase_acc_path(), *phase_env_paths()]
    launches = {}
    for run in paths:
        for name, n in run["launches"].items():
            if n:
                launches[name] = n
    from nrenderer_torch.ops import pt_cuda
    for run in paths:
        print(f"{run['path']}: {run['seconds']:.3f} s, "
              f"{run['spp_per_s']:.1f} spp/s, "
              f"{run['mbounce_rays_per_s']:.1f} Mbounce-rays/s on {gpu}")
    print(gpu)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": pt_cuda.KERNEL_SOURCE,
        "replaces": pt_cuda.REPLACES[name],
        "launches": launches.get(name, 0),
        "max_abs_err": st["max_abs_err"],
        "ms": st["kernel_ms"], "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "library_ms": None} for name, st in parity.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
