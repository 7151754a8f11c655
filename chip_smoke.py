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
  4. the path-tracing kernel against its plain torch version on the same
     CUDA inputs: the Cornell box at 64x64, 16 spp, depth 4, and at the main
     path's own shapes (512x512, depth 20, a few spp), with times for both;
  5. the main path, `nrenderer_torch.cli.main(["render", ...])` at 512x512,
     2048 spp, depth 20 on the GPU: once to warm up, once timed with its
     kernel launches counted; the image must be finite, in [0, 1], within a
     plausible brightness band and bright where the light is.

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
SCENE = os.path.join(ROOT, "resource", "cornell_box.scn")
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

# Phase-5 image bars: a converged 512x512 render of resource/cornell_box.scn
# has a mean near 0.45 (plain version on the CPU, 128x128, 512 spp).
MEAN_BAND = (0.25, 0.75)


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


def _setup(device):
    from nrenderer_torch import build_scene_arrays, load_scn
    from nrenderer_torch.ops.camera import make_camera
    from nrenderer_torch.ops.intersect import make_static_scene
    scene = load_scn(SCENE)
    ss = make_static_scene(build_scene_arrays(scene))
    return ss, make_camera(scene.camera, device=device)


def _time_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_parity(width, height, spp, depth, seed=0) -> dict:
    print(f"== phase 4: kernel vs plain, {width}x{height}, {spp} spp, "
          f"depth {depth}")
    from nrenderer_torch.ops.pt_core import scene_epsilon
    from nrenderer_torch.ops.pt_cuda import (
        pt_accumulate_plain, render_pt_linear)
    ss, cam = _setup("cuda")
    t_min = scene_epsilon(ss)
    n_pix = width * height

    def kernel():
        return render_pt_linear(ss, cam, width, height, spp, depth,
                                seed=seed, t_min=t_min, device="cuda")

    def plain():
        film = torch.zeros((n_pix, 3), dtype=torch.float32, device="cuda")
        return pt_accumulate_plain(film, ss, cam, width, height, 0, spp,
                                   depth, seed, t_min)

    lin_k = kernel()
    lin_p = plain()
    torch.cuda.synchronize()
    img = lambda f: torch.sqrt(torch.clamp(f * (1.0 / spp), min=0.0))
    diff = (img(lin_k) - img(lin_p)).abs()
    pix = diff.max(dim=1).values
    st = {
        "max_abs_err": float(diff.max()),
        "mean_abs_err": float(diff.mean()),
        "share_within_1e-4": float((pix <= WITHIN).float().mean()),
        "share_within_1e-3": float((pix <= 1e-3).float().mean()),
        "finite": bool(torch.isfinite(lin_k).all()),
        "kernel_ms": _time_ms(kernel, 3),
        "plain_ms": _time_ms(plain, 1),
    }
    print(json.dumps({"shape": [width, height, spp, depth], **st}))
    if not st["finite"]:
        raise AssertionError("kernel film has non-finite values")
    if st["mean_abs_err"] > MEAN_ABS_MAX:
        raise AssertionError(f"mean |kernel - plain| {st['mean_abs_err']} "
                             f"> {MEAN_ABS_MAX}")
    if st["share_within_1e-4"] < WITHIN_SHARE_MIN:
        raise AssertionError(
            f"only {st['share_within_1e-4']:.4f} of pixels within {WITHIN} "
            f"(need {WITHIN_SHARE_MIN})")
    return st


def _main_path_argv(width, height, spp, depth):
    return ["render", "--scene", SCENE, "--renderer", "SimplePathTracer",
            "--width", str(width), "--height", str(height), "--spp",
            str(spp), "--depth", str(depth), "--device", "cuda",
            "--out", OUT_PNG]


def phase_main_path(width=512, height=512, spp=2048, depth=20) -> dict:
    print(f"== phase 5: main path, cli render {width}x{height}, {spp} spp, "
          f"depth {depth}")
    from nrenderer_torch import cli
    from nrenderer_torch.ops import pt_cuda
    from nrenderer_torch.server.registry import get_server
    os.makedirs(os.path.dirname(OUT_PNG), exist_ok=True)
    argv = _main_path_argv(width, height, spp, depth)
    t0 = time.perf_counter()
    if cli.main(argv) != 0:
        raise AssertionError("warm-up render failed")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    pt_cuda.KERNEL_LAUNCHES = pt_cuda.HASH_LAUNCHES = 0
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = pt_cuda.KERNEL_LAUNCHES
    if rc != 0:
        raise AssertionError("timed render failed")
    if launches <= 0:
        raise AssertionError("the main path launched no path-tracing kernel")

    px = get_server().screen.get_pixels()[:, :, :3]
    if px.shape != (height, width, 3):
        raise AssertionError(f"image shape {px.shape}")
    if not np.isfinite(px).all() or px.min() < 0.0 or px.max() > 1.0:
        raise AssertionError("image not finite or outside [0, 1]")
    mean = float(px.mean())
    light = float(px[int(0.09 * height):int(0.14 * height),
                     int(0.45 * width):int(0.55 * width)].mean())
    if not MEAN_BAND[0] <= mean <= MEAN_BAND[1]:
        raise AssertionError(f"image mean {mean} outside {MEAN_BAND}")
    if not light > mean:
        raise AssertionError(f"light region {light} not brighter than the "
                             f"mean {mean}")
    if not os.path.getsize(OUT_PNG) > 0:
        raise AssertionError("no PNG written")
    st = {"seconds": secs, "warmup_seconds": warm_s, "launches": launches,
          "spp_per_s": spp / secs,
          "mbounce_rays_per_s": width * height * spp * depth / secs / 1e6,
          "image_mean": mean, "light_region_mean": light}
    print(json.dumps(st))
    return st


def main() -> int:
    gpu = phase_toolchain()
    phase_build()
    phase_hash()
    small = phase_parity(64, 64, 16, 4)
    full = phase_parity(512, 512, 4, 20)
    main_run = phase_main_path()
    from nrenderer_torch.ops import pt_cuda
    print(f"plain vs kernel at 64x64/16/4: {small['plain_ms']:.3f} ms vs "
          f"{small['kernel_ms']:.3f} ms; main path {main_run['seconds']:.3f} "
          f"s, {main_run['spp_per_s']:.1f} spp/s, "
          f"{main_run['mbounce_rays_per_s']:.1f} Mbounce-rays/s on {gpu}")
    print(gpu)
    print(json.dumps({"kernels": [{
        "name": "pt_diffuse_kernel", "route": "cuda",
        "source": pt_cuda.KERNEL_SOURCE, "replaces": pt_cuda.REPLACES,
        "launches": main_run["launches"],
        "max_abs_err": full["max_abs_err"],
        "ms": full["kernel_ms"], "plain_ms": full["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
