#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one GPU
    python3 chip_smoke.py --multi-gpu   # only the runs across every GPU

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without a result line:

  1. toolchain: nvidia-smi name and power limit, torch, CUDA, nvcc, device;
  2. build the kernel library from `nrenderer_torch/csrc` with nvcc;
  3. the kernel's device hash against the plain torch `hash_uniform`, bit
     for bit, over a grid of (pixel, sample, draw, seed) with negative and
     wrapping seeds;
  4. each analytic form of the path-tracing kernel (the flat loop of
     `pt_dense_kernel`) against its plain torch version on the same CUDA
     inputs, with times for both and the least time the card could take
     (the bound): the diffuse form on the Cornell box, the BSDF form on
     `resource/pt_glass_box.scn`, the diffuse and BSDF env forms on
     `resource/env_spheres.scn` under `resource/env_sky.png`; each at
     64x64, 16 spp, depth 4, at 512x512, 4 spp and its path's depth (20,
     env 8), at a ragged split shape (61x37, 33 spp as 20 + 13, depth 0, 1
     and 6, thin lens) and at one launch of its path's own size (512x512,
     the spp of `pt_cuda.launch_plan`; its record); the films bit for bit
     at every shape, each with its loop's lane slots (`pt_cuda.loop_slots`:
     the flat loop's useful share beside the nested loop's);
  5. the main path, `nrenderer_torch.cli.main(["render", ...])` at 512x512,
     2048 spp, depth 20 on the GPU: once to warm up, once timed with its
     kernel launches counted; the image must be finite, in [0, 1], within a
     plausible brightness band and bright where the light is;
  6. the AccPathTracer path: `cli.main` on `pt_glass_box.scn` at 512x512,
     2048 spp, depth 20, checked the same way;
  7. the env-map paths: `cli.main --env-map` on `env_spheres.scn` at
     512x512, 1024 spp, depth 8, with AccPathTracer and SimplePathTracer;
     the image must be finite, in [0, 1], in its band, and the sky bright;
  8. the texture and mesh forms against their plain versions, as phase 4:
     the four dense texture forms on `tex_quad.obj` (with and without
     `env_sky.png`) at phase 4's shapes with 256x256/4/6 and one launch of
     the textured path's own size (256x256, 512 spp, depth 6) in place of
     512x512; `pt_bsdf_mesh_kernel` on `resource/mesh_box.scn` +
     `blob_960.obj` at 64x64/16/4 and 500x500/4/20 and
     `pt_bsdf_mesh_tex_kernel` on `tex_grid.obj` at 64x64/16/4 and
     256x256/4/6, with the sweep's schedule counts (triangle-test lane
     slots of the per-lane and the warp-cooperative sweep) and the loop's
     counters (`pt_cuda.mesh_loop_slots`: the live lane slots held to the
     plain version's bounces and all its slots to the CPU model of the
     loop, `mesh_slots`, exactly); every film bit for bit; then B1e at the
     mesh cell's launch (`ico_5120.obj`, 500x500, 32 spp, depth 20) timed,
     with its counters, and bit for bit on a band of 8 rows through the
     ball (as phase 32's B1e);
  9. `mesh_sweep_kernel` on `ico_5120.obj` against its plain version, 2^20
     rays aimed at the mesh, natural and front-to-back block order: every
     output bit for bit (t and idx on every ray), with time, bound and
     schedule counts; then prefixes of those rays at ragged counts (1, 31,
     33, 32 k + 5, with dead lanes) and `tie_pool()` (exact ties: repeated
     triangles, shared edges, faces on block boxes) in blocks of 16 and
     128, both orders, and `mesh_sweep_mxu_kernel` (B4) on each of them,
     bit for bit;
 10. the mesh path: AccPathTracer `--obj blob_960.obj` on `mesh_box.scn`
     at 500x500, 256 spp, depth 20 (the megamesh route); the blob must be
     brighter than the floor in its shadow;
 11. the textured paths: AccPathTracer on `tex_grid.obj` at 256x256, 512
     spp, depth 6, and on its untextured twin (the ratio of their times is
     printed); the dense textured quad with SimplePathTracer and
     AccPathTracer, without and with the env map; the grid's left half
     must be red and its right half green;
 12. the streaming compactor (`stream_pack_kernel`, `stream_unpack_kernel`)
     against its plain versions at 2^24 lanes: an 11-channel stage pack
     (o, d, throughput, keep, and the lane id as int32 words) into 2^23
     slots and a 7-channel mesh pack (o, d, t_cap) into 2^22 slots, over
     random 40%, screen-clustered 20%, empty, full and tail masks and the
     kernels' edges: live lanes only in every 37th tile, dead mask words
     of -0.0 and NaN, and caps at count, count - 1 and inside a tile;
     each pack twice in a row (its look-back scratch is cleared every
     call); the packed buffer, the count, the tile offsets and the round
     trip bit for bit (the largest word difference is printed); kernel,
     plain, library (`x[:, mask]`, `fill_` + `masked_scatter_`) and bound
     times;
 13. the hybrid route (staged wavefront, mesh pipe) with its kernels
     against itself with the plain versions on `ico_5120.obj` at 128x128,
     8 spp, depth 13 (bit for bit), and against `pt_bsdf_mesh_kernel` on
     `blob_960.obj` at the same shape (phase 4's bars); then one sorted
     mesh-pipe bounce of the hybrid path's own chunk (500x500, 64 spp: 16
     Mi lanes, cap 4 Mi) with the pack and unpack against their plain
     versions bit for bit and the sweep on the whole sorted live prefix
     (bit for bit, timed, with its bound and schedule counts);
 14. the hybrid path: AccPathTracer `--obj ico_5120.obj` on `mesh_box.scn`
     at 500x500, 256 spp, depth 20 (staged, 4 chunks of 64 spp); the
     overflow full sweeps, roulette firings and peak memory are printed,
     and the ball must be brighter than the floor in its shadow; a second
     row the same on the 81,920-face icosphere (640 blocks; written into
     build/ by `tools/make_mesh_fixtures.py`'s `large_icosphere`);
 15. the env + mesh path: `--obj blob_960.obj --env-map env_sky.png` on
     `mesh_box.scn` at 512x512, 256 spp, depth 8 (the env row's 1024 spp
     cut to 256 to fit the script's time; unstaged), checked as phase 14;
 16. where one chunk of the hybrid path's time goes (64 spp of 500x500):
     bounce math, top-AABB test, pack, sort, sweep, unpack, stage packs
     and banking, each timed between device synchronisations;
 17. `mesh_sweep_mxu_kernel` (the MXU sweep, B4) against its plain version
     on phase 9's 2^20 rays at `ico_5120.obj`, every output bit for bit,
     with its flip and same-triangle shares against B2 on the same rays
     and each ray where the two engines part printed beside a float64
     intersection (their count barred); its schedule counts (pairs and
     batches), its `-Xptxas -v` line, and the `-Xptxas -v` figures of the
     path-tracing kernels (the sixteen `pt_dense_kernel` instantiations,
     the two mesh forms) and B2 held to their recorded figures
     (`KEPT_PTXAS`);
 18. the hybrid path of phase 14 under NR_MESH_MXU=1: every sweep on B4,
     the image within bars of phase 14's; then B4 against its plain
     version, bit for bit and timed, with its schedule counts, on phase
     13's sorted live prefix;
 19. MetropolisLightTransport on `cornell_box.scn` through `cli.main`:
     512x512, 1024 chains x 256 mutations, depth 20 (dense primitives, no
     kernel of its own);
 20. MLT on `mesh_box.scn` + `blob_960.obj` at 128x128, 1024 x 256, depth
     8, on B2 and under NR_MESH_MXU=1 on B4 (each engine's launches
     counted, the other's 0; each engine's kernel against its plain
     version, bit for bit and timed, with its schedule counts, on one
     path batch (2048 rays) and one shadow batch that the B2 run swept,
     and B4 also on its own run's):
     the two images' linear means within 5% and
     their 8x8-block correlation >= 0.9, and the ratio of their linear
     radiance to AccPathTracer's on the same scene;
 21. SimplePathTracer's progressive route: `cli.main(["render",
     "--progressive", ...])` on the Cornell box at 512x512, 2048 spp,
     depth 20 (256 passes of `pick_chunk`'s 8 spp, each at seed
     seed * 100003 + pass): B1a launched once a pass, the image in phase
     5's bars and against phase 5's image (an independent estimate:
     linear means within 5%, 8x8-block correlation >= 0.9), the passes'
     and the host previews' seconds; its last pass, kernel against plain
     version bit for bit and timed; the env form (env_spheres.scn, 512x512,
     1024 spp, depth 8) and the dense textured form (tex_quad.obj,
     256x256, 512 spp, depth 6) under --progressive; a scene without
     primitives through one pass (the ambient at depth 0, black past it);
 22. resume on the card: a `--checkpoint` render (512x512, 64 spp, depth
     20) that dies in its third pass, run again, ends bit for bit on the
     uninterrupted render;
 23. the camera flags: `--aperture 0.01 --fov 42 --camera-position 0 0
     12` at 128x128, 64 spp, depth 20 through the CLI;
 24. RayCast (the Cornell box with a point light, 512x512) and
     GeometryPreview (mesh_box.scn + ico_5120.obj, decimated to 1024
     faces and capped at 256 a side, and whole: 5120 triangles through the
     chunked SoA intersect): torch ops on the card against the same
     module on the CPU, >= 99.9% of pixels within 1e-5, with times and
     peak device memory;
 25. an editor round: `SceneEditor` on the Cornell box applies one
     document edit (the red wall's diffuse colour, the camera position),
     a snapshot gets a GeometryPreview and a SimplePathTracer render on the
     card (128x128, 64 spp, depth 20); the wall must turn from red to blue;
 26. every kernel form over pixel ranges (a band of rows, a ragged range,
     the last pixel) at 61x37, 6 spp, depth 4: each range's film the full
     film's rows bit for bit;
 27. the main path split across ranks through `parallel.mesh`
     (SimplePathTracer, Cornell box, 512x512, 2048 spp, depth 20): on an
     NCCL world of one ([cuda:0]) by samples and by pixels, its film and
     image bit for bit with the one-device `render_pt_linear` film and its
     gamma on the card, on two gloo ranks sharing cuda:0 by samples
     (within `shard_rtol`) and by pixel bands (bit for bit), and, where
     there are N >= 2 GPUs, on N NCCL ranks the same two ways; each with
     its render and collective times beside the one-device render's;
 28. the same for AccPathTracer on pt_glass_box.scn (512x512, 2048 spp,
     depth 20);
 29. the mesh routes on two ranks sharing cuda:0 against their one-device
     renders: the megamesh route (blob_960.obj, 256x256, 256 spp) by
     samples, the hybrid route (ico_5120.obj, 256x256, 64 spp, depth 20)
     by samples and by pixels, and MLT on blob_960.obj (128x128, 1024
     chains x 64 mutations, depth 8; also on N NCCL ranks where there are
     N >= 2 GPUs), their B1e/B2/B3 launches counted on the ranks (at most
     twice one device's), the MLT image within rounding of one device's;
 30. a sharded checkpointed render (two ranks, 4 passes) stopped after two
     passes and run again: bit for bit with the straight run;
 31. `cli.main(["render", "--devices", "2", ...])` on a one-GPU machine
     exits 2 with its message (with N >= 2 GPUs it renders on N NCCL
     ranks and must write the one-device PNG).

 32. the large mesh: the 81,920-face icosphere's host prep with the host
     library and with its numpy versions (NR_NO_NATIVE=1; the blocked
     tables equal), AccPathTracer on it through `cli.main` at 500x500, 256
     spp, depth 20 on the route the card's threshold picks (route, blocks,
     render and CLI wall, scene-prep and bvh-build with each, the two
     images bit for bit, peak memory, the hybrid route's counters), its
     image against phase 14's ico_5120 image (linear means within 2%,
     8x8-block correlation >= 0.95); B1e at its 640 blocks (a 32-spp
     launch timed, and on a band of 8 rows bit for bit against its plain
     version, with the bound from the plain version's counts); phase 13's
     mesh pipe on it (B3a, B2 and B3b bit for bit, B2 timed with its bound
     and schedule counts); the phase's seconds on a line of their own.
33. the hybrid bounce's kernels (`wavefront_dense_hit_kernel`,
    `wavefront_shade_kernel`) on the 81,920-face icosphere at the
    large-mesh cell's shapes: bounce 1 of a 500x500, 64-spp chunk (16 Mi
    lanes) and bounce 6 after the stage pack into n / 2 slots; the fused
    bounce against the eager one and each kernel against its plain version
    bit for bit, each kernel timed beside its bound and its plain
    version, the whole bounce in both forms beside the mesh pipe's time.

Phases 13, 14 (both rows), 18 and 29's hybrid half measure the hybrid
route: 14, 18 and 29 pin the CPU's megamesh limit (1024 triangles, the
card's too before its crossover was measured;
`routes.pinned_megamesh_max_tris`) for their runs, so ico_5120.obj stays
on it whatever the card's threshold (phase 29's ranks render the plan of
the launching process); 13 and 16 build the hybrid render function
directly, and phase 15's env map takes the hybrid route on any pool.

Each of phases 5-7, 10, 11, 14, 15, 18-21, 23 and 32 sets every launch count
to 0 just before its run and reads the counts just after (phases 22 and
25 reset and read B1a's); a kernel its path runs must have launched.  In
phases 27-30 each rank sets its counts to 0 before it renders and rank 0
sums them over the ranks ("sharded_launches" in the kernels' record).  The
last two lines are the kernels' JSON record and `{"ok": true, "device":
{...}}`.  Imports nothing of JAX.

`--multi-gpu` runs only what needs more than one GPU, on every GPU of the
machine: the N-rank NCCL runs of phases 27-29 with their one-device
references, and phase 31's `--devices N`; it ends with the same last line.
"""
from __future__ import annotations

import contextlib
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

# Image bars between two estimates of one image that may part on a few
# paths.  Kernel and plain version draw the same hash uniforms and, with
# the kernel built without FMA contraction, round every operation alike:
# phases 4 and 8 hold every form's film bit for bit (max |d| = 0).  A
# rounding difference would move a few hits across a primitive's edge and
# flip those paths; an FMA build flipped 0.3% of pixels at 64x64/16/4
# (mean |d| 1.1e-3).
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
# mesh_box.scn + ico_5120.obj near 0.32 (the ball 0.43, the floor in its
# shadow 0.02; 64x64, 64 spp, depth 20), + blob_960.obj under env_sky.png
# near 0.47 (the blob 0.63, its shadow 0.34; 64x64, 64 spp, depth 8): the
# hybrid route's plain versions on the CPU.
ICO_MEAN_BAND = (0.22, 0.5)
HYBRID_KERNELS = ["mesh_sweep_kernel", "stream_pack_kernel",
                  "stream_unpack_kernel", "wavefront_dense_hit_kernel",
                  "wavefront_shade_kernel"]
HYBRID_MXU_KERNELS = ["mesh_sweep_mxu_kernel", "stream_pack_kernel",
                      "stream_unpack_kernel", "wavefront_dense_hit_kernel",
                      "wavefront_shade_kernel"]
# MLT (plain versions on the CPU, seed 0): cornell_box.scn near 0.47 (its
# light 0.78; 64x64, 1024 chains x 32 mutations, depth 20), mesh_box.scn +
# blob_960.obj near 0.47 (the blob 0.45, the floor in its shadow 0.35;
# 64x64, 1024 x 32, depth 8)
MLT_MEAN_BAND = (0.3, 0.65)
MLT_MESH_MEAN_BAND = (0.3, 0.65)
# B4 against B2 on phase 17's 2^20 rays: rays that hit on one side only
# or whose t differs by more than 1e-3 relative.  Two float formulas
# decide a ray that crosses the edge shared by two triangles differently
# (one can reject both and pass through to the surface behind); each such
# ray is printed with a float64 intersection beside it.  Measured: 3 such
# rays on an H100 (this phase); the bar is ~5x that.
EDGE_RAYS_MAX = 16
# B4's image against B2's on the hybrid path: a path whose ray crosses an
# edge can flip, and a 500x500, 256 spp, depth 20 render traces ~5000
# ray-bounces a pixel.  Read on an H100 in three runs (the path is
# deterministic): mean |d| 3.77e-5 and 0.98997 of pixels within 1e-4; the
# bars are ~4x the mean and a share 1 point under the reading.
ENGINE_WITHIN_SHARE_MIN = 0.98
ENGINE_MEAN_ABS_MAX = 1.5e-4
ENV_MESH_MEAN_BAND = (0.35, 0.65)
GRID_MEAN_BAND = (0.1, 0.3)
PLAIN_GRID_MEAN_BAND = (0.2, 0.4)
QUAD_ENV_MEAN_BAND = (0.5, 0.8)

# The card's peaks for the bound.  HBM bandwidth: NVIDIA's H100 SXM data
# sheet, at the full 700 W power limit.  FP32 outside the tensor cores: the
# data sheet's 67 TFLOP/s counts a fused multiply-add as two operations,
# but the kernels are built with -fmad=false, so every operation counted
# below is one instruction: the peak is the SMs x 128 FP32 lanes x the
# SM clock (nvidia-smi clocks.max.sm; 132 x 128 x 1980 MHz = 33.45e12).
PEAK_BYTES_PER_S = 3.35e12
FP32_LANES_PER_SM = 128
_peak_fp32 = []


def peak_fp32() -> float:
    """FP32 instructions a second of the card: SMs x lanes x max SM clock."""
    if not _peak_fp32:
        mhz = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60).stdout.split()[0]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        _peak_fp32.append(sms * FP32_LANES_PER_SM * float(mhz) * 1e6)
    return _peak_fp32[0]


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
# the MXU sweep (csrc/mesh_sweep_mxu.cu): one triangle test of an entered
# block (four 10-term forms, 72, and the sign fold and accept tests, 18)
FLOPS_MXU_TRI = 90
# `-Xptxas -v` of the path-tracing and sweep kernels, read from builds on
# an H100 (sm_90a): (stack frame, spill stores, spill loads, registers), by
# the kernel's mangled name past its translation unit's prefix.
# pt_dense_kernel<kBsdf, kEnv, kTex, kRange> (the eight forms without a
# mesh, 64 registers at most at 8 blocks an SM: B1a with its float4
# records), pt_mesh_kernel<kTex> (B1e, B1d's mesh form) and
# mesh_sweep_kernel<kUv> (B2), and the hybrid bounce's
# wavefront_dense_hit_kernel and wavefront_shade_kernel.  A change to one
# kernel must leave the others' figures as they are.  Each dense-pool form
# has a whole-film instantiation (kRange false: the main path's, as before
# the pixel range) and a range one (one or two registers more in the BSDF
# form and the BSDF texture forms, two fewer in the diffuse texture forms).
KEPT_PTXAS = {
    "15pt_dense_kernelILb0ELb0ELb0ELb0EE": (24, 44, 24, 64),
    "15pt_dense_kernelILb1ELb0ELb0ELb0EE": (0, 0, 0, 61),
    "15pt_dense_kernelILb0ELb0ELb0ELb1EE": (24, 44, 24, 64),
    "15pt_dense_kernelILb1ELb0ELb0ELb1EE": (0, 0, 0, 62),
    "15pt_dense_kernelILb0ELb1ELb0ELb0EE": (32, 0, 0, 63),
    "15pt_dense_kernelILb1ELb1ELb0ELb0EE": (32, 0, 0, 56),
    "15pt_dense_kernelILb0ELb0ELb1ELb0EE": (32, 0, 0, 63),
    "15pt_dense_kernelILb1ELb0ELb1ELb0EE": (56, 0, 0, 58),
    "15pt_dense_kernelILb0ELb1ELb1ELb0EE": (32, 0, 0, 63),
    "15pt_dense_kernelILb1ELb1ELb1ELb0EE": (56, 0, 0, 58),
    "15pt_dense_kernelILb0ELb1ELb0ELb1EE": (32, 0, 0, 63),
    "15pt_dense_kernelILb1ELb1ELb0ELb1EE": (32, 0, 0, 56),
    "15pt_dense_kernelILb0ELb0ELb1ELb1EE": (32, 0, 0, 61),
    "15pt_dense_kernelILb1ELb0ELb1ELb1EE": (56, 0, 0, 60),
    "15pt_dense_kernelILb0ELb1ELb1ELb1EE": (32, 0, 0, 61),
    "15pt_dense_kernelILb1ELb1ELb1ELb1EE": (56, 0, 0, 59),
    "14pt_mesh_kernelILb0EE": (32, 0, 0, 79),
    "14pt_mesh_kernelILb1EE": (56, 0, 0, 85),
    "17mesh_sweep_kernelILb0EE": (0, 0, 0, 56),
    "17mesh_sweep_kernelILb1EE": (0, 0, 0, 63),
    "26wavefront_dense_hit_kernel": (0, 0, 0, 31),
    "22wavefront_shade_kernel": (32, 0, 0, 48)}


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
    print(f"nvidia-smi: {gpu}; FP32 peak for the bounds "
          f"{peak_fp32():.4g} instructions/s")
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


def _setup(device, scene_path=SCENE, env=False, objs=(), lens=False):
    """(StaticScene, camera, env map or None, scene arrays); `lens`: the
    scene's camera with a thin lens (aperture 20, focus 1000)."""
    from nrenderer_torch import build_scene_arrays, load_obj, load_scn
    from nrenderer_torch.io.image import load_image
    from nrenderer_torch.ops.camera import make_camera
    from nrenderer_torch.ops.intersect import make_static_scene
    scene = load_scn(scene_path)
    if lens:
        scene.camera.aperture, scene.camera.focus_distance = 20.0, 1000.0
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
    ops_ms = flops / peak_fp32() * 1e3
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
    flops = (work["samples"] * FLOPS_SAMPLE
             + work.get("bounces", 0) * per_bounce
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
                 phase=4, split=None, lens=False) -> dict:
    """One kernel form against its plain version on the same CUDA inputs.
    `split`: the spp as consecutive calls of these sizes (from sample 0);
    `lens`: a thin-lens camera."""
    from nrenderer_torch.ops import pt_cuda
    from nrenderer_torch.ops.bvh import build_mesh_accel
    from nrenderer_torch.ops.mesh_cuda import make_mesh_tables
    from nrenderer_torch.ops.pt_core import make_mat_channels, scene_epsilon
    from nrenderer_torch.ops.pt_cuda import (
        kernel_name, make_env_tables, make_tex_tables, pt_accumulate,
        pt_accumulate_plain)
    name = kernel_name(bsdf, env, mesh, tex)
    what = " + ".join(os.path.basename(p) for p in (scene, *objs))
    print(f"== phase {phase}: {name} vs plain, {what}, "
          f"{width}x{height}, {spp} spp"
          + (f" as {'+'.join(map(str, split))}" if split else "")
          + f", depth {depth}" + (", thin lens" if lens else ""))
    ss, cam, env_map, arrays = _setup("cuda", scene, env, objs, lens)
    calls = [(sum(split[:i]), n) for i, n in enumerate(split)] if split \
        else [(0, spp)]
    t_min = scene_epsilon(ss)
    n_pix = width * height
    tables = make_env_tables(env_map, "cuda") if env else None
    mesh_t = (make_mesh_tables(build_mesh_accel(
        arrays, make_mat_channels(ss)).bt, "cuda") if mesh else None)
    tex_t = make_tex_tables(arrays.textures, "cuda") if tex else None
    work = {"enter": []} if mesh else {}

    def kernel():
        film = torch.zeros((n_pix, 3), dtype=torch.float32, device="cuda")
        for sp0, n in calls:
            pt_accumulate(film, ss, cam, width, height, sp0, n, depth, seed,
                          t_min, bsdf=bsdf, env=tables, mesh=mesh_t,
                          tex=tex_t)
        return film

    def plain(stats=None):
        film = torch.zeros((n_pix, 3), dtype=torch.float32, device="cuda")
        for sp0, n in calls:
            pt_accumulate_plain(film, ss, cam, width, height, sp0, n, depth,
                                seed, t_min, bsdf=bsdf, env=tables,
                                mesh=mesh_t, tex=tex_t, stats=stats)
        return film

    if mesh:
        pt_cuda.mesh_loop_slots(reset=True)
    lin_k = kernel()
    counters = pt_cuda.mesh_loop_slots(reset=True) if mesh else None
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
        "bounces_per_sample": work.get("bounces", 0) / work["samples"],
        **({"slab_tests": work["slab_tests"],
            "tri_tests": work.get("tri_tests", 0),
            "schedule": _pt_schedule(work["schedule"]),
            # the loop's counters beside the CPU prediction
            "loop_slots": counters, "loop_slots_cpu": mesh_slots(
                work["path_bounces"], min(spp, pt_cuda.launch_plan(
                    True, n_pix)[1]))}
           if mesh else {}),
        # the flat loop in lane slots (pt_cuda.loop_slots): at this shape's
        # launches, the nested loop beside it
        **({"schedule": pt_cuda.loop_slots(
            work["path_bounces"], min(spp, pt_cuda.launch_plan(
                False, n_pix)[1]))}
           if not mesh and work.get("bounces") else {}),
    }
    st["shape"] = [width, height, spp, depth]
    print(json.dumps(st))
    if not st["finite"]:
        raise AssertionError(f"{name} film has non-finite values")
    if st["max_abs_err"] != 0.0:
        raise AssertionError(f"{name}: the film differs from the plain "
                             f"version's (max |d| {st['max_abs_err']})")
    if mesh and (counters["live"], counters["slots"]) != (
            work["bounces"], st["loop_slots_cpu"]["grouped"]):
        raise AssertionError(f"{name}: the loop counted {counters}, the "
                             f"plain version {work['bounces']} bounces and "
                             f"the model {st['loop_slots_cpu']}")
    return st


def _pt_schedule(sched: dict) -> dict:
    """The mesh forms' sweep schedules in triangle-test lane slots
    (`mesh_cuda.schedule_counts`): the per-lane sweep with the warp's lanes
    at one sample and bounce (the kernel before the warp sweep), the warp
    sweep the same way (this kernel), and the warp sweep in a flat loop
    where each lane starts its next sample as soon as its path ends (pairs
    and dense steps are the kernel's)."""
    lock, flat = sched["lockstep"], sched["flat"]
    return {"union_lockstep": lock["union_slots"],
            "coop_lockstep": lock["coop_slots"],
            "coop_flat": flat["coop_slots"], "coop_pairs":
            lock["coop_pairs"], "coop_dense_steps": lock["coop_dense_steps"],
            "entered": lock["entered_slots"]}


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
              band, check, warm_argv=None, timers=()) -> dict:
    """One path through `cli.main`: a warm-up run (`warm_argv`, or the same
    argv), then a timed run with every launch count set to 0 just before
    it and read just after; `timers`: `GLOBAL_TIMER` phases whose seconds
    in the timed run are returned under "timers"."""
    print(f"== phase {phase}: {label}, cli render {width}x{height}, "
          f"{spp} spp, depth {depth}")
    from nrenderer_torch import cli
    from nrenderer_torch.ops import mesh_cuda, mesh_mxu, pt_cuda, \
        stream_compact
    from nrenderer_torch.renderers import _wavefront
    from nrenderer_torch.server.registry import get_server
    from nrenderer_torch.utils.timing import GLOBAL_TIMER
    out = argv[argv.index("--out") + 1]
    os.makedirs(os.path.dirname(out), exist_ok=True)
    t0 = time.perf_counter()
    if cli.main(warm_argv or argv) != 0:
        raise AssertionError(f"{label}: warm-up render failed")
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    pt_cuda.reset_launch_counts()
    mesh_cuda.reset_launch_counts()
    mesh_mxu.reset_launch_counts()
    stream_compact.reset_launch_counts()
    mesh_cuda.reset_route_counts()
    _wavefront.reset_route_counts()
    torch.cuda.reset_peak_memory_stats()
    timer = f"{argv[argv.index('--renderer') + 1]}.render"
    render0 = GLOBAL_TIMER.get(timer).total_s
    timers0 = {k: GLOBAL_TIMER.get(k).total_s for k in timers}
    t0 = time.perf_counter()
    rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    render_s = GLOBAL_TIMER.get(timer).total_s - render0
    timer_s = {k: GLOBAL_TIMER.get(k).total_s - t for k, t in timers0.items()}
    launches = {**pt_cuda.KERNEL_LAUNCHES, **mesh_cuda.KERNEL_LAUNCHES,
                **mesh_mxu.KERNEL_LAUNCHES, **stream_compact.KERNEL_LAUNCHES}
    routes = {**mesh_cuda.ROUTE_COUNTS, **mesh_cuda.ENGINE_COUNTS,
              **_wavefront.ROUTE_COUNTS}
    peak = torch.cuda.max_memory_allocated()
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
    st = {"path": label, "seconds": secs, "render_seconds": render_s,
          "warmup_seconds": warm_s,
          "launches": launches, "peak_memory_bytes": peak,
          **({"routes": routes} if any(routes.values()) else {}),
          **({"timers": timer_s} if timers else {}),
          "spp_per_s": spp / secs,
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


FACE_PLANE_RAYS = 16


def tie_pool():
    """A triangle pool and rays built for exact ties, as numpy arrays
    (verts (V, 3), faces (F, 3) int32, origins and directions (N, 3)
    float32): the cube [-4, 4]^3, each face a 4x4 grid of 2x2 quads of two
    triangles (axis-aligned faces, each lying on its block's box face),
    with the top face's first triangle repeated 20 times (copies inside
    one block and across two adjacent blocks), and rays in one direction
    octant (no component above 0) that hit it on edges and vertices:
    onto the top face, onto the +x face, along the diagonal onto the top
    face's edges and corners, from inside the cube, and, last,
    FACE_PLANE_RAYS rays that run inside a block box's face plane (a zero
    component, the origin on the top face's plane z = 4 or on the plane
    y = 4) onto the +x face's edge there.  Every coordinate is a small
    dyadic number and every det a power of two, so each t is exact in
    float32 and tied hits are equal bit for bit in any float order."""
    verts, faces = [], []
    g = np.arange(-4.0, 4.5, 2.0)
    for axis in range(3):
        for sign in (-1.0, 1.0):
            base = len(verts)
            for a in g:
                for b in g:
                    p = [0.0, 0.0, 0.0]
                    p[axis] = 4.0 * sign
                    p[(axis + 1) % 3], p[(axis + 2) % 3] = a, b
                    verts.append(p)
            for i in range(4):
                for j in range(4):
                    v00 = base + i * 5 + j
                    faces += [(v00, v00 + 5, v00 + 6), (v00, v00 + 6, v00 + 1)]
    faces += [faces[160]] * 20   # the top face's first triangle
    # hit points on a dyadic grid; each ray starts 8 of its directions
    # back from its point (t = 8)
    xy = np.arange(-5.0, 5.25, 0.5)
    gx, gy = [a.reshape(-1) for a in np.meshgrid(xy, xy)]
    four = np.full(gx.size, 4.0)
    inner = np.arange(-3.0, 3.5, 1.0)
    ix, iy, iz = [a.reshape(-1) for a in np.meshgrid(inner, inner, inner)]
    origins, dirs = [], []
    for pts, d in ((np.stack([gx, gy, four], 1), (-0.5, -0.25, -1.0)),
                   (np.stack([four, gx, gy], 1), (-1.0, -0.5, -0.25)),
                   (np.stack([gx, gy, four], 1), (-1.0, -1.0, -1.0))):
        origins.append(pts - 8.0 * np.asarray(d))
        dirs.append(np.tile(d, (pts.shape[0], 1)))
    origins.append(np.stack([ix, iy, iz], 1))   # from inside, down
    dirs.append(np.tile((-0.25, -0.5, -1.0), (ix.size, 1)))
    edge = np.arange(-3.5, 4.0, 1.0)   # the +x face's top and y = 4 edges
    on = np.full(edge.size, 4.0)
    for pts, d in ((np.stack([on, edge, on], 1), (-1.0, -0.5, 0.0)),
                   (np.stack([on, on, edge], 1), (-1.0, 0.0, -0.5))):
        origins.append(pts - 8.0 * np.asarray(d))
        dirs.append(np.tile(d, (pts.shape[0], 1)))
    origins, dirs = np.concatenate(origins), np.concatenate(dirs)
    return (np.asarray(verts, np.float32), np.asarray(faces, np.int32),
            origins.astype(np.float32), dirs.astype(np.float32))


def _ico_rays(n_rays: int, seed: int):
    """ico_5120.obj's tables on the card and phase 9's rays: from the
    Cornell box's interior aimed at the mesh, a tenth of them with a zero
    cap (dead).  Returns (blocked pool, tables, t_min, (7, n) rays)."""
    from nrenderer_torch.ops.bvh import build_mesh_accel
    from nrenderer_torch.ops.mesh_cuda import make_mesh_tables
    from nrenderer_torch.ops.pt_core import make_mat_channels, scene_epsilon
    ss, _, _, arrays = _setup("cuda", MESH_SCENE, objs=(ICO,))
    bt = build_mesh_accel(arrays, make_mat_channels(ss)).bt
    g = torch.Generator(device="cuda").manual_seed(seed)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(
        n_rays, generator=g, device="cuda")
    o = torch.stack([u(-270.0, 270.0), u(-270.0, 270.0), u(760.0, 1300.0)])
    tgt = torch.stack([u(-150.0, 150.0), u(-278.0, -7.0),
                       u(850.0, 1150.0)])
    d = (tgt - o) / torch.linalg.vector_norm(tgt - o, dim=0)
    cap = torch.where(torch.rand(n_rays, generator=g, device="cuda") < 0.1,
                      0.0, float("inf"))
    rays = torch.cat([o, d, cap[None]]).contiguous()
    return bt, make_mesh_tables(bt, "cuda"), scene_epsilon(ss), rays


def _tie_tables(block: int):
    """`tie_pool()`'s tables on the card with `block`-triangle blocks and
    its rays as a (7, n) array (no cap)."""
    from nrenderer_torch import build_scene_arrays
    from nrenderer_torch.ops.bvh import build_mesh_accel
    from nrenderer_torch.ops.mesh_cuda import make_mesh_tables
    from nrenderer_torch.scene import model
    verts, faces, o, d = tie_pool()
    s = model.Scene()
    s.materials += [model.Material(name="A"), model.Material(name="B")]
    s.mesh_buffer.append(model.Mesh(positions=verts, position_indices=faces
                                    .reshape(-1), material=1))
    s.nodes.append(model.Node(name="tie", type=model.NodeType.MESH,
                              entity=0))
    bt = build_mesh_accel(build_scene_arrays(s), [(0.25, 9.0), (1.0, 2.0)],
                          block=block).bt
    rays = np.concatenate([o.T, d.T, np.full((1, o.shape[0]), np.inf)])
    return make_mesh_tables(bt, "cuda"), torch.as_tensor(
        rays.astype(np.float32), device="cuda").contiguous()


def phase_sweep(n_rays=1 << 20, seed=0) -> dict:
    """`mesh_sweep_kernel` against its plain version, every output bit for
    bit (t and idx on every ray), in natural and front-to-back block
    order: phase 9's rays at `ico_5120.obj`, with times, bound and schedule
    counts; then prefixes of them at ragged counts (1, 31, 33, 32 k + 5,
    with their dead lanes) and `tie_pool()` in blocks of 16 and 128."""
    from nrenderer_torch.ops.mesh_cuda import (
        KERNEL_NAME, sweep_mesh_full, sweep_mesh_plain)
    from nrenderer_torch.ops.soa import V3
    bt, mt, t_min, rays = _ico_rays(n_rays, seed)
    o, d, cap = V3(*rays[0:3]), V3(*rays[3:6]), rays[6]
    runs = {}
    for f2b in (False, True):
        label = "f2b" if f2b else "natural"
        print(f"== phase 9: {KERNEL_NAME} vs plain, ico_5120.obj "
              f"({bt.n_blocks} blocks of {bt.block}), {n_rays} rays, "
              f"{label} order")
        st = _engine_vs_plain(mt, rays, t_min, f2b, False,
                              f"phase 9: {label} order", timing=True)
        st["plain_ms"] = _time_ms(lambda: sweep_mesh_plain(
            mt, o, d, t_min, cap, f2b=f2b), 1)
        print(json.dumps({"plain_ms": st["plain_ms"]}))
        if st["hits"] < n_rays // 10:
            raise AssertionError(f"{KERNEL_NAME} ({label}): too few hits: "
                                 f"{st}")
        runs[label] = st
    t_nat, t_f2b = (sweep_mesh_full(mt, o, d, t_min, t_cap=cap, f2b=f2b)[0]
                    for f2b in (False, True))
    moved = int((t_nat != t_f2b).sum())
    print(f"natural vs f2b order: t differs on {moved} rays; triangle "
          f"tests {runs['natural']['tri_tests']} -> "
          f"{runs['f2b']['tri_tests']}")
    # each ragged and tie case on B2 in both orders and on B4 (natural)
    engines = ((False, False), (True, False), (False, True))
    for n in (1, 31, 33, 32 * 1000 + 5):
        for f2b, mxu in engines:
            _engine_vs_plain(mt, rays[:, :n].contiguous(), t_min, f2b, mxu,
                             f"phase 9: {n} rays, "
                             f"{'B4' if mxu else f'f2b={f2b}'}",
                             need_hits=False)
    for block in (16, 128):
        mt_t, rays_t = _tie_tables(block)
        for f2b, mxu in engines:
            _engine_vs_plain(mt_t, rays_t, 1e-3, f2b, mxu,
                             f"phase 9: tie pool, blocks of {block}, "
                             f"{'B4' if mxu else f'f2b={f2b}'}")
    return runs["natural"]


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


def _compactor_inputs(n: int, gen):
    """The masks of phase 12 over n lanes, the mask words of a dead lane
    (0, or for "nan_zero" -0.0, NaN of either sign, 0, -1 and -inf in
    turn), and an 11-channel stage state and a 7-channel mesh-pipe state on
    the card."""
    from nrenderer_torch.ops.stream_compact import TILE
    u = lambda: torch.rand(n, generator=gen, device="cuda")
    lane = torch.arange(n, dtype=torch.int32, device="cuda")
    side = 512
    pix = lane.to(torch.int64) % (side * side)
    px, py = (pix % side).float(), (pix // side).float()
    r = side * (0.2 / np.pi) ** 0.5   # a disc of 20% of each frame
    masks = {
        "random_40": u() < 0.4,
        "clustered_20": (px - 200.0) ** 2 + (py - 300.0) ** 2 < r * r,
        "empty": torch.zeros(n, dtype=torch.bool, device="cuda"),
        "full": torch.ones(n, dtype=torch.bool, device="cuda"),
        "tail": lane >= n - 1000,
        # live lanes only in every 37th tile, after 36 empty ones
        "sparse_tiles": ((lane // TILE) % 37 == 36) & (u() < 0.5),
        "nan_zero": u() < 0.3,
    }
    odd = torch.tensor([-0.0, float("nan"), -float("nan"), 0.0, -1.0,
                        -float("inf")], device="cuda")
    dead = {"nan_zero": odd[lane.to(torch.int64) % len(odd)]}
    state = [u() * 2.0 - 1.0 for _ in range(9)]
    return masks, dead, state, lane


def _word_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest difference between the 32-bit words of two tensors of
    one shape, read as int32 (0: bit for bit)."""
    if a.numel() == 0:
        return 0
    diff = a.view(torch.int32).to(torch.int64) - b.view(torch.int32).to(
        torch.int64)
    return int(diff.abs().max())


def _pack_errs(kp, pp) -> int:
    """The pack's error against its plain version: the largest word
    difference over the packed buffer, the count and the tile offsets."""
    return max(_word_err(kp.packed, pp.packed),
               abs(int(kp.count) - int(pp.count)),
               _word_err(kp.tile_off, pp.tile_off))


def _pack_bound_ms(kept: torch.Tensor, n_ch: int, cap: int) -> float:
    """The least time of a pack of the lanes `kept` (live, with a slot
    below cap) over n_ch channels, by bytes: the mask channel read once,
    every other channel read only in the 32-byte sectors that hold a kept
    lane, the kept lanes' words written once, and the mask channel cleared
    in the slots past them (all the contract asks; the kernel clears every
    channel there, which this does not count)."""
    n, n_valid = kept.shape[0], int(kept.sum())
    pad = torch.zeros((-n) % 8, dtype=torch.bool, device=kept.device)
    sectors = int(torch.cat([kept, pad]).view(-1, 8).any(dim=1).sum())
    words = n + (n_ch - 1) * 8 * sectors + n_ch * n_valid + (cap - n_valid)
    return 4.0 * words / PEAK_BYTES_PER_S * 1e3


def _compactor_case(chans, cap, mask_from, fills, label, timing):
    """Pack and round trip on the kernels and on the plain versions, bit
    for bit; with `timing`, kernel, plain and library times and the
    bound."""
    from nrenderer_torch.ops import stream_compact as sc
    kp = sc.stream_pack_channels(chans, cap, mask_from)
    pp = sc.stream_pack_plain(chans, cap, mask_from)
    # a second call on the same scratch sizes: the look-back's reset
    again = _pack_errs(sc.stream_pack_channels(chans, cap, mask_from), pp)
    res = [kp.packed[c] for c in range(len(chans) - 1)] + [
        kp.packed[-1].view(torch.int32)]
    mask = chans[mask_from]
    ku = sc.stream_unpack_channels(mask, res, fills, kp)
    pu = sc.stream_unpack_plain(mask, res, fills, pp)
    torch.cuda.synchronize()
    count, n_valid = int(kp.count), min(int(kp.count), cap)
    words = lambda t: t.view(torch.int32)
    pack_err = max(_pack_errs(kp, pp), again)
    unpack_err = max(_word_err(a, b) for a, b in zip(ku, pu))
    live = mask > 0.0
    slot = torch.cumsum(live.to(torch.int32), 0) - 1
    kept = live & (slot < cap)
    trip_ok = all(torch.equal(words(a)[kept], words(c)[kept])
                  for a, c in zip(ku, chans))
    st = {"case": label, "lanes": mask.shape[0], "channels": len(chans),
          "cap": cap, "count": count, "pack_max_word_err": pack_err,
          "unpack_max_word_err": unpack_err, "round_trip_exact": trip_ok}
    if timing:
        n, n_ch = mask.shape[0], len(chans)
        stacked = torch.stack([words(c) for c in chans]).view(torch.float32)
        src = stacked[:, live][:, :cap].contiguous() if count <= cap \
            else None
        st["pack_ms"] = _time_ms(
            lambda: sc.stream_pack_channels(chans, cap, mask_from), 10)
        st["pack_plain_ms"] = _time_ms(
            lambda: sc.stream_pack_plain(chans, cap, mask_from), 3)
        st["pack_library_ms"] = _time_ms(lambda: stacked[:, live], 10)
        st["pack_bound_ms"] = _pack_bound_ms(kept, n_ch, cap)
        st["unpack_ms"] = _time_ms(
            lambda: sc.stream_unpack_channels(mask, res, fills, kp), 10)
        st["unpack_plain_ms"] = _time_ms(
            lambda: sc.stream_unpack_plain(mask, res, fills, pp), 3)
        if src is not None:
            out = torch.empty((n_ch, n), device="cuda")
            full = live.expand(n_ch, n)
            st["unpack_library_ms"] = _time_ms(
                lambda: out.fill_(0.0).masked_scatter_(full, src), 10)
        st["unpack_bound_ms"] = (4.0 * (n + n_ch * n_valid + n_ch * n)
                                 / PEAK_BYTES_PER_S * 1e3)
    print(json.dumps(st))
    if pack_err or unpack_err or not trip_ok:
        raise AssertionError(f"compactor disagrees with its plain version: "
                             f"{st}")
    return st


def phase_compactor(n=1 << 24, seed=0) -> dict:
    """Phase 12; returns the timed cases by kernel shape, and each
    kernel's largest word error over every case."""
    print(f"== phase 12: stream_pack_kernel / stream_unpack_kernel vs "
          f"plain, {n} lanes")
    from nrenderer_torch.ops.stream_compact import TILE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    masks, dead, state, lane = _compactor_inputs(n, gen)
    timed = {"pack_err": 0, "unpack_err": 0}

    def case(chans, cap, mask_from, fills, label, timing=False):
        st = _compactor_case(chans, cap, mask_from, fills, label, timing)
        timed["pack_err"] = max(timed["pack_err"], st["pack_max_word_err"])
        timed["unpack_err"] = max(timed["unpack_err"],
                                  st["unpack_max_word_err"])
        return st

    for name, m in masks.items():
        off = dead.get(name, 0.0)
        keep = torch.where(m, 1.0, off)
        stage = state[:9] + [keep, lane]
        t_cap = torch.where(m, state[0].abs() * 1000.0 + 1.0, off)
        mesh = state[:6] + [t_cap]
        for key, chans, cap, mask_from, fills, timed_mask in (
                ("stage", stage, n // 2, 9, [0.0] * 10 + [-1], "random_40"),
                ("mesh", mesh, n // 4, 6,
                 [float("inf"), -1.0, 0.0, 0.0, 0.0, 0.0, 0],
                 "clustered_20")):
            st = case(chans, cap, mask_from, fills, f"{key} pack, {name}",
                      name == timed_mask)
            if name == timed_mask:
                timed[key] = st
                # the cap at the count, one short of it (the last live lane
                # dropped), and at the live lanes before the middle of a
                # tile
                live = torch.nonzero(chans[mask_from] > 0.0).flatten()
                mid = (n // TILE // 2) * TILE + TILE // 2 + 1
                inside = int(torch.searchsorted(
                    live, torch.tensor(mid, device="cuda")))
                for at, what in ((len(live), "count"),
                                 (len(live) - 1, "count - 1"),
                                 (inside, "inside a tile")):
                    case(chans, at, mask_from, fills,
                         f"{key} pack, {name}, cap = {what}")
    return timed


@contextlib.contextmanager
def _plain_versions():
    """The hybrid route with the plain versions of B2, B3a and B3b on the
    card's tensors in place of the kernels."""
    from nrenderer_torch.ops import mesh_cuda, stream_compact as sc
    from nrenderer_torch.renderers import _wavefront
    swaps = [(sc, "stream_pack_channels", sc.stream_pack_plain),
             (sc, "stream_unpack_channels", sc.stream_unpack_plain),
             (_wavefront, "stream_pack_channels", sc.stream_pack_plain),
             (_wavefront, "stream_unpack_channels", sc.stream_unpack_plain),
             (mesh_cuda, "_sweep_cuda",
              lambda mt, o, d, t_min, cap, f2b, with_uv:
              mesh_cuda.sweep_mesh_plain(mt, o, d, t_min, cap, f2b=f2b,
                                         with_uv=with_uv))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _hybrid_fn(objs, width, height, depth, chunk):
    from nrenderer_torch.ops.bvh import build_mesh_accel
    from nrenderer_torch.ops.mesh_cuda import make_mesh_tables
    from nrenderer_torch.ops.pt_core import make_mat_channels
    from nrenderer_torch.renderers._wavefront import build_render_fn
    ss, cam, _, arrays = _setup("cuda", MESH_SCENE, objs=objs)
    mt = make_mesh_tables(build_mesh_accel(arrays,
                                           make_mat_channels(ss)).bt, "cuda")
    fn = build_render_fn(ss, cam, width, height, depth, chunk, tri_bvh=mt,
                         staged=depth >= 12)
    return fn, ss, cam, mt


def _film_stats(a, b, spp) -> dict:
    img = lambda f: torch.sqrt(torch.clamp(f * (1.0 / spp), min=0.0))
    diff = (img(a) - img(b)).abs()
    pix = diff.max(dim=1).values
    return {"max_abs_err": float(diff.max()),
            "mean_abs_err": float(diff.mean()),
            "share_within_1e-4": float((pix <= WITHIN).float().mean()),
            "finite": bool(torch.isfinite(a).all())}


def phase_hybrid_parity(width=128, height=128, spp=8, depth=13) -> dict:
    from nrenderer_torch.ops import mesh_cuda, stream_compact
    from nrenderer_torch.ops.pt_core import scene_epsilon
    from nrenderer_torch.ops.pt_cuda import pt_accumulate
    from nrenderer_torch.renderers import _wavefront
    print(f"== phase 13: hybrid route, kernels vs plain versions, "
          f"ico_5120.obj, {width}x{height}, {spp} spp, depth {depth}")
    fn, *_ = _hybrid_fn((ICO,), width, height, depth, spp)
    for mod in (mesh_cuda, stream_compact):
        mod.reset_launch_counts()
    mesh_cuda.reset_route_counts()
    _wavefront.reset_route_counts()
    film_k = fn(0, 0, spp)
    torch.cuda.synchronize()
    launches = {**mesh_cuda.KERNEL_LAUNCHES,
                **stream_compact.KERNEL_LAUNCHES}
    routes = {**mesh_cuda.ROUTE_COUNTS, **_wavefront.ROUTE_COUNTS}
    with _plain_versions():
        film_p = fn(0, 0, spp)
    torch.cuda.synchronize()
    st = {"scene": "ico_5120", "bit_exact": bool(torch.equal(film_k, film_p)),
          **_film_stats(film_k, film_p, spp), "launches": launches,
          "routes": routes}
    print(json.dumps(st))
    if not st["bit_exact"] or min(launches.values()) <= 0 \
            or not routes["compacted"]:
        raise AssertionError(f"hybrid route vs its plain versions: {st}")
    print(f"== phase 13: hybrid route vs pt_bsdf_mesh_kernel, blob_960.obj, "
          f"{width}x{height}, {spp} spp, depth {depth}")
    fn, ss, cam, mt = _hybrid_fn((BLOB,), width, height, depth, spp)
    film_h = fn(0, 0, spp)
    film_m = pt_accumulate(
        torch.zeros((width * height, 3), device="cuda"), ss, cam, width,
        height, 0, spp, depth, 0, scene_epsilon(ss), bsdf=True, mesh=mt)
    torch.cuda.synchronize()
    st2 = {"scene": "blob_960", "bit_exact": bool(torch.equal(film_h,
                                                              film_m)),
           **_film_stats(film_h, film_m, spp)}
    print(json.dumps(st2))
    if not st2["finite"] or st2["mean_abs_err"] > MEAN_ABS_MAX \
            or st2["share_within_1e-4"] < WITHIN_SHARE_MIN:
        raise AssertionError(f"hybrid route vs the megamesh kernel: {st2}")
    return st


class _Captured(Exception):
    """Ends a chunk once the mesh pipe's inputs are held."""


def phase_pipe_main_shape(width=500, height=500, chunk=64, depth=20,
                          obj=ICO, phase=13) -> tuple:
    """One sorted mesh-pipe bounce of a chunk of the hybrid path, at its
    own shape (the second bounce of 64 spp of 500x500: 16 Mi lanes, a cap
    of 4 Mi rays): the pack and the unpack on the kernels and on the plain
    versions, bit for bit, the unpack's result channels as long as the
    live prefix (shorter than the cap, as on every compacted bounce), and
    the sweep against its plain version on the whole sorted prefix, with
    its time, bound and schedule counts.  Returns the stats and (tables,
    t_min, the sorted prefix) for phase 18.  `obj`: the mesh (phase 32
    runs it on the 81,920-face icosphere)."""
    from nrenderer_torch.ops import mesh_cuda, stream_compact as sc
    from nrenderer_torch.ops.pt_core import scene_epsilon
    from nrenderer_torch.ops.soa import V3
    print(f"== phase {phase}: mesh pipe at the hybrid path's shape, "
          f"{os.path.basename(obj)}, bounce 1 of {width}x{height}, {chunk} "
          f"spp, depth {depth}")
    fn, ss, _, mt = _hybrid_fn((obj,), width, height, depth, chunk)
    t_min = scene_epsilon(ss)
    held, pack = [], sc.stream_pack_channels

    def hold(chans, cap, mask_from):
        if not held:   # the camera bounce's pack runs; bounce 1's is held
            held.append(None)
            return pack(chans, cap, mask_from)
        held[:] = [chans, cap]
        raise _Captured

    sc.stream_pack_channels = hold
    try:
        fn(0, 0, chunk)
        raise AssertionError("the chunk packed no second mesh bounce")
    except _Captured:
        pass
    finally:
        sc.stream_pack_channels = pack
    chans, cap = held
    t_cap = chans[6]
    kp = sc.stream_pack_channels(chans, cap, 6)
    pp = sc.stream_pack_plain(chans, cap, 6)
    n_hit = int(kp.count)
    pack_err = _pack_errs(kp, pp)
    if not 0 < n_hit < cap:
        raise AssertionError(f"bounce 1 did not compact: {n_hit} rays, cap "
                             f"{cap}")
    lo, hi = mt.bb[:, 0:3].amin(dim=0), mt.bb[:, 4:7].amax(dim=0)
    rays, perm = mesh_cuda.sort_rays(kp.packed[:, :n_hit], lo, hi, t_min)
    rays = rays.contiguous()
    sweep = _engine_vs_plain(mt, rays, t_min, True, False,
                             f"phase {phase}: B2 on the sorted live prefix "
                             f"({mt.n_blocks} blocks)", timing=True)
    out = mesh_cuda.sweep_mesh_full(
        mt, V3(rays[0], rays[1], rays[2]), V3(rays[3], rays[4], rays[5]),
        t_min, t_cap=rays[6], f2b=True)
    out = mesh_cuda.unsort(out, perm)
    misses = (float("inf"), -1, 0.0, 0.0, 0.0, 0.0)
    ku = sc.stream_unpack_channels(t_cap, out, misses, kp)
    pu = sc.stream_unpack_plain(t_cap, out, misses, pp)
    unpack_err = max(_word_err(a, b) for a, b in zip(ku, pu))
    torch.cuda.synchronize()
    st = {"mesh": os.path.basename(obj), "blocks": mt.n_blocks,
          "lanes": t_cap.shape[0], "cap": cap, "live_prefix": n_hit,
          "pack_max_word_err": pack_err, "unpack_max_word_err": unpack_err,
          "hits": int((ku[1] >= 0).sum()), "sweep": sweep}
    print(json.dumps({k: v for k, v in st.items() if k != "sweep"}))
    if pack_err or unpack_err or not st["hits"]:
        raise AssertionError(f"mesh pipe at the path's shape disagrees "
                             f"with its plain versions: {st}")
    return st, (mt, t_min, rays)


def _hybrid_pinned():
    """The CPU's megamesh limit (1024) pinned for a run: the hybrid-route
    phases on ico_5120.obj keep the route they have always measured,
    whatever the card's limit."""
    from nrenderer_torch.renderers import routes
    return routes.pinned_megamesh_max_tris(routes.MEGAMESH_MAX_TRIS)


def phase_hybrid_path(obj=ICO, width=500, height=500, spp=256,
                      depth=20) -> dict:
    name = os.path.splitext(os.path.basename(obj))[0]
    out = os.path.join(ROOT, "build", f"smoke_{name}.png")
    argv = _cli_argv(MESH_SCENE, "AccPathTracer", width, height, spp, depth,
                     out, objs=(obj,))
    with _hybrid_pinned():
        return phase_cli(14, f"hybrid path (AccPathTracer, {name})", argv,
                         HYBRID_KERNELS, width, height, spp, depth,
                         ICO_MEAN_BAND, _blob_lit)


def large_fixtures() -> tuple:
    """(ico_20480.obj, ico_81920.obj): the subdivision-5 and -6 icospheres
    of `tools/make_mesh_fixtures.py` (160 and 640 blocks of 128; the same
    radius and place as ico_5120.obj), written under build/mesh_fixtures/
    at first use."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import make_mesh_fixtures
    return tuple(str(make_mesh_fixtures.large_icosphere(level))
                 for level in make_mesh_fixtures.LARGE_LEVELS)


def _same_tables(a, b) -> bool:
    """Two BlockedTris field by field, bit for bit."""
    return all((x is None and y is None) or (
        x is not None and y is not None
        and np.array_equal(np.asarray(x), np.asarray(y)))
        for x, y in zip(a, b))


def mesh_prep_seconds(obj) -> dict:
    """Host seconds of one mesh's set-up on mesh_box.scn with the host
    library and under NR_NO_NATIVE=1 (the numpy versions): `load_obj`,
    the renderer's scene prep (`build_scene_arrays`, `make_static_scene`)
    and its BVH and block build (`build_mesh_accel`, without the copy to
    the card); the block count, and whether the two builds' blocked
    tables are equal."""
    from nrenderer_torch import build_scene_arrays, load_obj, load_scn
    from nrenderer_torch.native import available
    from nrenderer_torch.ops.bvh import build_mesh_accel
    from nrenderer_torch.ops.intersect import make_static_scene
    from nrenderer_torch.ops.pt_core import make_mat_channels
    with _env("NR_NO_NATIVE", None):
        available()   # built before the clock starts
    out, tables = {}, []
    for mode in ("native", "numpy"):
        with _env("NR_NO_NATIVE", None if mode == "native" else "1"):
            scene = load_scn(MESH_SCENE)
            t0 = time.perf_counter()
            load_obj(obj, scene, material=0)
            t1 = time.perf_counter()
            arrays = build_scene_arrays(scene)
            ss = make_static_scene(arrays)
            t2 = time.perf_counter()
            tables.append(build_mesh_accel(arrays,
                                           make_mat_channels(ss)).bt)
            t3 = time.perf_counter()
        out[mode] = {"load_obj": t1 - t0, "scene_prep": t2 - t1,
                     "bvh_build": t3 - t2}
    out["blocks"] = tables[0].n_blocks
    out["tables_equal"] = _same_tables(*tables)
    return out


def phase_env_mesh_path(width=512, height=512, spp=256, depth=8) -> dict:
    out = os.path.join(ROOT, "build", "smoke_env_mesh.png")
    argv = _cli_argv(MESH_SCENE, "AccPathTracer", width, height, spp, depth,
                     out, env=True, objs=(BLOB,))
    return phase_cli(15, "env + mesh path (AccPathTracer, blob_960)", argv,
                     HYBRID_KERNELS, width, height, spp, depth,
                     ENV_MESH_MEAN_BAND, _blob_lit)


def phase_breakdown(width=500, height=500, chunk=64, depth=20) -> dict:
    """One chunk of the hybrid path, each part timed between device
    synchronisations; bounce math is the rest of the chunk."""
    print(f"== phase 16: one hybrid chunk, ico_5120.obj, {width}x{height}, "
          f"{chunk} spp, depth {depth}")
    from nrenderer_torch.ops import mesh_cuda, stream_compact as sc
    from nrenderer_torch.renderers import _wavefront
    fn, *_ = _hybrid_fn((ICO,), width, height, depth, chunk)
    fn(1, 0, chunk)   # warm
    parts, calls = {}, {}

    def timed(name, f):
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*args, **kw)
            torch.cuda.synchronize()
            parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0
            calls[name] = calls.get(name, 0) + 1
            return out
        return run

    swaps = [(mesh_cuda, "top_aabb_reach", "top-AABB test"),
             (sc, "stream_pack_channels", "mesh pack"),
             (mesh_cuda, "sort_rays", "sort"), (mesh_cuda, "unsort", "sort"),
             (mesh_cuda, "sweep_mesh_full", "sweep"),
             (sc, "stream_unpack_channels", "mesh unpack"),
             (_wavefront, "stream_pack_channels", "stage pack"),
             (_wavefront, "stream_unpack_channels", "banking")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in swaps]
    for mod, attr, name in swaps:
        setattr(mod, attr, timed(name, getattr(mod, attr)))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(0, 0, chunk)
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
    finally:
        for mod, attr, f in saved:
            setattr(mod, attr, f)
    parts["bounce math (the rest)"] = total - sum(parts.values())
    st = {"chunk_seconds": total,
          **{k: v for k, v in sorted(parts.items(), key=lambda kv: -kv[1])},
          "shares": {k: v / total for k, v in parts.items()},
          "calls": calls}
    print(json.dumps(st))
    return st


# Phase 32's image bars: the 81,920-face icosphere's image against
# ico_5120.obj's (phase 14) at the same settings.  The two spheres have
# the same radius and place and differ by tessellation (the flat facets of
# ico_5120 sit at most 3.4e-4 of the radius inside the sphere) and noise,
# so their linear means agree within 2% and their 8x8-block means
# correlate at 0.95 or more (the hybrid route's plain versions on the CPU,
# 64x64, 64 spp, depth 20, seed 0: 0.29% and 0.9991).
LARGE_MEAN_REL_MAX = 0.02
LARGE_BLOCK_CORR_MIN = 0.95
# B1e's band in phase 32: rows [137, 145) of a 500-row film (row 0 at the
# bottom) cross the middle of the ball (its centre projects to row ~141)
B1E_BAND_ROWS = (137, 8)


def mesh_slots(path_bounces, launch_spp: int) -> dict:
    """The CPU prediction (`pt_cuda.loop_slots`) of the mesh forms' lane
    slots beside their counters: the useful share of the nested loop, of
    the flat loop and of the mesh forms' grouped loop (its slots
    are the counters' on the same pixels)."""
    from nrenderer_torch.ops import pt_cuda
    got = pt_cuda.loop_slots(path_bounces, launch_spp,
                             regen=pt_cuda.MESH_REGEN_EIGHTHS)
    return {k: got[k] for k in ("grouped", "nested_share", "flat_share",
                                "grouped_share")}


def phase_b1e_launch(obj, phase, band_rows, width=500, height=500, spp=32,
                     depth=20) -> dict:
    """B1e at `obj`'s blocks (phase 8: `ico_5120.obj`, the mesh cell's; phase
    32: the 81,920-face icosphere): one launch of the megamesh route's
    32-spp pass at 500x500, depth 20, timed, with its loop counters
    (`pt_cuda.mesh_loop_slots`); then, on the rows `band_rows` (first row,
    count; the same 32 spp), the kernel against its plain version bit for
    bit, with both times (the plain version's while it counts), the bound
    from the plain version's counts on the band (the whole launch's plain
    version would take minutes at 640 blocks) and the CPU prediction of
    the loop's lane slots there (`mesh_slots`)."""
    from nrenderer_torch.ops import pt_cuda
    from nrenderer_torch.ops.bvh import build_mesh_accel
    from nrenderer_torch.ops.mesh_cuda import make_mesh_tables
    from nrenderer_torch.ops.pt_core import make_mat_channels, scene_epsilon
    print(f"== phase {phase}: pt_bsdf_mesh_kernel at "
          f"{os.path.basename(obj)}, {width}x{height}, {spp} spp, depth "
          f"{depth}")
    ss, cam, _, arrays = _setup("cuda", MESH_SCENE, objs=(obj,))
    mt = make_mesh_tables(build_mesh_accel(arrays,
                                           make_mat_channels(ss)).bt, "cuda")
    t_min = scene_epsilon(ss)
    row0, rows = band_rows
    pix0, n_band = row0 * width, rows * width

    def run(fn, film_rows, **kw):
        film = torch.zeros((film_rows, 3), dtype=torch.float32,
                           device="cuda")
        fn(film, ss, cam, width, height, 0, spp, depth, 0, t_min, bsdf=True,
           mesh=mt, **kw)
        return film

    name = "pt_bsdf_mesh_kernel"
    n0 = pt_cuda.KERNEL_LAUNCHES[name]
    launch = lambda: run(pt_cuda.pt_accumulate, width * height)
    pt_cuda.mesh_loop_slots(reset=True)
    launch()
    torch.cuda.synchronize()
    launches = pt_cuda.KERNEL_LAUNCHES[name] - n0
    counters = pt_cuda.mesh_loop_slots(reset=True)
    launch_ms = _time_ms(launch, 3)
    band = dict(pix0=pix0, n_pix=n_band)
    kernel = lambda: run(pt_cuda.pt_accumulate, n_band, **band)
    work = {"enter": []}
    lin_k = kernel()
    # the plain version runs once, counting (minutes for the whole film)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    lin_p = run(pt_cuda.pt_accumulate_plain, n_band, stats=work, **band)
    end.record()
    torch.cuda.synchronize()
    b_ms, b_by = bound_ms(ss, n_band, work, None, mt)
    st = {"kernel": name, "blocks": mt.n_blocks,
          "launch_shape": [width, height, spp, depth],
          "launches_per_pass": launches, "launch_ms": launch_ms,
          "loop_slots": counters,
          "band_pixels": [pix0, n_band],
          "band_loop_slots_cpu": mesh_slots(work["path_bounces"], spp),
          "max_abs_err": float((lin_k - lin_p).abs().max()),
          "finite": bool(torch.isfinite(lin_k).all()),
          "kernel_ms": _time_ms(kernel, 3),
          "plain_ms": start.elapsed_time(end),
          "bound_ms": b_ms, "bound_by": b_by,
          "bounces_per_sample": work["bounces"] / work["samples"],
          "slab_tests": work["slab_tests"], "tri_tests": work["tri_tests"],
          "schedule": _pt_schedule(work["schedule"])}
    del work
    print(json.dumps(st))
    if not st["finite"] or st["max_abs_err"] != 0.0 or launches != 1:
        raise AssertionError(f"{name} at {mt.n_blocks} blocks: {st}")
    return st


def phase_large_mesh(ico_pixels, obj, width=500, height=500, spp=256,
                     depth=20) -> dict:
    """Phase 32: AccPathTracer on mesh_box.scn + the 81,920-face icosphere
    through `cli.main` at (6b)'s settings, on the route the card's
    threshold picks: its route and blocks, the host's mesh prep with the
    host library and with its numpy versions (the blocked tables equal),
    the render with each (the images bit for bit), peak memory and the
    hybrid route's counters, and the image against ico_5120.obj's
    (`ico_pixels`, phase 14) within LARGE_MEAN_REL_MAX and
    LARGE_BLOCK_CORR_MIN; then B1e (`phase_b1e_large`) and the mesh pipe
    (phase 13 at this mesh: B3a, B2, B3b bit for bit) at its 640 blocks."""
    from nrenderer_torch import cli
    from nrenderer_torch.renderers.routes import plan_route
    from nrenderer_torch.server.registry import get_server
    from nrenderer_torch.utils.timing import GLOBAL_TIMER
    t_phase = time.perf_counter()
    name = os.path.splitext(os.path.basename(obj))[0]
    print(f"== phase 32: large mesh, {name}: host prep, native and numpy")
    prep = mesh_prep_seconds(obj)
    print(json.dumps({"mesh_prep_s": prep}))
    if not prep["tables_equal"]:
        raise AssertionError(f"{name}: the numpy build's blocked tables "
                             "differ from the host library's")
    route = plan_route(_scene_of(MESH_SCENE, width, height, spp, depth,
                                 objs=(obj,)),
                       "AccPathTracer", False, "cuda").kind
    out = os.path.join(ROOT, "build", f"smoke_{name}.png")
    argv = _cli_argv(MESH_SCENE, "AccPathTracer", width, height, spp, depth,
                     out, objs=(obj,))
    timers = ("AccPathTracer.scene-prep", "AccPathTracer.bvh-build")
    kernels = (HYBRID_KERNELS if route == "hybrid"
               else ["pt_bsdf_mesh_kernel"])
    st = phase_cli(32, f"large mesh (AccPathTracer, {name}, {route} route, "
                   f"{prep['blocks']} blocks)", argv, kernels, width, height,
                   spp, depth, ICO_MEAN_BAND, _blob_lit, timers=timers)
    px = get_server().screen.get_pixels()[:, :, :3].copy()
    with _env("NR_NO_NATIVE", "1"):
        t0s = {k: GLOBAL_TIMER.get(k).total_s for k in timers}
        t0 = time.perf_counter()
        if cli.main(argv) != 0:
            raise AssertionError(f"{name}: render under NR_NO_NATIVE=1 "
                                 "failed")
        torch.cuda.synchronize()
        numpy_wall = time.perf_counter() - t0
        numpy_timers = {k: GLOBAL_TIMER.get(k).total_s - t
                        for k, t in t0s.items()}
    px_np = get_server().screen.get_pixels()[:, :, :3]
    lin = _lin_stats(px, ico_pixels)
    st.update(route=route, blocks=prep["blocks"], mesh_prep_s=prep,
              numpy_timers=numpy_timers, numpy_seconds=numpy_wall,
              numpy_image_bit_for_bit=bool(np.array_equal(px, px_np)),
              vs_ico_5120=lin)
    print(f"phase 32: {name} on the {route} route, {prep['blocks']} blocks: "
          f"render {st['render_seconds']:.4f} s, CLI wall "
          f"{st['seconds']:.4f} s; scene-prep / bvh-build "
          f"{st['timers'][timers[0]]:.4f} / {st['timers'][timers[1]]:.4f} s "
          f"native, {numpy_timers[timers[0]]:.4f} / "
          f"{numpy_timers[timers[1]]:.4f} s numpy (CLI wall "
          f"{numpy_wall:.4f} s), images bit for bit: "
          f"{st['numpy_image_bit_for_bit']}; peak "
          f"{st['peak_memory_bytes'] / 2**30:.2f} GiB; route counts "
          f"{json.dumps(st.get('routes', {}))}; vs ico_5120: {json.dumps(lin)}"
          f" on {gpu_name_power()}")
    if not st["numpy_image_bit_for_bit"]:
        raise AssertionError(f"{name}: the numpy build's image differs")
    if lin["linear_mean_rel_diff"] > LARGE_MEAN_REL_MAX \
            or lin["block_corr"] < LARGE_BLOCK_CORR_MIN:
        raise AssertionError(f"{name}'s image outside the band of "
                             f"ico_5120's: {lin}")
    st["b1e"] = phase_b1e_launch(obj, 32, B1E_BAND_ROWS)
    st["pipe"], _ = phase_pipe_main_shape(obj=obj, phase=32)
    st["phase_seconds"] = time.perf_counter() - t_phase
    print(f"phase 32 (large mesh) took {st['phase_seconds']:.1f} s")
    return st


# The hybrid bounce's kernels (csrc/pt_kernel.cu), for their bounds: FP32
# operations of a live lane's dense hit and, in the shade kernel, of the
# dense hit again, the light tests and the cheapest scatter (the
# Lambertian lobe; the hash not counted).  Bytes: the dense-hit kernel
# reads every lane's alive byte and a live lane's o and d, and writes every
# lane's cap.  The shade kernel reads every lane's alive byte, a live
# lane's o, d, throughput and the pipe's t, and a mesh winner's normal and
# material; a lane that scatters reads its lane id and writes o, d and
# throughput; one that ends at a light, or misses under an env map, writes
# its alive byte and reads and writes its radiance (the miss also reads
# its texel); a plain miss writes its alive byte alone.
WAVE_DENSE_BYTES, WAVE_LIVE_BYTES = (1 + 4, 24), 40
WAVE_MESH_BYTES, WAVE_SCATTER_BYTES, WAVE_END_BYTES = 16, 40, 25
WAVE_TEXEL_BYTES, WAVE_MISS_BYTES = 12, 1


def _wave_copy(state):
    """A copy of a wavefront's state in the rows of one buffer."""
    from nrenderer_torch.ops.soa import V3
    o, d, thr, rad, alive = state
    st = torch.stack([*o, *d, *thr, *rad]).clone()
    return (*(V3(st[k], st[k + 1], st[k + 2]) for k in (0, 3, 6, 9)),
            alive.clone())


def _wave_restore(dst, src) -> None:
    for a, b in zip((*dst[0], *dst[1], *dst[2], *dst[3], dst[4]),
                    (*src[0], *src[1], *src[2], *src[3], src[4])):
        a.copy_(b)


def _timed_in_place(fn, state, reps: int) -> float:
    """Mean device ms of `fn(copy)`, each run on a fresh copy of `state`
    (the copies outside the timed span)."""
    work = _wave_copy(state)
    total = 0.0
    for _ in range(reps):
        _wave_restore(work, state)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(work)
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def _state_err(got, want) -> int:
    """The largest word error over two wavefront states' rows, and the
    count of alive flags that differ (0: bit for bit)."""
    err = max(_word_err(g, w) for g, w in zip(
        (*got[0], *got[1], *got[2], *got[3]),
        (*want[0], *want[1], *want[2], *want[3])))
    return max(err, int((got[4] != want[4]).sum()))


def _wave_case(label, ss, wt, mt, eager, fused, state, draws, b) -> dict:
    """One bounce at one shape: the fused bounce against the eager one and
    each kernel against its plain version, bit for bit, and each kernel
    timed beside its bound and its plain version."""
    from nrenderer_torch.ops import mesh_cuda, pt_cuda
    from nrenderer_torch.ops.intersect import intersect_area_lights_unrolled
    o, d, thr, rad, alive = state
    n = alive.shape[0]
    want = eager(*_wave_copy(state), draws, b)
    err = _state_err(fused(*_wave_copy(state), draws, b), want)
    cap = pt_cuda.wavefront_dense_hit(wt, o, d, alive)
    dense_err = _word_err(cap, pt_cuda.wavefront_dense_hit_plain(wt, o, d,
                                                                 alive))
    hit = mesh_cuda.intersect_triangles_mesh(mt, o, d, wt.t_min, cap,
                                             None)[:5]
    shaded = _wave_copy(state)
    pt_cuda.wavefront_shade(wt, *shaded, hit, draws, b)
    shade_err = _state_err(shaded, pt_cuda.wavefront_shade_plain(
        wt, *state, hit, draws, b))
    t_l = intersect_area_lights_unrolled(ss, o, d, t_min=wt.t_min)[0]
    ended = alive & ~want[4]
    live, scatter = int(alive.sum()), int(want[4].sum())
    lit = int((ended & (t_l < float("inf"))).sum())
    misses = int(ended.sum()) - lit
    env_misses = misses if wt.env is not None else 0
    mesh_hits = int((alive & (hit[0] < cap)).sum())
    per_live = len(ss.sph) * FLOPS_SPHERE + len(ss.pln) * FLOPS_PATCH
    dense_bound = _bound(live * per_live, n * WAVE_DENSE_BYTES[0]
                         + live * WAVE_DENSE_BYTES[1])
    shade_bound = _bound(
        live * (per_live + len(ss.al) * FLOPS_PATCH + FLOPS_SCATTER),
        n + live * WAVE_LIVE_BYTES + mesh_hits * WAVE_MESH_BYTES
        + scatter * WAVE_SCATTER_BYTES + (lit + env_misses) * WAVE_END_BYTES
        + env_misses * WAVE_TEXEL_BYTES
        + (misses - env_misses) * WAVE_MISS_BYTES)
    dense_ms = _time_ms(lambda: pt_cuda.wavefront_dense_hit(wt, o, d, alive),
                        20)
    dense_plain_ms = _time_ms(
        lambda: pt_cuda.wavefront_dense_hit_plain(wt, o, d, alive), 3)
    shade_ms = _timed_in_place(
        lambda s: pt_cuda.wavefront_shade(wt, *s, hit, draws, b), state, 20)
    shade_plain_ms = _time_ms(lambda: pt_cuda.wavefront_shade_plain(
        wt, *state, hit, draws, b), 3)
    pipe_ms = _time_ms(lambda: mesh_cuda.intersect_triangles_mesh(
        mt, o, d, wt.t_min, cap, None), 3)
    eager_ms = _time_ms(lambda: eager(*state, draws, b), 3)
    fused_ms = _timed_in_place(lambda s: fused(*s, draws, b), state, 3)
    st = {"shape": label, "lanes": n, "live": live, "mesh_hits": mesh_hits,
          "scatter": scatter, "lit": lit, "misses": misses,
          "max_abs_err": err, "dense_hit_max_abs_err": dense_err,
          "shade_max_abs_err": shade_err,
          "dense_hit_ms": dense_ms, "dense_hit_plain_ms": dense_plain_ms,
          "dense_hit_bound_ms": dense_bound[0],
          "dense_hit_bound_by": dense_bound[1],
          "shade_ms": shade_ms, "shade_plain_ms": shade_plain_ms,
          "shade_bound_ms": shade_bound[0],
          "shade_bound_by": shade_bound[1], "pipe_ms": pipe_ms,
          "eager_bounce_ms": eager_ms, "fused_bounce_ms": fused_ms,
          "eager_math_ms": eager_ms - pipe_ms}
    print(json.dumps(st))
    if err or dense_err or shade_err:
        raise AssertionError(
            f"{label}: the wavefront kernels differ (max word error: the "
            f"fused bounce against the eager one {err}, the dense-hit "
            f"kernel against its plain version {dense_err}, the shade "
            f"kernel against its plain version {shade_err})")
    return st


def phase_wavefront_bounce(obj, width=500, height=500, chunk=64) -> dict:
    """33: the hybrid bounce's kernels at the large-mesh cell's shapes:
    bounce 1 of a chunk (500x500, 64 spp: 16 Mi lanes) and bounce 6, the
    first after the stage pack into n / 2 slots; at each, the fused bounce
    against the eager one and each kernel against its plain version bit
    for bit (every state word and alive flag, every cap word), each kernel
    timed beside its bound and its plain version, and the whole bounce in
    both forms beside the mesh pipe's time."""
    name = os.path.splitext(os.path.basename(obj))[0]
    print(f"== phase 33: the hybrid bounce's kernels, {name}, {width}x"
          f"{height}, {chunk} spp a chunk")
    from nrenderer_torch.ops import pt_cuda
    from nrenderer_torch.ops.bvh import build_mesh_accel
    from nrenderer_torch.ops.mesh_cuda import make_mesh_tables
    from nrenderer_torch.ops.pt_core import make_mat_channels, scene_epsilon
    from nrenderer_torch.ops.stream_compact import stream_pack_channels
    from nrenderer_torch.ops.soa import V3
    from nrenderer_torch.renderers import _wavefront
    ss, cam, _, arrays = _setup("cuda", MESH_SCENE, objs=(obj,))
    mt = make_mesh_tables(build_mesh_accel(arrays, make_mat_channels(ss)).bt,
                          "cuda")
    t_min = scene_epsilon(ss)
    wt = pt_cuda.make_wave_tables(ss, t_min, None, "cuda")
    fused = _wavefront.make_bsdf_bounce(ss, t_min, mt)
    real = _wavefront.bounce_form
    _wavefront.bounce_form = lambda *a: "eager"
    try:
        eager = _wavefront.make_bsdf_bounce(ss, t_min, mt)
    finally:
        _wavefront.bounce_form = real
    n_pix = width * height
    draws, o, d = _wavefront._camera_chunk(cam, width, height, 0, 0, chunk, 0,
                                           n_pix)
    state = eager(*_wavefront._new_state(o, d), draws, 0, coherent=True)
    rows = [_wave_case("bounce 1, the chunk's lanes", ss, wt, mt, eager,
                       fused, state, draws, 1)]
    for b in range(1, 6):
        state = eager(*state, draws, b)
    o, d, thr, rad, alive = state
    cap = (chunk * n_pix // 2) // 128 * 128
    sp_k = stream_pack_channels((*o, *d, *thr, alive.to(torch.float32),
                                 draws.lane), cap, mask_from=9)
    p = sp_k.packed
    packed = (*(V3(p[k], p[k + 1], p[k + 2]) for k in (0, 3, 6)),
              V3(*torch.zeros((3, cap), device="cuda")), p[9] > 0.0)
    rows.append(_wave_case(
        f"bounce 6, after the pack into {cap} slots", ss, wt, mt, eager,
        fused, packed, draws._replace(lane=p[10].view(torch.int32)), 6))
    return {"rows": rows,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{f"{k}_max_abs_err": max(r[f"{k}_max_abs_err"] for r in rows)
               for k in ("dense_hit", "shade")}}


@contextlib.contextmanager
def _env(name: str, value):
    """The environment variable `name` set to `value` (removed when None)
    for the duration: NR_MESH_MXU=1 sweeps on B4, NR_NO_NATIVE=1 runs the
    host library's numpy versions."""
    def put(v):
        if v is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = v

    old = os.environ.get(name)
    put(value)
    try:
        yield
    finally:
        put(old)


def _ptxas(kernel: str) -> str:
    """The ptxas register and spill lines of one kernel from the build
    log (empty when the library was not rebuilt in this run)."""
    from nrenderer_torch import _build
    if not _build.LOG_PATH.exists():
        return ""
    lines = _build.LOG_PATH.read_text().splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            return " / ".join(ln.strip() for ln in lines[i + 1:i + 4]
                              if "registers" in ln or "spill" in ln)
    return ""


def _ptxas_table() -> dict:
    """Every kernel's (stack frame, spill stores, spill loads, registers)
    from the build log, by its mangled name past the translation unit's
    prefix (empty when the library was not rebuilt in this run)."""
    import re
    from nrenderer_torch import _build
    if not _build.LOG_PATH.exists():
        return {}
    lines = _build.LOG_PATH.read_text().splitlines()
    out = {}
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if not m:
            continue
        got = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                        r"(\d+) bytes spill loads.*?Used (\d+) registers",
                        " ".join(lines[i + 1:i + 5]))
        if got:
            name = re.sub(
                r"^_ZN\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "",
                m.group(1))
            out[name] = tuple(int(x) for x in got.groups())
    return out


def check_kept_ptxas() -> dict:
    """The `-Xptxas -v` figures of the kernels that KEPT_PTXAS lists
    against it: raises where one differs."""
    table = _ptxas_table()
    if not table:
        print("ptxas: the library was not rebuilt in this run; not checked")
        return {}
    got = {}
    for key, want in KEPT_PTXAS.items():
        found = [v for k, v in table.items() if k.startswith(key)]
        got[key] = found[0] if len(found) == 1 else None
    print(f"ptxas of the kept kernels (stack, spill stores, spill loads, "
          f"registers): {json.dumps(got)}")
    bad = {k: (v, KEPT_PTXAS[k]) for k, v in got.items()
           if v != KEPT_PTXAS[k]}
    if bad:
        raise AssertionError(f"-Xptxas -v differs from KEPT_PTXAS: {bad}")
    return got


def _schedule(mt, work: dict, n_rays: int, mxu: bool, device) -> dict:
    """The sweep's schedule counts (`mesh_cuda.schedule_counts`, 32
    consecutive rays a warp; B4's with its ray batch)."""
    from nrenderer_torch.ops import mesh_cuda, mesh_mxu
    return mesh_cuda.schedule_counts(
        torch.cat(work["enter"]),
        torch.arange(n_rays, device=device) // mesh_cuda.WARP, mt.block,
        ray_batch=mesh_mxu.RAY_BATCH if mxu else None)


def phase_mxu_sweep(n_rays=1 << 20, seed=0) -> dict:
    """`mesh_sweep_mxu_kernel` against its plain version on phase 9's rays
    (ico_5120.obj, a tenth of them dead), every output bit for bit, and
    against B2's kernel on the same rays: the share of rays that hit on
    one side only, and of rays both hit on the same triangle."""
    from nrenderer_torch.ops import mesh_mxu
    from nrenderer_torch.ops.mesh_cuda import sweep_mesh_full
    from nrenderer_torch.ops.soa import V3
    bt, mt, t_min, rays = _ico_rays(n_rays, seed)
    o, d, cap = V3(*rays[0:3]), V3(*rays[3:6]), rays[6]
    name = mesh_mxu.KERNEL_NAME
    print(f"== phase 17: {name} vs plain, ico_5120.obj ({bt.n_blocks} "
          f"blocks of {bt.block}), {n_rays} rays")
    kept_ptxas = check_kept_ptxas()
    work = {"enter": []}
    with _env("NR_MESH_MXU", "1"):
        before = mesh_mxu.KERNEL_LAUNCHES[name]
        got = sweep_mesh_full(mt, o, d, t_min, t_cap=cap)
        if mesh_mxu.KERNEL_LAUNCHES[name] != before + 1:
            raise AssertionError(f"{name} did not launch")
        kernel_ms = _time_ms(lambda: sweep_mesh_full(mt, o, d, t_min,
                                                     t_cap=cap), 5)
    raw = mesh_mxu.sweep_mxu_plain(mt, o, d, t_min, cap, stats=work)
    plain_ms = _time_ms(lambda: mesh_mxu.sweep_mxu_plain(mt, o, d, t_min,
                                                         cap), 1)
    with _env("NR_MESH_MXU", None):
        b2 = sweep_mesh_full(mt, o, d, t_min, t_cap=cap)
    torch.cuda.synchronize()
    want = [torch.where(raw[1] >= 0, raw[0], float("inf")),
            raw[1].to(torch.int32)] + list(raw[2:])
    differ = [int((a != b).sum()) for a, b in zip(got, want)]
    hit, hit2 = got[1] >= 0, b2[1] >= 0
    both = hit & hit2
    flops = (work["slab_tests"] * FLOPS_SLAB
             + work["tri_tests"] * FLOPS_MXU_TRI)
    n_bytes = n_rays * 4 * (7 + 6) + _table_bytes(mt.tris, mt.coef_t,
                                                  mt.bb)
    b_ms, b_by = _bound(flops, n_bytes)
    rel = torch.zeros_like(got[0])
    rel[both] = (got[0][both] - b2[0][both]).abs() / b2[0][both].abs()
    edge = torch.nonzero((hit != hit2) | (rel > 1e-3)).flatten()
    report = _edge_report(mt, o, d, t_min, got, b2, edge[:32])
    st = {"kernel": name, "rays": n_rays, "hits": int(hit.sum()),
          "outputs_differ": differ,
          "max_abs_err": float((got[0][hit] - want[0][hit]).abs().max()),
          "vs_b2_flip_share": float((hit != hit2).float().mean()),
          "vs_b2_same_triangle_share": float(
              (got[1][both] == b2[1][both]).float().mean()),
          "vs_b2_t_rel_max": float(rel.max()),
          "vs_b2_edge_rays": int(edge.numel()),
          "edge_rays_right": {k: sum(r["right"] == k for r in report)
                              for k in ("b4", "b2", "both", "neither")},
          "kernel_ms": kernel_ms, "plain_ms": plain_ms,
          "bound_ms": b_ms, "bound_by": b_by,
          "slab_tests": work["slab_tests"], "tri_tests": work["tri_tests"],
          "schedule": _schedule(mt, work, n_rays, True, rays.device),
          "ptxas": _ptxas(name),
          "kept_ptxas": kept_ptxas}
    print(json.dumps(st))
    for r in report:
        print("  edge ray:", json.dumps(r))
    if any(differ) or st["hits"] < n_rays // 10:
        raise AssertionError(f"{name} disagrees with its plain version: "
                             f"{st}")
    if st["vs_b2_flip_share"] > 0.002 or \
            st["vs_b2_same_triangle_share"] < 0.998 or \
            st["vs_b2_edge_rays"] > EDGE_RAYS_MAX:
        raise AssertionError(f"{name} against B2 past the bars: {st}")
    return st


def _edge_report(mt, o, d, t_min, b4, b2, rays) -> list:
    """The rays `rays` with both engines' (t, pid) and a float64
    intersection with every real triangle of the pool (the float32 table's
    vertices): its t, pid and the winner's least barycentric coordinate
    (its distance inside the nearest edge).  An engine is right where its
    t is within 1e-4 relative (plus 1e-4) of the float64 t."""
    if rays.numel() == 0:
        return []
    tri = mt.tris.to(torch.float64)
    tri = tri[tri[:, 13] >= 0]
    v1, e1, e2 = tri[None, :, 0:3], tri[None, :, 3:6], tri[None, :, 6:9]
    og = torch.stack([o.x[rays], o.y[rays], o.z[rays]], dim=1)
    dg = torch.stack([d.x[rays], d.y[rays], d.z[rays]], dim=1)
    o64, d64 = og.to(torch.float64)[:, None], dg.to(torch.float64)[:, None]
    p = torch.linalg.cross(d64.expand(-1, tri.shape[0], -1),
                           e2.expand(rays.numel(), -1, -1))
    det = (e1 * p).sum(-1)
    tv = o64 - v1
    q = torch.linalg.cross(tv, e1.expand_as(tv))
    u = (tv * p).sum(-1) / det
    v = (d64 * q).sum(-1) / det
    t = (e2 * q).sum(-1) / det
    margin = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
    t_in = torch.where((margin >= 0) & (t >= t_min), t, float("inf"))
    j = torch.argmin(t_in, dim=1)
    t_ref = t_in.gather(1, j[:, None])[:, 0]
    close = lambda te: (te == t_ref) | (
        (te - t_ref).abs() <= 1e-4 * t_ref.abs() + 1e-4)
    ok4, ok2 = close(b4[0][rays].double()), close(b2[0][rays].double())
    right = {(True, True): "both", (True, False): "b4",
             (False, True): "b2", (False, False): "neither"}
    out = []
    for k, i in enumerate(rays.tolist()):
        out.append({"ray": i, "o": og[k].tolist(), "d": dg[k].tolist(),
                    "b4": [float(b4[0][i]), int(b4[1][i])],
                    "b2": [float(b2[0][i]), int(b2[1][i])],
                    "f64": [float(t_ref[k]), int(tri[j[k], 13]),
                            float(margin[k, j[k]])],
                    "right": right[(bool(ok4[k]), bool(ok2[k]))]})
    return out


def _engine_vs_plain(mt, rays, t_min, f2b, mxu, label, timing=False,
                     need_hits=True) -> dict:
    """One sweep engine's kernel (B4 with `mxu`, else B2) against its plain
    version on the (7, n) rays `rays` (o, d, cap) on the card: every output
    bit for bit (t as `sweep_mesh_full` returns it, +inf on a miss).  With
    `timing`: the kernel's time (5 calls between events), its bound from
    the plain version's counts, and for B2 the schedule counts of its
    warps (`mesh_cuda.schedule_counts`, 32 consecutive rays a warp)."""
    from nrenderer_torch.ops import mesh_cuda, mesh_mxu
    from nrenderer_torch.ops.soa import V3
    o, d, cap = V3(rays[0], rays[1], rays[2]), V3(rays[3], rays[4],
                                                   rays[5]), rays[6]
    work = {"enter": []} if timing else {}
    if mxu:
        sweep = lambda: mesh_mxu.sweep_mxu(mt, o, d, t_min, cap)
        raw = mesh_mxu.sweep_mxu_plain(mt, o, d, t_min, cap, stats=work)
    else:
        sweep = lambda: mesh_cuda._sweep_cuda(mt, o, d, t_min, cap, f2b,
                                              False)
        raw = mesh_cuda.sweep_mesh_plain(mt, o, d, t_min, cap, f2b=f2b,
                                         stats=work)
    got = sweep()
    torch.cuda.synchronize()
    norm = lambda out: [torch.where(out[1] >= 0, out[0], float("inf")),
                        out[1]] + list(out[2:6])
    got, want = norm(got), norm(raw)
    differ = [int((a != b).sum()) for a, b in zip(got, want)]
    hit = got[1] >= 0
    st = {"check": label, "kernel": (mesh_mxu if mxu else mesh_cuda
                                     ).KERNEL_NAME,
          "rays": int(rays.shape[1]), "live": int((cap > t_min).sum()),
          "hits": int(hit.sum()), "outputs_differ": differ,
          "max_abs_err": float((got[0][hit] - want[0][hit]).abs().max())
          if bool(hit.any()) else 0.0}
    if timing:
        tri_flops = FLOPS_MXU_TRI if mxu else FLOPS_MESH_TRI
        n_bytes = st["rays"] * 4 * (7 + 6) + _table_bytes(
            mt.tris, mt.bb, mt.coef_t if mxu else None)
        st["kernel_ms"] = _time_ms(sweep, 5)
        st["bound_ms"], st["bound_by"] = _bound(
            work["slab_tests"] * FLOPS_SLAB + work["tri_tests"] * tri_flops,
            n_bytes)
        st["slab_tests"], st["tri_tests"] = (work["slab_tests"],
                                             work["tri_tests"])
        st["schedule"] = _schedule(mt, work, st["rays"], mxu, rays.device)
    print(json.dumps(st))
    if any(differ) or (need_hits and not st["hits"]):
        raise AssertionError(f"{label}: kernel vs plain version: {st}")
    return st


def _image_bars(a, b, label, share_min, mean_max=MEAN_ABS_MAX) -> dict:
    """A bar on the mean |d| (phase 4's by default) and a share of pixels
    within 1e-4 on two gamma'd (H, W, 3) images."""
    d = np.abs(a - b)
    st = {"max_abs_err": float(d.max()), "mean_abs_err": float(d.mean()),
          "share_within_1e-4": float((d.max(axis=-1) <= WITHIN).mean())}
    print(f"{label}: {json.dumps(st)}")
    if st["mean_abs_err"] > mean_max or \
            st["share_within_1e-4"] < share_min:
        raise AssertionError(f"{label} past the bars: {st}")
    return st


def phase_hybrid_mxu_path(b2_pixels, prefix, width=500, height=500,
                          spp=256, depth=20) -> dict:
    """Phase 18: the hybrid path under NR_MESH_MXU=1 through `cli.main`,
    its image against phase 14's (B2), then B4 against its plain version
    on phase 13's sorted live prefix of the same path's chunk."""
    out = os.path.join(ROOT, "build", "smoke_ico_mxu.png")
    argv = _cli_argv(MESH_SCENE, "AccPathTracer", width, height, spp, depth,
                     out, objs=(ICO,))
    from nrenderer_torch.server.registry import get_server
    with _env("NR_MESH_MXU", "1"), _hybrid_pinned():
        st = phase_cli(18, "hybrid path under NR_MESH_MXU=1 (AccPathTracer, "
                       "ico_5120)", argv, HYBRID_MXU_KERNELS, width, height,
                       spp, depth, ICO_MEAN_BAND, _blob_lit)
    if st["launches"]["mesh_sweep_kernel"] != 0:
        raise AssertionError("the hybrid path under NR_MESH_MXU=1 swept "
                             "on B2")
    st["vs_b2_image"] = _image_bars(
        get_server().screen.get_pixels()[:, :, :3], b2_pixels,
        "hybrid path, B4 image vs B2 image", ENGINE_WITHIN_SHARE_MIN,
        ENGINE_MEAN_ABS_MAX)
    mt, t_min, rays = prefix
    st["prefix_vs_plain"] = _engine_vs_plain(
        mt, rays, t_min, True, True,
        "phase 18: B4 on the hybrid chunk's sorted live prefix",
        timing=True)
    return st


def _mlt_argv(scene, width, height, depth, chains, mutations, out,
              objs=()):
    argv = ["render", "--scene", scene, "--renderer",
            "MetropolisLightTransport", "--width", str(width), "--height",
            str(height), "--depth", str(depth), "--chains", str(chains),
            "--mutations", str(mutations), "--device", "cuda", "--out", out]
    for obj in objs:
        argv += ["--obj", obj]
    return argv


def _mlt_stats(st, chains, mutations) -> dict:
    st["kmutations_per_s"] = chains * mutations / st["render_seconds"] / 1e3
    print(f"{st['path']}: render {st['render_seconds']:.3f} s, "
          f"{st['kmutations_per_s']:.1f} Kmut/s")
    return st


def _linear(px):
    """MLT's tone map pow(1 - exp(-x s), 1/2.2) undone (up to s)."""
    return -np.log1p(-np.clip(px.astype(np.float64), 0.0, 0.999999) ** 2.2)


def _blocks8(px):
    """Means of the whole 8x8 blocks (a ragged right or top edge dropped)."""
    h, w = (n - n % 8 for n in px.shape[:2])
    return px[:h, :w].reshape(h // 8, 8, w // 8, 8, 3).mean(
        axis=(1, 3)).reshape(-1)


def phase_mlt_cornell(width=512, height=512, chains=1024, mutations=256,
                      depth=20) -> dict:
    out = os.path.join(ROOT, "build", "smoke_mlt.png")
    argv = _mlt_argv(SCENE, width, height, depth, chains, mutations, out)
    warm = _mlt_argv(SCENE, 64, 64, depth, chains, 2, out)
    st = phase_cli(19, f"MLT (cornell_box), {chains} chains x {mutations} "
                   f"mutations", argv, [], width, height, 1, depth,
                   MLT_MEAN_BAND, _light_brighter, warm_argv=warm)
    return _mlt_stats(st, chains, mutations)


@contextlib.contextmanager
def _held_sweeps(chains: int, held: dict):
    """Hold a copy of the inputs of the first sweep of each of MLT's
    batch shapes, the 2-chains-lane path batch ("bounce") and the others
    (the connection shadow rays), as `sweep_mesh_full` receives them."""
    from nrenderer_torch.ops import mesh_cuda
    sweep = mesh_cuda.sweep_mesh_full

    def hold(mt, o, d, t_min, t_cap=None, n_valid=None, f2b=False,
             with_uv=False):
        kind = "bounce" if o.x.shape[0] == 2 * chains else "shadow"
        if kind not in held and t_cap is not None and n_valid is None \
                and not with_uv:
            held[kind] = (mt, torch.stack([o.x, o.y, o.z, d.x, d.y, d.z,
                                           t_cap.to(torch.float32)]),
                          t_min, f2b)
        return sweep(mt, o, d, t_min, t_cap=t_cap, n_valid=n_valid,
                     f2b=f2b, with_uv=with_uv)

    mesh_cuda.sweep_mesh_full = hold
    try:
        yield held
    finally:
        mesh_cuda.sweep_mesh_full = sweep


def phase_mlt_mesh(width=128, height=128, chains=1024, mutations=256,
                   depth=8) -> tuple:
    """Phase 20: MLT's mesh scene on each sweep engine, each engine's
    kernel against its plain version on one of the run's path batches and
    one of its shadow batches, the two images held to each other, and
    against AccPathTracer's."""
    from nrenderer_torch import cli
    from nrenderer_torch.server.registry import get_server
    runs, images, batches = [], {}, None
    for mxu, kernel in (("0", "mesh_sweep_kernel"),
                        ("1", "mesh_sweep_mxu_kernel")):
        out = os.path.join(ROOT, "build", f"smoke_mlt_mesh_{mxu}.png")
        argv = _mlt_argv(MESH_SCENE, width, height, depth, chains,
                         mutations, out, objs=(BLOB,))
        warm = _mlt_argv(MESH_SCENE, width, height, depth, chains, 2, out,
                         objs=(BLOB,))
        with _env("NR_MESH_MXU", "1" if mxu == "1" else None), \
                _held_sweeps(chains, {}) as held:
            st = phase_cli(20, f"MLT mesh scene ({kernel}), {chains} chains "
                           f"x {mutations} mutations", argv, [kernel],
                           width, height, 1, depth, MLT_MESH_MEAN_BAND,
                           _blob_lit, warm_argv=warm)
        other = ("mesh_sweep_mxu_kernel" if mxu == "0"
                 else "mesh_sweep_kernel")
        if st["launches"][other] != 0:
            raise AssertionError(f"MLT ({kernel}) launched {other}")
        if sorted(held) != ["bounce", "shadow"]:
            raise AssertionError(f"MLT ({kernel}) swept no {held.keys()}")
        # each engine on the batches the B2 run held, timed; B4 also on
        # the batches of its own run
        batches = batches or held
        st["batches_vs_plain"] = [
            _engine_vs_plain(mt, rays, t_min, f2b, mxu == "1",
                             f"phase 20: {kernel} on an MLT {kind} batch "
                             f"({rays.shape[1]} rays)", timing=True)
            for kind, (mt, rays, t_min, f2b) in sorted(batches.items())]
        if held is not batches:
            st["batches_vs_plain"] += [
                _engine_vs_plain(mt, rays, t_min, f2b, True,
                                 f"phase 20: {kernel} on its own run's MLT "
                                 f"{kind} batch")
                for kind, (mt, rays, t_min, f2b) in sorted(held.items())]
        images[mxu] = get_server().screen.get_pixels()[:, :, :3].copy()
        runs.append(_mlt_stats(st, chains, mutations))
    out = os.path.join(ROOT, "build", "smoke_mlt_mesh_acc.png")
    if cli.main(_cli_argv(MESH_SCENE, "AccPathTracer", width, height, 256,
                          depth, out, objs=(BLOB,))) != 0:
        raise AssertionError("AccPathTracer on MLT's mesh scene failed")
    pt = get_server().screen.get_pixels()[:, :, :3].astype(np.float64)
    band = height // 6   # the light quad's rows: MinPathLength = 3
    lin = {k: _linear(v) for k, v in images.items()}
    pt_lin = pt ** 2
    st = {"linear_mean_b2": float(lin["0"].mean()),
          "linear_mean_b4": float(lin["1"].mean()),
          "linear_mean_rel_diff": float(abs(lin["1"].mean() / lin["0"].mean()
                                            - 1.0)),
          "block_corr_b4_b2": float(np.corrcoef(_blocks8(images["1"]),
                                                _blocks8(images["0"]))[0, 1]),
          "ratio_to_acc_pt_b2": float(lin["0"][band:].mean()
                                      / pt_lin[band:].mean()),
          "ratio_to_acc_pt_b4": float(lin["1"][band:].mean()
                                      / pt_lin[band:].mean()),
          "block_corr_to_acc_pt_b2": float(np.corrcoef(
              _blocks8(images["0"]), _blocks8(pt))[0, 1])}
    print(f"MLT mesh scene, B4 vs B2 and vs AccPathTracer: {json.dumps(st)}")
    if st["linear_mean_rel_diff"] > 0.05 or st["block_corr_b4_b2"] < 0.9:
        raise AssertionError(f"MLT mesh scene, B4 vs B2 past the bars: {st}")
    runs[1]["vs_b2"] = st
    return tuple(runs)


PROGRESSIVE_TIMERS = ("SimplePathTracer.first-pass",
                      "SimplePathTracer.render-pass",
                      "SimplePathTracer.host-preview")


def _lin_stats(a, b) -> dict:
    """Two gamma'd images as independent estimates of one image: the
    relative difference of their linear means and the correlation of their
    8x8-block means (phase 20's bars: within 5%, >= 0.9)."""
    la, lb = (x.astype(np.float64) ** 2 for x in (a, b))
    return {"linear_mean_rel_diff": float(abs(la.mean() / lb.mean() - 1.0)),
            "block_corr": float(np.corrcoef(_blocks8(a), _blocks8(b))[0, 1])}


def _empty_scene_pass() -> dict:
    """A scene without primitives through one progressive pass, kernel
    against plain version: the ambient at depth 0, black past it (the JAX
    route's image)."""
    from nrenderer_torch import Scene, build_scene_arrays
    from nrenderer_torch.ops.camera import make_camera
    from nrenderer_torch.ops.intersect import make_static_scene
    from nrenderer_torch.ops.pt_cuda import pt_accumulate, \
        pt_accumulate_plain
    scene = Scene()
    scene.ambient.constant = (0.2, 0.3, 0.4)
    ss = make_static_scene(build_scene_arrays(scene))
    cam = make_camera(scene.camera, device="cuda")
    out = {}
    for depth in (0, 3):
        films = []
        for fn in (pt_accumulate, pt_accumulate_plain):
            film = torch.zeros((64 * 48, 3), dtype=torch.float32,
                               device="cuda")
            films.append(fn(film, ss, cam, 64, 48, 0, 8, depth, 7, 1e-6))
        want = torch.tensor([0.2, 0.3, 0.4], device="cuda") * 8 \
            if depth == 0 else torch.zeros(3, device="cuda")
        if not (torch.equal(films[0], films[1])
                and torch.allclose(films[0][0], want, rtol=1e-6, atol=0)):
            raise AssertionError(f"empty scene, depth {depth}: kernel "
                                 f"{films[0][0].tolist()}, plain "
                                 f"{films[1][0].tolist()}")
        out[f"depth_{depth}"] = films[0][0].tolist()
    return out


def phase_progressive(main_px, width=512, height=512, spp=2048,
                      depth=20) -> tuple:
    """Phase 21: the progressive main path through `cli.main(["render",
    "--progressive", ...])`, B1a launched spp // pick_chunk times; its
    image against phase 5's; one of its passes, kernel against plain
    version bit for bit and timed; the env and textured forms under
    --progressive; an empty scene's pass."""
    from nrenderer_torch.ops.pt_cuda import _int32
    from nrenderer_torch.renderers.routes import pick_chunk
    chunk = pick_chunk(width, height, spp)
    out = os.path.join(ROOT, "build", "smoke_progressive.png")
    argv = _cli_argv(SCENE, "SimplePathTracer", width, height, spp, depth,
                     out) + ["--progressive"]
    st = phase_cli(21, "progressive main path (SimplePathTracer)", argv,
                   ["pt_diffuse_kernel"], width, height, spp, depth,
                   MEAN_BAND, _light_brighter, timers=PROGRESSIVE_TIMERS)
    from nrenderer_torch.server.registry import get_server
    px = get_server().screen.get_pixels()[:, :, :3].copy()
    n = st["launches"]["pt_diffuse_kernel"]
    t = {k.split(".")[1]: v for k, v in st["timers"].items()}
    st.update(passes=spp // chunk, pass_spp=chunk, pass_seconds=t,
              vs_one_shot=_lin_stats(px, main_px))
    print(f"progressive main path: {n} launches of {chunk} spp; wall "
          f"{st['seconds']:.3f} s: first-pass {t['first-pass']:.3f} s, "
          f"render-pass {t['render-pass']:.3f} s, host-preview "
          f"{t['host-preview']:.3f} s; vs phase 5: "
          f"{json.dumps(st['vs_one_shot'])}")
    if n != spp // chunk:
        raise AssertionError(f"progressive path: {n} launches of "
                             f"pt_diffuse_kernel, not {spp // chunk}")
    vs = st["vs_one_shot"]
    if vs["linear_mean_rel_diff"] > 0.05 or vs["block_corr"] < 0.9:
        raise AssertionError(f"progressive image vs phase 5's: {vs}")
    # the last pass (at the CLI's seed 0: seed 0 * 100003 + pass), held bit
    # for bit and timed at its own size
    st["pass_vs_plain"] = phase_parity(
        width, height, chunk, depth, seed=_int32(0 * 100003 + n - 1),
        phase=21)
    st["empty_scene"] = _empty_scene_pass()
    runs = [st]
    for label, scene, kernel, objs, env, size, spp_, depth_, band, \
            check in (
            ("env map, progressive", ENV_SCENE, "pt_diffuse_env_kernel", (),
             True, 512, 1024, 8, ENV_MEAN_BAND, _sky_bright),
            ("textured quad, progressive", TEX_SCENE, "pt_diffuse_tex_kernel",
             (TEX_QUAD,), False, 256, 512, 6, GRID_MEAN_BAND, _red_left)):
        out = os.path.join(ROOT, "build", f"smoke_progressive_{kernel}.png")
        argv = _cli_argv(scene, "SimplePathTracer", size, size, spp_, depth_,
                         out, env=env, objs=objs) + ["--progressive"]
        r = phase_cli(21, label, argv, [kernel], size, size, spp_, depth_,
                      band, check, timers=PROGRESSIVE_TIMERS)
        want = spp_ // pick_chunk(size, size, spp_)
        if r["launches"][kernel] != want:
            raise AssertionError(f"{label}: {r['launches'][kernel]} "
                                 f"launches of {kernel}, not {want}")
        runs.append(r)
    return tuple(runs)


def phase_resume(width=512, height=512, spp=64, depth=20) -> dict:
    """Phase 22: a --checkpoint render that dies after two passes, run
    again, ends bit for bit on the uninterrupted render."""
    print(f"== phase 22: resume on the card, {width}x{height}, {spp} spp, "
          f"depth {depth}")
    from nrenderer_torch import cli
    from nrenderer_torch.renderers import routes
    from nrenderer_torch.server.registry import get_server
    ckpt = os.path.join(ROOT, "build", "smoke_resume.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    out = os.path.join(ROOT, "build", "smoke_resume.png")
    argv = _cli_argv(SCENE, "SimplePathTracer", width, height, spp, depth,
                     out)
    if cli.main(argv + ["--progressive"]) != 0:
        raise AssertionError("uninterrupted progressive render failed")
    whole = get_server().screen.get_pixels().copy()
    real = routes.pt_accumulate
    calls = []

    def dies_on_third(*args, **kw):
        calls.append(args[8])
        if len(calls) == 3:
            raise KeyboardInterrupt("interrupted")
        return real(*args, **kw)

    routes.pt_accumulate = dies_on_third
    try:
        rc = cli.main(argv + ["--checkpoint", ckpt])
    except KeyboardInterrupt:
        rc = None
    finally:
        routes.pt_accumulate = real
    spp_done = int(np.load(ckpt)["spp_done"])
    chunk = routes.pick_chunk(width, height, spp)
    if rc is not None or spp_done != 2 * chunk:
        raise AssertionError(f"interrupted render: rc {rc}, checkpoint at "
                             f"{spp_done} spp, not {2 * chunk}")
    from nrenderer_torch.ops import pt_cuda
    pt_cuda.reset_launch_counts()
    if cli.main(argv + ["--checkpoint", ckpt]) != 0:
        raise AssertionError("resumed render failed")
    resumed = get_server().screen.get_pixels().copy()
    n = pt_cuda.KERNEL_LAUNCHES["pt_diffuse_kernel"]
    st = {"path": "resume", "passes": spp // chunk, "resumed_at": spp_done,
          "launches_after_resume": n,
          "max_abs_err": float(np.abs(resumed - whole).max())}
    print(json.dumps(st))
    if n != spp // chunk - 2 or not np.array_equal(resumed, whole):
        raise AssertionError(f"resumed render differs: {st}")
    return st


def phase_camera_flags(width=128, height=128, spp=64, depth=20) -> dict:
    """Phase 23: the camera flags through the CLI: a thin lens
    (`--aperture`; the lens focuses at the camera's focus distance, 0.1 by
    default, so 0.01 blurs the box by ~0.05 rad) with `--fov` and
    `--camera-position`."""
    out = os.path.join(ROOT, "build", "smoke_aperture.png")
    argv = _cli_argv(SCENE, "SimplePathTracer", width, height, spp, depth,
                     out) + ["--aperture", "0.01", "--fov", "42",
                             "--camera-position", "0", "0", "12"]
    return phase_cli(23, "camera flags (--aperture 0.01, --fov, "
                     "--camera-position)", argv, ["pt_diffuse_kernel"],
                     width, height, spp, depth, MEAN_BAND, _light_brighter)


# RayCast and GeometryPreview are torch ops on the card and on the CPU;
# the two devices round rsqrt, pow and cos differently (within a few
# ulps), which can move a pixel whose ray grazes an edge: >= 99.9% of
# pixels within 1e-5.
RAY_WITHIN_SHARE_MIN = 0.999


def _device_pair(label, render, scene) -> dict:
    """`render(scene, device)` on the card (warm, then timed with its peak
    memory above what earlier phases left allocated) and on the CPU; their
    difference, barred."""
    render(scene, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    gpu = render(scene, "cuda")
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - resident
    t0 = time.perf_counter()
    cpu = render(scene, "cpu")
    cpu_s = time.perf_counter() - t0
    d = np.abs(gpu - cpu)
    st = {"path": label, "shape": list(gpu.shape), "seconds": secs,
          "cpu_seconds": cpu_s, "peak_memory_bytes": peak,
          "max_abs_err": float(d.max()),
          "share_within_1e-5": float((d.max(axis=-1) <= 1e-5).mean()),
          "image_mean": float(gpu.mean())}
    print(json.dumps(st))
    if not np.isfinite(gpu).all() or gpu.mean() <= 0.01:
        raise AssertionError(f"{label}: image not finite or dark")
    if st["share_within_1e-5"] < RAY_WITHIN_SHARE_MIN:
        raise AssertionError(f"{label}: card vs CPU past the bar: {st}")
    return st


def _cornell_point_light():
    """cornell_box.scn with a point light just under the area light (the
    repository has no point-light scene)."""
    from nrenderer_torch import Light, LightType, PointLight, load_scn
    scene = load_scn(SCENE)
    scene.point_light_buffer.append(PointLight(
        position=(0.0, 250.0, 1028.0), intensity=(1.2, 1.1, 1.0)))
    scene.lights.append(Light(name="Point", type=LightType.POINT, entity=0))
    return scene


def phase_raycast_preview(size=512) -> tuple:
    """Phase 24: RayCast (the Cornell box with a point light, 512x512) and
    GeometryPreview (mesh_box.scn + ico_5120.obj, decimated to 1024 faces
    and capped at 256 a side, and whole, 5120 triangles through the
    chunked SoA intersect), each on the card against the CPU."""
    print("== phase 24: RayCast and GeometryPreview, card vs CPU")
    from nrenderer_torch import load_obj, load_scn
    from nrenderer_torch.renderers.preview import GeometryPreviewRenderer
    from nrenderer_torch.renderers.raycast import RayCastRenderer
    rc = _cornell_point_light()
    rc.render_option.width = rc.render_option.height = size
    runs = [_device_pair(
        "RayCast (cornell_box + point light)",
        lambda s, dev: RayCastRenderer(device=dev).render(s).pixels[..., :3],
        rc)]
    mesh = load_scn(MESH_SCENE)
    load_obj(ICO, mesh, material=0)
    mesh.render_option.width = mesh.render_option.height = size
    preview = lambda s, dev: GeometryPreviewRenderer(device=dev).render(
        s).pixels[..., :3]
    for faces in ("1024", "100000"):
        os.environ["NR_PREVIEW_MAX_FACES"] = faces
        try:
            runs.append(_device_pair(
                f"GeometryPreview (ico_5120, NR_PREVIEW_MAX_FACES={faces})",
                preview, mesh))
        finally:
            del os.environ["NR_PREVIEW_MAX_FACES"]
    return tuple(runs)


def phase_editor(width=128, height=128, spp=64, depth=20) -> dict:
    """Phase 25: an editor round on the card: one document edit posted to
    the editor's /scene route (the left wall's diffuse colour and the
    camera position), a snapshot, a GeometryPreview, and SimplePathTracer
    on the snapshots before and after; the left wall must change
    colour."""
    print(f"== phase 25: editor round, {width}x{height}, {spp} spp, "
          f"depth {depth}")
    from nrenderer_torch import load_scn
    from nrenderer_torch.ops import pt_cuda
    from nrenderer_torch.renderers.preview import GeometryPreviewRenderer
    from nrenderer_torch.renderers.simple_pt import SimplePathTracerRenderer
    from nrenderer_torch.server.editor import SceneEditor, scene_doc
    scene = load_scn(SCENE)
    ro = scene.render_option
    ro.width, ro.height, ro.samples_per_pixel, ro.depth = (width, height,
                                                           spp, depth)
    editor = SceneEditor(scene)
    before, _ = editor.snapshot()
    doc = scene_doc(scene)
    red = next(i for i, m in enumerate(doc["materials"])
               if m["name"] == "Red")
    doc["materials"][red]["properties"]["diffuseColor"] = [0.1, 0.2, 0.8]
    doc["camera"]["position"] = [0.0, 0.0, 30.0]
    code, _, body = editor.routes["/scene"]("POST", json.dumps(doc).encode())
    changed = json.loads(body).get("changed") if code == 200 else body
    after, version = editor.snapshot()
    t0 = time.perf_counter()
    pv = GeometryPreviewRenderer(device="cuda").render(after)
    preview_s = time.perf_counter() - t0
    imgs = []
    pt_cuda.reset_launch_counts()
    t0 = time.perf_counter()
    for snap in (before, after):
        imgs.append(SimplePathTracerRenderer(device="cuda").render(
            snap).pixels[..., :3])
    render_s = time.perf_counter() - t0
    launches = pt_cuda.KERNEL_LAUNCHES["pt_diffuse_kernel"]
    wall = lambda px: px[int(0.3 * height):int(0.7 * height),
                         int(0.05 * width):int(0.15 * width)].mean((0, 1))
    w0, w1 = wall(imgs[0]), wall(imgs[1])
    st = {"path": "editor round", "changed": changed, "version": version,
          "preview_shape": [pv.height, pv.width],
          "preview_seconds": preview_s, "render_seconds": render_s,
          "launches": launches, "left_wall_before": w0.tolist(),
          "left_wall_after": w1.tolist()}
    print(json.dumps(st))
    if version != 1 or sorted(changed) != [
            "camera.position", f"materials[{red}].properties.diffuseColor"]:
        raise AssertionError(f"editor applied {changed} (version "
                             f"{version})")
    if launches <= 0 or not np.isfinite(pv.pixels).all():
        raise AssertionError("editor round launched no pt_diffuse_kernel "
                             "or previewed non-finite pixels")
    if not (w0[0] > w0[2] and w1[2] > w1[0]):
        raise AssertionError(f"left wall did not turn from red to blue: "
                             f"{w0} -> {w1}")
    return st


def phase_bands(width=61, height=37, spp=6, depth=4) -> dict:
    """Phase 26: every kernel form over pixel ranges (a band of rows and a
    ragged range): each range's film the full film's rows bit for bit
    (the hash and the camera keep the global pixel id)."""
    print(f"== phase 26: pixel ranges of every form, {width}x{height}, "
          f"{spp} spp, depth {depth}")
    from nrenderer_torch.ops.bvh import build_mesh_accel
    from nrenderer_torch.ops.mesh_cuda import make_mesh_tables
    from nrenderer_torch.ops.pt_core import make_mat_channels, scene_epsilon
    from nrenderer_torch.ops.pt_cuda import (
        KERNEL_LAUNCHES, kernel_name, make_env_tables, make_tex_tables,
        pt_accumulate)
    n_pix = width * height
    out = {}
    for scene, objs, bsdf, env, mesh, tex in (
            (SCENE, (), False, False, False, False),
            (GLASS_SCENE, (), True, False, False, False),
            (ENV_SCENE, (), False, True, False, False),
            (ENV_SCENE, (), True, True, False, False),
            (MESH_SCENE, (BLOB,), True, False, True, False),
            (TEX_SCENE, (TEX_QUAD,), False, False, False, True),
            (TEX_SCENE, (TEX_QUAD,), True, False, False, True),
            (TEX_SCENE, (TEX_QUAD,), False, True, False, True),
            (TEX_SCENE, (TEX_QUAD,), True, True, False, True),
            (TEX_SCENE, (TEX_GRID,), True, False, True, True)):
        name = kernel_name(bsdf, env, mesh, tex)
        ss, cam, env_map, arrays = _setup("cuda", scene, env, objs)
        kw = dict(bsdf=bsdf,
                  env=make_env_tables(env_map, "cuda") if env else None,
                  mesh=(make_mesh_tables(build_mesh_accel(
                      arrays, make_mat_channels(ss)).bt, "cuda")
                      if mesh else None),
                  tex=make_tex_tables(arrays.textures, "cuda") if tex
                  else None)
        t_min = scene_epsilon(ss)
        full = pt_accumulate(
            torch.zeros((n_pix, 3), device="cuda"), ss, cam, width, height,
            2, spp, depth, 5, t_min, **kw)
        before = KERNEL_LAUNCHES[name]
        for pix0, n in ((10 * width, 7 * width), (5, 1000),
                        (n_pix - 1, 1)):
            band = pt_accumulate(
                torch.zeros((n, 3), device="cuda"), ss, cam, width, height,
                2, spp, depth, 5, t_min, pix0=pix0, n_pix=n, **kw)
            if not torch.equal(band, full[pix0:pix0 + n]):
                err = float((band - full[pix0:pix0 + n]).abs().max())
                raise AssertionError(f"phase 26: {name} pixels [{pix0}, "
                                     f"{pix0 + n}) differ from the full "
                                     f"film's rows (max |d| {err})")
        if KERNEL_LAUNCHES[name] - before < 3:
            raise AssertionError(f"phase 26: {name} launched no kernel")
        out[name] = float(full.abs().sum())
    print(json.dumps({"bands_bit_for_bit": sorted(out)}))
    return out


# Sample sharding's bar: two ranks sum their halves of the samples and the
# halves are added, where one device sums them in one run; each order
# rounds a float32 sum of spp positive terms, within spp x 2^-24 of it.
def shard_rtol(spp: int) -> float:
    return spp * 2.0 ** -24


def _scene_of(path, width, height, spp, depth, objs=()):
    from nrenderer_torch import load_obj, load_scn
    scene = load_scn(path)
    for obj in objs:
        load_obj(obj, scene, material=0 if scene.materials else None)
    ro = scene.render_option
    ro.width, ro.height, ro.samples_per_pixel, ro.depth = (width, height,
                                                           spp, depth)
    return scene


def _sharded(label, fn, *args, kernels=(), **kw):
    """One sharded render with its ranks' launches of `kernels` checked
    (each rank zeroes its counts before it renders and they are summed
    over the ranks)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    wall = time.perf_counter() - t0
    for name in kernels:
        if out.launches.get(name, 0) <= 0:
            raise AssertionError(f"{label} launched no {name}")
    if out.image is not None and not np.isfinite(out.image).all():
        raise AssertionError(f"{label}: image not finite")
    st = {"path": label, "backend": out.backend, "route": out.route,
          "wall_seconds": wall, "seconds": out.seconds,
          "launches": {k: v for k, v in out.launches.items() if v}}
    print(json.dumps(st))
    return out, st


def _held_to(label, got, want, exact, rtol=0.0):
    """`got` against `want` (films or images): bit for bit, or within
    rtol of |want| (plus 1e-6)."""
    err = float(np.abs(got - want).max())
    ok = (np.array_equal(got, want) if exact else
          bool(np.all(np.abs(got - want) <= rtol * np.abs(want) + 1e-6)))
    print(f"{label}: max |d| {err:.3g} "
          f"({'bit for bit' if exact else f'rtol {rtol:.3g}'})")
    if not ok:
        raise AssertionError(f"{label}: differs from its one-device render "
                             f"(max |d| {err})")
    return err


def _gpus() -> list:
    """Every GPU of the machine, one rank each (an NCCL world)."""
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def phase_sharded_dense(phase, scene_path, renderer, kernel,
                        main_render_s=None, multi_only=False, width=512,
                        height=512, spp=2048, depth=20) -> dict:
    """Phases 27 and 28: a dense route through `parallel.mesh` on an NCCL
    world of one ([cuda:0], by samples and by pixels; its film and image
    bit for bit with the one-device ones), on two gloo ranks sharing
    cuda:0 (samples: within shard_rtol(spp); pixels: bit for bit) and,
    where there are N >= 2 GPUs, on N NCCL ranks the same two ways.
    `multi_only`: the N-GPU runs alone."""
    print(f"== phase {phase}: {renderer} sharded, {width}x{height}, {spp} "
          f"spp, depth {depth}")
    from nrenderer_torch.ops.pt_cuda import gamma_image, render_pt_linear
    from nrenderer_torch.parallel.mesh import render_sharded
    scene = _scene_of(scene_path, width, height, spp, depth)
    ss, cam, _, _ = _setup("cuda", scene_path)

    def one_device():
        return render_pt_linear(ss, cam, width, height, spp, depth, seed=0,
                                bsdf=renderer == "AccPathTracer",
                                device="cuda")

    one_device()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = one_device()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    # the renderer's image: gamma on the card, row 0 = top, clipped
    one_img = np.clip(gamma_image(one, spp, width, height).cpu().numpy()
                      [::-1], 0.0, 1.0)
    one = one.cpu().numpy()
    gpus = _gpus()
    worlds = [] if multi_only else [
        ("nccl_1", ["cuda:0"], "samples"),
        ("nccl_1_pixels", ["cuda:0"], "pixels"),
        ("gloo_2_samples", ["cuda:0"] * 2, "samples"),
        ("gloo_2_pixels", ["cuda:0"] * 2, "pixels")]
    if len(gpus) >= 2:
        worlds += [(f"nccl_{len(gpus)}_{shard}", gpus, shard)
                   for shard in ("samples", "pixels")]
    runs = {}
    for key, devices, shard in worlds:
        out, st = _sharded(f"phase {phase}: {renderer} {key}",
                           render_sharded, scene, devices, renderer, shard,
                           kernels=(kernel,))
        want = "gloo" if key.startswith("gloo") else "nccl"
        if out.backend != want:
            raise AssertionError(f"phase {phase}: {key} on {out.backend}")
        # a sample split sums in another order; bands and a world of one
        # are the one-device render
        exact = shard == "pixels" or len(devices) == 1
        st["max_abs_err"] = _held_to(f"phase {phase}: {key} film", out.film,
                                     one, exact, shard_rtol(spp))
        if exact:
            _held_to(f"phase {phase}: {key} image", out.image, one_img, True)
        runs[key] = st
    times = ", ".join(
        f"{key} {st['seconds']['render']:.4f} s + "
        f"{'all-reduce' if 'pixels' not in key else 'gather'} "
        f"{st['seconds']['collective'] * 1e3:.3f} ms"
        for key, st in runs.items())
    main = ("" if main_render_s is None
            else f" (phase {phase - 22}'s CLI render {main_render_s:.4f} s)")
    print(f"phase {phase}: rank 0's render and collective: {times}; one "
          f"device {one_s:.4f} s{main}, on {gpu_name_power()}")
    return runs


def phase_sharded_mesh(width=256, height=256) -> dict:
    """Phase 29: the mesh routes on two gloo ranks sharing cuda:0, each
    against its one-device render: the megamesh route on blob_960.obj
    (256 spp, passes of 32) by samples, the hybrid route on ico_5120.obj
    (64 spp, depth 20, staged) by samples and by pixels, and MLT on
    blob_960.obj at 128x128 (1024 chains x 64 mutations, depth 8)."""
    print(f"== phase 29: mesh routes on two ranks, {width}x{height}")
    from nrenderer_torch.parallel.mesh import (
        _launch_counts, render_sharded, reset_launch_counts)
    from nrenderer_torch.renderers.acc_pt import AccPathTracerRenderer
    runs = {}
    # the megamesh route's bands are phase 26's pt_bsdf_mesh_kernel ranges
    for route, obj, spp, kernels, shards in (
            ("megamesh", BLOB, 256, ["pt_bsdf_mesh_kernel"], ("samples",)),
            ("hybrid", ICO, 64, HYBRID_KERNELS, ("samples", "pixels"))):
        scene = _scene_of(MESH_SCENE, width, height, spp, 20, objs=(obj,))
        # the hybrid half keeps its route under the old limit, here and on
        # the ranks, which render the plan of this process
        pin = _hybrid_pinned() if route == "hybrid" \
            else contextlib.nullcontext()
        with pin:
            reset_launch_counts()
            one = AccPathTracerRenderer(device="cuda").render(scene)
            one = one.pixels[..., :3]
            one_launches = _launch_counts()
            runs_of = [(shard, *_sharded(
                f"phase 29: {route} {shard}", render_sharded, scene,
                ["cuda:0"] * 2, "AccPathTracer", shard, kernels=kernels))
                for shard in shards]
        for shard, out, st in runs_of:
            if out.route != route:
                raise AssertionError(f"phase 29: took {out.route}, not "
                                     f"{route}")
            # each rank runs the one-device route's launches on its share
            more = {k: (n, one_launches[k]) for k, n in out.launches.items()
                    if n > 2 * one_launches[k]}
            if more:
                raise AssertionError(f"phase 29: {route} {shard} launched "
                                     f"more than twice one device: {more}")
            st["max_abs_err"] = _held_to(
                f"phase 29: {route} {shard} image", out.image, one,
                shard == "pixels", shard_rtol(spp))
            runs[f"{route}_{shard}"] = st
    runs.update(phase_sharded_mlt())
    return runs


# a chain split draws what one device draws for the same chains; the
# splats' index_add_ sums in no fixed order on the card, and b is summed
# over the ranks, so the images differ by rounding alone (max |d| 7.8e-7
# read on an H100)
MLT_SHARD_RTOL = 1e-4
MLT_SHARD_ATOL = 1e-5


def phase_sharded_mlt(multi_only=False) -> dict:
    """Phase 29's MLT: blob_960.obj at 128x128 (1024 chains x 64
    mutations, depth 8) split by chains on two gloo ranks sharing cuda:0
    and, where there are N >= 2 GPUs, on N NCCL ranks; each image within
    MLT_SHARD_RTOL/ATOL of the one-device image.  `multi_only`: the N-GPU
    run alone."""
    from nrenderer_torch.parallel.mlt import render_mlt_sharded
    from nrenderer_torch.renderers.mlt import render_mlt
    kw = dict(chains=1024, mutations=64, seed=0)
    scene = _scene_of(MESH_SCENE, 128, 128, 1, 8, objs=(BLOB,))
    t0 = time.perf_counter()
    one = render_mlt(scene, device="cuda", **kw)[..., :3]
    one_s = time.perf_counter() - t0
    gpus = _gpus()
    worlds = [] if multi_only else [("mlt", ["cuda:0"] * 2)]
    if len(gpus) >= 2:
        worlds.append((f"mlt_nccl_{len(gpus)}", gpus))
    runs = {}
    for key, devices in worlds:
        out, st = _sharded(f"phase 29: MLT blob_960 {key}",
                           render_mlt_sharded, scene, devices,
                           kernels=["mesh_sweep_kernel"], **kw)
        got = out.image[..., :3]
        st.update(max_abs_err=float(np.abs(got - one).max()),
                  one_device_seconds=one_s)
        print(json.dumps(st))
        if not np.allclose(got, one, rtol=MLT_SHARD_RTOL,
                           atol=MLT_SHARD_ATOL):
            raise AssertionError(f"phase 29: sharded MLT {key} differs from "
                                 f"one device: {st}")
        runs[key] = st
    return runs


def phase_sharded_resume(width=256, height=256, spp=64, depth=20) -> dict:
    """Phase 30: a sharded checkpointed render (AccPathTracer on
    pt_glass_box.scn, two ranks on cuda:0 by samples: 4 passes of 16 spp)
    stopped after two passes and run again ends bit for bit on the
    straight run."""
    print(f"== phase 30: sharded kill and resume, {width}x{height}, {spp} "
          f"spp, depth {depth}")
    from nrenderer_torch.parallel.mesh import render_multichip_resumable
    scene = _scene_of(GLASS_SCENE, width, height, spp, depth)
    ckpt = os.path.join(ROOT, "build", "smoke_sharded_resume.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    kw = dict(renderer="AccPathTracer", shard="samples", seed=7)
    devices = ["cuda:0"] * 2
    straight, _ = _sharded("phase 30: straight", render_multichip_resumable,
                           scene, devices, kernels=["pt_bsdf_kernel"], **kw)
    part, _ = _sharded("phase 30: stopped", render_multichip_resumable,
                       scene, devices, checkpoint_path=ckpt, pass_limit=2,
                       **kw)
    previews = []
    resumed, _ = _sharded("phase 30: resumed", render_multichip_resumable,
                          scene, devices, checkpoint_path=ckpt,
                          on_preview=lambda n, img: previews.append(n),
                          kernels=["pt_bsdf_kernel"], **kw)
    st = {"stopped_at": part.spp_done, "previews_after": previews,
          "max_abs_err": float(np.abs(resumed.film - straight.film).max())}
    print(json.dumps(st))
    if part.image is not None or part.spp_done != spp // 2 \
            or previews != [3 * spp // 4, spp] \
            or not np.array_equal(resumed.film, straight.film) \
            or not np.array_equal(resumed.image, straight.image):
        raise AssertionError(f"phase 30: resumed render differs: {st}")
    return st


def phase_sharded_cli(width=512, height=512, spp=2048, depth=20) -> dict:
    """Phase 31: `render --devices N` through `cli.main`: with one GPU,
    `--devices 2` exits 2 with its message; with N >= 2 GPUs it renders
    on N NCCL ranks and writes the one-device PNG (pixel bands)."""
    print("== phase 31: cli --devices")
    import io
    from nrenderer_torch import cli
    from nrenderer_torch.io.image import load_image
    n = torch.cuda.device_count()
    out = os.path.join(ROOT, "build", "smoke_devices.png")
    argv = _cli_argv(SCENE, "SimplePathTracer", width, height, spp, depth,
                     out)
    if os.path.exists(out):
        os.remove(out)
    if n < 2:
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli.main(argv + ["--devices", "2"])
        st = {"devices": n, "rc": rc, "stderr": err.getvalue().strip()}
        print(json.dumps(st))
        if rc != 2 or "2 cuda devices requested, 1 available" not in \
                st["stderr"] or os.path.exists(out):
            raise AssertionError(f"phase 31: --devices 2 on one GPU: {st}")
        return st
    one = out.replace(".png", "_one.png")
    if cli.main(argv[:-1] + [one]) != 0 or cli.main(
            argv + ["--devices", str(n), "--shard", "pixels"]) != 0:
        raise AssertionError(f"phase 31: --devices {n} failed")
    st = {"devices": n, "equal": bool(np.array_equal(load_image(one),
                                                     load_image(out)))}
    print(json.dumps(st))
    if not st["equal"]:
        raise AssertionError(f"phase 31: --devices {n} PNG differs")
    return st


def main_multi_gpu() -> int:
    """`--multi-gpu`: the runs that need N >= 2 GPUs, one NCCL rank each,
    with their one-device references (phases 27-29 and 31)."""
    t_start = time.perf_counter()
    gpu = phase_toolchain()
    n = torch.cuda.device_count()
    if n < 2:
        raise RuntimeError(f"--multi-gpu needs at least 2 GPUs, {n} here")
    phase_build()
    runs = {
        "spt": phase_sharded_dense(27, SCENE, "SimplePathTracer",
                                   "pt_diffuse_kernel", multi_only=True),
        "acc": phase_sharded_dense(28, GLASS_SCENE, "AccPathTracer",
                                   "pt_bsdf_kernel", multi_only=True),
        **phase_sharded_mlt(multi_only=True)}
    phase_sharded_cli()
    print(f"{n} GPUs, every run passed: {', '.join(runs)}")
    print(f"whole script: {time.perf_counter() - t_start:.1f} s")
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": n}}))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv == ["--multi-gpu"]:
        return main_multi_gpu()
    if argv:
        raise SystemExit(f"usage: chip_smoke.py [--multi-gpu] (got {argv})")
    t_start = time.perf_counter()
    gpu = phase_toolchain()
    phase_build()
    phase_hash()
    from nrenderer_torch.ops import pt_cuda
    # kernel name -> the stats of its record shape (the path's launch, or
    # the path's 4-spp shape for the mesh forms), with the largest max |d|
    # of all its shapes
    parity = {}
    # the dense pool: 64x64/16/4, the path's own size at 4 spp, a ragged
    # split with a thin lens at depths 0, 1 and 6, then one launch of the
    # path's own size (the path's spp if it takes fewer)
    for phase, scene, objs, bsdf, env, tex, size, spp, depth in (
            (4, SCENE, (), False, False, False, 512, 2048, 20),
            (4, GLASS_SCENE, (), True, False, False, 512, 2048, 20),
            (4, ENV_SCENE, (), False, True, False, 512, 1024, 8),
            (4, ENV_SCENE, (), True, True, False, 512, 1024, 8),
            (8, TEX_SCENE, (TEX_QUAD,), False, False, True, 256, 512, 6),
            (8, TEX_SCENE, (TEX_QUAD,), True, False, True, 256, 512, 6),
            (8, TEX_SCENE, (TEX_QUAD,), False, True, True, 256, 512, 6),
            (8, TEX_SCENE, (TEX_QUAD,), True, True, True, 256, 512, 6)):
        kw = dict(scene=scene, objs=objs, bsdf=bsdf, env=env, tex=tex,
                  phase=phase)
        runs = [phase_parity(64, 64, 16, 4, **kw),
                phase_parity(size, size, 4, depth, **kw)]
        runs += [phase_parity(61, 37, 33, d, seed=5, split=(20, 13),
                              lens=True, **kw) for d in (0, 1, 6)]
        launch_spp = min(spp, pt_cuda.launch_plan(False, size * size)[1])
        st = phase_parity(size, size, launch_spp, depth, **kw)
        st["max_abs_err"] = max(r["max_abs_err"] for r in runs + [st])
        parity[st["kernel"]] = st
    for scene, obj, tex, size, depth in ((MESH_SCENE, BLOB, False, 500, 20),
                                         (TEX_SCENE, TEX_GRID, True, 256,
                                          6)):
        kw = dict(scene=scene, objs=(obj,), bsdf=True, mesh=True, tex=tex,
                  phase=8)
        runs = [phase_parity(64, 64, 16, 4, **kw)]
        st = phase_parity(size, size, 4, depth, **kw)
        st["max_abs_err"] = max(r["max_abs_err"] for r in runs + [st])
        parity[st["kernel"]] = st
    # B1e at the mesh cell's launch: ico_5120.obj, 500x500, 32 spp, depth 20
    b1e_cell = phase_b1e_launch(ICO, 8, B1E_BAND_ROWS)
    parity["pt_bsdf_mesh_kernel"]["max_abs_err"] = max(
        parity["pt_bsdf_mesh_kernel"]["max_abs_err"],
        b1e_cell["max_abs_err"])
    phase_bands()
    sweep = phase_sweep()
    mxu = phase_mxu_sweep()
    compactor = phase_compactor()
    phase_hybrid_parity()
    pipe, prefix = phase_pipe_main_shape()
    from nrenderer_torch.server.registry import get_server
    main_path = phase_main_path()
    main_px = get_server().screen.get_pixels()[:, :, :3].copy()
    paths = [main_path, phase_acc_path(), *phase_env_paths(),
             phase_mesh_path(), *phase_tex_paths(), phase_hybrid_path()]
    b2_pixels = get_server().screen.get_pixels()[:, :, :3].copy()
    ico_81920 = large_fixtures()[1]
    paths.append(phase_hybrid_path(ico_81920))   # phase 14's second row
    paths.append(phase_env_mesh_path())
    mxu_path = phase_hybrid_mxu_path(b2_pixels, prefix)
    paths += [mxu_path, phase_mlt_cornell()]
    mlt_runs = phase_mlt_mesh()
    paths += mlt_runs
    progressive = phase_progressive(main_px)
    paths += [*progressive, phase_camera_flags()]
    resume = phase_resume()
    ray_runs = phase_raycast_preview()
    editor = phase_editor()
    breakdown = phase_breakdown()
    sharded = {
        "spt": phase_sharded_dense(27, SCENE, "SimplePathTracer",
                                   "pt_diffuse_kernel",
                                   main_path["render_seconds"]),
        "acc": phase_sharded_dense(28, GLASS_SCENE, "AccPathTracer",
                                   "pt_bsdf_kernel",
                                   paths[1]["render_seconds"]),
        **phase_sharded_mesh()}
    sharded_resume = phase_sharded_resume()
    phase_sharded_cli()
    large = phase_large_mesh(b2_pixels, ico_81920)
    paths.append(large)
    wave = phase_wavefront_bounce(ico_81920)
    launches = {}
    for run in paths:
        for name, n in run["launches"].items():
            if n:
                launches[name] = launches.get(name, 0) + n
    # the sharded phases' launches, summed over their ranks
    sharded_runs = [*sharded.pop("spt").values(),
                    *sharded.pop("acc").values(), *sharded.values()]
    sharded_launches = {}
    for run in sharded_runs:
        for name, n in run["launches"].items():
            sharded_launches[name] = sharded_launches.get(name, 0) + n
    from nrenderer_torch.ops import mesh_cuda, mesh_mxu, stream_compact
    for run in paths:
        print(f"{run['path']}: {run['seconds']:.3f} s "
              f"(render {run['render_seconds']:.3f} s), "
              f"{run['spp_per_s']:.1f} spp/s, "
              f"{run['mbounce_rays_per_s']:.1f} Mbounce-rays/s, peak "
              f"{run['peak_memory_bytes'] / 2**30:.2f} GiB on {gpu}")
    print(f"hybrid chunk: {breakdown['chunk_seconds']:.3f} s on {gpu}")
    print(f"large mesh (phase 32): {large['route']} route at "
          f"{large['blocks']} blocks, render {large['render_seconds']:.4f} s"
          f"; the phase {large['phase_seconds']:.1f} s on {gpu}")
    for run in progressive:
        t = {k.split(".")[1]: v for k, v in run["timers"].items()}
        print(f"{run['path']}: passes "
              f"{t['first-pass'] + t['render-pass']:.3f} s, host-preview "
              f"{t['host-preview']:.3f} s of {run['seconds']:.3f} s on "
              f"{gpu}")
    held = progressive[0]["pass_vs_plain"]
    print(f"progressive pass ({held['shape']}): kernel {held['kernel_ms']:.3f}"
          f" ms, plain {held['plain_ms']:.1f} ms, bound {held['bound_ms']:.4f}"
          f" ms on {gpu}")
    for run in ray_runs:
        print(f"{run['path']}: {run['seconds']:.3f} s, peak "
              f"{run['peak_memory_bytes'] / 2**20:.1f} MiB above the "
              f"resident (CPU "
              f"{run['cpu_seconds']:.3f} s) on {gpu}")
    print(f"sharded resume: stopped at {sharded_resume['stopped_at']} spp, "
          f"resumed bit for bit on {gpu}")
    print(f"resume: {resume['resumed_at']} spp reloaded, "
          f"{resume['launches_after_resume']} passes after it; editor "
          f"round: preview {editor['preview_seconds']:.3f} s, renders "
          f"{editor['render_seconds']:.3f} s on {gpu}")
    # each sweep engine at its paths' own shapes: the hybrid chunk's sorted
    # prefix (phases 13 and 18) and MLT's path and shadow batches (phase 20)
    shape = lambda st: {"rays": st["rays"], "ms": st["kernel_ms"],
                        "bound_ms": st["bound_ms"],
                        "schedule": st["schedule"]}
    b2_shapes = {"hybrid_prefix": shape(pipe["sweep"]),
                 "hybrid_prefix_640_blocks": shape(large["pipe"]["sweep"]),
                 **{f"mlt_{st['rays']}": shape(st)
                    for st in mlt_runs[0]["batches_vs_plain"]}}
    b4_shapes = {"hybrid_prefix": shape(mxu_path["prefix_vs_plain"]),
                 **{f"mlt_{st['rays']}": shape(st)
                    for st in mlt_runs[1]["batches_vs_plain"][:2]}}
    for name, shapes in (("B2", b2_shapes), ("B4", b4_shapes)):
        print(f"{name} at its paths' shapes on {gpu}: {json.dumps(shapes)}")
    print(gpu)
    kernels = [{
        "name": name, "route": "cuda", "source": pt_cuda.KERNEL_SOURCE,
        "replaces": pt_cuda.REPLACES[name],
        "launches": launches.get(name, 0),
        "max_abs_err": st["max_abs_err"],
        "ms": st["kernel_ms"], "plain_ms": st["plain_ms"],
        "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
        "library_ms": None, "shape": st["shape"],
        "sharded_launches": sharded_launches.get(name, 0),
        **({f"{row}_mesh": {k: b1e[k] for k in (
            "blocks", "launch_shape", "launch_ms", "loop_slots",
            "band_pixels", "band_loop_slots_cpu", "kernel_ms", "plain_ms",
            "bound_ms", "bound_by", "max_abs_err", "schedule")}
            for row, b1e in (("cell", b1e_cell), ("large", large["b1e"]))}
           if name == "pt_bsdf_mesh_kernel" else {}),
        **({"progressive_pass": {
            k: held[k] for k in ("kernel_ms", "plain_ms", "bound_ms",
                                 "bound_by", "max_abs_err", "shape")}}
           if name == "pt_diffuse_kernel" else {})}
        for name, st in parity.items()]
    # the standalone sweep runs on the hybrid paths; its device function
    # also runs inline in the mesh forms' launches
    kernels.append({
        "name": mesh_cuda.KERNEL_NAME, "route": "cuda",
        "source": mesh_cuda.KERNEL_SOURCE, "replaces": mesh_cuda.REPLACES,
        "launches": launches.get(mesh_cuda.KERNEL_NAME, 0),
        "max_abs_err": sweep["max_abs_err"], "ms": sweep["kernel_ms"],
        "plain_ms": sweep["plain_ms"], "bound_ms": sweep["bound_ms"],
        "bound_by": sweep["bound_by"], "library_ms": None,
        "path_shapes": b2_shapes,
        "sharded_launches": sharded_launches.get(mesh_cuda.KERNEL_NAME, 0),
        "inlined_in": ["pt_bsdf_mesh_kernel", "pt_bsdf_mesh_tex_kernel"],
        "inlined_launches": launches.get("pt_bsdf_mesh_kernel", 0)
        + launches.get("pt_bsdf_mesh_tex_kernel", 0)})
    kernels.append({
        "name": mesh_mxu.KERNEL_NAME, "route": "cuda",
        "source": mesh_mxu.KERNEL_SOURCE, "replaces": mesh_mxu.REPLACES,
        "launches": launches.get(mesh_mxu.KERNEL_NAME, 0),
        "max_abs_err": mxu["max_abs_err"], "ms": mxu["kernel_ms"],
        "plain_ms": mxu["plain_ms"], "bound_ms": mxu["bound_ms"],
        "bound_by": mxu["bound_by"], "library_ms": None,
        "schedule": mxu["schedule"], "path_shapes": b4_shapes})
    for name, key, case in ((stream_compact.PACK, "pack", "stage"),
                            (stream_compact.UNPACK, "unpack", "mesh")):
        st = compactor[case]
        kernels.append({
            "name": name, "route": "cuda",
            "source": stream_compact.KERNEL_SOURCE,
            "replaces": stream_compact.REPLACES[name],
            "launches": launches.get(name, 0),
            "max_abs_err": float(max(
                compactor[f"{key}_err"], pipe[f"{key}_max_word_err"],
                large["pipe"][f"{key}_max_word_err"])),
            "ms": st[f"{key}_ms"], "plain_ms": st[f"{key}_plain_ms"],
            "bound_ms": st[f"{key}_bound_ms"], "bound_by": "bytes",
            "library_ms": st.get(f"{key}_library_ms"),
            "shape": st["case"],
            "sharded_launches": sharded_launches.get(name, 0)})
    # the hybrid bounce's kernels at the large-mesh cell's first shape
    for name, key in zip(pt_cuda.WAVEFRONT_KERNELS, ("dense_hit", "shade")):
        st = wave["rows"][0]
        kernels.append({
            "name": name, "route": "cuda", "source": pt_cuda.KERNEL_SOURCE,
            "replaces": "nrenderer_tpu/renderers/acc_pt.py:53-99, the XLA "
                        "bounce of the stream wavefront",
            "launches": launches.get(name, 0),
            "max_abs_err": wave[f"{key}_max_abs_err"], "ms": st[f"{key}_ms"],
            "plain_ms": st[f"{key}_plain_ms"],
            "bound_ms": st[f"{key}_bound_ms"],
            "bound_by": st[f"{key}_bound_by"], "library_ms": None,
            "shape": st["shape"],
            "shapes": [{k: r[k] for k in ("shape", "lanes", f"{key}_ms",
                                          f"{key}_bound_ms")}
                       for r in wave["rows"]]})
    print(f"whole script: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
