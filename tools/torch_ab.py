#!/usr/bin/env python3
"""A/B of the port's paths on one NVIDIA GPU against another checkout.

    git archive <parent> | tar -x -C build/parent     # a second checkout
    python3 tools/torch_ab.py build/parent              # the analytic paths
    python3 tools/torch_ab.py --launch-spp 64,256 --pt-min-blocks 8,10 \
        build/parent
    python3 tools/torch_ab.py --hybrid build/parent     # the hybrid paths
    python3 tools/torch_ab.py --mesh build/parent       # the mesh sweep
    python3 tools/torch_ab.py --mesh --dense-min 8,16,32 build/parent
    python3 tools/torch_ab.py --mxu build/parent        # the MXU sweep
    python3 tools/torch_ab.py --mxu --ray-batch 2,6 --min-blocks 4,6 \
        build/parent
    python3 tools/torch_ab.py --crossover  # this checkout alone

Runs the two checkouts in turns (parent, change, change, parent), each in a
fresh process that builds its own kernel library.  It times each form of
the path-tracing kernel without a mesh alone at its path's shape (the
paths of `chip_smoke.py` phases 5-7 and 11's dense textured quad: the
Cornell box and `pt_glass_box.scn` at 512x512, 2048 spp, depth 20;
`env_spheres.scn` under `env_sky.png` at 512x512, 1024 spp, depth 8;
`tex_quad.obj` on `tex_grid.scn` at 256x256, 512 spp, depth 6, without
and with the map; each with SimplePathTracer's and AccPathTracer's
estimator): one `pt_accumulate` call of the path's spp, three calls
between CUDA events (ms a call, the wrapper's host work included), and
each launch alone between events recorded around the library call (ms a
launch on the device), with the launches a call makes; the env and
texture forms also at other launch sizes (the constants set in-process),
at the other path's film size and, for the diffuse env form, at the
progressive route's 8-spp pass; the first change run adds the bound
(`chip_smoke.bound_ms`) and the lane slots (`pt_cuda.loop_slots`) of one
launch of the change's size.  Then it renders each of those paths through
its own `cli.main` (a warm-up render and three, seven for the textured
quad, whose render phases it reads from the renderer's timer, and the
CLI walls) and the progressive env route (`--progressive`, 128 passes of
8 spp); and it prints the `-Xptxas -v` lines of every path-tracing
kernel.  The dense forms' tuning constants each get a kernel-only run
per value, in a copy of this checkout (`build/<name>_K/`, ~1 min a run),
after the four: `--launch-spp K,...` sets the launch size of the forms
without a mesh to K spp of a 512x512 film
(`DENSE_PIXEL_SAMPLES_PER_LAUNCH` in `ops/pt_cuda.py`),
`--pt-min-blocks K,...` their launch bound's blocks an SM
(`kDenseMinBlocks` in `csrc/pt_kernel.cu`).  `--set NAME=K,NAME=K` (NAME
a flag's name with `_` for `-`) adds one run with several constants set
at once.

With `--hybrid` it renders instead the two hybrid-route paths of
phases 14-15 (`ico_5120.obj` on `mesh_box.scn`, 500x500, 256 spp, depth
20, with the megamesh limit at 1024 as in phase 14; `blob_960.obj` under
`env_sky.png`, 512x512, 256 spp, depth 8) the same way, then runs phase 16's breakdown of one hybrid chunk, and first
phase 12 (the streaming compactor against its plain versions at 2^24
lanes: kernel, plain, library and bound times of the stage and mesh
cases) with the compactor kernels' `nvcc -Xptxas -v` lines (registers,
shared memory, stack frame, spills).

With `--mesh` it times the blocked mesh sweep and its callers: the
`-Xptxas -v` lines of every path-tracing form and of the sweep kernels;
each path-tracing form alone at its phase 4 / phase 8 size and depth
(512x512, the mesh forms 500x500 and the texture forms 256x256; the
untextured mesh form also on the grid, `tex_grid_plain.obj`) in ms per
launch of the renders' launch size (eight launches a call, five calls
between CUDA events); `mesh_sweep_kernel` (B2) on phase 9's rays at
`ico_5120.obj` at 2^20 rays and at MLT's batch sizes, 2048 and 36,864
rays, in both block orders; phase 10's megamesh render (`blob_960.obj`,
500x500, 256 spp, depth 20, warm-up and three renders); and the
megamesh/hybrid crossover: `blob_960.obj` and `ico_5120.obj` each on
both routes (500x500, 256 spp, depth 20; a warm-up and three renders), the
route forced by setting every megamesh limit the checkout has
(`routes.MEGAMESH_MAX_TRIS` and the card's `MEGAMESH_MAX_TRIS_CUDA`; in a
checkout from before `renderers/routes.py`, `acc_pt`'s) for those
renders.  With
`--dense-min K,...` it then runs the `--mesh` measurements once more in a
copy of this checkout for each K, with the warp sweep's dense-step
threshold (`kDenseMin` in `csrc/mesh_sweep.cuh`) set to K.

With `--mxu` it times the MXU sweep (B4, `mesh_sweep_mxu_kernel`) at its
paths' shapes and the renders around it: the `-Xptxas -v` lines of every
path-tracing form and sweep kernel; B4 on phase 17's 2^20 rays at
`ico_5120.obj`, on phase 18's sorted live prefix of a hybrid chunk
(3,379,039 rays) and on MLT's first path and shadow batches of the mesh
scene (`blob_960.obj`, 1024 chains: 2048 and 36,864 rays, held from a
two-mutation run), five calls between CUDA events (twenty for MLT's);
then, each a warm-up render and three timed ones, the main path, the
megamesh render (`blob_960.obj`, 500x500, 256 spp, depth 20), the hybrid
render (`ico_5120.obj`, 500x500, 256 spp, depth 20) on B2 and the same
under NR_MESH_MXU=1 on B4.  With `--ray-batch K,...` it then times B4
alone (no renders) once more in a copy of this checkout for each K, with
the rays the MXU kernel tests against each triangle it loads
(`kRayBatch` in `csrc/mesh_sweep_mxu.cu`, `RAY_BATCH` in
`ops/mesh_mxu.py`) set to K, and with `--min-blocks K,...` for each K
with its launch bound's blocks an SM (`kMinBlocks`) set to K.

With `--crossover` (no second checkout) it measures the megamesh/hybrid
crossover in this checkout alone, in one process: the host's mesh prep of
`blob_960.obj`, `ico_5120.obj` and the 20,480- and 81,920-face icospheres
(`chip_smoke.large_fixtures`) with the host library and with its numpy
versions (`chip_smoke.mesh_prep_seconds`), then each of the four pools on
both routes (500x500, 256 spp, depth 20; the route forced by the
megamesh limits), a warm-up render and three timed ones each, with peak
device memory; it prints each route's median CLI wall (argv to PNG, what
decides the crossover) and render phase by size.  The megamesh route's
render phase counts its passes after the first (7 of 8 at 256 spp), as the
JAX renderer's does; the wall counts all of them and their previews.

Prints one line per run and a final `AB` JSON line.  Imports nothing of
JAX."""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

COMMON = r'''
import json, os, time, torch, chip_smoke as c
from nrenderer_torch import cli
from nrenderer_torch.renderers import acc_pt
from nrenderer_torch.utils.timing import GLOBAL_TIMER
try:
    from nrenderer_torch.renderers import routes as rules
except ImportError:   # a checkout from before the route layer
    rules = acc_pt
c.phase_build()
out = {}
# the megamesh limits a checkout has (an older one lacks the card's own)
LIMITS = [n for n in ("MEGAMESH_MAX_TRIS", "MEGAMESH_MAX_TRIS_CUDA")
          if hasattr(rules, n)]


def renders(label, scene, renderer, size, spp, depth, env, objs=(),
            limit=None, extra=(), n=3):
    """A warm-up render, then `n` whose render phases and CLI walls are
    kept under `label`.  `limit`: every megamesh limit set to it for the
    renders (1024 keeps ico_5120.obj on the hybrid route, 0 forces the
    hybrid route, 1 << 30 the megamesh route); `extra`: more CLI flags."""
    png = os.path.join(c.ROOT, "build", f"ab_{label}.png")
    os.makedirs(os.path.dirname(png), exist_ok=True)
    argv = c._cli_argv(scene, renderer, size, size, spp, depth, png,
                       env=env, objs=objs) + list(extra)
    saved = [getattr(rules, name) for name in LIMITS]
    for name in LIMITS if limit is not None else ():
        setattr(rules, name, limit)
    try:
        assert cli.main(argv) == 0
        phases, walls = [], []
        for _ in range(n):
            g0 = GLOBAL_TIMER.get(f"{renderer}.render").total_s
            t0 = time.perf_counter()
            assert cli.main(argv) == 0
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            phases.append(GLOBAL_TIMER.get(f"{renderer}.render").total_s
                          - g0)
    finally:
        for name, v in zip(LIMITS, saved):
            setattr(rules, name, v)
    out[label] = {"render_phase_s": phases, "cli_s": walls}
'''

PTXAS = r'''
from nrenderer_torch import _build
lines = _build.LOG_PATH.read_text().splitlines()
out["ptxas"] = {ln.split("'")[1]: " / ".join(
    x.strip() for x in lines[i + 1:i + 5]
    if "stack" in x or "registers" in x)
    for i, ln in enumerate(lines)
    if "Compiling entry function" in ln and any(
        k in ln for k in ("pt_kernel", "pt_dense_kernel", "mesh_sweep"))}
'''

HYBRID = COMMON + r'''
from nrenderer_torch import _build
st = c.phase_compactor()
out["compactor"] = {case: {k: v for k, v in st[case].items()
                           if k.endswith("_ms") or k == "count"}
                    for case in ("stage", "mesh")}
lines = _build.LOG_PATH.read_text().splitlines()
out["ptxas"] = {ln.split("'")[1]: " / ".join(
    x.strip() for x in lines[i + 1:i + 5]
    if "stack" in x or "registers" in x)
    for i, ln in enumerate(lines)
    if "Compiling entry function" in ln and "pack" in ln}
renders("hybrid", c.MESH_SCENE, "AccPathTracer", 500, 256, 20, False,
        (c.ICO,), limit=1024)
renders("env_mesh", c.MESH_SCENE, "AccPathTracer", 512, 256, 8, True,
        (c.BLOB,))
out["chunk"] = c.phase_breakdown()
print("RESULT", json.dumps(out))
'''

MESH = COMMON + PTXAS + r'''
from nrenderer_torch.ops import mesh_cuda, pt_cuda
from nrenderer_torch.ops.bvh import build_mesh_accel
from nrenderer_torch.ops.pt_core import make_mat_channels, scene_epsilon
from nrenderer_torch.ops.soa import V3
from nrenderer_torch.renderers import acc_pt
forms = (("diffuse", c.SCENE, (), False, False, 512, 20),
         ("bsdf", c.GLASS_SCENE, (), True, False, 512, 20),
         ("diffuse_env", c.ENV_SCENE, (), False, True, 512, 8),
         ("bsdf_env", c.ENV_SCENE, (), True, True, 512, 8),
         ("bsdf_mesh", c.MESH_SCENE, (c.BLOB,), True, False, 500, 20),
         ("diffuse_tex", c.TEX_SCENE, (c.TEX_QUAD,), False, False, 256, 6),
         ("bsdf_tex", c.TEX_SCENE, (c.TEX_QUAD,), True, False, 256, 6),
         ("diffuse_env_tex", c.TEX_SCENE, (c.TEX_QUAD,), False, True, 256, 6),
         ("bsdf_env_tex", c.TEX_SCENE, (c.TEX_QUAD,), True, True, 256, 6),
         ("bsdf_mesh_tex", c.TEX_SCENE, (c.TEX_GRID,), True, False, 256, 6),
         ("bsdf_mesh_grid", c.TEX_SCENE, (c.TEX_GRID_PLAIN,), True, False,
          256, 6))
out["kernel_ms"] = {}
for label, scene, objs, bsdf, env, size, depth in forms:
    ss, cam, emap, arrays = c._setup("cuda", scene, env, objs)
    mesh = "mesh" in label
    mt = (mesh_cuda.make_mesh_tables(build_mesh_accel(
        arrays, make_mat_channels(ss)).bt, "cuda") if mesh else None)
    kw = dict(bsdf=bsdf, mesh=mt,
              env=pt_cuda.make_env_tables(emap, "cuda") if env else None,
              tex=(pt_cuda.make_tex_tables(arrays.textures, "cuda")
                   if "tex" in label else None))
    film = torch.zeros((size * size, 3), device="cuda")
    # the checkout's launch size (an older one lacks `launch_plan`, and
    # one older still the dense forms' own size)
    per_pix = (getattr(pt_cuda, "DENSE_PIXEL_SAMPLES_PER_LAUNCH",
                       pt_cuda.PIXEL_SAMPLES_PER_LAUNCH)
               if label in ("diffuse", "bsdf")
               else pt_cuda.PIXEL_SAMPLES_PER_LAUNCH)
    per_launch = (pt_cuda.launch_plan(mesh, size * size)[1]
                  if hasattr(pt_cuda, "launch_plan")
                  else max(1, per_pix // (size * size)))
    call = lambda: pt_cuda.pt_accumulate(film, ss, cam, size, size, 0,
                                         8 * per_launch, depth, 0,
                                         scene_epsilon(ss), **kw)
    call()
    torch.cuda.synchronize()
    out["kernel_ms"][label] = c._time_ms(call, 5) / 8
# B2 on phase 9's rays at ico_5120.obj (its law, inline: the parent's
# chip_smoke.py has no helper for it)
ss, _, _, arrays = c._setup("cuda", c.MESH_SCENE, objs=(c.ICO,))
mt = mesh_cuda.make_mesh_tables(build_mesh_accel(
    arrays, make_mat_channels(ss)).bt, "cuda")
t_min = scene_epsilon(ss)
out["b2_ms"] = {}
for n in (1 << 20, 36864, 2048):
    g = torch.Generator(device="cuda").manual_seed(0)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, generator=g,
                                                   device="cuda")
    o = V3(u(-270.0, 270.0), u(-270.0, 270.0), u(760.0, 1300.0))
    tgt = V3(u(-150.0, 150.0), u(-278.0, -7.0), u(850.0, 1150.0))
    dv = torch.stack([tgt.x - o.x, tgt.y - o.y, tgt.z - o.z])
    dv = dv / torch.linalg.vector_norm(dv, dim=0)
    d = V3(dv[0].contiguous(), dv[1].contiguous(), dv[2].contiguous())
    cap = torch.where(torch.rand(n, generator=g, device="cuda") < 0.1,
                      0.0, float("inf"))
    for f2b in (False, True):
        sweep = lambda: mesh_cuda.sweep_mesh_full(mt, o, d, t_min,
                                                  t_cap=cap, f2b=f2b)
        sweep()
        torch.cuda.synchronize()
        out["b2_ms"][f"{n}_{'f2b' if f2b else 'natural'}"] = c._time_ms(
            sweep, 20 if n < 1 << 20 else 5)
renders("megamesh", c.MESH_SCENE, "AccPathTracer", 500, 256, 20, False,
        (c.BLOB,))
# the megamesh/hybrid crossover: each pool on both routes
for obj in (c.BLOB, c.ICO):
    for route, limit in (("megamesh", 1 << 30), ("hybrid", 0)):
        renders(f"cross_{os.path.basename(obj)}_{route}", c.MESH_SCENE,
                "AccPathTracer", 500, 256, 20, False, (obj,), limit=limit)
print("RESULT", json.dumps(out))
'''

CROSSOVER = COMMON + r'''
from nrenderer_torch.renderers.routes import plan_route
objs = [c.BLOB, c.ICO, *c.large_fixtures()]
# the host's mesh prep with the host library and with the numpy versions
out["mesh_prep_s"] = {os.path.basename(o): c.mesh_prep_seconds(o)
                      for o in objs}
for obj in objs:
    name = os.path.splitext(os.path.basename(obj))[0]
    for route, limit in (("megamesh", 1 << 30), ("hybrid", 0)):
        with rules.pinned_megamesh_max_tris(limit):
            scene = c._scene_of(c.MESH_SCENE, 500, 500, 256, 20, (obj,))
            assert plan_route(scene, "AccPathTracer", False,
                              "cuda").kind == route
        torch.cuda.reset_peak_memory_stats()
        renders(f"{name}_{route}", c.MESH_SCENE, "AccPathTracer", 500, 256,
                20, False, (obj,), limit=limit)
        out[f"{name}_{route}"]["peak_bytes"] = \
            torch.cuda.max_memory_allocated()
out["gpu"] = c.gpu_name_power()
print("RESULT", json.dumps(out))
'''

MXU_TIMES = COMMON + PTXAS + r'''
from nrenderer_torch.ops import mesh_mxu
from nrenderer_torch.ops.soa import V3


def b4_ms(mt, rays, t_min, reps):
    o, d, cap = V3(*rays[0:3]), V3(*rays[3:6]), rays[6]
    call = lambda: mesh_mxu.sweep_mxu(mt, o, d, t_min, cap)
    call()
    torch.cuda.synchronize()
    return c._time_ms(call, reps)


out["b4_ms"] = {}
bt, mt, t_min, rays = c._ico_rays(1 << 20, 0)
out["b4_ms"]["phase17_1048576"] = b4_ms(mt, rays, t_min, 5)
del rays
_, (mtp, t_p, rays_p) = c.phase_pipe_main_shape()
out["b4_ms"][f"prefix_{rays_p.shape[1]}"] = b4_ms(mtp, rays_p, t_p, 5)
del rays_p
held = {}
png = os.path.join(c.ROOT, "build", "ab_mlt.png")
with c._held_sweeps(1024, held):
    assert cli.main(c._mlt_argv(c.MESH_SCENE, 128, 128, 8, 1024, 2, png,
                                objs=(c.BLOB,))) == 0
for kind, (mtm, rays_m, t_m, _) in sorted(held.items()):
    out["b4_ms"][f"mlt_{kind}_{rays_m.shape[1]}"] = b4_ms(
        mtm, rays_m.contiguous(), t_m, 20)
'''

MXU_KERNEL = MXU_TIMES + 'print("RESULT", json.dumps(out))\n'

MXU = MXU_TIMES + r'''
renders("main", c.SCENE, "SimplePathTracer", 512, 2048, 20, False)
renders("megamesh", c.MESH_SCENE, "AccPathTracer", 500, 256, 20, False,
        (c.BLOB,))
os.environ.pop("NR_MESH_MXU", None)
renders("hybrid_b2", c.MESH_SCENE, "AccPathTracer", 500, 256, 20, False,
        (c.ICO,), limit=1024)
os.environ["NR_MESH_MXU"] = "1"
renders("hybrid_b4", c.MESH_SCENE, "AccPathTracer", 500, 256, 20, False,
        (c.ICO,), limit=1024)
print("RESULT", json.dumps(out))
'''

# The dense pool's forms at their paths' shapes: (label, scene, objs, bsdf,
# env, size, spp, depth), the label a path's (phases 5-7 and 11's dense
# textured quad)
FORMS = r'''
FORMS = (("main", c.SCENE, (), False, False, 512, 2048, 20),
         ("acc", c.GLASS_SCENE, (), True, False, 512, 2048, 20),
         ("env_simple", c.ENV_SCENE, (), False, True, 512, 1024, 8),
         ("env_acc", c.ENV_SCENE, (), True, True, 512, 1024, 8),
         ("tex_simple", c.TEX_SCENE, (c.TEX_QUAD,), False, False, 256, 512,
          6),
         ("tex_acc", c.TEX_SCENE, (c.TEX_QUAD,), True, False, 256, 512, 6),
         ("tex_env_simple", c.TEX_SCENE, (c.TEX_QUAD,), False, True, 256,
          512, 6),
         ("tex_env_acc", c.TEX_SCENE, (c.TEX_QUAD,), True, True, 256, 512,
          6))
'''

# Each form alone: one `pt_accumulate` call of its path's spp (the launches
# the checkout's wrapper makes), three calls between CUDA events ("ms": a
# call, the wrapper's host work included, as a render pays it), and each
# launch alone between events recorded around the library call
# ("launch_ms": the device's time, the pixel counter's memset included);
# the env and texture forms also at every launch size of LAUNCH_SPP set
# in-process, at the other path's film size (the env scene at 256x256, 512
# spp; the textured quad at 512x512, 1024 spp) and the progressive env
# route's pass (one 8-spp call).  With BOUNDS the bound
# (`chip_smoke.bound_ms`) and the lane slots (`pt_cuda.loop_slots`) of one
# launch of the change's size, from the plain version's counts.
KERNEL_TIMES = FORMS + r'''
from nrenderer_torch.ops import pt_cuda
from nrenderer_torch.ops.pt_core import scene_epsilon
LAUNCH_SPP = {True: (32, 64, 256), False: (128, 512)}   # by env
BOUNDS = False
CONSTS = [n for n in ("PIXEL_SAMPLES_PER_LAUNCH",
                      "DENSE_PIXEL_SAMPLES_PER_LAUNCH") if hasattr(pt_cuda, n)]
lib = pt_cuda._kernels()
render_fn, launch_events = lib.nr_pt_render, []


def timed_render(*a):
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    err = render_fn(*a)
    ev[1].record()
    launch_events.append(ev)
    return err


lib.nr_pt_render = timed_render
out["kernel"] = {}


def timed(ss, cam, size, n_spp, depth, t_min, kw):
    film = torch.zeros((size * size, 3), device="cuda")
    call = lambda: pt_cuda.pt_accumulate(film, ss, cam, size, size, 0,
                                         n_spp, depth, 0, t_min, **kw)
    call()
    torch.cuda.synchronize()
    launch_events.clear()
    ms = c._time_ms(call, 3)
    launches = len(launch_events) // 3
    launch_ms = sum(a.elapsed_time(b) for a, b in launch_events) / (
        3 * launches)
    return {"ms": ms, "launches": launches, "launch_ms": launch_ms,
            "ms_32spp": ms / (n_spp / 32)}


for label, scene, objs, bsdf, env, size, spp, depth in FORMS:
    ss, cam, emap, arrays = c._setup("cuda", scene, env, objs)
    kw = dict(bsdf=bsdf,
              env=pt_cuda.make_env_tables(emap, "cuda") if env else None,
              tex=(pt_cuda.make_tex_tables(arrays.textures, "cuda")
                   if objs else None))
    t_min = scene_epsilon(ss)
    row = timed(ss, cam, size, spp, depth, t_min, kw)
    if env or objs:
        saved = [getattr(pt_cuda, n) for n in CONSTS]
        for k in LAUNCH_SPP[not objs]:
            for n in CONSTS:
                setattr(pt_cuda, n, k * size * size)
            row[f"launch_{k}"] = timed(ss, cam, size, spp, depth, t_min, kw)
        for n, v in zip(CONSTS, saved):
            setattr(pt_cuda, n, v)
        other, other_spp = (256, 512) if size == 512 else (512, 1024)
        row[f"film_{other}"] = timed(ss, cam, other, other_spp, depth, t_min,
                                     kw)
        if env and not (bsdf or objs):
            row["progressive_pass"] = timed(ss, cam, size, 8, depth, t_min,
                                            kw)
    if BOUNDS:
        launch = min(spp, pt_cuda.launch_plan(False, size * size)[1])
        work = {}
        pt_cuda.pt_accumulate_plain(
            torch.zeros((size * size, 3), device="cuda"), ss, cam, size,
            size, 0, launch, depth, 0, t_min, stats=work, **kw)
        row["bound"] = {"launch_spp": launch, "bound_ms": c.bound_ms(
            ss, size * size, work, emap, None, kw["tex"])[0],
            "bounces_per_sample": work["bounces"] / work["samples"],
            "slots": pt_cuda.loop_slots(work["path_bounces"], launch)}
    out["kernel"][label] = row
    print(label, json.dumps(row), flush=True)
lib.nr_pt_render = render_fn
'''

CODE = COMMON + PTXAS + KERNEL_TIMES + r'''
for label, scene, objs, bsdf, env, size, spp, depth in FORMS:
    renders(label, scene, "AccPathTracer" if bsdf else "SimplePathTracer",
            size, spp, depth, env, objs, n=7 if objs else 3)
renders("env_progressive", c.ENV_SCENE, "SimplePathTracer", 512, 1024, 8,
        True, extra=["--progressive"])
out["gpu"] = c.gpu_name_power()
print("RESULT", json.dumps(out))
'''

ANALYTIC_KERNEL = COMMON + PTXAS + KERNEL_TIMES + r'''
out["gpu"] = c.gpu_name_power()
print("RESULT", json.dumps(out))
'''


def _run(cwd: str, code: str) -> dict:
    p = subprocess.run([sys.executable, "-c", code], cwd=cwd,
                       capture_output=True, text=True, timeout=900)
    line = [l for l in p.stdout.splitlines() if l.startswith("RESULT ")]
    if p.returncode or not line:
        print(p.stdout[-2000:], p.stderr[-3000:], file=sys.stderr)
        raise SystemExit(f"run in {cwd} failed")
    return json.loads(line[0][len("RESULT "):])


# The constants a copy can set, by flag: the lines that hold them (file
# in the package, the line with {} for the value) and the mode they tune
THRESHOLDS = {
    "dense_min": ("mesh", [("csrc/mesh_sweep.cuh",
                            "constexpr int kDenseMin = {};")]),
    "min_blocks": ("mxu", [("csrc/mesh_sweep_mxu.cu",
                            "constexpr int kMinBlocks = {};")]),
    "ray_batch": ("mxu", [("csrc/mesh_sweep_mxu.cu",
                           "constexpr int kRayBatch = {};"),
                          ("ops/mesh_mxu.py", "RAY_BATCH = {}")]),
    "pt_min_blocks": ("analytic", [("csrc/pt_kernel.cu",
                                    "constexpr int kDenseMinBlocks = {};")]),
    "launch_spp": ("analytic", [
        ("ops/pt_cuda.py", "DENSE_PIXEL_SAMPLES_PER_LAUNCH = {} * 512 * 512")]),
}


def _set_line(path: str, line: str, value: int) -> None:
    """Replace the one line of `path` that starts as `line` does before its
    {}, with `line` holding `value`."""
    pattern = "^" + re.escape(line.split("{}")[0]) + ".*$"
    text, n = re.subn(pattern, line.format(value), open(path).read(),
                      flags=re.M)
    if n != 1:
        raise SystemExit(f"no single {pattern!r} line in {path}")
    open(path, "w").write(text)


def _threshold_copy(change: str, values: dict) -> str:
    """A copy of this checkout's package and script (resources linked)
    with sweep thresholds set (`THRESHOLDS` name -> value)."""
    tag = "_".join(f"{k}_{v}" for k, v in sorted(values.items()))
    dst = os.path.join(change, "build", tag)
    shutil.rmtree(dst, ignore_errors=True)
    os.makedirs(dst)
    shutil.copytree(os.path.join(change, "nrenderer_torch"),
                    os.path.join(dst, "nrenderer_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(change, "chip_smoke.py"), dst)
    os.symlink(os.path.join(change, "resource"),
               os.path.join(dst, "resource"))
    pkg = os.path.join(dst, "nrenderer_torch")
    for which, k in values.items():
        for path, line in THRESHOLDS[which][1]:
            _set_line(os.path.join(pkg, path), line, k)
    return dst


def main(argv) -> int:
    mode, sweeps = "analytic", []
    args = argv[1:]
    while args and args[0].startswith("--"):
        flag = args.pop(0)
        if flag in ("--hybrid", "--mesh", "--mxu", "--crossover"):
            mode = flag[2:]
        elif flag[2:].replace("-", "_") in THRESHOLDS and args:
            which = flag[2:].replace("-", "_")
            sweeps += [{which: int(k)} for k in args.pop(0).split(",")]
        elif flag == "--set" and args:   # one run with several constants
            pairs = [kv.split("=") for kv in args.pop(0).split(",")]
            if any(len(kv) != 2 or kv[0] not in THRESHOLDS for kv in pairs):
                args = []
                break
            sweeps.append({k: int(v) for k, v in pairs})
        else:
            args = []
    bad = any(mode != THRESHOLDS[which][0]
              for sw in sweeps for which in sw)
    change = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if mode == "crossover" and not args and not sweeps:
        st = _run(change, CROSSOVER)
        for name in sorted({k.rsplit("_", 1)[0] for k in st
                            if k.endswith(("_megamesh", "_hybrid"))}):
            med = {(r, key): sorted(st[f"{name}_{r}"][key])[1]
                   for r in ("megamesh", "hybrid")
                   for key in ("cli_s", "render_phase_s")}
            wins = med["megamesh", "cli_s"] < med["hybrid", "cli_s"]
            print(f"{name}: median CLI wall megamesh "
                  f"{med['megamesh', 'cli_s']:.4f} s, hybrid "
                  f"{med['hybrid', 'cli_s']:.4f} s (render phase "
                  f"{med['megamesh', 'render_phase_s']:.4f}, "
                  f"{med['hybrid', 'render_phase_s']:.4f} s): "
                  f"{'megamesh' if wins else 'hybrid'} wins", flush=True)
        print("CROSSOVER", json.dumps(st))
        return 0
    if len(args) != 1 or bad or not os.path.isfile(
            os.path.join(args[0], "chip_smoke.py")):
        print(__doc__, file=sys.stderr)
        return 2
    code = {"analytic": CODE, "hybrid": HYBRID, "mesh": MESH,
            "mxu": MXU}.get(mode)
    if code is None:
        print(__doc__, file=sys.stderr)
        return 2
    runs = []
    for i, who in enumerate(("parent", "change", "change", "parent")):
        bounds = mode == "analytic" and i == 1   # once: the same inputs
        st = _run(args[0] if who == "parent" else change,
                  code.replace("BOUNDS = False", "BOUNDS = True")
                  if bounds else code)
        runs.append((who, st))
        print(who, json.dumps(st), flush=True)
    for sw in sweeps:
        label = ",".join(f"{k}={v}" for k, v in sorted(sw.items()))
        st = _run(_threshold_copy(change, sw),
                  {"mxu": MXU_KERNEL, "analytic": ANALYTIC_KERNEL}.get(
                      mode, code))
        runs.append((label, st))
        print(label, json.dumps(st), flush=True)
    print("AB", json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
