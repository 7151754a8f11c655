#!/usr/bin/env python3
"""A/B of the port's analytic-scene paths on one NVIDIA GPU.

    git archive <parent> | tar -x -C build/parent     # a second checkout
    python3 tools/torch_ab.py build/parent              # from the repo root
    python3 tools/torch_ab.py --hybrid build/parent     # the hybrid paths

Runs the two checkouts in turns (parent, change, change, parent), each in a
fresh process that builds its own kernel library and then renders, through
its own `cli.main`, the four paths of `chip_smoke.py` phases 5-7: the
SimplePathTracer main path (Cornell box, 512x512, 2048 spp, depth 20),
AccPathTracer on `pt_glass_box.scn` (512x512, 2048 spp, depth 20), and
AccPathTracer and SimplePathTracer on `env_spheres.scn` under
`env_sky.png` (512x512, 1024 spp, depth 8).  Each path gets a warm-up
render and then three renders whose render phases it reads from the
renderer's timer.  Then it times each path's kernel form alone: one
`pt_accumulate` call of 256 spp at 512x512 at the path's depth (eight
launches of 32 spp, so the wrapper's host work is a small share even for
the short env launches), five calls between CUDA events, in ms per 32-spp
launch.  With `--hybrid` it renders instead the two hybrid-route paths of
phases 14-15 (`ico_5120.obj` on `mesh_box.scn`, 500x500, 256 spp, depth
20; `blob_960.obj` under `env_sky.png`, 512x512, 256 spp, depth 8) the
same way, then runs phase 16's breakdown of one hybrid chunk, and first
phase 12 (the streaming compactor against its plain versions at 2^24
lanes: kernel, plain, library and bound times of the stage and mesh
cases) with the compactor kernels' `nvcc -Xptxas -v` lines (registers,
shared memory, stack frame, spills).  Prints one line per run and a final
`AB` JSON line.  Imports nothing of JAX."""
from __future__ import annotations

import json
import os
import subprocess
import sys

COMMON = r'''
import json, os, time, torch, chip_smoke as c
from nrenderer_torch import cli
from nrenderer_torch.utils.timing import GLOBAL_TIMER
c.phase_build()
out = {}


def renders(label, scene, renderer, size, spp, depth, env, objs=()):
    """A warm-up render, then three whose render phases and CLI walls are
    kept under `label`."""
    png = os.path.join(c.ROOT, "build", f"ab_{label}.png")
    os.makedirs(os.path.dirname(png), exist_ok=True)
    argv = c._cli_argv(scene, renderer, size, size, spp, depth, png,
                       env=env, objs=objs)
    assert cli.main(argv) == 0
    phases, walls = [], []
    for _ in range(3):
        g0 = GLOBAL_TIMER.get(f"{renderer}.render").total_s
        t0 = time.perf_counter()
        assert cli.main(argv) == 0
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        phases.append(GLOBAL_TIMER.get(f"{renderer}.render").total_s - g0)
    out[label] = {"render_phase_s": phases, "cli_s": walls}
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
        (c.ICO,))
renders("env_mesh", c.MESH_SCENE, "AccPathTracer", 512, 256, 8, True,
        (c.BLOB,))
out["chunk"] = c.phase_breakdown()
print("RESULT", json.dumps(out))
'''

CODE = COMMON + r'''
paths = (("main", c.SCENE, "SimplePathTracer", 2048, 20, False),
         ("acc", c.GLASS_SCENE, "AccPathTracer", 2048, 20, False),
         ("env_acc", c.ENV_SCENE, "AccPathTracer", 1024, 8, True),
         ("env_simple", c.ENV_SCENE, "SimplePathTracer", 1024, 8, True))
for label, scene, renderer, spp, depth, env in paths:
    renders(label, scene, renderer, 512, spp, depth, env)
from nrenderer_torch.ops import pt_cuda
from nrenderer_torch.ops.pt_core import scene_epsilon
for label, scene, renderer, spp, depth, env in paths:
    ss, cam, emap = c._setup("cuda", scene, env)[:3]
    tables = pt_cuda.make_env_tables(emap, "cuda") if env else None
    film = torch.zeros((512 * 512, 3), device="cuda")
    call = lambda: pt_cuda.pt_accumulate(
        film, ss, cam, 512, 512, 0, 256, depth, 0, scene_epsilon(ss),
        bsdf=renderer == "AccPathTracer", env=tables)
    call()
    torch.cuda.synchronize()
    out[label]["kernel_ms_32spp"] = c._time_ms(call, 5) / 8
print("RESULT", json.dumps(out))
'''


def main(argv) -> int:
    hybrid = argv[1:2] == ["--hybrid"]
    argv = argv[:1] + argv[1 + hybrid:]
    if len(argv) != 2 or not os.path.isfile(
            os.path.join(argv[1], "chip_smoke.py")):
        print(__doc__, file=sys.stderr)
        return 2
    change = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = []
    for who in ("parent", "change", "change", "parent"):
        cwd = argv[1] if who == "parent" else change
        p = subprocess.run([sys.executable, "-c",
                            HYBRID if hybrid else CODE], cwd=cwd,
                           capture_output=True, text=True, timeout=900)
        line = [l for l in p.stdout.splitlines() if l.startswith("RESULT ")]
        if p.returncode or not line:
            print(p.stdout[-2000:], p.stderr[-3000:], file=sys.stderr)
            raise SystemExit(f"{who} run failed")
        st = json.loads(line[0][len("RESULT "):])
        runs.append((who, st))
        print(who, json.dumps(st), flush=True)
    print("AB", json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
