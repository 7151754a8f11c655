#!/usr/bin/env python3
"""Lane slots of the flat-loop path-tracing forms, counted on the CPU.

    python3 tools/torch_pt_schedule.py                 # the main path
    python3 tools/torch_pt_schedule.py --bsdf          # AccPathTracer's
    python3 tools/torch_pt_schedule.py --env --depth 8 --size 128 --spp 32
    python3 tools/torch_pt_schedule.py --tex --depth 6 --size 64 --spp 32
    python3 tools/torch_pt_schedule.py --spp 64 --launch-spp 32,64 \
        --resident 152064

Runs the kernel's plain torch version (`pt_cuda.pt_accumulate_plain`) on
the CPU at a path's shape: `resource/cornell_box.scn` (SimplePathTracer,
`pt_diffuse_kernel`) or, with `--bsdf`, `resource/pt_glass_box.scn`
(AccPathTracer, `pt_bsdf_kernel`); with `--env`, `resource/env_spheres.scn`
under `resource/env_sky.png` (the env forms); with `--tex`,
`resource/tex_grid.scn` + `resource/obj/tex_quad.obj` (the dense texture
forms; with `--env` too under the map); 512x512, 256 spp, depth 20, seed 0
by default; takes each path's bounce count from its stats and prints, for
each launch size, `pt_cuda.loop_slots`: the useful bounces, the lane slots
of the nested loop (samples, then bounces) and of the flat loop (one
bounce of whichever sample a lane is on), with `--resident` those of the
persistent schedule for each count of resident lanes (the first four
launches only: its model is a Python loop), and each loop's useful share.
One JSON line per launch size.  A 512x512 run of 256 spp takes ~15 min
(diffuse) on three CPU threads.  No GPU and no JAX."""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bsdf", action="store_true")
    ap.add_argument("--env", action="store_true")
    ap.add_argument("--tex", action="store_true")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--depth", type=int, default=20)
    ap.add_argument("--launch-spp", default="1,32,64,128,256")
    ap.add_argument("--resident", default="")
    ap.add_argument("--threads", type=int, default=3)
    a = ap.parse_args(argv)
    torch.set_num_threads(a.threads)
    from nrenderer_torch import build_scene_arrays, load_obj, load_scn
    from nrenderer_torch.io.image import load_image
    from nrenderer_torch.ops import pt_cuda
    from nrenderer_torch.ops.camera import make_camera
    from nrenderer_torch.ops.intersect import make_static_scene
    from nrenderer_torch.ops.pt_core import scene_epsilon
    res = os.path.join(ROOT, "resource")
    name = ("tex_grid.scn" if a.tex else "env_spheres.scn" if a.env
            else "pt_glass_box.scn" if a.bsdf else "cornell_box.scn")
    scene = load_scn(os.path.join(res, name))
    if a.tex:
        load_obj(os.path.join(res, "obj", "tex_quad.obj"), scene, material=0)
    arrays = build_scene_arrays(scene)
    ss = make_static_scene(arrays)
    cam = make_camera(scene.camera, device="cpu")
    env = pt_cuda.make_env_tables(load_image(os.path.join(
        res, "env_sky.png"))[:, :, :3], "cpu") if a.env else None
    tex = pt_cuda.make_tex_tables(arrays.textures, "cpu") if a.tex \
        else None
    n = a.size * a.size
    stats = {}
    pt_cuda.pt_accumulate_plain(torch.zeros((n, 3)), ss, cam, a.size, a.size,
                                0, a.spp, a.depth, 0, scene_epsilon(ss),
                                bsdf=a.bsdf, env=env, tex=tex, stats=stats)
    pb = stats["path_bounces"]
    print(json.dumps({"scene": name, "env": a.env, "tex": a.tex,
                      "bsdf": a.bsdf, "shape": [a.size, a.size, a.spp,
                                                a.depth],
                      "mean_path": float(pb.float().mean())}))
    for launch in (int(k) for k in a.launch_spp.split(",")):
        if launch > a.spp:
            continue
        sub = pb[:, :a.spp // launch * launch]
        row = {"launch_spp": launch, **pt_cuda.loop_slots(sub, launch)}
        for lanes in (int(k) for k in a.resident.split(",") if k):
            head = sub[:, :launch * min(4, a.spp // launch)]
            got = pt_cuda.loop_slots(head, launch, resident=lanes)
            row[f"persistent_{lanes}_vs_flat"] = \
                got["persistent"] / got["flat"]
            row[f"persistent_{lanes}_share"] = got["persistent_share"]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
