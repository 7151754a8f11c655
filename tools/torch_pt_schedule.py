#!/usr/bin/env python3
"""Lane slots of the path-tracing kernel's bounce loops, counted on the CPU.

    python3 tools/torch_pt_schedule.py                 # the main path
    python3 tools/torch_pt_schedule.py --bsdf          # AccPathTracer's
    python3 tools/torch_pt_schedule.py --env --depth 8 --size 128 --spp 32
    python3 tools/torch_pt_schedule.py --tex --depth 6 --size 64 --spp 32
    python3 tools/torch_pt_schedule.py --spp 64 --launch-spp 32,64 \
        --resident 152064
    python3 tools/torch_pt_schedule.py --mesh --size 500 --spp 32 \
        --launch-spp 32 --bands 250,400 --resident 118272

Runs the kernel's plain torch version (`pt_cuda.pt_accumulate_plain`) on
the CPU at a path's shape: `resource/cornell_box.scn` (SimplePathTracer,
`pt_diffuse_kernel`) or, with `--bsdf`, `resource/pt_glass_box.scn`
(AccPathTracer, `pt_bsdf_kernel`); with `--env`, `resource/env_spheres.scn`
under `resource/env_sky.png` (the env forms); with `--tex`,
`resource/tex_grid.scn` + `resource/obj/tex_quad.obj` (the dense texture
forms; with `--env` too under the map); with `--mesh`, the mesh cell's
`benchmark/scenes/mesh_box.scn` + `benchmark/obj/ico_5120.obj` through the
blocked sweep (AccPathTracer's megamesh route, `pt_bsdf_mesh_kernel`);
512x512, 256 spp, depth 20, seed 0 by default; takes each path's bounce
count from its stats and prints, for each launch size,
`pt_cuda.loop_slots`: the useful bounces, the lane slots of the nested
loop (samples, then bounces) and of the flat loop (one bounce of whichever
sample a lane is on), with `--mesh` those of the mesh forms' grouped loop
(samples started together once half the lanes wait), with `--resident`
those of the persistent schedule for each count of resident lanes (the
first four launches only: its model is a Python loop), and each loop's
useful share.  `--bands R,...` counts
bands of `--band-rows` rows from each row R (row 0 the bottom) instead of
the whole film, the persistent schedule's resident lanes cut to the band's
share of the film (a band of a large film stands for the film at a tenth
of the time).  One JSON line per launch size and band.  A 512x512 run of
256 spp takes ~15 min (diffuse) on three CPU threads; the mesh cell's two
bands of 16 rows at 32 spp ~10 min.  No GPU and no JAX."""
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
    ap.add_argument("--mesh", action="store_true")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--depth", type=int, default=20)
    ap.add_argument("--launch-spp", default="1,32,64,128,256")
    ap.add_argument("--resident", default="")
    ap.add_argument("--bands", default="")
    ap.add_argument("--band-rows", type=int, default=16)
    ap.add_argument("--threads", type=int, default=3)
    a = ap.parse_args(argv)
    torch.set_num_threads(a.threads)
    from nrenderer_torch import build_scene_arrays, load_obj, load_scn
    from nrenderer_torch.io.image import load_image
    from nrenderer_torch.ops import pt_cuda
    from nrenderer_torch.ops.bvh import build_mesh_accel
    from nrenderer_torch.ops.camera import make_camera
    from nrenderer_torch.ops.intersect import make_static_scene
    from nrenderer_torch.ops.mesh_cuda import make_mesh_tables
    from nrenderer_torch.ops.pt_core import make_mat_channels, scene_epsilon
    res = os.path.join(ROOT, "resource")
    if a.mesh:
        name = os.path.join(ROOT, "benchmark", "scenes", "mesh_box.scn")
        obj = os.path.join(ROOT, "benchmark", "obj", "ico_5120.obj")
    else:
        name = os.path.join(res, "tex_grid.scn" if a.tex
                            else "env_spheres.scn" if a.env
                            else "pt_glass_box.scn" if a.bsdf
                            else "cornell_box.scn")
        obj = os.path.join(res, "obj", "tex_quad.obj") if a.tex else None
    scene = load_scn(name)
    if obj:
        load_obj(obj, scene, material=0)
    arrays = build_scene_arrays(scene)
    ss = make_static_scene(arrays)
    cam = make_camera(scene.camera, device="cpu")
    env = pt_cuda.make_env_tables(load_image(os.path.join(
        res, "env_sky.png"))[:, :, :3], "cpu") if a.env else None
    tex = pt_cuda.make_tex_tables(arrays.textures, "cpu") if a.tex \
        else None
    mesh = make_mesh_tables(build_mesh_accel(
        arrays, make_mat_channels(ss)).bt, "cpu") if a.mesh else None
    n = a.size * a.size
    bands = ([(r * a.size, a.band_rows * a.size)
              for r in (int(k) for k in a.bands.split(","))]
             if a.bands else [(0, n)])
    for pix0, n_pix in bands:
        stats = {}
        pt_cuda.pt_accumulate_plain(
            torch.zeros((n_pix, 3)), ss, cam, a.size, a.size, 0, a.spp,
            a.depth, 0, scene_epsilon(ss), bsdf=a.bsdf or a.mesh, env=env,
            mesh=mesh, tex=tex, stats=stats, pix0=pix0, n_pix=n_pix)
        pb = stats["path_bounces"]
        print(json.dumps({
            "scene": os.path.relpath(name, ROOT), "obj": obj and
            os.path.relpath(obj, ROOT), "env": a.env, "tex": a.tex,
            "bsdf": a.bsdf or a.mesh, "shape": [a.size, a.size, a.spp,
                                                a.depth],
            "pixels": [pix0, n_pix], "mean_path": float(pb.float().mean()),
            **({"slab_tests": stats["slab_tests"],
                "tri_tests": stats["tri_tests"]} if a.mesh else {})}))
        for launch in (int(k) for k in a.launch_spp.split(",")):
            if launch > a.spp:
                continue
            sub = pb[:, :a.spp // launch * launch]
            row = {"launch_spp": launch, "pixels": [pix0, n_pix],
                   **pt_cuda.loop_slots(
                       sub, launch, regen=pt_cuda.MESH_REGEN_EIGHTHS
                       if a.mesh else None)}
            for lanes in (int(k) for k in a.resident.split(",") if k):
                # the band's share of the film's resident lanes, in warps
                cut = max(32, lanes * n_pix // n // 32 * 32)
                head = sub[:, :launch * min(4, a.spp // launch)]
                got = pt_cuda.loop_slots(head, launch, resident=cut)
                row[f"persistent_{lanes}_vs_flat"] = \
                    got["persistent"] / got["flat"]
                row[f"persistent_{lanes}_share"] = got["persistent_share"]
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
