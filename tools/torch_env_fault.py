#!/usr/bin/env python3
"""Hunt the env-map CLI render's rare wrong image on the CPU.

    python3 tools/torch_env_fault.py [--procs 300] [--renders 3] [--out DIR]
                                     [--cores all|0,3,...] [--load N]

Runs `tests/test_torch_acc_pt.py::test_cli_acc_pt_matches_pallas_image[env]`'s
CLI render (`env_spheres.scn` under `env_sky.png`, AccPathTracer, 64x64,
16 spp, depth 3, `--device cpu`) `--renders` times in each of `--procs`
fresh processes, one process after another.  A spy on
`pt_core.closest_hit` keeps the process's first pass (its rays, the
sphere table as parsed, the hit t) and recomputes that pass at once, and
records the CPU each OpenMP worker runs on right after the pass (worker k
computes the k-th contiguous chunk of the pass's rays).  The first image's
md5 is the reference; every image that differs prints DIFF and its first
pass is saved to `DIR/bad_<proc>_<render>.npz` beside `DIR/good.npz`.

`--cores` runs the processes pinned to one core at a time (`taskset -c`),
`--procs` of them on each listed core in turn, so that a fault tied to one
core shows on it alone.  `--load N` keeps N CPU-heavy processes (float32
matrix products on torch's default threads, unpinned) running beside the
renders for the whole run.  The fault shows in well under 1% of renders,
and only with other CPU-heavy work running beside them (ROADMAP.md
section C)."""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOAD = ("import torch\n"
        "a = torch.rand(768, 768)\n"
        "while True:\n"
        "    a = torch.tanh(a @ a)\n")


def omp_worker_cpus() -> list:
    """The CPU each of torch's OpenMP workers runs on, by worker number:
    one parallel region of torch's own libgomp in which every worker
    reads sched_getcpu()."""
    path = next(ln.split()[-1] for ln in open("/proc/self/maps")
                if ln.rstrip().endswith("libgomp.so.1"))
    gomp, libc = ctypes.CDLL(path), ctypes.CDLL(None)
    n = gomp.omp_get_max_threads()
    cpus = (ctypes.c_int * n)(*([-1] * n))

    @ctypes.CFUNCTYPE(None, ctypes.c_void_p)
    def region(_):
        cpus[gomp.omp_get_thread_num()] = libc.sched_getcpu()

    gomp.GOMP_parallel.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_uint, ctypes.c_uint]
    gomp.GOMP_parallel(ctypes.cast(region, ctypes.c_void_p), None, 0, 0)
    return list(cpus)


def child(tag: str, renders: int, out: str) -> None:
    import numpy as np
    sys.path.insert(0, ROOT)
    from nrenderer_torch import cli
    from nrenderer_torch.ops import pt_core
    rec, real = {}, pt_core.closest_hit

    def spy(ss, o, d, *a, **kw):
        hit = real(ss, o, d, *a, **kw)
        if "t" not in rec:
            cpus = omp_worker_cpus()
            again = real(ss, o, d, *a, **kw)
            rec.update(t=hit.t.numpy().copy(), t_again=again.t.numpy().copy(),
                       sph=np.array(ss.sph, np.float64),
                       cpus=np.array(cpus, np.int32),
                       **{f"{v}{k}": getattr(x, k).numpy().copy()
                          for v, x in (("o", o), ("d", d))
                          for k in "xyz"})
        return hit

    pt_core.closest_hit = spy
    good = os.path.join(out, "good.md5")
    for it in range(renders):
        rec.clear()
        png = os.path.join(out, f"img_{tag}.png")
        argv = ["render", "--scene", f"{ROOT}/resource/env_spheres.scn",
                "--renderer", "AccPathTracer", "--width", "64", "--height",
                "64", "--spp", "16", "--depth", "3", "--device", "cpu",
                "--out", png, "--env-map", f"{ROOT}/resource/env_sky.png"]
        if cli.main(argv) != 0:
            raise SystemExit("render failed")
        with open(png, "rb") as f:
            md5 = hashlib.md5(f.read()).hexdigest()
        if not os.path.exists(good):
            with open(good, "w") as f:
                f.write(md5)
            np.savez(os.path.join(out, "good.npz"), **rec)
        with open(good) as f:
            same = f.read().strip() == md5
        cpus = ",".join(str(c) for c in rec["cpus"])
        print(tag, it, "ok" if same else "DIFF", md5, f"cpus={cpus}",
              flush=True)
        if not same:
            np.savez(os.path.join(out, f"bad_{tag}_{it}.npz"), **rec)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--procs", type=int, default=300)
    p.add_argument("--renders", type=int, default=3)
    p.add_argument("--out", default=os.path.join(ROOT, "build", "env_fault"))
    p.add_argument("--cores", default=None,
                   help="'all' or a comma list: pin each turn to one core")
    p.add_argument("--load", type=int, default=0)
    p.add_argument("--child", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.child:
        child(args.child, args.renders, args.out)
        return 0
    if args.cores is None:
        turns = [None]
    elif args.cores == "all":
        turns = sorted(os.sched_getaffinity(0))
    else:
        turns = [int(c) for c in args.cores.split(",")]
    loads = [subprocess.Popen([sys.executable, "-c", LOAD],
                              stdout=subprocess.DEVNULL)
             for _ in range(args.load)]
    # pinned, libgomp would start one worker; keep the unpinned count, so
    # the pass splits into the same chunks
    env = dict(os.environ,
               OMP_NUM_THREADS=str(len(os.sched_getaffinity(0))))
    diffs = {}
    try:
        for core in turns:
            pin = [] if core is None else ["taskset", "-c", str(core)]
            for k in range(args.procs):
                tag = f"p{k}" if core is None else f"c{core}p{k}"
                res = subprocess.run(
                    [*pin, sys.executable, __file__, "--child", tag,
                     "--renders", str(args.renders), "--out", args.out],
                    capture_output=True, text=True, env=env)
                lines = [ln for ln in res.stdout.splitlines()
                         if ln.startswith(tag)]
                print("\n".join(lines), flush=True)
                diffs[core] = diffs.get(core, 0) + sum("DIFF" in ln
                                                       for ln in lines)
    finally:
        for proc in loads:
            proc.kill()
            proc.wait()
    for core, n in diffs.items():
        where = "unpinned" if core is None else f"core {core}"
        print(f"{where}: {n} of {args.procs * args.renders} renders differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
