#!/usr/bin/env python3
"""Hunt the env-map CLI render's rare wrong image on the CPU.

    python3 tools/torch_env_fault.py [--procs 300] [--renders 3] [--out DIR]
                                     [--cores all|0,3,...] [--load N]
                                     [--threads 1,0]
    python3 tools/torch_env_fault.py --fpu-watch 3600 [--load N]

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
renders for the whole run.  `--threads` gives the OpenMP worker counts of
the render processes (0: one a core of the affinity, the default), taken
in turn from process to process under the same load, each count with its
own reference image.  The fault shows in well under 1% of renders, and
only with other CPU-heavy work running beside them (ROADMAP.md section
C).

`--fpu-watch SECONDS` runs no render: it builds `FPU_WATCH` below with
gcc into DIR and runs it for that long, one thread a core of the
affinity (beside `--load`), each checking without pause that the control
bits of its SSE status word (MXCSR: rounding, flush-to-zero,
denormals-are-zero, exception masks) keep their value, that 1 + 2^-24
rounds to 1 (round to nearest), and that the render's failing operation,
b*b - a*c over 65,536 floats, gives the bits of its first pass: the
signature of the fault (one worker's chunk off by ulps, right on
recompute) is what state lost across a preemption would leave.  It
prints the counts of each thread."""
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

FPU_WATCH = r"""
#include <immintrin.h>
#include <pthread.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#define N 65536
static double secs;
typedef struct { int id; long iters, csr, round, vec; unsigned csr0; } R;
__attribute__((noinline)) static void disc(const float* a, const float* b,
                                           const float* c, float* out) {
  for (int i = 0; i < N; ++i) out[i] = b[i] * b[i] - a[i] * c[i];
}
static double now(void) {
  struct timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec + 1e-9 * t.tv_nsec;
}
static void* run(void* p) {
  R* r = (R*)p;
  float* m = malloc(5 * N * sizeof(float));
  float *a = m, *b = m + N, *c = m + 2 * N, *ref = m + 3 * N, *out = m + 4 * N;
  unsigned s = 12345u + 977u * r->id;
  for (int i = 0; i < N; ++i) {
    s = s * 1664525u + 1013904223u; a[i] = 1.0f + (s >> 8) * 5.9604645e-8f;
    s = s * 1664525u + 1013904223u; b[i] = (s >> 8) * 3.0e-5f - 250.0f;
    s = s * 1664525u + 1013904223u; c[i] = (s >> 8) * 4.0e-3f - 30000.0f;
  }
  disc(a, b, c, ref);
  r->csr0 = _mm_getcsr();
  const double t0 = now();
  do {
    disc(a, b, c, out);
    r->vec += memcmp(out, ref, N * sizeof(float)) != 0;
    r->csr += (_mm_getcsr() & 0xffc0u) != (r->csr0 & 0xffc0u);
    volatile float one = 1.0f, tiny = 5.9604645e-8f;
    r->round += (float)(one + tiny) != 1.0f;
    ++r->iters;
  } while (now() - t0 < secs);
  free(m);
  return 0;
}
int main(int argc, char** argv) {
  secs = atof(argv[1]);
  const int n = atoi(argv[2]);
  pthread_t th[256];
  R r[256];
  memset(r, 0, sizeof(r));
  for (int k = 0; k < n; ++k) {
    r[k].id = k;
    pthread_create(&th[k], 0, run, &r[k]);
  }
  for (int k = 0; k < n; ++k) {
    pthread_join(th[k], 0);
    printf("thread %d: %ld passes, mxcsr %08x changed %ld, rounding %ld, "
           "b*b-a*c differs %ld\n", k, r[k].iters, r[k].csr0, r[k].csr,
           r[k].round, r[k].vec);
  }
  return 0;
}
"""


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


def child(tag: str, renders: int, out: str, threads: str) -> None:
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
    good = os.path.join(out, f"good_t{threads}.md5")
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
            np.savez(os.path.join(out, f"good_t{threads}.npz"), **rec)
        with open(good) as f:
            same = f.read().strip() == md5
        cpus = ",".join(str(c) for c in rec["cpus"])
        print(tag, it, "ok" if same else "DIFF", md5, f"cpus={cpus}",
              flush=True)
        if not same:
            np.savez(os.path.join(out, f"bad_{tag}_{it}.npz"), **rec)


def fpu_watch(seconds: float, load: int, out: str) -> int:
    src, exe = os.path.join(out, "fpu_watch.c"), os.path.join(out, "fpu_watch")
    with open(src, "w") as f:
        f.write(FPU_WATCH)
    subprocess.run(["gcc", "-O3", "-march=native", "-ffp-contract=off",
                    "-pthread", "-o", exe, src], check=True)
    loads = [subprocess.Popen([sys.executable, "-c", LOAD],
                              stdout=subprocess.DEVNULL)
             for _ in range(load)]
    try:
        res = subprocess.run(
            [exe, str(seconds), str(len(os.sched_getaffinity(0)))],
            capture_output=True, text=True, check=True)
    finally:
        for proc in loads:
            proc.kill()
            proc.wait()
    print(res.stdout, end="", flush=True)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--procs", type=int, default=300)
    p.add_argument("--renders", type=int, default=3)
    p.add_argument("--out", default=os.path.join(ROOT, "build", "env_fault"))
    p.add_argument("--cores", default=None,
                   help="'all' or a comma list: pin each turn to one core")
    p.add_argument("--load", type=int, default=0)
    p.add_argument("--threads", default="0")
    p.add_argument("--fpu-watch", type=float, default=0.0)
    p.add_argument("--child", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.child:
        child(args.child, args.renders, args.out,
              os.environ["OMP_NUM_THREADS"])
        return 0
    if args.fpu_watch:
        return fpu_watch(args.fpu_watch, args.load, args.out)
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
    counts = [int(n) or len(os.sched_getaffinity(0))
              for n in args.threads.split(",")]
    diffs, runs = {}, {}
    try:
        for core in turns:
            pin = [] if core is None else ["taskset", "-c", str(core)]
            for k in range(args.procs):
                n = counts[k % len(counts)]
                tag = (f"p{k}" if core is None else f"c{core}p{k}") + f"t{n}"
                res = subprocess.run(
                    [*pin, sys.executable, __file__, "--child", tag,
                     "--renders", str(args.renders), "--out", args.out],
                    capture_output=True, text=True,
                    env=dict(os.environ, OMP_NUM_THREADS=str(n)))
                lines = [ln for ln in res.stdout.splitlines()
                         if ln.startswith(tag)]
                print("\n".join(lines), flush=True)
                key = (core, n)
                runs[key] = runs.get(key, 0) + len(lines)
                diffs[key] = diffs.get(key, 0) + sum("DIFF" in ln
                                                     for ln in lines)
    finally:
        for proc in loads:
            proc.kill()
            proc.wait()
    for (core, threads), n in diffs.items():
        where = "unpinned" if core is None else f"core {core}"
        print(f"{where}, {threads} threads: {n} of {runs[core, threads]} "
              "renders differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
