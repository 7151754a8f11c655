#!/usr/bin/env python3
"""Hunt the env-map CLI render's rare wrong image on the CPU.

    python3 tools/torch_env_fault.py [--procs 300] [--renders 3] [--out DIR]

Runs `tests/test_torch_acc_pt.py::test_cli_acc_pt_matches_pallas_image[env]`'s
CLI render (`env_spheres.scn` under `env_sky.png`, AccPathTracer, 64x64,
16 spp, depth 3, `--device cpu`) `--renders` times in each of `--procs`
fresh processes, one process after another.  A spy on
`pt_core.closest_hit` keeps the process's first pass (its rays, the
sphere table as parsed, the hit t) and recomputes that pass at once.  The
first image's md5 is the reference; every image that differs prints
DIFF and its first pass is saved to `DIR/bad_<proc>_<render>.npz` beside
`DIR/good.npz`.  The fault shows in well under 1% of renders, and only
with other CPU-heavy work running beside them (ROADMAP.md section C)."""
from __future__ import annotations

import argparse
import hashlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(tag: str, renders: int, out: str) -> None:
    import numpy as np
    sys.path.insert(0, ROOT)
    from nrenderer_torch import cli
    from nrenderer_torch.ops import pt_core
    rec, real = {}, pt_core.closest_hit

    def spy(ss, o, d, *a, **kw):
        hit = real(ss, o, d, *a, **kw)
        if "t" not in rec:
            again = real(ss, o, d, *a, **kw)
            rec.update(t=hit.t.numpy().copy(), t_again=again.t.numpy().copy(),
                       sph=np.array(ss.sph, np.float64),
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
        print(tag, it, "ok" if same else "DIFF", md5, flush=True)
        if not same:
            np.savez(os.path.join(out, f"bad_{tag}_{it}.npz"), **rec)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--procs", type=int, default=300)
    p.add_argument("--renders", type=int, default=3)
    p.add_argument("--out", default=os.path.join(ROOT, "build", "env_fault"))
    p.add_argument("--child", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.child:
        child(args.child, args.renders, args.out)
        return 0
    diffs = 0
    for k in range(args.procs):
        res = subprocess.run([sys.executable, __file__, "--child", f"p{k}",
                              "--renders", str(args.renders), "--out",
                              args.out], capture_output=True, text=True)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("p")]
        print("\n".join(lines), flush=True)
        diffs += sum("DIFF" in ln for ln in lines)
    print(f"{diffs} of {args.procs * args.renders} renders differ")
    return 0


if __name__ == "__main__":
    sys.exit(main())
