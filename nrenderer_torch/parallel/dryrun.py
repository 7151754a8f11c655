"""A quick end-to-end run of every sharded path on N ranks.

    python -m nrenderer_torch.parallel.dryrun N [--device cuda|cpu]
        [--shard samples|pixels]

The port's counterpart of `__graft_entry__.py`'s `dryrun_multichip`: it
renders 16x16 films on the first N GPUs (or, with `--device cpu`, on N CPU
ranks over gloo) and holds each against the one-device render of the same
route on the same device, printing one line per path:

- SimplePathTracer on `resource/cornell_box.scn`;
- AccPathTracer on `resource/pt_glass_box.scn`;
- MetropolisLightTransport on `resource/cornell_box.scn`, chain-sharded;
- the mesh routes: AccPathTracer on `resource/mesh_box.scn` with
  `resource/obj/blob_960.obj` (megamesh) and `ico_5120.obj` (the hybrid
  route, which the GPU's threshold would not pick for it: the line pins
  the CPU's `acc_pt.MEGAMESH_MAX_TRIS`).

Pixel bands must equal the one-device film's rows bit for bit; sample and
chain sharding must agree within RTOL (the final sum's order is all that
differs).  Exits 1 on the first path that fails, 2 when the devices asked
for are not there (no GPU, or fewer than N)."""
from __future__ import annotations

import argparse
import contextlib
import pathlib
import sys
import time

import numpy as np

RESOURCE = pathlib.Path(__file__).resolve().parents[2] / "resource"
SIZE = 16
RTOL = 1e-5


def _scene(scn: str, obj: str = None, spp: int = 16, depth: int = 4):
    from ..io.obj import load_obj
    from ..io.scn import load_scn
    from ..scene.model import Scene
    scene = Scene()
    load_scn(str(RESOURCE / scn), scene)
    if obj:
        load_obj(str(RESOURCE / "obj" / obj), scene, material=0)
    ro = scene.render_option
    ro.width = ro.height = SIZE
    ro.samples_per_pixel = spp
    ro.depth = depth
    return scene


def _one_device(scene, renderer: str, device, **kw) -> np.ndarray:
    from ..renderers.acc_pt import AccPathTracerRenderer
    from ..renderers.mlt import render_mlt
    from ..renderers.simple_pt import SimplePathTracerRenderer
    if renderer == "MetropolisLightTransport":
        return render_mlt(scene, device=device, **kw)
    cls = (SimplePathTracerRenderer if renderer == "SimplePathTracer"
           else AccPathTracerRenderer)
    return cls(device=device).render(scene).pixels[..., :3]


def run(n: int, device_type: str = "cuda", shard: str = "samples") -> bool:
    """Every path on `n` ranks; prints a line each, returns whether all
    passed."""
    from ..parallel.group import make_devices
    from ..parallel.mesh import render_sharded
    from ..parallel.mlt import render_mlt_sharded
    from ..renderers import acc_pt
    devices = make_devices(n, device_type)
    mlt_kw = dict(chains=64 * n, mutations=16, n_init=512)
    # (label, renderer, scene, the megamesh limit pinned for the path)
    paths = [
        ("SPT", "SimplePathTracer", _scene("cornell_box.scn"), None),
        ("AccPT", "AccPathTracer", _scene("pt_glass_box.scn"), None),
        ("MLT", "MetropolisLightTransport", _scene("cornell_box.scn"), None),
        # the megamesh route shards passes of 32 spp
        ("AccPT mesh blob_960", "AccPathTracer",
         _scene("mesh_box.scn", "blob_960.obj", spp=32 * n), None),
        ("AccPT mesh ico_5120", "AccPathTracer",
         _scene("mesh_box.scn", "ico_5120.obj", spp=4),
         acc_pt.MEGAMESH_MAX_TRIS),
    ]
    ok = True
    for label, renderer, scene, limit in paths:
        t0 = time.perf_counter()
        mlt = renderer == "MetropolisLightTransport"
        if mlt:
            out = render_mlt_sharded(scene, devices, **mlt_kw)
            want = _one_device(scene, renderer, device_type, **mlt_kw)
            mode = "chains"
        else:
            with (contextlib.nullcontext() if limit is None else
                  acc_pt.pinned_megamesh_max_tris(limit)):
                out = render_sharded(scene, devices, renderer, shard)
                want = _one_device(scene, renderer, device_type)
            mode = shard
        got = out.image
        err = float(np.abs(got - want).max())
        exact = shard == "pixels" and not mlt
        good = (got.shape == want.shape and bool(np.isfinite(got).all())
                and (np.array_equal(got, want) if exact else
                     bool(np.allclose(got, want, rtol=RTOL, atol=RTOL))))
        ok &= good
        print(f"dryrun({n} x {device_type}, {mode}): {label} "
              f"[{out.route}] {'OK' if good else 'FAILED'}, mean "
              f"{got[..., :3].mean():.5f}, max |d| vs one device {err:.3g}, "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        if not good:
            break
    return ok


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nrenderer_torch.parallel.dryrun")
    p.add_argument("n", type=int, help="ranks")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--shard", choices=("samples", "pixels"),
                   default="samples")
    args = p.parse_args(argv)
    from ..parallel.group import make_devices
    try:
        make_devices(args.n, args.device)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    ok = run(args.n, args.device, args.shard)
    print(f"dryrun({args.n}): {'OK' if ok else 'FAILED'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
