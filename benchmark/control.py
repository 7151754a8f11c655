"""The check's control: the configuration's reference
(`check.reference_for`) in the nearest precision below the one the
configuration states (bfloat16 for float32), put in the renderer's place
and judged by the check itself (`check.compare`, `check.judge`).

    python3 benchmark/control.py --workload cornell.final --seeds 1,2,3

For each seed it builds the window's render records as a run with that
seed does (`--renders` renders, each with its render seed, the kept ones
drawn from the seed), and writes each checked render's PNG with the
control's pixels where the check reads them (the rest of the film is
black: the check reads nothing else).  Then the check's own comparison
and judgement run over those records, and one JSON line a seed gives
`correct` and the numbers beside their limits; a last line gives the
smallest of each number over the seeds (the upper readings of the
check's limits).  It exits 1 if the control came out correct on any
seed.  It runs on the first CUDA device, or with `--device cpu`."""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import check
from harness import ROOT, load_spec
from reference import png, tracer


def control_run(spec: dict, seed: int, renders: int, device,
                dtype=torch.bfloat16) -> tuple:
    """`check.judge`'s (correct, shown) for a window of `renders` renders
    whose PNGs hold the reference's pixels computed in `dtype`."""
    config, traffic = spec["config"], spec["traffic"]
    w, h, chk = traffic["width"], traffic["height"], traffic["check"]
    ref = check.reference_for(config, ROOT)
    tables = ref.load(config, ROOT)
    with tempfile.TemporaryDirectory(prefix="nrbench.control.") as tmp:
        window = [{"k": k, "seed": check.render_seed(seed, k), "ok": True,
                   "kept": check.kept(seed, k, chk["every"]),
                   "out": str(Path(tmp) / f"render{k}.png")}
                  for k in range(renders)]
        for r in check.chosen(window, chk["renders"]):
            rows, cols, ids = tracer.film_pixels(
                w, h, chk["pixels"], check.pixel_rng(seed, r["k"]))
            img = np.zeros((h, w, 4), np.uint8)
            img[..., 3] = 255
            img[rows, cols, :3] = ref.render_pixels(
                tables, config, traffic, ids, r["seed"], device, dtype, None)
            png.write(r["out"], img)
        numbers = check.compare(config, traffic, ROOT, seed, window, device)
    return check.judge(numbers, traffic["limits"], 0, len(window))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated run seeds")
    p.add_argument("--renders", type=int, default=64,
                   help="renders in the window the control stands for")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    spec = load_spec(args.workload)
    device = "cuda:0" if args.device == "cuda" else args.device
    lows, passed = {}, 0
    for seed in (int(s) for s in args.seeds.split(",")):
        correct, shown = control_run(spec, seed, args.renders, device)
        passed += correct
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": "bfloat16", "correct": correct,
                          "checked": shown}), flush=True)
        for name in spec["traffic"]["limits"]:
            v = shown[name]["value"]
            lows[name] = min(lows.get(name, v), v)
    print(json.dumps({"workload": args.workload, "dtype": "bfloat16",
                      "smallest": lows, "correct_on": passed}))
    return 1 if passed else 0


if __name__ == "__main__":
    sys.path.insert(1, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    sys.exit(main())
