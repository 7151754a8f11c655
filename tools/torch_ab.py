#!/usr/bin/env python3
"""A/B of the port's SimplePathTracer main path on one NVIDIA GPU.

    git archive <parent> | tar -x -C build/parent     # a second checkout
    python3 tools/torch_ab.py build/parent              # from the repo root

Runs the two checkouts in turns (parent, change, change, parent), each in a
fresh process that builds its own kernel library, runs its `chip_smoke.py`
main-path phase (a warm-up and a timed CLI render at 512x512, 2048 spp,
depth 20) and then three more CLI renders, whose render phases it reads from
the renderer's timer.  Prints one line per run and a final `AB` JSON line.
Imports nothing of JAX."""
from __future__ import annotations

import json
import os
import subprocess
import sys

CODE = r'''
import json, chip_smoke as c
from nrenderer_torch import cli
from nrenderer_torch.utils.timing import GLOBAL_TIMER
c.phase_build()
st = c.phase_main_path()
argv = (c._main_path_argv(512, 512, 2048, 20)
        if hasattr(c, "_main_path_argv") else
        c._cli_argv(c.SCENE, "SimplePathTracer", 512, 512, 2048, 20,
                    c.OUT_PNG))
phases = []
for _ in range(3):
    g0 = GLOBAL_TIMER.get("SimplePathTracer.render").total_s
    assert cli.main(argv) == 0
    phases.append(GLOBAL_TIMER.get("SimplePathTracer.render").total_s - g0)
print("RESULT", json.dumps({"cli_s": st["seconds"],
                            "render_phase_s": phases}))
'''


def main(argv) -> int:
    if len(argv) != 2 or not os.path.isfile(
            os.path.join(argv[1], "chip_smoke.py")):
        print(__doc__, file=sys.stderr)
        return 2
    change = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = []
    for who in ("parent", "change", "change", "parent"):
        cwd = argv[1] if who == "parent" else change
        p = subprocess.run([sys.executable, "-c", CODE], cwd=cwd,
                           capture_output=True, text=True, timeout=600)
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
