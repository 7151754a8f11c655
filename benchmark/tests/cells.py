"""The tests' cells: those of `BENCHMARK.json`, and the draft this
benchmark measured and held out (PERF.md §7), whose traffic and metric
files stay under `benchmark/`."""
import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import harness  # noqa: E402

HELD_OUT = {
    "cornell.draft": {"name": "cornell.draft", "config": "cornell",
                      "traffic": "draft", "chips": 1,
                      "why": "128x128, 16 spp: the host sets the pace"},
}


def spec(name: str) -> dict:
    if name in HELD_OUT:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            return harness.cell_spec(HELD_OUT[name], json.load(f))
    return harness.load_spec(name)
