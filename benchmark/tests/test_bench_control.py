"""The check's control at a size a test run holds: the reference in
bfloat16, put in the renderer's place, comes out not correct by the
check's own comparison and judgement for every cell's traffic, and the
reference in float32 there comes out correct.  On the chip the same
function runs at the cells' own sizes
(`python3 benchmark/control.py --workload <cell> --seeds ...`)."""
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import control  # noqa: E402
from cells import spec as cell_spec  # noqa: E402
from reference import png  # noqa: E402


def _small(cell):
    spec = cell_spec(cell)
    spec["traffic"].update(width=32, height=32, spp=64, depth=8)
    spec["traffic"]["check"] = dict(spec["traffic"]["check"], pixels=256)
    return spec


@pytest.mark.parametrize("cell", ["cornell.final", "glass.final",
                                  "cornell.draft"])
@pytest.mark.parametrize("seed", [1, 2 ** 31 + 9])
def test_bfloat16_fails_and_float32_passes(cell, seed):
    spec = _small(cell)
    correct, shown = control.control_run(spec, seed, 4, "cpu",
                                         torch.bfloat16)
    assert not correct, shown
    assert any(shown[k]["value"] > limit
               for k, limit in spec["traffic"]["limits"].items()), shown
    correct, shown = control.control_run(spec, seed, 4, "cpu",
                                         torch.float32)
    assert correct, shown
    assert shown["max_gap"]["value"] == 0.0
    assert shown["mismatch_share"]["value"] == 0.0


def test_png_round_trip(tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (5, 7, 4), np.uint8)
    png.write(str(tmp_path / "a.png"), img)
    assert np.array_equal(png.read(str(tmp_path / "a.png")), img)
