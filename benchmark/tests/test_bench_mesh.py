"""The mesh cell, `mesh.megamesh`, at sizes a test run holds on the CPU:
through `harness.run_cell` on the renderer's plain versions it reads
`correct` with `max_gap` 0 (the CPU's megamesh limit pinned to the
card's, so that the 5,120-face pool takes the cell's route there too),
and a traced run reports the cell's per-layer metrics from the program's
spans; the mesh reference imports nothing of the renderer or JAX; the
control's bfloat16 reference comes out not correct on the cell; and
`roofline_mesh.py`'s counts are frozen."""
import json
import os
import subprocess
import sys
import time

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import control  # noqa: E402
import harness  # noqa: E402
import roofline  # noqa: E402
import roofline_mesh  # noqa: E402
from cells import spec as cell_spec  # noqa: E402

CELL = "mesh.megamesh"
SPAN_METRICS = ("render_phase_ms.megamesh", "pass_host_ms.megamesh",
                "bvh_build_ms.megamesh")


def _small(size=16, spp=64, depth=5):
    spec = cell_spec(CELL)
    t = spec["traffic"]
    t.update(width=size, height=size, spp=spp, depth=depth)
    t["check"] = dict(t["check"], every=1, renders=2, pixels=size * size)
    return spec


def _run(spec, trace, seed):
    from nrenderer_torch.renderers import acc_pt
    with acc_pt.pinned_megamesh_max_tris(acc_pt.MEGAMESH_MAX_TRIS_CUDA):
        return harness.run_cell(spec, seed, 0.3, trace, time.perf_counter(),
                                device="cpu")


def test_the_cell_is_its_configuration():
    spec = cell_spec(CELL)
    c, t = spec["config"], spec["traffic"]
    assert (c["renderer"], c["estimator"], c["reference"]) == (
        "AccPathTracer", "bsdf", "mesh")
    assert (t["width"], t["height"], t["spp"], t["depth"]) == (
        500, 500, 256, 20)
    for copy, orig in ((c["scene"], "resource/mesh_box.scn"),
                       (c["obj"][0], "resource/obj/ico_5120.obj")):
        with open(os.path.join(ROOT, copy), "rb") as a, \
                open(os.path.join(ROOT, orig), "rb") as b:
            assert a.read() == b.read()
    assert {m["name"] for m in spec["end_to_end"]} == {"render_s",
                                                      "setup_s"}
    assert {m["name"] for m in spec["per_layer"]} == set(SPAN_METRICS) | {
        "pt_mesh_kernel_roofline", "device.idle_pct.megamesh"}


@pytest.mark.parametrize("seed", [2 ** 31 + 71, 4100000093])
def test_the_cell_is_correct_on_the_plain_versions(seed):
    result = _run(_small(), False, seed)
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["correct"], result["checked"]
    assert result["checked"]["max_gap"]["value"] == 0
    assert result["checked"]["mismatch_share"]["value"] == 0
    rec = result["_record"]
    assert rec["tables"]["counts"] == {
        "spheres": 0, "triangles": 0, "planes": 5, "lights": 1,
        "mesh_triangles": 5120}
    # the mesh form's scene table, 40 blocks of 128 rows of 16 and boxes
    assert rec["tables"]["floats"] == 155 + 40 * 128 * 16 + 40 * 8
    assert set(result["metrics"]) == {"render_s", "setup_s"}


def test_a_traced_run_reads_the_span_metrics():
    result = _run(_small(spp=64), True, 2 ** 31 + 73)
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert all(got.get(name) is not None for name in SPAN_METRICS), got
    # the loop's host work is the render phase less the passes' waits
    assert 0.0 <= got["pass_host_ms.megamesh"] < \
        got["render_phase_ms.megamesh"]
    assert got["bvh_build_ms.megamesh"] > 0.0
    assert "pt_mesh_kernel_roofline" not in got    # no CUDA kernel here


def test_without_pass_waits_the_host_work_reads_none(monkeypatch):
    from nrenderer_torch.utils import timing
    timer = timing.PhaseTimer()
    monkeypatch.setattr(timing, "GLOBAL_TIMER", timer)
    t0 = time.perf_counter()
    with timer.phase("cli.render", root=True):
        with timer.scope("AccPathTracer").phase("render"):
            pass
    rec = {"renders": [{"t0": t0, "t1": time.perf_counter(), "ok": True}]}
    assert harness.load_reader("pass_host_ms.megamesh")(rec) is None
    assert harness.load_reader("render_phase_ms.megamesh")(
        dict(rec, renders=[dict(rec["renders"][0], phase_s=0.01)])) \
        == pytest.approx(10.0)


def test_the_mesh_reference_loads_nothing_of_the_renderer():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    script = (f"import sys; sys.path[:0] = [{BENCH!r}]\n"
              "import reference.mesh\n"
              "import json; print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], cwd=BENCH, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "reference" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "nrenderer_tpu",
                         "nrenderer_torch"}


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9])
def test_bfloat16_fails_and_float32_passes(seed):
    spec = _small(size=32, spp=32, depth=6)
    spec["traffic"]["check"] = dict(spec["traffic"]["check"], pixels=128)
    correct, shown = control.control_run(spec, seed, 4, "cpu",
                                         torch.bfloat16)
    assert not correct, shown
    assert any(shown[k]["value"] > limit
               for k, limit in spec["traffic"]["limits"].items()), shown
    correct, shown = control.control_run(spec, seed, 4, "cpu",
                                         torch.float32)
    assert correct and shown["max_gap"]["value"] == 0.0, shown


def test_roofline_counts_are_frozen():
    import chip_smoke
    counts = {"spheres": 0, "triangles": 0, "planes": 5, "lights": 1,
              "mesh_triangles": 5120}
    assert roofline_mesh.FLOPS_BOX == chip_smoke.FLOPS_SLAB == 26
    # 6 patches x 38 + the scatter 80 + 40 boxes x 26 + 128 tests x 52
    assert roofline_mesh.flops_per_bounce_mesh(counts) == 8004
    assert roofline_mesh.flops_per_bounce_mesh(
        dict(counts, mesh_triangles=960)) == 308 + 8 * 26 + 128 * 52
    assert roofline_mesh.flops_per_bounce_mesh(
        dict(counts, triangles=4, mesh_triangles=60)) == 308 + 26 + 64 * 52
    flops, n_bytes = roofline_mesh.render_work(
        counts, 82395, 500 * 500, 256, 6.5, 8)
    assert flops == 500 * 500 * 256 * (40 + 6.5 * 8004)
    assert n_bytes == 8 * (2 * 500 * 500 * 12 + 82395 * 4)


def test_roofline_reads_under_a_hundred_on_a_recorded_time():
    """B1e on the cell, one H100 at 700 W (a traced 8 s run of the cell):
    112 launches in 14 renders took 5.2929 s of device time, at 6.92
    bounces a sample by the reference's count."""
    counts = {"spheres": 0, "triangles": 0, "planes": 5, "lights": 1,
              "mesh_triangles": 5120}
    flops, n_bytes = roofline_mesh.render_work(
        counts, 82395, 500 * 500, 256, 6.92, 8)
    share = 100.0 * roofline.least_seconds(flops, n_bytes) / (5.2929 / 14)
    assert flops / roofline.PEAK_FP32_OPS > n_bytes / roofline.PEAK_HBM_BYTES
    assert 10.0 < share < 100.0
