"""The large-mesh cell, `largemesh.hybrid`: its spec loads with its
configuration, traffic and metrics; the committed 81,920-face OBJ is the
fixture writer's subdivision-6 icosphere byte for byte; through
`harness.run_cell` on the renderer's plain versions, with a 1,280-face
icosphere in its place so that a test run holds it, it reads `correct`
with `max_gap` 0 and a traced run reports the span metrics;
`roofline_hybrid.py`'s counts on a pool sized by hand; each new reader
reads None on a record without its spans, trace or counts, and the
device readers' arithmetic on a recorded trace; the control's bfloat16
reference comes out not correct."""
import os
import sys
import time

import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT, os.path.join(ROOT, "tools")]

import control  # noqa: E402
import harness  # noqa: E402
import make_mesh_fixtures  # noqa: E402
import roofline  # noqa: E402
import roofline_hybrid  # noqa: E402
from cells import spec as cell_spec  # noqa: E402

CELL = "largemesh.hybrid"
SPAN_METRICS = ("render_phase_ms.hybrid", "wavefront_host_ms.hybrid",
                "scene_prep_ms.hybrid", "bvh_build_ms.hybrid")
# the host layers around the render, read in the cell by the accepted
# metrics whose lists name it
HOST_METRICS = ("host_ms.final", "parse_ms.final", "png_ms.final",
                "cli_self_ms.final")
DEVICE_METRICS = ("mesh_sweep_kernel_roofline",
                  "stream_compact_kernel_roofline", "wavefront_ops_ms.hybrid",
                  "device.idle_pct.hybrid")
COUNTS = {"spheres": 0, "triangles": 0, "planes": 5, "lights": 1,
          "mesh_triangles": 81920}


@pytest.fixture(scope="module")
def ico_1280(tmp_path_factory):
    return str(make_mesh_fixtures.write_icosphere(
        tmp_path_factory.mktemp("ico"), 3))


def _small(obj, size=16, spp=4, depth=20):
    spec = cell_spec(CELL)
    spec["config"]["obj"] = [obj]
    t = spec["traffic"]
    t.update(width=size, height=size, spp=spp, depth=depth)
    t["check"] = dict(t["check"], every=1, renders=2, pixels=size * size)
    return spec


def test_the_cell_is_its_configuration(tmp_path):
    spec = cell_spec(CELL)
    c, t = spec["config"], spec["traffic"]
    assert (c["name"], c["renderer"], c["estimator"], c["reference"],
            c["reduced"]) == ("largemesh", "AccPathTracer", "bsdf", "hybrid",
                              [])
    assert (t["width"], t["height"], t["spp"], t["depth"]) == (
        500, 500, 256, 20)
    assert t["check"] == {"renders": 2, "every": 4, "pixels": 1024}
    assert t["limits"] == {"max_gap": 24, "mismatch_share": 0.1}
    assert spec["cell"]["chips"] == 1
    assert {m["name"] for m in spec["end_to_end"]} == {"render_s",
                                                      "setup_s"}
    assert {m["name"] for m in spec["per_layer"]} == set(
        SPAN_METRICS + HOST_METRICS + DEVICE_METRICS)
    with open(os.path.join(ROOT, c["scene"]), "rb") as a, \
            open(os.path.join(ROOT, "resource/mesh_box.scn"), "rb") as b:
        assert a.read() == b.read()
    with open(os.path.join(ROOT, c["obj"][0]), "rb") as a:
        committed = a.read()
    assert len(committed) == 3_021_090
    with open(make_mesh_fixtures.large_icosphere(6, tmp_path), "rb") as b:
        assert committed == b.read()


def test_the_card_plans_four_staged_chunks():
    from nrenderer_torch import cli
    from nrenderer_torch.renderers import routes
    spec = cell_spec(CELL)
    argv = harness.cli_argv(spec, 2 ** 31 + 1, "o.png", "cuda")
    scene = cli._build_scene(cli._parser().parse_args(argv))
    plan = routes.plan_route(scene, "AccPathTracer", False, "cuda")
    assert plan == routes.Plan("hybrid", "samples", 256, 1, 64)
    assert spec["traffic"]["depth"] >= routes.STAGED_MIN_DEPTH


@pytest.mark.parametrize("seed", [2 ** 31 + 131, 4100000137])
def test_the_cell_is_correct_on_the_plain_versions(ico_1280, seed):
    result = harness.run_cell(_small(ico_1280), seed, 0.3, False,
                              time.perf_counter(), device="cpu")
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert result["correct"], result["checked"]
    assert result["checked"]["max_gap"]["value"] == 0
    assert result["checked"]["mismatch_share"]["value"] == 0
    rec = result["_record"]
    assert rec["tables"]["counts"] == dict(COUNTS, mesh_triangles=1280)
    assert set(rec["work"]) == {"samples", "bounces", "box_rays",
                                "stage_rays"}
    assert set(result["metrics"]) == {"render_s", "setup_s"}


def test_a_traced_run_reads_the_span_metrics(ico_1280):
    result = harness.run_cell(_small(ico_1280), 2 ** 31 + 139, 0.3, True,
                              time.perf_counter(), device="cpu")
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert all(got.get(name) is not None
               for name in SPAN_METRICS + HOST_METRICS), got
    # the host's own work is the render phase less its waits
    assert 0.0 < got["wavefront_host_ms.hybrid"] <= \
        got["render_phase_ms.hybrid"]
    assert got["bvh_build_ms.hybrid"] > 0.0
    # no CUDA kernel here
    assert not set(got) & {"mesh_sweep_kernel_roofline",
                           "stream_compact_kernel_roofline"}


def test_roofline_counts_on_a_pool_by_hand():
    counts = {"spheres": 0, "triangles": 4, "planes": 5, "lights": 1,
              "mesh_triangles": 300}
    # 304 triangles: 3 blocks' boxes and one block's 128 tests
    assert roofline_hybrid.sweep_flops_per_ray(counts) == 3 * 26 + 128 * 52
    assert roofline_hybrid.sweep_flops_per_ray(COUNTS) == \
        640 * 26 + 128 * 52
    flops, n_bytes = roofline_hybrid.sweep_work(counts, 10, 2, 1.5)
    assert (flops, n_bytes) == (30 * 6734, 30 * 13 * 4)
    # pipe: 30 rays in and out (7 + 6 floats, twice); stages: 10 ray
    # crossings of 10 + 3 floats, twice
    assert roofline_hybrid.compact_bytes(10, 2, 1.5, 0.5) == \
        4 * (30 * 26 + 10 * 26)


def _record(ops=None, work=None):
    return {"renders": [{"t0": 0.0, "t1": 1.0, "ok": True, "kept": True}],
            "window_start": 0.0, "trace": (
                None if ops is None else
                {"busy_s": 0.5, "window_s": 1.0, "ops": ops, "idle": {}}),
            "work": work or {}, "traffic": {"width": 500, "height": 500,
                                            "spp": 256},
            "tables": {"counts": COUNTS, "floats": 0}}


def test_readers_without_spans_trace_or_counts_read_none(monkeypatch):
    from nrenderer_torch.utils import timing
    monkeypatch.setattr(timing, "GLOBAL_TIMER", timing.PhaseTimer())
    for name in SPAN_METRICS + DEVICE_METRICS:
        assert harness.load_reader(name)(_record()) is None, name
    # a render phase without count waits: a program without those spans
    timer = timing.PhaseTimer()
    monkeypatch.setattr(timing, "GLOBAL_TIMER", timer)
    t0 = time.perf_counter()
    with timer.phase("cli.render", root=True):
        with timer.scope("AccPathTracer").phase("render"):
            pass
    rec = dict(_record(), renders=[{"t0": t0, "t1": time.perf_counter(),
                                    "ok": True}])
    assert harness.load_reader("wavefront_host_ms.hybrid")(rec) is None
    # a trace without the hand-written kernels, or no reference counts
    ops = {"void at::native::elementwise_kernel<...>": 0.2,
           "Memcpy HtoD (Pageable -> Device)": 0.01}
    for name in ("mesh_sweep_kernel_roofline",
                 "stream_compact_kernel_roofline"):
        assert harness.load_reader(name)(_record(ops, {
            "samples": 1, "box_rays": 1})) is None
        assert harness.load_reader(name)(_record(
            {"mesh_sweep_kernel": 0.1, "stream_pack_kernel": 0.1})) is None


def test_device_readers_on_a_recorded_trace():
    ops = {"mesh_sweep_kernel(float const*, int)": 0.25,
           "stream_pack_kernel(int const* const*)": 0.03,
           "stream_unpack_kernel(float const*)": 0.02,
           "void at::native::elementwise_kernel<...>": 2.0,
           "void at::native::reduce_kernel<...>": 0.5,
           "Memcpy DtoH (Device -> Pageable)": 0.1,
           "Memset (Device)": 0.01}
    work = {"samples": 1000, "bounces": 6000, "box_rays": 1300,
            "stage_rays": 650}
    rec = _record(ops, work)
    read = lambda name: harness.load_reader(name)(rec)
    samples = 500 * 500 * 256
    flops = samples * 1.3 * (640 * 26 + 128 * 52)
    assert read("mesh_sweep_kernel_roofline") == pytest.approx(
        100.0 * flops / roofline.PEAK_FP32_OPS / 0.25)
    n_bytes = 4 * samples * (1.3 * 26 + 0.65 * 26)
    assert read("stream_compact_kernel_roofline") == pytest.approx(
        100.0 * n_bytes / roofline.PEAK_HBM_BYTES / 0.05)
    assert read("wavefront_ops_ms.hybrid") == pytest.approx(2500.0)
    assert read("device.idle_pct.hybrid") == pytest.approx(50.0)


def test_the_hybrid_reference_loads_nothing_of_the_renderer():
    import json
    import subprocess
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    script = (f"import sys; sys.path[:0] = [{BENCH!r}]\n"
              "import reference.hybrid, roofline_hybrid\n"
              "import json; print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], cwd=BENCH, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "reference" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "nrenderer_tpu",
                         "nrenderer_torch"}


@pytest.mark.parametrize("seed", [7, 2 ** 31 + 149])
def test_bfloat16_fails_and_float32_passes(ico_1280, seed):
    spec = _small(ico_1280, size=32, spp=8, depth=20)
    spec["traffic"]["check"] = dict(spec["traffic"]["check"], pixels=128)
    correct, shown = control.control_run(spec, seed, 4, "cpu",
                                         torch.bfloat16)
    assert not correct, shown
    assert any(shown[k]["value"] > limit
               for k, limit in spec["traffic"]["limits"].items()), shown
    correct, shown = control.control_run(spec, seed, 4, "cpu",
                                         torch.float32)
    assert correct and shown["max_gap"]["value"] == 0.0, shown
