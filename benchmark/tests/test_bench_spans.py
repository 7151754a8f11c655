"""The metrics read from the program's own spans: a traced run reports
`parse_ms.final`, `scene_prep_ms.final`, `png_ms.final` and
`cli_self_ms.final`, and they with the renderer's `host-post` make up
`host_ms.final` (the harness's span around `cli.main` less the render
phase; argv parsing sits outside `cli.render`).  Small runs on the
renderer's plain versions on the CPU."""
import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import harness  # noqa: E402
import program_spans  # noqa: E402
from cells import spec as cell_spec  # noqa: E402

SPAN_METRICS = ("parse_ms.final", "scene_prep_ms.final", "png_ms.final",
                "cli_self_ms.final")


def _run(cell, seed=2 ** 31 + 29):
    spec = cell_spec(cell)
    t = spec["traffic"]
    t.update(width=32, height=32, spp=16, depth=6)
    t["check"] = dict(t["check"], every=1, renders=2, pixels=32 * 32)
    return harness.run_cell(spec, seed, 0.5, True, time.perf_counter(),
                            device="cpu")


@pytest.mark.parametrize("cell", ["cornell.final", "glass.final"])
def test_span_metrics_make_up_the_host_time(cell):
    result = _run(cell)
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert all(got.get(name) is not None for name in SPAN_METRICS), got
    post = program_spans.span_ms(result["_record"],
                                 lambda name: name.endswith(".host-post"))
    assert post is not None
    parts = sum(got[name] for name in SPAN_METRICS) + post
    host = got["host_ms.final"]
    assert abs(parts - host) <= max(0.05 * host, 2.0), (parts, got)
    assert all(got[name] >= 0.0 for name in SPAN_METRICS)


def test_a_program_without_spans_reads_none(monkeypatch):
    from nrenderer_torch.utils import timing
    rec = {"renders": [{"t0": 0.0, "t1": 1.0, "ok": True}]}
    monkeypatch.setattr(timing, "GLOBAL_TIMER", object())
    assert harness.load_reader("png_ms.final")(rec) is None
    assert harness.load_reader("cli_self_ms.final")(rec) is None


def test_spans_dropped_inside_the_window_read_none(monkeypatch):
    from nrenderer_torch.utils import timing
    timer = timing.PhaseTimer(capacity=2)
    monkeypatch.setattr(timing, "GLOBAL_TIMER", timer)
    read = harness.load_reader("png_ms.final")

    def window(n):
        t0 = time.perf_counter()
        for _ in range(n):
            with timer.phase("cli.png"):
                pass
        return {"renders": [{"t0": t0, "t1": time.perf_counter(),
                             "ok": True}]}

    rec = window(3)
    assert timer.dropped == 1 and read(rec) is None
    # spans dropped before the window began leave it whole
    rec = window(1)
    assert timer.dropped == 2 and read(rec) is not None
