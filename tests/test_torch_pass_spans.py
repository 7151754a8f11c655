"""The progressive loop's spans inside each pass (`routes.progressive_loop`):
on a megamesh render through `cli.main` on the CPU every `first-pass` and
`render-pass` span holds one `pass-wait` span (the time the host is held
by the device: the next pass's launch through this pass's film's arrival
on the host) and then one `film-add` span (the add into the host sum),
with the command's render id; and the benchmark's
`pass_host_ms.megamesh` reads the render span less those waits."""
import importlib.util
import pathlib
import sys

import pytest
import torch

from nrenderer_torch import cli
from nrenderer_torch.utils.timing import GLOBAL_TIMER

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
BENCH = REPO / "benchmark"


def _render(tmp_path, spp):
    """The spans of one megamesh render of `spp` samples (passes of 32)."""
    argv = ["render", "--scene", str(REPO / "resource/mesh_box.scn"),
            "--obj", str(REPO / "resource/obj/blob_960.obj"), "--renderer",
            "AccPathTracer", "--width", "16", "--height", "16", "--spp",
            str(spp), "--depth", "3", "--device", "cpu", "--out",
            str(tmp_path / "m.png")]
    assert cli.main(argv) == 0
    spans = GLOBAL_TIMER.spans()
    root = next(s for s in reversed(spans) if s.name == "cli.render")
    return root, [s for s in spans if s.render == root.render]


@pytest.mark.parametrize("spp,passes", [(32, 1), (96, 3)])
def test_each_pass_holds_its_wait_and_its_add(spp, passes, tmp_path):
    root, spans = _render(tmp_path, spp)
    render = next(s for s in spans if s.name == "AccPathTracer.render")
    outer = [s for s in spans if s.name in ("AccPathTracer.first-pass",
                                            "AccPathTracer.render-pass")]
    assert [s.name for s in outer] == ["AccPathTracer.first-pass"] + [
        "AccPathTracer.render-pass"] * (passes - 1)
    for name in ("AccPathTracer.pass-wait", "AccPathTracer.film-add"):
        inner = [s for s in spans if s.name == name]
        assert len(inner) == passes
        assert [s.parent for s in inner] == [s.id for s in outer]
        assert all(s.render == root.render for s in inner)
    waits = [s for s in spans if s.name == "AccPathTracer.pass-wait"]
    adds = [s for s in spans if s.name == "AccPathTracer.film-add"]
    for p, w, a in zip(outer, waits, adds):
        assert p.t0 <= w.t0 <= w.t1 <= a.t0 <= a.t1 <= p.t1
        assert p.parent == render.id


def test_pass_host_ms_is_the_render_span_less_its_waits(tmp_path):
    root, spans = _render(tmp_path, 64)
    sys.path.insert(0, str(BENCH))
    try:
        spec = importlib.util.spec_from_file_location(
            "metric_pass_host_ms", BENCH / "metrics/pass_host_ms.megamesh.py")
        metric = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(metric)
        got = metric.read({"renders": [{"t0": root.t0, "t1": root.t1,
                                        "ok": True}]})
    finally:
        sys.path.remove(str(BENCH))
    render = next(s for s in spans if s.name == "AccPathTracer.render")
    waits = [s for s in spans if s.name == "AccPathTracer.pass-wait"]
    assert len(waits) == 2 and waits[0].t1 <= waits[1].t0
    want = (render.t1 - render.t0) - sum(s.t1 - s.t0 for s in waits)
    assert got == pytest.approx(1e3 * want, rel=1e-9, abs=1e-9)
    assert 0.0 <= got < 1e3 * (render.t1 - render.t0)
