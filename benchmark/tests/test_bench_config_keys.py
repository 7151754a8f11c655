"""The configuration's keys beyond the scene, run through `harness.run_cell`
on the renderer's plain versions at a small size on the CPU: an OBJ named
by `"obj"` reaches the renderer (the megamesh route, which the CPU takes
for pools up to 1024 triangles), the harness's host spans name the OBJ's
parse and the mesh route's render, and a configuration that names its
reference `"analytic"` reads as one that names none."""
import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import check  # noqa: E402
import harness  # noqa: E402
from cells import spec as cell_spec  # noqa: E402
from reference import png  # noqa: E402


def _run(spec, monkeypatch, trace=False, seed=2 ** 31 + 53):
    """`run_cell`'s result and the 8-bit image of the window's first
    render, read before the run deletes it."""
    images = []
    compare = check.compare

    def keep_first(config, traffic, root, seed, renders, *args, **kwargs):
        images.append(png.read(renders[0]["out"]))
        return compare(config, traffic, root, seed, renders, *args, **kwargs)
    monkeypatch.setattr(check, "compare", keep_first)
    result = harness.run_cell(spec, seed, 0.3, trace, time.perf_counter(),
                              device="cpu")
    monkeypatch.setattr(check, "compare", compare)
    return result, images[0]


def _small(cell, **config):
    spec = cell_spec(cell)
    spec["config"].update(config)
    t = spec["traffic"]
    t.update(width=16, height=16, spp=2, depth=4)
    t["check"] = dict(t["check"], every=1, renders=2, pixels=16 * 16)
    return spec


def test_the_obj_reaches_the_renderer(monkeypatch):
    box = {"name": "mesh", "scene": "resource/mesh_box.scn"}
    without, plain = _run(_small("glass.final", **box), monkeypatch)
    mesh = _small("glass.final", obj=["resource/obj/blob_960.obj"], **box)
    result, img = _run(mesh, monkeypatch)
    assert result["failed"] == 0 and result["attempted"] >= 1
    # the same render seeds: only the mesh tells the two images apart
    assert img.shape == plain.shape and (img != plain).any()
    # the analytic reference knows the box alone
    assert without["correct"] and without["checked"]["max_gap"]["value"] == 0
    assert not result["correct"]


def test_spans_name_the_obj_parse_and_the_mesh_route(tmp_path):
    from nrenderer_torch.cli import main
    spans = harness.Spans()
    spans.install()
    try:
        rc = main(["render", "--scene", f"{ROOT}/resource/mesh_box.scn",
                   "--obj", f"{ROOT}/resource/obj/blob_960.obj",
                   "--renderer", "AccPathTracer", "--width", "16",
                   "--height", "16", "--spp", "2", "--depth", "4",
                   "--device", "cpu", "--out", str(tmp_path / "m.png")])
    finally:
        spans.remove()
    assert rc == 0
    assert sorted(name for name, _t0, _t1 in spans.spans) == [
        "parse", "parse", "png", "render", "scene-prep"]


def test_the_analytic_reference_by_name_reads_as_the_default(monkeypatch):
    named, _ = _run(_small("cornell.final", reference="analytic"),
                    monkeypatch)
    default, _ = _run(_small("cornell.final"), monkeypatch)
    assert named["correct"] and default["correct"]
    for name in ("max_gap", "mismatch_share"):
        assert named["checked"][name] == default["checked"][name]
    assert named["checked"]["max_gap"]["value"] == 0
    assert named["_record"]["tables"] == default["_record"]["tables"]
