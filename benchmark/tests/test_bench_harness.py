"""The benchmark's files: every name and unit in `BENCHMARK.json` and every
file under `configs/`, `traffic/` and `metrics/` parses and keeps to the
naming rules; every per-layer metric moves an end-to-end metric that each
of its cells reports; the cells' commands are as they were; and a new
configuration (with OBJ files and a reference of its own), traffic mix,
cell and metric are picked up from new files alone."""
import json
import re
import shutil
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

import pytest  # noqa: E402

import harness  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "cell": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_shape_and_names():
    assert set(SPEC) == KEYS["top"]
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"][1:] == ["benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = []
    for c in SPEC["configs"]:
        assert set(c) == KEYS["config"]
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/") and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == KEYS["cell"]
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["e2e"]
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock",
                                                          "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"]
        assert _line(m["layer"]) and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        names.append(m["name"])
    assert len(names) == len(set(names))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_files_parse():
    for sub in ("configs", "traffic"):
        for path in (BENCH / sub).iterdir():
            assert NAME.match(path.stem), path
            json.loads(path.read_text())
    for path in (BENCH / "metrics").iterdir():
        if path.suffix == ".py":
            assert NAME.match(path.stem), path
            compile(path.read_text(), str(path), "exec")
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (ROOT / cfg["scene"]).is_file()
        assert cfg["estimator"] in ("diffuse", "bsdf")
        files = cfg.get("obj", []) + ([cfg["env_map"]] if "env_map" in cfg
                                      else [])
        for path in files:
            assert (ROOT / path).is_file(), path
        ref = cfg.get("reference", "analytic")
        assert (BENCH / "reference" / f"{ref}.py").is_file(), ref
    for w in SPEC["workloads"]:
        t = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                       .read_text())
        assert set(t["limits"]) == {"max_gap", "mismatch_share"}


def test_every_metric_has_a_reader_and_each_cell_reports_enough():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
    for w in SPEC["workloads"]:
        spec = harness.load_spec(w["name"])
        reported = {m["name"] for m in spec["end_to_end"]}
        assert "setup_s" in reported and len(reported) >= 2
        assert spec["per_layer"]
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", [w["name"] for w in
                                         SPEC["workloads"]]):
            assert cell in e2e[m["moves"]].get("workloads", [cell]), (
                m["name"], cell)


@pytest.mark.parametrize("cell,scene,renderer", [
    ("cornell.final", "cornell_box.scn", "SimplePathTracer"),
    ("glass.final", "pt_glass_box.scn", "AccPathTracer")])
def test_cells_commands_are_frozen(cell, scene, renderer):
    argv = harness.cli_argv(harness.load_spec(cell), 2 ** 31 + 1, "o.png",
                            "cuda")
    assert argv == ["render", "--scene", f"{ROOT}/benchmark/scenes/{scene}",
                    "--renderer", renderer, "--width", "512", "--height",
                    "512", "--spp", "2048", "--depth", "20", "--seed",
                    "2147483649", "--out", "o.png", "--device", "cuda"]


# a mesh configuration's reference of its own, as a new file: its tables,
# counts and (black) pixels mark what went through it
STUB_REFERENCE = """
import numpy as np


def load(config, root):
    return {"faces": 960 * len(config["obj"])}


def counts(tables):
    return {"spheres": 0, "triangles": tables["faces"], "planes": 5,
            "lights": 1}


def table_floats(tables):
    return 4242


def render_pixels(tables, config, traffic, ids, seed, device, dtype, stats):
    if stats is not None:
        stats["stub_renders"] = stats.get("stub_renders", 0) + 1
    return np.zeros((len(ids), 3), np.uint8)
"""


def test_new_files_are_picked_up_without_editing_any(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    for path in ("resource/mesh_box.scn", "resource/obj/blob_960.obj"):
        (root / path).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(ROOT / path, root / path)
    before = {p: p.read_bytes() for d in ("benchmark", "resource")
              for p in (root / d).rglob("*") if p.is_file()}
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "cornell.json").read_text())
    cfg["name"] = "cornell2"
    (b / "configs" / "cornell2.json").write_text(json.dumps(cfg))
    tr = json.loads((b / "traffic" / "final.json").read_text())
    tr.update(width=128, height=128, spp=16)
    (b / "traffic" / "tiny.json").write_text(json.dumps(tr))
    (b / "metrics" / "renders_done.tiny.py").write_text(
        "def read(rec):\n    return float(len(rec['renders']))\n")
    glass = json.loads((b / "configs" / "glass.json").read_text())
    mesh = dict(glass, name="mesh", scene="resource/mesh_box.scn",
                obj=["resource/obj/blob_960.obj"], reference="stub_mesh")
    (b / "configs" / "mesh.json").write_text(json.dumps(mesh))
    (b / "reference" / "stub_mesh.py").write_text(STUB_REFERENCE)
    tr = dict(tr, width=16, height=16, spp=2, depth=4,
              check=dict(tr["check"], every=1, renders=2, pixels=256))
    (b / "traffic" / "meshtiny.json").write_text(json.dumps(tr))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "cornell2", "source": "a copy",
                            "file": "benchmark/configs/cornell2.json",
                            "reduced": [], "why": "a test"})
    spec["configs"].append({"name": "mesh", "source": "a test",
                            "file": "benchmark/configs/mesh.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "cornell2.tiny", "config": "cornell2",
                              "traffic": "tiny", "chips": 1, "why": "a test"})
    spec["workloads"].append({"name": "mesh.tiny", "config": "mesh",
                              "traffic": "meshtiny", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "tiny_s", "unit": "s",
                               "better": "lower", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["cornell2.tiny"]})
    spec["per_layer"].append({"name": "renders_done.tiny", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "host around the render",
                              "moves": "tiny_s",
                              "workloads": ["cornell2.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    got = harness.load_spec("cornell2.tiny", root=root)
    assert got["config"]["name"] == "cornell2"
    assert got["traffic"]["width"] == 128
    assert sorted(m["name"] for m in got["end_to_end"]) == ["setup_s",
                                                            "tiny_s"]
    assert [m["name"] for m in got["per_layer"]] == ["renders_done.tiny"]
    read = harness.load_reader("renders_done.tiny", bench=b)
    assert read({"renders": [1, 2, 3]}) == 3.0
    # the mesh cell: its OBJ on the command line right after the scene,
    # its own reference behind the check and the record's tables
    monkeypatch.setattr(harness, "ROOT", root)
    got = harness.load_spec("mesh.tiny", root=root)
    argv = harness.cli_argv(got, 1, "o.png", "cpu")
    assert argv[1:5] == ["--scene", f"{root}/resource/mesh_box.scn",
                         "--obj", f"{root}/resource/obj/blob_960.obj"]
    assert "--env-map" not in argv
    result = harness.run_cell(got, 2 ** 31 + 41, 0.3, False,
                              time.perf_counter(), device="cpu")
    rec = result["_record"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert rec["tables"] == {"counts": {"spheres": 0, "triangles": 960,
                                        "planes": 5, "lights": 1},
                             "floats": 4242}
    assert rec["work"]["stub_renders"] >= 1
    assert result["checked"]["max_gap"]["value"] > 0 and not result["correct"]
    # the old cells read as before, and no file that was there changed
    assert harness.load_spec("cornell.final", root=root)["per_layer"] == \
        harness.load_spec("cornell.final")["per_layer"]
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_refuses_an_unknown_cell(capsys):
    assert harness.main(["--workload", "no.such", "--seed", "1",
                         "--seconds", "1"], 0.0) == 2
    assert capsys.readouterr().out == ""
