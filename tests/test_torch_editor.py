"""The port's scene editor, builder, templates and live viewer
(`server/editor.py`, `scene/builder.py`, `scene/templates.py`,
`server/viewer.py`, copies of the JAX package's modules) against the JAX
package's, and the `edit` and `render --serve` commands end to end.

The JAX suite's editor cases (tests/test_editor.py, which load scenes that
are not in the repository) are rebuilt on `resource/cornell_box.scn` with a
point light added: each case runs the same document edits through both
editors, and the two `scene_doc` results must be equal JSON (with the same
changed paths, or both raising `EditError`).  The HTTP surfaces run on
localhost."""
import importlib
import json
import pathlib
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import nrenderer_torch as P
from nrenderer_torch.io.image import encode_png, read_png, write_png
from nrenderer_torch.scene.model import NodeType, PropertyType
from nrenderer_torch.server.editor import (
    EditError, SceneEditor, apply_doc, scene_doc,
)
from nrenderer_torch.server.screen import Screen
from nrenderer_torch.server.viewer import ScreenViewer

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
CORNELL = REPO / "resource" / "cornell_box.scn"


def _cornell(mod):
    s = mod.load_scn(str(CORNELL))
    s.point_light_buffer.append(mod.PointLight(position=(0.0, 250.0, 1028.0),
                                               intensity=(1.0, 1.0, 1.0)))
    s.lights.append(mod.Light(name="Point", type=mod.LightType.POINT,
                              entity=0))
    return s


@pytest.fixture()
def cornel():
    return _cornell(P)


# ---------------------------------------------------------------------------
# the same edits through both editors
# ---------------------------------------------------------------------------

def _first_diffuse(doc):
    return next(i for i, m in enumerate(doc["materials"])
                if "diffuseColor" in m["properties"])


def _case_roundtrip(ed, s):
    return [ed.apply_doc(s, json.loads(json.dumps(ed.scene_doc(s))))]


def _case_camera_option(ed, s):
    doc = ed.scene_doc(s)
    doc["camera"]["fov"] = 55.0
    doc["camera"]["position"] = [0.0, 1.0, 9.0]
    doc["render_option"]["samples_per_pixel"] = 4
    return [ed.apply_doc(s, doc)]


def _case_material_prop(ed, s):
    doc = ed.scene_doc(s)
    doc["materials"][_first_diffuse(doc)]["properties"]["diffuseColor"] = \
        [0.9, 0.1, 0.2]
    return [ed.apply_doc(s, doc)]


def _case_add_remove_prop(ed, s):
    doc = ed.scene_doc(s)
    doc["materials"][0]["properties"]["roughness"] = 0.25
    out = [ed.apply_doc(s, doc)]
    doc = ed.scene_doc(s)
    doc["materials"][0]["properties"]["roughness"] = None
    return out + [ed.apply_doc(s, doc)]


def _case_partial(ed, s):
    return [ed.apply_doc(s, {"camera": {"aperture": 0.5}})]


def _case_light_edit(ed, s):
    doc = ed.scene_doc(s)
    out = []
    for kind in ("area", "point"):
        field = next(iter(doc["lights"][kind][0]))
        val = doc["lights"][kind][0][field]
        doc["lights"][kind][0][field] = ([v + 0.5 for v in val]
                                         if isinstance(val, list)
                                         else val + 0.5)
        out.append(ed.apply_doc(s, doc))
    return out


def _case_add_sphere(ed, s):
    n = len(s.sphere_buffer)
    return [ed.apply_doc(s, {"spheres": [{} for _ in range(n)] + [
        {"position": [1.0, 2.0, 3.0], "radius": 0.5, "material": 0,
         "model": 0, "name": "ball"}]})]


def _case_add_point_light(ed, s):
    n = len(s.point_light_buffer)
    return [ed.apply_doc(s, {"lights": {"point": [{} for _ in range(n)] + [
        {"intensity": [2.0, 2.0, 2.0], "position": [0.0, 1.0, 0.0]}]}})]


def _case_optional_knob(ed, s):
    return [ed.apply_doc(s, {"render_option": {"roughness": 0.4}}),
            ed.apply_doc(s, {"render_option": {"roughness": None}})]


def _case_remove_sphere(ed, s):
    ns = len(s.sphere_buffer)
    return [ed.apply_doc(s, {"spheres": [None] + [{}] * (ns - 1)})]


def _case_remove_lights(ed, s):
    return [ed.apply_doc(s, {"lights": {"area": [None]}}),
            ed.apply_doc(s, {"lights": {"point": [None]}})]


def _case_template_material(ed, s):
    n = len(s.materials)
    return [ed.apply_doc(s, {"materials": [{}] * n + [
        {"template": "Dielectric", "name": "glassy",
         "properties": {"ior": 1.33}}]}),
        ed.apply_doc(s, {"materials": [{}] * n + [None]})]


def _case_renumber(ed, s):
    n = len(s.materials)
    out = [ed.apply_doc(s, {"materials": [{}] * n + [
        {"template": "Lambertian", "name": "tmp"},
        {"template": "Conductor", "name": "shiny"}]})]
    ns = len(s.sphere_buffer)
    out.append(ed.apply_doc(s, {"spheres": [{}] * ns + [
        {"radius": 1.0, "material": n + 1}]}))
    out.append(ed.apply_doc(s, {"materials": [{}] * n + [None, {}]}))
    return out


def _case_add_edit_remove(ed, s):
    ns, nm = len(s.sphere_buffer), len(s.materials)
    return [
        ed.apply_doc(s, {"materials": [{}] * nm + [
            {"template": "Conductor", "name": "chrome"}]}),
        ed.apply_doc(s, {"spheres": [{}] * ns + [
            {"position": [0.0, 0.0, 5.0], "radius": 0.5, "material": nm}]}),
        ed.apply_doc(s, {"spheres": [{}] * ns + [{"radius": 0.75}]}),
        ed.apply_doc(s, {"spheres": [{}] * ns + [None]}),
        ed.apply_doc(s, {"materials": [{}] * nm + [None]})]


def _case_ambient(ed, s):
    return [ed.apply_doc(s, {"ambient": {"constant": [0.1, 0.2, 0.3]}})]


def _bad(doc_fn):
    def case(ed, s):
        with pytest.raises(ed.EditError):
            ed.apply_doc(s, doc_fn(ed, s))
        return []
    return case


def _bad_binding(ed, s):
    doc = ed.scene_doc(s)
    doc["triangles"][0]["material"] = 999
    return doc


CASES = {
    "roundtrip_noop": _case_roundtrip,
    "camera_and_option": _case_camera_option,
    "material_property": _case_material_prop,
    "add_remove_property": _case_add_remove_prop,
    "partial_doc": _case_partial,
    "light_edit": _case_light_edit,
    "add_sphere": _case_add_sphere,
    "add_point_light": _case_add_point_light,
    "optional_knob": _case_optional_knob,
    "remove_sphere": _case_remove_sphere,
    "remove_lights": _case_remove_lights,
    "template_material": _case_template_material,
    "material_renumbering": _case_renumber,
    "add_edit_remove": _case_add_edit_remove,
    "ambient": _case_ambient,
    "bad_vec3_arity": _bad(lambda ed, s: {"camera": {"position": [1., 2.]}}),
    "bad_ambient_enum": _bad(lambda ed, s: {"ambient": {"type": "NOPE"}}),
    "bad_binding": _bad(_bad_binding),
    "entity_needs_material": _bad(lambda ed, s: {"spheres": [{}] * len(
        s.sphere_buffer) + [{"radius": 1.0}]}),
    "remove_list_rejected": _bad(lambda ed, s: {"triangles": []}),
    "bad_material_type": _bad(lambda ed, s: {"materials": [
        {"type": "not-an-int"}] + [{}] * (len(s.materials) - 1)}),
    "bad_model_index": _bad(lambda ed, s: {"spheres": [{}] * len(
        s.sphere_buffer) + [{"radius": 1.0, "material": 0,
                             "model": "zero"}]}),
    "remove_bound_material": _bad(lambda ed, s: {"materials": [None] + [
        {}] * (len(s.materials) - 1)}),
    "unknown_template": _bad(lambda ed, s: {"materials": [{}] * len(
        s.materials) + [{"template": "Nope"}]}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_edits_match_jax_editor(case):
    pytest.importorskip("jax")
    import nrenderer_tpu as T
    out = {}
    for mod in (P, T):
        ed = importlib.import_module(mod.__name__ + ".server.editor")
        s = _cornell(mod)
        changed = CASES[case](ed, s)
        out[mod.__name__] = (changed, json.dumps(ed.scene_doc(s),
                                                 sort_keys=True))
        # the edited scene still flattens
        mod.build_scene_arrays(s)
    assert out["nrenderer_torch"] == out["nrenderer_tpu"]
    if case == "roundtrip_noop":
        assert out["nrenderer_torch"][0] == [[]]


def test_edit_results(cornel):
    """Spot checks of what the edits do to the port's Scene."""
    doc = scene_doc(cornel)
    assert doc["camera"]["fov"] == cornel.camera.fov
    assert len(doc["triangles"]) == len(cornel.triangle_buffer)
    assert doc["ambient"]["type"] in ("CONSTANT", "ENVIRONMENT_MAP")
    _case_camera_option(importlib.import_module(
        "nrenderer_torch.server.editor"), cornel)
    assert cornel.camera.position == (0.0, 1.0, 9.0)
    assert isinstance(cornel.camera.position, tuple)
    idx = _first_diffuse(doc)
    doc["materials"][idx]["properties"]["diffuseColor"] = [0.9, 0.1, 0.2]
    apply_doc(cornel, doc)
    prop = next(p for p in cornel.materials[idx].properties
                if p.key == "diffuseColor")
    assert prop.type == PropertyType.RGB and prop.value == (0.9, 0.1, 0.2)
    ns, nn = len(cornel.sphere_buffer), len(cornel.nodes)
    assert apply_doc(cornel, {"spheres": [None] + [{}] * (ns - 1)}) == \
        ["spheres[0] (removed)"]
    ents = sorted(nd.entity for nd in cornel.nodes
                  if nd.type is NodeType.SPHERE)
    assert ents == list(range(len(cornel.sphere_buffer))) == \
        list(range(ns - 1))
    assert len(cornel.nodes) == nn - 1
    for mdl in cornel.models:
        assert all(0 <= k < len(cornel.nodes) for k in mdl.nodes)
    with pytest.raises(EditError):   # env-map ambient without a map
        apply_doc(P.Scene(), {"ambient": {"type": "ENVIRONMENT_MAP"}})


def test_snapshot_is_isolated(cornel):
    ed = SceneEditor(cornel)
    snap, v0 = ed.snapshot()
    assert snap is not cornel
    old_fov = cornel.camera.fov
    apply_doc(cornel, {"camera": {"fov": old_fov + 5.0}})
    assert snap.camera.fov == old_fov
    assert cornel.camera.fov == old_fov + 5.0


def test_texture_import(cornel, tmp_path):
    png = tmp_path / "tex.png"
    write_png(str(png), np.full((4, 4, 3), 0.5, np.float32))
    nt = len(cornel.textures)
    doc = scene_doc(cornel)
    doc["textures"].append({"name": "mytex", "path": str(png)})
    assert apply_doc(cornel, doc) == [f"textures[{nt}] (imported)"]
    t = cornel.textures[-1]
    assert t.name == "mytex" and t.pixels.shape == (4, 4, 4)
    with pytest.raises(EditError):
        apply_doc(cornel, {"textures": [{}] * (nt + 1)
                           + [{"name": "x", "path": str(tmp_path / "no")}]})


# ---------------------------------------------------------------------------
# builder and templates (tests/test_builder.py)
# ---------------------------------------------------------------------------

GOOD = """Begin Material
Material A
Prop diffuseColor RGB 1 0 0
End
Begin Model
Model M
Sphere S A
R 5
End
"""


def test_builder_and_templates():
    s = P.parse_scn(GOOD)
    assert P.validate_scene(s) == []
    snap = P.build_scene(s)
    assert snap is not s and len(snap.sphere_buffer) == 1
    s.sphere_buffer[0].radius = 999.0
    assert snap.sphere_buffer[0].radius == pytest.approx(5.0)
    s.sphere_buffer[0].material = 99
    problems = P.validate_scene(s)
    assert len(problems) == 1 and "out of range" in problems[0]
    s.sphere_buffer[0].material = -1
    with pytest.raises(P.SceneBuildError, match="no material"):
        P.build_scene(s)
    assert set(P.template_names()) == {"Lambertian", "Phong", "Dielectric",
                                       "Conductor", "Plastic"}
    m = P.make_material("Dielectric", "Glass2")
    assert m.type == 2 and m.get_property("ior") == pytest.approx(1.5)
    assert not m.register_property(P.Property("ior", P.PropertyType.FLOAT,
                                              2.0))


def test_builder_and_templates_match_jax():
    pytest.importorskip("jax")
    import nrenderer_tpu as T
    from nrenderer_tpu.server.editor import scene_doc as jax_doc
    assert P.template_names() == T.template_names()
    props = lambda m: (m.type, [(p.key, p.type.name, p.value)
                                for p in m.properties])
    for name in P.template_names():
        assert props(P.make_material(name, "x")) == \
            props(T.make_material(name, "x"))
    out = []
    for mod, doc in ((P, scene_doc), (T, jax_doc)):
        s = _cornell(mod)
        snap = json.dumps(doc(mod.build_scene(s)), sort_keys=True)
        s.sphere_buffer[0].material = 99
        s.triangle_buffer[0].material = -1
        out.append((mod.validate_scene(s), snap))
    assert out[0] == out[1]
    assert len(out[0][0]) == 2


# ---------------------------------------------------------------------------
# viewer and the HTTP surfaces (tests/test_viewer.py, tests/test_editor.py)
# ---------------------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read()


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_viewer_serves_frames_and_log(tmp_path):
    from nrenderer_torch.server.registry import get_server
    screen = Screen()
    viewer = ScreenViewer(screen, port=0, state_fn=lambda: "RUNNING").start()
    try:
        st = json.loads(_get(viewer.url + "status")[1])
        assert st["frame"] == 0 and st["state"] == "RUNNING"
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(viewer.url + "frame.png")
        assert e.value.code == 404
        img1 = np.zeros((8, 12, 3), np.float32)
        img1[:, :6] = (1.0, 0.0, 0.0)
        screen.set(img1, 12, 8)
        st = json.loads(_get(viewer.url + "status")[1])
        assert st["frame"] == 1 and (st["width"], st["height"]) == (12, 8)
        p = tmp_path / "f.png"
        p.write_bytes(_get(viewer.url + "frame.png")[1])
        decoded = read_png(str(p))
        assert decoded.shape == (8, 12, 3)
        assert decoded[0, 0, 0] > 0.9 and decoded[0, 11, 0] < 0.1
        screen.set(np.ones((8, 12, 3), np.float32), 12, 8)
        assert json.loads(_get(viewer.url + "status")[1])["frame"] == 2
        assert json.loads(_get(viewer.url + "status")[1])["frame"] == 2
        assert b"frame.png" in _get(viewer.url)[1]
        logger = get_server().logger
        logger.clear()
        logger.warning("wavefront stalled")
        logger.success("pass 1 done")
        entries = json.loads(_get(viewer.url + "log")[1])
        assert [e["type"] for e in entries[-2:]] == ["WARNING", "SUCCESS"]
        assert entries[-1]["content"] == "pass 1 done"
    finally:
        viewer.stop()
        get_server().logger.clear()
    rgb = np.random.default_rng(0).random((5, 7, 3)).astype(np.float32)
    p = tmp_path / "x.png"
    p.write_bytes(encode_png(rgb))
    np.testing.assert_allclose(read_png(str(p)), rgb, atol=1.0 / 255.0)


def test_editor_http_surface(cornel):
    editor = SceneEditor(cornel)
    viewer = ScreenViewer(Screen(), port=0, routes=editor.routes).start()
    try:
        assert b"apply + re-render" in _get(viewer.url)[1]
        payload = json.loads(_get(viewer.url + "scene")[1])
        assert payload["version"] == 0
        doc = payload["doc"]
        doc["camera"]["fov"] = 33.0
        code, body = _post(viewer.url + "scene", json.dumps(doc).encode())
        assert code == 200
        resp = json.loads(body)
        assert resp["changed"] == ["camera.fov"] and resp["version"] == 1
        assert cornel.camera.fov == 33.0
        assert editor.wait_dirty(timeout=1.0)
        code, body = _post(viewer.url + "scene", json.dumps(doc).encode())
        assert json.loads(body)["changed"] == []
        assert not editor.wait_dirty(timeout=0.1)
        code, body = _post(viewer.url + "scene", b"{nope")
        assert code == 400 and b"bad JSON" in body
        code, body = _post(viewer.url + "scene",
                           json.dumps({"camera": {"fov": [1, 2]}}).encode())
        assert code == 400
    finally:
        viewer.stop()


def _wait_frame(url, above, timeout=120):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            st = json.loads(_get(url + "status")[1])
            if st["frame"] > above:
                return st["frame"]
        except OSError:
            pass
        time.sleep(0.2)
    pytest.fail(f"no frame past {above} at {url}")


class _Stderr:
    """A child process's stderr lines, read on a thread."""

    def __init__(self, proc):
        self.lines = []
        self._t = threading.Thread(target=self._read, args=(proc,),
                                   daemon=True)
        self._t.start()

    def _read(self, proc):
        for line in proc.stderr:
            self.lines.append(line)

    def wait_for(self, pattern, count=1, timeout=120):
        """The first match of `pattern` once `count` lines match it."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            hits = [m for m in map(re.compile(pattern).search,
                                   list(self.lines)) if m]
            if len(hits) >= count:
                return hits[0]
            time.sleep(0.1)
        pytest.fail(f"no {count} x {pattern!r} in {''.join(self.lines)}")


def _child(args):
    return subprocess.Popen([sys.executable, "-m", "nrenderer_torch", *args],
                            cwd=REPO, stderr=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True)


def _interrupt(proc):
    """Ctrl-C the child; it must exit 0."""
    try:
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("renderer", ["RayCast", "SimplePathTracer"])
def test_edit_loop_rerenders(tmp_path, renderer):
    """Drive `nrenderer_torch edit` like a browser: wait for the rendered
    frame (after the GeometryPreview), flip every diffuse colour to white
    and add a point light (cornell_box.scn has none, so RayCast's first
    frame is black) over POST /scene, and check that the re-rendered frame
    is brighter."""
    from nrenderer_torch.io.image import decode_png
    out = tmp_path / "edit.png"
    proc = _child(["edit", "--scene", str(CORNELL), "--renderer", renderer,
                   "--width", "24", "--height", "24", "--spp", "8",
                   "--depth", "3", "--device", "cpu", "--out", str(out)])
    try:
        err = _Stderr(proc)
        url = err.wait_for(r"editor: (http://localhost:\d+/)").group(1)
        err.wait_for(r"preview v0 in")
        err.wait_for(r"rendered scene v0 in")
        _, f1 = _get(url + "frame.png")
        doc = json.loads(_get(url + "scene")[1])["doc"]
        for m in doc["materials"]:
            if "diffuseColor" in m["properties"]:
                m["properties"]["diffuseColor"] = [1.0, 1.0, 1.0]
        doc["lights"]["point"] = [{"intensity": [1.0, 1.0, 1.0],
                                   "position": [0.0, 250.0, 1028.0]}]
        code, body = _post(url + "scene", json.dumps(doc).encode())
        assert code == 200 and "lights.point[0] (added)" in \
            json.loads(body)["changed"]
        err.wait_for(r"rendered scene v1 in")
        _, f2 = _get(url + "frame.png")
        a, b = decode_png(f1), decode_png(f2)
        assert a.shape[:2] == b.shape[:2] == (24, 24)
        assert b.mean() > a.mean()
        assert out.exists()
    finally:
        _interrupt(proc)


def test_render_serve(tmp_path):
    """`render --serve` (progressive for SimplePathTracer) serves the
    previews and then the final frame until interrupted."""
    out = tmp_path / "s.png"
    proc = _child(["render", "--scene", str(CORNELL), "--renderer",
                   "SimplePathTracer", "--width", "16", "--height", "12",
                   "--spp", "4", "--depth", "3", "--device", "cpu",
                   "--serve", "--out", str(out)])
    try:
        err = _Stderr(proc)
        url = err.wait_for(r"live view: (http://localhost:\d+/)").group(1)
        err.wait_for(r"serving final frame")
        st = json.loads(_get(url + "status")[1])
        assert st["frame"] >= 1 and (st["width"], st["height"]) == (16, 12)
        assert out.exists()
    finally:
        _interrupt(proc)
