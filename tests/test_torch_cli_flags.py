"""The port's CLI surface against the JAX package's: the camera and ambient
flags (`--camera-position`, `--camera-look-at`, `--fov`, `--aperture`,
`--ambient`) build the same Scene as JAX's `_build_scene`, field by field;
`list-renderers` prints the same six renderers in the same order;
SimplePathTracer takes `--progressive` and `--checkpoint`; the new routes
(RayCast, GeometryPreview, Example, the progressive route, `edit`'s
modules) load no JAX."""
import argparse
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from nrenderer_torch import cli
from nrenderer_torch.io.image import read_png

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SCENE = str(REPO / "resource" / "cornell_box.scn")
SMALL = ["--scene", SCENE, "--width", "16", "--height", "12", "--spp", "4",
         "--depth", "3", "--device", "cpu"]
FLAGS = ["--camera-position", "10", "20", "-5", "--camera-look-at", "1",
         "2", "1000", "--fov", "55", "--aperture", "12.5", "--ambient",
         "0.1", "0.2", "0.3"]


def _captured_scene(monkeypatch, argv):
    """(args, Scene) that `cli.main(argv)` builds; the render still runs."""
    seen = {}
    real = cli._build_scene

    def capture(args):
        seen["args"], seen["scene"] = args, real(args)
        return seen["scene"]

    monkeypatch.setattr(cli, "_build_scene", capture)
    assert cli.main(argv) == 0
    return seen["args"], seen["scene"]


@pytest.mark.parametrize("flags", [FLAGS, FLAGS[:4], FLAGS[10:12], []],
                         ids=["all", "position", "aperture", "none"])
def test_camera_flags_match_jax_build_scene(monkeypatch, tmp_path, flags):
    pytest.importorskip("jax")
    from nrenderer_tpu import cli as jax_cli
    args, scene = _captured_scene(monkeypatch, [
        "render", *SMALL, "--renderer", "RayCast", *flags, "--out",
        str(tmp_path / "f.png")])
    want = jax_cli._build_scene(argparse.Namespace(**vars(args)))
    for field in ("position", "look_at", "up", "fov", "aperture",
                  "focus_distance", "aspect"):
        assert getattr(scene.camera, field) == getattr(want.camera, field), \
            field
    assert scene.ambient.constant == want.ambient.constant
    assert scene.ambient.type.name == want.ambient.type.name
    ro, wro = scene.render_option, want.render_option
    assert (ro.width, ro.height, ro.samples_per_pixel, ro.depth) == \
        (wro.width, wro.height, wro.samples_per_pixel, wro.depth)
    if flags == FLAGS:
        assert scene.camera.position == (10.0, 20.0, -5.0)
        assert scene.camera.aperture == 12.5
        assert scene.ambient.constant == (0.1, 0.2, 0.3)


def test_list_renderers_matches_jax(capsys):
    pytest.importorskip("jax")
    from nrenderer_tpu import cli as jax_cli
    assert cli._cmd_list(None) == 0
    port = capsys.readouterr().out.splitlines()
    assert jax_cli._cmd_list(None) == 0
    jax = capsys.readouterr().out.splitlines()
    names = [line.split()[0] for line in port]
    assert names == [line.split()[0] for line in jax]
    assert port == jax
    assert len(names) == 6
    assert {"NR.Render.RayCast", "NR.Render.Example",
            "NR.Render.GeometryPreview"} <= set(names)


def test_checkpoint_and_progressive(tmp_path):
    """`--checkpoint` with SimplePathTracer exits 0 and resumes; a
    one-pass `--progressive` render is the one-shot render."""
    ckpt, a, b, c = (tmp_path / n for n in ("c.npz", "a.png", "b.png",
                                            "c.png"))
    base = ["render", *SMALL, "--renderer", "SimplePathTracer"]
    assert cli.main(base + ["--checkpoint", str(ckpt), "--out", str(a)]) == 0
    assert ckpt.exists() and int(np.load(ckpt)["spp_done"]) == 4
    assert cli.main(base + ["--checkpoint", str(ckpt), "--out", str(b)]) == 0
    assert cli.main(base + ["--progressive", "--out", str(c)]) == 0
    once = tmp_path / "once.png"
    assert cli.main(base + ["--out", str(once)]) == 0
    for p in (a, b, c):
        np.testing.assert_array_equal(read_png(str(p)), read_png(str(once)))


@pytest.mark.parametrize("renderer", ["RayCast", "GeometryPreview",
                                      "Example", "SimplePathTracer"])
def test_new_routes_render(tmp_path, monkeypatch, renderer):
    if renderer == "Example":
        from nrenderer_torch.renderers import example
        monkeypatch.setattr(example.time, "sleep", lambda s: None)
    out = tmp_path / "r.png"
    # the lens focuses at the camera's default focus distance, 0.1: a
    # lens of 0.01 blurs the box by ~0.05 rad
    extra = ["--aperture", "0.01"] if renderer == "SimplePathTracer" \
        else ["--camera-position", "0", "0", "100"]
    assert cli.main(["render", *SMALL, "--renderer", renderer, *extra,
                     "--out", str(out)]) == 0
    img = read_png(str(out))
    assert img.shape == (12, 16, 3) and np.isfinite(img).all()
    if renderer != "RayCast":   # cornell_box.scn has no point light
        assert img.mean() > 0.02


def test_new_routes_load_no_jax(tmp_path):
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from nrenderer_torch import cli\n"
        "from nrenderer_torch.renderers import example\n"
        "example.time.sleep = lambda s: None\n"
        "import nrenderer_torch.server.editor, nrenderer_torch.server.viewer\n"
        f"base = {['render', *SMALL]!r}\n"
        f"out = {str(tmp_path / 'x.png')!r}\n"
        "for r, extra in (('RayCast', []), ('GeometryPreview', []),\n"
        "                 ('Example', []),\n"
        "                 ('SimplePathTracer', ['--progressive',\n"
        "                  '--aperture', '5', '--checkpoint',\n"
        f"                  {str(tmp_path / 'c.npz')!r}])):\n"
        "    assert cli.main(base + ['--renderer', r, '--out', out]\n"
        "                    + extra) == 0, r\n"
        "assert cli.main(['list-renderers']) == 0\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'nrenderer_tpu')))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout


def test_edit_errors_exit_2(tmp_path):
    out = str(tmp_path / "e.png")
    assert cli.main(["edit", "--scene", SCENE, "--renderer", "NoSuch",
                     "--device", "cpu", "--out", out]) == 2
    assert cli.main(["edit", "--scene", "does/not/exist.scn",
                     "--device", "cpu", "--out", out]) == 2
    if not torch.cuda.is_available():
        assert cli.main(["edit", "--scene", SCENE, "--out", out]) == 2
