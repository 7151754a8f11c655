"""The port's entry points: `python -m nrenderer_torch render/list-renderers`,
the registry and ComponentManager surface, and the rule that the package
never imports JAX and never runs on the CPU when asked for CUDA."""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from nrenderer_torch import cli

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
SCENE = str(REPO / "resource" / "cornell_box.scn")
SMALL = ["--scene", SCENE, "--renderer", "SimplePathTracer", "--width", "16",
         "--height", "16", "--spp", "4", "--depth", "3"]


def _run(args, timeout=120):
    return subprocess.run([sys.executable, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def test_module_render_cpu_writes_png(tmp_path):
    out = tmp_path / "cornell.png"
    proc = _run(["-m", "nrenderer_torch", "render", *SMALL, "--device", "cpu",
                 "--out", str(out)])
    assert proc.returncode == 0, proc.stderr
    assert "SimplePathTracer[cpu]" in proc.stdout
    from nrenderer_torch.io.image import read_png
    img = read_png(str(out))
    assert img is not None and img.shape == (16, 16, 3)


def test_no_jax_imported_after_render(tmp_path):
    """Every module of the package (the hybrid route's
    `ops/stream_compact`, `renderers/_wavefront`, the MXU sweep's
    `ops/mesh_mxu` and `renderers/mlt` among them), and renders through
    the three renderers with an env map, a mesh (`--obj`: the megamesh
    route, the hybrid route staged, under an env map and with
    NR_MESH_MXU=1, and MLT's mesh scene) and textures, leave no JAX module
    loaded; `chip_smoke.py` imports neither JAX nor the JAX package."""
    env = ["--env-map", str(REPO / "resource" / "env_sky.png")]
    res = REPO / "resource"
    tiny = ["--width", "8", "--height", "8", "--spp", "2", "--depth", "2",
            "--device", "cpu"]
    mesh = ["render", "--scene", str(res / "mesh_box.scn"), "--obj",
            str(res / "obj" / "blob_960.obj"), "--renderer", "AccPathTracer",
            *tiny, "--out", str(tmp_path / "m.png")]
    tex = ["render", "--scene", str(res / "tex_grid.scn"), "--obj",
           str(res / "obj" / "tex_grid.obj"), "--renderer", "AccPathTracer",
           *tiny, "--out", str(tmp_path / "t.png")]
    hybrid = ["render", "--scene", str(res / "mesh_box.scn"), "--obj",
              str(res / "obj" / "ico_5120.obj"), "--renderer",
              "AccPathTracer", *tiny[:-4], "--depth", "13", "--device",
              "cpu", "--out", str(tmp_path / "h.png")]
    env_mesh = mesh[:-1] + [str(tmp_path / "em.png")] + env
    acc = ["render", "--scene", str(REPO / "resource" / "pt_glass_box.scn"),
           "--renderer", "AccPathTracer", "--width", "8", "--height", "8",
           "--spp", "2", "--depth", "2", "--device", "cpu", "--out",
           str(tmp_path / "a.png")]
    mlt = ["render", "--scene", SCENE, "--renderer",
           "MetropolisLightTransport", "--width", "8", "--height", "8",
           "--depth", "3", "--chains", "1024", "--mutations", "2",
           "--device", "cpu", "--out", str(tmp_path / "l.png")]
    mlt_mesh = mlt[:2] + [str(res / "mesh_box.scn"), "--obj",
                          str(res / "obj" / "blob_960.obj")] + mlt[3:-1] + [
        str(tmp_path / "lm.png")]
    argvs = [["render", *SMALL, "--device", "cpu", "--out",
              str(tmp_path / "x.png")],
             ["render", *SMALL, *env, "--device", "cpu", "--out",
              str(tmp_path / "e.png")],
             acc, acc[:-1] + [str(tmp_path / "b.png")] + env, mesh, tex,
             hybrid, env_mesh, mlt, mlt_mesh]
    code = (
        "import os, pkgutil, sys\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import nrenderer_torch\n"
        "for m in pkgutil.walk_packages(nrenderer_torch.__path__, "
        "'nrenderer_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        __import__(m.name)\n"
        "assert {'nrenderer_torch.ops.stream_compact', "
        "'nrenderer_torch.renderers._wavefront', "
        "'nrenderer_torch.ops.mesh_mxu', 'nrenderer_torch.renderers.mlt'} "
        "<= set(sys.modules)\n"
        "import chip_smoke\n"
        "from nrenderer_torch.cli import main\n"
        f"for argv in {argvs!r}:\n"
        "    rc = main(argv)\n"
        "    assert rc == 0, (rc, argv)\n"
        "os.environ['NR_MESH_MXU'] = '1'\n"
        "from nrenderer_torch.ops import mesh_cuda\n"
        "mesh_cuda.reset_route_counts()\n"
        f"assert main({hybrid[:-1] + [str(tmp_path / 'hm.png')]!r}) == 0\n"
        "assert mesh_cuda.ENGINE_COUNTS['mxu'] > 0, mesh_cuda.ENGINE_COUNTS\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'nrenderer_tpu')))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = _run(["-c", code])
    assert proc.returncode == 0, proc.stderr
    assert "clean" in proc.stdout


def test_list_renderers(capsys):
    assert cli.main(["list-renderers"]) == 0
    assert "NR.Render.SimplePathTracer" in capsys.readouterr().out


def test_cuda_without_gpu_fails_instead_of_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda renders there")
    out = tmp_path / "x.png"
    rc = cli.main(["render", *SMALL, "--device", "cuda", "--out", str(out)])
    assert rc != 0
    assert not out.exists()


@pytest.mark.parametrize("args", [
    ["--renderer", "NoSuchRenderer"],
    ["--scene", "does/not/exist.scn"],
    ["--device", "tpu"],
])
def test_render_errors_exit_2(tmp_path, args):
    base = dict(zip(SMALL[::2], SMALL[1::2]))
    base.update(dict(zip(args[::2], args[1::2])))
    argv = ["render", *[x for kv in base.items() for x in kv],
            "--device", base.get("--device", "cpu"),
            "--out", str(tmp_path / "x.png")]
    assert cli.main(argv) == 2


def test_component_manager_exec_wait():
    """The README's Python API: registered component, background thread,
    state machine, (H, W, 4) pixels posted to the Screen."""
    import nrenderer_torch
    from nrenderer_torch.renderers.simple_pt import SimplePathTracerRenderer
    from nrenderer_torch.server.manager import ComponentManager, State
    from nrenderer_torch.server.registry import get_server
    nrenderer_torch._register_builtin_renderers()
    scene = nrenderer_torch.load_scn(SCENE)
    ro = scene.render_option
    ro.width, ro.height, ro.samples_per_pixel, ro.depth = 8, 6, 2, 2
    mgr = ComponentManager()
    mgr.exec("SimplePathTracer", scene,
             component=SimplePathTracerRenderer(seed=1, device="cpu"))
    result = mgr.wait(timeout=120)
    assert mgr.state == State.IDLING
    assert result.pixels.shape == (6, 8, 4)
    assert np.isfinite(result.pixels).all()
    assert ((result.pixels >= 0) & (result.pixels <= 1)).all()
    np.testing.assert_array_equal(get_server().screen.get_pixels(),
                                  result.pixels)
    info = get_server().component_factory.get_components_info("Render")
    assert "NR.Render.SimplePathTracer" in [i.id for i in info]
