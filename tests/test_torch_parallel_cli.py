"""`render --devices N --shard samples|pixels`, the launcher and the
dryrun of `nrenderer_torch.parallel`, on CPU ranks over gloo.

The CLI refuses what the JAX CLI refuses with exit 2
(`nrenderer_tpu/cli.py:152-310`): more devices than there are, `--shard
pixels` for MetropolisLightTransport, a height the device count does not
divide, and (where JAX asserts) a sample budget it does not divide.  With
`--device cpu --devices 2` a pixel-sharded render writes the one-device
render's PNG exactly, and a sample-sharded one within one 8-bit level.
`cuda` asked for on a machine without a GPU raises and runs nothing on the
CPU."""
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from nrenderer_torch import cli
from nrenderer_torch.io.image import load_image
from nrenderer_torch.parallel import group
from nrenderer_torch.parallel import mesh as pm

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))
CORNELL = str(REPO / "resource" / "cornell_box.scn")
GLASS = str(REPO / "resource" / "pt_glass_box.scn")
SMALL = ["--width", "16", "--height", "16", "--spp", "8", "--depth", "3",
         "--device", "cpu", "--seed", "2"]


def _render(tmp_path, name, *args):
    out = tmp_path / name
    rc = cli.main(["render", *args, "--out", str(out)])
    return rc, out


@pytest.mark.parametrize("args, message", [
    (["--devices", "2", "--shard", "pixels", "--renderer",
      "MetropolisLightTransport"], "supports SimplePathTracer"),
    (["--devices", "3", "--shard", "pixels"], "height divisible"),
    (["--devices", "3"], "multiple of the device count 3"),
    (["--devices", "100000"], "100000 cpu devices requested"),
    (["--devices", "2", "--renderer", "MetropolisLightTransport",
      "--chains", "7"], "multiple of the device count 2"),
], ids=["mlt-pixels", "height", "spp", "too-many", "chains"])
def test_refusals_exit_2(tmp_path, capsys, args, message):
    rc, out = _render(tmp_path, "x.png", "--scene", CORNELL, *SMALL, *args)
    assert rc == 2 and not out.exists()
    assert message in capsys.readouterr().err


def test_cuda_without_a_gpu_exits_2(tmp_path, capsys):
    """`--device cuda --devices 2` without a GPU: exit 2, nothing on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    rc, out = _render(tmp_path, "x.png", "--scene", CORNELL,
                      *SMALL[:-4], "--device", "cuda", "--devices", "2")
    assert rc == 2 and not out.exists()
    assert "no GPU" in capsys.readouterr().err


def test_cuda_ranks_without_a_gpu_raise():
    """The launcher and the entry points refuse CUDA ranks without a GPU;
    they never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    from nrenderer_torch import load_scn
    with pytest.raises(RuntimeError, match="no GPU"):
        group.check_devices(["cuda"])
    with pytest.raises(RuntimeError, match="no GPU"):
        pm.render_multichip(load_scn(CORNELL), ["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="0 available"):
        group.make_devices(2, "cuda")


@pytest.mark.parametrize("renderer", ["SimplePathTracer", "AccPathTracer"])
@pytest.mark.parametrize("shard", ["samples", "pixels"])
def test_two_cpu_ranks_write_the_one_device_png(tmp_path, renderer, shard):
    scene = CORNELL if renderer == "SimplePathTracer" else GLASS
    base = ["--scene", scene, "--renderer", renderer, *SMALL]
    rc1, one = _render(tmp_path, "one.png", *base)
    rc2, two = _render(tmp_path, "two.png", *base, "--devices", "2",
                       "--shard", shard)
    assert rc1 == rc2 == 0
    a, b = load_image(str(one)), load_image(str(two))
    if shard == "pixels":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, atol=1.0 / 255 + 1e-6)


def test_checkpoint_with_devices_resumes(tmp_path, capsys):
    """`--checkpoint` takes the resumable route: a second run resumes at
    the end of the first and writes the same PNG."""
    ck = str(tmp_path / "film.npz")
    base = ["--scene", GLASS, "--renderer", "AccPathTracer",
            "--width", "16", "--height", "16", "--spp", "32", "--depth", "3",
            "--device", "cpu", "--devices", "2", "--checkpoint", ck]
    rc1, first = _render(tmp_path, "a.png", *base)
    assert rc1 == 0 and int(np.load(ck)["spp_done"]) == 32
    assert "resumable" in capsys.readouterr().out
    rc2, second = _render(tmp_path, "b.png", *base)
    assert rc2 == 0
    np.testing.assert_array_equal(load_image(str(first)),
                                  load_image(str(second)))


def test_progressive_pixels_is_the_one_device_progressive_png(tmp_path):
    """`--progressive --shard pixels` on two ranks: the one-device
    progressive render's PNG exactly."""
    base = ["--scene", CORNELL, *SMALL, "--progressive"]
    rc1, one = _render(tmp_path, "one.png", *base)
    rc2, two = _render(tmp_path, "two.png", *base, "--devices", "2",
                       "--shard", "pixels")
    assert rc1 == rc2 == 0
    np.testing.assert_array_equal(load_image(str(one)),
                                  load_image(str(two)))


def test_mlt_devices_matches_one_device(tmp_path, monkeypatch):
    monkeypatch.setenv("NR_MLT_BLOCK", "8")
    base = ["--scene", CORNELL, "--renderer", "MetropolisLightTransport",
            "--width", "16", "--height", "16", "--depth", "4", "--chains",
            "64", "--mutations", "16", "--device", "cpu"]
    rc1, one = _render(tmp_path, "one.png", *base)
    rc2, two = _render(tmp_path, "two.png", *base, "--devices", "2")
    assert rc1 == rc2 == 0
    np.testing.assert_allclose(load_image(str(one)), load_image(str(two)),
                               atol=1.0 / 255 + 1e-6)


def test_serve_with_devices(tmp_path):
    """`--serve --devices 2` shows rank 0's previews and then the final
    frame until interrupted."""
    from test_torch_editor import _Stderr, _child, _get, _interrupt
    out = tmp_path / "s.png"
    proc = _child(["render", "--scene", CORNELL, *SMALL, "--devices", "2",
                   "--shard", "pixels", "--serve", "--out", str(out)])
    try:
        err = _Stderr(proc)
        url = err.wait_for(r"live view: (http://localhost:\d+/)").group(1)
        err.wait_for(r"serving final frame")
        st = json.loads(_get(url + "status")[1])
        assert st["frame"] >= 1 and (st["width"], st["height"]) == (16, 16)
        assert out.exists()
    finally:
        _interrupt(proc)


def test_ranks_import_no_jax():
    """Each rank runs in a fresh process that imports torch and the port
    only, whatever the launching process has loaded."""
    pytest.importorskip("jax")
    import jax  # noqa: F401  (the launching process has JAX loaded)
    ranks = group.describe_ranks(["cpu", "cpu"], threads=1, timeout=120)
    assert [r["rank"] for r in ranks] == [0, 1]
    assert all(r["backend"] == "gloo" and r["world"] == 2 for r in ranks)
    assert not any(r["jax_loaded"] or r["nrenderer_tpu_loaded"]
                   for r in ranks)


def test_failing_or_late_ranks_make_the_launch_raise():
    """A rank that raises fails the launch with its traceback; so does a
    launch past its timeout.  No rank is left running."""
    import multiprocessing
    with pytest.raises(group.RankError, match="AttributeError"):
        group.launch(pm._render_rank, ["cpu", "cpu"], None,
                     "SimplePathTracer", "samples", 0, threads=1, timeout=120)
    with pytest.raises(group.RankError, match="timed out"):
        group.describe_ranks(["cpu", "cpu"], threads=1, timeout=0.5)
    assert not multiprocessing.active_children()


def test_backend_choice():
    cpu, c0, c1 = (torch.device(d) for d in ("cpu", "cuda:0", "cuda:1"))
    assert group.backend_for([c0, c1]) == "nccl"
    assert group.backend_for([c0]) == "nccl"
    assert group.backend_for([c0, c0]) == "gloo"
    assert group.backend_for([cpu, cpu]) == "gloo"


def test_dryrun_two_ranks(capsys):
    """`python -m nrenderer_torch.parallel.dryrun 2 --device cpu`: one line
    a path, the mesh routes included, each against its one-device render."""
    from nrenderer_torch.parallel import dryrun
    assert dryrun.main(["2", "--device", "cpu", "--shard", "pixels"]) == 0
    lines = capsys.readouterr().out.splitlines()
    for label in ("SPT [dense]", "AccPT [megakernel]", "MLT [mlt]",
                  "AccPT mesh blob_960 [megamesh]",
                  "AccPT mesh ico_5120 [hybrid]"):
        assert any(label in ln and "OK" in ln for ln in lines), label
    assert lines[-1] == "dryrun(2): OK"


def test_dryrun_defaults_to_the_card(capsys):
    """The dryrun runs on the GPUs unless `--device cpu` is given: without
    a GPU it exits 2 and renders nothing."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    from nrenderer_torch.parallel import dryrun
    assert dryrun.main(["1"]) == 2
    io = capsys.readouterr()
    assert "1 cuda devices requested, 0 available" in io.err
    assert "dryrun(" not in io.out
