"""Checkpointed sharded renders (`parallel.mesh.render_multichip_resumable`)
on CPU ranks over gloo: a render stopped after a pass and run again ends
on the straight run bit for bit in both shard modes, its resumed passes
post previews to the launching process, and a checkpoint resumes only on
the world, shard mode and devices that wrote it.  Pixel bands of the
megakernel's checkpointed route are the one-device checkpointed render
bit for bit; sample shards agree within rtol 1e-6."""
import pathlib

import numpy as np
import pytest
import torch

from nrenderer_torch import load_scn
from nrenderer_torch.parallel import mesh as pm
from nrenderer_torch.renderers.acc_pt import AccPathTracerRenderer
from nrenderer_torch.scene.model import Scene

torch.set_num_threads(2)

RES = pathlib.Path(__file__).resolve().parent.parent / "resource"
RTOL = 1e-6
LAUNCH = dict(threads=2, timeout=300)


def _scene(spp=64, size=16, depth=3):
    scene = Scene()
    load_scn(str(RES / "pt_glass_box.scn"), scene)
    ro = scene.render_option
    ro.width = ro.height = size
    ro.samples_per_pixel, ro.depth = spp, depth
    return scene


@pytest.mark.parametrize("shard", ["samples", "pixels"])
def test_kill_and_resume_is_bit_identical(tmp_path, shard):
    """A checkpointed resumable render stopped after its first pass, then
    run again, resumes at the next pass and ends on the straight run's
    film and image bit for bit; each resumed pass posts a preview.  The
    megakernel's checkpointed route at 64 spp has 8 steps of 8 spp: two
    ranks take 4 passes of two steps (one a rank) by samples, or 8 passes
    of one step (a band a rank) by pixels, which is then the one-device
    checkpointed render bit for bit (the host adds the same step films in
    the same order)."""
    scene = _scene()
    kw = dict(renderer="AccPathTracer", shard=shard, seed=5, **LAUNCH)
    straight = pm.render_multichip_resumable(scene, ["cpu"] * 2, **kw)
    ck = str(tmp_path / "film.npz")
    part = pm.render_multichip_resumable(scene, ["cpu"] * 2,
                                         checkpoint_path=ck, pass_limit=1,
                                         **kw)
    step = 16 if shard == "samples" else 8
    assert part.image is None and part.spp_done == step
    assert int(np.load(ck)["spp_done"]) == step
    previews = []
    resumed = pm.render_multichip_resumable(
        scene, ["cpu"] * 2, checkpoint_path=ck,
        on_preview=lambda spp, img: previews.append(spp), **kw)
    np.testing.assert_array_equal(resumed.film, straight.film)
    np.testing.assert_array_equal(resumed.image, straight.image)
    assert previews == list(range(2 * step, 65, step))
    assert resumed.route == "megakernel"
    one = AccPathTracerRenderer(seed=5, checkpoint_path=str(
        tmp_path / "one.npz"), device="cpu").render(scene).pixels[..., :3]
    if shard == "pixels":
        np.testing.assert_array_equal(straight.image, one)
    else:
        np.testing.assert_allclose(straight.image, one, rtol=RTOL,
                                   atol=1e-7)


def test_resume_needs_the_same_world(tmp_path):
    """The fingerprint holds the world size and the devices: a checkpoint
    of two ranks does not resume on one."""
    scene = _scene()
    ck = str(tmp_path / "film.npz")
    kw = dict(renderer="AccPathTracer", seed=5, checkpoint_path=ck, **LAUNCH)
    pm.render_multichip_resumable(scene, ["cpu"] * 2, pass_limit=1, **kw)
    previews = []
    one = pm.render_multichip_resumable(
        scene, ["cpu"], on_preview=lambda spp, img: previews.append(spp),
        **kw)
    assert previews[0] == 8 and one.spp_done == 64
