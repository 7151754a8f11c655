"""Chain-sharded MLT (`nrenderer_torch.parallel.mlt`) on CPU ranks over
gloo, against the port's one-device `render_mlt` and JAX's
`render_mlt_sharded`.

Rank r draws `hash(chain, step, draw, seed')` of its global chains, so
every chain moves as it does on one device:

- a world of one is `render_mlt` bit for bit;
- a world of two differs by the order of the film's final sum and of b's
  sum: the image within rtol 1e-5, atol 1e-6 (read on the CPU: max |d|
  4.2e-7 at 16x16, 64 chains x 16 mutations);
- a render stopped after a block and resumed from its checkpoint ends on
  the straight run bit for bit.

JAX folds the device index into its `jax.random` key, so parity with its
`render_mlt_sharded` on 8 virtual CPU devices is statistical."""
import pathlib

import numpy as np
import pytest
import torch

from nrenderer_torch import load_scn
from nrenderer_torch.io.obj import load_obj
from nrenderer_torch.parallel.mlt import render_mlt_sharded
from nrenderer_torch.renderers.mlt import render_mlt
from nrenderer_torch.scene.model import Scene

torch.set_num_threads(2)

RES = pathlib.Path(__file__).resolve().parent.parent / "resource"
LAUNCH = dict(threads=2, timeout=300)
KW = dict(chains=64, mutations=16, n_init=256, seed=3)


@pytest.fixture(autouse=True)
def _blocks(monkeypatch):
    """Blocks of 8 mutations (two a render); no previews."""
    monkeypatch.setenv("NR_MLT_BLOCK", "8")
    monkeypatch.delenv("NR_MLT_PREVIEW_BLOCKS", raising=False)


def _scene(size=16, depth=4, obj=None):
    scene = Scene()
    load_scn(str(RES / ("mesh_box.scn" if obj else "cornell_box.scn")),
             scene)
    if obj:
        load_obj(str(RES / "obj" / obj), scene, material=0)
    ro = scene.render_option
    ro.width = ro.height = size
    ro.depth = depth
    return scene


def test_world_of_one_is_render_mlt():
    want = render_mlt(_scene(), device="cpu", **KW)
    out = render_mlt_sharded(_scene(), ["cpu"], **KW, **LAUNCH)
    np.testing.assert_array_equal(out.image, want)
    assert out.spp_done == 16 and out.route == "mlt"


@pytest.mark.parametrize("world", [2, 4])
def test_chain_shards_match_one_device(world):
    """Two (four) ranks of 32 (16) chains each against one device's 64."""
    want = render_mlt(_scene(), device="cpu", **KW)
    out = render_mlt_sharded(_scene(), ["cpu"] * world, **KW, threads=1,
                             timeout=300)
    np.testing.assert_allclose(out.image, want, rtol=1e-5, atol=1e-6)
    assert out.image[..., :3].max() > 0.05


def test_mesh_scene_runs_the_mesh_pipe_on_every_rank():
    """blob_960 (past MLT_BVH_THRESHOLD) on two ranks: the chains' bounces
    go through the mesh pipe on each rank, and the image matches one
    device's."""
    kw = dict(chains=32, mutations=8, n_init=64, seed=1)
    scene = _scene(size=8, depth=3, obj="blob_960.obj")
    want = render_mlt(scene, device="cpu", **kw)
    out = render_mlt_sharded(scene, ["cpu"] * 2, **kw, **LAUNCH)
    np.testing.assert_allclose(out.image, want, rtol=1e-5, atol=1e-6)


def test_kill_and_resume_is_bit_identical(tmp_path):
    """A render stopped after its first block resumes from the one file
    rank 0 wrote and ends on the straight run bit for bit; a world of
    another size does not take that checkpoint."""
    straight = render_mlt_sharded(_scene(), ["cpu"] * 2, **KW, **LAUNCH)
    ck = str(tmp_path / "chains.npz")
    part = render_mlt_sharded(_scene(), ["cpu"] * 2, checkpoint_path=ck,
                              block_limit=1, **KW, **LAUNCH)
    assert part.image is None and part.spp_done == 8
    saved = np.load(ck)
    assert int(saved["blocks_done"]) == 1
    assert saved["film"].shape[0] == 2 and saved["leaf_0"].shape[1] == 64
    resumed = render_mlt_sharded(_scene(), ["cpu"] * 2, checkpoint_path=ck,
                                 **KW, **LAUNCH)
    np.testing.assert_array_equal(resumed.image, straight.image)
    np.testing.assert_array_equal(resumed.film, straight.film)
    assert int(np.load(ck)["blocks_done"]) == 2
    other = render_mlt_sharded(_scene(), ["cpu"], checkpoint_path=ck,
                               block_limit=1, **KW, **LAUNCH)
    assert other.spp_done == 8   # started afresh, not at block 2


def test_chains_must_divide():
    with pytest.raises(ValueError, match="multiple of the device count 3"):
        render_mlt_sharded(_scene(), ["cpu"] * 3, **KW)


def test_matches_jax_render_mlt_sharded_in_distribution():
    """JAX's 8-device chain-sharded MLT and two ranks of the port at 32x32,
    256 chains x 64 mutations, depth 4, with a b estimate of 8192 samples
    (b scales the whole image, and 1024 samples left it 30% apart):
    independent estimates of one image; their linear means agree within
    10% and their 8x8-block means correlate >= 0.9 (read on the CPU: 0.6%
    and 0.980)."""
    pytest.importorskip("jax")
    import jax
    import nrenderer_tpu as T
    from nrenderer_tpu.parallel.mesh import make_mesh
    from nrenderer_tpu.parallel.mlt import render_mlt_sharded as jax_mlt
    kw = dict(chains=256, mutations=64, n_init=8192, seed=0)
    scene = T.load_scn(str(RES / "cornell_box.scn"))
    ro = scene.render_option
    ro.width = ro.height = 32
    ro.depth = 4
    want = np.asarray(jax_mlt(scene, mesh=make_mesh(
        8, devices=jax.devices("cpu")), **kw))[..., :3]
    got = render_mlt_sharded(_scene(size=32), ["cpu"] * 2, **kw,
                             **LAUNCH).image[..., :3]
    lin = [np.asarray(im, np.float64) ** 2.2 for im in (got, want)]
    rel = abs(lin[0].mean() / lin[1].mean() - 1.0)
    blocks = [im.reshape(8, 4, 8, 4, 3).mean(axis=(1, 3)).ravel()
              for im in lin]
    corr = float(np.corrcoef(*blocks)[0, 1])
    print(f"MLT port vs JAX: linear mean rel diff {rel:.4f}, block corr "
          f"{corr:.4f}")
    assert rel <= 0.1 and corr >= 0.9
