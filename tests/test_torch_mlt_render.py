"""MetropolisLightTransport end to end on the CPU: a whole render against
the port's own path tracers, chain checkpoints and resume, previews, the
CLI, and (on a GPU) the mesh scene on each sweep engine.

The radiance check is `tests/test_mlt_golden.py:73-126`'s (its scene, the
reference's `Metropolis.scn`, is not in the repository): the tone map
pow(1 - exp(-x s), 1/2.2) is inverted to the MLT film's linear radiance
and held against the path tracer's linear film (sqrt gamma undone),
without the top sixth of the rows (the light quad: MinPathLength = 3
takes the direct camera -> light path out of MLT); then the tone-domain
correlation of 8x8-block means over the whole image.  The two preserved
REFQUIRKs (emitted = 2x the scene radiance, a light vertex's colour = the
emitted radiance) keep the ratio off 1, so the bands are centred on the
JAX package's own figures at the same scene and budget, measured once on
the CPU (its `render_mlt`, Pallas in interpret mode, against its
SimplePathTracer / AccPathTracer, seed 0):

  - cornell_box.scn, 32x32, depth 6, 512 chains x 64 mutations, n_init
    8192, SimplePathTracer 256 spp: ratio 1.108 (r 1.205, g 1.073,
    b 0.926), correlation 0.751;
  - mesh_box.scn + blob_960.obj, 32x32, depth 6, 256 chains x 64
    mutations, n_init 8192, AccPathTracer 128 spp: ratio 1.101 (r 1.227,
    g 1.057, b 0.866), correlation 0.742.

Each ratio must lie within [0.8, 1.25] times JAX's (the golden test's
band is 0.85-1.30 around 1.08), the correlation above JAX's less 0.1.  The
port's own spread over seeds 0-3 at these budgets (its draws are not
JAX's): ratio 1.04-1.26 (Cornell) and 1.11-1.29 (mesh), correlation
0.77-0.79, most of it from the brightness estimate b."""
import pathlib

import numpy as np
import pytest
import torch

import nrenderer_torch as P
from nrenderer_torch import cli
from nrenderer_torch.io.image import read_png
from nrenderer_torch.ops import mesh_cuda, mesh_mxu
from nrenderer_torch.renderers import mlt
from nrenderer_torch.renderers.acc_pt import AccPathTracerRenderer
from nrenderer_torch.renderers.simple_pt import SimplePathTracerRenderer
from nrenderer_torch.server.registry import get_server

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = REPO / "resource"
# scene: (objs, chains, mutations, path tracer, spp, JAX ratio, JAX
# per-channel ratios, JAX correlation)
BUDGETS = {
    "cornell": ("cornell_box.scn", (), 512, 64, SimplePathTracerRenderer,
                256, 1.108, (1.205, 1.073, 0.926), 0.751),
    "mesh": ("mesh_box.scn", ("blob_960.obj",), 256, 64,
             AccPathTracerRenderer, 128, 1.101, (1.227, 1.057, 0.866),
             0.742),
}
W = H = 32
DEPTH = 6
N_INIT = 8192


def _scene(scn, objs, w=W, h=H, depth=DEPTH):
    scene = P.Scene()
    P.load_scn(str(RES / scn), scene)
    for o in objs:
        P.load_obj(str(RES / "obj" / o), scene, material=0)
    ro = scene.render_option
    ro.width, ro.height, ro.depth = w, h, depth
    return scene


def _blocks(a):
    return a.reshape(8, H // 8, 8, W // 8, 3).mean(axis=(1, 3)).reshape(-1)


@pytest.mark.parametrize("which", sorted(BUDGETS))
def test_linear_radiance_tracks_the_path_tracer(which):
    scn, objs, chains, muts, tracer, spp, ratio_j, chan_j, corr_j = \
        BUDGETS[which]
    img = mlt.render_mlt(_scene(scn, objs), chains=chains, mutations=muts,
                         n_init=N_INIT, seed=0, device="cpu")
    assert img.shape == (H, W, 4) and np.isfinite(img).all()
    assert (img >= 0).all() and (img <= 1).all()
    scene = _scene(scn, objs)
    scene.render_option.samples_per_pixel = spp
    pt = tracer(seed=0, device="cpu").render(scene).pixels[..., :3]
    rgb = img[..., :3].astype(np.float64)
    mlt_lin = -np.log1p(-np.clip(rgb, 0.0, 0.999999) ** 2.2)
    pt_lin = pt.astype(np.float64) ** 2
    band = H // 6
    a, b = mlt_lin[band:], pt_lin[band:]
    ratio = a.mean() / b.mean()
    chans = [a[..., i].mean() / b[..., i].mean() for i in range(3)]
    corr = np.corrcoef(_blocks(rgb), _blocks(pt))[0, 1]
    print(which, "MLT / path tracer: ratio", ratio, "channels", chans,
          "correlation", corr)
    assert 0.8 * ratio_j < ratio < 1.25 * ratio_j
    for got, want in zip(chans, chan_j):
        assert 0.8 * want < got < 1.25 * want
    assert corr > corr_j - 0.1


def _small(depth=4):
    return _scene("cornell_box.scn", (), 16, 16, depth)


def test_checkpoint_resume_equals_uninterrupted(tmp_path, monkeypatch):
    """A checkpointed render that dies in its second block resumes from
    the saved chains and ends with the uninterrupted render's image, bit
    for bit; a snapshot of another render is ignored."""
    monkeypatch.setenv("NR_MLT_BLOCK", "4")
    kw = dict(chains=64, mutations=12, n_init=256, seed=3, device="cpu")
    whole = mlt.render_mlt(_small(), **kw)
    real = mlt.mutation_step
    steps, dies = [], [True]

    def dies_in_block_two(kern, ch, step, b, seed):
        steps.append(step)
        if step == 6 and dies[0]:
            dies[0] = False
            raise KeyboardInterrupt("interrupted")
        return real(kern, ch, step, b, seed)

    ckpt = tmp_path / "chains.npz"
    monkeypatch.setattr(mlt, "mutation_step", dies_in_block_two)
    with pytest.raises(KeyboardInterrupt):
        mlt.render_mlt(_small(), checkpoint_path=str(ckpt), **kw)
    assert steps == list(range(7))
    assert int(np.load(ckpt)["blocks_done"]) == 1
    steps.clear()
    get_server().logger.clear()
    resumed = mlt.render_mlt(_small(), checkpoint_path=str(ckpt), **kw)
    assert steps == list(range(4, 12))
    assert "MLT: resumed at block 1/3" in " | ".join(
        m.content for m in get_server().logger.get())
    np.testing.assert_array_equal(resumed, whole)
    assert whole[..., :3].mean() > 0.05
    # another seed's snapshot does not resume: all twelve steps run again
    steps.clear()
    mlt.render_mlt(_small(), checkpoint_path=str(ckpt),
                   **{**kw, "seed": 4})
    assert steps == list(range(12))


def test_previews_post_the_partial_film(monkeypatch):
    """NR_MLT_PREVIEW_BLOCKS=1 posts the tone-mapped film after every block
    but the last."""
    monkeypatch.setenv("NR_MLT_BLOCK", "2")
    monkeypatch.setenv("NR_MLT_PREVIEW_BLOCKS", "1")
    posted = []
    screen = get_server().screen
    monkeypatch.setattr(screen, "set",
                        lambda px, w, h: posted.append((px.copy(), w, h)))
    img = mlt.render_mlt(_small(3), chains=64, mutations=6, n_init=128,
                         device="cpu")
    assert [p[1:] for p in posted] == [(16, 16), (16, 16)]
    for px, _, _ in posted:
        assert px.shape == (16, 16, 4) and np.isfinite(px).all()
    assert img.shape == (16, 16, 4)


def test_cli_writes_png(tmp_path):
    """`render --renderer MetropolisLightTransport --device cpu` writes a
    PNG; `--device cuda` without a GPU exits 2 and writes nothing."""
    out = tmp_path / "mlt.png"
    argv = ["render", "--scene", str(RES / "cornell_box.scn"), "--renderer",
            "MetropolisLightTransport", "--width", "12", "--height", "10",
            "--depth", "3", "--chains", "1024", "--mutations", "2",
            "--seed", "1", "--out", str(out)]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    img = read_png(str(out))
    assert img.shape == (10, 12, 3) and np.isfinite(img).all()
    assert img.mean() > 0.02
    if not torch.cuda.is_available():
        out.unlink()
        assert cli.main(argv + ["--device", "cuda"]) == 2
        assert not out.exists()


def test_no_area_light_renders_black():
    scene = _small()
    scene.area_light_buffer.clear()
    img = mlt.render_mlt(scene, chains=8, mutations=2, device="cpu")
    assert img.shape == (16, 16, 4) and not img.any()


def test_render_mlt_runs_on_the_card_unless_told_otherwise():
    """`render_mlt` without a device runs on the card, as the renderer and
    the CLI do: without a GPU it refuses rather than rendering on the CPU."""
    import inspect
    assert inspect.signature(mlt.render_mlt).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            mlt.render_mlt(_small(), chains=8, mutations=2)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mxu", ["0", "1"])
def test_cuda_mesh_mlt_runs_the_sweep_engine(gpu, monkeypatch, mxu):
    """On the card the mesh scene's bounces and shadow rays launch B2, or
    B4 under NR_MESH_MXU=1, and nothing falls back to the plain sweep."""
    monkeypatch.setenv("NR_MESH_MXU", mxu)
    mesh_cuda.reset_launch_counts()
    mesh_mxu.reset_launch_counts()
    img = mlt.render_mlt(_scene("mesh_box.scn", ("blob_960.obj",), 16, 16,
                                4), chains=256, mutations=4, n_init=512,
                         device=gpu)
    assert np.isfinite(img).all() and img[..., :3].mean() > 0.02
    b2 = mesh_cuda.KERNEL_LAUNCHES[mesh_cuda.KERNEL_NAME]
    b4 = mesh_mxu.KERNEL_LAUNCHES[mesh_mxu.KERNEL_NAME]
    assert (b4 > 0 and b2 == 0) if mxu == "1" else (b2 > 0 and b4 == 0)
