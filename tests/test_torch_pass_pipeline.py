"""The progressive loop's one-deep pipeline (`routes.progressive_loop`):
pass k + 1 is queued before pass k is added, previewed and saved.

It is held bit for bit against the serial loop, kept here as the
reference (each pass launched, copied to the host, added, previewed and
saved before the next is launched): the film, the returned image, every
preview posted to the Screen, in order, and every checkpoint written, on
each kind of route in passes.  A render that fails at a pass's launch
leaves the serial loop's checkpoint and previews, and resumed it ends on
the render that never failed.  The `cuda` test holds the same on the
card, where the films come back through page-locked memory:
`python -m pytest tests/test_torch_pass_pipeline.py -m cuda`."""
import pathlib

import numpy as np
import pytest
import torch

import nrenderer_torch as P
from nrenderer_torch.renderers import routes
from nrenderer_torch.server.checkpoint import (
    load_checkpoint, render_fingerprint,
)
from nrenderer_torch.server.registry import get_server
from nrenderer_torch.utils.timing import PhaseTimer

torch.set_num_threads(1)

RES = pathlib.Path(__file__).resolve().parent.parent / "resource"
# kind: (scene, OBJ, renderer)
SCENES = {"megamesh": ("mesh_box.scn", "blob_960.obj", "AccPathTracer"),
          "hybrid": ("mesh_box.scn", "blob_960.obj", "AccPathTracer"),
          "progressive": ("cornell_box.scn", None, "SimplePathTracer"),
          "megakernel": ("pt_glass_box.scn", None, "AccPathTracer")}
W, H, SPP, DEPTH, SEED = 16, 16, 8, 3, 5
N_PASSES = 4


def _route(kind, device):
    """`kind`'s route in 4 passes of 2 samples on `device`."""
    name, obj, renderer = SCENES[kind]
    scene = P.Scene()
    P.load_scn(str(RES / name), scene)
    if obj:
        P.load_obj(str(RES / "obj" / obj), scene, material=0)
    ro = scene.render_option
    ro.width, ro.height, ro.samples_per_pixel, ro.depth = W, H, SPP, DEPTH
    pcall = SPP // N_PASSES
    plan = routes.Plan(kind, "passes", N_PASSES, pcall,
                       pcall if kind == "hybrid" else 0)
    return routes.make_route(scene, renderer, True, device, SEED, plan)


def _serial_loop(route, ckpt, preview_every):
    """The loop without the pipeline: one pass at a time, launched,
    copied to the host, added, previewed and saved."""
    pcall = route.plan.unit_spp
    parts, arrays = route.fingerprint()
    fingerprint = render_fingerprint(parts, arrays=arrays)
    film, start = np.zeros((W * H, 3), np.float32), 0
    loaded = load_checkpoint(ckpt, fingerprint)
    if loaded is not None:
        film, done = loaded
        start = done // pcall
    n_steps = SPP // pcall
    for step in range(start, n_steps):
        film += route.one_pass(step, 0, W * H).cpu().numpy()
        done = (step + 1) * pcall
        if (step + 1) % preview_every == 0 or step == n_steps - 1:
            img = np.sqrt(np.maximum(film / done, 0.0))
            img = img.reshape(H, W, 3)[::-1]
            get_server().screen.set(np.concatenate(
                [img, np.ones((H, W, 1), np.float32)], axis=2), W, H)
        routes.save_checkpoint(ckpt, film, done, W, H, SEED, fingerprint)
    img = np.sqrt(np.maximum(film / SPP, 0.0)).reshape(H, W, 3)
    return np.clip(img[::-1], 0.0, 1.0)


def _pipelined_loop(route, ckpt, preview_every):
    return routes.progressive_loop(route, W, H, SPP, SEED, ckpt,
                                   PhaseTimer().scope("T"), preview_every)


@pytest.fixture
def posted(monkeypatch):
    """What a loop posts and saves, in order: each preview's pixels and
    each checkpoint's arrays."""
    log = {"previews": [], "checkpoints": []}
    screen = get_server().screen
    real_set, real_save = screen.set, routes.save_checkpoint

    def post(px, w, h):
        log["previews"].append(np.array(px))
        real_set(px, w, h)

    def save(path, *args):
        real_save(path, *args)
        with np.load(path) as z:
            log["checkpoints"].append({k: z[k] for k in z.files})

    monkeypatch.setattr(screen, "set", post)
    monkeypatch.setattr(routes, "save_checkpoint", save)
    return log


def _take(log):
    """The log's entries so far, and the log emptied."""
    out = {k: list(v) for k, v in log.items()}
    for v in log.values():
        v.clear()
    return out


def _assert_same(got, want):
    """Previews and checkpoints equal in number, order and every bit."""
    assert len(got["previews"]) == len(want["previews"])
    for a, b in zip(got["previews"], want["previews"]):
        np.testing.assert_array_equal(a, b)
    assert len(got["checkpoints"]) == len(want["checkpoints"])
    for a, b in zip(got["checkpoints"], want["checkpoints"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def _both_loops(route, tmp_path, posted, preview_every):
    """The serial and the pipelined loop's images and logs, each from an
    empty checkpoint file of its own."""
    want = _serial_loop(route, str(tmp_path / "serial.npz"), preview_every)
    want_log = _take(posted)
    got = _pipelined_loop(route, str(tmp_path / "pipe.npz"), preview_every)
    return got, want, _take(posted), want_log


@pytest.mark.parametrize("kind,preview_every", [
    ("megamesh", 1), ("megamesh", 3), ("hybrid", 1), ("progressive", 2),
    ("megakernel", 1)])
def test_pipelined_loop_is_the_serial_loop(kind, preview_every, tmp_path,
                                           posted):
    route = _route(kind, "cpu")
    before = dict(routes.PASS_OVERLAP)
    got, want, got_log, want_log = _both_loops(route, tmp_path, posted,
                                               preview_every)
    np.testing.assert_array_equal(got, want)
    _assert_same(got_log, want_log)
    assert len(got_log["checkpoints"]) == N_PASSES
    assert len(got_log["previews"]) == (4 if preview_every == 1 else 2)
    final = got_log["checkpoints"][-1]
    assert int(final["spp_done"]) == SPP and final["film"].max() > 0.0
    # the CPU runs a pass when it is queued: no pass can be hidden
    assert routes.PASS_OVERLAP["passes"] - before["passes"] == N_PASSES
    assert routes.PASS_OVERLAP["hidden"] == before["hidden"]
    assert any(m.content == "passes: 4, 0 with their host work under the "
               "next pass" for m in get_server().logger.get()[-3:])


def test_next_pass_is_queued_before_this_one_is_added(tmp_path, posted):
    """The order that lets the card hide the host's work: pass k + 1 is
    launched inside pass k's `pass-wait` span, before pass k's film is
    added, previewed and saved."""
    route = _route("megamesh", "cpu")
    timer = PhaseTimer()
    seen = []   # at each launch: previews, checkpoints, closed waits

    def one_pass(step, pix0, n_pix):
        seen.append((step, len(posted["previews"]),
                     len(posted["checkpoints"]),
                     timer.get("pass-wait").count))
        return route.one_pass(step, pix0, n_pix)

    routes.progressive_loop(route._replace(one_pass=one_pass), W, H, SPP,
                            SEED, str(tmp_path / "c.npz"), timer)
    assert seen == [(0, 0, 0, 0), (1, 0, 0, 0), (2, 1, 1, 1), (3, 2, 2, 2)]
    assert timer.get("pass-wait").count == N_PASSES
    assert len(posted["previews"]) == len(posted["checkpoints"]) == N_PASSES


@pytest.mark.parametrize("dies_at", [2, 4])
def test_failed_launch_then_resume_is_the_serial_loop(dies_at, tmp_path,
                                                      posted):
    """Launch number `dies_at` raises: both loops leave the same
    checkpoint and previews (every pass launched before it finished), and
    resumed both end on the render that never failed."""
    route = _route("megamesh", "cpu")
    whole = _serial_loop(route, str(tmp_path / "whole.npz"), 1)
    _take(posted)
    logs = []
    for loop, ckpt in ((_serial_loop, tmp_path / "serial.npz"),
                       (_pipelined_loop, tmp_path / "pipe.npz")):
        launches = []

        def dies(step, pix0, n_pix):
            launches.append(step)
            if len(launches) == dies_at:
                raise KeyboardInterrupt("interrupted")
            return route.one_pass(step, pix0, n_pix)

        with pytest.raises(KeyboardInterrupt):
            loop(route._replace(one_pass=dies), str(ckpt), 1)
        assert launches == list(range(dies_at))
        assert int(np.load(ckpt)["spp_done"]) == (dies_at - 1) * 2
        interrupted = _take(posted)
        np.testing.assert_array_equal(loop(route, str(ckpt), 1), whole)
        logs.append((interrupted, _take(posted)))
    for got, want in zip(logs[1], logs[0]):
        _assert_same(got, want)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(SCENES))
def test_cuda_pipelined_loop_is_the_serial_loop(kind, gpu, tmp_path,
                                                posted):
    """On the card, through page-locked memory and events: the same
    film, image, previews and checkpoints as the serial loop, and every
    pass counted."""
    # a film's copy to the host is asynchronous only into page-locked
    # memory, which torch's copy takes from its caching host allocator
    assert torch.ones(4, device=gpu).to("cpu", non_blocking=True).is_pinned()
    route = _route(kind, gpu)
    before = dict(routes.PASS_OVERLAP)
    got, want, got_log, want_log = _both_loops(route, tmp_path, posted, 1)
    np.testing.assert_array_equal(got, want)
    _assert_same(got_log, want_log)
    assert len(got_log["checkpoints"]) == N_PASSES
    assert routes.PASS_OVERLAP["passes"] - before["passes"] == N_PASSES
    assert routes.PASS_OVERLAP["hidden"] - before["hidden"] < N_PASSES
