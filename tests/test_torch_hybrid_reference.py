"""The benchmark's hybrid-route reference (`benchmark/reference/hybrid.py`)
against the port's own `render` command on the CPU: a subdivision-3
icosphere (1,280 faces, past the CPU's 1,024-face megamesh limit, so the
hybrid route) in `mesh_box.scn` at 16x16, every pixel of the PNG and every
float the PNG writer receives, at depths 12 and 20 (the staged wavefront,
two and three stage boundaries) and 5 (one running sum), with the stage
roulette never firing.  Faults come out not correct: the reference of
another render seed and of half the samples.  The reference sums each
path in one running sum, and the route's staged banking rounds as it
does: a path of the five-lobe estimator gains radiance once at most (at
its light hit, which ends it, or from the depth cap's ambient), so its
stage radiances hold one non-zero term.  The batched sweep is
`reference.mesh`'s block-by-block sweep, number for number."""
import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

from nrenderer_torch import cli
from nrenderer_torch.io import image
from nrenderer_torch.renderers import _wavefront

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
BENCH = REPO / "benchmark"
SCENE = "resource/mesh_box.scn"
SIZE = 16


def _import(path, *names):
    sys.path.insert(0, str(path))
    try:
        return [importlib.import_module(n) for n in names]
    finally:
        sys.path.remove(str(path))


hybrid, mesh, png, tracer = _import(BENCH, "reference.hybrid",
                                    "reference.mesh", "reference.png",
                                    "reference.tracer")
(fixtures,) = _import(REPO / "tools", "make_mesh_fixtures")


@pytest.fixture(scope="module")
def ico(tmp_path_factory):
    """The subdivision-3 icosphere's OBJ and the reference's tables."""
    obj = fixtures.write_icosphere(tmp_path_factory.mktemp("ico"), 3)
    return str(obj), mesh.load(_config(str(obj)), REPO)


def _config(obj):
    return {"scene": SCENE, "obj": [obj], "renderer": "AccPathTracer",
            "estimator": "bsdf", "reference": "hybrid"}


def _traffic(spp, depth):
    return {"width": SIZE, "height": SIZE, "spp": spp, "depth": depth}


def _port(obj, spp, depth, seed, out, monkeypatch):
    """The 8-bit PNG of the port's render command, the float image it
    handed the PNG writer, and the stage roulette's firings."""
    handed = []
    write = image.write_png

    def keep(path, rgb):
        handed.append(np.asarray(rgb))
        write(path, rgb)
    monkeypatch.setattr(image, "write_png", keep)
    rc = cli.main(["render", "--scene", str(REPO / SCENE), "--obj", obj,
                   "--renderer", "AccPathTracer", "--width", str(SIZE),
                   "--height", str(SIZE), "--spp", str(spp), "--depth",
                   str(depth), "--seed", str(seed), "--device", "cpu",
                   "--out", str(out)])
    monkeypatch.setattr(image, "write_png", write)
    assert rc == 0 and len(handed) == 1
    return (png.read(str(out))[..., :3], handed[0][..., :3],
            _wavefront.ROUTE_COUNTS["roulette"])


def _frame():
    return tracer.film_pixels(SIZE, SIZE, SIZE * SIZE,
                              np.random.default_rng(0))


def _judge(port, values, rows, cols):
    """(max_gap, mismatch_share, floats equal): the check's two numbers
    over every pixel of the frame, and the floats before quantisation."""
    img, handed = port[:2]
    want = (np.clip(values, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    gap = np.abs(img[rows, cols].astype(np.int64) - want.astype(np.int64))
    return (int(gap.max()), float((gap != 0).mean()),
            np.array_equal(handed[rows, cols], values))


@pytest.mark.parametrize("spp,depth,seed", [
    (4, 12, 2 ** 31 + 101), (4, 20, 4100000011), (3, 5, 987654323)])
def test_reference_is_the_render_command(ico, spp, depth, seed, tmp_path,
                                         monkeypatch):
    obj, tables = ico
    port = _port(obj, spp, depth, seed, tmp_path / "a.png", monkeypatch)
    assert port[2] == 0   # the stage roulette did not fire
    rows, cols, ids = _frame()
    stats = {}
    values = hybrid.render_values(tables, _config(obj), _traffic(spp, depth),
                                  ids, seed, "cpu", torch.float32, stats)
    assert _judge(port, values, rows, cols) == (0, 0.0, True)
    assert stats["samples"] == SIZE * SIZE * spp
    assert 0 < stats["bounces"] <= stats["samples"] * depth
    assert 0 < stats["box_rays"] < stats["bounces"]
    starts = hybrid.stage_starts(depth)
    assert starts == [6, 11, 16][:len(starts)]
    assert len(starts) == {12: 2, 20: 3, 5: 0}[depth]
    assert (stats.get("stage_rays", 0) > 0) == bool(starts)
    # the contract's 8-bit pixels are those values quantised
    assert np.array_equal(
        hybrid.render_pixels(tables, _config(obj), _traffic(spp, depth),
                             ids[:40], seed, "cpu"), port[0][rows[:40],
                                                             cols[:40]])


def test_below_the_staged_depth_it_is_the_mesh_reference(ico):
    obj, tables = ico
    _, _, ids = _frame()
    seed = 2 ** 31 + 107
    got = hybrid.render_values(tables, _config(obj), _traffic(3, 5), ids,
                               seed, "cpu")
    want = mesh.render_values(tables, _config(obj), _traffic(3, 5), ids,
                              seed, "cpu", route="hybrid")
    assert np.array_equal(got, want)


@pytest.mark.parametrize("fault", ["another seed", "half the samples"])
def test_a_wrong_reference_is_not_correct(ico, fault, tmp_path,
                                          monkeypatch):
    obj, tables = ico
    spp, depth, seed = 4, 20, 2 ** 31 + 113
    port = _port(obj, spp, depth, seed, tmp_path / "a.png", monkeypatch)
    rows, cols, ids = _frame()
    if fault == "another seed":
        seed += 1
    else:
        spp //= 2
    wrong = hybrid.render_values(tables, _config(obj), _traffic(spp, depth),
                                 ids, seed, "cpu")
    max_gap, share, same = _judge(port, wrong, rows, cols)
    assert max_gap > 0 and share > 0.0 and not same


def test_banking_changes_no_number_for_one_term_paths(ico, tmp_path,
                                                      monkeypatch):
    """At depth 20 the port banks each path's radiance at three stage
    boundaries, and the reference's one running sum (as `mesh`'s hybrid
    route sums it) still gives its floats bit for bit: no float, and so
    no 8-bit level, differs.  Each path's radiance has one non-zero term,
    so the per-stage sums round as the running sum does; the check cannot
    tell the two apart, and need not."""
    obj, tables = ico
    spp, depth, seed = 4, 20, 2 ** 31 + 127
    port = _port(obj, spp, depth, seed, tmp_path / "a.png", monkeypatch)
    assert port[2] == 0
    rows, cols, ids = _frame()
    flat = hybrid.render_values(tables, _config(obj), _traffic(spp, depth),
                                ids, seed, "cpu")
    assert _judge(port, flat, rows, cols) == (0, 0.0, True)
    assert np.array_equal(flat, mesh.render_values(
        tables, _config(obj), _traffic(spp, depth), ids, seed, "cpu",
        route="hybrid"))


def _rays(tables, n, seed):
    """Rays about the pool's box: a tenth parallel to the x axis, a tenth
    parallel to y with their origins on a block's face; caps of 0, at a
    random distance and far."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = torch.as_tensor(tables.lo), torch.as_tensor(tables.hi)
    c = (lo.amin(0) + hi.amax(0)) / 2
    o = c + (torch.rand(n, 3, generator=g) - 0.5) * 600
    d = c + (torch.rand(n, 3, generator=g) - 0.5) * 300 - o
    k = n // 10
    d[:k, 0] = 0.0
    o[k:2 * k, 1] = lo[len(lo) // 2, 1]
    d[k:2 * k, 1] = 0.0
    d = d / d.norm(dim=1, keepdim=True)
    cap = torch.full((n,), 2000.0)
    cap[torch.rand(n, generator=g) < 0.2] = 0.0
    cap[5 * k:6 * k] = torch.rand(k, generator=g) * 400
    split = lambda a: mesh.V3(*(a[:, i].contiguous() for i in range(3)))
    return split(o), split(d), cap


@pytest.mark.parametrize("which", ["ico", "blob"])
def test_batched_sweep_is_the_block_by_block_sweep(ico, which):
    tables = ico[1] if which == "ico" else mesh.load(
        _config(str(REPO / "resource/obj/blob_960.obj")), REPO)
    pool = {k: torch.as_tensor(v) for k, v in tables.pool.items()}
    lo, hi = torch.as_tensor(tables.lo), torch.as_tensor(tables.hi)
    o, d, cap = _rays(tables, 6000, 5)
    want = mesh.sweep(pool, lo, hi, o, d, tables.t_min, cap)
    got = hybrid.sweep(pool, lo, hi, o, d, tables.t_min, cap)
    assert int((want[1] >= 0).sum()) > 1000
    assert all(torch.equal(a, b) for a, b in zip(got, want))
