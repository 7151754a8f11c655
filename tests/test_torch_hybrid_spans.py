"""The hybrid route's spans and counters (`renderers/_wavefront.py`,
`ops/mesh_cuda.intersect_triangles_mesh`, `renderers/acc_pt.py`) on a
small CPU render through `cli.main`: one `wavefront.chunk` span a chunk,
one `wavefront.stage` span a stage boundary with its
`wavefront.count-wait`, one `mesh-pipe.reach-wait` span a call of the
mesh pipe and one `mesh-pipe.count-wait` span a read of its pack count,
one `AccPathTracer.film-wait` span a render, each nested where it runs
and counted by the route's counters, which start from zero in every
render.

The `cuda` test renders on the card under
`torch.cuda.set_sync_debug_mode("warn")`: every call in the render phase
that waits on the device lies inside a `*-wait` span, and each such span
holds one, so `wavefront_host_ms.hybrid` (the render phase less those
spans) is the host's own work: `python -m pytest
tests/test_torch_hybrid_spans.py -m cuda`."""
import collections
import pathlib
import sys
import time
import warnings

import pytest
import torch

from nrenderer_torch import cli
from nrenderer_torch.ops import mesh_cuda
from nrenderer_torch.renderers import _wavefront, routes
from nrenderer_torch.utils.timing import GLOBAL_TIMER

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import make_mesh_fixtures  # noqa: E402
sys.path.remove(str(REPO / "tools"))


@pytest.fixture(scope="module")
def obj(tmp_path_factory):
    return str(make_mesh_fixtures.write_icosphere(
        tmp_path_factory.mktemp("ico"), 3))


def _render(obj, depth, out, device="cpu"):
    """One render of two chunks of 8 spp (8192 rays each) whose first
    bounces go through the pipe's pack; (its spans, the counters)."""
    assert cli.main(["render", "--scene", str(REPO / "resource/mesh_box.scn"),
                     "--obj", obj, "--renderer", "AccPathTracer", "--width",
                     "32", "--height", "32", "--spp", "16", "--depth",
                     str(depth), "--seed", "2147483771", "--device", device,
                     "--out", str(out)]) == 0
    spans = GLOBAL_TIMER.spans()
    root = next(s for s in reversed(spans) if s.name == "cli.render")
    counts = {**_wavefront.ROUTE_COUNTS, **mesh_cuda.ROUTE_COUNTS}
    return [s for s in spans if s.render == root.render], counts


@pytest.mark.parametrize("depth", [20, 5])
def test_spans_and_counters_once_each(obj, depth, tmp_path, monkeypatch):
    monkeypatch.setitem(routes.HYBRID_BUDGET_RAYS, "cpu", 8192)
    monkeypatch.setattr(mesh_cuda, "MESH_COMPACT_MIN", 4096)
    spans, counts = _render(obj, depth, tmp_path / "a.png")
    n = collections.Counter(s.name for s in spans)
    stages = 3 if depth == 20 else 0
    assert counts["chunks"] == n["wavefront.chunk"] == 2
    assert counts["stage_packs"] == n["wavefront.stage"] \
        == n["wavefront.count-wait"] == 2 * stages
    assert counts["roulette"] == 0
    # every call of the pipe lists its parallel rays on the host; a pipe
    # pack's count is read once: compacted, or overflowed
    sweeps = counts["compacted"] + counts["uncompacted"] + \
        counts["overflow_full_sweeps"]
    assert n["mesh-pipe.reach-wait"] == sweeps == 2 * depth
    assert n["mesh-pipe.count-wait"] \
        == counts["compacted"] + counts["overflow_full_sweeps"] > 0
    assert n["AccPathTracer.film-wait"] == 1
    by_id = {s.id: s for s in spans}
    render = next(s for s in spans if s.name == "AccPathTracer.render")
    chunks = [s for s in spans if s.name == "wavefront.chunk"]
    assert all(s.parent == render.id for s in chunks)
    assert all(render.t0 <= s.t0 <= s.t1 <= render.t1 for s in chunks)
    assert all(by_id[s.parent].name == "wavefront.chunk" for s in spans
               if s.name in ("wavefront.stage", "mesh-pipe.reach-wait",
                             "mesh-pipe.count-wait"))
    assert by_id[next(s for s in spans if s.name == "AccPathTracer.film-wait"
                      ).parent].name == "AccPathTracer.render"
    assert all(by_id[s.parent].name == "wavefront.stage" for s in spans
               if s.name == "wavefront.count-wait")
    # the counters start from zero in every render
    again, counts2 = _render(obj, depth, tmp_path / "b.png")
    assert counts2 == counts
    assert collections.Counter(s.name for s in again) == n


@pytest.mark.cuda
def test_cuda_every_wait_is_spanned(obj, tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    monkeypatch.setattr(routes, "MEGAMESH_MAX_TRIS_CUDA", 1024)
    monkeypatch.setitem(routes.HYBRID_BUDGET_RAYS, "cuda", 8192)
    monkeypatch.setattr(mesh_cuda, "MESH_COMPACT_MIN", 4096)
    _render(obj, 20, tmp_path / "warm.png", "cuda")   # builds the kernels
    syncs = []
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = lambda *a, **k: syncs.append(
            time.perf_counter())
        torch.cuda.set_sync_debug_mode("warn")
        try:
            spans, counts = _render(obj, 20, tmp_path / "a.png", "cuda")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    render = next(s for s in spans if s.name == "AccPathTracer.render")
    waits = [s for s in spans if s.name.endswith("-wait")]
    inside = [t for t in syncs if render.t0 <= t <= render.t1]
    assert counts["compacted"] > 0 and counts["stage_packs"] == 6
    assert inside and all(any(w.t0 <= t <= w.t1 for w in waits)
                          for t in inside)
    assert all(any(w.t0 <= t <= w.t1 for t in inside) for w in waits)
