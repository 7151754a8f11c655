"""The benchmark's mesh reference (`benchmark/reference/mesh.py`) against
the port's own `render` command on the CPU, at sizes a test run holds:
every pixel of the PNG and every float the PNG writer receives, for the
megamesh route (`blob_960.obj`, the CPU's pools up to 1024 triangles)
and the hybrid route (`ico_5120.obj`, whose film the megamesh film equals
on a shared pool).  Faults come out not correct: the reference of half
the passes, of another render seed, and of the mesh with one vertex moved
by one ulp (which shows in the hits of the frame's camera rays)."""
import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

from nrenderer_torch import cli
from nrenderer_torch.io import image

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
BENCH = REPO / "benchmark"
SCENE = "resource/mesh_box.scn"
BLOB, ICO = "resource/obj/blob_960.obj", "resource/obj/ico_5120.obj"


def _reference():
    """The reference's modules, imported with the benchmark's folder on
    the path only while they load."""
    sys.path.insert(0, str(BENCH))
    try:
        return (importlib.import_module("reference.mesh"),
                importlib.import_module("reference.png"),
                importlib.import_module("reference.scene"),
                importlib.import_module("reference.tracer"))
    finally:
        sys.path.remove(str(BENCH))


mesh, png, scene, tracer = _reference()


def _config(obj):
    return {"scene": SCENE, "obj": [obj], "renderer": "AccPathTracer",
            "estimator": "bsdf", "reference": "mesh"}


def _port(obj, size, spp, depth, seed, out, monkeypatch):
    """The 8-bit PNG of the port's render command and the float image it
    handed the PNG writer."""
    handed = []
    write = image.write_png

    def keep(path, rgb):
        handed.append(np.asarray(rgb))
        write(path, rgb)
    monkeypatch.setattr(image, "write_png", keep)
    rc = cli.main(["render", "--scene", str(REPO / SCENE), "--obj",
                   str(REPO / obj), "--renderer", "AccPathTracer",
                   "--width", str(size), "--height", str(size), "--spp",
                   str(spp), "--depth", str(depth), "--seed", str(seed),
                   "--device", "cpu", "--out", str(out)])
    monkeypatch.setattr(image, "write_png", write)
    assert rc == 0 and len(handed) == 1
    return png.read(str(out))[..., :3], handed[0][..., :3]


def _judge(port, ref_values, rows, cols):
    """(correct, max_gap, mismatch_share, floats equal): the check's two
    numbers at limits of 0, over every pixel of the frame, and the floats
    before quantisation, bit for bit."""
    img, handed = port
    want = (np.clip(ref_values, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    gap = np.abs(img[rows, cols].astype(np.int64) - want.astype(np.int64))
    same = np.array_equal(handed[rows, cols], ref_values)
    max_gap, share = int(gap.max()), float((gap != 0).mean())
    return max_gap == 0 and share == 0.0 and same, max_gap, share, same


def _frame(size, seed=0):
    return tracer.film_pixels(size, size, size * size,
                              np.random.default_rng(seed))


@pytest.mark.parametrize("obj,route,size,spp,depth,seed", [
    (BLOB, "megamesh", 16, 4, 6, 2 ** 31 + 11),
    (ICO, "hybrid", 16, 2, 5, 987654321),
])
def test_reference_is_the_render_command(obj, route, size, spp, depth, seed,
                                         tmp_path, monkeypatch):
    port = _port(obj, size, spp, depth, seed, tmp_path / "a.png",
                 monkeypatch)
    tables = mesh.load(_config(obj), REPO)
    rows, cols, ids = _frame(size)
    traffic = {"width": size, "height": size, "spp": spp, "depth": depth}
    stats = {}
    values = mesh.render_values(tables, _config(obj), traffic, ids, seed,
                                "cpu", torch.float32, stats, route=route)
    correct, max_gap, share, same = _judge(port, values, rows, cols)
    assert (max_gap, share, same) == (0, 0.0, True)
    assert correct
    assert stats["samples"] == size * size * spp
    assert 0 < stats["bounces"] <= stats["samples"] * depth
    # the contract's 8-bit pixels are those values quantised
    assert np.array_equal(
        mesh.render_pixels(tables, _config(obj), traffic, ids[:40], seed,
                           "cpu", route=route), port[0][rows[:40],
                                                        cols[:40]])


@pytest.mark.parametrize("fault", ["half the passes", "another seed"])
def test_a_wrong_reference_is_not_correct(fault, tmp_path, monkeypatch):
    """The megamesh route at 64 spp (two passes of 32) against the
    reference of its first pass alone, and of another render seed."""
    size, spp, depth, seed = 16, 64, 4, 2 ** 31 + 17
    port = _port(BLOB, size, spp, depth, seed, tmp_path / "a.png",
                 monkeypatch)
    tables = mesh.load(_config(BLOB), REPO)
    rows, cols, ids = _frame(size)
    traffic = {"width": size, "height": size, "spp": spp, "depth": depth}
    right = mesh.render_values(tables, _config(BLOB), traffic, ids, seed,
                               "cpu")
    assert _judge(port, right, rows, cols)[0]
    if fault == "half the passes":
        assert len(mesh.passes("megamesh", size, size, spp, seed)) == 2
        traffic = dict(traffic, spp=spp // 2)
    else:
        seed += 1
    wrong = mesh.render_values(tables, _config(BLOB), traffic, ids, seed,
                               "cpu")
    correct, max_gap, share, _ = _judge(port, wrong, rows, cols)
    assert not correct and max_gap > 0 and share > 0.0


def _camera_hits(tables, size, seed):
    """(t, triangle, normal) of the reference's sweep for the first
    camera ray of every pixel in the megamesh route's first pass."""
    n = size * size
    pix = torch.arange(n)
    o, d = tracer.camera_rays(scene.default_camera(), pix,
                              torch.zeros(n, dtype=torch.int64),
                              torch.full((n,), (seed * 100003) & 0xFFFFFFFF),
                              size, size, torch.float32, "cpu")
    pool = {k: torch.as_tensor(v) for k, v in tables.pool.items()}
    t, pid, nx, ny, nz, _ = mesh.sweep(
        pool, torch.as_tensor(tables.lo), torch.as_tensor(tables.hi), o, d,
        tables.t_min, torch.full((n,), float("inf")))
    return o, d, t, pid, torch.stack([nx, ny, nz])


def test_a_vertex_moved_one_ulp_is_not_correct(tmp_path):
    """The reference's hits of the frame's camera rays are the port's own
    plain sweep's, bit for bit; with one vertex of the most-hit face moved
    by one ulp (its largest coordinate), they are not.  (The image cannot
    show such a move at this size: a Lambertian path's weight reads the
    hit's normal only through the rounding of its cosines, and few
    checked paths reach the light.)"""
    from nrenderer_torch import build_scene_arrays, load_scn
    from nrenderer_torch.io.obj import load_obj
    from nrenderer_torch.ops.bvh import build_mesh_accel
    from nrenderer_torch.ops.intersect import make_static_scene
    from nrenderer_torch.ops.mesh_cuda import make_mesh_tables, \
        sweep_mesh_plain
    from nrenderer_torch.ops.pt_core import make_mat_channels, scene_epsilon
    size, seed = 16, 2 ** 31 + 23
    sc = load_scn(str(REPO / SCENE))
    load_obj(str(REPO / BLOB), sc, material=0)
    arrays = build_scene_arrays(sc)
    ss = make_static_scene(arrays)
    mt = make_mesh_tables(build_mesh_accel(arrays, make_mat_channels(
        ss)).bt, "cpu")
    tables = mesh.load(_config(BLOB), REPO)
    assert tables.t_min == scene_epsilon(ss)
    o, d, t, pid, nrm = _camera_hits(tables, size, seed)
    want = sweep_mesh_plain(mt, o, d, scene_epsilon(ss),
                            torch.full_like(t, float("inf")))
    assert int((pid >= 0).sum()) > 8
    assert torch.equal(t, want[0]) and torch.equal(pid, want[1])
    assert torch.equal(nrm, torch.stack(want[2:5]))

    pos, faces = mesh.read_obj(str(REPO / BLOB))
    face = int(torch.bincount(pid[pid >= 0].long()).argmax())
    vertex = int(faces[face, 0])
    axis = int(np.argmax(np.abs(pos[vertex])))
    lines = (REPO / BLOB).read_text().splitlines()
    at = [i for i, line in enumerate(lines) if line.startswith("v ")][vertex]
    words = lines[at].split()
    words[1 + axis] = np.format_float_positional(
        np.nextafter(pos[vertex, axis], np.float32(np.inf)), unique=True)
    lines[at] = " ".join(words)
    moved = tmp_path / "moved.obj"
    moved.write_text("\n".join(lines) + "\n")
    moved_pos = mesh.read_obj(str(moved))[0]
    assert int((moved_pos != pos).sum()) == 1
    _, _, t2, pid2, nrm2 = _camera_hits(
        mesh.load(_config(str(moved)), REPO), size, seed)
    assert not (torch.equal(t2, want[0])
                and torch.equal(nrm2, torch.stack(want[2:5])))


def test_reader_rounds_each_decimal_once():
    """Decimals whose float64 value lies exactly halfway between two
    float32 values: the decimal decides, as `strtof` rounds it (through
    float64 the ones just beside a midpoint round twice, wrongly); the
    fixtures' coordinates are the port's own."""
    from nrenderer_torch.io.obj import _scan_plain
    one = np.float32(1.0)
    up = lambda x, k=1: x if k == 0 else up(
        np.nextafter(x, np.float32(2.0)), k - 1)
    got = mesh.float32_once([
        "1.000000059604644775390625",      # the midpoint: ties to even
        "1.0000000596046447753906251",     # just above it
        "1.000000178813934326171875",      # a midpoint, even above
        "1.0000001788139343261718749"])    # just below that one
    assert list(got) == [one, up(one), up(one, 2), up(one)]
    for obj in (BLOB, ICO):
        pos, faces = mesh.read_obj(str(REPO / obj))
        want = _scan_plain(str(REPO / obj))
        assert np.array_equal(pos, want[0])
        assert np.array_equal(faces, want[3] - 1)
