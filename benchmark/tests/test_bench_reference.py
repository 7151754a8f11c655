"""The reference's frozen copies against the renderer's own plain versions,
bit for bit, at a tiny size on the CPU, for both configurations: the
tables, the films of every pixel, and the 8-bit pixels of the PNG that
the renderer's CLI writes.  (The tests may import the renderer; the
reference may not.)

    python -m pytest benchmark/tests -q
"""
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

from reference import png, scene, tracer  # noqa: E402

CONFIGS = [("cornell_box.scn", "SimplePathTracer", False),
           ("pt_glass_box.scn", "AccPathTracer", True)]
W, H, SPP, DEPTH = 16, 16, 4, 4


def _scene_path(name):
    return os.path.join(BENCH, "scenes", name)


def _port_static(path):
    from nrenderer_torch import build_scene_arrays, load_scn
    from nrenderer_torch.ops.camera import make_camera
    from nrenderer_torch.ops.intersect import make_static_scene
    sc = load_scn(path)
    return make_static_scene(build_scene_arrays(sc)), make_camera(
        sc.camera, device="cpu")


@pytest.mark.parametrize("name,renderer,bsdf", CONFIGS)
def test_tables_are_the_renderers(name, renderer, bsdf):
    from nrenderer_torch.ops.pt_core import make_mat_channels, scene_epsilon
    ss, cam = _port_static(_scene_path(name))
    ref = scene.load_tables(_scene_path(name))
    assert ref.sph == ss.sph
    for mine, theirs in ((ref.tri, ss.tri), (ref.pln, ss.pln),
                         (ref.al, ss.al)):
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            for x, y in zip(a, b):
                assert np.array_equal(np.asarray(x), np.asarray(y))
                assert np.asarray(x).dtype == np.asarray(y).dtype
    assert tracer.mat_channels(ref, True) == make_mat_channels(ss)
    assert scene.scene_epsilon(ref) == scene_epsilon(ss)
    rc = scene.default_camera()
    for mine, theirs in zip(rc, (cam.position, cam.lower_left,
                                 cam.horizontal, cam.vertical)):
        assert np.array_equal(np.asarray(mine, np.float32), theirs.numpy())


@pytest.mark.parametrize("name,renderer,bsdf", CONFIGS)
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_film_is_the_plain_versions(name, renderer, bsdf, seed):
    from nrenderer_torch.ops.pt_core import scene_epsilon
    from nrenderer_torch.ops.pt_cuda import _int32, pt_accumulate_plain
    ss, cam = _port_static(_scene_path(name))
    want = torch.zeros((W * H, 3), dtype=torch.float32)
    pt_accumulate_plain(want, ss, cam, W, H, 0, SPP, DEPTH, _int32(seed),
                        scene_epsilon(ss), bsdf=bsdf)
    sc = scene.load_tables(_scene_path(name))
    ids = torch.arange(W * H)
    got = tracer.accumulate(sc, scene.default_camera(), ids, W, H, 0, SPP,
                            DEPTH, seed, bsdf)
    assert torch.equal(got, want)
    # any subset of pixels, in any order, is those rows
    perm = torch.randperm(W * H, generator=torch.Generator().manual_seed(1))
    part = tracer.accumulate(sc, scene.default_camera(), perm[:37], W, H, 0,
                             SPP, DEPTH, seed, bsdf)
    assert torch.equal(part, want[perm[:37]])


@pytest.mark.parametrize("name,renderer,bsdf", CONFIGS)
def test_png_is_the_clis(name, renderer, bsdf, tmp_path):
    from nrenderer_torch.cli import main
    out = tmp_path / "out.png"
    seed = 123456789
    rc = main(["render", "--scene", _scene_path(name), "--renderer",
               renderer, "--width", str(W), "--height", str(H), "--spp",
               str(SPP), "--depth", str(DEPTH), "--seed", str(seed),
               "--device", "cpu", "--out", str(out)])
    assert rc == 0
    img = png.read(str(out))
    sc = scene.load_tables(_scene_path(name))
    rows, cols, ids = tracer.film_pixels(W, H, W * H,
                                         np.random.default_rng(0))
    got = tracer.render_pixels(sc, scene.default_camera(), ids, W, H, SPP,
                               DEPTH, seed, bsdf)
    assert np.array_equal(got, img[rows, cols, :3])
    # the samples split in two parts, as two sample-sharded ranks sum them
    two = tracer.render_pixels(sc, scene.default_camera(), ids, W, H, SPP,
                               DEPTH, seed, bsdf, parts=2)
    assert np.abs(two.astype(int) - got.astype(int)).max() <= 1


def test_png_decoder_reads_every_filter():
    import struct
    import zlib
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (5, 7, 4), dtype=np.uint8)
    rows = []
    prior = np.zeros(7 * 4, np.int64)
    for y, ftype in enumerate([0, 1, 2, 3, 4]):
        row = img[y].reshape(-1).astype(np.int64)
        enc = np.zeros_like(row)
        for i in range(row.size):
            a = int(row[i - 4]) if i >= 4 else 0
            b = int(prior[i])
            c = int(prior[i - 4]) if i >= 4 else 0
            pred = [0, a, b, (a + b) >> 1, png._paeth(a, b, c)][ftype]
            enc[i] = (int(row[i]) - pred) & 0xFF
        rows.append(bytes([ftype]) + enc.astype(np.uint8).tobytes())
        prior = row

    def chunk(tag, body):
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))

    data = (png.SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", 7, 5, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))
    assert np.array_equal(png.decode(data), img)
    with pytest.raises(png.PngError):
        png.decode(data[:-5])
