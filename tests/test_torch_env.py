"""Env maps: the port's lookups and index math against the JAX package, the
PNG decoder that loads env maps without Pillow, and the procedural env map
fixture `resource/env_sky.png` (made by `make_env_sky` below).

The polynomial angles are compared bit for bit as bins: the port's
`env_bin_index`/`env_native_index` must give the Pallas kernel's row and
column for every direction, grazing the poles and the seam included.
`bin_env_map` must give JAX's table exactly (same numpy code); the exact
lookup `sample_env_map_v3` must give the same texels except where atan2 or
asin of the two backends straddle a texel edge (<= 0.1% of directions)."""
import pathlib
import struct
import zlib

import numpy as np
import pytest
import torch

from nrenderer_torch.io import image
from nrenderer_torch.ops import env as tenv
from nrenderer_torch.ops.soa import V3

torch.set_num_threads(1)

ENV_PNG = pathlib.Path(__file__).resolve().parent.parent / "resource" \
    / "env_sky.png"


def make_env_sky(height: int = 256, width: int = 512) -> np.ndarray:
    """The procedural equirect sky of `resource/env_sky.png`, (H, W, 3)
    uint8: a zenith-to-horizon gradient, a darkening ground and one sun
    disc of 8 degrees radius (+y up, phi = atan2(z, x), as the lookups
    map directions)."""
    v = (np.arange(height) + 0.5) / height
    u = (np.arange(width) + 0.5) / width
    elev = (0.5 - v)[:, None] * np.pi * np.ones((1, width))
    azim = (u - 0.5)[None, :] * 2.0 * np.pi * np.ones((height, 1))
    d = np.stack([np.cos(elev) * np.cos(azim), np.sin(elev),
                  np.cos(elev) * np.sin(azim)], axis=-1)
    t = np.sqrt(np.clip(np.sin(elev), 0.0, 1.0))[..., None]
    sky = (1.0 - t) * np.array([0.85, 0.9, 1.0]) \
        + t * np.array([0.2, 0.4, 0.85])
    g = np.clip(-np.sin(elev), 0.0, 1.0)[..., None]
    ground = (1.0 - g) * np.array([0.45, 0.4, 0.33]) \
        + g * np.array([0.12, 0.1, 0.08])
    img = np.where(elev[..., None] >= 0.0, sky, ground)
    sun = np.array([-0.45, 0.6, 0.66])
    sun = sun / np.linalg.norm(sun)
    img[(d @ sun) > np.cos(np.radians(8.0))] = 1.0
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def test_env_sky_fixture_is_the_procedural_map():
    assert ENV_PNG.stat().st_size < 200_000
    rgba = image.decode_png(ENV_PNG.read_bytes())
    np.testing.assert_array_equal(rgba[:, :, :3], make_env_sky())
    assert (rgba[:, :, 3] == 255).all()


def _filter_row(ftype: int, row: np.ndarray, prior: np.ndarray,
                bpp: int) -> bytes:
    """PNG's forward row filter (the encoder side of `decode_png`)."""
    r = row.astype(np.int64)
    p = prior.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), p[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(r)
    elif ftype == 1:
        pred = a
    elif ftype == 2:
        pred = p
    elif ftype == 3:
        pred = (a + p) // 2
    else:
        pa, pb, pc = (np.abs(p - c), np.abs(a - c), np.abs(a + p - 2 * c))
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, p, c))
    return bytes([ftype]) + ((r - pred) % 256).astype(np.uint8).tobytes()


def _png(img: np.ndarray, filters, interlace: int = 0) -> bytes:
    h, w, ch = img.shape
    flat = img.reshape(h, w * ch)
    prior = np.zeros(w * ch, np.uint8)
    raw = b""
    for y in range(h):
        raw += _filter_row(filters[y % len(filters)], flat[y], prior, ch)
        prior = flat[y]
    chunk = lambda tag, data: (struct.pack(">I", len(data)) + tag + data
                               + struct.pack(">I", zlib.crc32(tag + data)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                         {3: 2, 4: 6}[ch], 0, 0, interlace))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4])
def test_decode_png_every_row_filter(channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (11, 13, channels), dtype=np.uint8)
    rgba = image.decode_png(_png(img, [0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(rgba[:, :, :channels], img)
    if channels == 3:
        assert (rgba[:, :, 3] == 255).all()


def test_decode_png_refuses_outside_its_subset(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    assert image.decode_png(_png(img, [0], interlace=1)) is None
    assert image.decode_png(b"GIF89a...") is None
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"\x89PNG\r\n\x1a\n" + b"\x00" * 10)
    assert image.load_image(str(bad)) is None
    assert image.load_image(str(tmp_path / "missing.png")) is None


def test_load_image_without_pillow(monkeypatch, tmp_path):
    """The port's own PNGs load with Pillow absent, as on a machine
    without it, to the floats Pillow would give."""
    with_pil = image.load_image(str(ENV_PNG))
    monkeypatch.setattr(image, "_HAVE_PIL", False)
    out = tmp_path / "x.png"
    img = np.random.default_rng(0).random((7, 9, 3)).astype(np.float32)
    image.write_png(str(out), img)
    back = image.load_image(str(out))
    assert back.shape == (7, 9, 4) and back.dtype == np.float32
    np.testing.assert_allclose(back[:, :, :3], img, atol=0.5 / 255 + 1e-7)
    np.testing.assert_array_equal(image.load_image(str(ENV_PNG)), with_pil)


def _directions(seed: int, n: int = 65536):
    """Random unit directions plus the poles, the seam (x < 0, z = +-0),
    the axes and directions one ulp off them, float32."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(3, n))
    d /= np.linalg.norm(d, axis=0)
    special = np.array([[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0],
                        [0, 0, 1], [0, 0, -1], [-1, 0, 1e-7], [-1, 0, -1e-7],
                        [-1, 0, 0], [1e-7, 1, 0], [0.6, 0.8, 0]]).T
    d[:, :special.shape[1]] = special
    return d.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_polynomial_bins_match_the_pallas_kernel(seed):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from nrenderer_tpu.ops.pt_pallas import (
        ENV_ROWS, LANES, _asin_approx, _atan2_approx)
    d = _directions(seed)
    jx, jy, jz = (jnp.asarray(c) for c in d)
    u = 0.5 + _atan2_approx(jz, jx) * jnp.float32(0.5 / np.pi)
    v = 0.5 - _asin_approx(jnp.clip(jy, -1.0, 1.0)) * jnp.float32(1.0 / np.pi)
    td = V3(*(torch.from_numpy(c.copy()) for c in d))
    np.testing.assert_array_equal(
        tenv.atan2_approx(td.z, td.x).numpy(),
        np.asarray(_atan2_approx(jz, jx)))
    row, col = tenv.env_bin_index(td)
    np.testing.assert_array_equal(
        col.numpy(), np.asarray(jnp.clip((u * LANES).astype(jnp.int32), 0,
                                         LANES - 1)))
    np.testing.assert_array_equal(
        row.numpy(), np.asarray(jnp.clip((v * ENV_ROWS).astype(jnp.int32), 0,
                                         ENV_ROWS - 1)))
    he, we = 256, 512
    y, x = tenv.env_native_index(td, he, we)
    np.testing.assert_array_equal(
        x.numpy(), np.asarray(jnp.clip((u * we).astype(jnp.int32), 0,
                                       we - 1)))
    np.testing.assert_array_equal(
        y.numpy(), np.asarray(jnp.clip((v * he).astype(jnp.int32), 0,
                                       he - 1)))


@pytest.mark.parametrize("shape", [(256, 512), (32, 128), (20, 50),
                                   (33, 300)])
def test_bin_env_map_matches_jax(shape):
    pytest.importorskip("jax")
    from nrenderer_tpu.ops.env import bin_env_map
    e = np.random.default_rng(shape[0]).random((*shape, 3)).astype(
        np.float32)
    got = tenv.bin_env_map(e)
    assert got.shape == (3, 32, 128) and got.dtype == np.float32
    np.testing.assert_array_equal(got, bin_env_map(e, rows=32, lanes=128))
    if shape == (32, 128):   # a map of the table's size is its own table
        np.testing.assert_array_equal(got, e.transpose(2, 0, 1))


def test_env_lookups_match_jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from nrenderer_tpu.ops.env import sample_env_map_v3
    from nrenderer_tpu.ops.soa import V3 as JV3
    e = make_env_sky().astype(np.float32) / 255.0
    d = _directions(2)
    td = V3(*(torch.from_numpy(c.copy()) for c in d))
    want = sample_env_map_v3(jnp.asarray(e), JV3(*(jnp.asarray(c)
                                                   for c in d)))
    got = tenv.sample_env_map_v3(torch.from_numpy(e), td)
    same = np.ones(d.shape[1], bool)
    for g, w in zip(got, want):
        same &= g.numpy() == np.asarray(w)
    assert same.mean() >= 0.999
    # the kernel's lookups read the texel and the bin their index names
    y, x = tenv.env_native_index(td, *e.shape[:2])
    nat = tenv.env_native_lookup(torch.from_numpy(e), td)
    np.testing.assert_array_equal(nat.x.numpy(), e[y.numpy(), x.numpy(), 0])
    table = torch.from_numpy(tenv.bin_env_map(e))
    row, col = tenv.env_bin_index(td)
    binned = tenv.env_bin_lookup(table, td)
    np.testing.assert_array_equal(binned.z.numpy(),
                                  table[2].numpy()[row.numpy(), col.numpy()])
