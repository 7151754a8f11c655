"""The port's PNG writer (`nrenderer_torch/io/image.py` `encode_png`): the
Average filter over every row and the level-6 deflate in row bands, held
to the pixels of the Pillow encode it replaced under three decoders
(Pillow, `image.decode_png`, and plain zlib with the unfilter below), on
both the single-band and the banded path; its counter, its size against
Pillow's, and concurrent writers sharing the deflate threads."""
import io
import struct
import sys
import threading
import zlib

import numpy as np
import pytest
from PIL import Image

from nrenderer_torch.io import image

SHAPES = [(1, 1), (7, 9), (64, 64), (300, 257), (512, 512)]


def _pillow_png(rgb: np.ndarray) -> bytes:
    """The writer this one replaced: quantise, then Pillow's PNG at its
    defaults (zlib level 6, adaptive row filters)."""
    arr = np.asarray(rgb)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _render_like(h: int, w: int, channels: int, seed: int,
                 noise: float = 3 / 255) -> np.ndarray:
    """(H, W, C) float32: a smooth colour gradient with seeded noise that
    strays past [0, 1] at the edges, alpha 1."""
    rng = np.random.default_rng(seed)
    y = np.linspace(-0.02, 1.02, h, dtype=np.float32)[:, None]
    x = np.linspace(-0.02, 1.02, w, dtype=np.float32)[None, :]
    rgb = np.stack([x * np.ones_like(y), y * np.ones_like(x),
                    0.5 * (x + y)], axis=-1)
    rgb = rgb + rng.uniform(-noise, noise, rgb.shape).astype(np.float32)
    if channels == 4:
        rgb = np.concatenate([rgb, np.ones((h, w, 1), np.float32)], axis=-1)
    return rgb


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _plain_decode(data: bytes) -> np.ndarray:
    """(H, W, C) uint8 of an 8-bit, non-interlaced RGB or RGBA PNG: zlib
    and a byte-by-byte unfilter of the five row filters."""
    pos, idat = 8, []
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", data[pos + 8:pos + 8 + n])
        elif tag == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    assert depth == 8 and ctype in (2, 6) and interlace == 0
    bpp = 3 if ctype == 2 else 4
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    assert len(raw) == h * (stride + 1)
    rows, prior = [], bytearray(stride)
    for y in range(h):
        ftype = raw[y * (stride + 1)]
        cur = bytearray(raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)])
        assert ftype <= 4
        for i in range(stride):
            a = cur[i - bpp] if i >= bpp else 0
            b = prior[i]
            if ftype == 1:
                pred = a
            elif ftype == 2:
                pred = b
            elif ftype == 3:
                pred = (a + b) >> 1
            elif ftype == 4:
                pred = _paeth(a, b, prior[i - bpp] if i >= bpp else 0)
            else:
                pred = 0
            cur[i] = (cur[i] + pred) & 0xFF
        rows.append(cur)
        prior = cur
    return np.frombuffer(b"".join(rows), np.uint8).reshape(h, w, bpp)


def _header(data: bytes) -> tuple:
    """IHDR's (bit depth, colour type, interlace) and the zlib header."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and data[12:16] == b"IHDR"
    _w, _h, depth, ctype, _, _, interlace = struct.unpack(
        ">IIBBBBB", data[16:29])
    return depth, ctype, interlace, data[41:43]


@pytest.mark.parametrize("bands", [None, 1, 3, "each row"])
@pytest.mark.parametrize("channels", [3, 4])
@pytest.mark.parametrize("dtype", ["float32", "uint8"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_same_pixels_as_pillow(shape, dtype, channels, bands):
    """Every decoder reads the parent's pixels bit for bit; "each row" puts
    a band cut after the first row and before the last."""
    h, w = shape
    img = _render_like(h, w, channels, seed=h * 1000 + w)
    if dtype == "uint8":
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    data = image.encode_png(img, _bands=h if bands == "each row" else bands)
    want = np.asarray(Image.open(io.BytesIO(_pillow_png(img))))
    assert want.shape == (h, w, channels)
    assert _header(data) == (8, {3: 2, 4: 6}[channels], 0, b"\x78\x9c")
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))),
                                  want)
    np.testing.assert_array_equal(image.decode_png(data)[..., :channels],
                                  want)
    np.testing.assert_array_equal(_plain_decode(data), want)


@pytest.mark.parametrize("size,path", [(512, "banded"), (64, "single")])
def test_counter_counts_the_path(size, path):
    """A 512² RGBA frame takes the banded path wherever more than one CPU
    is usable, one band a CPU up to one per 64 KiB; a 64² one deflates
    inline."""
    cpus = image._usable_cpus()
    if cpus == 1:
        path = "single"
    nbytes = size * (size * 4 + 1)
    bands = 1 if path == "single" else min(cpus, nbytes // (64 * 1024))
    before = dict(image.PNG_ENCODES)
    image.encode_png(_render_like(size, size, 4, seed=size))
    gained = {k: image.PNG_ENCODES[k] - before[k] for k in before}
    assert gained == {"single": int(path == "single"),
                      "banded": int(path == "banded"), "bands": bands}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_size_within_five_percent_of_pillow(seed):
    img = _render_like(512, 512, 4, seed)
    assert len(image.encode_png(img)) <= 1.05 * len(_pillow_png(img))


def test_concurrent_writers_share_the_deflate_threads():
    """More writers than CPUs, each banded, with a short switch interval:
    every PNG decodes to its own image and no count is lost."""
    n_threads = 2 * image._usable_cpus() + 2
    imgs = [_render_like(96, 80, 4, seed=k) for k in range(n_threads)]
    want = [(np.clip(x, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
            for x in imgs]
    out = [None] * n_threads
    before = dict(image.PNG_ENCODES)

    def write(k):
        for _ in range(4):
            out[k] = image.encode_png(imgs[k], _bands=5)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=write, args=(k,))
                   for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    for k in range(n_threads):
        np.testing.assert_array_equal(image.decode_png(out[k]), want[k])
    assert image.PNG_ENCODES["banded"] - before["banded"] == 4 * n_threads
    assert image.PNG_ENCODES["bands"] - before["bands"] == 20 * n_threads
