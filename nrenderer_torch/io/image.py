"""Image IO on the host: texture decode and framebuffer PNG write.

Replaces the reference's stb_image wrapper (`ImageLoader.cpp:8-19`, floats in
[0,1]) and the on-screen blit with a PNG writer.  PNGs of the subset
`encode_png` writes (8-bit RGB or RGBA, non-interlaced, any row filter)
decode with zlib from the standard library, so env maps and textures load
the same on a machine without Pillow; other formats go through Pillow when
it is present.  The writer is numpy and zlib alone: every row under the
Average filter, the rows cut into bands that threads deflate at level 6 side
by side (zlib releases the interpreter lock while it compresses), joined into
one zlib stream."""
from __future__ import annotations

import os
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np

from ..utils.timing import GLOBAL_TIMER

try:
    from PIL import Image as _PILImage
    _HAVE_PIL = True
except Exception:  # pragma: no cover
    _HAVE_PIL = False


_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _unfilter_sequential(ftype: int, row: bytearray, prior: bytes,
                         bpp: int) -> None:
    """Undo PNG filter 3 (Average) or 4 (Paeth) in place: each byte
    depends on the reconstructed byte `bpp` to its left."""
    for i in range(len(row)):
        a = row[i - bpp] if i >= bpp else 0
        b = prior[i]
        if ftype == 3:
            row[i] = (row[i] + ((a + b) >> 1)) & 0xFF
            continue
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        row[i] = (row[i] + pred) & 0xFF


def decode_png(data: bytes) -> Optional[np.ndarray]:
    """(H, W, 4) uint8 RGBA of an 8-bit RGB/RGBA non-interlaced PNG, or
    None for anything outside that subset."""
    if not data.startswith(_PNG_SIG):
        return None
    pos, ihdr, idat = len(_PNG_SIG), None, []
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            return None
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if ihdr is None:
        return None
    w, h, bit_depth, color_type, _comp, _filt, interlace = ihdr
    if bit_depth != 8 or color_type not in (2, 6) or interlace != 0:
        return None
    bpp = 3 if color_type == 2 else 4
    stride = w * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error:
        return None
    if len(raw) < h * (stride + 1):
        return None
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        start = y * (stride + 1)
        ftype = raw[start]
        row = np.frombuffer(raw, np.uint8, stride, start + 1)
        if ftype == 0:
            rec = row
        elif ftype == 1:    # Sub: running sum per channel along the row
            rec = np.cumsum(row.reshape(w, bpp), axis=0,
                            dtype=np.uint64).astype(np.uint8).reshape(-1)
        elif ftype == 2:    # Up
            rec = row + prior
        elif ftype in (3, 4):
            buf = bytearray(row.tobytes())
            _unfilter_sequential(ftype, buf, prior.tobytes(), bpp)
            rec = np.frombuffer(bytes(buf), np.uint8)
        else:
            return None
        out[y] = rec
        prior = out[y]
    img = out.reshape(h, w, bpp)
    if bpp == 3:
        img = np.concatenate([img, np.full((h, w, 1), 255, np.uint8)],
                             axis=2)
    return img


def load_image(path: str) -> Optional[np.ndarray]:
    """Decode an image file to (H, W, 4) float32 RGBA in [0,1].
    Returns None if the file is missing or undecodable (reference behavior:
    importer logs and continues)."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    rgba = decode_png(data)
    if rgba is not None:
        return rgba.astype(np.float32) / 255.0
    try:
        if _HAVE_PIL:
            with _PILImage.open(path) as im:
                arr = np.asarray(im.convert("RGBA"), dtype=np.float32) / 255.0
            return arr
    except Exception:
        return None
    return None


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    chunk = tag + data
    return (struct.pack(">I", len(data)) + chunk
            + struct.pack(">I", zlib.crc32(chunk) & 0xFFFFFFFF))


# A band is at least this many filtered bytes: below it the hand-off to a
# thread costs more than the band's share of the deflate saves.
_BAND_MIN_BYTES = 64 * 1024
# deflate's window: a band is primed with this much of the stream before it
_WINDOW = 32 * 1024

# Encodes by path, and the bands they deflated in all (one for a single-band
# encode): a caller reads them before and after to see how wide writes ran.
PNG_ENCODES = {"single": 0, "banded": 0, "bands": 0}
_COUNT_LOCK = threading.Lock()
_POOL: Optional[ThreadPoolExecutor] = None
_POOL_LOCK = threading.Lock()


def _usable_cpus() -> int:
    return len(os.sched_getaffinity(0))


def _deflate_pool() -> ThreadPoolExecutor:
    """The process's deflate threads, started at the first banded write."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(_usable_cpus(),
                                       thread_name_prefix="png-deflate")
        return _POOL


def _filter_average(px: np.ndarray, bpp: int) -> np.ndarray:
    """(H, 1 + stride) uint8: each row of the (H, stride) samples under PNG
    filter 3 (Average), its filter byte first, all rows at once."""
    h, stride = px.shape
    pred = np.zeros((h, stride), np.uint16)
    pred[:, bpp:] += px[:, :-bpp]
    pred[1:] += px[:-1]
    pred >>= 1
    out = np.empty((h, stride + 1), np.uint8)
    out[:, 0] = 3
    # the difference mod 256 is its low byte
    np.subtract(px, pred, out=out[:, 1:], casting="unsafe")
    return out


def _deflate_band(data: memoryview, lo: int, hi: int, last: bool) -> bytes:
    """Raw deflate at level 6 of data[lo:hi], primed with the window of the
    stream before `lo` (what the decoder holds there), ended on a byte
    boundary (sync flush), or as the stream's final block."""
    if lo:
        c = zlib.compressobj(6, zlib.DEFLATED, -15,
                             zdict=data[max(0, lo - _WINDOW):lo])
    else:
        c = zlib.compressobj(6, zlib.DEFLATED, -15)
    return c.compress(data[lo:hi]) + c.flush(
        zlib.Z_FINISH if last else zlib.Z_SYNC_FLUSH)


def _zlib_stream(filtered: np.ndarray, bands: Optional[int]) -> bytes:
    """The zlib stream of the filtered rows, deflated in `bands` bands of
    whole rows (None: as many as there are usable CPUs, each of at least
    `_BAND_MIN_BYTES`); the calling thread deflates the first band."""
    h, row = filtered.shape
    if bands is None:
        bands = min(_usable_cpus(), filtered.nbytes // _BAND_MIN_BYTES)
    bands = max(1, min(bands, h))
    data = memoryview(filtered.reshape(-1))
    cuts = [h * i // bands * row for i in range(bands + 1)]
    jobs = [(cuts[i], cuts[i + 1], i == bands - 1) for i in range(bands)]
    rest = [_deflate_pool().submit(_deflate_band, data, *job)
            for job in jobs[1:]]
    parts = [_deflate_band(data, *jobs[0])] + [f.result() for f in rest]
    with _COUNT_LOCK:
        PNG_ENCODES["single" if bands == 1 else "banded"] += 1
        PNG_ENCODES["bands"] += bands
    # header: deflate, 32 KiB window, default level; Adler-32 closes it
    return (b"\x78\x9c" + b"".join(parts)
            + struct.pack(">I", zlib.adler32(data)))


def encode_png(rgb: np.ndarray, _bands: Optional[int] = None) -> bytes:
    """Encode an (H, W, 3|4) float [0,1] or uint8 array as PNG bytes: 8-bit
    RGB or RGBA as given, not interlaced (the live viewer serves these over
    HTTP; `write_png` wraps this).  `_bands` fixes the band count (tests)."""
    with GLOBAL_TIMER.phase("png.quantise-filter"):
        arr = np.asarray(rgb)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        if arr.ndim == 2:
            arr = np.repeat(arr[:, :, None], 3, axis=2)
        h, w, channels = arr.shape
        if channels not in (3, 4):
            raise ValueError(f"encode_png takes 3 or 4 channels, not "
                             f"{channels}")
        filtered = _filter_average(arr.reshape(h, w * channels), channels)
    with GLOBAL_TIMER.phase("png.deflate"):
        stream = _zlib_stream(filtered, _bands)
    color_type = 2 if channels == 3 else 6
    return (_PNG_SIG
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                              color_type, 0, 0, 0))
            + _png_chunk(b"IDAT", stream)
            + _png_chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) or (H, W, 4) float [0,1] or uint8 array as PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def read_png(path: str) -> Optional[np.ndarray]:
    """Read an image to (H, W, 3) float32 RGB in [0,1] (golden-image tests)."""
    img = load_image(path)
    if img is None:
        return None
    return img[:, :, :3]
