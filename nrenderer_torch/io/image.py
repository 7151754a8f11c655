"""Image IO on the host: texture decode and framebuffer PNG write.

Replaces the reference's stb_image wrapper (`ImageLoader.cpp:8-19`, floats in
[0,1]) and the on-screen blit with a PNG writer.  PNGs of the subset
`encode_png` writes (8-bit RGB or RGBA, non-interlaced, any row filter)
decode with zlib from the standard library, so env maps and textures load
the same on a machine without Pillow; other formats go through Pillow when
it is present.  PNG writing uses Pillow when present and a minimal
pure-python encoder otherwise."""
from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

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


def encode_png(rgb: np.ndarray) -> bytes:
    """Encode an (H, W, 3|4) float [0,1] or uint8 array as PNG bytes
    (the live viewer serves these over HTTP; `write_png` wraps this)."""
    arr = np.asarray(rgb)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    if _HAVE_PIL:
        import io as _io
        buf = _io.BytesIO()
        _PILImage.fromarray(arr).save(buf, format="PNG")
        return buf.getvalue()
    h, w = arr.shape[:2]
    channels = arr.shape[2]
    color_type = {3: 2, 4: 6}[channels]
    raw = b"".join(b"\x00" + arr[row].tobytes() for row in range(h))
    return (b"\x89PNG\r\n\x1a\n"
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                              color_type, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw, 6))
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
