"""Image IO on the host: texture decode and framebuffer PNG write.

Replaces the reference's stb_image wrapper (`ImageLoader.cpp:8-19`, floats in
[0,1]) and the on-screen blit with a PNG writer.  Uses PIL when present and
falls back to a minimal pure-python PNG codec so the package has no hard
dependency beyond numpy."""
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


def load_image(path: str) -> Optional[np.ndarray]:
    """Decode an image file to (H, W, 4) float32 RGBA in [0,1].
    Returns None if the file is missing or undecodable (reference behavior:
    importer logs and continues)."""
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
