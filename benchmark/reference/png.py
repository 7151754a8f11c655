"""A PNG decoder of the reference's own: 8-bit RGB or RGBA, not
interlaced, any of the five row filters; and an encoder of 8-bit RGBA
(row filter 0), for the check's control.  Imports numpy and zlib only."""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


class PngError(ValueError):
    pass


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def decode(data: bytes) -> np.ndarray:
    """(H, W, C) uint8 pixels of a PNG file's bytes (C = 3 or 4)."""
    if not data.startswith(SIGNATURE):
        raise PngError("not a PNG file")
    pos, ihdr, idat, ended = len(SIGNATURE), None, [], False
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4 or struct.unpack(
                ">I", crc)[0] != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise PngError(f"chunk {tag!r} is cut or its CRC is wrong")
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            ended = True
            break
        pos += 12 + n
    if ihdr is None or not ended:
        raise PngError("no IHDR or no IEND chunk")
    w, h, depth, ctype, _comp, _filt, interlace = ihdr
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise PngError(f"unsupported PNG: depth {depth}, colour type "
                       f"{ctype}, interlace {interlace}")
    bpp = 3 if ctype == 2 else 4
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise PngError("image data has the wrong length")
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(h):
        start = y * (stride + 1)
        ftype = raw[start]
        row = np.frombuffer(raw, np.uint8, stride, start + 1).astype(np.int64)
        if ftype == 0:
            rec = row
        elif ftype == 1:
            rec = np.cumsum(row.reshape(w, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:
            rec = (row + prior) & 0xFF
        elif ftype in (3, 4):
            rec = np.zeros(stride, np.int64)
            for i in range(stride):
                a = int(rec[i - bpp]) if i >= bpp else 0
                b = int(prior[i])
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, int(prior[i - bpp]) if i >= bpp
                                  else 0)
                rec[i] = (int(row[i]) + pred) & 0xFF
        else:
            raise PngError(f"unknown row filter {ftype}")
        out[y] = rec
        prior = rec
    return out.reshape(h, w, bpp)


def read(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def encode(img: np.ndarray) -> bytes:
    """A PNG file's bytes of (H, W, 4) uint8 pixels."""
    h, w, c = img.shape
    if c != 4 or img.dtype != np.uint8:
        raise PngError(f"encode takes (H, W, 4) uint8, not {img.shape} "
                       f"{img.dtype}")
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, w * 4)], axis=1)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(img))
