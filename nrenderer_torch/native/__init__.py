"""The host-side runtime library (`nrnative.cpp`), built with g++ and loaded
through ctypes.

Counterpart of `nrenderer_tpu/native/`, with its own copy of the source:
the OBJ scan of plain triangulated files (`io/obj.py`), the median-split
BVH builder (`ops/bvh.py`) and the film's clamp, gamma and uint8
quantisation.  `g++ -O3 -shared -fPIC -std=c++17` compiles the source into
`build/nrenderer_torch/libnrnative.so` beside the package at first use,
and again only when the source is newer than the library; the compiler
writes a pid-tagged file that replaces the library in one step, so
processes that build at once never load a half-written one.

A missing g++ or a failed compile raises `NativeBuildError` with the
compiler's output.  `NR_NO_NATIVE=1` is the one way to run without the
library: `available()` is then False, the entry points return None, and
their callers take the numpy versions (`io/obj._scan_plain`,
`ops/bvh.build_bvh(use_native=False)`), which the tests hold the library
against.  Nothing is built or loaded at import time."""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .._build import BUILD_DIR

SRC = Path(__file__).resolve().parent / "nrnative.cpp"
LIB_PATH = BUILD_DIR / "libnrnative.so"
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    pass


def disabled() -> bool:
    """Whether `NR_NO_NATIVE=1` selects the numpy versions."""
    return os.environ.get("NR_NO_NATIVE") == "1"


def build() -> Path:
    """Compile the library if it is missing or not newer than the source."""
    if LIB_PATH.exists() and LIB_PATH.stat().st_mtime > SRC.stat().st_mtime:
        return LIB_PATH
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError(
            "g++ not found on PATH: the host library cannot be built "
            "(NR_NO_NATIVE=1 runs the numpy versions instead)")
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [gxx, *GXX_FLAGS, str(SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"g++ failed ({proc.returncode}):\n"
                               + " ".join(cmd) + "\n" + proc.stdout
                               + proc.stderr)
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader sees old or new
    return LIB_PATH


def _load() -> Optional[ctypes.CDLL]:
    """The library (built if needed), or None under NR_NO_NATIVE=1."""
    global _lib
    if disabled():
        return None
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64p = ctypes.POINTER(ctypes.c_int64)
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int32)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.nr_obj_count.argtypes = [ctypes.c_char_p, i64p, i64p, i64p,
                                         i64p]
            lib.nr_obj_count.restype = ctypes.c_int
            lib.nr_obj_parse.argtypes = [ctypes.c_char_p, f32p, f32p, f32p,
                                         i64p, i64p, i64p]
            lib.nr_obj_parse.restype = ctypes.c_int64
            lib.nr_build_bvh.argtypes = [f32p, f32p, ctypes.c_int64, f32p,
                                         f32p, i32p, i32p]
            lib.nr_build_bvh.restype = ctypes.c_int64
            lib.nr_film_to_rgba8.argtypes = [f32p, ctypes.c_int64,
                                             ctypes.c_int, u8p]
            lib.nr_film_to_rgba8.restype = None
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is in use: False under NR_NO_NATIVE=1; else it
    is built and loaded (a failed build raises)."""
    return _load() is not None


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def obj_scan(path: str):
    """The `v`/`vt`/`vn`/`f` records of an OBJ file: (positions (V, 3),
    uvs (T, 2), normals (N, 3) float32, and the (F, 3) int64 face
    position, uv and normal indices, 1-based as in the file, 0 = absent),
    or None when the library is off, the file cannot be read or a record
    does not parse (a face that is not a triangle among them)."""
    lib = _load()
    if lib is None:
        return None
    nv, nt, nn, nf = (ctypes.c_int64() for _ in range(4))
    if lib.nr_obj_count(os.fsencode(path), ctypes.byref(nv),
                        ctypes.byref(nt), ctypes.byref(nn),
                        ctypes.byref(nf)) != 0:
        return None
    v = np.zeros((max(nv.value, 1), 3), np.float32)
    vt = np.zeros((max(nt.value, 1), 2), np.float32)
    vn = np.zeros((max(nn.value, 1), 3), np.float32)
    fv = np.zeros((max(nf.value, 1), 3), np.int64)
    ft = np.zeros_like(fv)
    fn = np.zeros_like(fv)
    n_faces = lib.nr_obj_parse(
        os.fsencode(path), _ptr(v, ctypes.c_float), _ptr(vt, ctypes.c_float),
        _ptr(vn, ctypes.c_float), _ptr(fv, ctypes.c_int64),
        _ptr(ft, ctypes.c_int64), _ptr(fn, ctypes.c_int64))
    if n_faces < 0:
        return None
    return (v[:nv.value], vt[:nt.value], vn[:nn.value], fv[:n_faces],
            ft[:n_faces], fn[:n_faces])


def build_bvh(bb_min: np.ndarray, bb_max: np.ndarray):
    """The median-split BVH of `ops.bvh.build_bvh` over (n, 3) primitive
    boxes: (bb_min, bb_max, skip, prim) in depth-first preorder, or None
    when the library is off or n is 0."""
    lib = _load()
    n = bb_min.shape[0]
    if lib is None or n == 0:
        return None
    n_nodes = 2 * n - 1
    mn = np.ascontiguousarray(bb_min, np.float32)
    mx = np.ascontiguousarray(bb_max, np.float32)
    if mn.shape != (n, 3) or mx.shape != (n, 3):
        raise ValueError(f"boxes of shape {mn.shape} and {mx.shape}: need "
                         "(n, 3) each")
    out_min = np.zeros((n_nodes, 3), np.float32)
    out_max = np.zeros((n_nodes, 3), np.float32)
    skip = np.zeros((n_nodes,), np.int32)
    prim = np.zeros((n_nodes,), np.int32)
    got = lib.nr_build_bvh(
        _ptr(mn, ctypes.c_float), _ptr(mx, ctypes.c_float), n,
        _ptr(out_min, ctypes.c_float), _ptr(out_max, ctypes.c_float),
        _ptr(skip, ctypes.c_int32), _ptr(prim, ctypes.c_int32))
    if got != n_nodes:
        raise RuntimeError(f"nr_build_bvh wrote {got} nodes of {n_nodes}")
    return out_min, out_max, skip, prim


def film_to_rgba8(film: np.ndarray, apply_gamma: bool = False):
    """Clamp (after a sqrt gamma with `apply_gamma`) and quantise a
    (..., 3) float32 film to (..., 4) uint8 RGBA, alpha 255; None when
    the library is off."""
    lib = _load()
    if lib is None:
        return None
    flat = np.ascontiguousarray(film.reshape(-1, 3), np.float32)
    out = np.empty((flat.shape[0], 4), np.uint8)
    lib.nr_film_to_rgba8(_ptr(flat, ctypes.c_float), flat.shape[0],
                         1 if apply_gamma else 0, _ptr(out, ctypes.c_uint8))
    return out.reshape(film.shape[:-1] + (4,))

