"""The port's host library (`nrenderer_torch/native`) against its numpy
versions and the JAX package's.

The library's BVH is bit for bit with the port's numpy builder and with
both of the JAX package's builders; its OBJ scan equals the JAX package's
native scan and the port's numpy scan on every committed fixture and on a
written 20,480-face icosphere, and `load_obj` builds the same `Scene` in
both packages from them; `film_to_rgba8` takes the JAX test's cases.  Each
coordinate of a plain file is rounded once to float32 (as `strtof` rounds
it) by the library and by the numpy scan alike.  The library builds into
`build/nrenderer_torch/`, a failed build raises with the compiler's
output, and NR_NO_NATIVE=1 is the one way to the numpy versions.

Every comparison with the JAX package's library takes it from the
`jax_native` fixture (`test_torch_jax_native.py`), so it runs in every
test order."""
import pathlib
import sys
from decimal import Decimal, localcontext

import numpy as np
import pytest

pytest.importorskip("jax")

import nrenderer_tpu as T  # noqa: E402
from nrenderer_tpu.ops import bvh as jbvh  # noqa: E402

import nrenderer_torch as P  # noqa: E402
from nrenderer_torch import native  # noqa: E402
from nrenderer_torch._build import BUILD_DIR  # noqa: E402
from nrenderer_torch.io import obj as pobj  # noqa: E402
from nrenderer_torch.ops import bvh  # noqa: E402

from test_torch_jax_native import jax_native  # noqa: E402,F401
from test_torch_scene import plain  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
OBJ = REPO / "resource" / "obj"
sys.path.insert(0, str(REPO / "tools"))
import make_mesh_fixtures  # noqa: E402

FIXTURES = sorted(p.name for p in OBJ.glob("*.obj"))
# The decimal of the fault: float64 rounds it onto the midpoint between
# 1.0 and the next float32, and float32 then rounds the tie to even (1.0);
# rounded once it is above the midpoint: 1.0000001
DOUBLE_ROUNDING = "1.000000059604644775390626"


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    monkeypatch.delenv("NR_NO_NATIVE", raising=False)


@pytest.fixture(scope="module")
def ico_20480(tmp_path_factory):
    return make_mesh_fixtures.write_icosphere(
        tmp_path_factory.mktemp("ico"), 5)


def _path(name, ico_20480):
    return ico_20480 if name == "ico_20480.obj" else OBJ / name


def _aabbs(kind):
    rng = np.random.default_rng(5)
    if isinstance(kind, int):
        mn = rng.uniform(-50, 50, (kind, 3)).astype(np.float32)
        return mn, mn + rng.uniform(0.01, 5.0, (kind, 3)).astype(np.float32)
    if kind == "equal_centroids":   # every centroid alike: ties throughout
        mn = np.repeat(rng.uniform(-5, 5, (1, 3)), 300, axis=0)
        mn = (mn - rng.uniform(0, 1, (300, 1))).astype(np.float32)
        return mn, (2 * mn.mean(axis=0) - mn).astype(np.float32)
    a = P.build_scene_arrays(P.load_obj(str(OBJ / kind)))
    v1 = np.asarray(a.tri_v1, np.float32)
    v2 = v1 + np.asarray(a.tri_e1, np.float32)
    v3 = v1 + np.asarray(a.tri_e2, np.float32)
    return (np.minimum(np.minimum(v1, v2), v3),
            np.maximum(np.maximum(v1, v2), v3))


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", [1, 2, 3, 513, "ico_5120.obj",
                                  "equal_centroids"])
def test_library_bvh_is_the_numpy_and_jax_builders(kind, jax_native):
    mn, mx = _aabbs(kind)
    if kind == "equal_centroids":
        c = (mn + mx) * np.float32(0.5)
        assert (c == c[0]).all()
    got = native.build_bvh(mn, mx)
    _assert_same(got, bvh.build_bvh(mn, mx))   # the library by default
    _assert_same(got, bvh.build_bvh(mn, mx, use_native=False))
    _assert_same(got, jbvh.build_bvh(mn, mx, use_native=False))
    _assert_same(got, jax_native.build_bvh(mn, mx))
    _assert_same(got, jbvh.build_bvh(mn, mx, use_native=True))
    n = mn.shape[0]
    assert got[3].shape == (2 * n - 1,)
    assert sorted(got[3][got[3] >= 0].tolist()) == list(range(n))


def test_empty_pool_and_no_native(monkeypatch):
    empty = np.zeros((0, 3), np.float32)
    assert native.build_bvh(empty, empty) is None
    _assert_same(bvh.build_bvh(empty, empty),
                 jbvh.build_bvh(empty, empty))
    monkeypatch.setenv("NR_NO_NATIVE", "1")
    mn, mx = _aabbs(3)
    assert not native.available()
    assert native.build_bvh(mn, mx) is None
    assert native.obj_scan(str(OBJ / "blob_960.obj")) is None
    assert native.film_to_rgba8(np.zeros((1, 3), np.float32)) is None
    _assert_same(bvh.build_bvh(mn, mx), jbvh.build_bvh(mn, mx,
                                                       use_native=False))


@pytest.mark.parametrize("name", FIXTURES + ["ico_20480.obj"])
def test_obj_scan_is_the_numpy_scan(name, ico_20480):
    """The library's scan and its numpy version on the same file; the
    numpy scan refuses the files with materials, which the library's
    C scan reads record by record."""
    path = str(_path(name, ico_20480))
    got = native.obj_scan(path)
    assert got is not None
    want = pobj._scan_plain(path)
    if want is None:
        assert b"mtllib" in pathlib.Path(path).read_bytes()
        assert pobj.scan_plain_file(path) is None
    else:
        _assert_same(got, want)
        _assert_same(pobj.scan_plain_file(path), want)


@pytest.mark.parametrize("name", FIXTURES + ["ico_20480.obj"])
def test_obj_scan_is_the_jax_native_scan(name, ico_20480, jax_native):
    path = str(_path(name, ico_20480))
    _assert_same(native.obj_scan(path), jax_native.obj_scan(path))


@pytest.mark.parametrize("no_native", ["0", "1"])
@pytest.mark.parametrize("name", FIXTURES + ["ico_20480.obj"])
def test_load_obj_builds_the_jax_scene(name, no_native, ico_20480,
                                       monkeypatch, jax_native):
    monkeypatch.setenv("NR_NO_NATIVE", no_native)
    path = str(_path(name, ico_20480))
    ps = P.load_obj(path)
    monkeypatch.delenv("NR_NO_NATIVE")   # the JAX package's native route
    assert plain(T.load_obj(path)) == plain(ps)


def _film_to_rgba8_numpy(film, apply_gamma):
    """`native.film_to_rgba8` in numpy, in the library's float32
    arithmetic (`nrnative.cpp` `nr_film_to_rgba8`)."""
    v = np.asarray(film, np.float32)
    if apply_gamma:
        v = np.sqrt(np.maximum(v, np.float32(0)))
    v = np.clip(v, np.float32(0), np.float32(1))
    rgb = (v * np.float32(255) + np.float32(0.5)).astype(np.uint8)
    return np.concatenate([rgb, np.full(rgb.shape[:-1] + (1,), 255,
                                        np.uint8)], axis=-1)


def test_film_to_rgba8(jax_native):
    """The JAX test's cases (`tests/test_native.py`), then the library
    against numpy and the JAX library on a random film."""
    film = np.array([[[0.0, 0.25, 1.5], [-1.0, 1.0, 0.5]]], np.float32)
    out = native.film_to_rgba8(film, apply_gamma=False)
    assert out.shape == (1, 2, 4) and out.dtype == np.uint8
    np.testing.assert_array_equal(out[0, 0], [0, 64, 255, 255])
    np.testing.assert_array_equal(out[0, 1], [0, 255, 128, 255])
    out_g = native.film_to_rgba8(film, apply_gamma=True)
    assert out_g[0, 0, 1] == int(np.sqrt(0.25) * 255 + 0.5)
    rng = np.random.default_rng(3)
    film = rng.uniform(-0.5, 1.5, (7, 9, 3)).astype(np.float32)
    film[0, 0] = (0.5 / 255, 1.5 / 255, -0.0)   # quantisation ties
    for gamma in (False, True):
        got = native.film_to_rgba8(film, gamma)
        np.testing.assert_array_equal(
            got, _film_to_rgba8_numpy(film, gamma))
        np.testing.assert_array_equal(
            got, jax_native.film_to_rgba8(film, gamma))


def _midpoint_decimals(n: int, seed: int) -> list:
    """Decimals whose float64 value is exactly a float32 midpoint while
    the decimal lies just above or below it (or on it): the inputs that
    rounding through float64 can get wrong.  With them, the point past
    float32's largest value where rounding overflows, nudged both ways."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-300, 300, n).astype(np.float32)
    lo = np.concatenate([lo, np.float32([1e-40, -2e-44, 3.4e38, 1.0,
                                         -7.5])])
    hi = np.nextafter(lo, np.float32(np.inf))
    big = float(np.finfo(np.float32).max)
    out = []
    with localcontext() as ctx:
        ctx.prec = 400   # exact: a float32 midpoint has < 200 digits
        mids = [(Decimal(float(a)) + Decimal(float(b))) / 2
                for a, b in zip(lo, hi)]
        mids += [Decimal(big) + Decimal(2) ** 103] * 2
        for i, mid in enumerate(mids):
            nudge = mid.copy_abs() * Decimal("1e-30") * (i % 3 - 1)
            out.append(format(mid + nudge, "e"))
    return out


def test_coordinates_round_once(tmp_path, ico_20480, jax_native):
    """The double-rounding fault: `np.float32(float(s))` rounds twice
    and reads DOUBLE_ROUNDING as 1.0, where `strtof` reads 1.0000001.
    The JAX package's native scan, the port's library and the port's
    numpy scan read the same float32 for it and for decimals around
    float32 midpoints; the old rule (round through float64) differs on
    each nudged one."""
    decimals = [DOUBLE_ROUNDING] + _midpoint_decimals(200, 11)
    assert float(np.float32(float(DOUBLE_ROUNDING))) == 1.0
    rows = [decimals[i:i + 3] for i in range(0, len(decimals) - 2, 3)]
    text = "".join(f"v {' '.join(r)}\n" for r in rows)
    text += "f 1 2 3\n"
    path = tmp_path / "midpoints.obj"
    path.write_text(text)
    lib = native.obj_scan(str(path))[0]
    numpy_scan = pobj._scan_plain(str(path))[0]
    np.testing.assert_array_equal(lib, numpy_scan)
    assert lib[0, 0] == np.float32(1.0000001) != np.float32(1.0)
    np.testing.assert_array_equal(lib, jax_native.obj_scan(str(path))[0])
    flat = [d for r in rows for d in r]
    with np.errstate(over="ignore"):
        old = np.float32([float(d) for d in flat]).reshape(-1, 3)
    differs = old != lib
    # a decimal nudged off its midpoint toward the odd neighbour reads
    # differently now (about half the nudged ones); the rest as before
    nudged = np.array([Decimal(d) != Decimal(float(d)) for d in flat]
                      ).reshape(-1, 3)
    assert differs[0, 0] and differs.sum() > nudged.sum() // 4
    assert not differs[~nudged].any()
    # a plain file without midpoints reads as before
    ico = pobj._scan_plain(str(ico_20480))[0]
    toks = [line.split()[1:] for line in ico_20480.read_text().splitlines()
            if line.startswith("v ")]
    np.testing.assert_array_equal(
        ico, np.float32([[float(x) for x in t] for t in toks]))


def test_build_goes_to_build_dir_and_is_kept():
    assert native.available()
    assert native.LIB_PATH == BUILD_DIR / "libnrnative.so"
    assert native.LIB_PATH.exists()
    mtime = native.LIB_PATH.stat().st_mtime
    assert native.build() == native.LIB_PATH   # newer than the source
    assert native.LIB_PATH.stat().st_mtime == mtime
    assert not list(BUILD_DIR.glob("libnrnative.so.*.tmp"))


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "nrnative.cpp"
    bad.write_text('extern "C" int nr_obj_count( {\n')
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "libnrnative.so")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ failed"):
        native.available()
    assert not list(tmp_path.glob("*.so*"))
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(native.NativeBuildError, match="NR_NO_NATIVE=1"):
        native.obj_scan(str(OBJ / "blob_960.obj"))
    monkeypatch.setenv("NR_NO_NATIVE", "1")
    assert not native.available()   # the one way round the library
