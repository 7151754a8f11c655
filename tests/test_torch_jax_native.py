"""The JAX package's native library for the port's tests, and the test
that a lost build race cannot take it from them.

The JAX package's loader (`nrenderer_tpu/native/__init__.py`) builds its
library at first use into its package directory, not atomically, and
keeps a failed load for the life of the process: test workers that build
it at once can leave one of them without the library, and a comparison
with it then never runs.  `jax_native` builds the JAX package's source
with that loader's own command into a directory of this process, points
the loader there, resets it as if it had never run and loads through it,
so the comparisons run in every test order; `jax_loader` does the same
for modules that reach the loader only through the JAX package
(`load_obj`, `build_bvh`), so that no port test writes under
`nrenderer_tpu/`.  Both restore the loader after the requesting module."""
import ctypes
import importlib.util
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

from nrenderer_torch import native

OBJ = pathlib.Path(__file__).resolve().parent.parent / "resource" / "obj"

# `nrenderer_tpu/native/__init__.py` `_build`'s command, minus its output
JAX_BUILD = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]
_JAX_LIBS = {}   # this process's build of the JAX package's library


def build_jax_library(tmp_path_factory) -> pathlib.Path:
    """The JAX package's source built into a directory of this process,
    once a process; fails with g++'s output where it does not build."""
    from nrenderer_tpu import native as jnative
    if shutil.which("g++") is None:
        pytest.skip("g++ is not on PATH: the JAX package's native library "
                    "cannot build")
    if "lib" not in _JAX_LIBS:
        lib = tmp_path_factory.mktemp("jax_native") / "libnrnative.so"
        res = subprocess.run(JAX_BUILD + [str(jnative._SRC), "-o", str(lib)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            pytest.fail("g++ did not build the JAX package's native "
                        f"library:\n{res.stderr}")
        _JAX_LIBS["lib"] = lib
    return _JAX_LIBS["lib"]


def _private_loader(tmp_path_factory):
    pytest.importorskip("jax")
    from nrenderer_tpu import native as jnative
    lib = build_jax_library(tmp_path_factory)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB", lib)
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_tried", False)
        mp.delenv("NR_NO_NATIVE", raising=False)
        if not jnative.available():
            try:
                ctypes.CDLL(str(lib))
            except OSError as e:
                pytest.fail("the JAX package's native library did not "
                            f"load: {e}")
            pytest.fail(f"the JAX package's loader did not load {lib}")
        yield jnative


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native module with its library loaded; skips
    only where JAX or g++ is missing."""
    yield from _private_loader(tmp_path_factory)


@pytest.fixture(scope="module")
def jax_loader(tmp_path_factory):
    """`jax_native` where JAX and g++ are there; else nothing (without
    g++ the JAX loader builds nothing), so the module's tests run."""
    if importlib.util.find_spec("jax") is None or shutil.which("g++") is None:
        yield None
    else:
        yield from _private_loader(tmp_path_factory)


@pytest.fixture(scope="module")
def lost_race(tmp_path_factory):
    """The JAX loader as a worker that lost the race leaves it: tried, no
    library, a truncated library at the path it reads.  Restored after
    the module."""
    pytest.importorskip("jax")
    from nrenderer_tpu import native as jnative
    whole = build_jax_library(tmp_path_factory).read_bytes()
    cut = tmp_path_factory.mktemp("lost_race") / "libnrnative.so"
    # cut inside the program headers, which dlopen reads and refuses; a
    # file cut past them maps pages beyond its end, and the first touch
    # kills the process (SIGBUS) instead
    cut.write_bytes(whole[:256])
    before = (jnative._LIB, jnative._lib, jnative._tried)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("NR_NO_NATIVE", raising=False)
        mp.setattr(jnative, "_LIB", cut)
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_tried", False)
        assert not jnative.available()   # the truncated file does not load
        assert jnative._tried and jnative._lib is None
        yield jnative
    assert (jnative._LIB, jnative._lib, jnative._tried) == before


def test_fixture_loads_where_the_jax_loader_lost_the_race(lost_race,
                                                          request):
    jnative = lost_race
    assert not jnative.available()   # the loader alone stays without it
    try:
        jn = request.getfixturevalue("jax_native")
    except pytest.skip.Exception as e:
        pytest.fail(f"the fixture skipped: {e}")
    assert jn is jnative and jnative._lib is not None
    blob = str(OBJ / "blob_960.obj")
    got = jnative.obj_scan(blob)
    assert got is not None and got[3].shape == (960, 3)
    want = native.obj_scan(blob)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
