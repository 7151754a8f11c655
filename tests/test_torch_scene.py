"""The port's host scene layer against the JAX package's, on the in-repo
Cornell box: the parsed `Scene`, the `SceneArrays` and the `StaticScene`
must be identical (exact equality; both are float64/float32 host numpy), and
`interop.static_scene_from_numpy` must hand JAX's `StaticScene` over
unchanged."""
import dataclasses
import enum
import pathlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import nrenderer_tpu as T  # noqa: E402
from nrenderer_tpu.ops.intersect import (  # noqa: E402
    make_static_scene as jax_make_static_scene,
)

import nrenderer_torch as P  # noqa: E402
from nrenderer_torch.interop import static_scene_from_numpy  # noqa: E402
from nrenderer_torch.ops.intersect import make_static_scene  # noqa: E402

torch.set_num_threads(1)

SCENE = pathlib.Path(__file__).resolve().parent.parent / "resource" \
    / "cornell_box.scn"


def plain(x):
    """Package-independent form of a scene object: dataclasses by field,
    enums by name and value, arrays as nested lists."""
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return (type(x).__name__, x.name, x.value)
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.tolist())
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


def assert_static_equal(a, b):
    assert len(a.sph) == len(b.sph) and a.sph == b.sph
    for name in ("tri", "pln", "al"):
        ra, rb = getattr(a, name), getattr(b, name)
        assert len(ra) == len(rb), name
        for pa, pb in zip(ra, rb):
            assert len(pa) == len(pb)
            for fa, fb in zip(pa, pb):
                np.testing.assert_array_equal(np.asarray(fa), np.asarray(fb))
                assert np.asarray(fa).dtype == np.asarray(fb).dtype
    assert len(a.mats) == len(b.mats)
    for ma, mb in zip(a.mats, b.mats):
        assert ma.keys() == mb.keys()
        for k in ma:
            np.testing.assert_array_equal(np.asarray(ma[k]),
                                          np.asarray(mb[k]), err_msg=k)
    assert a.ambient_type == b.ambient_type
    assert a.ambient_constant == b.ambient_constant
    assert a.n_mats == b.n_mats
    assert tuple(a.tri_uv) == tuple(b.tri_uv)


@pytest.fixture(scope="module")
def both():
    js = T.load_scn(str(SCENE))
    ps = P.load_scn(str(SCENE))
    ja = T.build_scene_arrays(js)
    pa = P.build_scene_arrays(ps)
    return js, ps, ja, pa


def test_scene_fields_equal(both):
    js, ps, _, _ = both
    assert plain(js) == plain(ps)


def test_cornell_fixture_records(both):
    """The values `tests/test_scn.py` records for the reference Cornell."""
    _, s, _, _ = both
    assert [m.name for m in s.materials] == ["White", "Red", "Green"]
    red = s.materials[1].get_property("diffuseColor", P.PropertyType.RGB)
    assert red == pytest.approx((0.63, 0.065, 0.0))  # "0.065," quirk
    white = s.materials[0].get_property("diffuseColor", P.PropertyType.RGB)
    assert white == pytest.approx((0.725, 0.71, 0.68))
    assert (len(s.plane_buffer), len(s.sphere_buffer),
            len(s.triangle_buffer), len(s.models)) == (11, 1, 4, 4)
    assert s.models[0].translation == pytest.approx((0.0, 0.0, 1028.0))
    assert s.models[1].translation == pytest.approx((-100.0, -228.0, 800.0))
    al = s.area_light_buffer[0]
    assert al.radiance == pytest.approx((47.8384, 38.5664, 31.0808))
    assert al.position == pytest.approx((60.0, 275.0, 1088.0))
    assert al.u == pytest.approx((-120.0, 0.0, 0.0))
    assert al.v == pytest.approx((0.0, 0.0, -120.0))
    assert s.lights[0].type == P.LightType.AREA
    assert s.camera == P.Camera()


def test_scene_arrays_equal(both):
    _, _, ja, pa = both
    assert type(ja)._fields == type(pa)._fields
    for name in type(pa)._fields:
        a, b = getattr(ja, name), getattr(pa, name)
        if name == "textures":
            assert len(a) == len(b)
            for ta, tb in zip(a, b):
                np.testing.assert_array_equal(ta, tb)
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_static_scene_equal(both):
    _, _, ja, pa = both
    assert_static_equal(jax_make_static_scene(ja), make_static_scene(pa))


def test_interop_static_scene_equals_own(both):
    _, _, ja, pa = both
    handed = static_scene_from_numpy(jax_make_static_scene(ja))
    assert_static_equal(handed, make_static_scene(pa))
    assert type(handed).__module__ == "nrenderer_torch.ops.intersect"


SNIPPETS = [
    # C++ stream numerics: longest-prefix parse, later components 0
    "Begin Material\nMaterial X\nProp diffuseColor RGB 0.63 0.065, 0.05\n"
    "Prop other RGB 1 2 3\nEnd\n",
    # comments, blank lines, material type
    "\n# c\nBegin Material\n# inner\nMaterial A 2\n\nProp ior Float 1.33\n"
    "End\n",
    # lights of every kind
    "Begin Light\nPoint p\nIRV 1 2 3\nP 0 1 0\nSpot s\nD 0 -1 0\n"
    "HotSpot 0.5\nFallout 0.7\nArea a\nU 1 0 0\nV 0 0 1\nEnd\n",
    # syntax error
    "Begin Model\nModel M\nGibberish x y z\nEnd\n",
    # duplicate material
    "Begin Material\nMaterial A\nMaterial A\nEnd\n",
    # unknown material reference
    "Begin Material\nMaterial A\nEnd\nBegin Model\nModel M\n"
    "Sphere S NoSuchMaterial\nEnd\n",
    # field before its entity
    "Begin Model\nR 200\nEnd\n",
]


@pytest.mark.parametrize("text", SNIPPETS)
def test_parse_snippets_agree(text):
    """Same scene or same error message from both parsers."""
    try:
        want = ("ok", plain(T.parse_scn(text)))
    except T.ScnParseError as exc:
        want = ("error", str(exc))
    try:
        got = ("ok", plain(P.parse_scn(text)))
    except P.ScnParseError as exc:
        got = ("error", str(exc))
    assert got == want
