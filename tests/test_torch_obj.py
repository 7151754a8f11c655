"""The port's OBJ importer against the JAX package's, and the mesh fixtures.

Every fixture of `tools/make_mesh_fixtures.py` and a few hand-written
OBJ/MTL files parse to the same `Scene` in both packages (the JAX side
takes its native C++ scan for plain files, the port its numpy scan), and
flatten to the same `SceneArrays` and `StaticScene` (UVs and texture ids
included).  Regenerating the fixtures gives the committed bytes."""
import pathlib
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import nrenderer_tpu as T  # noqa: E402
from nrenderer_tpu.ops.intersect import (  # noqa: E402
    make_static_scene as jax_make_static_scene,
)

import nrenderer_torch as P  # noqa: E402
from nrenderer_torch.io.obj import _scan_plain  # noqa: E402
from nrenderer_torch.ops.bvh import pack_blocked_triangles  # noqa: E402
from nrenderer_torch.ops.intersect import make_static_scene  # noqa: E402
from nrenderer_torch.ops.pt_core import make_mat_channels  # noqa: E402

from test_torch_scene import assert_static_equal, plain  # noqa: E402
from test_torch_jax_native import jax_loader  # noqa: E402,F401

# the JAX package's loader loads a build of this process's own
pytestmark = pytest.mark.usefixtures("jax_loader")

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = REPO / "resource"
OBJ = RES / "obj"
sys.path.insert(0, str(REPO / "tools"))

# (scene file or None, OBJ files): the fixtures as the CLI loads them
FIXTURES = {
    "blob": ("mesh_box.scn", ["blob_960.obj"]),
    "ico": ("mesh_box.scn", ["ico_5120.obj"]),
    "tex_grid": ("tex_grid.scn", ["tex_grid.obj"]),
    "tex_grid_plain": ("tex_grid.scn", ["tex_grid_plain.obj"]),
    "tex_quad": ("tex_grid.scn", ["tex_quad.obj"]),
    "obj_only": (None, ["blob_960.obj", "tex_quad.obj"]),
}


def _load(pkg, scn, objs, base=OBJ):
    scene = pkg.Scene()
    if scn:
        pkg.load_scn(str(RES / scn), scene)
    for o in objs:
        pkg.load_obj(str(base / o), scene,
                     material=0 if scene.materials else None)
    return scene


def _assert_arrays_equal(ja, pa):
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


@pytest.mark.parametrize("which", sorted(FIXTURES))
def test_fixtures_parse_and_flatten_alike(which):
    scn, objs = FIXTURES[which]
    js, ps = _load(T, scn, objs), _load(P, scn, objs)
    assert plain(js) == plain(ps)
    ja, pa = T.build_scene_arrays(js), P.build_scene_arrays(ps)
    _assert_arrays_equal(ja, pa)
    jss, pss = jax_make_static_scene(ja), make_static_scene(pa)
    assert_static_equal(jss, pss)
    n_mapped = sum(uv[6] == 0 for uv in pss.tri_uv)
    assert n_mapped == sum({"tex_grid.obj": 128, "tex_quad.obj": 2}.get(o, 0)
                           for o in objs)
    assert len(ps.textures) == (1 if n_mapped else 0)


def test_plain_files_take_the_scan_with_the_whole_pool():
    """A plain file keeps its whole `v` pool, as the JAX native route
    does; a file with materials goes through the line parser, which
    compacts the pool per mesh."""
    assert _scan_plain(str(OBJ / "blob_960.obj")) is not None
    assert _scan_plain(str(OBJ / "tex_grid.obj")) is None   # mtllib
    s = P.load_obj(str(OBJ / "blob_960.obj"))
    assert s.mesh_buffer[0].positions.shape == (482, 3)
    assert s.mesh_buffer[0].position_indices.shape == (960 * 3,)


HAND = {
    # negative (relative) indices, v//n corners, normals kept
    "relative.obj": "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nvn 0 0 1\n"
                    "f -4//1 -3//1 -2//1\nf 2//1 4//1 3//1\n",
    # v/t corners on one face, bare corners on another: UVs dropped
    "mixed.obj": "v 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 0 1\n"
                 "f 1/1 2/2 3/3\nf 1 2 3\n",
    # unused vertices, comments, tabs
    "loose.obj": "# c\nv 5 5 5\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                 "f\t2 3 4\n",
    # groups, materials with maps, a missing texture
    "groups.obj": "mtllib m.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n"
                  "vt 0 0\nvt 1 0\nvt 0 1\nvt 1 1\ng a\nusemtl shiny\n"
                  "f 1/1 2/2 3/3\ng b\nusemtl mapped\nf 2/2 4/4 3/3\n",
    # an MTL that does not exist
    "nomtl.obj": "mtllib missing.mtl\nv 0 0 0\nv 1 0 0\nv 0 1 0\n"
                 "usemtl nothing\nf 1 2 3\n",
}
MTL = ("newmtl shiny\nKd 0.2 0.3 0.4\nKs 1 1 1\nNs 12\n"
       "newmtl mapped\nKd 1 1 1\nmap_Kd ../obj_fixture/tex_grid.png\n"
       "map_Ks ../obj_fixture/tex_grid.png\nmap_bump no_such.png\n")


@pytest.fixture(scope="module")
def hand_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hand")
    (d / "m.mtl").write_text(MTL)
    for name, text in HAND.items():
        (d / name).write_text(text)
    fx = d.parent / "obj_fixture"
    fx.mkdir(exist_ok=True)
    (fx / "tex_grid.png").write_bytes((OBJ / "tex_grid.png").read_bytes())
    return d


@pytest.mark.parametrize("name", sorted(HAND))
def test_hand_written_files_agree(hand_dir, name):
    js = T.load_obj(str(hand_dir / name))
    ps = P.load_obj(str(hand_dir / name))
    assert plain(js) == plain(ps)
    _assert_arrays_equal(T.build_scene_arrays(js), P.build_scene_arrays(ps))
    if name == "groups.obj":
        assert len(ps.mesh_buffer) == 2 and len(ps.textures) == 2
        mapped = ps.materials[1]
        assert mapped.get_property("specularMap") is not None
        assert mapped.get_property("bumpMap") is None   # missing image
    if name == "nomtl.obj":
        assert ps.materials == [] and ps.mesh_buffer[0].material == -1


def test_non_triangulated_face_raises(tmp_path):
    for text in ("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n",
                 "mtllib x.mtl\nv 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                 "f 1 2 3 4\n"):
        p = tmp_path / "quad.obj"
        p.write_text(text)
        with pytest.raises(P.ObjParseError, match="Triangulated"):
            P.load_obj(str(p))
        with pytest.raises(T.ObjParseError, match="Triangulated"):
            T.load_obj(str(p))
    with pytest.raises(P.ObjParseError, match="does not exist"):
        P.load_obj(str(tmp_path / "absent.obj"))


def test_fixture_regeneration_gives_the_committed_bytes(tmp_path):
    import make_mesh_fixtures
    written = make_mesh_fixtures.write_all(tmp_path)
    assert len(written) == 10
    for p in written:
        committed = RES / p.relative_to(tmp_path)
        assert p.read_bytes() == committed.read_bytes(), p.name


def test_blob_fixture_shape():
    """960 faces, 8 blocks of 128 (inside the megamesh route), resting on
    the Cornell floor near the box centre, about 250 units across, closed
    (every edge shared by two faces)."""
    scene = _load(P, "mesh_box.scn", ["blob_960.obj"])
    arrays = P.build_scene_arrays(scene)
    ss = make_static_scene(arrays)
    assert len(ss.tri) == 960 and len(ss.pln) == 5 and not ss.sph
    bt = pack_blocked_triangles(arrays, make_mat_channels(ss))
    assert (bt.n_blocks, bt.block) == (8, 128)
    assert int((bt.pid >= 0).sum()) == 960
    mesh = scene.mesh_buffer[0]
    pos = mesh.positions[mesh.position_indices]
    assert abs(pos[:, 1].min() - (-278.0)) <= 1.0
    ext = pos.max(axis=0) - pos.min(axis=0)
    assert 200.0 <= ext[0] <= 300.0 and 200.0 <= ext[2] <= 300.0
    centre = (pos.max(axis=0) + pos.min(axis=0)) / 2
    assert abs(centre[0]) < 50 and abs(centre[2] - 1028.0) < 100
    tri = mesh.position_indices.reshape(-1, 3)
    edges = np.sort(np.concatenate([tri[:, [0, 1]], tri[:, [1, 2]],
                                    tri[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()
    ico = P.load_obj(str(OBJ / "ico_5120.obj")).mesh_buffer[0]
    assert ico.position_indices.shape == (5120 * 3,)
