#!/usr/bin/env python3
"""Write the mesh and texture fixtures of the renderer's tests and smoke runs.

    python3 tools/make_mesh_fixtures.py [--out-dir DIR] [--large]

Deterministic (numpy arithmetic and fixed-point text, a PNG with stored
deflate blocks) and needs nothing outside the repository.  Writes, under
`resource/` (or DIR):

  obj/blob_960.obj    a closed 16x32 UV sphere (960 faces) with a smooth
                      radial displacement, ~250 units across, in world
                      coordinates, resting on the Cornell floor (y = -278)
                      near the box centre: 8 blocks of 128, AccPathTracer's
                      megamesh route
  mesh_box.scn        the Cornell shell, materials and light of
                      cornell_box.scn without its short box, ball and
                      tetrahedron (render with --obj obj/blob_960.obj)
  obj/ico_5120.obj    a subdivision-4 icosphere (5120 faces) of radius 120
                      on the same floor, a stand-in for the 5k-face bunny
  obj/tex_grid.obj    an 8x8-subdivided 2x2 quad (128 faces) with UVs and
   + .mtl + .png      a map_Kd texture, red left and green right (the
                      textured-grid row of bench_suite.py), 4 units in
                      front of the default camera at (0, 0, 10) looking
                      down +z
  obj/tex_grid_plain.obj + .mtl   its twin without the map
  obj/tex_quad.obj    the same quad with one subdivision (2 faces: dense
                      textured triangles)
  tex_grid.scn        the bench row's area light in the same frame

With `--large` it writes instead, under `build/mesh_fixtures/` (or DIR),
the subdivision-5 and -6 icospheres of the same radius and place,
`ico_20480.obj` and `ico_81920.obj` (160 and 640 blocks of 128; not
committed: `large_icosphere` writes them at run time where they are
needed).

Both packages parse every file the same way (`tests/test_torch_obj.py`)."""
from __future__ import annotations

import argparse
import os
import pathlib
import struct
import zlib

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
FLOOR_Y = -278.0

# The Cornell shell, materials and light of resource/cornell_box.scn.
MESH_BOX_SCN = """\
# Cornell shell and light for the mesh path: the walls, materials and area
# light of cornell_box.scn with no short box, ball or tetrahedron.  The mesh
# comes from the command line and takes the first material (White):
#   python -m nrenderer_torch render --scene resource/mesh_box.scn \\
#       --obj resource/obj/blob_960.obj --renderer AccPathTracer ...
# Written by tools/make_mesh_fixtures.py.  Camera at the Camera defaults:
# (0, 0, 10) looking down +z, fov 40: red wall left, green right.

Begin Material
Material White
Prop diffuseColor RGB 0.725 0.71 0.68
Material Red
Prop diffuseColor RGB 0.63 0.065, 0.05
Material Green
Prop diffuseColor RGB 0.14 0.45 0.091
End

Begin Model
Model Walls
Translation 0 0 1028
Plane LeftWall Red
N -1 0 0
P 278 278 278
U 0 -556 0
V 0 0 -556
Plane RightWall Green
N 1 0 0
P -278 278 278
U 0 -556 0
V 0 0 -556
Plane Ceiling White
N 0 -1 0
P 278 278 278
U -556 0 0
V 0 0 -556
Plane Floor White
N 0 1 0
P 278 -278 278
U -556 0 0
V 0 0 -556
Plane BackWall White
N 0 0 -1
P 278 278 278
U -556 0 0
V 0 -556 0
End

Begin Light
Area CeilingLight
IRV 47.8384 38.5664 31.0808
P 60 275 1088
U -120 0 0
V 0 0 -120
End
"""

# The area light of bench_suite.py's textured-grid row, (-2, 2.5, 2) with
# u (4, 0, 0), v (0, 0, 2) in front of a camera at (0, 0, 4) looking down
# -z, turned half a turn about y into the default camera's frame
# (x -> -x, z -> 14 - z).
TEX_GRID_SCN = """\
# Area light for the textured grid (resource/obj/tex_grid.obj): the light of
# bench_suite.py's textured-grid row in the default camera's frame (camera
# at (0, 0, 10) looking down +z; the grid 4 units ahead).  The grid brings
# its own material and texture:
#   python -m nrenderer_torch render --scene resource/tex_grid.scn \\
#       --obj resource/obj/tex_grid.obj --renderer AccPathTracer ...
# Written by tools/make_mesh_fixtures.py.

Begin Light
Area GridLight
IRV 6 6 6
P 2 2.5 12
U -4 0 0
V 0 0 -2
End
"""


def _fmt(x: float) -> str:
    s = f"{x:.6f}".rstrip("0").rstrip(".")
    return "0" if s in ("-0", "") else s


def write_obj(path: pathlib.Path, verts, faces, uvs=None, header=(),
              mtllib=None, usemtl=None) -> None:
    """OBJ text: 1-based faces, `v/t` corners when `uvs` is given."""
    lines = [f"# {h}" for h in header]
    if mtllib:
        lines.append(f"mtllib {mtllib}")
    lines += ["v " + " ".join(_fmt(c) for c in v) for v in verts]
    if uvs is not None:
        lines += ["vt " + " ".join(_fmt(c) for c in t) for t in uvs]
    if usemtl:
        lines.append(f"usemtl {usemtl}")
    for f in faces:
        a, b, c = (int(i) + 1 for i in f)
        if uvs is None:
            lines.append(f"f {a} {b} {c}")
        else:
            lines.append(f"f {a}/{a} {b}/{b} {c}/{c}")
    path.write_text("\n".join(lines) + "\n")


def _check_outward(verts: np.ndarray, faces: np.ndarray,
                   centre: np.ndarray) -> None:
    v1, v2, v3 = (verts[faces[:, k]] for k in range(3))
    n = np.cross(v2 - v1, v3 - v1)
    out = ((v1 + v2 + v3) / 3.0 - centre)
    assert (np.einsum("ij,ij->i", n, out) > 0).all(), "inward face"


def uv_blob(rings: int = 16, segs: int = 32, radius: float = 120.0):
    """A closed UV sphere (2 * segs * (rings - 1) faces) with a smooth
    radial displacement, outward winding; returns (verts, faces, centre)
    placed on the Cornell floor."""
    theta = np.arange(1, rings) * np.pi / rings          # polar, no poles
    phi = np.arange(segs) * 2.0 * np.pi / segs
    th, ph = np.meshgrid(theta, phi, indexing="ij")

    def bump(t, p):
        return radius * (1.0 + 0.12 * np.sin(3.0 * p) * np.sin(t) ** 2
                         + 0.08 * np.cos(2.0 * t))

    r = bump(th, ph)
    ring = np.stack([r * np.sin(th) * np.cos(ph), r * np.cos(th),
                     r * np.sin(th) * np.sin(ph)], axis=-1).reshape(-1, 3)
    top = np.array([[0.0, bump(0.0, 0.0), 0.0]])
    bottom = np.array([[0.0, -bump(np.pi, 0.0), 0.0]])
    verts = np.concatenate([top, ring, bottom])
    ib = len(verts) - 1
    at = lambda i, j: 1 + i * segs + (j % segs)
    faces = []
    for j in range(segs):
        faces.append((0, at(0, j + 1), at(0, j)))
    for i in range(rings - 2):
        for j in range(segs):
            faces.append((at(i, j), at(i, j + 1), at(i + 1, j + 1)))
            faces.append((at(i, j), at(i + 1, j + 1), at(i + 1, j)))
    for j in range(segs):
        faces.append((ib, at(rings - 2, j), at(rings - 2, j + 1)))
    faces = np.asarray(faces, np.int64)
    centre = np.array([0.0, FLOOR_Y + 0.5 - verts[:, 1].min(), 1000.0])
    verts = verts + centre
    _check_outward(verts, faces, centre)
    return verts, faces, centre


def icosphere(level: int = 4, radius: float = 120.0):
    """A subdivided icosahedron (20 * 4**level faces) on the Cornell
    floor, outward winding; returns (verts, faces, centre)."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
             (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
             (-t, 0, -1), (-t, 0, 1)]
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    for _ in range(level):
        mid = {}

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                mid[key] = len(verts) - 1
            return mid[key]

        nxt = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nxt += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = nxt
    centre = np.array([0.0, FLOOR_Y + 0.5 + radius, 1000.0])
    verts = np.asarray(verts) * radius + centre
    faces = np.asarray(faces, np.int64)
    _check_outward(verts, faces, centre)
    return verts, faces, centre


def icosphere_name(level: int) -> str:
    return f"ico_{20 * 4 ** level}.obj"


def write_icosphere(obj_dir: pathlib.Path, level: int) -> pathlib.Path:
    """Write `icosphere(level)` as `obj_dir/ico_<faces>.obj`; returns the
    path.  The file appears whole: it is written under a pid-tagged name
    and then renamed, so processes that write it at once never read a
    partial one."""
    verts, faces, _ = icosphere(level)
    p = obj_dir / icosphere_name(level)
    tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
    write_obj(tmp, verts, faces, header=(
        f"{p.stem}: a subdivision-{level} icosphere, {len(faces)} faces, "
        "radius",
        "120, resting on the Cornell floor (y = -278).",
        "Written by tools/make_mesh_fixtures.py."))
    os.replace(tmp, p)
    return p


# The large icospheres of the mesh routes' crossover and the large-mesh
# smoke phase: 160 and 640 blocks of 128, too large to commit (the
# 81,920-face file is 3 MB of text), so written at run time into build/
LARGE_LEVELS = (5, 6)
LARGE_DIR = ROOT / "build" / "mesh_fixtures"


def large_icosphere(level: int, obj_dir: pathlib.Path = LARGE_DIR
                    ) -> pathlib.Path:
    """The path of `icosphere(level)`'s OBJ under `obj_dir`, written there
    first if it is not there yet."""
    p = obj_dir / icosphere_name(level)
    if not p.exists():
        obj_dir.mkdir(parents=True, exist_ok=True)
        write_icosphere(obj_dir, level)
    return p


def grid_quad(nsub: int):
    """The bench row's 2x2 quad split into nsub x nsub cells (2 faces
    each), turned half a turn about y to sit 4 units in front of the
    default camera (z = 14) and face it: vertex (i, j) at
    (1 - 2i/n, 2j/n - 1, 14) with uv (i/n, j/n), so u < 0.5 is the image's
    left half."""
    verts, uvs, faces = [], [], []
    for j in range(nsub + 1):
        for i in range(nsub + 1):
            verts.append((1.0 - 2.0 * i / nsub, 2.0 * j / nsub - 1.0, 14.0))
            uvs.append((i / nsub, j / nsub))
    for j in range(nsub):
        for i in range(nsub):
            a = j * (nsub + 1) + i
            b, c, d = a + 1, a + nsub + 2, a + nsub + 1
            faces.append((a, b, c))
            faces.append((a, c, d))
    verts = np.asarray(verts)
    faces = np.asarray(faces, np.int64)
    v1, v2, v3 = (verts[faces[:, k]] for k in range(3))
    assert (np.cross(v2 - v1, v3 - v1)[:, 2] < 0).all()  # faces the camera
    return verts, np.asarray(uvs), faces


def png_bytes(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG with stored (uncompressed) deflate blocks, the same
    bytes on every zlib."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[r].tobytes() for r in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 0))
            + chunk(b"IEND", b""))


def grid_texture() -> np.ndarray:
    """32x128 map: left half (1, 0.2, 0.2), right half (0.2, 1, 0.2)."""
    tex = np.zeros((32, 128, 3), np.uint8)
    tex[:, :64] = (255, 51, 51)
    tex[:, 64:] = (51, 255, 51)
    return tex


def write_all(out_dir: pathlib.Path) -> list:
    """Write every fixture under `out_dir`; returns the paths written."""
    obj = out_dir / "obj"
    obj.mkdir(parents=True, exist_ok=True)
    written = []

    verts, faces, centre = uv_blob()
    p = obj / "blob_960.obj"
    write_obj(p, verts, faces, header=(
        "blob_960: a 16x32 UV sphere with a smooth radial displacement,",
        f"{len(faces)} faces, resting on the Cornell floor (y = -278).",
        "Written by tools/make_mesh_fixtures.py."))
    written.append(p)
    p = out_dir / "mesh_box.scn"
    p.write_text(MESH_BOX_SCN)
    written.append(p)

    written.append(write_icosphere(obj, 4))

    p = obj / "tex_grid.png"
    p.write_bytes(png_bytes(grid_texture()))
    written.append(p)
    p = obj / "tex_grid.mtl"
    p.write_text("# Written by tools/make_mesh_fixtures.py.\n"
                 "newmtl grid\nKd 1 1 1\nmap_Kd tex_grid.png\n")
    written.append(p)
    p = obj / "tex_grid_plain.mtl"
    p.write_text("# Written by tools/make_mesh_fixtures.py.\n"
                 "newmtl grid\nKd 1 1 1\n")
    written.append(p)
    for name, nsub, mtl in (("tex_grid", 8, "tex_grid.mtl"),
                            ("tex_grid_plain", 8, "tex_grid_plain.mtl"),
                            ("tex_quad", 1, "tex_grid.mtl")):
        verts, uvs, faces = grid_quad(nsub)
        p = obj / f"{name}.obj"
        write_obj(p, verts, faces, uvs=uvs, mtllib=mtl, usemtl="grid",
                  header=(f"{name}: a 2x2 quad in {nsub}x{nsub} cells, "
                          f"{len(faces)} faces, 4 units in front of the",
                          "default camera.  Written by "
                          "tools/make_mesh_fixtures.py."))
        written.append(p)
    p = out_dir / "tex_grid.scn"
    p.write_text(TEX_GRID_SCN)
    written.append(p)
    return written


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out-dir", default=None,
                    help="where to write (default: resource/, with "
                         "--large build/mesh_fixtures/)")
    ap.add_argument("--large", action="store_true",
                    help="write only the large icospheres (20,480 and "
                         "81,920 faces), which are not committed")
    args = ap.parse_args(argv)
    if args.large:
        out = pathlib.Path(args.out_dir) if args.out_dir else LARGE_DIR
        out.mkdir(parents=True, exist_ok=True)
        written = [write_icosphere(out, level) for level in LARGE_LEVELS]
    else:
        written = write_all(pathlib.Path(args.out_dir or ROOT / "resource"))
    for p in written:
        print(p)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
