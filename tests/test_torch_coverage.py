"""The port does all that the JAX package does.

Each module of `nrenderer_tpu/` is read with `ast` (nothing of JAX is
imported): every public top-level function and class has a counterpart
of the same name in the port's module of the same path, or an entry
below.  `COUNTERPARTS` says where a counterpart lives under another name
or in another module; `NOT_PORTED` holds what the port leaves out by
design (ROADMAP §A), each with its reason.  Every entry is checked too:
a counterpart must exist, and a name left out must exist in the JAX
package and not in the port.  The two CLIs must take the same
subcommands and flags, the port's `--device` aside."""
import ast
import importlib.util
import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX = REPO / "nrenderer_tpu"
PORT = REPO / "nrenderer_torch"
JAX_MODULES = sorted(p.relative_to(JAX).as_posix()
                     for p in JAX.rglob("*.py"))

# JAX modules whose names the port keeps in modules of another path
MOVED = {
    "ops/mesh_pallas.py": ("ops/mesh_cuda.py", "ops/mesh_mxu.py"),
    "ops/pt_pallas.py": ("ops/pt_cuda.py",),
    "ops/vecmath.py": ("ops/soa.py",),
}

# "module:name" -> ("port module:name", why that is its counterpart)
COUNTERPARTS = {
    "ops/camera.py:shoot": (
        "ops/camera.py:shoot_v3",
        "the same rays on SoA components; the port keeps no (..., 3) form"),
    "ops/env.py:sample_env_map": (
        "ops/env.py:sample_env_map_v3",
        "the same lookup on SoA directions"),
    "ops/pt_core.py:uniform_from_bits": (
        "ops/pt_core.py:hash_uniform",
        "its last step: the top 24 bits scaled by 2^-24"),
    "ops/stream_compact.py:stream_rows_needed": (
        "ops/stream_compact.py:stream_lanes_needed",
        "the overflow guard of the port's dense pack, which claims lanes "
        "and not 8-row tiles"),
    "ops/mesh_pallas.py:sweep_tile": (
        "ops/mesh_cuda.py:sweep_mesh_plain",
        "the B2 sweep's contract in its float order; the kernel is "
        "csrc/mesh_sweep.cuh warp_sweep"),
    "ops/mesh_pallas.py:sweep_tile_mxu": (
        "ops/mesh_mxu.py:sweep_mxu_plain",
        "B4's contract in its float order; the kernel is "
        "csrc/mesh_sweep_mxu.cu"),
    "ops/mesh_pallas.py:sweep_mesh_pallas": (
        "ops/mesh_cuda.py:sweep_mesh_full",
        "the (t, idx) view of sweep_mesh_full"),
    "ops/mesh_pallas.py:intersect_triangles_pallas": (
        "ops/mesh_cuda.py:intersect_triangles_mesh",
        "the kernel route of bvh.intersect_triangles_blocked's contract"),
    "ops/pt_pallas.py:render_simple_pt_pallas": (
        "ops/pt_cuda.py:render_simple_pt", "B1a-e's renderer entry"),
    "ops/pt_pallas.py:render_pt_pallas_linear": (
        "ops/pt_cuda.py:render_pt_linear", "B1a-e's linear film"),
    "ops/pt_pallas.py:render_bsdf_pt_pallas": (
        "ops/pt_cuda.py:render_bsdf_pt", "B1b-e's renderer entry"),
    "renderers/simple_pt.py:pick_chunk": (
        "renderers/routes.py:pick_chunk",
        "the route layer's pass size, which SimplePathTracer's progressive "
        "route and AccPathTracer's hybrid route both read"),
    "renderers/acc_pt.py:trace_bsdf_wavefront": (
        "renderers/_wavefront.py:trace_bsdf_wavefront",
        "the hybrid route's film loops live beside the wavefront, below the "
        "route layer"),
    "renderers/acc_pt.py:build_render_fn": (
        "renderers/_wavefront.py:build_render_fn",
        "the hybrid route's film, built by renderers/routes.py"),
    "ops/vecmath.py:cross": ("ops/soa.py:cross3", "SoA components"),
    "ops/vecmath.py:dot": ("ops/soa.py:dot3", "SoA components"),
    "ops/vecmath.py:norm": ("ops/soa.py:norm3", "SoA components"),
    "ops/vecmath.py:normalize": ("ops/soa.py:normalize3", "SoA components"),
    "ops/vecmath.py:reflect": ("ops/soa.py:reflect3", "SoA components"),
}

_XLA_BVH = ("the XLA BVH engine (a per-ray stack-free walk over a flat "
            "BVH); the port's mesh routes sweep the blocked pool "
            "(ops/bvh.py BlockedTris, B1e/B2/B4)")
_XLA_WAVEFRONT = ("the XLA wavefront engine; the port's SimplePathTracer "
                  "renders on B1a (ops/pt_cuda.py render_simple_pt)")
_JIT = "XLA/TPU machinery: a cache of jax.jit builds"
_SHARD_MAP = ("a jax.sharding Mesh and shard_map builders; the port runs "
              "one process per device (parallel/group.py launch, "
              "parallel/mesh.py render_sharded)")

# "module" or "module:name" -> why the port leaves it out (ROADMAP §A)
NOT_PORTED = {
    "utils/device_warm.py": "XLA/TPU machinery: TPU device warm-up",
    "ops/sampling.py": ("jax.random sampling; the port draws every number "
                        "from ops/pt_core.py hash_uniform"),
    "ops/compact.py": ("the XLA log-shift compactor; the port packs with "
                       "B3a/B3b (ops/stream_compact.py)"),
    "__init__.py:enable_compilation_cache": (
        "XLA/TPU machinery: the persistent XLA compilation cache"),
    "utils/timing.py:profile_trace": (
        "XLA/TPU machinery: a jax.profiler trace span"),
    "renderers/simple_pt.py:get_render_fn": _JIT,
    "renderers/acc_pt.py:get_render_fn": _JIT,
    "renderers/simple_pt.py:build_render_fn": _XLA_WAVEFRONT,
    "renderers/simple_pt.py:trace_diffuse_wavefront": _XLA_WAVEFRONT,
    "renderers/simple_pt.py:build_linear_chunk_fn": _XLA_WAVEFRONT,
    "ops/pt_core.py:_blocked_compacted": (
        "the XLA engine's compacted blocked sweep; the port compacts with "
        "B3a/B3b"),
    "ops/bvh.py:FlatBVH": _XLA_BVH,
    "ops/bvh.py:flatten_bvh": _XLA_BVH,
    "ops/bvh.py:intersect_triangles_bvh": _XLA_BVH,
    "ops/bvh.py:build_triangle_bvh": _XLA_BVH,
    "ops/bvh.py:TrianglePack": (
        "the flat per-triangle pool that only the XLA BVH engine and "
        "mesh_pallas.intersect_triangles_pallas's gathers read; the "
        "port's kernels read the blocked pool"),
    "ops/bvh.py:pack_triangles": "builds TrianglePack",
    "ops/bvh.py:primitive_aabbs": (
        "no caller in the JAX package; the port's BVH boxes are the "
        "triangles' (ops/bvh.py pack_blocked_triangles)"),
    "ops/vecmath.py:luminance": "no caller in the JAX package",
    "ops/mesh_pallas.py:_row_packed_sweep": (
        "the NR_MESH_PACK=row engine; the port packs with B3a/B3b"),
    "ops/pt_pallas.py:_env_patch_build": (
        "the env-patch windows, a TPU gather workaround; the port's "
        "kernels read the whole map"),
    "ops/pt_pallas.py:_build_env_primary": (
        "the env-patch windows' primary pass"),
    "parallel/mesh.py:make_mesh": _SHARD_MAP,
    "parallel/mesh.py:build_sharded_render": _SHARD_MAP,
    "parallel/mesh.py:build_sharded_render_pixels": _SHARD_MAP,
    "parallel/mesh.py:build_sharded_render_acc": _SHARD_MAP,
    "parallel/mesh.py:build_sharded_render_acc_pixels": _SHARD_MAP,
}


def _top_level(path: pathlib.Path):
    """(functions and classes, every name the module binds) at its top
    level."""
    defs, bound = set(), set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            defs.add(node.name)
            bound.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            bound.update(t.id for t in targets if isinstance(t, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            bound.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return defs, bound


def _port_bound(module: str) -> set:
    bound = set()
    for m in MOVED.get(module, (module,)):
        if (PORT / m).exists():
            bound |= _top_level(PORT / m)[1]
    return bound


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_has_its_counterparts(module):
    if module in NOT_PORTED:
        assert not any((PORT / m).exists()
                       for m in MOVED.get(module, (module,))), \
            f"{module} is ported: take it out of NOT_PORTED"
        return
    defs, jax_bound = _top_level(JAX / module)
    port = _port_bound(module)
    missing = [n for n in sorted(defs) if not n.startswith("_")
               and n not in port and f"{module}:{n}" not in COUNTERPARTS
               and f"{module}:{n}" not in NOT_PORTED]
    assert not missing, f"{module}: no counterpart in the port: {missing}"
    for key in [k for k in [*COUNTERPARTS, *NOT_PORTED]
                if k.startswith(module + ":")]:
        name = key.split(":")[1]
        assert name in jax_bound, f"{key}: no such name in the JAX package"
        if key in COUNTERPARTS:
            m, n = COUNTERPARTS[key][0].split(":")
            assert n in _top_level(PORT / m)[1], \
                f"{key}'s counterpart {m}:{n} is gone"
        else:
            assert name not in port, \
                f"{key} is ported: take it out of NOT_PORTED"


def test_every_entry_names_a_jax_module_and_a_reason():
    for key in [*COUNTERPARTS, *NOT_PORTED]:
        assert key.split(":")[0] in JAX_MODULES, key
    assert all(why for _, why in COUNTERPARTS.values())
    assert all(NOT_PORTED.values())


def test_package_exports_the_same_names():
    """`import nrenderer_tpu as T` and `import nrenderer_torch as P`
    offer the same names (the scene contract and its loaders)."""
    def exported(pkg):
        return {a.asname or a.name
                for node in ast.parse((pkg / "__init__.py").read_text()).body
                if isinstance(node, ast.ImportFrom) for a in node.names}
    assert exported(JAX) == exported(PORT)


def test_port_imports_nothing_of_jax():
    """No module of the port imports JAX or the JAX package, at its top
    or inside a function."""
    offenders = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(REPO)}:{node.lineno} {m}"
                          for m in mods if m.split(".")[0]
                          in ("jax", "jaxlib", "nrenderer_tpu")]
    assert not offenders, offenders


SUBCOMMANDS = ["render", "edit", "list-renderers"]
PORT_ONLY_FLAGS = {"--device"}


@pytest.fixture(scope="module")
def usages(tmp_path_factory):
    """Each CLI's usage text, top level and per subcommand, from `-h` in
    subprocesses on the CPU, all started at once."""
    if importlib.util.find_spec("jax") is None:
        pytest.skip("the JAX package's CLI needs jax")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               NR_JAX_CACHE=str(tmp_path_factory.mktemp("jax_cache")))
    procs = {(pkg, cmd): subprocess.Popen(
                 [sys.executable, "-m", pkg, *([cmd] if cmd else []), "-h"],
                 cwd=REPO, env=env, stdout=subprocess.PIPE,
                 stderr=subprocess.PIPE, text=True)
             for pkg in ("nrenderer_tpu", "nrenderer_torch")
             for cmd in [""] + SUBCOMMANDS}
    out = {}
    try:
        for key, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=240)
            assert proc.returncode == 0, f"{key}: {stderr}"
            out[key] = " ".join(stdout.split("\n\n")[0].split())
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()
    return out


def _options(usage: str) -> dict:
    """{flag: its arguments as the usage line shows them}."""
    items = re.findall(r"\[(-[^\[\]]*(?:\[[^\]]*\][^\[\]]*)?)\]", usage)
    opts = dict((item.split(" ", 1) + [""])[:2] for item in items)
    flags = set(re.findall(r"(?<![\w-])--?[A-Za-z][\w-]*", usage))
    assert flags == set(opts), f"options outside brackets: {usage}"
    return opts


@pytest.mark.parametrize("cmd", [""] + SUBCOMMANDS)
def test_clis_take_the_same_flags(cmd, usages):
    jax, port = usages["nrenderer_tpu", cmd], usages["nrenderer_torch", cmd]
    if not cmd:
        subs = [re.search(r"\{([^}]*)\}", u).group(1).split(",")
                for u in (jax, port)]
        assert subs[0] == subs[1] == SUBCOMMANDS
        return
    jopts, popts = _options(jax), _options(port)
    assert set(popts) - set(jopts) <= PORT_ONLY_FLAGS
    assert {f: a for f, a in popts.items() if f not in PORT_ONLY_FLAGS} \
        == jopts
