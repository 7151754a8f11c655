"""The MXU sweep (B4) on exact ties, its kernel's table and its schedule.

The pool is `chip_smoke.tie_pool()` (`tests/test_torch_sweep_ties.py`
describes it): every t is exact in float32 in both sweep forms, so B4's
plain version must give the JAX package's MXU route (Pallas in interpret
mode, blocks of 16) and the port's B2 the same t and winner on every ray.
Then the kernel's form of the coefficient table (`MeshTables.coef_t`),
B4's schedule counts by hand, the wrapper's constant against the
kernel's, and (on a GPU) `mesh_sweep_mxu_kernel` against its plain
version at ragged counts and on the tie pool."""
import pathlib
import sys

import numpy as np
import pytest
import torch

import nrenderer_torch as P
from nrenderer_torch.ops import mesh_cuda, mesh_mxu
from nrenderer_torch.ops.bvh import build_mesh_accel
from nrenderer_torch.ops.soa import V3
from nrenderer_torch.scene import model

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = REPO / "resource"
sys.path.insert(0, str(REPO))

from chip_smoke import tie_pool  # noqa: E402
from test_torch_jax_native import jax_loader  # noqa: E402,F401

# the JAX package's loader loads a build of this process's own
pytestmark = pytest.mark.usefixtures("jax_loader")

T_MIN = 1e-3
CHANNELS = [(0.25, 9.0), (1.0, 2.0)]


def _v3(a, mk=torch.as_tensor):
    return V3(*(mk(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _jv3(a, jv3, jnp):
    return jv3(*(jnp.asarray(np.ascontiguousarray(a[:, i]))
                 for i in range(3)))


def _tie_scene(verts, faces, pkg_model=model):
    s = pkg_model.Scene()
    s.materials += [pkg_model.Material(name="A"),
                    pkg_model.Material(name="B")]
    s.mesh_buffer.append(pkg_model.Mesh(
        positions=verts, position_indices=faces.reshape(-1), material=1))
    s.nodes.append(pkg_model.Node(name="tie", type=pkg_model.NodeType.MESH,
                                  entity=0))
    return s


def _tie_tables(block, device="cpu"):
    verts, faces, o, d = tie_pool()
    bt = build_mesh_accel(P.build_scene_arrays(_tie_scene(verts, faces)),
                          CHANNELS, block=block).bt
    return mesh_cuda.make_mesh_tables(bt, device), o, d


@pytest.fixture(scope="module")
def tie_jax_mxu():
    """The JAX package's MXU route on the tie pool (Pallas in interpret
    mode, blocks of 16)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu
    import nrenderer_tpu as T
    from nrenderer_tpu.ops.bvh import build_mesh_accel as jbuild
    from nrenderer_tpu.ops.mesh_pallas import sweep_mesh_full
    from nrenderer_tpu.ops.soa import V3 as JV3
    from nrenderer_tpu.scene import model as jmodel
    verts, faces, o, d = tie_pool()
    bt = jbuild(T.build_scene_arrays(_tie_scene(verts, faces, jmodel)),
                CHANNELS, block=16).bt
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NR_MESH_MXU", "1")
        with pltpu.force_tpu_interpret_mode():
            res = sweep_mesh_full(bt, _jv3(o, JV3, jnp),
                                  _jv3(d, JV3, jnp), T_MIN, interpret=True)
    return tuple(np.asarray(a) for a in res)


def _tie_port(monkeypatch, mxu):
    mt, o, d = _tie_tables(16)
    monkeypatch.setenv("NR_MESH_MXU", "1" if mxu else "0")
    mesh_cuda.reset_route_counts()
    out = mesh_cuda.sweep_mesh_full(mt, _v3(o), _v3(d), T_MIN)
    assert mesh_cuda.ENGINE_COUNTS["mxu" if mxu else "blocked"] == 1
    return tuple(a.numpy() for a in out)


def test_ties_plain_mxu_matches_jax_mxu_route(tie_jax_mxu, monkeypatch):
    """B4's plain version gives the JAX MXU route's t, winner and shading
    on every ray of the tie pool, bit for bit (ties to the first triangle
    in natural order)."""
    got = _tie_port(monkeypatch, True)
    assert int((got[1] >= 0).sum()) > 1000
    for k in range(6):
        np.testing.assert_array_equal(got[k], tie_jax_mxu[k])


def test_ties_plain_mxu_matches_blocked_sweep(monkeypatch):
    """B4's plain version against B2's (natural order) on the tie pool:
    the same t, winner and shading on every ray."""
    b4 = _tie_port(monkeypatch, True)
    b2 = _tie_port(monkeypatch, False)
    for k in range(6):
        np.testing.assert_array_equal(b4[k], b2[k])


@pytest.mark.parametrize("block", [16, 20, 128])
def test_kernel_table_is_the_coefficient_rows(block):
    """`coef_t[b, k, t]` is float4 k of triangle t of block b in the
    contract's (n_blocks * block, 40) rows, a block's triangles side by
    side; a block that is not a multiple of 32 too."""
    mt, _, _ = _tie_tables(block)
    coef = mt.coef.numpy()
    ct = mt.coef_t.numpy()
    assert ct.shape == (mt.n_blocks, 10, mt.block, 4)
    assert mt.coef_t.is_contiguous()
    for b in (0, mt.n_blocks - 1):
        for t in (0, mt.block - 1):
            for k in range(10):
                np.testing.assert_array_equal(
                    ct[b, k, t], coef[b * mt.block + t, 4 * k:4 * k + 4])


def test_mxu_schedule_counts_by_hand():
    """`test_torch_sweep_ties.test_schedule_counts_by_hand`'s scene under
    B4's schedule: four unit squares a block each (two triangles), 40
    rays straight down, lanes 0-29 over square 0, lanes 30-31 over square
    1 (warp 0), lanes 32-39 over square 3 (warp 1).  By hand, with
    RAY_BATCH = 4: every step cooperative, 30 + 2 + 8 = 40 pairs of one
    32-lane pass each (1280 slots), in ceil(30 / 4) + ceil(2 / 4) +
    ceil(8 / 4) = 11 batches; no dense step; union 3 blocks x 2 x 32 =
    192; entered 80."""
    verts, faces = [], []
    for k in range(4):
        x = 10.0 * k
        base = len(verts)
        verts += [(x, 0, 0), (x + 1, 0, 0), (x + 1, 1, 0), (x, 1, 0)]
        faces += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    bt = build_mesh_accel(P.build_scene_arrays(_tie_scene(
        np.asarray(verts, np.float32), np.asarray(faces, np.int32))),
        CHANNELS, block=2).bt
    mt = mesh_cuda.make_mesh_tables(bt, "cpu")
    xs = [0.5] * 30 + [10.5] * 2 + [30.5] * 8
    n = len(xs)
    o = V3(torch.tensor(xs), torch.full((n,), 0.5), torch.full((n,), 5.0))
    d = V3(torch.zeros(n), torch.zeros(n), torch.full((n,), -1.0))
    stats = {"enter": []}
    got = mesh_mxu.sweep_mxu_plain(mt, o, d, T_MIN,
                                   torch.full((n,), float("inf")),
                                   stats=stats)
    np.testing.assert_array_equal(got[0].numpy(), np.full(n, 5.0, np.float32))
    assert mesh_mxu.RAY_BATCH == 4
    counts = mesh_cuda.schedule_counts(stats["enter"][0],
                                       torch.arange(n) // 32, 2,
                                       ray_batch=mesh_mxu.RAY_BATCH)
    assert counts == {"union_slots": 192, "coop_slots": 1280,
                      "coop_pairs": 40, "coop_dense_steps": 0,
                      "entered_slots": 80, "coop_batches": 11}


def test_ray_batch_matches_the_kernel():
    """The wrapper's RAY_BATCH is the kernel's kRayBatch."""
    src = (REPO / "nrenderer_torch" / "csrc" / "mesh_sweep_mxu.cu"
           ).read_text()
    line = next(ln for ln in src.splitlines()
                if ln.startswith("constexpr int kRayBatch"))
    assert int(line.split("=")[1].strip(" ;")) == mesh_mxu.RAY_BATCH


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _kernel_vs_plain(mt, t_min, o, d, cap, dev):
    og = _v3(o, lambda a: torch.as_tensor(a, device=dev))
    dg = _v3(d, lambda a: torch.as_tensor(a, device=dev))
    capg = torch.as_tensor(cap, device=dev)
    before = mesh_mxu.KERNEL_LAUNCHES[mesh_mxu.KERNEL_NAME]
    got = mesh_mxu.sweep_mxu(mt, og, dg, t_min, capg)
    assert mesh_mxu.KERNEL_LAUNCHES[mesh_mxu.KERNEL_NAME] == before + 1
    want = mesh_mxu.sweep_mxu_plain(mt, og, dg, t_min, capg)
    # the kernel's miss is t = +inf, the plain version's the ray's cap
    want = (torch.where(want[1] >= 0, want[0], float("inf")),) + want[1:]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 33, 32 * 40 + 5])
def test_cuda_kernel_at_ragged_counts(gpu, n):
    """`mesh_sweep_mxu_kernel` against its plain version on rays from the
    box's interior towards `ico_5120.obj`, a tenth dead (zero cap) and a
    fifth capped short: every output bit for bit."""
    from nrenderer_torch.ops.intersect import make_static_scene
    from nrenderer_torch.ops.pt_core import make_mat_channels, scene_epsilon
    scene = P.Scene()
    P.load_scn(str(RES / "mesh_box.scn"), scene)
    P.load_obj(str(RES / "obj" / "ico_5120.obj"), scene, material=0)
    arrays = P.build_scene_arrays(scene)
    ss = make_static_scene(arrays)
    mt = mesh_cuda.make_mesh_tables(
        build_mesh_accel(arrays, make_mat_channels(ss)).bt, gpu)
    rng = np.random.default_rng(0)
    o = np.stack([rng.uniform(-270, 270, n), rng.uniform(-270, 270, n),
                  rng.uniform(760, 1300, n)], axis=1)
    tgt = np.stack([rng.uniform(-150, 150, n), rng.uniform(-278, -7, n),
                    rng.uniform(850, 1150, n)], axis=1)
    dist = np.linalg.norm(tgt - o, axis=1)
    u = rng.random(n)
    cap = np.where(u < 0.1, 0.0, np.where(u < 0.3, 0.9 * dist, np.inf))
    _kernel_vs_plain(mt, scene_epsilon(ss), o.astype(np.float32),
                     ((tgt - o) / dist[:, None]).astype(np.float32),
                     cap.astype(np.float32), gpu)


@pytest.mark.cuda
@pytest.mark.parametrize("block", [16, 128])
def test_cuda_kernel_on_the_tie_pool(gpu, block):
    """The kernel against its plain version on the tie pool: every output
    bit for bit (exact ties go to the first triangle)."""
    mt, o, d = _tie_tables(block, gpu)
    _kernel_vs_plain(mt, T_MIN, o, d, np.full(len(o), np.inf, np.float32),
                     gpu)
