"""`roofline.py` against the renderer's chip smoke test: for the same
work count, the same operations and bytes, over the published peaks."""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import roofline  # noqa: E402
from reference import scene  # noqa: E402


@pytest.mark.parametrize("name", ["cornell_box.scn", "pt_glass_box.scn"])
@pytest.mark.parametrize("n_pix,spp,bounces_per_sample",
                         [(512 * 512, 256, 4.25), (128 * 128, 16, 1.5),
                          (61 * 37, 33, 0.0)])
def test_work_is_chip_smokes(name, n_pix, spp, bounces_per_sample,
                             monkeypatch):
    import chip_smoke
    from nrenderer_torch import build_scene_arrays, load_scn
    from nrenderer_torch.ops.intersect import make_static_scene
    ss = make_static_scene(build_scene_arrays(
        load_scn(os.path.join(BENCH, "scenes", name))))
    tables = scene.load_tables(os.path.join(BENCH, "scenes", name))
    samples = n_pix * spp
    work = {"samples": samples, "bounces": samples * bounces_per_sample}
    # chip_smoke's bound at the published FP32 peak in place of its own
    monkeypatch.setattr(chip_smoke, "peak_fp32",
                        lambda: roofline.PEAK_FP32_OPS)
    want_ms, _ = chip_smoke.bound_ms(ss, n_pix, work, None)
    flops, n_bytes = roofline.render_work(
        scene.primitive_counts(tables), scene.table_floats(tables), n_pix,
        spp, bounces_per_sample, 1)
    assert roofline.least_seconds(flops, n_bytes) * 1e3 == pytest.approx(
        want_ms, rel=1e-12)
    assert chip_smoke.PEAK_BYTES_PER_S == roofline.PEAK_HBM_BYTES
    for k in ("FLOPS_SAMPLE", "FLOPS_SPHERE", "FLOPS_TRIANGLE",
              "FLOPS_PATCH", "FLOPS_SCATTER"):
        assert getattr(chip_smoke, k) == getattr(roofline, k)


def test_table_bytes_are_the_kernels():
    from nrenderer_torch import build_scene_arrays, load_scn
    from nrenderer_torch.ops.intersect import make_static_scene
    from nrenderer_torch.ops.pt_cuda import pack_scene
    for name in ("cornell_box.scn", "pt_glass_box.scn"):
        path = os.path.join(BENCH, "scenes", name)
        ss = make_static_scene(build_scene_arrays(load_scn(path)))
        assert pack_scene(ss)[0].nbytes == 4 * scene.table_floats(
            scene.load_tables(path))


def test_least_time_takes_the_larger_bound():
    assert roofline.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(67e12, 2 * 3.35e12) == pytest.approx(2.0)
