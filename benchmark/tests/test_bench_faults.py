"""A run with the timed path broken underneath comes out not correct.

Each test drives `harness.run_cell` as a run does, past its look for a
card, on the renderer's plain versions at a small size on the CPU, with one
fault planted in the renderer: the film returned unchanged, half of the
samples left out and the mean taken over the rest, and the answer altered
where it is produced (the render drawn at another seed).  The same runs
without a fault come out correct.  (No cell spans chips, so none can
leave out the exchange between them.)"""
import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

import harness  # noqa: E402
from cells import spec as cell_spec  # noqa: E402


def _run(cell, seed=2 ** 31 + 17):
    spec = cell_spec(cell)
    t = spec["traffic"]
    t.update(width=32, height=32, spp=16, depth=6)
    t["check"] = dict(t["check"], every=1, renders=2, pixels=32 * 32)
    return harness.run_cell(spec, seed, 0.5, False, time.perf_counter(),
                            device="cpu")


def _state_unchanged(monkeypatch):
    from nrenderer_torch.ops import pt_cuda
    monkeypatch.setattr(pt_cuda, "pt_accumulate", lambda film, *a, **k: film)


def _half_the_samples(monkeypatch):
    from nrenderer_torch.ops import pt_cuda
    orig = pt_cuda.pt_accumulate

    def half(film, ss, cam, w, h, sp0, n_spp, *args, **kwargs):
        orig(film, ss, cam, w, h, sp0, max(1, n_spp // 2), *args, **kwargs)
        film *= n_spp / max(1, n_spp // 2)
        return film
    monkeypatch.setattr(pt_cuda, "pt_accumulate", half)


def _answer_altered(monkeypatch):
    from nrenderer_torch.renderers import acc_pt, simple_pt
    for mod, name in ((simple_pt, "render_simple_pt"),
                      (acc_pt, "render_bsdf_pt")):
        orig = getattr(mod, name)

        def other_seed(*args, _orig=orig, seed=0, **kwargs):
            return _orig(*args, seed=seed + 1, **kwargs)
        monkeypatch.setattr(mod, name, other_seed)


@pytest.mark.parametrize("cell", ["cornell.final", "glass.final",
                                  "cornell.draft"])
def test_unbroken_runs_are_correct(cell):
    result = _run(cell)
    assert result["correct"], result["checked"]
    assert result["failed"] == 0 and result["attempted"] >= 1


@pytest.mark.parametrize("cell", ["cornell.final", "glass.final"])
@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_samples,
                                   _answer_altered])
def test_a_broken_render_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(cell)
    assert not result["correct"], result["checked"]
