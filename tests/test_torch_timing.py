"""The port's phase timer and spans (`nrenderer_torch/utils/timing.py`):
span fields and nesting, the manager thread's spans under the command's
root, the spans of one `render` command through `cli.main` on the CPU,
the per-name totals, the ring's bound, and the `torch.profiler` ranges
(entered only while a profile records)."""
import pathlib
import threading

import pytest
import torch

from nrenderer_torch import cli
from nrenderer_torch.utils import timing
from nrenderer_torch.utils.timing import GLOBAL_TIMER, PhaseTimer

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
RES = REPO / "resource"
SCENES = {"SimplePathTracer": RES / "cornell_box.scn",
          "AccPathTracer": RES / "pt_glass_box.scn"}


def _argv(renderer, out, *extra, spp=4):
    return ["render", "--scene", str(SCENES[renderer]), "--renderer",
            renderer, "--width", "16", "--height", "16", "--spp", str(spp),
            "--depth", "3", "--device", "cpu", "--out", str(out), *extra]


def _command(argv):
    """The spans of one `cli.main(argv)`: those of its root's render id."""
    assert cli.main(argv) == 0
    spans = GLOBAL_TIMER.spans()
    root = next(s for s in reversed(spans) if s.name == "cli.render")
    return root, [s for s in spans if s.render == root.render]


def test_span_fields_and_nesting():
    timer = PhaseTimer()
    with timer.phase("outer", root=True):
        with timer.phase("inner"):
            pass
        with timer.scope("R").phase("leaf"):
            pass
    with timer.phase("after"):
        pass
    inner, leaf, outer, after = timer.spans()
    assert [s.name for s in (inner, leaf, outer, after)] == [
        "inner", "R.leaf", "outer", "after"]
    assert outer.parent is None and outer.render is not None
    assert inner.parent == outer.id and leaf.parent == outer.id
    assert inner.render == leaf.render == outer.render
    assert outer.t0 <= inner.t0 <= inner.t1 <= leaf.t0 <= leaf.t1 <= outer.t1
    assert after.parent is None and after.render is None
    assert len({s.id for s in (inner, leaf, outer, after)}) == 4


def test_worker_thread_spans_take_the_root():
    timer = PhaseTimer()

    def work():
        with timer.phase("worker"):
            with timer.phase("worker-child"):
                pass

    with timer.phase("root", root=True):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    child, worker, root = timer.spans()
    assert worker.parent == root.id and child.parent == worker.id
    assert child.render == worker.render == root.render
    # the next root starts another render id; a worker outside any root
    # has no parent
    with timer.phase("root", root=True):
        pass
    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=30)
    root2, child2, worker2 = timer.spans()[-3:]
    assert root2.render != root.render
    assert worker2.parent is None and worker2.render is None


@pytest.mark.parametrize("renderer", ["SimplePathTracer", "AccPathTracer"])
def test_render_command_spans(renderer, tmp_path):
    """Exactly the command's spans: the root, the parse, the renderer's
    scene prep, render and post on the manager thread (parented to the
    root), the PNG write with its quantise-filter and deflate inside it;
    one render id a command."""
    root, spans = _command(_argv(renderer, tmp_path / "a.png"))
    names = sorted(s.name for s in spans)
    assert names == sorted([
        "cli.render", "cli.parse", f"{renderer}.scene-prep",
        f"{renderer}.render", f"{renderer}.host-post", "cli.png",
        "png.quantise-filter", "png.deflate"])
    by = {s.name: s for s in spans}
    inner = ("png.quantise-filter", "png.deflate")
    assert all(s.parent == root.id for s in spans
               if s is not root and s.name not in inner)
    assert all(by[n].parent == by["cli.png"].id for n in inner)
    assert by["cli.png"].t0 <= by[inner[0]].t0 <= by[inner[0]].t1 \
        <= by[inner[1]].t0 <= by[inner[1]].t1 <= by["cli.png"].t1
    assert all(root.t0 <= s.t0 <= s.t1 <= root.t1 for s in spans)
    order = ["cli.parse", f"{renderer}.scene-prep", f"{renderer}.render",
             f"{renderer}.host-post", "cli.png"]
    assert all(by[a].t1 <= by[b].t0 for a, b in zip(order, order[1:]))
    root2, spans2 = _command(_argv(renderer, tmp_path / "b.png"))
    assert root2.render != root.render and len(spans2) == len(spans)


def test_totals_accumulate_under_the_old_names(tmp_path):
    names = ("SimplePathTracer.render", "SimplePathTracer.scene-prep",
             "cli.png")
    before = {n: GLOBAL_TIMER.get(n) for n in names}
    before = {n: (st.total_s, st.count) for n, st in before.items()}
    _, spans = _command(_argv("SimplePathTracer", tmp_path / "a.png"))
    for n in names:
        st = GLOBAL_TIMER.get(n)
        span = next(s for s in spans if s.name == n)
        assert st.count == before[n][1] + 1
        assert st.total_s - before[n][0] == pytest.approx(span.t1 - span.t0)


def test_scope_keeps_its_own_totals():
    timer = PhaseTimer()
    scoped = timer.scope("R")
    for _ in range(2):
        with scoped.phase("render"):
            pass
    assert scoped.get("render").count == 2
    assert timer.get("R.render").count == 2
    assert scoped.get("render").total_s == pytest.approx(
        timer.get("R.render").total_s)
    assert scoped.summary().startswith("render ") and "x2" in \
        scoped.summary()


def test_ring_is_bounded_and_counts_what_it_drops():
    timer = PhaseTimer(capacity=3)
    for k in range(5):
        with timer.phase(f"s{k}"):
            pass
    assert [s.name for s in timer.spans()] == ["s2", "s3", "s4"]
    assert timer.dropped == 2
    # the totals keep every span
    assert sum(timer.get(f"s{k}").count for k in range(5)) == 5
    assert timing.SPAN_CAPACITY >= 700 * 6


def test_threads_lose_no_span():
    """Many threads recording at once, with a short switch interval: every
    span counted once, ids unique, each parented within its own thread."""
    import os
    import sys
    n_threads, n_spans = 4 * (os.cpu_count() or 1), 200
    timer = PhaseTimer(capacity=2 * n_threads * n_spans)

    def work():
        for _ in range(n_spans):
            with timer.phase("outer"):
                with timer.phase("inner"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    total = 2 * n_threads * n_spans
    assert timer.get("outer").count + timer.get("inner").count == total
    spans = timer.spans()
    assert timer.dropped == 0 and len(spans) == total
    assert len({s.id for s in spans}) == total
    outer = {s.id: s for s in spans if s.name == "outer"}
    assert all(s.parent is None for s in outer.values())
    assert all(outer[s.parent].t0 <= s.t0 <= s.t1 <= outer[s.parent].t1
               for s in spans if s.name == "inner")


def test_progressive_route_render_span_covers_every_pass(tmp_path):
    """The checkpointed megakernel route: `AccPathTracer.render` covers
    its 8 passes, the first included, each a child span."""
    root, spans = _command(_argv(
        "AccPathTracer", tmp_path / "a.png", "--checkpoint",
        str(tmp_path / "film.npz"), spp=8))
    render = next(s for s in spans if s.name == "AccPathTracer.render")
    passes = [s for s in spans
              if s.name in ("AccPathTracer.first-pass",
                            "AccPathTracer.render-pass")]
    assert [s.name for s in passes] == ["AccPathTracer.first-pass"] + \
        ["AccPathTracer.render-pass"] * 7
    assert all(s.parent == render.id for s in passes)
    assert render.t0 <= passes[0].t0 and passes[-1].t1 <= render.t1
    assert render.parent == root.id


def test_no_profiler_range_without_a_profile(tmp_path, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profile")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    _command(_argv("SimplePathTracer", tmp_path / "a.png"))


def test_profile_all_threads_shows_both_threads_ranges(tmp_path):
    from torch.profiler import ProfilerActivity, profile
    cli.main(_argv("SimplePathTracer", tmp_path / "warm.png"))
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=config) as prof:
        _command(_argv("SimplePathTracer", tmp_path / "a.png"))
    threads = {}
    for e in prof.events():
        if e.name.startswith("nr:"):
            threads.setdefault(e.name, set()).add(e.thread)
    assert set(threads) == {
        "nr:cli.render", "nr:cli.parse", "nr:cli.png",
        "nr:SimplePathTracer.scene-prep", "nr:SimplePathTracer.render",
        "nr:SimplePathTracer.host-post", "nr:png.quantise-filter",
        "nr:png.deflate"}
    main = threads["nr:cli.render"]
    assert threads["nr:cli.png"] == main
    assert threads["nr:png.quantise-filter"] == threads["nr:png.deflate"] \
        == main
    assert threads["nr:SimplePathTracer.render"].isdisjoint(main)
