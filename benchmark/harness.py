"""One run of one cell: set-up, a closed loop of renders for the window,
the check, the result line.

The cell (`BENCHMARK.json` `workloads`) names a configuration (a scene,
the renderer that renders it, the reference's estimator, and optionally
OBJ files `"obj"`, an environment map `"env_map"` and the reference
module `"reference"`: `configs/<name>.json`) and a traffic mix
(`traffic/<name>.json`: width, height, spp, depth, which renders and
pixels the check reads, and the check's limits).  A run:

1. checks that CUDA has the devices the cell asks for (else exits 2 and
   prints no result), builds or loads the renderer's kernel and host
   libraries (their build caches sit at fixed paths in the checkout's
   `build/`), and renders once at the cell's shape: that is set-up;
2. runs one user's closed loop for `--seconds`: the renderer's own
   command, `nrenderer_torch.cli.main(["render", ...])`, in this process,
   each render started when the last one's PNG is written, each with its
   own render seed drawn from `--seed` and its index; a render that
   starts inside the window is waited for;
3. reads the device's peak memory, frees the renderer's cached memory and
   checks the PNGs (`check.py`) against the configuration's reference;
4. refuses (exits 1, no result) if JAX or the JAX package is loaded;
5. prints the numbers compared, then the result line: with `--trace 0`
   the cell's end-to-end metrics, with `--trace 1` its per-layer metrics,
   each read by `metrics/<name>.py` from the run's record.

`--trace 1` runs the window under `torch.profiler` (CPU and CUDA
activities) and records host spans around the renderer's layers
(`Spans`) to name the device's idle time."""
from __future__ import annotations

import argparse
import contextlib
import gc
import importlib.util
import io
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "nrenderer_tpu")


class SpecError(ValueError):
    pass


def load_json(path: Path):
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_spec(workload: str, root: Path = ROOT) -> dict:
    """The cell, its configuration and traffic, and the metrics it reports
    (end-to-end and per-layer), from `BENCHMARK.json` under `root`."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SpecError(f"no workload {workload!r}; the cells are "
                        f"{', '.join(cells)}")
    return cell_spec(cells[workload], bench, root)


def cell_spec(cell: dict, bench: dict, root: Path = ROOT) -> dict:
    """`load_spec` of a `workloads` entry `cell` of the benchmark `bench`
    (an entry not in `bench`, as the tests' held-out cells, reports only
    the metrics that every cell reports)."""
    workload = cell["name"]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = load_json(root / files[cell["config"]])
    traffic = load_json(root / "benchmark" / "traffic"
                        / f"{cell['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    return {"cell": cell, "config": config, "traffic": traffic,
            "end_to_end": e2e, "per_layer": layer}


def load_reader(name: str, bench: Path = BENCH):
    """`metrics/<name>.py`'s `read`."""
    path = bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cli_argv(spec: dict, seed: int, out: str, device: str) -> list:
    """The user's `render` command for one render of the cell: the
    configuration's scene, then each of its OBJ files (`"obj"`, a list of
    checkout-relative paths, in order; an OBJ's MTL and textures come
    with it), the renderer, the traffic's shape, and the configuration's
    environment map (`"env_map"`, a checkout-relative PNG) if it names
    one."""
    c, t = spec["config"], spec["traffic"]
    argv = ["render", "--scene", str(ROOT / c["scene"])]
    for path in c.get("obj", []):
        argv += ["--obj", str(ROOT / path)]
    argv += ["--renderer", c["renderer"], "--width", str(t["width"]),
             "--height", str(t["height"]), "--spp", str(t["spp"]),
             "--depth", str(t["depth"]), "--seed", str(seed),
             "--out", out, "--device", device]
    if "env_map" in c:
        argv += ["--env-map", str(ROOT / c["env_map"])]
    return argv


class Spans:
    """Host spans (name, start, end in perf_counter seconds) around the
    renderer's layers, recorded while installed: the scene parse
    (`io.scn.load_scn`, `io.obj.load_obj`), the renderer's call
    ("scene-prep": its host work around the render phase), the render
    phase (`render_simple_pt`, `render_bsdf_pt`, and AccPathTracer's mesh
    routes whole, their BVH build with them), the PNG write
    (`io.image.write_png`); the harness adds "cli" around each command."""

    def __init__(self):
        self.spans = []
        self._undo = []

    def span(self, name: str):
        spans = self.spans

        @contextlib.contextmanager
        def cm():
            t0 = time.perf_counter()
            try:
                yield
            finally:
                spans.append((name, t0, time.perf_counter()))
        return cm()

    def wrap(self, owner, attr: str, name: str) -> None:
        orig = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            with self.span(name):
                return orig(*args, **kwargs)
        setattr(owner, attr, wrapped)
        self._undo.append((owner, attr, orig))

    def install(self) -> None:
        from nrenderer_torch.io import image, obj, scn
        from nrenderer_torch.renderers import acc_pt, simple_pt
        self.wrap(scn, "load_scn", "parse")
        self.wrap(obj, "load_obj", "parse")
        self.wrap(image, "write_png", "png")
        self.wrap(simple_pt.SimplePathTracerRenderer, "render", "scene-prep")
        self.wrap(acc_pt.AccPathTracerRenderer, "render", "scene-prep")
        self.wrap(simple_pt, "render_simple_pt", "render")
        self.wrap(acc_pt, "render_bsdf_pt", "render")
        self.wrap(acc_pt.AccPathTracerRenderer, "_render_megamesh", "render")
        self.wrap(acc_pt.AccPathTracerRenderer, "_render_hybrid", "render")

    def remove(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo.clear()


def gpu_state() -> str:
    """nvidia-smi's name, power limit, SM clock, temperature and power
    draw of the first card, as one CSV line ("" without nvidia-smi)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "temperature.gpu,power.draw", "--format=csv,noheader", "-i",
             "0"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
             start: float, device: str = "cuda") -> dict:
    """One run of the cell `spec` (`load_spec`); returns the result line's
    object (its last key, "checked", the compared numbers and their
    limits) plus "_record", what the metric files read.  `device` "cpu"
    runs the renderer's plain versions (the tests' small cells)."""
    import torch
    import check
    import nrenderer_torch
    from nrenderer_torch import cli
    from nrenderer_torch.ops import pt_cuda
    from nrenderer_torch.utils.timing import GLOBAL_TIMER

    config, traffic = spec["config"], spec["traffic"]
    phase = f"{config['renderer']}.render"
    tmp = Path(tempfile.mkdtemp(prefix="nrbench."))
    shared_out = str(tmp / "render.png")
    spans = Spans() if trace else None
    try:
        nrenderer_torch._register_builtin_renderers()
        if device == "cuda":
            pt_cuda._kernels()               # nvcc once per checkout
        from nrenderer_torch import native
        native.available()                   # g++ once per checkout
        sink = io.StringIO()

        def render(k: int, out: str) -> tuple:
            rseed = check.render_seed(seed, k)
            sink.seek(0)
            sink.truncate()
            with contextlib.redirect_stdout(sink):
                try:
                    rc = cli.main(cli_argv(spec, rseed, out, device))
                except Exception as exc:   # a render that raises failed
                    print(f"render {k} raised {exc!r}", file=sys.stderr)
                    rc = -1
            return rseed, rc

        rseed, rc = render(-1, shared_out)   # warm-up at the cell's shape
        if rc != 0:
            raise RuntimeError(f"the warm-up render exited {rc}")
        if device == "cuda":
            torch.cuda.synchronize()
        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                prof = profile(activities=acts)
            prof.start()
            spans.install()
        launches0 = dict(pt_cuda.KERNEL_LAUNCHES)
        renders = []
        from torch.profiler import record_function
        window_start = time.perf_counter()
        setup_s = window_start - start
        with record_function("bench:window"):
            anchor = time.perf_counter()
            k = 0
            while time.perf_counter() - window_start < seconds:
                keep = check.kept(seed, k, traffic["check"]["every"])
                out = str(tmp / f"render{k}.png") if keep else shared_out
                before = GLOBAL_TIMER.get(phase).total_s
                t0 = time.perf_counter()
                if spans is not None:
                    with spans.span("cli"):
                        rseed, rc = render(k, out)
                else:
                    rseed, rc = render(k, out)
                t1 = time.perf_counter()
                rec = {"k": k, "seed": rseed, "t0": t0, "t1": t1,
                       "ok": rc == 0, "kept": keep, "out": out,
                       "phase_s": GLOBAL_TIMER.get(phase).total_s - before}
                renders.append(rec)
                k += 1
        window_end = time.perf_counter()
        smi = gpu_state() if device == "cuda" else ""
        launches = {n: c - launches0.get(n, 0)
                    for n, c in pt_cuda.KERNEL_LAUNCHES.items()
                    if c - launches0.get(n, 0)}
        trace_rec = None
        if prof is not None:
            if device == "cuda":
                torch.cuda.synchronize()
            prof.stop()
            spans.remove()
            import devtrace
            events = devtrace.load_events(prof, str(tmp / "trace.json"))
            trace_rec = devtrace.summarize(events, spans.spans, anchor)
            trace_rec["window_s"] = window_end - window_start
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        # the renderer's state is freed before the reference runs
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        stats = {}
        numbers = check.compare(config, traffic, ROOT, seed, renders,
                                device if device == "cpu" else "cuda:0",
                                stats)
        failed = sum(not r["ok"] for r in renders)
        correct, shown = check.judge(numbers, traffic["limits"], failed,
                                     sum(r["ok"] for r in renders))
        ref = check.reference_for(config, ROOT)
        tables = ref.load(config, ROOT)
        record = {"renders": renders, "window_start": window_start,
                  "setup_s": setup_s, "trace": trace_rec,
                  "launches": launches, "work": stats, "traffic": traffic,
                  "config": config,
                  "tables": {"counts": ref.counts(tables),
                             "floats": ref.table_floats(tables)}}
        metrics = {}
        for m in (spec["per_layer"] if trace else spec["end_to_end"]):
            value = load_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if device == "cuda" else "cpu",
               "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                        else "cpu"),
               "count": spec["cell"]["chips"], "memory_peak_bytes": peak}
        if smi:
            dev["nvidia_smi"] = smi
        result = {"correct": bool(correct), "attempted": len(renders),
                  "failed": failed, "metrics": metrics, "device": dev}
        if trace_rec is not None:
            dev["busy_s"] = trace_rec["busy_s"]
            dev["window_s"] = trace_rec["window_s"]
            import devtrace
            result["breakdown"] = {
                "device_ops": devtrace.top(trace_rec["ops"]),
                "idle_gaps": devtrace.top(trace_rec["idle"])}
        result["diag"] = diagnostics(renders)
        result["checked"] = shown
        result["_record"] = record
        return result
    finally:
        if spans is not None:
            spans.remove()
        shutil.rmtree(tmp, ignore_errors=True)


def diagnostics(renders: list) -> dict:
    """Medians of the renders' latency, render phase and the rest, in
    milliseconds, and the host's load average: where a run's time and its
    spread came from."""
    import statistics
    med = lambda xs: statistics.median(xs) if xs else None
    done = [r for r in renders if r["ok"]]
    phase = [r["phase_s"] * 1e3 for r in done if r["phase_s"] is not None]
    return {"latency_ms": med([(r["t1"] - r["t0"]) * 1e3 for r in done]),
            "render_phase_ms": med(phase),
            "host_ms": med([(r["t1"] - r["t0"]) * 1e3 - p
                            for r, p in zip(done, phase)] if phase else []),
            "loadavg": os.getloadavg()[0]}


def main(argv, start: float) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        spec = load_spec(args.workload)
    except (OSError, KeyError, ValueError) as exc:
        print(f"error: {exc!r}", file=sys.stderr)
        return 2
    import torch
    want = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < want:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: the cell {args.workload} needs {want} CUDA device(s),"
              f" {have} available; no result", file=sys.stderr)
        return 2
    # the renderer's build caches stay at fixed paths in the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    logging.basicConfig(level=logging.WARNING)
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), start)
    found = forbidden_modules()
    if found:
        print(f"error: loaded in the benchmark's process: {found}; no "
              "result", file=sys.stderr)
        return 1
    result.pop("_record")
    for name, item in result["checked"].items():
        print(f"check {name}: {item['value']} (limit {item['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
