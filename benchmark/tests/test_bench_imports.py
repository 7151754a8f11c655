"""What the benchmark's processes load: neither JAX nor the JAX package
(compared by each module's whole top-level name), after the harness and
the reference are imported and after the command refuses for want of a
card; and no module of the reference loads anything of the renderer."""
import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "nrenderer_tpu"}


def _top_level_after(code: str) -> set:
    """The top-level names in sys.modules after `code` runs in a fresh
    interpreter started in the benchmark's folder without a CUDA device."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    script = (f"import sys; sys.path[:0] = [{BENCH!r}, {ROOT!r}]\n{code}\n"
              "import json; print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], cwd=BENCH, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_refusal_load_no_jax():
    loaded = _top_level_after(
        "import harness, check, control, devtrace, readers, roofline\n"
        "import io, contextlib\n"
        "buf = io.StringIO()\n"
        "with contextlib.redirect_stdout(buf):\n"
        "    rc = harness.main(['--workload', 'cornell.final', '--seed', "
        "'1', '--seconds', '1'], 0.0)\n"
        "assert rc == 2 and buf.getvalue() == '', (rc, buf.getvalue())\n"
        "from nrenderer_torch import cli\n"
        "assert harness.forbidden_modules() == []")
    assert not loaded & FORBIDDEN
    # the JAX package's name is a prefix of the renderer's: whole names
    assert "nrenderer_torch" in loaded


def test_reference_loads_nothing_of_the_renderer():
    names = sorted(n[:-3] for n in os.listdir(os.path.join(BENCH, "reference"))
                   if n.endswith(".py") and n != "__init__.py")
    assert {"analytic", "png", "scene", "tracer"} <= set(names)
    loaded = _top_level_after(
        "import " + ", ".join(f"reference.{n}" for n in names))
    assert not loaded & (FORBIDDEN | {"nrenderer_torch"})


def test_command_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "glass.final", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA device" in out.stderr
