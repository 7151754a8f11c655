"""Build the port's CUDA kernels into one shared library and load it.

`nvcc` compiles every `csrc/*.cu` for `sm_90a`, one process per source, all
started together, and links the objects into
`build/nrenderer_torch/libnrkernels.so` beside the package, at first use.
The build is skipped while the library is newer than every source and
every header (`csrc/*.cuh`).  The library has a plain C interface:
`ops/pt_cuda.py` and `ops/mesh_cuda.py` bind it with `ctypes`.  Nothing
here runs at import time, so the package imports on machines without a
compiler; a missing `nvcc` or a failed compile raises with the compiler's
output."""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "nrenderer_torch"
LIB_PATH = BUILD_DIR / "libnrkernels.so"
LOG_PATH = BUILD_DIR / "nvcc.log"

# No --use_fast_math: the hit tests and the hash need IEEE div and sqrt.
# -fmad=false keeps every multiply and add separately rounded, as the plain
# torch version computes them, so kernel and plain agree bit for bit (with
# contraction, rounding moved a few hits across edges and those paths
# flipped; about 11% faster on an H100, see PERF.md).
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-O3", "-std=c++17", "-fmad=false",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of this process's nvcc run, if it ran


class KernelBuildError(RuntimeError):
    pass


def sources(src_dir: Path = SRC_DIR) -> list:
    return sorted(src_dir.glob("*.cu"))


def headers(src_dir: Path = SRC_DIR) -> list:
    return sorted(src_dir.glob("*.cuh"))


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = Path(home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise KernelBuildError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels cannot be built")
    return nvcc


def _stale(lib_path: Path = LIB_PATH, src_dir: Path = SRC_DIR) -> bool:
    """Whether the library is missing or not newer than every source and
    header in `src_dir`."""
    if not lib_path.exists():
        return True
    built = lib_path.stat().st_mtime
    return any(f.stat().st_mtime >= built
               for f in sources(src_dir) + headers(src_dir))


def build() -> Path:
    """Compile the library if it is missing or older than a source."""
    global build_seconds
    if not _stale():
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{os.getpid()}.tmp"
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{tag}")
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            for src, obj in zip(sources(), objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    log = "".join(" ".join(cmd) + "\n" + out for cmd, out in zip(cmds, outs))
    failed = [p.returncode for p in procs if p.returncode != 0]
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
            *(str(o) for o in objs)]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        log += " ".join(link) + "\n" + proc.stdout + proc.stderr
        if proc.returncode != 0:
            failed.append(proc.returncode)
    build_seconds = time.perf_counter() - t0
    LOG_PATH.write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed ({failed[0]}):\n{log}")
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader sees old or new
    return LIB_PATH


def load_library() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib
