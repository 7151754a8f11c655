"""Build the port's CUDA kernels into one shared library and load it.

`nvcc` compiles every `csrc/*.cu` for `sm_90a` into
`build/nrenderer_torch/libnrkernels.so` beside the package, at first use.
The build is skipped while the library is newer than every source.  The
library has a plain C interface: `ops/pt_cuda.py` binds it with `ctypes`.
Nothing here runs at import time, so the package imports on machines
without a compiler; a missing `nvcc` or a failed compile raises with the
compiler's output."""
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
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of this process's nvcc run, if it ran


class KernelBuildError(RuntimeError):
    pass


def sources() -> list:
    return sorted(SRC_DIR.glob("*.cu"))


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


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime >= built for src in sources())


def build() -> Path:
    """Compile the library if it is missing or older than a source."""
    global build_seconds
    if not _stale():
        return LIB_PATH
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    LOG_PATH.write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, LIB_PATH)  # atomic: a concurrent loader sees old or new
    return LIB_PATH


def load_library() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = ctypes.CDLL(str(build()))
        return _lib
