"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` have a plain C interface. ``nvcc`` compiles them at
first use into one shared library under ``build/torch_kernels/`` of the
checkout, named after a hash of the sources and flags, and ``ctypes`` loads
it. Nothing here runs at import time: the package imports on a machine with
no CUDA toolkit, and only a kernel launch on a CUDA tensor needs the build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
SOURCES = ("recurrence_fwd.cu", "recurrence_bwd.cu", "rollout.cu")
HEADERS = ("mrssm_common.cuh",)
# Hopper only (sm_90a); no --use_fast_math, so expf/logf/tanhf stay accurate
# and the straight-through value (onehot + p) - p is not reassociated.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# name → (restype, argtypes) of the C entry points called from Python.
_SIGNATURES = {
    "mrssm_recurrence_forward": (_I, [_P] * 13 + [_I] * 9 + [_P]),
    "mrssm_recurrence_backward": (_I, [_P] * 18 + [_I] * 9 + [_P]),
    "mrssm_recurrence_bwd_rows": (_I, [_I] * 7),
    "mrssm_rollout": (_I, [_P] * 7 + [ctypes.c_ulonglong] + [_I] * 8 + [_P]),
    "mrssm_error_string": (ctypes.c_char_p, [_I]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# Wall seconds the last build (or load of a cached build) took.
build_seconds: float | None = None


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return found


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libmrssm_kernels-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use and then cached."""
    global _lib, build_seconds
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            path = library_path()
            if not path.is_file():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            build_seconds = time.perf_counter() - t0
            _lib = lib
        return _lib


def check(err: int) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = load_library().mrssm_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel launch failed: error {err} ({msg})")
