"""Build and load the port's CUDA kernels.

The sources in ``csrc/`` have a plain C interface. At first use ``nvcc``
compiles each source to an object, all at once in parallel, and links them
into one shared library under ``build/torch_kernels/`` of the checkout,
named after a hash of the sources and flags; ``ctypes`` loads it. Nothing
here runs at import time: the package imports on a machine with no CUDA
toolkit, and only a kernel launch on a CUDA tensor needs the build.
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
SOURCES = ("recurrence_fwd.cu", "recurrence_bwd.cu", "rollout.cu", "recurrence_mt_fwd.cu",
           "recurrence_mt_bwd.cu", "rollout_mt.cu", "recurrence_stacked_fwd.cu",
           "recurrence_stacked_bwd.cu", "fused_encoder_fwd.cu", "fused_encoder_bwd.cu",
           "fused_decoder_fwd.cu", "fused_decoder_bwd.cu", "fused_encoder_bf16_fwd.cu",
           "fused_encoder_bf16_bwd.cu", "fused_decoder_bf16_fwd.cu", "fused_decoder_bf16_bwd.cu")
HEADERS = ("mrssm_common.cuh", "conv_common.cuh", "chain_common.cuh", "forward_chain.cuh",
           "stack_map.cuh", "dense_grads.cuh", "fused_encoder.cuh", "fused_decoder.cuh",
           "bf16_mma.cuh", "fused_encoder_bf16.cuh", "fused_decoder_bf16.cuh")
# Hopper only (sm_90a); no --use_fast_math, so expf/logf/tanhf stay accurate
# and the straight-through value (onehot + p) - p is not reassociated.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int


class MTDims(ctypes.Structure):
    """``mrssm::MTDims`` of ``csrc/mrssm_common.cuh``, field for field: the
    MMTRSSM kernels' sizes, rows per block, and each layer's ``1/tau`` and
    ``1 - 1/tau`` (rounded to f32 from double, as JAX rounds its constants)."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "T", "B", "A", "E", "HD", "LD", "C", "R", "ls_class", "ls_category", "hs_class",
        "hs_category", "rows")] + [(name, ctypes.c_float) for name in (
            "l_inv", "l_keep", "h_inv", "h_keep")]


class EncDims(ctypes.Structure):
    """``fenc::EncDims`` of ``csrc/fused_encoder.cuh``, field for field: the
    fused encoder's frame count and sizes, frames per block of the
    cotangent pass, and frames per chunk of the weight-gradient pass."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "N", "H", "W", "C0", "coord", "ch0", "ch1", "ch2", "res_out", "res_mid", "n_res",
        "out_dim", "frames", "chunk")]


class DecDims(ctypes.Structure):
    """``fdec::DecDims`` of ``csrc/fused_decoder.cuh`` (and ``fdbf::DecDims``
    of ``csrc/fused_decoder_bf16.cuh``), field for field: the fused
    decoder's frame count, feature width and layer widths, frames per block,
    and frames per chunk of its weight-gradient pass."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "N", "F", "lin0", "c0", "h0", "w0", "res_in", "res_mid", "n_res", "ch0", "ch1", "ch2",
        "frames", "chunk")]

# name → (restype, argtypes) of the C entry points called from Python.
_SIGNATURES = {
    "mrssm_recurrence_forward": (_I, [_P] * 14 + [_I] * 10 + [_P]),
    "mrssm_recurrence_fwd_rows": (_I, [_I] * 8),
    "mrssm_recurrence_backward": (_I, [_P] * 18 + [_I] * 10 + [_P]),
    "mrssm_recurrence_bwd_rows": (_I, [_I] * 7),
    "mrssm_recurrence_bwd_workspace": (ctypes.c_longlong, [_I] * 8),
    "mrssm_rollout": (_I, [_P] * 10 + [_I] * 9 + [_P]),
    "mt_recurrence_forward": (_I, [_P] * 4 + [MTDims, _I, _P]),
    "mt_recurrence_fwd_rows": (_I, [MTDims, _I]),
    "mt_recurrence_backward": (_I, [_P] * 6 + [MTDims, _I, _P]),
    "mt_recurrence_bwd_rows": (_I, [MTDims, _I]),
    "mt_recurrence_bwd_workspace": (ctypes.c_longlong, [MTDims]),
    "mt_rollout": (_I, [_P] * 6 + [MTDims, _I, _P]),
    "mrssm_stacked_forward": (_I, [_P] * 14 + [_I] * 9 + [_P]),
    "mrssm_stacked_fwd_workspace": (ctypes.c_longlong, [_I] * 8),
    "mrssm_stacked_backward": (_I, [_P] * 18 + [_I] * 9 + [_P]),
    "mrssm_stacked_bwd_workspace": (ctypes.c_longlong, [_I] * 8),
    "fused_encoder_sizes": (_I, [EncDims, _P]),
    "fused_encoder_forward": (_I, [_P, _I, _P, _P, _P, _P, EncDims, _P]),
    "fused_encoder_backward": (_I, [_P, _I] + [_P] * 9 + [EncDims, _P]),
    "fused_encoder_bf16_sizes": (_I, [EncDims, _P]),
    "fused_encoder_bf16_forward": (_I, [_P, _I, _P, _P, _P, _P, EncDims, _P]),
    "fused_encoder_bf16_backward": (_I, [_P, _I] + [_P] * 9 + [EncDims, _P]),
    "fused_decoder_sizes": (_I, [DecDims, _P]),
    "fused_decoder_forward": (_I, [_P, _I, _P, _P, _P, DecDims, _P]),
    "fused_decoder_backward": (_I, [_P, _I] + [_P] * 8 + [DecDims, _P]),
    "fused_decoder_bf16_sizes": (_I, [DecDims, _P]),
    "fused_decoder_bf16_forward": (_I, [_P, _I, _P, _P, _P, DecDims, _P]),
    "fused_decoder_bf16_backward": (_I, [_P, _I] + [_P] * 8 + [DecDims, _P]),
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
    """One ``nvcc -c`` per source, started together, then one link."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{Path(s).stem}.o") for s in SOURCES]
    cmds = [[nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)] for o, s in zip(objs, SOURCES)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    try:
        errs = [p.communicate()[1] for p in procs]
        failed = [(cmd, p.returncode, err) for cmd, p, err in zip(cmds, procs, errs)
                  if p.returncode != 0]
        if not failed:
            link = [nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
            proc = subprocess.run(link, capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                failed = [(link, proc.returncode, proc.stderr)]
        if failed:
            tmp.unlink(missing_ok=True)
            raise RuntimeError("\n".join(f"nvcc failed ({rc}): {' '.join(cmd)}\n{err}"
                                         for cmd, rc, err in failed))
        os.replace(tmp, out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for o in objs:
            o.unlink(missing_ok=True)


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
