"""Host batch assembly in native code: a ``ctypes`` binding of
``csrc/fastbatch.cc`` (port of ``data/native.py``).

``gather_noise`` gathers episodes ``src[idx, :seq_len]`` and adds
``N(0, noise_std)`` input noise; ``gather_affine_noise`` also normalises
affinely (``x · scale + shift``), the memory-mapped pack's raw frames. One
pass over the batch on ``n_threads`` threads (0: every core), each row's
noise drawn by xoshiro128** and Box-Muller from ``seed ^ (0x9E3779B97F4A7C15
· (row + 1))``, so the bits do not depend on the thread count. Both take
``out``, a C-contiguous float32 array of the batch's shape, to assemble
straight into the caller's buffer (the pipeline's pinned staging buffers).

At first use ``g++ -O3 -shared -fPIC -pthread`` (the JAX package's flags:
its library and this one give the same bits) builds the source into
``build/torch_host/`` of the checkout, named after a hash of the source and
the flags; a build runs under a temporary name and is moved into place, so
processes that build at once leave one whole library. Unlike JAX, which
falls back to numpy silently where the build fails, a failed build or load
raises: the pipeline has no hidden second path. JAX's numpy path is kept
here as the plain versions, ``gather_noise_plain`` and
``gather_affine_noise_plain``, which the tests hold the native build
against; no path of the pipeline calls them, except where JAX's own rule by
type sends ``gather_affine_noise`` there (a source that is not a float32
``ndarray``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fastbatch.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_host"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread")

_F, _I64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
_SIGNATURES = {
    "fastbatch_gather_noise": [_F, _I64, _I64, _I64, ctypes.POINTER(_I64), _I64, _I64,
                               ctypes.c_float, ctypes.c_uint64, _F, _I64],
    "fastbatch_gather_affine_noise": [_F, _I64, _I64, _I64, ctypes.POINTER(_I64), _I64, _I64,
                                      ctypes.c_float, ctypes.c_float, ctypes.c_float,
                                      ctypes.c_uint64, _F, _I64],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libfastbatch-{h.hexdigest()[:16]}.so"


def _compile(out: Path) -> None:
    """``g++`` into a temporary name beside ``out``, then moved into place."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: the host batch library ({SOURCE.name}) "
                           "cannot be built")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)


def load_library() -> ctypes.CDLL:
    """The library, built on first use and then cached; raises where it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = None, argtypes
            _lib = lib
        return _lib


def _out(out: np.ndarray | None, shape: tuple[int, ...]) -> np.ndarray:
    """``out`` checked against the batch's shape, or a new array of it."""
    if out is None:
        return np.empty(shape, dtype=np.float32)
    if out.shape != shape or out.dtype != np.float32 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(f"out must be a C-contiguous float32 array of shape {shape}, got "
                         f"{out.dtype} {out.shape}")
    return out


def _dims(src: np.ndarray, idx: np.ndarray, seq_len: int) -> tuple[int, tuple[int, ...], int]:
    """The clamped ``seq_len`` (numpy's ``:seq_len`` slice clamps to the
    episode, and the kernel must not read past its row), the batch's shape,
    and the elements of a frame."""
    seq_len = min(int(seq_len), int(src.shape[1]))
    frame = tuple(src.shape[2:])
    return seq_len, (idx.shape[0], seq_len, *frame), int(np.prod(frame)) if frame else 1


def gather_noise(src: np.ndarray, idx: np.ndarray, seq_len: int, noise_std: float, seed: int,
                 n_threads: int = 0, out: np.ndarray | None = None) -> np.ndarray:
    """``src[idx, :seq_len]`` plus ``N(0, noise_std)`` noise (none at 0),
    fused in native code. ``src``: ``[N, T, ...]`` (made float32 and
    C-contiguous; a memmap is read through its mapping); ``idx``: ``[B]``."""
    src = np.ascontiguousarray(src, dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    seq_len, shape, frame_elems = _dims(src, idx, seq_len)
    out = _out(out, shape)
    load_library().fastbatch_gather_noise(
        src.ctypes.data_as(_F), src.shape[0], src.shape[1], frame_elems,
        idx.ctypes.data_as(ctypes.POINTER(_I64)), shape[0], seq_len, noise_std, seed,
        out.ctypes.data_as(_F), n_threads)
    return out


def gather_affine_noise(src: np.ndarray, idx: np.ndarray, seq_len: int, scale: float,
                        shift: float, noise_std: float, seed: int, n_threads: int = 0,
                        out: np.ndarray | None = None) -> np.ndarray:
    """``src[idx, :seq_len] · scale + shift`` plus ``N(0, noise_std)`` noise
    (none at 0), fused in native code. A source that is not a float32
    ``ndarray`` takes :func:`gather_affine_noise_plain`, as JAX's does."""
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if not isinstance(src, np.ndarray) or src.dtype != np.float32:
        plain = gather_affine_noise_plain(src, idx, seq_len, scale, shift, noise_std, seed)
        if out is None:
            return plain
        _out(out, plain.shape)[...] = plain
        return out
    src = src if src.flags["C_CONTIGUOUS"] else np.ascontiguousarray(src)
    seq_len, shape, frame_elems = _dims(src, idx, seq_len)
    out = _out(out, shape)
    load_library().fastbatch_gather_affine_noise(
        src.ctypes.data_as(_F), src.shape[0], src.shape[1], frame_elems,
        idx.ctypes.data_as(ctypes.POINTER(_I64)), shape[0], seq_len, scale, shift, noise_std,
        seed, out.ctypes.data_as(_F), n_threads)
    return out


# ---- the plain versions: JAX's numpy path -------------------------------------------------


def gather_noise_plain(src: np.ndarray, idx: np.ndarray, seq_len: int, noise_std: float,
                       seed: int) -> np.ndarray:
    """:func:`gather_noise`'s plain version: the gather, then noise from
    ``default_rng(seed)`` (another stream than the native one)."""
    src = np.ascontiguousarray(src, dtype=np.float32)
    out = src[np.ascontiguousarray(idx, dtype=np.int64), :seq_len].copy()
    if noise_std > 0:
        out += np.random.default_rng(seed).normal(0.0, noise_std, out.shape).astype(np.float32)
    return out


def gather_affine_noise_plain(src: np.ndarray, idx: np.ndarray, seq_len: int, scale: float,
                              shift: float, noise_std: float, seed: int) -> np.ndarray:
    """:func:`gather_affine_noise`'s plain version: the gather and the
    affine map in float32, then noise from ``default_rng(seed)``."""
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    out = np.asarray(src[idx, :seq_len], dtype=np.float32) * scale + shift
    if noise_std > 0:
        out += np.random.default_rng(seed).normal(0.0, noise_std, out.shape).astype(np.float32)
    return out
