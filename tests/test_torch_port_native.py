"""The port's native batch assembly (``data/native.py``, ``csrc/fastbatch.cc``)
and the prefetched host streams, on the CPU.

Tolerances: none. Both native entry points give the JAX package's native
library's bits (the same source, built with the same ``g++`` flags), at
every thread count; the plain versions give JAX's numpy path's bits; the
pipeline's batches, now drawn through the native library, give JAX's
(native too) bits in memory and from a pack, over two epochs and
validation; the prefetched flat and chunked streams give the sequentially
assembled batches' bits, in order.
"""

import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.data import pipeline as jax_pipeline
from multimodal_mtrssm_tpu_torch.data import episodes, native, pack, pipeline
from _port_native import jax_native as jax_native  # noqa: F401 (a fixture)

SEEDS = (0, 7, 2**62 - 3)
THREADS = (0, 1, 4)


def _source(kind: str, seed: int) -> np.ndarray:
    """A float32 episode array: actions ``[N, T, A]`` or frames ``[N, T, H, W, C]``."""
    rng = np.random.default_rng(seed)
    shape = (9, 12, 6) if kind == "action" else (9, 12, 5, 4, 1)
    return rng.uniform(-80.0, 0.0, shape).astype(np.float32)


def _calls(src: np.ndarray):
    """The argument sets each test runs: the seq_len clamp (20 > T), an
    empty batch, repeated and out-of-order episodes."""
    for idx, seq_len in (([3, 1, 7, 7, 0], 6), ([8, 2], 20), ([], 5), ([4], 12)):
        yield np.asarray(idx, dtype=np.int64), seq_len


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind", ["action", "frames"])
def test_native_entry_points_are_jax_native_bits(jax_native, kind, seed):
    """Both entry points equal JAX's native library bit for bit, noised and
    not, at 0, 1 and 4 threads (which leave the bits as they are)."""
    src = _source(kind, seed)
    for idx, seq_len in _calls(src):
        for std in (0.0, 0.1):
            first = None
            for n in THREADS:
                got = native.gather_noise(src, idx, seq_len, std, seed, n_threads=n)
                want = jax_native.gather_noise(src, idx, seq_len, std, seed, n_threads=n)
                np.testing.assert_array_equal(got, want)
                assert got.shape == (len(idx), min(seq_len, 12), *src.shape[2:])
                first = got if first is None else first
                np.testing.assert_array_equal(got, first)
                got = native.gather_affine_noise(src, idx, seq_len, 2 / 80, 1.0, std, seed,
                                                 n_threads=n)
                want = jax_native.gather_affine_noise(src, idx, seq_len, 2 / 80, 1.0, std, seed,
                                                      n_threads=n)
                np.testing.assert_array_equal(got, want)


def test_native_reads_a_memmap_and_writes_into_out(jax_native, tmp_path):
    """A memory-mapped source (a pack's) is read through its mapping, and
    ``out`` receives the batch; a wrong ``out`` is refused."""
    src = _source("frames", 3)
    np.save(tmp_path / "frames.npy", src)
    mm = np.load(tmp_path / "frames.npy", mmap_mode="r")
    assert isinstance(mm, np.memmap)
    idx = np.array([5, 0, 2])
    for std in (0.0, 0.1):
        out = np.empty((3, 8, 5, 4, 1), np.float32)
        got = native.gather_affine_noise(mm, idx, 8, 2 / 255, -1.0, std, 11, out=out)
        assert got is out
        np.testing.assert_array_equal(
            out, jax_native.gather_affine_noise(mm, idx, 8, 2 / 255, -1.0, std, 11))
        got = native.gather_noise(mm, idx, 8, std, 11, out=out)
        np.testing.assert_array_equal(got, jax_native.gather_noise(mm, idx, 8, std, 11))
    with pytest.raises(ValueError, match="C-contiguous float32"):
        native.gather_noise(src, idx, 8, 0.1, 0, out=np.empty((3, 7, 5, 4, 1), np.float32))
    with pytest.raises(ValueError, match="C-contiguous float32"):
        native.gather_noise(src, idx, 8, 0.1, 0, out=np.empty((3, 8, 5, 4, 1), np.float64))


@pytest.mark.parametrize("kind", ["action", "frames"])
def test_plain_versions_are_jax_numpy_bits(kind, monkeypatch):
    """The plain versions equal JAX's numpy path (its library switched
    off) bit for bit; a source that is not float32 takes that path in both
    packages' ``gather_affine_noise``, by type."""
    from multimodal_mtrssm_tpu.data import native as jax_mod

    monkeypatch.setattr(jax_mod, "_load", lambda: None)
    src = _source(kind, 5)
    for idx, seq_len in _calls(src):
        for std, seed in ((0.0, 0), (0.1, 3), (0.1, 2**61)):
            np.testing.assert_array_equal(
                native.gather_noise_plain(src, idx, seq_len, std, seed),
                jax_mod.gather_noise(src, idx, seq_len, std, seed))
            np.testing.assert_array_equal(
                native.gather_affine_noise_plain(src, idx, seq_len, 0.5, -1.0, std, seed),
                jax_mod.gather_affine_noise(src, idx, seq_len, 0.5, -1.0, std, seed))
    raw = np.random.default_rng(1).integers(0, 255, (4, 6, 3, 3, 1)).astype(np.uint8)
    idx = np.array([2, 0])
    want = jax_mod.gather_affine_noise(raw, idx, 4, 2 / 255, -1.0, 0.1, 9)
    np.testing.assert_array_equal(native.gather_affine_noise(raw, idx, 4, 2 / 255, -1.0, 0.1, 9),
                                  want)
    out = np.empty_like(want)
    native.gather_affine_noise(raw, idx, 4, 2 / 255, -1.0, 0.1, 9, out=out)
    np.testing.assert_array_equal(out, want)


def test_noiseless_native_is_the_plain_version():
    """At std 0 the native library and the plain versions agree bit for
    bit: the gather, and ``x * scale + shift`` in float32."""
    src = _source("frames", 8)
    for idx, seq_len in _calls(src):
        np.testing.assert_array_equal(native.gather_noise(src, idx, seq_len, 0.0, 1),
                                      native.gather_noise_plain(src, idx, seq_len, 0.0, 1))
        np.testing.assert_array_equal(
            native.gather_affine_noise(src, idx, seq_len, 2 / 80, 1.0, 0.0, 1),
            native.gather_affine_noise_plain(src, idx, seq_len, 2 / 80, 1.0, 0.0, 1))


def test_a_failed_build_raises_and_never_takes_numpy(tmp_path, monkeypatch):
    """No ``g++``: loading raises and names the cause, and so does an
    entry point, which never gives way to numpy; a compile error raises
    with the compiler's message. Nothing is left in the build directory."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        native.load_library()
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        native.gather_noise(_source("action", 0), np.array([0]), 4, 0.1, 0)
    monkeypatch.undo()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "GXX_FLAGS", (*native.GXX_FLAGS, "-include", "no_such_header.h"))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        native.load_library()
    assert native._lib is None
    assert not list((tmp_path / "build").glob("*"))


def test_two_processes_building_at_once_leave_one_library(tmp_path):
    """Two processes that build into one empty directory at once both load
    a whole library, and the directory ends with that one file."""
    script = textwrap.dedent("""
        import sys
        from pathlib import Path
        import numpy as np
        from multimodal_mtrssm_tpu_torch.data import native
        native.BUILD_DIR = Path(sys.argv[1])
        src = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)
        out = native.gather_noise(src, np.array([1, 0]), 3, 0.0, 0)
        assert np.array_equal(out, src[[1, 0]]), out
        print(native.library_path().name)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", script, str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    names = {o[0].strip() for o in outs}
    assert len(names) == 1 and [p.name for p in tmp_path.iterdir()] == list(names)


# ---- the pipeline's batches --------------------------------------------------------------


@pytest.fixture(scope="module")
def episode_dir(tmp_path_factory):
    """9 episodes of 12 frames: 7 train (3 full batches of 2 and a tail), 2 val."""
    d = tmp_path_factory.mktemp("episodes")
    episodes.generate_synthetic_audio_mnist(d, n_episodes=9, episode_length=12, seed=3)
    return d


def _pair(data_dir, tmp_path, **kw):
    cfg = dict(data_dir=str(data_dir), batch_size=2, sequence_length=6, seed=5,
               common_processed_dir=str(tmp_path / "none"), **kw)
    return (pipeline.EpisodeDataModule(pipeline.DataModuleConfig(**cfg)),
            jax_pipeline.EpisodeDataModule(jax_pipeline.DataModuleConfig(**cfg)))


def _same(got, want) -> None:
    got, want = list(got), list(want)
    assert len(got) == len(want) and got
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("layout", ["memory", "pack"])
def test_batches_are_jax_native_bits(jax_native, episode_dir, tmp_path, layout):
    """In memory at ``noise_std=0.1`` and from a pack: two epochs of train
    batches, validation and the chunked items equal JAX's with its native
    library on, bit for bit."""
    data_dir = episode_dir
    if layout == "pack":
        data_dir = tmp_path / "data"
        pack.pack_episodes(episode_dir, data_dir / "pack")
    ours, theirs = _pair(data_dir, tmp_path, noise_std=0.1)
    for epoch in (0, 1):
        _same(ours.train_batches(epoch), theirs.train_batches(epoch))
    assert ours._raw == (layout == "pack")
    _same(ours.val_batches(), theirs.val_batches())
    got = list(ours.train_batches_chunked(1, 2))
    want = list(theirs.train_batches_chunked(1, 2))
    assert [k for k, _ in got] == [k for k, _ in want] == ["scan", "step", "step"]
    _same([b for _, b in got], [b for _, b in want])


def test_prefetched_streams_are_the_sequential_batches(episode_dir, tmp_path):
    """The prefetched flat streams give ``host_batches``' batches (assembled
    one by one on the caller's thread) in order, bit for bit; the chunked
    items, assembled into slices of one buffer, give them too; with
    ``rows`` each item carries its rows of the batch."""
    dm, _ = _pair(episode_dir, tmp_path, noise_std=0.1, drop_modality="random")
    for epoch in (0, 1):
        flat = list(dm.train_batches(epoch))
        _same(flat, dm.host_batches("train", epoch))
        items = list(dm.train_batches_chunked(epoch, 3))
        assert [k for k, _ in items] == ["scan", "step"]
        scan = items[0][1]
        _same([tuple(x[i] for x in scan) for i in range(3)] + [items[1][1]], flat)
    _same(dm.val_batches(), dm.host_batches("val"))
    for kind, batch, (lo, hi, n) in dm.train_batches_chunked(0, 3, rows=lambda n: (1, n)):
        assert (lo, hi) == (1, n) and batch[0].shape[1 if kind == "scan" else 0] == n - 1
    flat_rows = list(dm.train_batches(0, rows=lambda n: (0, 1)))
    assert [r for _, r in flat_rows] == [(0, 1, 2)] * 3 + [(0, 1, 1)]
    _same([b for b, _ in flat_rows], [tuple(x[:1] for x in b) for b in dm.train_batches(0)])


def test_an_assembly_error_reaches_the_consumer_after_the_batches_before_it(
        episode_dir, tmp_path, monkeypatch):
    dm, _ = _pair(episode_dir, tmp_path, noise_std=0.1)
    real, calls = dm._make_batch, [0]

    def make_batch(*args, **kw):
        calls[0] += 1
        if calls[0] == 3:
            raise OSError("episode page unreadable")
        return real(*args, **kw)

    monkeypatch.setattr(dm, "_make_batch", make_batch)
    got = []
    with pytest.raises(OSError, match="unreadable"):
        for batch in dm.train_batches(0):
            got.append(batch)
    assert len(got) == 2


def test_an_early_close_stops_the_worker(episode_dir, tmp_path):
    """Closing a stream after its first batch (the rollout GIFs take one)
    joins its worker, blocked on the full queue (4 batches, 2 ahead): the
    thread count is restored at once."""
    dm, _ = _pair(episode_dir, tmp_path, noise_std=0.1)
    dm.setup()
    before = threading.active_count()
    for stream in (dm.train_batches(0), dm.train_batches(1), dm.train_batches_chunked(0, 1)):
        next(iter(stream))
        assert threading.active_count() == before + 1
        stream.close()
        assert threading.active_count() == before


def test_cpu_items_share_the_assembled_arrays(episode_dir, tmp_path):
    """On the CPU an item is its host arrays, with no copy."""
    dm, _ = _pair(episode_dir, tmp_path)
    kind, batch = next(iter(dm.train_batches_chunked(0, 2)))
    assert kind == "scan" and all(isinstance(x, torch.Tensor) and x.device.type == "cpu"
                                  for x in batch)
    assert batch[0].shape[:2] == (2, 2) and batch[0].is_contiguous()
