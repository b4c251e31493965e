"""Memory-mapped episode packs: datasets bounded by disk, not RAM (numpy
copy of ``data/pack.py``, the same files).

The episode store consolidated once into one raw ``.npy`` per stream;
training opens them with ``mmap_mode="r"``, so batch assembly touches only
the gathered pages. Streams stay raw (un-normalised): the pipeline
normalises each gathered batch, so one pack serves any normaliser.

Layout of a pack directory::

    <pack>/action.npy  float32 [N, T, A]
    <pack>/audio.npy   float32 [N, T, H, W, C]
    <pack>/vision.npy  float32 [N, T, H, W, C]
    <pack>/meta.json   {"n_episodes": N, "shapes": {stream: [...]}}

``EpisodeDataModule.setup`` finds a pack in ``data_dir`` or ``data_dir/pack``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from numpy.lib.format import open_memmap

from multimodal_mtrssm_tpu_torch.data import episodes as ep

STREAMS = ep.EPISODE_KEYS


def _stream_path(directory: Path | str, stream: str) -> Path:
    return Path(directory) / f"{stream}.npy"


def has_pack(directory: Path | str) -> bool:
    """True if ``directory`` holds a complete per-stream pack."""
    d = Path(directory)
    return d.is_dir() and all(_stream_path(d, s).exists() for s in STREAMS)


def open_pack(directory: Path | str) -> dict[str, np.ndarray]:
    """Open a pack read-only; each stream an ``np.memmap``-backed array."""
    d = Path(directory)
    arrays = {s: np.load(_stream_path(d, s), mmap_mode="r") for s in STREAMS}
    n = {s: a.shape[0] for s, a in arrays.items()}
    if len(set(n.values())) != 1:
        raise ValueError(f"pack streams disagree on episode count: {n}")
    return arrays


def pack_episodes(episodes_dir: Path | str, out_dir: Path | str) -> dict:
    """Consolidate an episode store into a pack, one episode resident at a
    time (``open_memmap``). Returns the ``meta.json`` contents."""
    paths = ep.list_episodes(episodes_dir)
    if not paths:
        raise FileNotFoundError(f"no episodes under {episodes_dir}")
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    first = ep.load_episode(paths[0])
    n = len(paths)
    writers = {s: open_memmap(_stream_path(out, s), mode="w+", dtype=np.float32,
                              shape=(n, *getattr(first, s).shape)) for s in STREAMS}
    for i, p in enumerate(paths):
        e = first if i == 0 else ep.load_episode(p)
        for s in STREAMS:
            arr = getattr(e, s)
            if arr.shape != writers[s].shape[1:]:
                raise ValueError(f"{p}: {s} shape {arr.shape} != pack shape "
                                 f"{writers[s].shape[1:]}")
            writers[s][i] = arr.astype(np.float32)
    for w in writers.values():
        w.flush()
    meta = {"n_episodes": n,
            "shapes": {s: [n, *map(int, getattr(first, s).shape)] for s in STREAMS}}
    (out / "meta.json").write_text(json.dumps(meta, indent=1))
    return meta
