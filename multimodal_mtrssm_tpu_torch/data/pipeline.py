"""Input pipeline: episode store → preprocessed host arrays → batches on the
device (port of ``data/pipeline.py``, its host paths).

``setup`` reads the data directory (``effective_data_dir``: the common
processed directory where it holds a data set, else ``data_dir``) in one of
three layouts: a memory-mapped pack (``data/pack.py``), ``.npz`` episodes,
or the reference's processed ``act_*/audio_obs_*/vision_obs_*`` triplets,
converted once into ``converted_episodes/`` behind a completion marker.
Episodes are normalised once (audio min-max and vision [0, 255] to [-1, 1],
or the config's ``*_preprocess`` transforms); a pack stays raw and each
gathered batch is normalised, affinely for the standard normalisers, as
JAX does. The sorted episodes split 0.8 / 0.2 (reference
``dataset.py:69-81``). A training epoch shuffles with ``default_rng((seed,
epoch))``, so its batch order is the JAX module's. Validation batches, in
split order, draw from ``default_rng((seed, 987654321))``, as JAX's and the
reference's val DataLoader do. Each batch takes one seed from its generator
and noises each input stream with ``N(0, noise_std)`` from ``seed ^ (k +
1)`` (k = 0, 1, 2 for action, audio, vision) through the native fused
gather (``data/native.py``, ``csrc/fastbatch.cc``), where JAX's
``_make_batch`` does (``data/pipeline.py:256-295``): in memory where
``noise_std > 0``, and from a pack, whose gathered raw frames that library
also normalises, for the standard (affine) normalisers, at any std. The
targets stay clean. Batches keep the reference's 6-tuple order
(``mrssm/dataset.py:168-183``): (action_input, audio_input, vision_input,
action_target, audio_target, vision_target).

``drop_modality``: ``"audio"`` or ``"vision"`` replaces that input stream
with the ``ZeroOut`` fill -1 in every batch; ``"random"`` draws, after the
noise, each train sample's fate from the epoch's generator (both kept,
audio dropped, vision dropped, a third each), as JAX draws it. Validation
stays clean under ``"random"``, as JAX's comment promises and its code does
not (it drops validation inputs too); and a mid-epoch resume counts the
dropout draw, which JAX's ``_batch_consumes_rng`` does not, so the resumed
epoch is the whole epoch's tail.

``train_batches`` takes a ``skip`` for a mid-epoch resume: the batches
after it, their noise and their drops are those of the whole epoch.

``modality``: ``"multimodal"`` serves the 6-tuple; ``"audio"`` or
``"vision"`` serves the unimodal RSSM's 4-tuple (action_input, obs_input,
action_target, obs_target), as JAX does (``data/pipeline.py:224-240``):
only the served streams are gathered, noised (each with its stream's own
seed, ``k`` as above) and counted in ``batch_nbytes``. A static
``drop_modality`` acts only on a served stream; ``"random"`` needs both
and is refused otherwise.

Chunked streams (JAX ``data/pipeline.py:377-483``): ``train_batches_chunked``
and ``val_batches_chunked`` serve the flat streams' batches, bit for bit and
in order, as ``("scan", [K, B, ...])`` items of K full batches and
``("step", batch)`` items for the rest (fewer than K full batches, and the
ragged tail, which flushes the full ones before it), for the trainer's K-step
dispatch; the flat streams are their items at K=1. A daemon thread assembles
the host items two ahead (``_prefetch_iter``, JAX's ``_device_prefetch``).
On the CPU the items are those host arrays. On a CUDA device the thread
assembles each item into a pinned buffer of a ring (a scan item's batches
into slices of one ``[K, B, ...]`` buffer), and the consumer copies it to
the card asynchronously on a copy stream, one item ahead
(``data/staging.py``), so no thread but the caller's touches the card while
it captures a CUDA graph; there is no other route to the card. With
``rows`` (a mesh rank's rows of each batch) only those rows move, and each
item carries ``(lo, hi, n)``.

``device_resident`` (JAX ``:79-96``, ``:485-651``): the normalised,
T-sliced streams are uploaded once to the batches' device and every batch is
gathered there (``index_select``), its input noise drawn on the device from
a generator seeded ``fold(seed, epoch, j, stream)`` (validation: ``fold(seed,
987654321, j, stream)``) for the batch's index ``j`` in its epoch, so a
mid-epoch resume and any K draw the same noise; ``"random"`` drops, drawn
from ``fold(seed, epoch, j, 3)``, touch training batches only. At
``noise_std=0`` it serves the host stream's values. Pack mode, or streams
over ``device_resident_max_bytes``, warn once and stream from the host.
"""

from __future__ import annotations

import dataclasses
import json
import os
import queue
import threading
import warnings
from collections import Counter
from pathlib import Path
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from multimodal_mtrssm_tpu_torch.data import episodes as ep
from multimodal_mtrssm_tpu_torch.data import native
from multimodal_mtrssm_tpu_torch.data import pack as packmod
from multimodal_mtrssm_tpu_torch.data.staging import RowsFn, Staging, staged_items
from multimodal_mtrssm_tpu_torch.data.transforms import (
    Identity,
    NormalizeAudioMelSpectrogram,
    NormalizeVisionImage,
    affine_of,
)
from multimodal_mtrssm_tpu_torch.utils import fold

Batch = tuple[torch.Tensor, ...]
HostBatch = tuple[np.ndarray, ...]
Item = tuple[str, Batch]
DROPS = (None, "audio", "vision", "random")
# The validation stream's generator path (JAX's and the reference's val loader).
_VAL_STREAM = 987654321
# Floats of noise a native gather's thread draws (~1 ms of Box-Muller on an
# H100's host, 4× the start of a thread): 4 threads for a B=8 T=30 stream
# of 32x32 frames, 1 for its actions.
NOISE_GRAIN = 1 << 16
MODALITIES = ("multimodal", "audio", "vision")


@dataclasses.dataclass
class DataModuleConfig:
    """The fields of the JAX ``DataModuleConfig`` that this pipeline serves."""

    data_dir: str | Path = "data/audio_mnist"
    batch_size: int = 8
    sequence_length: int = 30  # TakeFirstN n (configs :180-220)
    noise_std: float = 0.1  # GaussianNoise on the inputs, not the targets
    train_ratio: float = 0.8
    audio_min: float = -80.0
    audio_max: float = 0.0
    seed: int = 42
    # None, "audio" or "vision" (ZeroOut that input stream), or "random"
    # (per train sample: both, audio dropped or vision dropped, a third each).
    drop_modality: str | None = None
    # "multimodal": 6-tuple batches; "audio" or "vision": the unimodal
    # 4-tuple (action_in, obs_in, action_tgt, obs_tgt).
    modality: str = "multimodal"
    # False: the ragged tail batch trains and validates too (reference
    # DataLoader drop_last=False).
    drop_last: bool = False
    # Reference get_effective_processed_data_dir (dataset.py:136-161): where
    # this directory holds a data set in a layout setup reads, it takes
    # precedence over data_dir.
    common_processed_dir: str | Path = Path("data") / "processed_data"
    # Per-stream preprocess transforms (None: the normalisers above).
    action_preprocess: Callable | None = None
    audio_preprocess: Callable | None = None
    vision_preprocess: Callable | None = None
    # Upload the normalised streams once and gather every batch on the
    # batches' device (the module docstring); 8 GB of streams at most.
    device_resident: bool = False
    device_resident_max_bytes: int = 8 << 30

    def __post_init__(self):
        if self.drop_modality not in DROPS:
            raise ValueError(f"drop_modality={self.drop_modality!r} not in {DROPS}")
        if self.modality not in MODALITIES:
            raise ValueError(f"modality={self.modality!r} not in {MODALITIES}")
        if self.drop_modality == "random" and self.modality != "multimodal":
            raise ValueError(f"drop_modality='random' needs both streams; modality="
                             f"{self.modality!r} serves one")


def _is_reference_pt_layout(d: Path) -> bool:
    """A reference-format processed directory: ``act_*`` files with their
    observation streams (a lone ``act``-prefixed file does not count)."""
    return bool(sorted(d.glob("act_*")) and sorted(d.glob("audio_obs_*"))
                and sorted(d.glob("vision_obs_*")))


def effective_data_dir(cfg: DataModuleConfig) -> Path:
    """``common_processed_dir`` where it holds a data set in a layout
    ``setup`` reads (episodes, a pack, reference triplets), else
    ``data_dir`` (reference ``get_effective_processed_data_dir``,
    ``dataset.py:136-161``)."""
    common = Path(cfg.common_processed_dir)
    if common.exists() and (packmod.has_pack(common) or ep.list_episodes(common)
                            or _is_reference_pt_layout(common)):
        return common
    return Path(cfg.data_dir)


class EpisodeDataModule:
    """Loads episodes, preprocesses once, serves batches on a device."""

    def __init__(self, config: DataModuleConfig):
        self.cfg = config
        self._arrays: dict[str, np.ndarray] | None = None
        self._split: tuple[np.ndarray, np.ndarray] | None = None
        self._raw = False  # a pack: raw memmapped streams, normalised per batch
        self._preprocess: dict[str, Callable] = {}
        self._dev_data: tuple[torch.device, dict[str, torch.Tensor]] | None = None
        self._dev_warned = False
        self._frame_list: list[tuple[tuple[int, ...], np.dtype]] | None = None

    def setup(self) -> None:
        """Open the data directory's pack, or load and normalise its
        episodes (converting reference triplets first), and split them."""
        cfg = self.cfg
        self._preprocess = {
            "action": cfg.action_preprocess or Identity(),
            "audio": cfg.audio_preprocess or NormalizeAudioMelSpectrogram(cfg.audio_min,
                                                                          cfg.audio_max),
            "vision": cfg.vision_preprocess or NormalizeVisionImage(),
        }
        data_dir = effective_data_dir(cfg)
        pack_dir = data_dir if packmod.has_pack(data_dir) else data_dir / "pack"
        if packmod.has_pack(pack_dir):
            self._arrays = packmod.open_pack(pack_dir)
            self._raw = True
            n = self._arrays["action"].shape[0]
        else:
            paths = _episode_paths(data_dir)
            streams: dict[str, list[np.ndarray]] = {s: [] for s in ep.EPISODE_KEYS}
            for e in map(ep.load_episode, paths):
                for s, frames in streams.items():
                    frames.append(self._preprocess[s](getattr(e, s)))
            self._arrays = {k: np.stack(v).astype(np.float32) for k, v in streams.items()}
            self._raw = False
            n = len(paths)
        n_train = int(n * cfg.train_ratio)
        self._split = (np.arange(n_train), np.arange(n_train, n))
        self._frame_list = None

    def _require_setup(self) -> None:
        if self._arrays is None:
            self.setup()

    @property
    def n_train(self) -> int:
        self._require_setup()
        return len(self._split[0])

    @property
    def n_val(self) -> int:
        self._require_setup()
        return len(self._split[1])

    @property
    def train_batch_size(self) -> int:
        """Effective train batch: clamped so small datasets still train."""
        return max(1, min(self.cfg.batch_size, self.n_train))

    @property
    def val_batch_size(self) -> int:
        return max(1, min(self.cfg.batch_size, self.n_val)) if self.n_val else 0

    def _streams(self) -> tuple[str, ...]:
        """The streams the configured modality serves, in batch order."""
        m = self.cfg.modality
        return ep.EPISODE_KEYS if m == "multimodal" else ("action", m)

    def batch_nbytes(self, bs: int) -> int:
        """float32 bytes of one batch of ``bs`` episodes, inputs and
        targets, of the streams the modality serves."""
        self._require_setup()
        per_frame = sum(int(np.prod(self._arrays[s].shape[2:])) for s in self._streams())
        return 2 * bs * self.cfg.sequence_length * per_frame * 4

    def _frames(self) -> list[tuple[tuple[int, ...], np.dtype]]:
        """Each output's per-row shape and dtype, in batch order (inputs,
        then targets): ``[T, ...]`` float32 frames, T clamped to the
        episodes; a pack's stream under a transform that is no affine
        normaliser takes its transform's output on one episode."""
        if self._frame_list is None:
            T = self.cfg.sequence_length
            frames = []
            for s in self._streams():
                src = self._arrays[s]
                if self._raw and affine_of(self._preprocess[s]) is None:
                    x = self._preprocess[s](np.asarray(src[:1, :T]))
                    frames.append((x.shape[1:], x.dtype))
                else:
                    frames.append(((min(T, src.shape[1]), *src.shape[2:]), np.dtype(np.float32)))
            self._frame_list = frames * 2
        return self._frame_list

    def _empty(self, lead: tuple[int, ...]) -> HostBatch:
        """Uninitialised host arrays for a batch (or chunk) of ``lead``."""
        return tuple(np.empty((*lead, *shape), dtype) for shape, dtype in self._frames())

    def _gather(self, stream: str, idx: np.ndarray, k: int, rng: np.random.Generator | None,
                seed: int, noised: np.ndarray, clean: np.ndarray) -> None:
        """One stream's input and target for episodes ``idx``, written into
        ``noised`` and ``clean``: the input noised from ``seed ^ (k + 1)``
        by the native gather where noise applies (in memory, ``noise_std >
        0`` and a generator). From a pack the gathered raw frames are
        normalised here: affinely by the native gather for the standard
        normalisers (with the noise as above, at any std), else by the
        transform, the noise then drawn from ``rng`` (JAX
        ``data/pipeline.py:256-295``)."""
        cfg = self.cfg
        T, src = cfg.sequence_length, self._arrays[stream]
        threads = _gather_threads(noised.size)
        if not self._raw:
            native.gather_noise(src, idx, T, 0.0, 0, n_threads=1, out=clean)
            if rng is None or cfg.noise_std <= 0:
                noised[...] = clean
            else:
                native.gather_noise(src, idx, T, cfg.noise_std, seed ^ (k + 1), threads, noised)
            return
        std = cfg.noise_std if rng is not None else 0.0
        pre = self._preprocess[stream]
        affine = affine_of(pre)
        if affine is not None:
            native.gather_affine_noise(src, idx, T, *affine, std, seed ^ (k + 1),
                                       threads if std > 0 else 1, noised)
            if std > 0:
                native.gather_affine_noise(src, idx, T, *affine, 0.0, 0, n_threads=1, out=clean)
            else:
                clean[...] = noised
            return
        clean[...] = pre(np.asarray(src[idx, :T]))
        if std > 0:
            noised[...] = clean + rng.normal(0, std, clean.shape).astype(np.float32)
        else:
            noised[...] = clean

    def _make_batch(self, idx: np.ndarray, rng: np.random.Generator | None,
                    train: bool = False, out: HostBatch | None = None) -> HostBatch:
        """The 6-tuple (or the unimodal 4-tuple) of numpy arrays, assembled
        into ``out`` where given (else new arrays): the inputs noised and
        dropped as the module docstring says, the targets clean. With
        ``rng`` a batch first draws one noise seed (in memory only where
        ``noise_std > 0``); a ``train`` batch under
        ``drop_modality="random"`` then draws each sample's fate."""
        cfg = self.cfg
        draws = rng is not None and (self._raw or cfg.noise_std > 0)
        seed = int(rng.integers(0, 2**62)) if draws else 0
        streams = self._streams()
        n = len(streams)
        out = self._empty((len(idx),)) if out is None else out
        for j, s in enumerate(streams):
            self._gather(s, idx, ep.EPISODE_KEYS.index(s), rng, seed, out[j], out[n + j])
        drop = cfg.drop_modality
        if drop in ("audio", "vision") and drop in streams:  # a served stream only
            out[streams.index(drop)].fill(-1.0)
        elif drop == "random" and train:
            choice = rng.integers(0, 3, size=len(idx))
            for k, s in ((1, "audio"), (2, "vision")):
                out[streams.index(s)][choice == k] = -1.0
        return out

    def _batched_indices(self, idx: np.ndarray, bs: int) -> list[np.ndarray]:
        """Full batches, then (unless ``drop_last``) the ragged tail."""
        if bs <= 0:
            return []
        n_full = len(idx) // bs
        out = [idx[i * bs:(i + 1) * bs] for i in range(n_full)]
        if not self.cfg.drop_last and len(idx) % bs:
            out.append(idx[n_full * bs:])
        return out

    def _batch_consumes_rng(self, rng: np.random.Generator | None) -> bool:
        """Whether a train batch, ``_make_batch(idx, rng, train=True)``,
        draws from ``rng``: the test a mid-epoch skip keys off (skipping
        at the index level is exact only when no batch draws). It mirrors
        ``_make_batch``'s draws: the noise seed (a pack's whenever ``rng``
        is given, in memory where ``noise_std > 0``) and, under
        ``drop_modality="random"``, the dropout draw, which JAX's predicate
        leaves out."""
        if rng is None:
            return False
        return self._raw or self.cfg.noise_std > 0 or self.cfg.drop_modality == "random"

    def _train_groups(self, epoch: int) -> tuple[np.random.Generator, list[np.ndarray]]:
        """The epoch's generator, after its shuffle, and its index batches."""
        rng = np.random.default_rng((self.cfg.seed, epoch))
        idx = rng.permutation(self._split[0])
        return rng, self._batched_indices(idx, self.train_batch_size)

    def train_batches(self, epoch: int, device: torch.device | str = "cpu", skip: int = 0,
                      rows: RowsFn | None = None) -> Iterator:
        """Shuffled, noised (and dropped) train batches of one epoch: the
        items of :meth:`train_batches_chunked` at K=1, each a batch (with
        ``rows``: ``(batch, (lo, hi, n))``). ``skip`` drops the first
        batches (a mid-epoch resume) and leaves the rest as the whole epoch
        serves them: skipped batches still make their draws, or are dropped
        at the index level when no batch draws (JAX
        ``data/pipeline.py:354-376``)."""
        for item in self.train_batches_chunked(epoch, 1, device, skip, rows):
            yield item[1] if rows is None else item[1:]

    def val_batches(self, device: torch.device | str = "cpu",
                    rows: RowsFn | None = None) -> Iterator:
        """Validation batches in split order, the inputs noised from
        ``default_rng((seed, 987654321))`` (JAX ``data/pipeline.py:653-664``)
        and dropped only by a static ``drop_modality``: the items of
        :meth:`val_batches_chunked` at K=1, as :meth:`train_batches`."""
        for item in self.val_batches_chunked(1, device, rows):
            yield item[1] if rows is None else item[1:]

    def train_batches_chunked(self, epoch: int, k: int, device: torch.device | str = "cpu",
                              skip: int = 0, rows: RowsFn | None = None) -> Iterator[Item]:
        """``train_batches(epoch)``'s batches, bit for bit and in order, as
        ``("scan", [k, B, ...])`` items of k full batches and ``("step",
        batch)`` items (:meth:`_grouped_indices`) on ``device``; with
        ``rows``, only rows ``rows(n)`` of each batch of ``n``, the item
        then ``(kind, batch, (lo, hi, n))``. ``skip`` counts batches, as
        the trainer's ``items_done`` does (JAX counts chunk items): the
        first ``skip`` batches make their draws and are dropped, and the
        rest are grouped anew from there."""
        self._require_setup()
        rng, groups = self._train_groups(epoch)
        bs = self.train_batch_size
        if self.device_resident_active():
            return self._device_items(groups, bs, k, device, epoch, skip, True, rows)
        if skip and not self._batch_consumes_rng(rng):
            groups, skip = groups[skip:], 0
        return self._host_items(groups, bs, k, device, rng, skip, True, rows)

    def val_batches_chunked(self, k: int, device: torch.device | str = "cpu",
                            rows: RowsFn | None = None) -> Iterator[Item]:
        """``val_batches()``'s batches as :meth:`train_batches_chunked`'s
        items, k clamped to the full validation batches (JAX
        ``data/pipeline.py:407-431``: the split is far smaller than the
        training split that sized k)."""
        self._require_setup()
        bs = self.val_batch_size
        groups = self._batched_indices(self._split[1], bs)
        k = max(1, min(k, sum(1 for g in groups if len(g) == bs)))
        if self.device_resident_active():
            return self._device_items(groups, bs, k, device, _VAL_STREAM, 0, False, rows)
        rng = np.random.default_rng((self.cfg.seed, _VAL_STREAM))
        return self._host_items(groups, bs, k, device, rng, 0, False, rows)

    @staticmethod
    def _grouped_indices(groups: Iterable[np.ndarray], bs: int,
                         k: int) -> Iterator[tuple[str, np.ndarray]]:
        """Full batches gathered into ``("scan", [k, B] indices)`` items; a
        ragged batch first flushes the pending full ones as ``("step",
        [B] indices)`` items, so the order is the flat stream's (JAX
        ``_grouped_indices``)."""
        pending: list[np.ndarray] = []
        for g in groups:
            if len(g) == bs and k > 1:
                pending.append(g)
                if len(pending) == k:
                    yield "scan", np.stack(pending)
                    pending = []
            else:
                yield from (("step", p) for p in pending)
                pending = []
                yield "step", g
        yield from (("step", p) for p in pending)

    def _host_items(self, groups: list[np.ndarray], bs: int, k: int,
                    device: torch.device | str, rng: np.random.Generator, skip: int,
                    train: bool, rows: RowsFn | None) -> Iterator[Item]:
        """The host path's items: each batch assembled in group order (the
        flat stream's draws, the first ``skip`` batches drawn and dropped)
        on a prefetch thread, a scan item's batches into slices of one
        buffer. On the CPU the items are those arrays; on a CUDA device
        each is assembled into a pinned buffer and staged (module
        docstring)."""
        device = torch.device(device)
        plan = list(self._grouped_indices(groups[skip:], bs, k))
        staging = None
        if device.type == "cuda":
            staging = Staging(device, Counter(idx.shape for _, idx in plan), self._frames())

        def assemble() -> Iterator[tuple]:
            for g in groups[:skip]:
                self._make_batch(g, rng, train)
            for kind, idx in plan:
                bufs = staging.take(idx.shape) if staging else (None, self._empty(idx.shape))
                if kind == "scan":
                    for i, g in enumerate(idx):
                        self._make_batch(g, rng, train, tuple(x[i] for x in bufs[1]))
                else:
                    self._make_batch(idx, rng, train, bufs[1])
                yield kind, idx.shape, bufs

        items = _prefetch_iter(assemble())
        if staging is not None:
            return staged_items(items, staging, rows)
        return _cpu_items(items, rows)

    # ---- the device-resident dataset ----------------------------------------
    def device_resident_active(self) -> bool:
        """Whether batches are gathered from the device-resident streams:
        ``device_resident`` is set and neither a pack nor the budget stands
        in the way (each of those warns once and streams from the host, as
        JAX does)."""
        if not self.cfg.device_resident:
            return False
        self._require_setup()
        reason = None
        if self._raw:
            reason = "memmapped pack mode keeps raw pages on disk"
        else:
            T = self.cfg.sequence_length
            nbytes = sum(self._arrays[s][:, :T].nbytes for s in self._streams())
            if nbytes > self.cfg.device_resident_max_bytes:
                reason = (f"dataset needs {nbytes >> 20} MB resident, over the "
                          f"{self.cfg.device_resident_max_bytes >> 20} MB budget "
                          "(device_resident_max_bytes)")
        if reason is None:
            return True
        if not self._dev_warned:
            warnings.warn(f"device_resident dataset disabled ({reason}); falling back to host "
                          "streaming", stacklevel=3)
            self._dev_warned = True
        return False

    def _device_dataset(self, device: torch.device) -> dict[str, torch.Tensor]:
        """The served streams' normalised, T-sliced frames on ``device``,
        uploaded once (again only for another device)."""
        if self._dev_data is None or self._dev_data[0] != device:
            T = self.cfg.sequence_length
            self._dev_data = (device, {s: torch.as_tensor(np.ascontiguousarray(
                self._arrays[s][:, :T]), device=device) for s in self._streams()})
        return self._dev_data[1]

    def _device_items(self, groups: list[np.ndarray], bs: int, k: int,
                      device: torch.device | str, path: int, skip: int, train: bool,
                      rows: RowsFn | None) -> Iterator[Item]:
        """The device-resident path's items, grouped as the host path's;
        batch j of the stream (``skip`` onwards) draws from ``fold(seed,
        path, j, ·)`` (``path``: the epoch, or validation's 987654321).
        With ``rows`` each rank gathers the whole batch and keeps its rows."""
        device = torch.device(device)
        data = self._device_dataset(device)
        gen = torch.Generator(device=device)
        j = skip
        for kind, idx in self._grouped_indices(groups[skip:], bs, k):
            mat = np.atleast_2d(idx)
            batch = self._device_batch(data, mat, path, j, gen, train)
            j += mat.shape[0]
            yield _with_rows(kind, batch if kind == "scan" else tuple(x[0] for x in batch),
                             rows, mat.shape[1])

    def _device_batch(self, data: dict[str, torch.Tensor], rows: np.ndarray, path: int,
                      j0: int, gen: torch.Generator, train: bool) -> Batch:
        """``[k, B, ...]`` batches j0 … j0+k-1 gathered from ``data`` at the
        index matrix ``rows``: inputs noised and dropped, targets clean, in
        ``_make_batch``'s tuple order."""
        cfg = self.cfg
        k, b = rows.shape
        dev = next(iter(data.values())).device
        flat = torch.as_tensor(rows.reshape(-1), dtype=torch.int64, device=dev)
        seed = lambda j, s: fold(cfg.seed, path, j, s)  # noqa: E731
        outs = {}
        for s in self._streams():
            k_s = ep.EPISODE_KEYS.index(s)
            clean = data[s].index_select(0, flat).view(k, b, *data[s].shape[1:])
            noised = clean
            if cfg.noise_std > 0:
                noise = torch.stack([torch.randn(clean.shape[1:], generator=gen.manual_seed(
                    seed(j0 + i, k_s)), device=dev) for i in range(k)])
                noised = clean + cfg.noise_std * noise
            if cfg.drop_modality == s:
                noised = torch.full_like(clean, -1.0)
            outs[s] = (noised, clean)
        if cfg.drop_modality == "random" and train:
            choice = torch.stack([torch.randint(0, 3, (b,), generator=gen.manual_seed(
                seed(j0 + i, 3)), device=dev) for i in range(k)])
            for code, s in ((1, "audio"), (2, "vision")):
                x, target = outs[s]
                sel = (choice == code).view(k, b, *(1,) * (x.ndim - 2))
                outs[s] = (torch.where(sel, -1.0, x), target)
        inputs, targets = zip(*(outs[s] for s in self._streams()))
        return (*inputs, *targets)

    def host_batches(self, stage: str, epoch: int = 0) -> Iterator[HostBatch]:
        """Numpy batches of ``stage`` (``"train"``: epoch ``epoch``'s, as
        ``train_batches`` makes them; else validation's) for consumers that
        work on the host (the rollout GIFs; JAX ``data/pipeline.py:666-680``)."""
        self._require_setup()
        if stage == "train":
            rng, groups = self._train_groups(epoch)
        else:
            rng = np.random.default_rng((self.cfg.seed, _VAL_STREAM))
            groups = self._batched_indices(self._split[1], self.val_batch_size)
        return (self._make_batch(g, rng, train=stage == "train") for g in groups)


def _episode_paths(data_dir: Path) -> list[Path]:
    """The ``.npz`` episodes of ``data_dir``; reference triplets there are
    converted once into ``converted_episodes/``, whose ``_converted_ok.json``
    marker keeps a partial conversion from passing for the data set
    (reference prepare_data, ``dataset.py:264-315``)."""
    paths = ep.list_episodes(data_dir)
    if not paths and _is_reference_pt_layout(data_dir):
        converted = data_dir / "converted_episodes"
        marker = converted / "_converted_ok.json"
        if not marker.exists():
            if ep.list_episodes(converted):
                print(f"incomplete earlier conversion in {converted}; reconverting")
            n = ep.convert_reference_processed_dir(data_dir, converted)
            marker.write_text(json.dumps({"n_episodes": n}))
            print(f"converted {n} reference-format episodes into {converted}")
        paths = ep.list_episodes(converted)
    if not paths:
        raise FileNotFoundError(
            f"no episodes under {data_dir}; generate some with multimodal_mtrssm_tpu_torch.data."
            "generate_synthetic_audio_mnist, convert them with data.episodes."
            "convert_audio_mnist_npz or convert_reference_processed_dir, or pack them with "
            "data.pack.pack_episodes")
    return paths


def _gather_threads(elements: int) -> int:
    """Threads for a native gather with noise of ``elements`` floats: one a
    ``NOISE_GRAIN`` (rounded up), at most the cores. The library starts its
    threads anew each call (~0.25 ms each on an H100's host), so a gather
    without noise, a copy, takes one; the bits do not depend on it."""
    return max(1, min(os.cpu_count() or 1, -(-elements // NOISE_GRAIN)))


def _with_rows(kind: str, batch: Batch, rows: RowsFn | None, n: int) -> tuple:
    """The item ``(kind, batch)``, or with ``rows`` its rows ``rows(n)`` of
    each batch of ``n`` and ``(lo, hi, n)``."""
    if rows is None:
        return kind, batch
    lo, hi = rows(n)
    return kind, tuple(x[:, lo:hi].contiguous() if kind == "scan" else x[lo:hi]
                       for x in batch), (lo, hi, n)


def _cpu_items(items: Iterator[tuple], rows: RowsFn | None) -> Iterator[Item]:
    """The prefetched host items as CPU tensors (no copy)."""
    for kind, lead, (_, host) in items:
        yield _with_rows(kind, tuple(torch.from_numpy(x) for x in host), rows, lead[-1])


class _Raise:
    """A worker thread's exception, carried to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _prefetch_iter(items: Iterator, depth: int = 2) -> Iterator:
    """``items`` run on a daemon thread, ``depth`` ahead (JAX
    ``data/pipeline.py:707-752``). The worker's exception is raised on the
    consumer, after the items before it; closing the consumer early stops
    the worker, instead of leaving it blocked on a full queue, and joins
    it (after the item it is assembling, if any)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker() -> None:
        try:
            for item in items:
                if not put(item):
                    return
        except BaseException as exc:  # noqa: BLE001 — raised on the consumer
            put(_Raise(exc))
        finally:
            put(done)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, _Raise):
                raise item.exc
            yield item
    finally:
        stop.set()
        thread.join()
