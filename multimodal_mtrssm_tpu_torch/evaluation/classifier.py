"""MNIST digit classifier for scoring imagination rollouts (port of
``evaluation/classifier.py``).

The reference's ``SimpleMNISTClassifier``: conv 1→32 (3×3, pad 1) → ReLU →
maxpool 2, conv 32→64 → ReLU → maxpool 2, fc 4096→128 (flattened in CHW
order) → ReLU → dropout 0.5 → fc 128→10, trained with Adam 1e-3 on 32×32
digits in [0, 1]. Frames are NHWC ``[N, 32, 32, 1]``, as the decoders
give them.

The checkpoint is the JAX package's ``.npz`` layout (``conv1/w`` HWIO,
``fc1/w`` [in, out], ..., ``/``-joined keys), so one classifier file
serves both packages. ``load_mnist_arrays`` reads a local MNIST copy
(idx files or an ``.npz``) and resizes it 28→32 as JAX does; there is no
download.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodal_mtrssm_tpu_torch.utils import require_device


class MNISTClassifier(nn.Module):
    """The two-conv MNIST classifier (reference ``mnist_classifier.py:9-38``)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 32, 3, padding=1)
        self.conv2 = nn.Conv2d(32, 64, 3, padding=1)
        self.fc1 = nn.Linear(64 * 8 * 8, 128)
        self.fc2 = nn.Linear(128, 10)
        self.dropout = nn.Dropout(0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Logits ``[N, 10]`` for NHWC images ``[N, 32, 32, 1]``."""
        x = x.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.conv1(x)), 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2)
        x = self.dropout(F.relu(self.fc1(x.flatten(1))))  # NCHW flattens in CHW order
        return self.fc2(x)


def train_classifier(images: np.ndarray, labels: np.ndarray, *, num_epochs: int = 5,
                     batch_size: int = 128, learning_rate: float = 1e-3, seed: int = 0,
                     device: torch.device | str = "cuda") -> MNISTClassifier:
    """Train on ``[N, 32, 32, 1]`` float images in [0, 1] (reference
    ``:41-101``: Adam 1e-3, cross-entropy). The batch is clamped to the
    dataset, and the ragged tail is left out, as JAX does."""
    device = require_device(device, "the classifier")
    # The init and the dropout masks draw from torch's global generators:
    # seeded here, and the caller's restored after.
    with torch.random.fork_rng(devices=[device] if device.type == "cuda" else []):
        torch.manual_seed(seed)
        model = MNISTClassifier().to(device)
        opt = torch.optim.Adam(model.parameters(), lr=learning_rate)
        n = len(images)
        rng = np.random.default_rng(seed)
        batch_size = min(batch_size, n)
        x_all = torch.as_tensor(np.asarray(images, np.float32), device=device)
        y_all = torch.as_tensor(np.asarray(labels, np.int64), device=device)
        model.train()
        for _ in range(num_epochs):
            perm = rng.permutation(n)
            for i in range(max(n // batch_size, 1)):
                idx = torch.as_tensor(perm[i * batch_size:(i + 1) * batch_size], device=device)
                if len(idx) < batch_size:
                    continue
                loss = F.cross_entropy(model(x_all[idx]), y_all[idx])
                opt.zero_grad()
                loss.backward()
                opt.step()
    return model.eval()


@torch.no_grad()
def classifier_logits(classifier: MNISTClassifier, images: torch.Tensor) -> torch.Tensor:
    """Inference logits of ``[N, 32, 32, 1]`` images, clamped to [0, 1]."""
    classifier.eval()
    return classifier(images.clamp(0.0, 1.0))


def recognize_digits(classifier: MNISTClassifier, images: torch.Tensor) -> torch.Tensor:
    """Argmax digits ``[N]`` of ``[N, 32, 32, 1]`` images in [0, 1] (all
    frames in one call; the reference classifies one at a time)."""
    return classifier_logits(classifier, images).argmax(-1)


def recognize_digit(classifier: MNISTClassifier, image: np.ndarray) -> int:
    """One image, with the reference's shape guards: (32, 32), (1, 32, 32)
    or (32, 32, 1)."""
    img = np.asarray(image, dtype=np.float32)
    if img.ndim == 3 and img.shape[0] == 1:  # CHW
        img = img[0]
    if img.ndim == 3 and img.shape[-1] == 1:  # HWC
        img = img[..., 0]
    if img.shape != (32, 32):
        raise ValueError(f"expected 32x32 image, got {img.shape}")
    device = next(classifier.parameters()).device
    return int(recognize_digits(classifier, torch.as_tensor(img, device=device)[None, :, :, None])[0])


# ---- persistence: the JAX package's .npz layout -----------------------------------------


def _npz_path(path: str | Path) -> Path:
    """``np.savez`` appends ``.npz`` to any other suffix: the name on disk."""
    p = Path(path)
    return p if p.suffix == ".npz" else p.with_suffix(p.suffix + ".npz")


def save_classifier(classifier: MNISTClassifier, path: str | Path) -> Path:
    """Write the weights in the JAX ``.npz`` layout (conv weights HWIO,
    dense weights [in, out])."""
    arrays = {}
    for name in ("conv1", "conv2"):
        conv = getattr(classifier, name)
        arrays[f"{name}/w"] = conv.weight.detach().cpu().permute(2, 3, 1, 0).numpy()
        arrays[f"{name}/b"] = conv.bias.detach().cpu().numpy()
    for name in ("fc1", "fc2"):
        fc = getattr(classifier, name)
        arrays[f"{name}/w"] = fc.weight.detach().cpu().T.numpy()
        arrays[f"{name}/b"] = fc.bias.detach().cpu().numpy()
    path = _npz_path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **arrays)
    return path


def load_classifier(path: str | Path, device: torch.device | str = "cuda") -> MNISTClassifier:
    """A classifier with the weights of a JAX-layout ``.npz`` (either
    package's ``save_classifier``), on ``device``."""
    model = MNISTClassifier()
    with np.load(path) as z:
        state = {}
        for name in ("conv1", "conv2"):
            state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(
                np.transpose(z[f"{name}/w"], (3, 2, 0, 1))))
            state[f"{name}.bias"] = torch.from_numpy(np.array(z[f"{name}/b"]))
        for name in ("fc1", "fc2"):
            state[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(z[f"{name}/w"].T))
            state[f"{name}.bias"] = torch.from_numpy(np.array(z[f"{name}/b"]))
    model.load_state_dict({k: v.float() for k, v in state.items()}, strict=True)
    return model.to(require_device(device, "the classifier")).eval()


def load_or_train_classifier(ckpt_path: str | Path, mnist_root: str | Path | None = None,
                             device: torch.device | str = "cuda",
                             **train_kwargs: object) -> MNISTClassifier:
    """Load ``ckpt_path`` if present; else train on a local MNIST copy and save."""
    ckpt_path = _npz_path(ckpt_path)
    if ckpt_path.exists():
        return load_classifier(ckpt_path, device)
    if mnist_root is None:
        raise FileNotFoundError(
            f"no classifier checkpoint at {ckpt_path} and no --mnist-root given "
            "(provide a local MNIST copy; nothing is downloaded)")
    images, labels = load_mnist_arrays(mnist_root)
    classifier = train_classifier(images, labels, device=device, **train_kwargs)
    save_classifier(classifier, ckpt_path)
    return classifier


# ---- MNIST loading (local only) -----------------------------------------------------------


def load_mnist_arrays(root: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """MNIST train images ``[N, 32, 32, 1]`` in [0, 1] and labels, from a
    local copy: a directory of idx files (``train-images-idx3-ubyte[.gz]``,
    also under ``MNIST/raw`` or ``raw``) or an ``.npz`` with ``images`` and
    ``labels``. 28×28 digits are resized to 32×32 (:func:`_resize_28_to_32`)."""
    root = Path(root)
    if root.suffix == ".npz":
        with np.load(root) as z:
            images, labels = z["images"], z["labels"]
    else:
        candidates = [root, root / "MNIST" / "raw", root / "raw"]
        base = next((c for c in candidates if list(c.glob("train-images-idx3-ubyte*"))), None)
        if base is None:
            raise FileNotFoundError(f"no MNIST idx files under {root}")
        images = _read_idx(next(iter(base.glob("train-images-idx3-ubyte*"))))
        labels = _read_idx(next(iter(base.glob("train-labels-idx1-ubyte*"))))
    images = images.astype(np.float32) / 255.0
    if images.shape[-1] != 32:
        images = _resize_28_to_32(images)
    return images[..., None], labels.astype(np.int32)


def _read_idx(path: Path) -> np.ndarray:
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">H", f.read(4)[2:])
        ndim = magic & 0xFF
        dims = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)


def _resize_28_to_32(images: np.ndarray) -> np.ndarray:
    """Bilinear 28×28 → 32×32 (the reference's ``transforms.Resize((32,
    32))``, PIL bilinear): the scored frames' digits fill a 32×32 frame, so
    the classifier learns full-scale digits."""
    n, h, w = images.shape
    ys = (np.arange(32) + 0.5) * (h / 32.0) - 0.5
    xs = (np.arange(32) + 0.5) * (w / 32.0) - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
    y1 = np.clip(y0 + 1, 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
    x1 = np.clip(x0 + 1, 0, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[None, :, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, None, :]
    top = images[:, y0][:, :, x0] * (1 - wx) + images[:, y0][:, :, x1] * wx
    bot = images[:, y1][:, :, x0] * (1 - wx) + images[:, y1][:, :, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(images.dtype)
