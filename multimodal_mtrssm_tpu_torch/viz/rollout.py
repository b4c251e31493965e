"""Rollout visualisation (port of ``viz/rollout.py``): the posterior and
prior reconstructions of a batch on the card, and their 2×3 GIF grids on
the host (rows vision and audio; columns prior, observation, posterior;
reference ``mrssm/callback.py:156-233,689-905``).

:func:`reconstruction_states`: the initial state from frame 0, the
posterior over the whole sequence (one recurrence-kernel launch), and the
prior: ``posterior[:, :q]`` then imagination from ``posterior[:, q-1]``
over ``action[:, q:]`` (one rollout-kernel launch). Its noise is drawn as
the evaluation's is: the initial state's and the recurrence's Gumbel noise
from a CPU ``torch.Generator`` seeded with ``seed``, the rollout's Philox
noise keyed by the same integer (JAX splits one key three ways), so the
card and the CPU sample alike. :func:`compute_reconstructions` decodes
both. The renderer is a numpy copy of JAX's; audio goes through the magma
colormap, carried here as matplotlib's 256-entry table in uint8, so drawing
needs Pillow and nothing else.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from multimodal_mtrssm_tpu_torch.models import WorldModelNet
from multimodal_mtrssm_tpu_torch.models.state import MTState, cat_states

# Episodes drawn per stage (reference callback.py:14,178-210), and each
# frame's pixel scale in the grid.
MAX_EPISODES = 7
SCALE = 3

# matplotlib's "magma" colormap (its 256-entry lookup table), as
# ``(rgba[:, :3] * 255).astype(uint8)``: row i colours values in [i/256, (i+1)/256).
MAGMA = np.frombuffer(bytes.fromhex(
    "00000300000400000601000701010901010b02020d02020f03031104031304041505041706051907051b08061d09071f"
    "0a07220b08240c09260d0a280e0a2a0f0b2c100c2f110c31120d33140d35150e38160e3a170f3c180f3f1a10411b1044"
    "1c10461e10491f114b20114d2211502311522511552611572811592a115c2b115e2d10602f1062301065321067341068"
    "350f6a370f6c390f6e3b0f6f3c0f713e0f72400f73420f74430f75450f76470f774810784a10794b10794d117a4f117b"
    "50127b52127c53137c55137d57147d58157e5a157e5b167e5d177e5e177f60187f61187f63197f651a80661a80681b80"
    "691c806b1c806c1d806e1e816f1e81711f81731f817420817621817721817922817a22817c23817e24817f2481812581"
    "8225818426818526818727818928818a28818c29808d29808f2a80912a80922b80942b80952c80972c7f992d7f9a2d7f"
    "9c2e7f9e2e7e9f2f7ea12f7ea3307ea4307da6317da7317da9327cab337cac337bae347bb0347bb1357ab3357ab53679"
    "b63679b83778b93778bb3877bd3977be3976c03a75c23a75c33b74c53c74c63c73c83d72ca3e72cb3e71cd3f70ce4070"
    "d0416fd1426ed3426dd4436dd6446cd7456bd9466ada4769dc4869dd4968de4a67e04b66e14c66e24d65e44e64e55063"
    "e65162e75262e85461ea5560eb5660ec585fed595fee5b5eee5d5def5e5df0605df1615cf2635cf3655cf3675bf4685b"
    "f56a5bf56c5bf66e5bf6705bf7715bf7735cf8755cf8775cf9795cf97b5df97d5dfa7f5efa805efa825ffb8460fb8660"
    "fb8861fb8a62fc8c63fc8e63fc9064fc9265fc9366fd9567fd9768fd9969fd9b6afd9d6bfd9f6cfda16efda26ffda470"
    "fea671fea873feaa74feac75feae76feaf78feb179feb37bfeb57cfeb77dfeb97ffebb80febc82febe83fec085fec286"
    "fec488fec689fec78bfec98dfecb8efdcd90fdcf92fdd193fdd295fdd497fdd698fdd89afdda9cfddc9dfddd9ffddfa1"
    "fde1a3fce3a5fce5a6fce6a8fce8aafceaacfcecaefceeb0fcf0b1fcf1b3fcf3b5fcf5b7fbf7b9fbf9bbfbfabdfbfcbf"
), dtype=np.uint8).reshape(256, 3)


@torch.no_grad()
def reconstruction_states(model: WorldModelNet, batch: tuple, query_length: int,
                          seed: int) -> dict[str, Any]:
    """The states behind :func:`compute_reconstructions`, on the model's
    device: ``initial``, ``posterior`` and ``prior`` (``[B, T]``; the prior's
    steps from ``q`` on are the rollout's ``imagined`` ones), the Gumbel
    ``noise`` (``model.noise_shapes``' keys), ``q`` and ``seed``. ``batch``
    is a 6-tuple (or its first three) of tensors or arrays; ``q`` is
    ``query_length`` clamped to ``[1, T - 1]``, the floor winning at T=1,
    where the prior is the posterior's first step and nothing is imagined
    (no rollout launch)."""
    device = next(model.parameters()).device
    action, audio, vision = (torch.as_tensor(x, dtype=torch.float32, device=device)
                             for x in batch[:3])
    B, T = action.shape[:2]
    # q < 1 would seed "imagination" from posterior[:, -1], the episode's end.
    q = max(1, min(query_length, T - 1))
    noise = {k: v.to(device) for k, v in model.draw_noise(
        B, T, torch.Generator().manual_seed(int(seed))).items()}
    initial = model.initial_state(audio[:, 0], vision[:, 0],
                                  *(v for k, v in noise.items() if k.startswith("g_init")))
    if isinstance(initial, MTState):
        posterior, _ = model.rollout_representation(action, audio, vision, initial, noise)
    else:
        posterior, _ = model.rollout_representation(action, audio, vision, initial,
                                                    noise["g_prior"], noise["g_post"])
    imagined = (model.rollout_transition(action[:, q:], posterior[:, q - 1], int(seed))
                if q < T else None)
    prior = posterior[:, :q] if imagined is None else cat_states([posterior[:, :q], imagined], 1)
    return {"initial": initial, "posterior": posterior, "prior": prior, "imagined": imagined,
            "noise": noise, "q": q, "seed": int(seed)}


@torch.no_grad()
def decode_reconstructions(model: WorldModelNet, states: dict[str, Any]) -> dict[str, torch.Tensor]:
    """``{posterior, prior}/{audio, vision}`` frames ``[B, T, H, W, C]``
    decoded from :func:`reconstruction_states`' states."""
    post, prior = model.decode_state(states["posterior"]), model.decode_state(states["prior"])
    return {"posterior/audio": post["recon/audio"], "posterior/vision": post["recon/vision"],
            "prior/audio": prior["recon/audio"], "prior/vision": prior["recon/vision"]}


def compute_reconstructions(model: WorldModelNet, batch: tuple, query_length: int,
                            seed: int) -> dict[str, torch.Tensor]:
    """Posterior and prior reconstructions of a batch (reference
    ``mrssm/callback.py:156-233``; JAX's keys): ``{posterior, prior}/{audio,
    vision}`` frames ``[B, T, H, W, C]`` on the model's device."""
    return decode_reconstructions(model, reconstruction_states(model, batch, query_length, seed))


# ---- host-side rendering --------------------------------------------------------------


def _to_uint8_vision(x: np.ndarray) -> np.ndarray:
    """[-1, 1] → uint8 grayscale → RGB."""
    g = np.clip((x + 1.0) / 2.0, 0.0, 1.0)
    g = (g[..., 0] * 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def _to_uint8_audio(x: np.ndarray) -> np.ndarray:
    """[-1, 1] (normalised dB) → magma RGB (reference ``callback.py:426-502``),
    as matplotlib maps it: value g to row ``floor(256 g)`` (1 to the last),
    NaN to black."""
    g = np.clip((x[..., 0] + 1.0) / 2.0, 0.0, 1.0)
    nan = np.isnan(g)
    idx = np.minimum((np.where(nan, 0.0, g) * 256).astype(np.int64), 255)
    return np.where(nan[..., None], np.uint8(0), MAGMA[idx])


def row_labels(observations: dict[str, np.ndarray]) -> list[str]:
    """The grid's row labels: a stream whose input is all -1 (the ZeroOut
    fill) is "(missing)" (reference ``mrssm/callback.py:122-125``)."""
    return [f"{mod}{' (missing)' if np.allclose(np.asarray(observations[mod]), -1.0) else ''}"
            for mod in ("vision", "audio")]


def render_episode_gif(out_path: Path | str, observations: dict[str, np.ndarray],
                       reconstructions: dict[str, np.ndarray], query_length: int,
                       fps: float = 10.0) -> Path:
    """One episode's 2×3 grid GIF, frame t labelled ``t=NNN recon`` before
    ``query_length``, ``imagine`` from there. ``observations``: ``{"audio",
    "vision"}`` ``[T, H, W, C]`` (normalised); ``reconstructions``: the four
    keys of :func:`compute_reconstructions`, one episode's."""
    from PIL import Image, ImageDraw

    T = observations["vision"].shape[0]
    rows = []
    for mod, to_rgb in (("vision", _to_uint8_vision), ("audio", _to_uint8_audio)):
        rows.append(tuple(to_rgb(np.asarray(x)) for x in (
            reconstructions[f"prior/{mod}"], observations[mod],
            reconstructions[f"posterior/{mod}"])))
    labels = row_labels(observations)
    h, w, scale = *rows[0][0].shape[1:3], SCALE
    pad, label_h, side_w = 2, 12, 52
    frame_w = side_w + 3 * (w * scale + pad) + pad
    frame_h = 2 * (h * scale + pad) + pad + 2 * label_h
    frames = []
    for t in range(T):
        canvas = np.zeros((frame_h, frame_w, 3), dtype=np.uint8)
        for r, row in enumerate(rows):
            for c, img in enumerate(x[t] for x in row):
                y0 = 2 * label_h + pad + r * (h * scale + pad)
                x0 = side_w + pad + c * (w * scale + pad)
                canvas[y0:y0 + h * scale, x0:x0 + w * scale] = np.kron(
                    img, np.ones((scale, scale, 1), dtype=np.uint8))
        im = Image.fromarray(canvas)
        draw = ImageDraw.Draw(im)
        draw.text((2, 0), f"t={t:03d} {'recon' if t < query_length else 'imagine'}",
                  fill=(255, 255, 255))
        for c, label in enumerate(("prior", "obs", "posterior")):
            draw.text((side_w + pad + c * (w * scale + pad) + 2, label_h), label,
                      fill=(255, 255, 255))
        for r, label in enumerate(labels):
            draw.text((2, 2 * label_h + pad + r * (h * scale + pad) + 2), label,
                      fill=(255, 255, 255))
        frames.append(im)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)
    return out_path


def _numpy(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def log_rollout_gifs(model: WorldModelNet, batch: tuple, out_dir: Path | str, query_length: int,
                     fps: float, seed: int, indices=(0, 1, 2)) -> list[Path]:
    """``out_dir/episode_i.gif`` for the episodes ``indices`` of a batch
    (at most 7, the reference's cap), from one :func:`compute_reconstructions`."""
    recons = {k: _numpy(v) for k, v in compute_reconstructions(model, batch, query_length,
                                                              seed).items()}
    audio_in, vision_in = _numpy(batch[1]), _numpy(batch[2])
    paths = []
    for i in list(indices)[:MAX_EPISODES]:
        if i >= vision_in.shape[0]:
            continue
        obs = {"audio": audio_in[i], "vision": vision_in[i]}
        paths.append(render_episode_gif(Path(out_dir) / f"episode_{i}.gif", obs,
                                        {k: v[i] for k, v in recons.items()}, query_length, fps))
    return paths
