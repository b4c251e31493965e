"""What one imagination step from an initial state predicts (the port's
counterpart of ``scripts/probe_transitions.py``, with its flags and
``probe.json`` keys): the diagnostic behind the learning demonstration.

It trains ``configs/mopoe_<model>.yaml`` on synthetic episodes of 1-frame
words, trains the MNIST classifier on every labeled frame, then for each
digit d conditions an initial state on a frame of d, imagines 3 frames
64 times and classifies them: the mass of imagined frames 1-3 on d
("self"), on the data graph's successors of d, and the three commonest
digits. Under the reference's same-frame training alignment, frame 1
re-predicts the conditioning frame and frame 2 is the one-word-ahead
prediction (``BASELINE.md``: 0.68 self at frame 1, 0.52 successors at
frame 2, JAX). Training runs on the port's kernels; ``--device`` picks
the device (the card by default). A digit's initial-state noise comes
from a CPU generator seeded with ``fold(42, d)``, its rollout's Philox
noise from the same integer (JAX splits ``fold_in(PRNGKey(42), d)``).

    python -m multimodal_mtrssm_tpu_torch.probe_transitions --workdir runs/probe \\
        [--epochs 60] [--model mmtrssm] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from multimodal_mtrssm_tpu_torch.crossmodal_e2e import fit_best, labeled_frames
from multimodal_mtrssm_tpu_torch.train.entry import default_config_path

SAMPLES, FRAMES = 64, 3
# The synthetic word graph's successor offsets (data/episodes.py).
OFFSETS = (1, 3, 5, 7, 9)


def build_parser() -> argparse.ArgumentParser:
    """The JAX script's flags and defaults, and ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--episodes", type=int, default=96)
    ap.add_argument("--n-successors", type=int, default=2)
    ap.add_argument("--model", choices=("mrssm", "mmtrssm"), default="mrssm")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to train and probe on: 'cuda' (the default) or 'cpu'")
    return ap


@torch.no_grad()
def probe_digit(model, clf, frame: tuple[np.ndarray, np.ndarray, np.ndarray], d: int,
                successors: tuple[int, ...]) -> dict:
    """Frames 1-3 imagined :data:`SAMPLES` times from one initial state on
    ``frame`` (audio, image, speaker action) of digit ``d``: each frame's
    mass on ``d``, on ``successors`` and its three commonest digits."""
    from multimodal_mtrssm_tpu_torch.data.transforms import (
        NormalizeAudioMelSpectrogram,
        NormalizeVisionImage,
    )
    from multimodal_mtrssm_tpu_torch.evaluation import recognize_digits
    from multimodal_mtrssm_tpu_torch.evaluation.word_transitions import _repeat_rows
    from multimodal_mtrssm_tpu_torch.models.mrssm import draw_gumbels
    from multimodal_mtrssm_tpu_torch.train.steps import fold

    device = next(model.parameters()).device
    audio0 = NormalizeAudioMelSpectrogram(-80.0, 0.0)(frame[0][None, ..., None])
    vision0 = NormalizeVisionImage()(np.moveaxis(frame[1], 0, -1)[None])
    seed = fold(42, d)
    shapes = {k: s for k, s in model.noise_shapes(1, 1).items() if k.startswith("g_init")}
    noise = draw_gumbels(shapes, torch.Generator().manual_seed(seed), None)
    init = model.initial_state(torch.as_tensor(audio0, device=device),
                               torch.as_tensor(vision0, device=device),
                               *(g.to(device) for g in noise.values()))
    action = torch.as_tensor(frame[2], dtype=torch.float32, device=device)
    actions = action.expand(SAMPLES, FRAMES, action.shape[-1]).contiguous()
    states = model.rollout_transition(actions, _repeat_rows(init, SAMPLES), seed)
    recon = model.decode_state(states)["recon/vision"]
    frames = ((recon + 1.0) / 2.0).clamp(0.0, 1.0)  # [P, F, H, W, C]
    row = {}
    for f in range(FRAMES):
        c = Counter(int(x) for x in recognize_digits(clf, frames[:, f]).cpu())
        row[f"frame{f + 1}"] = {"self": c.get(d, 0) / SAMPLES,
                                "successors": sum(c.get(s, 0) for s in successors) / SAMPLES,
                                "top": c.most_common(3)}
    return row


def main(argv: list[str] | None = None) -> dict:
    """Train, probe every digit, write ``--workdir/probe.json``; returns its
    payload."""
    from multimodal_mtrssm_tpu_torch.data import generate_synthetic_labeled_audio_mnist
    from multimodal_mtrssm_tpu_torch.evaluation import (
        load_test_data_with_labels,
        recognize_digits,
        save_classifier,
        train_classifier,
    )
    from multimodal_mtrssm_tpu_torch.train.config import load_experiment

    args = build_parser().parse_args(argv)
    work = Path(args.workdir)
    train_dir, eval_dir = work / "episodes", work / "eval_npz"
    generate_synthetic_labeled_audio_mnist(train_dir, eval_dir, n_episodes=args.episodes,
                                           frames_per_word=1, n_successors=args.n_successors,
                                           seed=args.seed)
    exp = load_experiment(default_config_path(f"mopoe_{args.model}.yaml"))
    exp.trainer.max_epochs = args.epochs
    exp.trainer.log_dir = str(work / "run")
    exp.data.data_dir = train_dir
    model = fit_best(exp, args.device, "[probe]")

    test_data = load_test_data_with_labels(eval_dir)
    imgs, labels = labeled_frames(test_data)
    clf = train_classifier(imgs, labels, num_epochs=3, device=args.device)
    save_classifier(clf, work / "classifier.npz")
    digits = recognize_digits(clf, torch.as_tensor(imgs[:500], device=next(
        clf.parameters()).device)).cpu().numpy()
    print(f"classifier acc: {float((digits == labels[:500]).mean()):.3f}", flush=True)

    successors = {d: tuple((d + off) % 10 for off in OFFSETS[:args.n_successors])
                  for d in range(10)}
    report = {}
    for d in range(10):
        frame = None
        for ep in test_data:
            pos = np.where(ep["label"] == d)[0]
            if len(pos):
                t = int(pos[0])
                frame = (ep["audio"][t], ep["image"][t], ep["speaker"][t])
                break
        if frame is None:
            continue
        report[d] = row = probe_digit(model, clf, frame, d, successors[d])
        print(f"d={d} succ={successors[d]} " + " | ".join(
            f"f{f + 1}: self={row[f'frame{f + 1}']['self']:.2f} "
            f"succ={row[f'frame{f + 1}']['successors']:.2f}" for f in range(FRAMES)), flush=True)
    means = {f"frame{f + 1}": {k: float(np.mean([report[d][f"frame{f + 1}"][k] for d in report]))
                               for k in ("self", "successors")}
             for f in range(FRAMES)}
    print("MEANS:", json.dumps(means), flush=True)
    payload = {"means": means, "per_digit": {str(k): v for k, v in report.items()}}
    (work / "probe.json").write_text(json.dumps(payload, default=str))
    return payload


if __name__ == "__main__":
    main()
