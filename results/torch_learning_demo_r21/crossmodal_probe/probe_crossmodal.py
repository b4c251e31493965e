"""Probe of the cross-modal experiment's crossmodal variant at one seed:
trains it as ``crossmodal_e2e`` does (100 epochs on 96 episodes of 1-frame
words, on the card), then, as ``probe_transitions`` does, where imagined
frames 1-3 land after conditioning on each digit's vision frame (audio at
the ZeroOut fill, -80 dB before normalisation) and on both frames. Prints
one ``PROBE <seed> <json>`` line.

    PYTHONPATH=. python3 results/torch_learning_demo_r21/crossmodal_probe/probe_crossmodal.py \
        --seed 6 --work /tmp/cmp6
"""
import argparse
import json
from pathlib import Path

import numpy as np

from multimodal_mtrssm_tpu_torch import crossmodal_e2e, probe_transitions
from multimodal_mtrssm_tpu_torch.data import generate_synthetic_labeled_audio_mnist
from multimodal_mtrssm_tpu_torch.evaluation import load_test_data_with_labels, train_classifier

ap = argparse.ArgumentParser()
ap.add_argument("--seed", type=int)
ap.add_argument("--work")
a = ap.parse_args()
work = Path(a.work)
args = argparse.Namespace(epochs=100, device="cuda")
generate_synthetic_labeled_audio_mnist(work / "episodes", work / "eval_npz", n_episodes=96,
                                       frames_per_word=1, seed=a.seed, n_successors=2)
model = crossmodal_e2e.train_variant(args, work, a.seed, "crossmodal", work / "episodes")
test_data = load_test_data_with_labels(work / "eval_npz")
clf = train_classifier(*crossmodal_e2e.labeled_frames(test_data), num_epochs=3, device="cuda")
succ = {d: ((d + 1) % 10, (d + 3) % 10) for d in range(10)}
out = {}
for cond in ("vision", "both"):
    rows = {}
    for d in range(10):
        for ep in test_data:
            pos = np.where(ep["label"] == d)[0]
            if len(pos):
                t = int(pos[0])
                audio = ep["audio"][t] if cond == "both" else np.full_like(ep["audio"][t], -80.0)
                rows[d] = probe_transitions.probe_digit(model, clf, (audio, ep["image"][t],
                                                                     ep["speaker"][t]), d, succ[d])
                break
    out[cond] = {f"frame{f}": {k: float(np.mean([rows[d][f"frame{f}"][k] for d in rows]))
                               for k in ("self", "successors")} for f in (1, 2, 3)}
    out[cond + "_top"] = {d: rows[d]["frame1"]["top"] for d in rows}
print("PROBE", a.seed, json.dumps(out))
