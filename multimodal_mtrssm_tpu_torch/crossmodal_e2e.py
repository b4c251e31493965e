"""The cross-modal (missing-modality) inference experiment, end to end (the
port's counterpart of ``scripts/crossmodal_e2e.py``, with its flags and
``summary.json`` keys).

For each seed, on one synthetic labeled Audio-MNIST data set and one MNIST
classifier, three MoPoE-MRSSM variants are trained:

- **standard**: ``configs/mopoe_mrssm.yaml`` (both modalities observed);
- **crossmodal**: ``configs/mopoe_mrssm_crossmodal.yaml`` (audio inputs
  dropped, targets clean, so the ELBO trains audio reconstruction through
  the vision-conditioned posterior);
- **random**: the standard config with ``drop_modality="random"`` (each
  train sample keeps both, drops audio or drops vision): one model for
  either missing modality.

Each variant's best weights are then evaluated under three conditions, the
word-transition Matching Rate with both / vision only / audio only at
conditioning time, scored by the reconstruction report
(``evaluation.crossmodal``), and drawn as one GIF with the audio input
dropped, whose audio row is labelled "(missing)".

Unlike the JAX script, training runs on the port's kernels and streams
batches from the host: JAX turns its fused kernels off (``use_pallas_train=
False``) because a Mosaic compile costs minutes, and sets
``device_resident``, which serves only its K-step chunks. ``--device``
(the card by default) stands in for JAX's ``--platform``.

    python -m multimodal_mtrssm_tpu_torch.crossmodal_e2e --workdir runs/crossmodal \\
        --epochs 100 --seeds 3 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from multimodal_mtrssm_tpu_torch.train.entry import default_config_path

VARIANTS = ("standard", "crossmodal", "random")
CONFIGS = {"standard": "mopoe_mrssm.yaml", "crossmodal": "mopoe_mrssm_crossmodal.yaml",
           "random": "mopoe_mrssm.yaml"}
CONDITIONS = ("both", "vision", "audio")


def train_variant(args, work: Path, seed: int, variant: str, train_dir: Path):
    """Train one variant on ``args.device``; returns its best-weights model."""
    from multimodal_mtrssm_tpu_torch.train.config import load_experiment

    exp = load_experiment(default_config_path(CONFIGS[variant]))
    exp.trainer.max_epochs = args.epochs
    exp.trainer.seed = seed
    exp.trainer.log_dir = str(work / f"run_{variant}")
    exp.data.data_dir = train_dir
    if variant == "random":
        exp.data.drop_modality = "random"
    return fit_best(exp, args.device, f"[seed {seed}][{variant}]")


def fit_best(exp, device: str, tag: str, callbacks=()):
    """Train ``exp`` on ``device`` with ``callbacks``, print its first and
    last epochs' losses after ``tag``, and return the best-weights model."""
    trainer = exp.build_trainer(device=device)
    trainer.callbacks.extend(callbacks)
    out = trainer.fit()
    first, last = out["history"][0], out["history"][-1]
    print(f"{tag} train/loss {first['train/loss']:.1f} -> {last['train/loss']:.1f}; "
          f"val/loss {first['val/loss']:.1f} -> {last['val/loss']:.1f}", flush=True)
    return trainer.load_best_params(trainer.model).eval()


def labeled_frames(test_data: list[dict], every: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """Every ``every``-th labeled vision frame of the episodes as ``[N, 32,
    32, 1]`` floats in [0, 1], and their digits: the classifier's data."""
    imgs, labels = [], []
    for d in test_data:
        for t in range(0, d["image"].shape[0], every):
            if int(d["label"][t]) >= 0:
                imgs.append(d["image"][t, 0] / 255.0)
                labels.append(int(d["label"][t]))
    return np.asarray(imgs, np.float32)[..., None], np.asarray(labels, np.int32)


def run_seed(args, work: Path, seed: int) -> dict:
    """One seed: the data set and classifier, then each variant trained and
    evaluated under every condition."""
    from multimodal_mtrssm_tpu_torch.data import generate_synthetic_labeled_audio_mnist
    from multimodal_mtrssm_tpu_torch.evaluation import (
        build_normalized_batch,
        evaluate_word_transitions,
        load_test_data_with_labels,
        reconstruction_report,
        train_classifier,
        write_results,
    )
    from multimodal_mtrssm_tpu_torch.viz.rollout import log_rollout_gifs

    train_dir, eval_dir = work / "episodes", work / "eval_npz"
    print(f"[seed {seed}] generating synthetic labeled dataset ...", flush=True)
    generate_synthetic_labeled_audio_mnist(train_dir, eval_dir, n_episodes=args.episodes,
                                           frames_per_word=args.frames_per_word, seed=seed,
                                           n_successors=args.n_successors)
    test_data = load_test_data_with_labels(eval_dir)
    clf = train_classifier(*labeled_frames(test_data, every=3), num_epochs=3, device=args.device)

    seed_out: dict = {"seed": seed, "variants": {}}
    for variant in _variants(args):
        model = train_variant(args, work, seed, variant, train_dir)
        v: dict = {"mr": {}, "recon": None}
        for condition in CONDITIONS:
            results = evaluate_word_transitions(
                model, clf, test_data, n_intervals=6, query_length=args.query_length,
                n_predictions=args.n_predictions, n_frames=10, classify_frame=args.classify_frame,
                seed=seed, condition=condition)
            write_results(results, work / f"results_{variant}",
                          name=f"word_transitions_{condition}")
            s = results["summary"]
            v["mr"][condition] = s["mean_matching_rate"]
            print(f"[seed {seed}][{variant}] condition={condition}: mean MR = "
                  f"{s['mean_matching_rate']:.3f} (uniform {s['mean_uniform']:.3f})", flush=True)
            v["uniform"] = s["mean_uniform"]
        v["recon"] = reconstruction_report(model, test_data, seed=seed)
        (work / f"results_{variant}" / "crossmodal_recon.json").write_text(
            json.dumps(v["recon"], indent=2))
        cells = v["recon"]["conditions"]
        print(f"[seed {seed}][{variant}] audio recon MSE: both={cells['both']['posterior/audio']:.4f}"
              f" vision-only={cells['drop_audio']['posterior/audio']:.4f} mean-frame-baseline="
              f"{v['recon']['baselines']['mean_frame/audio']:.4f}", flush=True)
        gif_batch = build_normalized_batch(test_data, n_episodes=3, T=30, drop="audio")
        paths = log_rollout_gifs(model, gif_batch, work / f"results_{variant}", query_length=15,
                                 fps=10.0, seed=seed, indices=(0,))
        print(f"[seed {seed}][{variant}] missing-modality GIF: {paths[0]}", flush=True)
        seed_out["variants"][variant] = v
    return seed_out


def _variants(args) -> list[str]:
    return args.variants.split(",") if args.variants else list(VARIANTS)


def summarize(args, per_seed: list[dict]) -> dict:
    """``summary.json``: the protocol, each seed's results and, per variant,
    the MR of each condition over the seeds and the mean posterior
    reconstruction MSE of each modality in each report cell."""
    summary: dict = {
        "protocol": {k: getattr(args, k) for k in
                     ("epochs", "episodes", "frames_per_word", "query_length", "classify_frame",
                      "n_successors", "n_predictions", "seeds")},
        "per_seed": per_seed, "aggregate": {}}
    for variant in _variants(args):
        agg: dict = {}
        for condition in CONDITIONS:
            mrs = [s["variants"][variant]["mr"][condition] for s in per_seed]
            agg[f"mr_{condition}"] = {"mean": float(np.mean(mrs)), "std": float(np.std(mrs)),
                                      "per_seed": mrs}
        for cell in ("both", "drop_audio", "drop_vision"):
            for mod in ("audio", "vision"):
                vals = [s["variants"][variant]["recon"]["conditions"][cell][f"posterior/{mod}"]
                        for s in per_seed]
                agg[f"recon_{cell}_{mod}"] = float(np.mean(vals))
        summary["aggregate"][variant] = agg
    return summary


def main(argv: list[str] | None = None) -> dict:
    """Run the experiment; writes ``--workdir/summary.json`` (or
    ``summary_seeds<a>-<b>.json`` when ``--seed-start`` is not 0, so an
    extension cannot overwrite a full sweep's) and returns it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--episodes", type=int, default=96)
    ap.add_argument("--frames-per-word", type=int, default=1)
    ap.add_argument("--query-length", type=int, default=1)
    ap.add_argument("--classify-frame", type=int, default=1)
    ap.add_argument("--n-successors", type=int, default=2)
    ap.add_argument("--n-predictions", type=int, default=10)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--variants", default=None,
                    help="comma-separated subset of standard,crossmodal,random (default: all)")
    ap.add_argument("--seed-start", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to train and evaluate on: 'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    work = Path(args.workdir)
    per_seed = [run_seed(args, work / f"seed{seed}", seed)
                for seed in range(args.seed_start, args.seed_start + args.seeds)]
    summary = summarize(args, per_seed)
    name = ("summary.json" if args.seed_start == 0 else
            f"summary_seeds{args.seed_start}-{args.seed_start + args.seeds - 1}.json")
    work.mkdir(parents=True, exist_ok=True)
    (work / name).write_text(json.dumps(summary, indent=2))
    for variant in _variants(args):
        a = summary["aggregate"][variant]
        print(f"\n== {variant} ({args.seeds} seeds) ==", flush=True)
        for condition in CONDITIONS:
            m = a[f"mr_{condition}"]
            print(f"  MR[{condition:6s}] = {m['mean']:.3f} ± {m['std']:.3f} "
                  f"{[round(x, 3) for x in m['per_seed']]}", flush=True)
        print(f"  audio recon MSE: both={a['recon_both_audio']:.4f} "
              f"vision-only={a['recon_drop_audio_audio']:.4f}", flush=True)
        print(f"  vision recon MSE: both={a['recon_both_vision']:.4f} "
              f"audio-only={a['recon_drop_vision_vision']:.4f}", flush=True)
    return summary


if __name__ == "__main__":
    main()
