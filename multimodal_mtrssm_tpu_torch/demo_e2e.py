"""The learning demonstration, end to end (the port's counterpart of
``scripts/demo_e2e.py``, with its flags, defaults and ``summary.json``
keys): synthetic labeled Audio-MNIST episodes → train → the digit
classifier → the word-transition Matching Rate, for each seed.

Each seed generates its data set, trains ``configs/mopoe_<model>.yaml``
with the rollout-GIF callback, trains the MNIST classifier on every third
labeled frame, evaluates the best weights (6 intervals, 10 frames) and
writes ``results/word_transitions.{md,json}``. With more than one seed, or
a ``--seed-start`` other than 0, each seed has its own ``seed<i>/``, and
``summary.json`` (``summary_seeds<a>-<b>.json`` for an extension run)
holds the mean and spread of the seeds' mean MR.

The decisive configuration (``BASELINE.md``, "learning demonstration"):
``--frames-per-word 1 --query-length 1 --classify-frame 1 --epochs 100
--episodes 96 --seeds 5``. Unlike the JAX script, training runs on the
port's kernels (JAX turns its fused kernel off to save a Mosaic compile)
from host batches, so ``--no-device-resident`` is accepted and changes
nothing; ``--device`` (the card by default) stands in for ``--platform``.
``--seq-len`` beyond 60 sets ``remat``, as JAX does.

    python -m multimodal_mtrssm_tpu_torch.demo_e2e --workdir runs/demo --epochs 100 \\
        --episodes 96 --frames-per-word 1 --query-length 1 --classify-frame 1 \\
        --seeds 5 [--model mmtrssm] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path

import numpy as np
import torch

from multimodal_mtrssm_tpu_torch.crossmodal_e2e import fit_best, labeled_frames
from multimodal_mtrssm_tpu_torch.train.entry import default_config_path


def model_overrides(cfg, seq_len: int | None, set_model: list[str]) -> dict:
    """The model-config fields that ``--seq-len`` and ``--set-model
    FIELD=VALUE`` change: ``remat`` beyond 60 steps, and each value coerced
    to its field's type (a bool from ``1``/``true``/``True``); an unknown
    field raises ``AttributeError``."""
    over: dict = {}
    if seq_len is not None and seq_len > 60:
        over["remat"] = True
    for item in set_model:
        field, _, raw = item.partition("=")
        cur = getattr(cfg, field)
        over[field] = raw in ("1", "true", "True") if isinstance(cur, bool) else type(cur)(raw)
    return over


def run_once(args, work: Path, seed: int) -> dict:
    """Generate the data, train, evaluate; returns the results dict."""
    from multimodal_mtrssm_tpu_torch.data import generate_synthetic_labeled_audio_mnist
    from multimodal_mtrssm_tpu_torch.evaluation import (
        evaluate_word_transitions,
        load_test_data_with_labels,
        recognize_digits,
        save_classifier,
        train_classifier,
        write_results,
    )
    from multimodal_mtrssm_tpu_torch.train.config import load_experiment
    from multimodal_mtrssm_tpu_torch.viz.callback import make_viz_callback

    train_dir, eval_dir = work / "episodes", work / "eval_npz"
    print(f"[seed {seed}] generating synthetic labeled dataset ...", flush=True)
    generate_synthetic_labeled_audio_mnist(train_dir, eval_dir, n_episodes=args.episodes,
                                           frames_per_word=args.frames_per_word, seed=seed,
                                           n_successors=args.n_successors)
    exp = load_experiment(default_config_path(f"mopoe_{args.model}.yaml"))
    exp.trainer.max_epochs = args.epochs
    exp.trainer.seed = seed
    exp.trainer.log_dir = str(work / "run")
    exp.data.data_dir = train_dir
    if args.seq_len is not None:
        exp.data.sequence_length = args.seq_len
    over = model_overrides(exp.model.cfg, args.seq_len, args.set_model)
    if over:
        exp.model = type(exp.model)(dataclasses.replace(exp.model.cfg, **over))
        print(f"[seed {seed}] model overrides: {over}", flush=True)
    model = fit_best(exp, args.device, f"[seed {seed}]", [make_viz_callback(exp)])

    print(f"[seed {seed}] training digit classifier ...", flush=True)
    test_data = load_test_data_with_labels(eval_dir)
    imgs, labels = labeled_frames(test_data, every=3)
    clf = train_classifier(imgs, labels, num_epochs=3, device=args.device)
    save_classifier(clf, work / "classifier.npz")
    device = next(clf.parameters()).device
    digits = recognize_digits(clf, torch.as_tensor(imgs[:500], device=device)).cpu().numpy()
    acc = float((digits == labels[:500]).mean())
    print(f"[seed {seed}] classifier accuracy on train frames: {acc:.3f}", flush=True)

    print(f"[seed {seed}] running word-transition evaluation ...", flush=True)
    results = evaluate_word_transitions(
        model, clf, test_data, n_intervals=6, query_length=args.query_length,
        n_predictions=args.n_predictions, n_frames=10, classify_frame=args.classify_frame,
        seed=seed)
    md, _ = write_results(results, work / "results")
    s = results["summary"]
    print(f"[seed {seed}] mean MR = {s['mean_matching_rate']:.3f} (uniform "
          f"{s['mean_uniform']:.3f}, peak {s['mean_peak_onehot']:.3f}, random "
          f"{s['mean_random_onehot']:.3f})", flush=True)
    print(f"[seed {seed}] wrote {md}", flush=True)
    return results


def build_parser() -> argparse.ArgumentParser:
    """The JAX script's flags and defaults, ``--device`` for ``--platform``."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--episodes", type=int, default=48)
    ap.add_argument("--frames-per-word", type=int, default=18,
                    help="1 makes every transition a word transition")
    ap.add_argument("--query-length", type=int, default=30,
                    help="1 conditions the initial state on exactly the context word")
    ap.add_argument("--classify-frame", type=int, default=0,
                    help="which imagined frame the classifier scores; 0 = reference parity, "
                    "1 = the one-word-ahead prediction")
    ap.add_argument("--n-successors", type=int, default=2,
                    help="branching factor of the synthetic word graph")
    ap.add_argument("--n-predictions", type=int, default=10)
    ap.add_argument("--seq-len", type=int, default=None,
                    help="override the training sequence length (e.g. 180 = full episodes); "
                    "sets remat beyond 60")
    ap.add_argument("--set-model", action="append", default=[], metavar="FIELD=VALUE",
                    help="override a model-config field (repeatable; the value is coerced to "
                    "the field's type)")
    ap.add_argument("--seeds", type=int, default=1,
                    help="run N seeds (seed-start..seed-start+N-1) and report mean±std of "
                    "mean MR")
    ap.add_argument("--seed-start", type=int, default=0,
                    help="first seed; an extension run writes summary_seeds<a>-<b>.json")
    ap.add_argument("--model", choices=("mrssm", "mmtrssm"), default="mrssm")
    ap.add_argument("--no-device-resident", action="store_true",
                    help="accepted for the JAX script's surface; the port always streams "
                    "host batches")
    ap.add_argument("--device", default="cuda",
                    help="device to train and evaluate on: 'cuda' (the default) or 'cpu'")
    return ap


def summarize(args, mrs: list[float], unis: list[float]) -> dict:
    """``summary.json`` of a multi-seed sweep (JAX's keys)."""
    return {
        "model": args.model,
        "seeds": args.seeds,
        "seed_start": args.seed_start,
        "mean_mr": float(np.mean(mrs)),
        "std_mr": float(np.std(mrs)),
        "per_seed_mr": mrs,
        "mean_uniform": float(np.mean(unis)),
        "config": {k: getattr(args, k) for k in
                   ("epochs", "episodes", "frames_per_word", "query_length", "classify_frame",
                    "n_successors", "n_predictions")},
    }


def main(argv: list[str] | None = None) -> dict | None:
    """Run the sweep; returns the summary (None for one seed, which writes
    none, as JAX)."""
    args = build_parser().parse_args(argv)
    work = Path(args.workdir)
    mrs, unis = [], []
    # Per-seed directories for a sweep and for an extension run, so that
    # an extension cannot overwrite the earlier seeds' runs.
    per_seed_dirs = args.seeds > 1 or args.seed_start != 0
    for seed in range(args.seed_start, args.seed_start + args.seeds):
        results = run_once(args, work / (f"seed{seed}" if per_seed_dirs else "."), seed)
        mrs.append(results["summary"]["mean_matching_rate"])
        unis.append(results["summary"]["mean_uniform"])
    if args.seeds <= 1:
        return None
    summary = summarize(args, mrs, unis)
    name = ("summary.json" if args.seed_start == 0 else
            f"summary_seeds{args.seed_start}-{args.seed_start + args.seeds - 1}.json")
    work.mkdir(parents=True, exist_ok=True)
    (work / name).write_text(json.dumps(summary, indent=2))
    print(f"ACROSS {args.seeds} SEEDS: mean MR = {summary['mean_mr']:.3f} ± "
          f"{summary['std_mr']:.3f} (uniform {summary['mean_uniform']:.3f}); per-seed: "
          f"{[round(m, 3) for m in mrs]}", flush=True)
    return summary


if __name__ == "__main__":
    main()
