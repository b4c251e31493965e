"""The ``evaluate-word-transitions`` command (port of ``evaluation/cli.py``):
a run's checkpoint, a classifier and labeled test episodes in, the mean
Matching Rate printed and the results written as ``.md`` and ``.json``.
It runs on the card unless ``--device cpu`` is given. ``main`` also takes
an ``Experiment`` built without PyYAML (``train.config.make_experiment``),
which then stands in for ``--config``.
"""

from __future__ import annotations

import argparse


def main(argv: list[str] | None = None, experiment=None) -> dict:
    """Parse ``argv`` (the command line when None), load the model (of
    ``--config``, or ``experiment``) and its checkpoint, evaluate, write
    the results; returns the results dict."""
    ap = argparse.ArgumentParser(prog="evaluate-word-transitions")
    ap.add_argument("--config", required=experiment is None)
    ap.add_argument("--checkpoint", required=True,
                    help="checkpoint dir (uses 'best', falls back to 'last')")
    ap.add_argument("--test-data", required=True,
                    help="dir of labeled .npz test episodes, or of reference-processed "
                         "act_/audio_obs_/vision_obs_*.pt episodes")
    ap.add_argument("--use-pt-files", action="store_true", default=None,
                    help="force the .pt layout (auto-detected by default)")
    ap.add_argument("--npz-dir-for-labels", default=None,
                    help="dir of sample_*.npz label files (required with .pt episodes)")
    ap.add_argument("--classifier", default="ckpts/mnist_classifier.npz")
    ap.add_argument("--mnist-root", default=None)
    ap.add_argument("--out", default="evaluation_results")
    ap.add_argument("--n-intervals", type=int, default=6)
    ap.add_argument("--query-length", type=int, default=30)
    ap.add_argument("--n-predictions", type=int, default=10)
    ap.add_argument("--n-frames", type=int, default=10)
    ap.add_argument("--classify-frame", type=int, default=0,
                    help="which imagined frame the classifier scores; 0 = the reference's "
                         "(under its same-frame training alignment a re-prediction of the "
                         "conditioning frame), 1 = the one-word-ahead prediction")
    ap.add_argument("--condition", choices=("both", "vision", "audio"), default="both",
                    help="which modality carries information at conditioning time: "
                         "'vision'/'audio' fill the OTHER stream with -1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device to evaluate on: 'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)

    from multimodal_mtrssm_tpu_torch.evaluation.classifier import load_or_train_classifier
    from multimodal_mtrssm_tpu_torch.evaluation.word_transitions import (
        evaluate_word_transitions,
        load_test_data_with_labels,
        write_results,
    )
    from multimodal_mtrssm_tpu_torch.train.checkpoint import CheckpointManager
    from multimodal_mtrssm_tpu_torch.train.config import load_experiment
    from multimodal_mtrssm_tpu_torch.utils import require_device

    device = require_device(args.device, "evaluate-word-transitions", "--device cpu")
    exp = experiment if experiment is not None else load_experiment(args.config)
    ckpt = CheckpointManager(args.checkpoint)
    name = "best" if ckpt.exists("best") else "last"
    if not ckpt.exists(name):
        raise SystemExit(f"no 'best' or 'last' checkpoint under {args.checkpoint}: point "
                         "--checkpoint at a run's checkpoints directory")
    # A full 'last' (a run preempted before any validation) gives its weights.
    ckpt.restore_params(name, exp.model)
    model = exp.model.to(device).eval()
    print(f"loaded {name} checkpoint from {args.checkpoint}")
    classifier = load_or_train_classifier(args.classifier, args.mnist_root, device=device)
    test_data = load_test_data_with_labels(args.test_data, use_pt_files=args.use_pt_files,
                                           npz_dir_for_labels=args.npz_dir_for_labels)
    print(f"{len(test_data)} labeled test episodes")
    results = evaluate_word_transitions(
        model, classifier, test_data, n_intervals=args.n_intervals,
        query_length=args.query_length, n_predictions=args.n_predictions,
        n_frames=args.n_frames, audio_min=exp.data.audio_min, audio_max=exp.data.audio_max,
        classify_frame=args.classify_frame, seed=args.seed, condition=args.condition)
    suffix = "" if args.condition == "both" else f"_{args.condition}"
    md, js = write_results(results, args.out, name=f"word_transitions{suffix}")
    print(f"mean MR = {results['summary']['mean_matching_rate']:.3f}")
    print(f"wrote {md} and {js}")
    return results


if __name__ == "__main__":
    main()
