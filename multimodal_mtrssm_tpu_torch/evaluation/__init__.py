"""Evaluation (port of ``multimodal_mtrssm_tpu.evaluation``): the MNIST
digit classifier and the word-transition Matching Rate. The cross-modal
reconstruction report (``evaluation/crossmodal.py``) waits for the rollout
visualisation it is built on (ROADMAP queue 1 item 9)."""

from multimodal_mtrssm_tpu_torch.evaluation.classifier import (
    MNISTClassifier,
    classifier_logits,
    load_classifier,
    load_mnist_arrays,
    load_or_train_classifier,
    recognize_digit,
    recognize_digits,
    save_classifier,
    train_classifier,
)
from multimodal_mtrssm_tpu_torch.evaluation.word_transitions import (
    CONDITIONS,
    WORD_SET,
    compute_baselines,
    compute_matching_rate,
    compute_prediction_distribution,
    compute_true_distribution,
    evaluate_word_transitions,
    generate_predictions_batched,
    load_test_data_with_labels,
    predict_word,
    select_intervals_for_word,
    write_results,
)

__all__ = [
    "CONDITIONS",
    "MNISTClassifier",
    "WORD_SET",
    "classifier_logits",
    "compute_baselines",
    "compute_matching_rate",
    "compute_prediction_distribution",
    "compute_true_distribution",
    "evaluate_word_transitions",
    "generate_predictions_batched",
    "load_classifier",
    "load_mnist_arrays",
    "load_or_train_classifier",
    "load_test_data_with_labels",
    "predict_word",
    "recognize_digit",
    "recognize_digits",
    "save_classifier",
    "select_intervals_for_word",
    "train_classifier",
    "write_results",
]
