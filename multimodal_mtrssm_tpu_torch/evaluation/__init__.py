"""Evaluation (port of ``multimodal_mtrssm_tpu.evaluation``): the MNIST
digit classifier, the word-transition Matching Rate (with one modality's
conditioning frame dropped, ``condition``) and the cross-modal
reconstruction report (``evaluation/crossmodal.py``)."""

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
from multimodal_mtrssm_tpu_torch.evaluation.crossmodal import (
    build_normalized_batch,
    reconstruction_report,
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
    generate_predictions_with_classifier,
    load_test_data_with_labels,
    predict_word,
    select_intervals_for_word,
    write_results,
)

__all__ = [
    "CONDITIONS",
    "MNISTClassifier",
    "WORD_SET",
    "build_normalized_batch",
    "classifier_logits",
    "compute_baselines",
    "compute_matching_rate",
    "compute_prediction_distribution",
    "compute_true_distribution",
    "evaluate_word_transitions",
    "generate_predictions_batched",
    "generate_predictions_with_classifier",
    "load_classifier",
    "load_mnist_arrays",
    "load_or_train_classifier",
    "load_test_data_with_labels",
    "predict_word",
    "reconstruction_report",
    "recognize_digit",
    "recognize_digits",
    "save_classifier",
    "select_intervals_for_word",
    "train_classifier",
    "write_results",
]
