"""The port's console commands (JAX ``cli.py``): the two ``train-*``
commands on the shipped configs and ``evaluate-word-transitions``. Each
takes its arguments from ``argv`` (the command line when None)."""

from __future__ import annotations

from multimodal_mtrssm_tpu_torch.train.entry import default_config_path, run_training


def train_mopoe_mrssm(argv: list[str] | None = None) -> None:
    """``train-mopoe-mrssm``: train ``configs/mopoe_mrssm.yaml`` (or ``-c``)."""
    run_training(default_config_path("mopoe_mrssm.yaml"), argv)


def train_mopoe_mmtrssm(argv: list[str] | None = None) -> None:
    """``train-mopoe-mmtrssm``: train ``configs/mopoe_mmtrssm.yaml`` (or ``-c``)."""
    run_training(default_config_path("mopoe_mmtrssm.yaml"), argv)


def evaluate_word_transitions(argv: list[str] | None = None) -> None:
    """``evaluate-word-transitions``: the Matching-Rate evaluation of a run."""
    from multimodal_mtrssm_tpu_torch.evaluation.cli import main

    main(argv)
