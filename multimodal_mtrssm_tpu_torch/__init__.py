"""PyTorch/CUDA port of ``multimodal_mtrssm_tpu``.

The JAX package beside this one is the reference: every module here mirrors
the module of the same name there, and the CPU tests hold each one to its
JAX counterpart on the same weights, inputs and noise. This package imports
``torch`` and never ``jax``.

Ported so far, for MoPoE-MRSSM and MoPoE-MMTRSSM: serving (observe →
imagine → decode, ``serving.WorldModel`` and ``server.InferenceServer``,
with request coalescing exact per request; ``python -m
multimodal_mtrssm_tpu_torch serve``), the YAML configs
(``train.config.load_experiment``), training (``train.Trainer`` on
``data.EpisodeDataModule``: the ELBO, AdamW, checkpoints, exact resume,
preemption, accumulation, K-step chunks; ``train-mopoe-mrssm``,
``train-mopoe-mmtrssm``; data parallel on ``torch.distributed``,
``parallel`` and ``dryrun``, launched by ``torchrun``) and the
word-transition evaluation
(``evaluation``; ``evaluate-word-transitions``), with
hand-written CUDA kernels for the representation recurrences (forward and
BPTT backward), the imagination rollouts and the fused conv stacks
(``ops/kernels``, sources in ``csrc/``).
"""
