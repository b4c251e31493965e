"""PyTorch/CUDA port of ``multimodal_mtrssm_tpu``.

The JAX package beside this one is the reference: every module here mirrors
the module of the same name there, and the CPU tests hold each one to its
JAX counterpart on the same weights, inputs and noise. This package imports
``torch`` and never ``jax``.

Ported so far: MoPoE-MRSSM serving (observe → imagine → decode,
``serving.WorldModel`` and ``server.InferenceServer``) and training
(``train.Trainer`` on ``data.EpisodeDataModule``: the ELBO, AdamW,
checkpoints), with hand-written CUDA kernels for the representation
recurrence (forward and BPTT backward) and the imagination rollout
(``ops/kernels``, sources in ``csrc/``).
"""
