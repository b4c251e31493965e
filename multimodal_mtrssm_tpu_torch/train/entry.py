"""The training commands (port of ``train/entry.py``): an argparse front end
over ``train.config.load_experiment`` and ``Trainer.fit``.

``run_training(default_config, argv)`` trains the config ``-c/--config``
names, else ``default_config``, with JAX's flags (``--max-epochs``,
``--data-dir``, ``--log-dir``, ``--resume``, ``--synthetic N``) and
``--device`` (the card by default; ``cpu`` to train on the CPU). It also
takes an ``Experiment`` built without PyYAML (``train.config.
make_experiment``), which then stands in for the config file. As JAX's
command does, it attaches the rollout-GIF callback of the experiment's
``VizConfig`` (``viz.callback.make_viz_callback``).

Under ``torchrun`` (``WORLD_SIZE`` in the environment) each process joins
the process group (``parallel.mesh.init_from_env``: NCCL on the card,
``--device cuda`` meaning ``cuda:LOCAL_RANK``; gloo on the CPU), rank 0
writes the ``--synthetic`` episodes and builds the CUDA kernels while the
others wait, and the trainer trains data-parallel::

    torchrun --standalone --nproc_per_node=N -m multimodal_mtrssm_tpu_torch \
        train-mopoe-mrssm -c configs/mopoe_mrssm.yaml
"""

from __future__ import annotations

import argparse
from pathlib import Path

# The repository's configs/ folder (the YAML files both packages read).
_CONFIGS = Path(__file__).resolve().parents[2] / "configs"


def default_config_path(name: str) -> Path:
    """Path of a shipped config, ``configs/<name>`` at the repository's root."""
    return _CONFIGS / name


def run_training(default_config: str | Path, argv: list[str] | None = None,
                 experiment=None) -> dict:
    """Train from ``default_config`` (or ``-c``), or from ``experiment``
    when given; returns ``Trainer.fit``'s result."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-c", "--config", default=str(default_config), help="experiment YAML")
    parser.add_argument("--max-epochs", type=int, default=None)
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--log-dir", default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--synthetic", type=int, metavar="N", default=None,
                        help="generate N synthetic episodes into --data-dir first")
    parser.add_argument("--device", default="cuda",
                        help="device to train on: 'cuda' (the default; cuda:LOCAL_RANK under "
                             "torchrun) or 'cpu'")
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from multimodal_mtrssm_tpu_torch.data import generate_synthetic_audio_mnist
    from multimodal_mtrssm_tpu_torch.parallel.mesh import init_from_env
    from multimodal_mtrssm_tpu_torch.train.config import load_experiment
    from multimodal_mtrssm_tpu_torch.viz.callback import make_viz_callback

    exp = experiment if experiment is not None else load_experiment(args.config)
    if args.max_epochs is not None:
        exp.trainer.max_epochs = args.max_epochs
    if args.data_dir is not None:
        exp.data.data_dir = args.data_dir
    if args.log_dir is not None:
        exp.trainer.log_dir = args.log_dir
    device = init_from_env(args.device)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    if rank0:
        if args.synthetic:
            generate_synthetic_audio_mnist(exp.data.data_dir, n_episodes=args.synthetic)
        if device.type == "cuda" and dist.is_initialized():
            from multimodal_mtrssm_tpu_torch.ops.kernels.build import load_library

            load_library()  # built once; the other ranks load it after the barrier
    if dist.is_initialized():
        dist.barrier()
    trainer = exp.build_trainer(device=device)
    trainer.callbacks.append(make_viz_callback(exp))
    out = trainer.fit(resume=args.resume)
    if rank0:
        print(f"done: best val/loss = {out['best_val']:.4f} over {len(out['history'])} epochs "
              f"(log_dir={exp.trainer.log_dir})")
    return out
