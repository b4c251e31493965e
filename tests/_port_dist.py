"""The ranks' side of ``tests/test_torch_port_parallel.py``: small models,
batches and tasks that run in each spawned rank (and, without a process
group, in the test process as the one-process reference). Imports torch
and the port only: the ranks never import JAX."""

from __future__ import annotations

import os
import shutil
import signal
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from multimodal_mtrssm_tpu_torch.models import (
    MMTRSSMConfig,
    MoPoEMMTRSSM,
    MoPoEMRSSM,
    MRSSMConfig,
    RSSM,
    RSSMConfig,
    WeightedMoPoEMRSSM,
    WeightedMRSSMConfig,
)
from multimodal_mtrssm_tpu_torch.nn.conv import EncoderConfig
from multimodal_mtrssm_tpu_torch.parallel.mesh import make_hybrid_mesh, make_mesh, mesh_rows
from multimodal_mtrssm_tpu_torch.train.optim import AdamW
from multimodal_mtrssm_tpu_torch.train.steps import accumulate_gradients, fold

# conftest.small_encoder_config's widths (conftest imports JAX; the ranks do not).
ENC = dict(channels=(4, 8), kernel_sizes=(3, 3), strides=(2, 2), paddings=(1, 1),
           num_residual_blocks=0, coord_conv=False, linear_sizes=(64,))
T = 5
LR = 1e-3


def small_model(family: str, input_noise_std: float = 0.1):
    """A small model of ``family`` (mrssm, mmtrssm, weighted, rssm),
    initialised from seed 0."""
    enc = EncoderConfig(**ENC)
    kw = dict(init_proj_cells=32, input_noise_std=input_noise_std)
    if family == "rssm":
        model = RSSM(RSSMConfig(encoder=enc, **kw))
    else:
        cls, cfg = {"mrssm": (MoPoEMRSSM, MRSSMConfig), "mmtrssm": (MoPoEMMTRSSM, MMTRSSMConfig),
                    "weighted": (WeightedMoPoEMRSSM, WeightedMRSSMConfig)}[family]
        model = cls(cfg(audio_encoder=enc, vision_encoder=enc, **kw))
    return model.init(torch.Generator().manual_seed(0))


def host_batch(family: str, B: int, seed: int, frames_T: int = T) -> tuple[np.ndarray, ...]:
    """A global batch of ``B`` rows that every rank builds alike."""
    rng = np.random.default_rng(seed)
    act = rng.uniform(-1, 1, (B, frames_T, 6)).astype(np.float32)
    frames = [rng.uniform(-1, 1, (B, frames_T, 32, 32, 1)).astype(np.float32)
              for _ in range(2)]
    if family == "rssm":
        return (act, frames[1], act, frames[1])
    return (act, *frames, act, *frames)


def _mesh():
    return make_mesh() if dist.is_initialized() else None


def _rows(mesh, B: int):
    lo, hi = mesh_rows(B, mesh)
    return (lo, hi, B) if mesh is not None else None, lo, hi


def _summed_grads(model) -> dict[str, np.ndarray]:
    """Each parameter's gradient summed over the ranks (0 where missing)."""
    out = {}
    for name, p in model.named_parameters():
        g = p.grad.clone() if p.grad is not None else torch.zeros_like(p)
        if dist.is_initialized():
            dist.all_reduce(g)
        out[name] = g.cpu().numpy()
    return out


def _global(value: float, rows, device="cpu") -> float:
    if rows is None:
        return value
    lo, hi, B = rows
    t = torch.tensor([value * (hi - lo) / B], dtype=torch.float64, device=device)
    dist.all_reduce(t)
    return float(t)


def _weights(model) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in model.state_dict().items()}


def step_task(device, family: str, B: int, seed: int = 3, step: int = 1, zero1: bool = True,
              full: bool = False, frames_T: int = T) -> dict:
    """One data-parallel train step of a small ``family`` model (``full``:
    MoPoE-MRSSM at ``MRSSMConfig()``) on a ``B``-row batch of ``frames_T``
    frames (the one-process step without a process group): the global
    loss, the summed gradient, the weights after, the rank's rows and its
    kernel launches."""
    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    mesh = _mesh()
    model = (MoPoEMRSSM(MRSSMConfig()).init(torch.Generator().manual_seed(0)) if full
             else small_model(family)).to(device)
    rows, lo, hi = _rows(mesh, B)
    batch = tuple(torch.from_numpy(x[lo:hi]).to(device)
                  for x in host_batch(family, B, seed, frames_T))
    opt = AdamW(model.parameters(), LR, mesh=mesh, zero1=zero1)
    gen = torch.Generator(device=device).manual_seed(fold(seed, step))
    reset_launch_counts()
    metrics = accumulate_gradients(model, batch, gen, rows=rows)
    loss = float(metrics["loss"]) if metrics else 0.0
    grads = _summed_grads(model)
    opt.step()
    return {"loss": _global(loss, rows, device), "grads": grads, "weights": _weights(model),
            "rows": (lo, hi), "launches": launch_counts()}


def jax_step_task(device, weights: dict, batch: tuple, noise: dict) -> dict:
    """A ZeRO-1 step of the small MRSSM (no input noise) on given weights,
    batch and Gumbel noise, each rank on its rows: the global loss, the
    summed gradient and the weights after."""
    from multimodal_mtrssm_tpu_torch.train.weights import load_reference_state_dict

    mesh = _mesh()
    model = small_model("mrssm", input_noise_std=0.0)
    load_reference_state_dict(model, {k: torch.tensor(v) for k, v in weights.items()})
    B = batch[0].shape[0]
    rows, lo, hi = _rows(mesh, B)
    local = tuple(torch.from_numpy(x[lo:hi]) for x in batch)
    mine = {"g_init": torch.from_numpy(noise["g_init"][lo:hi]),
            **{k: torch.from_numpy(noise[k][:, lo:hi].copy()) for k in ("g_prior", "g_post")}}
    opt = AdamW(model.parameters(), LR, mesh=mesh, zero1=True)
    out = model.shared_step(local, mine)
    (out["loss"] * ((hi - lo) / B)).backward()
    grads = _summed_grads(model)
    opt.step()
    return {"loss": _global(float(out["loss"]), rows), "grads": grads,
            "weights": _weights(model)}


def zero1_exact_task(device, weights: dict, grad: dict, m: np.ndarray, v: np.ndarray,
                     count: int) -> dict:
    """One ZeRO-1 AdamW update on fixed weights, gradient (rank 0's; the
    others add 0) and whole moments: the weights after and the moments,
    gathered whole."""
    from multimodal_mtrssm_tpu_torch.train.weights import load_reference_state_dict

    mesh = _mesh()
    model = small_model("mrssm", input_noise_std=0.0)
    load_reference_state_dict(model, {k: torch.tensor(x) for k, x in weights.items()})
    opt = AdamW(model.parameters(), LR, mesh=mesh, zero1=mesh is not None)
    opt.load_state_dict({"m": m, "v": v, "count": count, "lr": LR})
    first = mesh is None or mesh.rank == 0
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(grad[name]).clone() if first else torch.zeros_like(p)
    opt.step()
    state = opt.state_dict()
    return {"weights": _weights(model), "m": state["m"].numpy(), "v": state["v"].numpy(),
            "shard": (opt.lo, opt.shard)}


def hybrid_task(device, B: int = 8, seed: int = 4) -> dict:
    """The same ZeRO-1 step from the same weights on the flat mesh and on a
    ``dcn_size=2`` hybrid mesh: both global losses, the hybrid mesh's
    layout and this rank's moment shard on each."""
    flat = make_mesh()
    hybrid = make_hybrid_mesh(dcn_size=2)
    out = {"layout": (hybrid.shape, hybrid.data_ranks)}
    for name, mesh in (("flat", flat), ("hybrid", hybrid)):
        model = small_model("mrssm").to(device)
        lo, hi = mesh_rows(B, mesh)
        rows = (lo, hi, B)
        batch = tuple(torch.from_numpy(x[lo:hi]) for x in host_batch("mrssm", B, seed))
        opt = AdamW(model.parameters(), LR, mesh=mesh, zero1=True)
        gen = torch.Generator().manual_seed(fold(seed, 0))
        metrics = accumulate_gradients(model, batch, gen, rows=rows)
        opt.step()
        out[name] = _global(float(metrics["loss"]) if metrics else 0.0, rows)
        out[f"{name}_shard"] = (opt.lo, opt.shard, opt.n)
        out[f"{name}_weights"] = _weights(model)
    return out


def _trainer(data_dir: str, log_dir: str, epochs: int = 2, batch_size: int = 2, **kw):
    from multimodal_mtrssm_tpu_torch.data.pipeline import DataModuleConfig, EpisodeDataModule
    from multimodal_mtrssm_tpu_torch.train.trainer import Trainer, TrainerConfig

    dm = EpisodeDataModule(DataModuleConfig(data_dir=data_dir, batch_size=batch_size,
                                            sequence_length=6, seed=5, noise_std=0.0))
    return Trainer(small_model("mrssm"), dm, TrainerConfig(max_epochs=epochs, seed=7,
                                                           log_dir=log_dir, **kw))


def fit_task(device, data_dir: str, log_dir: str, zero1: bool = True) -> dict:
    """``Trainer.fit`` of 2 epochs: the history, the weights and the step.
    Rank r > 0 is given ``<log_dir>-rank<r>``, where it must write nothing."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    trainer = _trainer(data_dir, log_dir if rank == 0 else f"{log_dir}-rank{rank}", zero1=zero1)
    out = trainer.fit()
    return {"history": out["history"], "weights": _weights(trainer.model),
            "global_step": out["global_step"], "count": out["opt_state"]["count"]}


def preempt_task(device, data_dir: str, log_dir: str, after: int, copy_to: str | None = None,
                 signal_rank: int = 1) -> dict:
    """A 2-epoch fit whose rank ``signal_rank`` receives SIGTERM right after
    its ``after``-th train step; rank 0 then copies the checkpoints to
    ``copy_to``. Returns ``preempted``, the step and the ``last`` aux."""
    from multimodal_mtrssm_tpu_torch.train import trainer as trainer_mod

    rank = dist.get_rank() if dist.is_initialized() else 0
    real = trainer_mod.make_train_step

    def make(*args):
        step, calls = real(*args), [0]

        def wrapped(*a):
            out = step(*a)
            calls[0] += 1
            if calls[0] == after and rank == signal_rank:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return wrapped

    trainer_mod.make_train_step = make
    try:
        # The per-batch path (K=1), which polls for SIGTERM after every step.
        trainer = _trainer(data_dir, log_dir, zero1=True, steps_per_dispatch=1)
        out = trainer.fit()
    finally:
        trainer_mod.make_train_step = real
    if copy_to is not None and rank == 0:
        shutil.copytree(Path(log_dir) / "checkpoints", Path(copy_to) / "checkpoints")
    if dist.is_initialized():
        dist.barrier()
    return {"preempted": out["preempted"], "global_step": out["global_step"],
            "aux": trainer.ckpt.aux("last")}


def late_sigterm_task(device, data_dir: str, log_dir: str, when: str) -> dict:
    """A 2-epoch fit of 3-step epochs in which SIGTERM reaches rank 0 alone
    late in epoch 0: ``"blocked_poll"``, while rank 0 waits in the epoch's
    last preemption poll (rank 1 comes to it 1 s late, the signal fires
    0.3 s into rank 0's wait); ``"after_last_poll"``, after that poll, as
    rank 0's batch iterator ends. Returns ``preempted``, the step, the
    epochs validated and the ``last`` aux."""
    import threading
    import time

    from multimodal_mtrssm_tpu_torch.train import trainer as trainer_mod

    rank = dist.get_rank()
    real_agree, calls = trainer_mod.agree, [0]

    def agree(flag, mesh):
        calls[0] += 1
        if when == "blocked_poll" and calls[0] == 3:
            if rank == 0:
                threading.Timer(0.3, os.kill, (os.getpid(), signal.SIGTERM)).start()
            else:
                time.sleep(1.0)
        return real_agree(flag, mesh)

    trainer_mod.agree = agree
    try:
        trainer = _trainer(data_dir, log_dir, zero1=True, steps_per_dispatch=1)
        real_batches = trainer.dm.train_batches

        def train_batches(epoch, *args, **kwargs):
            yield from real_batches(epoch, *args, **kwargs)
            if when == "after_last_poll" and epoch == 0 and rank == 0:
                os.kill(os.getpid(), signal.SIGTERM)

        trainer.dm.train_batches = train_batches
        out = trainer.fit()
    finally:
        trainer_mod.agree = real_agree
    dist.barrier()
    return {"preempted": out["preempted"], "global_step": out["global_step"],
            "epochs": [r["epoch"] for r in out["history"]], "aux": trainer.ckpt.aux("last")}


def resume_task(device, data_dir: str, log_dir: str) -> dict:
    """``fit(resume=True)`` of the 2-epoch run in ``log_dir``, at K=1 as the
    preempted run trained."""
    trainer = _trainer(data_dir, log_dir, zero1=True, steps_per_dispatch=1)
    out = trainer.fit(resume=True)
    return {"history": out["history"], "weights": _weights(trainer.model),
            "global_step": out["global_step"], "preempted": out["preempted"]}


def refusal_task(device, data_dir: str, log_dir: str, batch_size: int) -> str:
    """The error a ``Trainer`` raises at a batch size the world does not divide."""
    try:
        _trainer(data_dir, log_dir, batch_size=batch_size)
    except ValueError as exc:
        return str(exc)
    return "no error"


def run_tasks(device, tasks: list[tuple[str, dict]]) -> list:
    """Each ``(function name, kwargs)`` of ``tasks`` in order, on this rank."""
    return [globals()[name](device, **kw) for name, kw in tasks]
