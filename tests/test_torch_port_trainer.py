"""The port's training harness on the CPU: optimizer, schedulers, data and
``Trainer.fit``, each held to the JAX package where it has a counterpart.

Tolerances: the optimizer's parameters within rtol 1e-6 of ``FusedAdamW``
after each of 5 steps (atol 1e-9 for parameters that pass near 0; the same
f32 formula, one rounding apart) and its first moment within 1e-7 absolute;
schedulers, episodes and batches exactly. Both pipelines draw their input
noise through their native libraries (the same ``fastbatch.cc``; JAX's
loaded by the ``jax_native`` fixture), so the noised batches are held to
JAX's bit for bit.
"""

import dataclasses
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.data import episodes as jax_episodes
from multimodal_mtrssm_tpu.data import pipeline as jax_pipeline
from multimodal_mtrssm_tpu.train import optim as jax_optim
from multimodal_mtrssm_tpu_torch.data import episodes, pipeline
from multimodal_mtrssm_tpu_torch.models.mrssm import MoPoEMRSSM, MRSSMConfig
from multimodal_mtrssm_tpu_torch.nn.conv import EncoderConfig
from multimodal_mtrssm_tpu_torch.ops import kernels
from multimodal_mtrssm_tpu_torch.train import optim
from multimodal_mtrssm_tpu_torch.train.steps import make_train_step
from multimodal_mtrssm_tpu_torch.train.trainer import Trainer, TrainerConfig
from multimodal_mtrssm_tpu_torch.train.weights import load_lightning_checkpoint
from _port_native import jax_native as jax_native  # noqa: F401 (a fixture)
from _port_threads import _one_intra_op_thread  # noqa: F401 (autouse)

# ---- optimizer and schedulers -----------------------------------------------------


def test_adamw_matches_jax_fused_adamw():
    """5 steps on the same gradients, the second large enough that the
    global-norm clip bites, the LR changed before the fourth."""
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 3), "b": (3,), "c": (2, 2, 2)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * (30.0 if i == 1 else 0.5)).astype(np.float32)
              for k, s in shapes.items()} for i in range(5)]
    jopt = jax_optim.make_optimizer(1e-2, grad_clip=10.0, weight_decay=0.1)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    params = [torch.tensor(init[k]) for k in shapes]
    opt = optim.AdamW(params, 1e-2, grad_clip=10.0, weight_decay=0.1)
    for i, g in enumerate(grads):
        if i == 3:
            jstate = jax_optim.set_learning_rate(jstate, 3e-3)
            optim.set_learning_rate(opt, 3e-3)
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        for p, k in zip(params, shapes):
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for p, k in zip(params, shapes):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]), rtol=1e-6, atol=1e-9,
                                       err_msg=f"step {i} {k}")
    assert sum(float((v ** 2).sum()) for v in grads[1].values()) ** 0.5 > 10.0  # the clip bit
    # The first moment cancels (b1·m + (1 - b1)·g of both signs): absolute.
    np.testing.assert_allclose(opt.m.numpy(), np.asarray(jstate.m), rtol=0, atol=1e-7)


@pytest.mark.parametrize("spec", [None, {"kind": "plateau", "patience": 1, "factor": 0.3},
                                  {"kind": "cosine", "t_max": 4}, {"kind": "step", "step_size": 2},
                                  {"kind": "exponential", "gamma": 0.7}])
def test_schedulers_and_early_stopping_match_jax(spec):
    values = [5.0, 4.0, 4.0, 4.5, 3.0, 3.0, 3.0, 2.9, 3.5]
    ours = optim.make_scheduler(spec, 1e-3, plateau_patience=2)
    theirs = jax_optim.make_scheduler(spec, 1e-3, plateau_patience=2)
    assert [ours.step(v) for v in values] == [theirs.step(v) for v in values]
    es, jes = optim.EarlyStopping(patience=2), jax_optim.EarlyStopping(patience=2)
    assert [es.step(v) for v in values] == [jes.step(v) for v in values]
    with pytest.raises(ValueError, match="unknown"):
        optim.make_scheduler({"kind": "nope"}, 1e-3)


# ---- episodes and the pipeline ------------------------------------------------------


def test_synthetic_episodes_match_jax(tmp_path):
    ours = episodes.generate_synthetic_audio_mnist(tmp_path / "port", n_episodes=3,
                                                   episode_length=20, seed=7)
    theirs = jax_episodes.generate_synthetic_audio_mnist(tmp_path / "jax", n_episodes=3,
                                                         episode_length=20, seed=7)
    assert [p.name for p in ours] == [p.name for p in theirs]
    assert episodes.list_episodes(tmp_path / "port") == ours
    for a, b in zip(ours, theirs):
        e, f = episodes.load_episode(a), jax_episodes.load_episode(b)
        for k in ("action", "audio", "vision"):
            np.testing.assert_array_equal(getattr(e, k), getattr(f, k), err_msg=k)
    assert episodes.split_paths(ours, 0.7) == (ours[:2], ours[2:])


def _datamodules(tmp_path, **kw):
    data = tmp_path / "episodes"
    episodes.generate_synthetic_audio_mnist(data, n_episodes=7, episode_length=12, seed=3)
    cfg = dict(data_dir=str(data), batch_size=2, sequence_length=6, seed=5, **kw)
    jcfg = jax_pipeline.DataModuleConfig(common_processed_dir=str(tmp_path / "none"), **cfg)
    return (pipeline.EpisodeDataModule(pipeline.DataModuleConfig(**cfg)),
            jax_pipeline.EpisodeDataModule(jcfg))


def test_datamodule_streams_match_jax_host_path(tmp_path):
    """Without noise: the same split, batch order and arrays as the JAX
    module's host path, every epoch and in validation."""
    ours, theirs = _datamodules(tmp_path, noise_std=0.0)
    assert (ours.n_train, ours.n_val) == (theirs.n_train, theirs.n_val) == (5, 2)
    for epoch in (0, 1):
        got = list(ours.train_batches(epoch))
        want = list(theirs.train_batches(epoch))
        assert len(got) == len(want) == 3  # two full batches and the ragged tail
        for g, w in zip(got, want):
            assert len(g) == 6
            for x, y in zip(g, w):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    got, want = list(ours.val_batches()), list(theirs.val_batches())
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_datamodule_noises_training_inputs_only(tmp_path, jax_native):
    ours, theirs = _datamodules(tmp_path, noise_std=0.1)
    resid = []
    for g, w in zip(ours.train_batches(0), theirs.train_batches(0)):
        for k in range(3):
            np.testing.assert_array_equal(g[3 + k].numpy(), np.asarray(w[3 + k]))  # clean targets
            resid.append((g[k] - g[3 + k]).numpy().ravel())
    resid = np.concatenate(resid)
    assert abs(resid.std() - 0.1) < 0.005 and abs(resid.mean()) < 0.005
    # Validation inputs are noised as JAX noises them; the targets stay clean.
    got, want = list(ours.val_batches()), list(theirs.val_batches())
    assert len(got) == len(want) == 1
    for g, w in zip(got, want):
        for x, y in zip(g, w):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        assert not any(torch.equal(g[k], g[3 + k]) for k in range(3))
    # The epoch's noise is a function of (seed, epoch).
    first = [b[1] for b in ours.train_batches(0)]
    assert all(torch.equal(a, b) for a, b in zip(first, (b[1] for b in ours.train_batches(0))))


def test_datamodule_noised_batches_match_jax(tmp_path, jax_native):
    """At ``noise_std=0.1``: every epoch's train batches and the validation
    batches equal the JAX module's, the inputs' noise bit for bit; a second
    pass over validation gives the same noise."""
    ours, theirs = _datamodules(tmp_path, noise_std=0.1)
    for epoch in (0, 1):
        for g, w in zip(ours.train_batches(epoch), theirs.train_batches(epoch), strict=True):
            for x, y in zip(g, w, strict=True):
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    first = list(ours.val_batches())
    for g, w in zip(first, theirs.val_batches(), strict=True):
        for x, y in zip(g, w, strict=True):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for a, b in zip(first, ours.val_batches(), strict=True):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# ---- the train step and Trainer.fit --------------------------------------------------


def _small_model() -> MoPoEMRSSM:
    from conftest import small_encoder_config

    enc = EncoderConfig(**dataclasses.asdict(small_encoder_config()))
    return MoPoEMRSSM(MRSSMConfig(audio_encoder=enc, vision_encoder=enc, init_proj_cells=32))


def test_train_step_is_a_function_of_seed_and_step(tmp_path):
    dm, _ = _datamodules(tmp_path, noise_std=0.1)
    batch = next(dm.train_batches(0))
    runs = []
    for _ in range(2):
        model = _small_model().init(torch.Generator().manual_seed(0))
        step = make_train_step(model, optim.AdamW(model.parameters()))
        metrics = [step(batch, 11, i) for i in range(2)]
        runs.append((metrics, [p.detach().clone() for p in model.parameters()]))
    (m0, p0), (m1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert float(m0[1]["loss"]) == float(m1[1]["loss"]) and torch.isfinite(m0[1]["loss"])
    assert sorted(m0[0]) == ["kl", "loss", "recon", "recon/audio", "recon/vision"]


def test_trainer_fit_on_the_cpu(tmp_path):
    dm, _ = _datamodules(tmp_path, noise_std=0.1)
    model = _small_model()
    cfg = TrainerConfig(max_epochs=2, log_dir=str(tmp_path / "run"), seed=3)
    kernels.reset_launch_counts()
    out = Trainer(model, dm, cfg).fit()
    init = _small_model().init(torch.Generator().manual_seed(3))
    assert out["global_step"] == 6 and len(out["history"]) == 2
    for row in out["history"]:
        assert all(np.isfinite(v) for v in row.values())
        assert {"train/loss", "train/kl", "val/loss", "val/recon/audio", "lr"} <= set(row)
    rows = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    rows = [r for r in rows if "image" not in r]  # the charts' paths follow the epoch rows
    assert [r["val/loss"] for r in rows] == [r["val/loss"] for r in out["history"]]
    assert out["best_val"] == min(r["val/loss"] for r in rows)
    moved = [not torch.equal(p, q) for p, q in zip(model.parameters(), init.parameters())]
    assert all(moved)
    ckpts = tmp_path / "run" / "checkpoints"
    fresh = load_lightning_checkpoint(_small_model(), ckpts / "best.ckpt")  # strict
    assert all(torch.isfinite(p).all() for p in fresh.parameters())
    last = torch.load(ckpts / "last.ckpt", weights_only=True)
    assert last["optimizer"]["count"] == 6
    assert {k: torch.equal(v, model.state_dict()[k]) for k, v in last["state_dict"].items()} \
        == {k: True for k in last["state_dict"]}
    assert kernels.launch_counts() == dict.fromkeys(kernels.LAUNCH_COUNTERS, 0)


def test_trainer_fit_returns_the_jax_keys(tmp_path):
    """``fit`` returns JAX ``Trainer.fit``'s keys (``params``, ``opt_state``,
    ``history``, ``best_val``, ``preempted``) and the port's two extra ones."""
    dm, _ = _datamodules(tmp_path, noise_std=0.0)
    model = _small_model()
    out = Trainer(model, dm, TrainerConfig(max_epochs=1, log_dir=str(tmp_path / "run"))).fit()
    assert set(out) == {"params", "opt_state", "history", "best_val", "preempted",
                        "global_step", "train_seconds"}
    assert out["preempted"] is False
    assert out["params"].keys() == model.state_dict().keys()
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in out["params"].items())
    assert out["opt_state"]["count"] == out["global_step"] == 3


@pytest.mark.parametrize("field,value", [("zero1", True), ("dcn_size", 2),
                                         ("accumulate_grad_batches", 2), ("steps_per_dispatch", 4),
                                         ("profile_epoch", 0), ("use_wandb", True)])
def test_trainer_refuses_unsupported_fields(field, value, tmp_path):
    """``use_wandb`` still raises; gradient accumulation, an integer
    ``steps_per_dispatch``, ``profile_epoch``, ``zero1`` and ``dcn_size``
    are honoured: a one-epoch fit steps once a window, trains from K-batch
    chunks (an optimizer step a batch), writes a trace, or trains on one process (ZeRO-1 of one
    shard is the replicated optimizer; ``dcn_size`` above the one rank
    warns and trains flat, as JAX's trainer does on one device)."""
    if field == "use_wandb":
        with pytest.raises(ValueError, match=field):
            TrainerConfig(**{field: value})
        return
    dm, _ = _datamodules(tmp_path, noise_std=0.0)
    with warnings.catch_warnings(record=True) as said:
        warnings.simplefilter("always")
        trainer = Trainer(_small_model(), dm, TrainerConfig(
            max_epochs=1, log_dir=str(tmp_path / "run"), **{field: value}))
    assert any("flat data mesh" in str(w.message) for w in said) == (field == "dcn_size")
    assert trainer.mesh is None
    out = trainer.fit()
    assert out["global_step"] == 3 and np.isfinite(out["history"][0]["train/loss"])
    # 3 batches: windows of 2 and the leftover 1 take 2 optimizer steps.
    assert out["opt_state"]["count"] == (2 if field == "accumulate_grad_batches" else 3)
    assert (tmp_path / "run" / "profile" / "epoch_0.trace.json").is_file() \
        == (field == "profile_epoch")


def test_trainer_refuses_resume(tmp_path):
    """Resuming is supported: ``resume=True`` without a ``last``
    checkpoint trains from scratch, then continues the run's ``last``;
    ``resume_from`` a directory without checkpoints raises."""
    dm, _ = _datamodules(tmp_path, noise_std=0.0)
    trainer = Trainer(_small_model(), dm, TrainerConfig(log_dir=str(tmp_path / "run"),
                                                        max_epochs=1, steps_per_dispatch=1))
    assert [r["epoch"] for r in trainer.fit(resume=True)["history"]] == [0]
    trainer.cfg = dataclasses.replace(trainer.cfg, max_epochs=2)
    out = trainer.fit(resume=True)
    assert [r["epoch"] for r in out["history"]] == [1] and out["global_step"] == 6
    with pytest.raises(FileNotFoundError, match="checkpoint"):
        trainer.fit(resume_from=tmp_path)
