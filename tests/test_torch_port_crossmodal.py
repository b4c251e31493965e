"""The port's cross-modal run on the CPU against the JAX package: the
crossmodal config (its YAML, which ``chip_smoke.py``'s phase 7 loads),
the evaluation batch and the reconstruction report, a
mid-epoch resume under random modality dropout, the ``train-*`` command on
the crossmodal config, and the ``crossmodal_e2e`` experiment.

Tolerances: batches, configs and the experiment's summary exactly; the
report's baselines within 1e-6 of JAX's formula evaluated in float64, and
within 1e-4 relative of JAX's own float32 values (XLA's float32 means
over the 30,720 target values stray up to 1.5e-5 relative from float64
here, the port's under 1e-7); each
condition's MSE within 1e-5 relative of the MSE of JAX's ``decode_state``
of the port's sampled states; a resumed fit equal to the uninterrupted one
bit for bit.
"""

import contextlib
import dataclasses
import importlib.util
import json
import os
import signal
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.evaluation import crossmodal as jax_crossmodal
from multimodal_mtrssm_tpu.models.state import cat_states as jax_cat_states
from multimodal_mtrssm_tpu.train.config import load_experiment as jax_load_experiment
from multimodal_mtrssm_tpu.viz import rollout as jax_rollout
from multimodal_mtrssm_tpu_torch import __main__ as entry
from multimodal_mtrssm_tpu_torch import crossmodal_e2e
from multimodal_mtrssm_tpu_torch.data import episodes, pipeline, transforms
from multimodal_mtrssm_tpu_torch.evaluation import crossmodal
from multimodal_mtrssm_tpu_torch.evaluation.word_transitions import load_test_data_with_labels
from multimodal_mtrssm_tpu_torch.train import config as config_mod
from multimodal_mtrssm_tpu_torch.train import trainer as trainer_mod
from multimodal_mtrssm_tpu_torch.train.trainer import Trainer, TrainerConfig
from multimodal_mtrssm_tpu_torch.viz.rollout import reconstruction_states
from _port_models import family, to_jax_state
from _port_threads import _one_intra_op_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
CROSSMODAL = REPO / "configs" / "mopoe_mrssm_crossmodal.yaml"
ENC = dict(channels=[4, 8], kernel_sizes=[3, 3], strides=[2, 2], paddings=[1, 1],
           num_residual_blocks=0, coord_conv=False, linear_sizes=[64])
TINY = {"model": {"init_args": {"audio_encoder": {"config": ENC}, "vision_encoder": {"config": ENC},
                                "init_proj": {"num_cells": 32}}}}


@pytest.fixture(autouse=True)
def _no_charts(monkeypatch):
    import multimodal_mtrssm_tpu_torch.viz.charts as charts

    monkeypatch.setattr(charts, "render_combined_charts", lambda *a, **k: [])


@pytest.fixture(scope="module")
def test_data(tmp_path_factory):
    """4 labeled evaluation episodes of 12 frames."""
    d = tmp_path_factory.mktemp("labeled")
    episodes.generate_synthetic_labeled_audio_mnist(d / "train", d / "eval", n_episodes=4,
                                                    episode_length=12, frames_per_word=3, seed=2)
    return load_test_data_with_labels(d / "eval")


# ---- the config ---------------------------------------------------------------------------


def test_crossmodal_yaml_equals_the_phase_7_build():
    """``configs/mopoe_mrssm_crossmodal.yaml``, which ``chip_smoke.py``'s
    phase 7 loads, builds with nothing pending what that phase's checks
    assume: the reference ``MRSSMConfig()``, batches of 8 × 30 steps with no
    pipeline noise and the audio input dropped, and a GIF callback."""
    from multimodal_mtrssm_tpu_torch.models import MRSSMConfig

    exp = config_mod.load_experiment(CROSSMODAL)
    assert exp.pending == {}
    decoders = lambda cfg: dataclasses.replace(  # noqa: E731 (the YAML spells them out)
        cfg, audio_decoder=cfg.decoder_cfg("audio"), vision_decoder=cfg.decoder_cfg("vision"))
    assert decoders(exp.model.cfg) == decoders(MRSSMConfig())
    d = exp.data
    assert (d.drop_modality, d.batch_size, d.sequence_length, d.noise_std) == ("audio", 8, 30, 0.0)
    assert exp.viz.every_n_epochs >= 1 and exp.viz.query_length == 10


def test_crossmodal_datamodule_drops_audio_inputs(tmp_path):
    """The crossmodal config's datamodule serves every train and val batch
    with the audio input at -1 and clean targets."""
    episodes.generate_synthetic_audio_mnist(tmp_path, n_episodes=5, episode_length=31, seed=1)
    exp = config_mod.load_experiment(CROSSMODAL, TINY)
    exp.data.data_dir = str(tmp_path)
    dm = exp.build_trainer(device="cpu").dm
    for batch in (*dm.train_batches(0), *dm.val_batches()):
        assert bool((batch[1] == -1).all()) and batch[1].shape[1] == 30
        assert not bool((batch[4] == -1).all()) and not bool((batch[2] == -1).all())


def test_preprocess_nodes_build_the_transforms_jax_builds():
    """A data section's ``*_preprocess`` nodes that name another transform
    than the pipeline's default become that transform (a ``Compose`` of
    them too), as JAX builds them: the same arrays out; nothing waits.
    ``modality`` builds its config, and so does ``device_resident``."""
    nodes = {"action_preprocess": {"class_path": "multimodal_rssm.models.transform.RemoveDim",
                                   "init_args": {"axis": 1, "indices_to_remove": [0]}},
             "audio_observation_preprocess": {"init_args": {"min_value": -60.0,
                                                            "max_value": 0.0}},
             "vision_observation_preprocess": {
                 "class_path": "torchvision.transforms.Compose",
                 "init_args": {"transforms": [{"class_path": "NormalizeVisionImage"},
                                              {"class_path": "ZeroOut",
                                               "init_args": {"fill_value": 0.5}}]}}}
    over = {"data": {"init_args": {"config": nodes}}}
    path = REPO / "configs" / "mopoe_mrssm.yaml"
    ours, theirs = config_mod.load_experiment(path, over), jax_load_experiment(path, over)
    assert ours.pending == {}
    assert ours.data.audio_preprocess is None and ours.data.audio_min == -60.0
    x = np.random.default_rng(0).uniform(0, 255, (3, 4, 6)).astype(np.float32)
    for field in ("action_preprocess", "vision_preprocess"):
        np.testing.assert_array_equal(getattr(ours.data, field)(x), getattr(theirs.data, field)(x))
    assert isinstance(ours.data.vision_preprocess, transforms.Compose)
    exp = config_mod.load_experiment(path, {"data": {"init_args": {"config": {
        "modality": "audio"}}}})
    assert exp.pending == {} and exp.data.modality == "audio"
    assert exp.build_datamodule().cfg.modality == "audio"
    exp = config_mod.load_experiment(path, {"data": {"init_args": {"config": {
        "device_resident": True}}}})
    assert exp.pending == {} and exp.build_datamodule().cfg.device_resident is True
    with pytest.raises(ValueError, match="unknown transform"):
        config_mod.load_experiment(path, {"data": {"init_args": {"config": {
            "audio_observation_preprocess": {"class_path": "Spectrogram"}}}}})


# ---- the evaluation batch and the report -----------------------------------------------------


@pytest.mark.parametrize("drop", [None, "audio", "vision"])
def test_build_normalized_batch_matches_jax(test_data, drop):
    ours = crossmodal.build_normalized_batch(test_data, n_episodes=3, T=10, drop=drop)
    theirs = jax_crossmodal.build_normalized_batch(test_data, n_episodes=3, T=10, drop=drop)
    for x, y in zip(ours, theirs, strict=True):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    k = {"audio": 1, "vision": 2}.get(drop)
    if k:
        assert bool((ours[k] == -1).all()) and not bool((ours[k + 3] == -1).all())
    with pytest.raises(ValueError, match="drop"):
        crossmodal.build_normalized_batch(test_data, drop="video")
    with pytest.raises(ValueError, match="no eval episodes"):
        crossmodal.build_normalized_batch([])


@pytest.mark.parametrize("name", ["mrssm", "mmtrssm"])
def test_reconstruction_report_matches_jax(name, test_data, monkeypatch):
    """The report's structure, baselines and config are JAX's (JAX's report
    run on stand-in reconstructions; the baselines also against float64);
    each condition's MSEs equal, within 1e-5 relative, those of JAX's
    ``decode_state`` of the port's states on the same weights and seed."""
    jmodel, params, port = family(name)
    kw = dict(query_length=4, n_episodes=3, T=10, seed=6)
    ours = crossmodal.reconstruction_report(port, test_data, **kw)

    def stand_in(model, params, batch, q, key):
        zero = jnp.zeros_like(batch[4])
        return {k: zero for k in ("posterior/audio", "posterior/vision", "prior/audio",
                                  "prior/vision")}

    monkeypatch.setattr(jax_rollout, "compute_reconstructions", stand_in)
    theirs = jax_crossmodal.reconstruction_report(jmodel, params, test_data, **kw)
    assert list(ours) == list(theirs)
    assert {k: list(v) for k, v in ours["conditions"].items()} == \
        {k: list(v) for k, v in theirs["conditions"].items()}
    assert list(ours["baselines"]) == list(theirs["baselines"])
    assert ours["config"] == theirs["config"]
    targets = jax_crossmodal.build_normalized_batch(test_data, n_episodes=3, T=10)[4:]
    for mod, tgt in zip(("audio", "vision"), targets):
        t = np.asarray(tgt, np.float64)
        exact = {f"constant_-1/{mod}": np.mean((t + 1.0) ** 2),
                 f"mean_frame/{mod}": np.mean((t - t.mean(axis=(0, 1), keepdims=True)) ** 2)}
        for k, v in exact.items():
            assert ours["baselines"][k] == pytest.approx(v, rel=0, abs=1e-6)
            assert ours["baselines"][k] == pytest.approx(theirs["baselines"][k], rel=1e-4)
    for drop in crossmodal.DROPS:
        batch = crossmodal.build_normalized_batch(test_data, n_episodes=3, T=10, drop=drop)
        states = reconstruction_states(port, batch, 4, seed=6)
        post = to_jax_state(states["posterior"], port.cfg)
        prior = jax_cat_states([post[:, :4], to_jax_state(states["imagined"], port.cfg)], 1)
        cell = ours["conditions"]["both" if drop is None else f"drop_{drop}"]
        for which, s in (("posterior", post), ("prior", prior)):
            recon = jmodel.decode_state(params, s)
            for mod, tgt in zip(("audio", "vision"), targets):
                want = float(jnp.mean((recon[f"recon/{mod}"] - tgt) ** 2))
                assert cell[f"{which}/{mod}"] == pytest.approx(want, rel=1e-5)
    assert ours["conditions"]["drop_audio"] != ours["conditions"]["both"]


# ---- random dropout: an exact mid-epoch resume ------------------------------------------------


@contextlib.contextmanager
def _sigterm_after(n: int):
    """SIGTERM this process right after the n-th train step of a fit."""
    real = trainer_mod.make_train_step

    def make(*args):
        step, calls = real(*args), [0]

        def wrapped(*a):
            out = step(*a)
            calls[0] += 1
            if calls[0] == n:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return wrapped

    trainer_mod.make_train_step = make
    try:
        yield
    finally:
        trainer_mod.make_train_step = real


def test_random_drop_mid_epoch_resume_is_bit_identical(tmp_path):
    """Under ``drop_modality="random"`` with pipeline noise 0 (the YAML
    runs' setting), a fit SIGTERMed after its 7th step (mid epoch 1 of
    5-step epochs) and resumed ends with the uninterrupted fit's weights
    bit for bit: the resume's skip counts the dropout draw (the fault JAX
    has, ``data/pipeline.py:326-340``, is not copied)."""
    episodes.generate_synthetic_audio_mnist(tmp_path / "ep", n_episodes=13, episode_length=6,
                                            seed=3)

    def trainer(log):
        dm = pipeline.EpisodeDataModule(pipeline.DataModuleConfig(
            data_dir=str(tmp_path / "ep"), batch_size=2, sequence_length=3, noise_std=0.0, seed=5,
            drop_modality="random"))
        model = type(family("mrssm")[2])(family("mrssm")[2].cfg)
        return Trainer(model, dm, TrainerConfig(max_epochs=2, learning_rate=3e-4, seed=7,
                                                log_dir=str(tmp_path / log)))

    ref = trainer("ref")
    ref.fit()
    with _sigterm_after(7):
        out = trainer("cut").fit()
    assert out["preempted"]
    resumed = trainer("cut")
    assert [r["epoch"] for r in resumed.fit(resume=True)["history"]] == [1]
    for a, b in zip(resumed.model.state_dict().values(), ref.model.state_dict().values()):
        assert torch.equal(a, b)


# ---- the train command and the experiment -----------------------------------------------------


def test_train_command_on_the_crossmodal_config_writes_gifs(tmp_path):
    """``train-mopoe-mrssm -c configs/mopoe_mrssm_crossmodal.yaml
    --synthetic 8 --max-epochs 2 --device cpu`` trains the config as it
    is and draws the best weights' GIFs (its period, 10 epochs, draws no
    epoch), each with the audio input dropped."""
    run = tmp_path / "run"
    entry.main(["train-mopoe-mrssm", "-c", str(CROSSMODAL), "--synthetic", "8", "--max-epochs",
                "2", "--device", "cpu", "--data-dir", str(tmp_path / "data"), "--log-dir",
                str(run)])
    assert sorted(p.name for p in (run / "viz").iterdir()) == ["final_best"]
    for stage, n in (("train", 6), ("val", 2)):
        gifs = sorted((run / "viz" / "final_best" / stage).glob("*.gif"))
        assert len(gifs) == n
    videos = [line for line in (run / "metrics.jsonl").read_text().splitlines() if '"video"' in line]
    assert len(videos) == 8


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_crossmodal_e2e",
                                                  REPO / "scripts" / "crossmodal_e2e.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_crossmodal_e2e_writes_the_jax_summary(tmp_path, monkeypatch):
    """The experiment at a tiny scale on the CPU (small encoders, 1 seed, 1
    epoch, 6 episodes, all three variants) writes each variant's results,
    report and missing-audio GIF, and a ``summary.json`` equal to the one
    the JAX script builds from the same per-seed results."""
    real = config_mod.load_experiment
    monkeypatch.setattr(config_mod, "load_experiment", lambda path: real(path, TINY))
    flags = ["--epochs", "1", "--episodes", "6", "--seeds", "1", "--n-predictions", "2"]
    summary = crossmodal_e2e.main(["--workdir", str(tmp_path / "port"), *flags, "--device", "cpu"])
    seed0 = tmp_path / "port" / "seed0"
    for variant in crossmodal_e2e.VARIANTS:
        out = seed0 / f"results_{variant}"
        assert (out / "episode_0.gif").is_file() and (out / "crossmodal_recon.json").is_file()
        assert sorted(p.name for p in out.glob("word_transitions_*.json")) == \
            [f"word_transitions_{c}.json" for c in ("audio", "both", "vision")]
    script = _jax_script()
    monkeypatch.setattr(script, "run_seed", lambda args, work, seed: summary["per_seed"][0])
    monkeypatch.setattr(sys, "argv", ["crossmodal_e2e.py", "--workdir", str(tmp_path / "jax"),
                                      *flags])
    (tmp_path / "jax").mkdir()  # the JAX script's run_seed makes it
    script.main()
    ours = json.loads((tmp_path / "port" / "summary.json").read_text())
    assert ours == json.loads((tmp_path / "jax" / "summary.json").read_text())
    assert set(ours["aggregate"]) == set(crossmodal_e2e.VARIANTS)
