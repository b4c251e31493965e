"""The port's commands on the CPU: ``python -m multimodal_mtrssm_tpu_torch``
lists the four of them, ``train-*`` trains a config (or an ``Experiment``
built without PyYAML) and resumes it, and the card is the default device.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch
import yaml

from multimodal_mtrssm_tpu_torch import __main__ as entry
from multimodal_mtrssm_tpu_torch.data.pipeline import DataModuleConfig
from multimodal_mtrssm_tpu_torch.models import MRSSMConfig
from multimodal_mtrssm_tpu_torch.nn.conv import EncoderConfig
from multimodal_mtrssm_tpu_torch.train import CheckpointManager, TrainerConfig
from multimodal_mtrssm_tpu_torch.train.config import make_experiment
from multimodal_mtrssm_tpu_torch.train.entry import default_config_path, run_training
from _port_threads import _one_intra_op_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
COMMANDS = ("train-mopoe-mrssm", "train-mopoe-mmtrssm", "evaluate-word-transitions", "serve")
ENC = dict(channels=[4, 8], kernel_sizes=[3, 3], strides=[2, 2], paddings=[1, 1],
           num_residual_blocks=0, coord_conv=False, linear_sizes=[64])


def _tiny_yaml(tmp_path, name: str) -> Path:
    """A shipped config with the small test encoders and batch 2, T 3."""
    cfg = yaml.safe_load(open(REPO / "configs" / name))
    margs = cfg["model"]["init_args"]
    margs["audio_encoder"] = {"config": ENC}
    margs["vision_encoder"] = {"config": dict(ENC)}
    margs["init_proj"] = {"num_cells": 32}
    data = cfg["data"]["init_args"]
    data = data.get("config", data)
    data["batch_size"] = 2
    for stream in ("action", "audio_observation", "vision_observation"):
        for t in data[f"{stream}_input_transform"]["init_args"]["transforms"]:
            if t["class_path"].endswith("TakeFirstN"):
                t["init_args"]["n"] = 3
    path = tmp_path / name
    yaml.safe_dump(cfg, open(path, "w"))
    return path


def test_module_entry_lists_the_four_commands():
    proc = subprocess.run([sys.executable, "-m", "multimodal_mtrssm_tpu_torch", "--help"],
                          cwd=REPO, capture_output=True, text=True, timeout=120, check=False)
    assert proc.returncode == 0
    listed = proc.stdout.split("commands:")[1]
    assert [c.strip() for c in listed.split(",")] == list(COMMANDS)
    assert default_config_path("mopoe_mrssm.yaml").resolve() == \
        (REPO / "configs" / "mopoe_mrssm.yaml").resolve()


@pytest.mark.parametrize("command,config", [("train-mopoe-mrssm", "mopoe_mrssm.yaml"),
                                            ("train-mopoe-mmtrssm", "mopoe_mmtrssm.yaml")])
def test_train_command_writes_best_and_last_then_resumes(tmp_path, capsys, command, config):
    """``<command> -c <tiny config> --synthetic 4 --max-epochs 1 --device
    cpu`` trains and writes ``best`` and ``last``; ``--resume`` with two
    epochs continues at epoch 1. The command attaches the config's
    rollout-GIF callback: each fit draws its best weights' GIFs."""
    args = [command, "-c", str(_tiny_yaml(tmp_path, config)), "--data-dir",
            str(tmp_path / "data"), "--log-dir", str(tmp_path / "run"), "--device", "cpu"]
    entry.main(args + ["--synthetic", "4", "--max-epochs", "1"])
    said = capsys.readouterr().out
    assert "done: best val/loss" in said
    assert sorted(p.name for p in (tmp_path / "run" / "viz" / "final_best" / "train").iterdir()) \
        == ["episode_0.gif", "episode_1.gif", "episode_2.gif"]
    ckpt = CheckpointManager(tmp_path / "run" / "checkpoints")
    assert ckpt.exists("best") and ckpt.exists("last")
    entry.main(args + ["--max-epochs", "2", "--resume"])
    assert "over 1 epochs" in capsys.readouterr().out
    assert ckpt.aux("last")["epoch"] == 1


def test_train_defaults_to_the_card(tmp_path):
    """Without ``--device`` the command trains on the card; with no card it
    raises rather than train on the CPU (and ``build_trainer`` likewise)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default trains there")
    cfg = str(_tiny_yaml(tmp_path, "mopoe_mrssm.yaml"))
    args = ["train-mopoe-mrssm", "-c", cfg, "--data-dir", str(tmp_path / "data"),
            "--log-dir", str(tmp_path / "run"), "--synthetic", "2"]
    for device in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry.main(args + device)
    assert not (tmp_path / "run" / "checkpoints").exists()


def test_run_training_takes_an_experiment_without_pyyaml(tmp_path, monkeypatch, capsys):
    """``run_training`` on a ``make_experiment`` built from a model config
    object, with PyYAML unimportable: it trains, and resumes at the next
    epoch."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    enc = EncoderConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in ENC.items()})
    exp = make_experiment(MRSSMConfig(audio_encoder=enc, vision_encoder=enc, init_proj_cells=32),
                          TrainerConfig(max_epochs=1, log_dir=str(tmp_path / "run")),
                          DataModuleConfig(data_dir=str(tmp_path / "data"), batch_size=2,
                                           sequence_length=3, noise_std=0.0))
    assert exp.data.noise_std == 0.0
    out = run_training("unused.yaml", ["--synthetic", "4", "--device", "cpu"], experiment=exp)
    assert [r["epoch"] for r in out["history"]] == [0]
    out = run_training("unused.yaml", ["--max-epochs", "2", "--resume", "--device", "cpu"],
                       experiment=exp)
    assert [r["epoch"] for r in out["history"]] == [1]
    assert (tmp_path / "run" / "viz" / "final_best" / "val").is_dir()
