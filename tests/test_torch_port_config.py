"""The port's YAML experiment config (``train/config.py``), checkpoint
restore and ``WorldModel.from_checkpoint``, and the serving CLI, on the CPU.

``load_experiment`` on each shipped ``configs/*.yaml`` gives the model
config JAX's ``load_experiment`` gives (field for field), the reference
parameter counts and the weight bridge's state-dict keys; fields the port
cannot honour yet wait until the datamodule or trainer is built.
``from_checkpoint`` serves what ``Trainer.fit`` wrote.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.train.config import load_experiment as jax_load_experiment
from multimodal_mtrssm_tpu.train.torch_export import (
    export_reference_mmtrssm_state_dict,
    export_reference_state_dict,
)
from multimodal_mtrssm_tpu.utils import count_params as jax_count_params
from multimodal_mtrssm_tpu_torch import __main__ as cli
from multimodal_mtrssm_tpu_torch import server as server_mod
from multimodal_mtrssm_tpu_torch.data import episodes
from multimodal_mtrssm_tpu_torch.data.pipeline import DataModuleConfig, EpisodeDataModule
from multimodal_mtrssm_tpu_torch.models import (
    MMTRSSMConfig,
    MoPoEMMTRSSM,
    MoPoEMRSSM,
    MRSSMConfig,
)
from multimodal_mtrssm_tpu_torch.nn.conv import EncoderConfig
from multimodal_mtrssm_tpu_torch.serving import WorldModel
from multimodal_mtrssm_tpu_torch.train import CheckpointManager, Trainer, TrainerConfig
from multimodal_mtrssm_tpu_torch.train.config import build_model, load_experiment
from multimodal_mtrssm_tpu_torch.utils import count_params

REPO = Path(__file__).resolve().parents[1]
CONFIGS = {"mopoe_mrssm": 1_734_842, "mopoe_mmtrssm": 1_747_386,
           "mopoe_mrssm_crossmodal": 1_734_842}


def _same_fields(port_cfg, jax_cfg, where: str) -> None:
    """Every field of the port's config dataclass equals JAX's field of the
    same name (nested encoder and decoder configs field for field; the
    compute dtype, torch's and JAX's, by name)."""
    for f in dataclasses.fields(port_cfg):
        ours, theirs = getattr(port_cfg, f.name), getattr(jax_cfg, f.name)
        if dataclasses.is_dataclass(ours):
            _same_fields(ours, theirs, f"{where}.{f.name}")
            continue
        if f.name == "compute_dtype":
            ours, theirs = str(ours).removeprefix("torch."), jax.numpy.dtype(theirs).name
        assert ours == theirs, (where, f.name, ours, theirs)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_load_experiment_matches_jax(name):
    """The model config, its parameter count, the state-dict keys the bridge
    exports, and the trainer and data fields both packages share."""
    path = REPO / "configs" / f"{name}.yaml"
    ours, theirs = load_experiment(path), jax_load_experiment(path)
    assert type(ours.model).__name__ == type(theirs.model).__name__
    _same_fields(ours.model.cfg, theirs.model.cfg, name)
    assert count_params(ours.model) == CONFIGS[name]
    params = theirs.model.init(jax.random.PRNGKey(0))
    assert jax_count_params(params) == CONFIGS[name]
    export = (export_reference_mmtrssm_state_dict if isinstance(ours.model, MoPoEMMTRSSM)
              else export_reference_state_dict)
    assert set(ours.model.state_dict()) == set(export(params))
    for f in dataclasses.fields(ours.trainer):
        if hasattr(theirs.trainer, f.name):
            assert getattr(ours.trainer, f.name) == getattr(theirs.trainer, f.name), f.name
    for f in dataclasses.fields(ours.data):
        if f.name.endswith("_preprocess"):
            # JAX builds the default normaliser a node names (None without
            # a node); the port leaves it to the pipeline, same parameters.
            assert getattr(ours.data, f.name) is None and type(getattr(theirs.data, f.name)) \
                .__name__ in ("NoneType", "Identity", "NormalizeAudioMelSpectrogram",
                              "NormalizeVisionImage")
        elif f.name != "data_dir" and hasattr(theirs.data, f.name):
            assert getattr(ours.data, f.name) == getattr(theirs.data, f.name), f.name
    assert str(ours.data.data_dir) == str(theirs.data.data_dir)
    assert dataclasses.asdict(ours.viz) == dataclasses.asdict(theirs.viz)
    assert ours.model.cfg.input_noise_std == 0.1 and ours.data.noise_std == 0.0


def test_drop_modality_waits_for_the_datamodule(tmp_path):
    """``drop_modality: audio`` no longer waits: the crossmodal config loads
    with nothing pending and builds its datamodule and trainer, which drop
    the audio inputs (``tests/test_torch_port_crossmodal.py``)."""
    exp = load_experiment(REPO / "configs" / "mopoe_mrssm_crossmodal.yaml")
    assert exp.pending == {} and exp.data.drop_modality == "audio"
    dm = exp.build_datamodule()
    assert isinstance(dm, EpisodeDataModule) and dm.cfg.drop_modality == "audio"
    assert exp.build_trainer(datamodule=dm, device="cpu").dm is dm
    assert isinstance(load_experiment(REPO / "configs" / "mopoe_mrssm.yaml").build_datamodule(),
                      EpisodeDataModule)


@pytest.mark.parametrize("override,field,item", [
    ({"trainer": {"accumulate_grad_batches": 4}}, "accumulate_grad_batches", "item 4"),
    ({"trainer": {"steps_per_dispatch": 8}}, "steps_per_dispatch", "item 4"),
    ({"trainer": {"precision": "16-mixed"}}, "precision", "item 8"),
    ({"trainer": {"zero1": True}}, "zero1", "item 11"),
    ({"trainer": {"zero1": True, "dcn_size": 2}}, "dcn_size", "item 11"),
    ({"data": {"init_args": {"config": {"device_resident": True}}}}, "device_resident", "item 7"),
])
def test_unsupported_trainer_fields_wait_for_the_trainer(override, field, item, tmp_path):
    """Fields of later items raise at ``build_trainer``; item 4's (gradient
    accumulation, ``steps_per_dispatch``) and item 11's (``zero1``,
    ``dcn_size``) are read into ``TrainerConfig`` as JAX reads them and
    ``build_trainer`` returns a trainer that takes them; item 8's
    ``precision: 16-mixed`` is the model's bf16 conv dtype, as JAX maps it,
    and nothing waits; item 7's ``device_resident`` (with
    ``device_resident_max_bytes``) is read into ``DataModuleConfig`` as JAX
    reads it, and the datamodule and trainer build."""
    exp = load_experiment(REPO / "configs" / "mopoe_mrssm.yaml", override)
    assert isinstance(exp.model, MoPoEMRSSM)
    if item == "item 7":
        theirs = jax_load_experiment(REPO / "configs" / "mopoe_mrssm.yaml", override)
        assert exp.pending == {}
        for f in ("device_resident", "device_resident_max_bytes"):
            assert getattr(exp.data, f) == getattr(theirs.data, f)
        assert exp.data.device_resident is True and exp.data.device_resident_max_bytes == 8 << 30
        dm = exp.build_datamodule()
        assert dm.cfg.device_resident is True
        assert exp.build_trainer(datamodule=dm, device="cpu").dm is dm
        return
    if item == "item 8":
        theirs = jax_load_experiment(REPO / "configs" / "mopoe_mrssm.yaml", override)
        assert exp.model.cfg.conv_dtype == torch.bfloat16
        assert str(theirs.model.cfg.conv_dtype.__name__) == "bfloat16"
        assert exp.pending == {}
        exp.build_trainer(datamodule=EpisodeDataModule(DataModuleConfig(
            data_dir=str(tmp_path / "none"))), device="cpu")
        return
    if item not in ("item 4", "item 11"):
        with pytest.raises(NotImplementedError, match=f"{field}=.*{item}"):
            exp.build_trainer(device="cpu")
        return
    theirs = jax_load_experiment(REPO / "configs" / "mopoe_mrssm.yaml", override)
    value = override["trainer"][field]
    assert getattr(exp.trainer, field) == getattr(theirs.trainer, field) == value
    assert "trainer" not in exp.pending
    dm = EpisodeDataModule(DataModuleConfig(data_dir=str(tmp_path / "none")))
    trainer = exp.build_trainer(datamodule=dm, device="cpu")
    assert getattr(trainer.cfg, field) == value


@pytest.mark.parametrize("family,override", [
    ("WeightedMoPoEMRSSM", {}),
    ("RSSM", {"data": {"init_args": {"config": {"modality": "vision"}}}})])
def test_weighted_and_unimodal_models_load_as_jax(family, override):
    """``configs/mopoe_mrssm.yaml`` with ``class_path`` swapped (the unimodal
    RSSM at ``modality: vision``) builds the port's model of that family:
    its config equals JAX's field for field (the port's own
    ``use_pallas_train`` aside; ``compute_dtype`` float32 in both), its
    parameter count and state-dict keys JAX's, and nothing waits."""
    from _port_models import export_rssm_state_dict, export_weighted_state_dict

    path = REPO / "configs" / "mopoe_mrssm.yaml"
    over = {"model": {"class_path": f"multimodal_mtrssm_tpu.models.{family}"}, **override}
    ours, theirs = load_experiment(path, over), jax_load_experiment(path, over)
    assert type(ours.model).__name__ == type(theirs.model).__name__ == family
    assert ours.pending == {}
    cfg = ours.model.cfg
    if family == "RSSM":
        assert cfg.compute_dtype == torch.float32 and theirs.model.cfg.compute_dtype.__name__ \
            == "float32"
        assert ours.data.modality == theirs.data.modality == "vision"
        cfg = dataclasses.replace(cfg, use_pallas_train="auto")
        fields = [f for f in dataclasses.fields(cfg)
                  if f.name not in ("compute_dtype", "use_pallas_train")]
        for f in fields:
            ours_v, theirs_v = getattr(cfg, f.name), getattr(theirs.model.cfg, f.name)
            if dataclasses.is_dataclass(ours_v):
                _same_fields(ours_v, theirs_v, f"RSSM.{f.name}")
            else:
                assert ours_v == theirs_v, (f.name, ours_v, theirs_v)
    else:
        _same_fields(cfg, theirs.model.cfg, family)
    params = theirs.model.init(jax.random.PRNGKey(0))
    assert count_params(ours.model) == jax_count_params(params)
    export = export_rssm_state_dict if family == "RSSM" else export_weighted_state_dict
    assert set(ours.model.state_dict()) == set(export(params))


def test_build_trainer_on_a_supported_config(tmp_path):
    exp = load_experiment(REPO / "configs" / "mopoe_mrssm.yaml",
                          {"log_dir": str(tmp_path / "run")})
    dm = EpisodeDataModule(DataModuleConfig(data_dir=str(tmp_path / "none")))
    trainer = exp.build_trainer(datamodule=dm, device="cpu")
    assert trainer.model is exp.model and trainer.cfg.log_dir == str(tmp_path / "run")
    assert trainer.device == torch.device("cpu")


# ---- checkpoints and from_checkpoint ------------------------------------------------


def _small_cfg(family: str):
    from conftest import small_encoder_config

    enc = EncoderConfig(**dataclasses.asdict(small_encoder_config()))
    cls = MMTRSSMConfig if family == "mmtrssm" else MRSSMConfig
    return cls(audio_encoder=enc, vision_encoder=enc, init_proj_cells=32, input_noise_std=0.0)


def _weights_equal(model, other) -> bool:
    theirs = other.state_dict()
    return all(torch.equal(v.cpu(), theirs[k].cpu()) for k, v in model.state_dict().items())


@pytest.mark.parametrize("family", ["mrssm", "mmtrssm"])
def test_from_checkpoint_serves_what_fit_wrote(tmp_path, family):
    """``Trainer.fit`` on the CPU, then ``from_checkpoint`` on its
    checkpoints directory: the served weights are the ``best``
    checkpoint's, and it observes and imagines."""
    data = tmp_path / "episodes"
    episodes.generate_synthetic_audio_mnist(data, n_episodes=5, episode_length=8, seed=1)
    dm = EpisodeDataModule(DataModuleConfig(data_dir=str(data), batch_size=2, sequence_length=4,
                                            noise_std=0.0, seed=2))
    cfg = _small_cfg(family)
    model = build_model(cfg)
    Trainer(model, dm, TrainerConfig(max_epochs=1, log_dir=str(tmp_path / "run"), seed=3)).fit()
    ckpts = tmp_path / "run" / "checkpoints"
    wm = WorldModel.from_checkpoint(cfg, ckpts, device="cpu")
    best = type(model)(cfg)
    CheckpointManager(ckpts).restore_params("best", best)
    assert _weights_equal(wm.model, best) and _weights_equal(wm.model, model)
    rng = np.random.default_rng(0)
    post, _ = wm.observe(rng.uniform(-1, 1, (2, 3, 6)), rng.uniform(-1, 1, (2, 3, 32, 32, 1)),
                         rng.uniform(-1, 1, (2, 3, 32, 32, 1)), seed=1)
    frames = wm.imagine_frames(np.zeros((2, 4, 6), np.float32), post[:, -1], seed=2)
    assert frames["recon/audio"].shape == (2, 4, 32, 32, 1)


def test_from_checkpoint_takes_best_then_last_and_raises_on_none(tmp_path):
    cfg = _small_cfg("mrssm")
    first = build_model(cfg).init(torch.Generator().manual_seed(1))
    second = build_model(cfg).init(torch.Generator().manual_seed(2))
    ckpt = CheckpointManager(tmp_path / "ckpts")
    with pytest.raises(FileNotFoundError, match="ckpts"):
        WorldModel.from_checkpoint(cfg, tmp_path / "ckpts", device="cpu")
    with pytest.raises(FileNotFoundError, match="nowhere"):
        WorldModel.from_checkpoint(cfg, tmp_path / "nowhere", device="cpu")
    from multimodal_mtrssm_tpu_torch.train.optim import AdamW

    ckpt.save("last", second, AdamW(second.parameters(), 1e-3), {"epoch": 4})  # full state
    assert not ckpt.exists("best") and ckpt.exists("last")
    assert _weights_equal(WorldModel.from_checkpoint(cfg, ckpt.dir, device="cpu").model, second)
    assert ckpt.restore_params("last", build_model(cfg)) == {"epoch": 4}
    ckpt.save("best", first)
    assert _weights_equal(WorldModel.from_checkpoint(cfg, ckpt.dir, device="cpu").model, first)


def test_from_checkpoint_takes_a_config_object_without_pyyaml(tmp_path, monkeypatch):
    cfg = _small_cfg("mmtrssm")
    model = build_model(cfg).init(torch.Generator().manual_seed(4))
    CheckpointManager(tmp_path).save("best", model)
    monkeypatch.setitem(sys.modules, "yaml", None)
    wm = WorldModel.from_checkpoint(cfg, tmp_path, device="cpu")
    assert _weights_equal(wm.model, model)
    with pytest.raises(ImportError, match="PyYAML"):
        WorldModel.from_checkpoint(REPO / "configs" / "mopoe_mmtrssm.yaml", tmp_path,
                                   device="cpu")
    with pytest.raises(TypeError, match="MRSSMConfig"):
        build_model({"model": {}})


# ---- the CLI ------------------------------------------------------------------------


class _FakeServer:
    built: dict = {}

    def __init__(self, wm, host, port, **batching):
        _FakeServer.built = {"wm": wm, **batching}
        self.port = 0

    def serve_forever(self):
        pass


def test_server_main_serves_a_config_and_a_checkpoints_dir(tmp_path, monkeypatch):
    """``serve --config x.yaml --checkpoint <dir> --device cpu``: the YAML's
    model with the directory's weights and the window asked for; ``python
    -m multimodal_mtrssm_tpu_torch serve`` reaches the same entry."""
    model = load_experiment(REPO / "configs" / "mopoe_mmtrssm.yaml").model
    model.init(torch.Generator().manual_seed(5))
    CheckpointManager(tmp_path).save("best", model)
    monkeypatch.setattr(server_mod, "InferenceServer", _FakeServer)
    args = ["--config", str(REPO / "configs" / "mopoe_mmtrssm.yaml"), "--checkpoint",
            str(tmp_path), "--device", "cpu", "--batch-window-ms", "5"]
    server_mod.main(args)
    built = _FakeServer.built
    assert isinstance(built["wm"].model, MoPoEMMTRSSM)
    assert _weights_equal(built["wm"].model, model)
    assert (built["batch_window_ms"], built["batch_max"]) == (5.0, 8)
    _FakeServer.built = {}
    cli.main(["serve", *args[:6]])
    assert _weights_equal(_FakeServer.built["wm"].model, model)
    assert "batch_window_ms" not in _FakeServer.built  # window 0: as before
    with pytest.raises(SystemExit, match="--checkpoint"):
        server_mod.main(args[:2] + ["--device", "cpu"])


def test_module_entry_lists_serve():
    proc = subprocess.run([sys.executable, "-m", "multimodal_mtrssm_tpu_torch"], cwd=REPO,
                          capture_output=True, text=True, timeout=120, check=False)
    assert proc.returncode == 2 and "serve" in proc.stdout
    proc = subprocess.run([sys.executable, "-m", "multimodal_mtrssm_tpu_torch", "train"],
                          cwd=REPO, capture_output=True, text=True, timeout=120, check=False)
    assert proc.returncode == 2 and "unknown command" in proc.stdout
