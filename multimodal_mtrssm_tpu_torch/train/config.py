"""YAML experiment configuration (port of ``train/config.py``).

Reads the reference's LightningCLI schema (``class_path``/``init_args``
nodes; the shipped ``configs/*.yaml`` use it) into the port's dataclasses:

- ``model`` → ``MRSSMConfig`` / ``WeightedMRSSMConfig`` / ``MMTRSSMConfig``
  / ``RSSMConfig`` and the model (by ``class_path``: ``MoPoEMRSSM``,
  ``WeightedMoPoEMRSSM``, ``MoPoEMMTRSSM``, ``RSSM``), with the data
  section's ``GaussianNoise`` input transforms moved into the model's
  ``input_noise_std`` (added on the device in ``shared_step``; the unimodal
  RSSM takes the action stream's and the ``modality`` stream's) and the
  pipeline's own noise 0, as JAX does; ``trainer.precision`` containing 16
  (Lightning's ``16-mixed``) sets the model's ``conv_dtype`` to bf16, as
  JAX's ``train/config.py:192-202`` does: bf16 conv stacks, the recurrence
  and the ELBO in float32 (RSSM, which has no ``conv_dtype``, stays in
  float32, as in JAX). The port also reads ``remat`` and ``scan_unroll``
  from the model's ``init_args``;
- ``optimizer`` / ``lr_scheduler`` / ``trainer`` (and its callbacks) →
  ``TrainerConfig``;
- ``data`` → ``DataModuleConfig`` (``drop_modality``, ``modality``, and each
  ``*_preprocess`` node that names another transform than the pipeline's
  default as that transform, ``data.transforms.TRANSFORMS``);
- the viz callback → ``VizConfig``; ``seed_everything`` → the seeds.

A data or trainer field that the port cannot honour yet is not dropped and
does not fail the load (so that serving, ``WorldModel.from_checkpoint``,
reads every config): it waits in ``Experiment.pending`` and
``Experiment.build_datamodule`` / ``build_trainer`` raise, naming it and the
ROADMAP item that ports it. PyYAML is imported only to read a file; a model
config object needs none, and :func:`make_experiment` builds an
``Experiment`` from one. ``Experiment.build_trainer`` moves the model to
the card and trains there unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import warnings
from pathlib import Path
from typing import Any

import torch

from multimodal_mtrssm_tpu_torch.data.pipeline import DataModuleConfig, EpisodeDataModule
from multimodal_mtrssm_tpu_torch.data.transforms import TRANSFORMS, Compose
from multimodal_mtrssm_tpu_torch.models import (
    RSSM,
    MMTRSSMConfig,
    MoPoEMMTRSSM,
    MoPoEMRSSM,
    MRSSMConfig,
    RSSMConfig,
    WeightedMoPoEMRSSM,
    WeightedMRSSMConfig,
    WorldModelNet,
)
from multimodal_mtrssm_tpu_torch.nn.conv import DecoderConfig, EncoderConfig
from multimodal_mtrssm_tpu_torch.train.trainer import Trainer, TrainerConfig
from multimodal_mtrssm_tpu_torch.utils import require_device

@dataclasses.dataclass
class VizConfig:
    """The rollout-GIF callback's settings (reference
    ``configs/default.yaml:149-155``; ``viz.callback.make_viz_callback``)."""

    every_n_epochs: int = 10
    indices: tuple[int, ...] = (0, 1, 2)
    query_length: int = 10
    fps: float = 10.0


@dataclasses.dataclass
class Experiment:
    """An experiment parsed from a YAML config. ``pending`` holds, per
    section (``"data"``, ``"trainer"``), each field the config sets that
    the port cannot honour yet: ``{field: (value, what ports it)}``."""

    model: WorldModelNet
    trainer: TrainerConfig
    data: DataModuleConfig
    viz: VizConfig
    raw: dict
    pending: dict[str, dict[str, tuple[Any, str]]]

    def _refuse(self, section: str) -> None:
        fields = self.pending.get(section)
        if fields:
            said = "; ".join(f"{k}={v!r} ({why})" for k, (v, why) in fields.items())
            raise NotImplementedError(f"the config's {section} section sets what the port "
                                      f"does not support yet: {said}")

    def build_datamodule(self) -> EpisodeDataModule:
        """The episode pipeline of the data section; raises on a pending
        data field."""
        self._refuse("data")
        return EpisodeDataModule(self.data)

    def build_trainer(self, model: WorldModelNet | None = None,
                      datamodule: EpisodeDataModule | None = None,
                      device: torch.device | str = "cuda") -> Trainer:
        """A ``Trainer`` of ``model`` (the experiment's by default), moved to
        ``device`` and trained there (the card unless the caller asks for
        the CPU; without a card the default raises), on ``datamodule``
        (:meth:`build_datamodule` by default); raises on a pending trainer
        or data field."""
        self._refuse("trainer")
        device = require_device(device, "build_trainer")
        model = (model if model is not None else self.model).to(device)
        return Trainer(model, datamodule if datamodule is not None else self.build_datamodule(),
                       self.trainer)


def make_experiment(model_config: Any, trainer: TrainerConfig | None = None,
                    data: DataModuleConfig | None = None) -> Experiment:
    """An :class:`Experiment` without a YAML file, hence without PyYAML:
    the model of ``model_config`` (a config of any family),
    ``trainer`` and ``data`` (their defaults when None). The data
    pipeline adds no noise: the model's ``input_noise_std`` does, as a
    config read from YAML arranges."""
    return Experiment(model=build_model(model_config), trainer=trainer or TrainerConfig(),
                      data=data or DataModuleConfig(noise_std=0.0), viz=VizConfig(), raw={},
                      pending={})


def _init_args(node: dict | None) -> dict:
    if not node:
        return {}
    return node.get("init_args", node) or {}


def _class_name(node: dict | None) -> str:
    if not node:
        return ""
    return str(node.get("class_path", "")).rsplit(".", 1)[-1]


def _tuples(d: dict, keys: tuple[str, ...]) -> dict:
    return {k: tuple(v) if k in keys else v for k, v in d.items()}


def _encoder_cfg(node: dict | None) -> EncoderConfig:
    cfg = _init_args(node).get("config", {})
    known = {f.name for f in dataclasses.fields(EncoderConfig)}
    return EncoderConfig(**_tuples({k: v for k, v in cfg.items() if k in known}, (
        "linear_sizes", "channels", "kernel_sizes", "strides", "paddings", "in_hw")))


def _decoder_cfg(node: dict | None, in_features: int) -> DecoderConfig:
    cfg = dict(_init_args(node).get("config", {}))
    cfg["in_features"] = cfg.get("in_features", in_features)
    known = {f.name for f in dataclasses.fields(DecoderConfig)}
    return DecoderConfig(**_tuples({k: v for k, v in cfg.items() if k in known}, (
        "linear_sizes", "conv_in_shape", "channels", "kernel_sizes", "strides", "paddings",
        "output_paddings")))


def _scheduler_spec(node: dict | None) -> dict | None:
    """A YAML ``lr_scheduler`` node (torch ``class_path``) as a
    ``train.optim.make_scheduler`` spec. ``ReduceLROnPlateau`` (the
    reference default) returns None: the trainer builds the plateau from the
    separately parsed factor and patience. An unknown class warns and falls
    back to the plateau."""
    name = _class_name(node)
    if not name or name == "ReduceLROnPlateau":
        return None
    args = _init_args(node)
    if name == "CosineAnnealingLR":
        return {"kind": "cosine", "t_max": int(args.get("T_max", 100)),
                "eta_min": float(args.get("eta_min", 0.0))}
    if name == "StepLR":
        return {"kind": "step", "step_size": int(args.get("step_size", 30)),
                "gamma": float(args.get("gamma", 0.1))}
    if name == "ExponentialLR":
        return {"kind": "exponential", "gamma": float(args.get("gamma", 0.95))}
    warnings.warn(f"unsupported lr_scheduler class {name!r}; using ReduceLROnPlateau",
                  stacklevel=2)
    return None


def _first_scalar(v):
    """torch's ReduceLROnPlateau takes min_lr as a scalar or one per param
    group; one group here, so a list gives its first element."""
    if isinstance(v, (list, tuple)):
        return v[0] if v else 0.0
    return v


def _find_callback(callbacks: list, name: str) -> dict:
    for cb in callbacks or []:
        if _class_name(cb).endswith(name):
            return _init_args(cb)
    return {}


def _activation_name(value, default: str) -> str:
    """'torch.nn.ELU' / 'ELU' → 'ELU'; None → default."""
    if not value:
        return default
    return str(value).rsplit(".", 1)[-1]


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = (_deep_merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict)
                  else v)
    return out


def _read_yaml(path: str | Path) -> dict:
    """A YAML file as a dict, through PyYAML (imported here, not with the
    module: a machine without it still builds models from config objects)."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"reading {path} needs PyYAML, which is not installed; pass a model "
                          "config object (MRSSMConfig / MMTRSSMConfig) instead") from e
    return yaml.safe_load(Path(path).read_text()) or {}


def _input_transforms(dconf: dict) -> tuple[int, float | tuple[float, float, float]]:
    """``TakeFirstN`` n and the ``GaussianNoise`` std(s) of the three input
    streams' transforms (all streams share one sequence length)."""
    seq_lens: dict[str, int] = {}
    noise_stds: dict[str, float] = {}
    for stream in ("action", "audio_observation", "vision_observation"):
        for t in _init_args(dconf.get(f"{stream}_input_transform")).get("transforms", []):
            name = _class_name(t)
            if name == "TakeFirstN":
                seq_lens[stream] = int(_init_args(t).get("n", 30))
            elif name == "GaussianNoise":
                noise_stds[stream] = float(_init_args(t).get("std", 0.1))  # the transform's default
    if len(set(seq_lens.values())) > 1:
        raise ValueError(f"TakeFirstN lengths disagree across input streams: {seq_lens}; all "
                         "streams must share one sequence length")
    stds3 = tuple(noise_stds.get(s, 0.0)
                  for s in ("action", "audio_observation", "vision_observation"))
    # A scalar when uniform, as JAX keeps it.
    return next(iter(seq_lens.values()), 30), stds3[0] if len(set(stds3)) == 1 else stds3


# Preprocess nodes of the data section, the pipeline's field for each, and
# the transform the pipeline applies itself (a node without class_path
# names it).
_PREPROCESS = {"action_preprocess": ("action_preprocess", "Identity"),
               "audio_observation_preprocess": ("audio_preprocess", "NormalizeAudioMelSpectrogram"),
               "vision_observation_preprocess": ("vision_preprocess", "NormalizeVisionImage")}


def _build_transform(node: dict):
    """The transform a YAML ``class_path`` node names (the reference's
    ``multimodal_rssm`` transforms, ``torch.nn.Identity``, or a
    ``Compose`` of them), with its ``init_args``."""
    name = _class_name(node)
    args = dict(node.get("init_args") or {})
    if name == "Compose":
        return Compose([_build_transform(t) for t in args.get("transforms", [])])
    cls = TRANSFORMS.get(name)
    if cls is None:
        raise ValueError(f"unknown transform class_path: {node.get('class_path')}")
    return cls(**args)


def _data_config(raw: dict, dconf: dict, seq_len: int) -> DataModuleConfig:
    """The data section as a ``DataModuleConfig``. A preprocess node that
    names the pipeline's own normaliser sets its parameters (the audio
    range); another transform replaces it."""
    transforms = {}
    for key, (field, default) in _PREPROCESS.items():
        node = dconf.get(key)
        if node and (_class_name(node) or default) != default:
            transforms[field] = _build_transform(node)
    audio_pre = _init_args(dconf.get("audio_observation_preprocess"))
    return DataModuleConfig(
        drop_modality=dconf.get("drop_modality"),
        modality=dconf.get("modality", "multimodal"),
        **transforms,
        data_dir=dconf.get("data_dir", f"data/{dconf.get('data_name', 'audio_mnist')}"),
        batch_size=int(dconf.get("batch_size", 8)),
        sequence_length=seq_len,
        noise_std=0.0,  # the model's input_noise_std adds it on the device
        audio_min=float(audio_pre.get("min_value", -80.0)),
        audio_max=float(audio_pre.get("max_value", 0.0)),
        seed=int(raw.get("seed_everything", 42)),
        device_resident=bool(dconf.get("device_resident", False)),
        device_resident_max_bytes=int(dconf.get("device_resident_max_bytes", 8 << 30)),
    )


def _trainer_config(raw: dict, pending: dict) -> TrainerConfig:
    trainer_node = raw.get("trainer", {})
    if raw.get("use_wandb", False):
        pending["use_wandb"] = (raw["use_wandb"], "W&B is not ported: JSONL metrics are the record")
    callbacks = trainer_node.get("callbacks", [])
    sched = _init_args(raw.get("lr_scheduler"))
    early = _find_callback(callbacks, "EarlyStopping")
    logger_args = _init_args(trainer_node.get("logger"))
    opt_args = _init_args(raw.get("optimizer"))
    betas = opt_args.get("betas", (0.9, 0.999))
    return TrainerConfig(
        max_epochs=int(trainer_node.get("max_epochs", 100)),
        seed=int(raw.get("seed_everything", 42)),
        learning_rate=float(opt_args.get("lr", 1e-3)),
        grad_clip=float(trainer_node.get("gradient_clip_val", 10.0)),
        weight_decay=float(opt_args.get("weight_decay", 0.01)),
        adam_b1=float(betas[0]),
        adam_b2=float(betas[1]),
        adam_eps=float(opt_args.get("eps", 1e-8)),
        plateau_factor=float(sched.get("factor", 0.5)),
        plateau_patience=int(sched.get("patience", 50)),
        plateau_min_lr=float(_first_scalar(sched.get("min_lr", 0.0))),
        plateau_threshold=float(sched.get("threshold", 1e-4)),
        early_stop_patience=int(early.get("patience", 200)),
        early_stop_min_delta=float(early.get("min_delta", 0.0)),
        log_dir=str(raw.get("log_dir", f"runs/{logger_args.get('project', 'default')}")),
        wandb_project=logger_args.get("project"),
        lr_scheduler=_scheduler_spec(raw.get("lr_scheduler")),
        accumulate_grad_batches=int(trainer_node.get("accumulate_grad_batches", 1)),
        zero1=bool(trainer_node.get("zero1", False)),
        dcn_size=trainer_node.get("dcn_size"),
        steps_per_dispatch=(
            spd if (spd := trainer_node.get("steps_per_dispatch", "auto")) == "auto" else int(spd)),
    )


def load_experiment(path: str | Path, overrides: dict | None = None) -> Experiment:
    """Parse a YAML config (the shipped ones or the reference LightningCLI
    schema) into an :class:`Experiment`; ``overrides`` deep-merge over it."""
    raw = _read_yaml(path)
    if overrides:
        raw = _deep_merge(raw, overrides)
    model_node = raw.get("model", {})
    model_cls = _class_name(model_node).upper()
    margs = _init_args(model_node)
    data_args = _init_args(raw.get("data"))
    # A flat mapping in the reference YAML, or a class_path/init_args node.
    dconf = _init_args(data_args.get("config", data_args))
    seq_len, noise_std = _input_transforms(dconf)
    if "MMTRSSM" in model_cls:
        model = _build_mmtrssm(margs, noise_std)
    elif "WEIGHTED" in model_cls:
        model = _build_weighted_mrssm(margs, noise_std)
    elif "MRSSM" in model_cls or not model_cls:
        model = _build_mrssm(margs, noise_std)
    elif "RSSM" in model_cls:
        # The unimodal model takes (action, obs) stds; the obs stream is the
        # modality's (JAX config.py:183-187).
        stds3 = noise_std if isinstance(noise_std, tuple) else (noise_std,) * 3
        obs_std = stds3[2] if dconf.get("modality") == "vision" else stds3[1]
        model = _build_unimodal_rssm(
            margs, stds3[0] if stds3[0] == obs_std else (stds3[0], obs_std))
    else:
        raise ValueError(f"unknown model class_path: {model_node.get('class_path')}")
    trainer_pending: dict[str, tuple[Any, str]] = {}
    data = _data_config(raw, dconf, seq_len)
    trainer = _trainer_config(raw, trainer_pending)
    # Lightning's 16-mixed is bf16 conv stacks with a float32 recurrence; the
    # unimodal RSSM has no conv dtype and stays in float32, as in JAX.
    if "16" in str(raw.get("trainer", {}).get("precision", "32")).lower() \
            and getattr(model.cfg, "conv_dtype", False) is None:
        model = type(model)(dataclasses.replace(model.cfg, conv_dtype=torch.bfloat16))
    viz_args = _find_callback(raw.get("trainer", {}).get("callbacks", []), "Output")
    viz = VizConfig(
        every_n_epochs=int(viz_args.get("every_n_epochs", 10)),
        indices=tuple(viz_args.get("indices", (0, 1, 2))),
        query_length=int(viz_args.get("query_length", 10)),
        fps=float(viz_args.get("fps", 10.0)),
    )
    return Experiment(model=model, trainer=trainer, data=data, viz=viz, raw=raw,
                      pending={"trainer": trainer_pending} if trainer_pending else {})


def build_model(config: Any) -> WorldModelNet:
    """The model of ``config``: a YAML path (:func:`load_experiment`) or an
    ``MRSSMConfig`` / ``WeightedMRSSMConfig`` / ``MMTRSSMConfig`` /
    ``RSSMConfig``."""
    if isinstance(config, (str, Path)):
        return load_experiment(config).model
    if isinstance(config, MMTRSSMConfig):
        return MoPoEMMTRSSM(config)
    if isinstance(config, WeightedMRSSMConfig):
        return WeightedMoPoEMRSSM(config)
    if isinstance(config, MRSSMConfig):
        return MoPoEMRSSM(config)
    if isinstance(config, RSSMConfig):
        return RSSM(config)
    raise TypeError(f"expected a YAML path, MRSSMConfig, WeightedMRSSMConfig, MMTRSSMConfig or "
                    f"RSSMConfig, got {type(config).__name__}")


def _build_mrssm(margs: dict, noise_std: float | tuple = 0.1) -> MoPoEMRSSM:
    rep = _init_args(margs.get("audio_representation"))
    trans = _init_args(margs.get("transition"))
    dist = rep.get("distribution_config", [4, 4])
    deter = int(rep.get("deterministic_size", 32))
    feature = deter + int(dist[0]) * int(dist[1])
    init_proj = _init_args(margs.get("init_proj"))
    cfg = MRSSMConfig(
        deterministic_size=deter,
        hidden_size=int(rep.get("hidden_size", 32)),
        obs_embed_size=int(rep.get("obs_embed_size", 64)),
        class_size=int(dist[0]),
        category_size=int(dist[1]),
        action_size=int(trans.get("action_size", 6)),
        activation_name=rep.get("activation_name", "ELU"),
        init_proj_cells=int(init_proj.get("num_cells", 200)),
        init_proj_activation=_activation_name(init_proj.get("activation_class"), "Tanh"),
        kl_coeff=float(margs.get("kl_coeff", 1.0)),
        use_kl_balancing=bool(margs.get("use_kl_balancing", True)),
        input_noise_std=noise_std,
        use_pallas_train=margs.get("use_pallas_train", "auto"),
        conv_layout=margs.get("conv_layout", "auto"),
        **_scan_fields(margs),
        audio_encoder=_encoder_cfg(margs.get("audio_encoder")),
        vision_encoder=_encoder_cfg(margs.get("vision_encoder")),
        audio_decoder=_decoder_cfg(margs.get("audio_decoder"), feature),
        vision_decoder=_decoder_cfg(margs.get("vision_decoder"), feature),
    )
    return MoPoEMRSSM(cfg)


def _scan_fields(margs: dict) -> dict:
    """``remat`` and ``scan_unroll`` of a model's ``init_args`` (the
    configs validate them)."""
    return {"remat": margs.get("remat", False), "scan_unroll": margs.get("scan_unroll", 1)}


def _build_weighted_mrssm(margs: dict, noise_std: float | tuple = 0.1) -> WeightedMoPoEMRSSM:
    """``_build_mrssm``'s config and ``moe_weight_head.num_cells`` (JAX
    ``config.py:306-321``)."""
    base = _build_mrssm(margs, noise_std).cfg
    cfg = WeightedMRSSMConfig(
        **{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
        weight_head_cells=int(_init_args(margs.get("moe_weight_head")).get("num_cells", 32)))
    return WeightedMoPoEMRSSM(cfg)


def _build_unimodal_rssm(margs: dict, noise_std: float | tuple = 0.0) -> RSSM:
    """JAX ``config.py:324-350``: ``representation``, ``encoder`` and
    ``decoder`` fall back to the ``audio_*`` nodes."""
    rep = _init_args(margs.get("representation") or margs.get("audio_representation"))
    trans = _init_args(margs.get("transition"))
    dist = rep.get("distribution_config", [4, 4])
    deter = int(rep.get("deterministic_size", 32))
    feature = deter + int(dist[0]) * int(dist[1])
    cfg = RSSMConfig(
        deterministic_size=deter,
        hidden_size=int(rep.get("hidden_size", 32)),
        obs_embed_size=int(rep.get("obs_embed_size", 64)),
        class_size=int(dist[0]),
        category_size=int(dist[1]),
        action_size=int(trans.get("action_size", 6)),
        activation_name=rep.get("activation_name", "ELU"),
        init_proj_cells=int(_init_args(margs.get("init_proj")).get("num_cells", 200)),
        kl_coeff=float(margs.get("kl_coeff", 1.0)),
        use_kl_balancing=bool(margs.get("use_kl_balancing", True)),
        input_noise_std=noise_std,
        remat=margs.get("remat", False),
        use_pallas_train=margs.get("use_pallas_train", "auto"),
        encoder=_encoder_cfg(margs.get("encoder") or margs.get("audio_encoder")),
        decoder=_decoder_cfg(margs.get("decoder") or margs.get("audio_decoder"), feature),
    )
    return RSSM(cfg)


def _build_mmtrssm(margs: dict, noise_std: float | tuple = 0.1) -> MoPoEMMTRSSM:
    rep = _init_args(margs.get("audio_representation"))
    l_dist = _init_args(margs.get("l_dist"))
    h_dist = _init_args(margs.get("h_dist"))
    hd = int(margs.get("hd_dim", 32))
    ld = int(margs.get("ld_dim", 32))
    feature = hd + int(margs.get("hs_dim", 16)) + ld + int(margs.get("ls_dim", 16))
    init_proj = _init_args(margs.get("init_proj"))
    cfg = MMTRSSMConfig(
        action_size=int(margs.get("action_size", 6)),
        obs_embed_size=int(rep.get("obs_embed_size", 64)),
        hd_dim=hd,
        hs_class=int(h_dist.get("class_size", 2)),
        hs_category=int(h_dist.get("category_size", 8)),
        ld_dim=ld,
        ls_class=int(l_dist.get("class_size", 4)),
        ls_category=int(l_dist.get("category_size", 4)),
        l_tau=float(margs.get("l_tau", 2.0)),
        h_tau=float(margs.get("h_tau", 4.0)),
        prior_cells=int(_init_args(margs.get("l_prior")).get("num_cells", 32)),
        rep_hidden_size=int(rep.get("hidden_size", 32)),
        activation_name=rep.get("activation_name", "ELU"),
        init_proj_cells=int(init_proj.get("num_cells", 200)),
        init_proj_activation=_activation_name(init_proj.get("activation_class"), "Tanh"),
        kl_coeff=float(margs.get("kl_coeff", 1.0)),
        use_kl_balancing=bool(margs.get("use_kl_balancing", True)),
        input_noise_std=noise_std,
        w_kl_h=float(margs.get("w_kl_h", 1.0)),
        use_pallas_train=margs.get("use_pallas_train", "auto"),
        conv_layout=margs.get("conv_layout", "auto"),
        **_scan_fields(margs),
        audio_encoder=_encoder_cfg(margs.get("audio_encoder")),
        vision_encoder=_encoder_cfg(margs.get("vision_encoder")),
        audio_decoder=_decoder_cfg(margs.get("audio_decoder"), feature),
        vision_decoder=_decoder_cfg(margs.get("vision_decoder"), feature),
    )
    # The declared stoch widths must match the distributions' (the
    # reference configs keep them in step by hand).
    if cfg.hs_dim != int(margs.get("hs_dim", cfg.hs_dim)):
        raise ValueError(f"hs_dim {margs.get('hs_dim')} != h_dist {cfg.hs_dim}")
    if cfg.ls_dim != int(margs.get("ls_dim", cfg.ls_dim)):
        raise ValueError(f"ls_dim {margs.get('ls_dim')} != l_dist {cfg.ls_dim}")
    return MoPoEMMTRSSM(cfg)
