"""Small models of both families in the JAX package and in the port on the
same weights, for the port's CPU tests that replay port states through
JAX (``_family``), and the conversion of port states into JAX's
(``to_jax_state``)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp

from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig, MoPoEMMTRSSM, MoPoEMRSSM, MRSSMConfig
from multimodal_mtrssm_tpu_torch.models.state import MTState
from multimodal_mtrssm_tpu_torch.nn.conv import EncoderConfig
from multimodal_mtrssm_tpu_torch.train.weights import load_reference_state_dict


@functools.lru_cache(maxsize=None)
def family(name: str):
    """A small JAX model of ``name`` ("mrssm" or "mmtrssm"), its params, and
    the port model on the same weights (eval mode), made once: callers only
    read the weights."""
    from conftest import small_encoder_config
    from multimodal_mtrssm_tpu.models.mmtrssm import MMTRSSMConfig as JaxMMTRSSMConfig
    from multimodal_mtrssm_tpu.models.mmtrssm import MoPoEMMTRSSM as JaxMoPoEMMTRSSM
    from multimodal_mtrssm_tpu.models.mrssm import MoPoEMRSSM as JaxMoPoEMRSSM
    from multimodal_mtrssm_tpu.models.mrssm import MRSSMConfig as JaxMRSSMConfig
    from multimodal_mtrssm_tpu.train.torch_export import (
        export_reference_mmtrssm_state_dict,
        export_reference_state_dict,
    )

    enc = small_encoder_config()
    penc = EncoderConfig(**dataclasses.asdict(enc))
    if name == "mmtrssm":
        jmodel = JaxMoPoEMMTRSSM(JaxMMTRSSMConfig(audio_encoder=enc, vision_encoder=enc,
                                                  init_proj_cells=32))
        port = MoPoEMMTRSSM(MMTRSSMConfig(audio_encoder=penc, vision_encoder=penc,
                                          init_proj_cells=32))
        export = export_reference_mmtrssm_state_dict
    else:
        jmodel = JaxMoPoEMRSSM(JaxMRSSMConfig(audio_encoder=enc, vision_encoder=enc,
                                              init_proj_cells=32))
        port = MoPoEMRSSM(MRSSMConfig(audio_encoder=penc, vision_encoder=penc,
                                      init_proj_cells=32))
        export = export_reference_state_dict
    params = jmodel.init(jax.random.PRNGKey(9))
    load_reference_state_dict(port, export(params))
    return jmodel, params, port.eval()


def to_jax_state(state, cfg):
    """A port ``State``/``MTState`` as the JAX package's, the same arrays."""
    from multimodal_mtrssm_tpu.models.state import MTState as JaxMTState
    from multimodal_mtrssm_tpu.models.state import State as JaxState
    from multimodal_mtrssm_tpu.ops.distributions import MultiOneHot

    j = lambda x: jnp.asarray(x.detach().cpu().numpy())  # noqa: E731
    if isinstance(state, MTState):
        return JaxMTState(
            deter_h=j(state.deter_h), deter_l=j(state.deter_l), stoch_h=j(state.stoch_h),
            stoch_l=j(state.stoch_l),
            distribution_h=MultiOneHot(j(state.logits_h), cfg.hs_class, cfg.hs_category),
            distribution_l=MultiOneHot(j(state.logits_l), cfg.ls_class, cfg.ls_category),
            hidden_h=j(state.hidden_h), hidden_l=j(state.hidden_l))
    return JaxState(deter=j(state.deter), stoch=j(state.stoch),
                    distribution=MultiOneHot(j(state.logits), cfg.class_size, cfg.category_size))


def jax_scan_gumbels(key, cfg, B: int, T: int) -> dict:
    """The Gumbel noise JAX's ``shared_step`` draws from ``key`` on its XLA
    scan (``use_pallas_train=False``: per-step key splits,
    ``models/mrssm.py:367-380``, ``models/mmtrssm.py:318-340``), as the
    port's noise dict of ``cfg``'s family (numpy float32): each
    straight-through sample's ``jax.random.categorical`` adds
    ``gumbel(key, [B, classes, categories])`` to its block logits."""
    import numpy as np

    def g(k, c, n):
        return np.asarray(jax.random.gumbel(k, (B, c, n), jnp.float32)).reshape(B, c * n)

    k_init, k_roll, _ = jax.random.split(key, 3)
    steps = jax.random.split(k_roll, T)
    if hasattr(cfg, "hs_class"):
        hc, hk, lc, lk = cfg.hs_class, cfg.hs_category, cfg.ls_class, cfg.ls_category
        k_h, k_l = jax.random.split(k_init)
        sites = {"g_lprior": [], "g_lpost": [], "g_hprior": [], "g_hpost": []}
        for k in steps:
            k_lp, k_lq, k_hp, k_hq = jax.random.split(k, 4)
            sites["g_lprior"].append(g(k_lp, lc, lk))
            sites["g_lpost"].append(g(k_lq, lc, lk))
            sites["g_hprior"].append(g(k_hp, hc, hk))
            sites["g_hpost"].append(g(k_hq, hc, hk))
        return {"g_init_h": g(k_h, hc, hk), "g_init_l": g(k_l, lc, lk),
                **{name: np.stack(v) for name, v in sites.items()}}
    c, n = cfg.class_size, cfg.category_size
    prior, post = [], []
    for k in steps:
        k_p, k_q = jax.random.split(k)
        prior.append(g(k_p, c, n))
        post.append(g(k_q, c, n))
    return {"g_init": g(k_init, c, n), "g_prior": np.stack(prior), "g_post": np.stack(post)}


@functools.lru_cache(maxsize=None)
def scan_family(name: str, activation: str = "ELU", conv_dtype: str | None = None,
                compute_dtype: str = "float32"):
    """``family``'s small models on JAX's XLA scan (``use_pallas_train=
    False``) and the port's plain route, with ``activation`` in the
    recurrence, ``conv_dtype`` (None or "bfloat16") in the conv stacks and
    ``compute_dtype`` ("float32" or "bfloat16") in the model; the same
    weights (eval mode)."""
    import torch

    from conftest import small_encoder_config
    from multimodal_mtrssm_tpu.models.mmtrssm import MMTRSSMConfig as JaxMMTRSSMConfig
    from multimodal_mtrssm_tpu.models.mmtrssm import MoPoEMMTRSSM as JaxMoPoEMMTRSSM
    from multimodal_mtrssm_tpu.models.mrssm import MoPoEMRSSM as JaxMoPoEMRSSM
    from multimodal_mtrssm_tpu.models.mrssm import MRSSMConfig as JaxMRSSMConfig
    from multimodal_mtrssm_tpu.train.torch_export import (
        export_reference_mmtrssm_state_dict,
        export_reference_state_dict,
    )

    from multimodal_mtrssm_tpu.nn.conv import DecoderConfig as JaxDecoderConfig

    from multimodal_mtrssm_tpu_torch.nn.conv import DecoderConfig

    enc = small_encoder_config()
    penc = EncoderConfig(**dataclasses.asdict(enc))
    # Narrow decoders (the reference shape, no residual blocks): JAX's
    # compile of the two stacks' VJP dominates these tests.
    feat = 96 if name == "mmtrssm" else 48
    dec = dict(in_features=feat, linear_sizes=(32, 256), conv_in_shape=(16, 4, 4),
               channels=(8, 4, 1), num_residual_blocks=0)
    jdec, pdec = JaxDecoderConfig(**dec), DecoderConfig(**dec)
    common = dict(init_proj_cells=32, activation_name=activation, use_pallas_train=False)
    jdt = None if conv_dtype is None else getattr(jnp, conv_dtype)
    pdt = None if conv_dtype is None else getattr(torch, conv_dtype)
    jcd, pcd = getattr(jnp, compute_dtype), getattr(torch, compute_dtype)
    if name == "mmtrssm":
        jmodel = JaxMoPoEMMTRSSM(JaxMMTRSSMConfig(
            audio_encoder=enc, vision_encoder=enc, audio_decoder=jdec, vision_decoder=jdec,
            conv_dtype=jdt, compute_dtype=jcd, **common))
        port = MoPoEMMTRSSM(MMTRSSMConfig(
            audio_encoder=penc, vision_encoder=penc, audio_decoder=pdec, vision_decoder=pdec,
            input_noise_std=0.0, conv_dtype=pdt, compute_dtype=pcd, **common))
        export = export_reference_mmtrssm_state_dict
    else:
        jmodel = JaxMoPoEMRSSM(JaxMRSSMConfig(
            audio_encoder=enc, vision_encoder=enc, audio_decoder=jdec, vision_decoder=jdec,
            conv_dtype=jdt, compute_dtype=jcd, **common))
        port = MoPoEMRSSM(MRSSMConfig(
            audio_encoder=penc, vision_encoder=penc, audio_decoder=pdec, vision_decoder=pdec,
            input_noise_std=0.0, conv_dtype=pdt, compute_dtype=pcd, **common))
        export = export_reference_state_dict
    port.init(torch.Generator().manual_seed(9))
    return jmodel, params_from_port(jmodel, port, export), port.eval(), export


def params_from_port(jmodel, port, export):
    """JAX params of ``jmodel`` holding ``port``'s weights: the inverse of
    ``export`` (a pure relayout: transposes, splits and permutations), found
    by exporting a params tree whose every element holds its own index.
    Faster than JAX's own init (a compile of every draw) for the tests that
    only need both packages on one set of weights."""
    import numpy as np

    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    sizes = [int(np.prod(x.shape)) for x in leaves]
    ids = np.arange(sum(sizes), dtype=np.float64)
    tagged = jax.tree_util.tree_unflatten(tree, [
        part.reshape(x.shape) for part, x in zip(np.split(ids, np.cumsum(sizes)[:-1]), leaves)])
    flat = np.full(ids.shape, np.nan, np.float32)
    sd = port.state_dict()
    for name, where in export(tagged).items():
        flat[np.asarray(where, np.float64).astype(np.int64).ravel()] = \
            sd[name].detach().cpu().numpy().ravel()
    assert not np.isnan(flat).any(), "export does not cover every JAX parameter"
    return jax.tree_util.tree_unflatten(tree, [
        jnp.asarray(part.reshape(x.shape)) for part, x in
        zip(np.split(flat, np.cumsum(sizes)[:-1]), leaves)])


# ---- the weighted and unimodal families -------------------------------------------------


def export_weighted_state_dict(params) -> dict:
    """JAX WeightedMoPoEMRSSM params → the port's state dict: MoPoE-MRSSM's
    (``export_reference_state_dict``) and ``moe_weight_head``."""
    from multimodal_mtrssm_tpu.train.torch_export import _export_mlp, export_reference_state_dict

    sd = export_reference_state_dict(params)
    _export_mlp(sd, "moe_weight_head", params["moe_weight_head"])
    return sd


def export_rssm_state_dict(params) -> dict:
    """JAX RSSM params → the port's state dict, from JAX's own export
    helpers: ``transition.*``, ``representation.*``, the encoder (its head's
    rows in torch's CHW order), the decoder and ``init_proj``."""
    import numpy as np

    from multimodal_mtrssm_tpu.train.torch_export import _export_conv_component, _export_mlp

    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    sd: dict = {}
    gru = params["transition"]["gru"]
    sd["transition.rnn_cell.weight_ih"] = f32(gru["w_ih"]).T
    sd["transition.rnn_cell.weight_hh"] = f32(gru["w_hh"]).T
    sd["transition.rnn_cell.bias_ih"] = f32(gru["b_ih"])
    sd["transition.rnn_cell.bias_hh"] = f32(gru["b_hh"])
    for name in ("action_state_projector", "rnn_to_prior_projector"):
        _export_mlp(sd, f"transition.{name}", params["transition"][name])
    _export_mlp(sd, "representation.rnn_to_post_projector", params["representation"])
    _export_mlp(sd, "init_proj", params["init_proj"])
    _export_conv_component(sd, "encoder", params["encoder"], encoder_head=True)
    _export_conv_component(sd, "decoder", params["decoder"])
    return sd


@functools.lru_cache(maxsize=None)
def variant_family(name: str, input_noise_std=0.0, compute_dtype: str = "float32"):
    """A small ``"weighted"`` (WeightedMoPoE-MRSSM) or ``"rssm"`` model in
    both packages on the port's seeded torch init (``params_from_port``),
    with ``scan_family``'s narrow decoders, ``input_noise_std`` and
    ``compute_dtype``: the JAX model, its params, the port model (eval
    mode) and the exporter."""
    import torch

    from conftest import small_encoder_config
    from multimodal_mtrssm_tpu.models.rssm import RSSM as JaxRSSM
    from multimodal_mtrssm_tpu.models.rssm import RSSMConfig as JaxRSSMConfig
    from multimodal_mtrssm_tpu.models.weighted_mopoe import (
        WeightedMoPoEMRSSM as JaxWeighted,
        WeightedMRSSMConfig as JaxWeightedConfig,
    )
    from multimodal_mtrssm_tpu.nn.conv import DecoderConfig as JaxDecoderConfig

    from multimodal_mtrssm_tpu_torch.models import (
        RSSM,
        RSSMConfig,
        WeightedMoPoEMRSSM,
        WeightedMRSSMConfig,
    )
    from multimodal_mtrssm_tpu_torch.nn.conv import DecoderConfig

    enc = small_encoder_config()
    penc = EncoderConfig(**dataclasses.asdict(enc))
    dec = dict(in_features=48, linear_sizes=(32, 256), conv_in_shape=(16, 4, 4),
               channels=(8, 4, 1), num_residual_blocks=0)
    jdec, pdec = JaxDecoderConfig(**dec), DecoderConfig(**dec)
    common = dict(init_proj_cells=32, input_noise_std=input_noise_std)
    jcd, pcd = getattr(jnp, compute_dtype), getattr(torch, compute_dtype)
    if name == "weighted":
        jmodel = JaxWeighted(JaxWeightedConfig(audio_encoder=enc, vision_encoder=enc,
                                               audio_decoder=jdec, vision_decoder=jdec,
                                               use_pallas_train=False, compute_dtype=jcd,
                                               **common))
        port = WeightedMoPoEMRSSM(WeightedMRSSMConfig(
            audio_encoder=penc, vision_encoder=penc, audio_decoder=pdec, vision_decoder=pdec,
            compute_dtype=pcd, **common))
        export = export_weighted_state_dict
    else:
        jmodel = JaxRSSM(JaxRSSMConfig(encoder=enc, decoder=jdec, compute_dtype=jcd, **common))
        port = RSSM(RSSMConfig(encoder=penc, decoder=pdec, compute_dtype=pcd, **common))
        export = export_rssm_state_dict
    port.init(torch.Generator().manual_seed(9))
    return jmodel, params_from_port(jmodel, port, export), port.eval(), export
