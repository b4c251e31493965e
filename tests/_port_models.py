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
