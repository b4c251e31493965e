"""Full-model bf16 (``compute_dtype=torch.bfloat16``) in every family,
against the JAX package's ``compute_dtype=jnp.bfloat16``.

The same weights (``_port_models``: the port's seeded init, bridged into
JAX's params), a batch made by numpy and JAX's per-step Gumbel draws
(``_port_models.jax_scan_gumbels``), with small encoders and narrow
decoders (B=2, T=6, as ``tests/test_bf16.py``). The port runs its plain
route (``use_pallas_train=False``), JAX its XLA scan, which is what JAX
takes at bf16 whatever the flag.

- ``shared_step``'s loss terms within 1e-2 of JAX's bf16 loss (measured
  ≤ 1.2e-6 of it) and JAX's own bound of the port's f32 loss, 1% + 0.5
  (``tests/test_bf16.py:70-72``); every gradient in float32, within 5e-2 ×
  max(1, max|JAX|) of JAX's bf16 gradient per tensor (measured ≤ 5e-3),
  but the transposed convs' biases. Their gradient sums the frames'
  cotangent over 1024 positions of every frame, and JAX's XLA CPU sums it
  in bf16: it strays from the f32 gradient by up to 0.84 × the tensor's
  scale, the port's (float32 sums, rounded once) by ≤ 9e-3 (measured
  here on both packages' f32 gradients, which agree within 2.3e-6 × scale).
  So these are held to the port's f32 gradient within 5e-2 × scale.
  Compared on the first batch seed
  whose step has no Gumbel near-tie of 1e-2 (``parity.train_step_near_ties``):
  bf16 moves the logits by ~1e-3, so within a near-tie the two packages
  may sample two categories.
- The f32 islands return float32 for bf16 input (``tests/test_bf16.py:
  82-94``); the carry runs in bf16 and the logits leave it in float32;
  serving's float32 frames stay float32.
- ``"auto"``, True and ``"stacked"`` are refused at bf16 for the two
  families with recurrence kernels, naming ``use_pallas_train=False``; the
  weighted model and ``RSSMConfig`` take bf16.
- A 30-step bf16 run drops its loss by at least 0.8× the f32 run's
  (``tests/test_bf16.py:115-151``).
- A float32 model converts no floating tensor in a train step: the casts
  that serve bf16 are no-ops at float32, so its arithmetic is the one it
  had before them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

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
from multimodal_mtrssm_tpu_torch.ops.distributions import MultiOneHot, kl_balanced, st_sample
from multimodal_mtrssm_tpu_torch.ops.fusion import mopoe_mix_log_probs, poe_fuse_log_probs
from multimodal_mtrssm_tpu_torch.ops.kernels import parity
from multimodal_mtrssm_tpu_torch.ops.likelihood import gaussian_nll
from multimodal_mtrssm_tpu_torch.train import AdamW, one_update
from _port_models import jax_scan_gumbels, scan_family, variant_family
from _port_threads import _one_intra_op_thread  # noqa: F401 (autouse)

B, T = 2, 6
BF16 = torch.bfloat16
TIE_EPS = 1e-2
LOSS_RTOL, GRAD_REL = 1e-2, 5e-2
FAMILIES = ["mrssm", "mmtrssm", "weighted", "rssm"]


def _models(name: str, dtype: str):
    """The family's small JAX model, its params, the port model and the
    exporter at ``dtype`` ("float32" or "bfloat16"), on one set of weights
    for both dtypes."""
    if name in ("weighted", "rssm"):
        return variant_family(name, 0.0, dtype)
    return scan_family(name, "ELU", None, dtype)


def _batch(seed: int, uni: bool) -> tuple[np.ndarray, ...]:
    rng = np.random.default_rng(seed)
    act = rng.uniform(-1, 1, (B, T, 6)).astype(np.float32)
    audio, vision = (rng.uniform(-1, 1, (B, T, 32, 32, 1)).astype(np.float32) for _ in range(2))
    return (act, vision, act, vision) if uni else (act, audio, vision, act, audio, vision)


def _untied_case(port, uni: bool):
    """The first seed's batch, JAX key and JAX's Gumbel draws as the port's
    noise whose bf16 step has no Gumbel near-tie of ``TIE_EPS``."""
    for seed in range(40):
        batch = _batch(seed, uni)
        key = jax.random.PRNGKey(seed)
        noise = {k: torch.from_numpy(v) for k, v in jax_scan_gumbels(key, port.cfg, B, T).items()}
        with torch.no_grad():
            ties = parity.train_step_near_ties(port, tuple(map(torch.from_numpy, batch)), noise,
                                               TIE_EPS)
        if ties == 0:
            return batch, key, noise
    raise AssertionError(f"no seed without near-ties of {TIE_EPS}")


def _port_step(port, batch, noise) -> tuple[dict, dict]:
    port.zero_grad(set_to_none=True)
    out = port.shared_step(tuple(map(torch.from_numpy, batch)), noise)
    out["loss"].backward()
    return ({k: float(v.detach()) for k, v in out.items()},
            {n: p.grad for n, p in port.named_parameters()})


def _deconv_bias(name: str) -> bool:
    return ".deconvs." in name and name.endswith(".bias")


@pytest.mark.parametrize("name", FAMILIES)
def test_bf16_shared_step_matches_jax(name):
    jmodel, params, port, export = _models(name, "bfloat16")
    _, _, port32, _ = _models(name, "float32")
    batch, key, noise = _untied_case(port, name == "rssm")

    def loss(p):
        d = jmodel.shared_step(p, tuple(map(jnp.asarray, batch)), key)
        return d["loss"], d

    grads, ref = jax.jit(jax.grad(loss, has_aux=True))(params)
    losses, got = _port_step(port, batch, noise)
    losses32, got32 = _port_step(port32, batch, noise)
    want = float(ref["loss"])
    for k, v in losses.items():
        assert np.isfinite(v) and abs(v - float(ref[k])) <= LOSS_RTOL * abs(want), (k, v, ref[k])
        assert abs(v - losses32[k]) <= 0.01 * abs(losses32[k]) + 0.5, (k, v, losses32[k])
    ref_grads = export(grads)
    assert set(got) == set(ref_grads)
    assert all(g.dtype == torch.float32 and bool(g.isfinite().all()) for g in got.values())
    for n, g in ref_grads.items():
        scale = max(1.0, float(np.abs(g).max()))
        if _deconv_bias(n):
            f32 = got32[n].numpy()
            err = float(np.abs(got[n].numpy() - f32).max())
            assert err <= GRAD_REL * scale, (n, err, scale)
            continue
        np.testing.assert_allclose(got[n].numpy(), g, rtol=0, atol=GRAD_REL * scale, err_msg=n)


def test_f32_islands_stay_f32_under_bf16():
    rng = np.random.default_rng(0)
    logits = torch.tensor(rng.standard_normal((4, 16)).astype(np.float32)).to(BF16)
    gumbel = torch.tensor(rng.gumbel(size=(4, 16)).astype(np.float32))
    assert poe_fuse_log_probs(logits, logits).dtype == torch.float32
    assert mopoe_mix_log_probs(logits, logits).dtype == torch.float32
    d = MultiOneHot(logits, 4, 4)
    assert st_sample(logits, gumbel, 4, 4).dtype == torch.float32
    assert d.sample(gumbel).dtype == d.probs().dtype == d.mode().dtype == torch.float32
    assert d.log_probs().dtype == d.entropy().dtype == torch.float32
    assert kl_balanced(d, d, use_balancing=True).dtype == torch.float32
    frames = torch.ones((2, 3, 4, 4, 1), dtype=BF16)
    assert gaussian_nll(frames, frames, 3).dtype == torch.float32


@pytest.mark.parametrize("name", ["mrssm", "mmtrssm"])
def test_bf16_carry_and_f32_logits(name):
    """In ``shared_step``'s filtering the carries run in bf16 and the logits
    and samples leave in float32; the reconstructions are bf16 before the
    float32 NLL. Serving's float32 frames stay float32 in and out."""
    _, _, port, _ = _models(name, "bfloat16")
    batch = tuple(map(torch.from_numpy, _batch(1, False)))
    noise = port.draw_noise(B, T, torch.Generator().manual_seed(2))
    with torch.no_grad():
        _, post, prior, _ = port._observe_batch(batch, noise, None)
        recon = port.decode_state(post)
        served, _ = port.observe(*batch[:3], noise)
        frames = port.decode_state(served)
    if name == "mrssm":
        carries, logits = (post.deter,), (post.logits, prior.logits, post.stoch, prior.stoch)
        served_fields = (served.deter, served.logits, served.stoch)
    else:
        carries = (post.deter_h, post.deter_l, post.hidden_h, post.hidden_l)
        logits = (post.logits_h, post.logits_l, prior.logits_h, prior.logits_l, post.stoch_h,
                  post.stoch_l)
        served_fields = (served.deter_h, served.hidden_l, served.logits_l, served.stoch_h)
    assert all(x.dtype == BF16 for x in carries)
    assert all(x.dtype == torch.float32 for x in logits)
    assert all(v.dtype == BF16 for v in recon.values())
    assert all(x.dtype == torch.float32 for x in served_fields)
    assert all(v.dtype == torch.float32 for v in frames.values())


def test_bf16_refusals_name_the_plain_route():
    from conftest import small_encoder_config

    import dataclasses

    from multimodal_mtrssm_tpu_torch.nn.conv import EncoderConfig

    enc = EncoderConfig(**dataclasses.asdict(small_encoder_config()))
    kw = dict(audio_encoder=enc, vision_encoder=enc, init_proj_cells=32, compute_dtype=BF16)
    for family, cfg_cls, values in ((MoPoEMRSSM, MRSSMConfig, ("auto", True, "stacked")),
                                    (MoPoEMMTRSSM, MMTRSSMConfig, ("auto", True))):
        for v in values:
            with pytest.raises(ValueError, match="use_pallas_train=False"):
                family(cfg_cls(use_pallas_train=v, **kw))
        assert family(cfg_cls(use_pallas_train=None, **kw)).plain
        with pytest.raises(ValueError, match="compute_dtype"):
            cfg_cls(compute_dtype=torch.float16)
    assert not WeightedMoPoEMRSSM(WeightedMRSSMConfig(**kw)).plain
    with pytest.raises(ValueError, match="use_pallas_train"):
        WeightedMoPoEMRSSM(WeightedMRSSMConfig(use_pallas_train=True, **kw))
    assert RSSM(RSSMConfig(encoder=enc, init_proj_cells=32, compute_dtype=BF16)).cfg.compute_dtype \
        == BF16
    with pytest.raises(ValueError, match="compute_dtype"):
        RSSMConfig(compute_dtype=torch.float16)


def _fit_losses(name: str, dtype: str, steps: int = 30) -> list[float]:
    """``steps`` AdamW updates (lr 1e-3) of the family's small model at
    ``dtype`` on one batch, a fresh noise draw each step."""
    _, _, port, _ = _models(name, dtype)
    model = type(port)(port.cfg)
    model.load_state_dict(port.state_dict())
    opt = AdamW(model.parameters(), 1e-3)
    batch = tuple(map(torch.from_numpy, _batch(1, False)))
    return [float(one_update(model, opt, batch, torch.Generator().manual_seed(7 + i))["loss"])
            for i in range(steps)]


@pytest.mark.parametrize("name", ["mrssm", "mmtrssm"])
def test_bf16_training_loss_decreases_comparably(name):
    l32, l16 = _fit_losses(name, "float32"), _fit_losses(name, "bfloat16")
    assert all(np.isfinite(l16))
    drop32, drop16 = l32[0] - min(l32), l16[0] - min(l16)
    assert drop16 > 0 and drop16 >= 0.8 * drop32, (drop16, drop32)


class _FloatConversions(TorchFunctionMode):
    """Records every ``Tensor.to``/``Tensor.float`` that makes a new tensor
    from a floating one."""

    def __init__(self):
        super().__init__()
        self.seen: list[tuple[torch.dtype, torch.dtype]] = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (func in (torch.Tensor.to, torch.Tensor.float) and args[0].is_floating_point()
                and out is not args[0]):
            self.seen.append((args[0].dtype, out.dtype))
        return out


@pytest.mark.parametrize("name", ["mrssm", "mmtrssm"])
def test_f32_step_converts_no_floating_tensor(name):
    _, _, port, _ = _models(name, "float32")
    assert port.cfg.compute_dtype == torch.float32
    batch = tuple(map(torch.from_numpy, _batch(1, False)))
    port.zero_grad(set_to_none=True)
    mode = _FloatConversions()
    with mode:
        port.shared_step(batch, generator=torch.Generator().manual_seed(3))["loss"].backward()
    assert mode.seen == []
