"""The plain route chosen by name (``use_pallas_train=False``), and ``remat``
and ``scan_unroll``.

``use_pallas_train`` False or None resolves to ``"plain"``: both families'
recurrences and rollouts run as their plain versions on any device, for any
activation, and every refusal of the kernels names that route. A Tanh model
of each family (which the kernels refuse) is held to JAX's XLA scan
(``use_pallas_train=False``) on the same weights: the port is given the
per-step Gumbel draws JAX's scan makes from its key
(``_port_models.jax_scan_gumbels``), so both sample alike; losses within
rtol 2e-5, every gradient within 3e-4 × max(1, max|JAX|) per tensor. An ELU
model's plain route equals the kernel wiring's plain versions bit for bit
on the CPU. ``remat`` and ``scan_unroll`` are read from Python and YAML,
validated, and change nothing (both routes recompute a step from its
carries already).
"""

import contextlib
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig, MoPoEMMTRSSM, MoPoEMRSSM, MRSSMConfig
from multimodal_mtrssm_tpu_torch.ops import kernels
from multimodal_mtrssm_tpu_torch.ops.kernels import (
    build,
    fused_conv,
    recurrence,
    recurrence_mt,
    rollout,
)
from multimodal_mtrssm_tpu_torch.train.config import load_experiment
from _port_models import jax_scan_gumbels, scan_family
from _port_threads import _one_intra_op_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
ROUTE = "use_pallas_train=False"


# ---- resolution ----------------------------------------------------------------------------


@pytest.mark.parametrize("value,family,mode", [
    (True, "mrssm", "kernel"), ("auto", "mrssm", "kernel"), ("stacked", "mrssm", "stacked"),
    (False, "mrssm", "plain"), (None, "mrssm", "plain"), (True, "mmtrssm", "kernel"),
    (False, "mmtrssm", "plain"), (None, "mmtrssm", "plain")])
def test_resolve_table(value, family, mode):
    assert kernels.resolve_train_kernel_mode(value, family) == mode


@pytest.mark.parametrize("value", ["interpret", "reference", "stacked_interpret"])
def test_jax_debug_modes_still_raise(value):
    with pytest.raises(ValueError, match="not supported by the port"):
        kernels.resolve_train_kernel_mode(value)


def test_models_take_the_plain_route_by_name():
    assert MoPoEMRSSM(MRSSMConfig(use_pallas_train=False)).plain
    assert MoPoEMMTRSSM(MMTRSSMConfig(use_pallas_train=None)).plain
    assert not MoPoEMRSSM(MRSSMConfig()).plain and not MoPoEMRSSM(MRSSMConfig()).stacked
    assert kernels._dispatch(torch.device("cuda"), "Tanh", True) is not None
    assert kernels._dispatch(torch.device("cuda"), "ELU", False) is None


# ---- each refusal names its route ------------------------------------------------------------


class _NoRoom:
    """A kernel library whose every block-size query says nothing fits."""

    def __getattr__(self, name):
        return lambda *a: 0 if name.endswith("_rows") else -1


@contextlib.contextmanager
def _as_if_on_the_card(monkeypatch, *modules):
    """The launch wrappers as far as their block-size queries, on CPU
    tensors: no input check, no device context, a library where nothing
    fits."""
    for m in modules:
        monkeypatch.setattr(m, "_check_inputs", lambda *a, **k: None)
        if hasattr(m, "_rows_per_block"):
            monkeypatch.setattr(m, "_rows_per_block", lambda B, dev: 1)
    monkeypatch.setattr(build, "load_library", lambda: _NoRoom())
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    yield


def test_activation_refusal_names_the_route():
    with pytest.raises(ValueError, match=ROUTE):
        kernels._route(torch.device("cuda"), "Tanh")


def test_category_refusals_name_the_route():
    with pytest.raises(ValueError, match=ROUTE):
        recurrence._check_categories(33)
    spec = recurrence_mt.MT_SPEC._replace(ls_category=40)
    with pytest.raises(ValueError, match=ROUTE):
        recurrence_mt._check_spec(spec)


def test_shared_memory_refusals_name_the_route(monkeypatch):
    """The MRSSM forward's and backward chain's block-size refusals
    (``fwd_rows``, ``chain_rows``), the MMTRSSM forward's and backward's,
    and the fused stacks' (``fused_conv._sizes``, ``bf16_sizes``: the
    encoders' route is ``conv_layout='nhwc'``)."""
    lib = _NoRoom()
    monkeypatch.setattr(recurrence, "_rows_per_block", lambda B, dev: 1)
    with pytest.raises(ValueError, match=ROUTE):
        recurrence.fwd_rows(lib, 30, 6, 64, 32, 32, 4, 4, 8, None)
    with pytest.raises(ValueError, match=ROUTE):
        recurrence.chain_rows(lib, 6, 64, 32, 32, 4, 4, 8, None)
    port = MoPoEMMTRSSM(MMTRSSMConfig())
    T, B = 3, 2
    w = port.recurrence_weights()
    cfg = port.cfg
    ins = [torch.zeros(T, B, d) for d in (6, 64, 64)]
    init6 = [torch.zeros(B, d) for d in (32, 32, cfg.hs_dim, cfg.ls_dim, 32, 32)]
    gumbels = [torch.zeros(T, B, d) for d in (cfg.ls_dim, cfg.ls_dim, cfg.hs_dim, cfg.hs_dim)]
    with _as_if_on_the_card(monkeypatch, recurrence_mt):
        with pytest.raises(ValueError, match=ROUTE):
            recurrence_mt.mt_forward_launch(w, *ins, init6, gumbels, cfg.spec)
        outs = recurrence_mt.mt_recurrence_forward_plain(w, *ins, init6, gumbels, cfg.spec)
        carries = recurrence_mt.shift_carries(init6, recurrence_mt.carries(outs))
        with pytest.raises(ValueError, match=ROUTE):
            recurrence_mt.mt_backward_launch(w, *ins, carries, [torch.zeros_like(o) for o in outs],
                                             cfg.spec)
    with pytest.raises(ValueError, match="conv_layout='nhwc'"):
        fused_conv._sizes(lambda dims, out: -1, fused_conv._dims(fused_conv.EncoderConfig(), 8),
                          "encoder")
    with pytest.raises(ValueError, match="conv_layout='nhwc'"):
        fused_conv.bf16_sizes(lib, fused_conv._dims(fused_conv.EncoderConfig(), 8))


# ---- a Tanh model against JAX's XLA scan -----------------------------------------------------


def _batch(seed: int, B: int = 2, T: int = 5):
    rng = np.random.default_rng(seed)
    act = rng.uniform(-1, 1, (B, T, 6)).astype(np.float32)
    audio, vision = (rng.uniform(-1, 1, (B, T, 32, 32, 1)).astype(np.float32) for _ in range(2))
    return act, audio, vision, act, audio, vision


def _jax_step(jmodel, params, batch, key):
    """JAX's ``shared_step`` losses and gradients, jitted."""
    def loss(p):
        d = jmodel.shared_step(p, batch, key)
        return d["loss"], d

    return jax.jit(jax.grad(loss, has_aux=True))(params)


def _port_step(port, batch, noise):
    port.zero_grad(set_to_none=True)
    out = port.shared_step(tuple(map(torch.from_numpy, batch)),
                           {k: torch.from_numpy(v) for k, v in noise.items()})
    out["loss"].backward()
    return ({k: float(v.detach()) for k, v in out.items()},
            {n: p.grad for n, p in port.named_parameters()})


def _assert_step_matches(name: str, activation: str, rtol: float = 2e-5, rel: float = 3e-4,
                         conv_dtype: str | None = None):
    """``shared_step`` of the port's plain route against JAX's XLA scan on
    the same weights, batch and per-step noise: every loss term within
    ``rtol`` (relative), every gradient within ``rel × max(1, max|JAX|)``
    per tensor. Returns the port's losses and gradients."""
    jmodel, params, port, export = scan_family(name, activation, conv_dtype)
    batch = _batch(3)
    key = jax.random.PRNGKey(4)
    grads, ref = _jax_step(jmodel, params, tuple(map(jnp.asarray, batch)), key)
    B, T = batch[0].shape[:2]
    losses, got = _port_step(port, batch, jax_scan_gumbels(key, port.cfg, B, T))
    for k, v in losses.items():
        np.testing.assert_allclose(v, float(ref[k]), rtol=rtol, err_msg=k)
    ref_grads = export(grads)
    assert set(got) == set(ref_grads)
    for n, g in ref_grads.items():
        scale = max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(got[n].numpy(), g, rtol=0, atol=rel * scale, err_msg=n)
    return losses, got


@pytest.mark.parametrize("name", ["mrssm", "mmtrssm"])
def test_tanh_shared_step_matches_jax_scan(name):
    """A Tanh model (the kernels refuse it) on the plain route, against
    JAX's ``use_pallas_train=False`` scan: loss terms and every gradient."""
    kernels.reset_launch_counts()
    _assert_step_matches(name, "Tanh")
    assert kernels.launch_counts() == dict.fromkeys(kernels.LAUNCH_COUNTERS, 0)


# ---- an ELU model: the plain route is the kernel wiring's plain versions ---------------------


@pytest.mark.parametrize("family,cfg_cls", [(MoPoEMRSSM, MRSSMConfig),
                                            (MoPoEMMTRSSM, MMTRSSMConfig)])
def test_elu_plain_route_equals_the_kernel_wiring_on_the_cpu(family, cfg_cls):
    """On the CPU the kernel wiring runs the kernels' plain versions; the
    plain route by name runs the same functions, so a train step and an
    imagination give the same bits."""
    from conftest import small_encoder_config

    enc = fused_conv.EncoderConfig(**dataclasses.asdict(small_encoder_config()))
    kw = dict(audio_encoder=enc, vision_encoder=enc, init_proj_cells=32, input_noise_std=0.0)
    wired = family(cfg_cls(**kw)).init(torch.Generator().manual_seed(2))
    plain = family(cfg_cls(use_pallas_train=False, **kw))
    plain.load_state_dict(wired.state_dict())
    batch = tuple(map(torch.from_numpy, _batch(5)))
    noise = wired.draw_noise(2, 5, torch.Generator().manual_seed(6))
    outs = []
    for model in (wired, plain):
        model.zero_grad(set_to_none=True)
        loss = model.shared_step(batch, noise)["loss"]
        loss.backward()
        with torch.no_grad():
            init = model.initial_state(batch[1][:, 0], batch[2][:, 0],
                                       *(v for k, v in noise.items() if k.startswith("g_init")))
            imagined = model.rollout_transition(batch[0], init, 11)
        outs.append([loss.detach(), *(p.grad for p in model.parameters()),
                     imagined.feature])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_plain_rollout_draws_the_kernels_noise():
    """The plain route's imagination samples on ``philox_gumbel(seed)``,
    the rollout kernel's stream, at any activation."""
    port = MoPoEMRSSM(MRSSMConfig(activation_name="Tanh", use_pallas_train=False))
    port.init(torch.Generator().manual_seed(0))
    w = port.transition.weights()
    B, T = 3, 4
    actions = torch.rand(B, T, 6, generator=torch.Generator().manual_seed(1))
    deter, stoch = torch.zeros(B, 32), torch.zeros(B, 16)
    with torch.no_grad():
        got = kernels.fused_rollout_transition(w, actions, deter, stoch, 9, 4, 4, "Tanh", True)
        ref = rollout.rollout_plain(w, actions, deter, stoch, None, 4, 4,
                                    rollout.philox_gumbel(9, T, B, 4, 4), act=torch.tanh)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


# ---- remat and scan_unroll -----------------------------------------------------------------


def test_remat_and_scan_unroll_from_python():
    cfg = MRSSMConfig(remat=True, scan_unroll=4)
    assert (cfg.remat, cfg.scan_unroll) == (True, 4)
    mt = MMTRSSMConfig(remat=True, scan_unroll=2)
    assert (mt.remat, mt.scan_unroll) == (True, 2)
    for bad in ({"remat": "yes"}, {"scan_unroll": 0}, {"scan_unroll": 1.5},
                {"scan_unroll": True}):
        with pytest.raises(ValueError):
            MRSSMConfig(**bad)
        with pytest.raises(ValueError):
            MMTRSSMConfig(**bad)


@pytest.mark.parametrize("family", ["mrssm", "mmtrssm"])
def test_remat_and_scan_unroll_from_yaml(family):
    exp = load_experiment(REPO / "configs" / f"mopoe_{family}.yaml",
                          {"model": {"init_args": {"remat": True, "scan_unroll": 3,
                                                   "use_pallas_train": False}}})
    assert (exp.model.cfg.remat, exp.model.cfg.scan_unroll) == (True, 3)
    assert exp.model.plain
    plain = load_experiment(REPO / "configs" / f"mopoe_{family}.yaml").model.cfg
    assert (plain.remat, plain.scan_unroll) == (False, 1)


def test_remat_trains_as_without():
    """Both routes already recompute a step from the saved carries, so
    ``remat`` changes no bit of a train step."""
    from conftest import small_encoder_config

    enc = fused_conv.EncoderConfig(**dataclasses.asdict(small_encoder_config()))
    kw = dict(audio_encoder=enc, vision_encoder=enc, init_proj_cells=32, input_noise_std=0.0)
    a = MoPoEMRSSM(MRSSMConfig(**kw)).init(torch.Generator().manual_seed(3))
    b = MoPoEMRSSM(MRSSMConfig(remat=True, scan_unroll=2, **kw))
    b.load_state_dict(a.state_dict())
    batch = tuple(map(torch.from_numpy, _batch(8)))
    noise = a.draw_noise(2, 5, torch.Generator().manual_seed(9))
    grads = []
    for m in (a, b):
        m.shared_step(batch, noise)["loss"].backward()
        grads.append([p.grad for p in m.parameters()])
    assert all(torch.equal(x, y) for x, y in zip(*grads))
