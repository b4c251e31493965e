"""The port's two kernels (``multimodal_mtrssm_tpu_torch.ops.kernels``)
against the JAX package's Pallas kernels and their references.

On the CPU each kernel's plain PyTorch version is what runs; it is held to
JAX ``reference_train_recurrence`` and to the Pallas kernels in interpret
mode, with inputs and noise made by numpy from a seed and handed to both.
The CUDA kernels themselves are checked against the plain versions by
``tests/test_torch_port_gpu.py`` (marked ``gpu``) and by ``chip_smoke.py``.

Tolerances: 1e-5 absolute for deter and logits (f32, the two frameworks sum
the small matmuls in different orders). Sampled categories are compared
exactly; the straight-through value ``(onehot + p) - p`` may differ from
JAX's by one f32 ulp where ``p`` does, so its values get 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.models.mrssm import MoPoEMRSSM as JaxMoPoEMRSSM
from multimodal_mtrssm_tpu.models.mrssm import MRSSMConfig as JaxMRSSMConfig
from multimodal_mtrssm_tpu.ops.pallas import rollout as jax_rollout
from multimodal_mtrssm_tpu.ops.pallas.train_step import (
    fused_train_recurrence,
    pack_train_params,
    reference_train_recurrence,
)
from multimodal_mtrssm_tpu.train.torch_export import export_reference_state_dict
from multimodal_mtrssm_tpu_torch.models.mrssm import MoPoEMRSSM, MRSSMConfig
from multimodal_mtrssm_tpu_torch.ops import kernels
from multimodal_mtrssm_tpu_torch.ops.kernels import parity, recurrence, rollout
from multimodal_mtrssm_tpu_torch.nn.conv import EncoderConfig
from multimodal_mtrssm_tpu_torch.train.weights import load_reference_state_dict

C, K = 4, 4
S = C * K
ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    """A small JAX model, its params, and the port model with the same
    weights through the weight bridge."""
    from conftest import small_encoder_config

    enc = small_encoder_config()
    jcfg = JaxMRSSMConfig(audio_encoder=enc, vision_encoder=enc, use_pallas_train=False)
    jmodel = JaxMoPoEMRSSM(jcfg)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(3))
    port = MoPoEMRSSM(MRSSMConfig(audio_encoder=_port_enc(enc), vision_encoder=_port_enc(enc)))
    load_reference_state_dict(port, export_reference_state_dict(params))
    return jmodel, params, port.eval()


def _port_enc(jax_enc) -> EncoderConfig:
    """The port's EncoderConfig with the fields of a JAX one."""
    return EncoderConfig(**dataclasses.asdict(jax_enc))


def _recurrence_inputs(seed: int, B: int, T: int, A: int = 6, E: int = 64, D: int = 32):
    rng = np.random.default_rng(seed)
    stoch0 = np.zeros((B, C, K), np.float32)
    stoch0[np.arange(B)[:, None], np.arange(C), rng.integers(0, K, (B, C))] = 1.0
    return [np.asarray(a, np.float32) for a in (
        rng.uniform(-1, 1, (T, B, A)), rng.standard_normal((T, B, E)),
        rng.standard_normal((T, B, E)), np.tanh(rng.standard_normal((B, D))),
        stoch0.reshape(B, S), rng.gumbel(size=(T, B, S)), rng.gumbel(size=(T, B, S)))]


def _assert_stochs(port, ref):
    port, ref = np.asarray(port), np.asarray(ref)
    blocks = lambda x: x.reshape(*x.shape[:-1], C, K)  # noqa: E731
    np.testing.assert_array_equal(blocks(port).argmax(-1), blocks(ref).argmax(-1))
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-6)


def _assert_recurrence(port_outs, jax_outs):
    for i, (p, j) in enumerate(zip(port_outs, jax_outs)):
        if i in (2, 4):
            _assert_stochs(p.numpy(), j)
        else:
            np.testing.assert_allclose(p.numpy(), np.asarray(j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("B,T", [(3, 5), (2, 1), (5, 9)])
def test_plain_recurrence_matches_jax_reference(models, B, T):
    jmodel, params, port = models
    ins = _recurrence_inputs(B * 100 + T, B, T)
    ref = reference_train_recurrence(pack_train_params(params), *map(jnp.asarray, ins),
                                     class_size=C, category_size=K)
    with torch.no_grad():
        got = kernels.fused_train_recurrence(port.representation_weights(),
                                             *map(torch.from_numpy, ins), C, K)
    _assert_recurrence(got, ref)


def test_plain_recurrence_matches_pallas_interpret(models):
    jmodel, params, port = models
    ins = _recurrence_inputs(7, 3, 5)
    ref = fused_train_recurrence(pack_train_params(params), *map(jnp.asarray, ins),
                                 class_size=C, category_size=K, interpret=True)
    with torch.no_grad():
        got = recurrence.recurrence_forward_plain(port.representation_weights(),
                                                  *map(torch.from_numpy, ins), C, K)
    _assert_recurrence(got, ref)


def test_plain_rollout_with_noise_matches_jax_replay(models):
    """Given the same noise, the plain rollout is the JAX transition core
    followed by the kernels' first-index one-hot sweep."""
    jmodel, params, port = models
    B, T = 4, 6
    ins = _recurrence_inputs(11, B, T)
    actions = np.swapaxes(ins[0], 0, 1).copy()
    deter0, stoch0, noise = ins[3], ins[4], ins[5]
    deter, stoch = jnp.asarray(deter0), jnp.asarray(stoch0)
    ref = []
    for t in range(T):
        deter, logits = jmodel._transition_core(params, jnp.asarray(actions[:, t]), stoch, deter)
        stoch = jax_rollout.onehot_blocks(logits + noise[t], C, K)
        ref.append((deter, logits, stoch))
    ref = [np.stack([np.asarray(r[i]) for r in ref], 1) for i in range(3)]
    with torch.no_grad():
        got = rollout.rollout_plain(port.transition.weights(), torch.from_numpy(actions),
                                    torch.from_numpy(deter0), torch.from_numpy(stoch0),
                                    class_size=C, category_size=K,
                                    noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got[0].numpy(), ref[0], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[1].numpy(), ref[1], rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[2].numpy(), ref[2])


def test_pallas_rollout_replays_through_plain_transition(models):
    """The JAX kernel (interpret mode) draws its own samples; fed through
    the port's plain transition, they give the kernel's deters and logits."""
    jmodel, params, port = models
    B, T = 3, 7
    ins = _recurrence_inputs(13, B, T)
    actions = np.swapaxes(ins[0], 0, 1).copy()
    deters, logits, stochs = jax_rollout.fused_rollout_transition(
        jax_rollout.pack_params(params), jnp.asarray(actions), jnp.asarray(ins[3]),
        jnp.asarray(ins[4]), jnp.int32(5), class_size=C, category_size=K, interpret=True)
    with torch.no_grad():
        d, lg = parity.replay_transition(port.transition.weights(), torch.from_numpy(actions),
                                         torch.from_numpy(ins[3]), torch.from_numpy(ins[4]),
                                         torch.from_numpy(np.array(stochs)))
    np.testing.assert_allclose(d.numpy(), np.asarray(deters), rtol=0, atol=ATOL)
    np.testing.assert_allclose(lg.numpy(), np.asarray(logits), rtol=0, atol=ATOL)


@pytest.mark.parametrize("counter,key,expect", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, expect):
    """Random123's philox4x32-10 known-answer vectors."""
    out = rollout.philox4x32_10([torch.tensor([c]) for c in counter], key)
    assert tuple(int(o) for o in out) == expect


def test_uniforms_lie_in_open_interval():
    edge = torch.tensor([0, 1, 511, 512, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF])
    bits = torch.cat([edge, torch.stack(rollout.philox4x32_10(
        [torch.arange(4096), torch.zeros(4096), torch.zeros(4096), torch.zeros(4096)],
        (1, 2))).flatten()])
    u = rollout.uniform_from_bits(bits)
    assert u.dtype == torch.float32
    assert bool((u > 0).all()) and bool((u < 1).all())
    g = rollout.philox_gumbel(9, 30, 8, C, K)
    assert g.shape == (30, 8, S) and bool(torch.isfinite(g).all())


def test_philox_gumbel_is_a_function_of_the_seed():
    a, b = rollout.philox_gumbel(5, 4, 3, C, K), rollout.philox_gumbel(5, 4, 3, C, K)
    assert torch.equal(a, b)
    assert not torch.equal(a, rollout.philox_gumbel(6, 4, 3, C, K))
    big = rollout.philox_gumbel(2**40 + 5, 4, 3, C, K)  # the high key word matters
    assert not torch.equal(a, big)
    # A longer horizon or batch extends the stream without changing its prefix.
    np.testing.assert_array_equal(rollout.philox_gumbel(5, 6, 5, C, K)[:4, :3].numpy(), a.numpy())


def test_plain_rollout_seed_draws_the_philox_stream(models):
    _, _, port = models
    ins = _recurrence_inputs(17, 3, 4)
    actions = torch.from_numpy(np.swapaxes(ins[0], 0, 1).copy())
    deter0, stoch0 = torch.from_numpy(ins[3]), torch.from_numpy(ins[4])
    w = port.transition.weights()
    with torch.no_grad():
        by_seed = rollout.rollout_plain(w, actions, deter0, stoch0, 21, C, K)
        by_noise = rollout.rollout_plain(w, actions, deter0, stoch0, class_size=C,
                                         category_size=K, noise=rollout.philox_gumbel(21, 4, 3, C, K))
        res = parity.check_rollout(w, actions, deter0, stoch0, 21, by_seed, C, K)
    for x, y in zip(by_seed, by_noise):
        assert torch.equal(x, y)
    assert res["max_abs_err"] == 0.0


def test_parity_checks_catch_a_wrong_kernel(models):
    """The checks ``chip_smoke.py`` holds the kernels to reject a wrong output."""
    _, _, port = models
    ins = [torch.from_numpy(a) for a in _recurrence_inputs(19, 4, 6)]
    with torch.no_grad():
        ref = recurrence.recurrence_forward_plain(port.representation_weights(), *ins, C, K)
        ok = parity.check_recurrence(ref, ref, ins[5], ins[6], C, K)
        assert ok["max_abs_err"] == 0.0 and ok["compared"] == 1.0
        bad = list(ref)
        bad[0] = bad[0] + 1e-3
        with pytest.raises(parity.ParityError):
            parity.check_recurrence(bad, ref, ins[5], ins[6], C, K)
        bad = list(ref)
        bad[4] = bad[4].roll(1, dims=-1)
        with pytest.raises(parity.ParityError):
            parity.check_recurrence(bad, ref, ins[5], ins[6], C, K)
        actions = ins[0].transpose(0, 1).contiguous()
        w = port.transition.weights()
        out = rollout.rollout_plain(w, actions, ins[3], ins[4], 3, C, K)
        flipped = (out[0], out[1], out[2].roll(1, dims=-1))
        with pytest.raises(parity.ParityError):
            parity.check_rollout(w, actions, ins[3], ins[4], 3, flipped, C, K)


def test_cuda_routes_refuse_what_the_kernels_do_not_take():
    """A non-ELU model raises on CUDA instead of taking the plain path, and
    the CUDA wrappers refuse CPU tensors without counting a launch."""
    from conftest import small_encoder_config

    with pytest.raises(ValueError, match="ELU"):
        kernels._route(torch.device("cuda"), "Tanh")
    with pytest.raises(ValueError, match="no kernel route"):
        kernels._route(torch.device("meta"), "ELU")
    kernels.reset_launch_counts()
    model = MoPoEMRSSM(MRSSMConfig(audio_encoder=_port_enc(small_encoder_config()),
                                   vision_encoder=_port_enc(small_encoder_config())))
    ins = [torch.from_numpy(a) for a in _recurrence_inputs(23, 2, 3)]
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        recurrence.recurrence_forward_cuda(model.representation_weights(), *ins, C, K)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors"):
        rollout.rollout_cuda(model.transition.weights(), ins[0].transpose(0, 1).contiguous(),
                             ins[3], ins[4], 1, C, K)
    assert kernels.launch_counts() == dict.fromkeys(kernels.LAUNCH_COUNTERS, 0)
