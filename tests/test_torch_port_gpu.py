"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports neither JAX nor the JAX package, so it also runs on a machine with
the card and no JAX, without the JAX-importing ``conftest.py``:

    python -m pytest --noconftest -q -m gpu tests/test_torch_port_gpu.py

Tolerances as in ``chip_smoke.py``: deter and logits within 1e-4, sampled
categories equal outside blocks whose top two scores lie within 1e-5
(``ops/kernels/parity.py``).
"""

import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu_torch.models.mrssm import MoPoEMRSSM
from multimodal_mtrssm_tpu_torch.ops import kernels
from multimodal_mtrssm_tpu_torch.ops.kernels import parity, recurrence, rollout

C, K = 4, 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed: int, B: int, T: int, dev) -> list[torch.Tensor]:
    """Observe-recurrence inputs ``[T, B, ·]`` made by numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    stoch0 = np.zeros((B, C, K), np.float32)
    stoch0[np.arange(B)[:, None], np.arange(C), rng.integers(0, K, (B, C))] = 1.0
    arrays = (rng.uniform(-1, 1, (T, B, 6)), rng.standard_normal((T, B, 64)),
              rng.standard_normal((T, B, 64)), np.tanh(rng.standard_normal((B, 32))),
              stoch0.reshape(B, C * K), rng.gumbel(size=(T, B, C * K)),
              rng.gumbel(size=(T, B, C * K)))
    return [torch.tensor(np.asarray(a, np.float32), device=dev) for a in arrays]


def _model(dev) -> MoPoEMRSSM:
    return MoPoEMRSSM().init(torch.Generator().manual_seed(0)).to(dev).eval()


@pytest.mark.gpu
@pytest.mark.parametrize("B,T", [(8, 30), (3, 7)])
def test_recurrence_kernel_matches_plain(cuda_device, B, T):
    w = _model(cuda_device).representation_weights()
    ins = _inputs(B + T, B, T, cuda_device)
    with torch.no_grad():
        got = recurrence.recurrence_forward_cuda(w, *ins, C, K)
        ref = recurrence.recurrence_forward_plain(w, *ins, C, K)
    parity.check_recurrence(got, ref, ins[5], ins[6], C, K)


@pytest.mark.gpu
@pytest.mark.parametrize("B,T", [(10, 10), (64, 30)])
def test_rollout_kernel_matches_plain(cuda_device, B, T):
    w = _model(cuda_device).transition.weights()
    ins = _inputs(B + T, B, T, cuda_device)
    actions = ins[0].transpose(0, 1).contiguous()
    with torch.no_grad():
        got = rollout.rollout_cuda(w, actions, ins[3], ins[4], 77, C, K)
    parity.check_rollout(w, actions, ins[3], ins[4], 77, got, C, K)


@pytest.mark.gpu
def test_kernels_refuse_tracked_inputs_and_count_launches(cuda_device):
    """Without a backward the kernels refuse inputs autograd would track;
    each launch through the dispatch counts once; a non-ELU model raises."""
    model = _model(cuda_device)
    ins = _inputs(1, 2, 3, cuda_device)
    with pytest.raises(RuntimeError, match="no backward"):
        recurrence.recurrence_forward_cuda(model.representation_weights(), *ins, C, K)
    kernels.reset_launch_counts()
    with torch.no_grad():
        kernels.fused_train_recurrence(model.representation_weights(), *ins, C, K)
        kernels.fused_rollout_transition(model.transition.weights(),
                                         ins[0].transpose(0, 1).contiguous(), ins[3], ins[4], 5)
        with pytest.raises(ValueError, match="ELU"):
            kernels.fused_rollout_transition(model.transition.weights(),
                                             ins[0].transpose(0, 1).contiguous(), ins[3], ins[4],
                                             5, activation_name="Tanh")
    assert kernels.launch_counts() == {"recurrence_fwd": 1, "rollout": 1}
