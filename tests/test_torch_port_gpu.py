"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device. The file
imports neither JAX nor the JAX package, so it also runs on a machine with
the card and no JAX, without the JAX-importing ``conftest.py``:

    python -m pytest --noconftest -q -m gpu tests/test_torch_port_gpu.py

The MoPoE-MRSSM kernels, the MoPoE-MMTRSSM kernels (hierarchical
recurrence forward and backward, hierarchical rollout), the stacked
recurrence kernels, the fused encoder kernels and the fused decoder kernels
alike. Tolerances as in ``chip_smoke.py``: deters, integrators and logits
within 1e-4, sampled categories equal outside blocks whose top two scores
lie within 1e-5 (``ops/kernels/parity.py``); backward gradients, and the
recurrence backward's records pass by pass, within 2e-4 × max(1, max|plain|)
per tensor; encoder embeddings within 1e-4 ×
max(1, max|plain|) (f32 sums over up to 576 taps in another order); decoder
frames within 1e-5 (after the Tanh); a whole train step's loss terms within
2e-5 of the loss and its gradient tree within 3e-4 × scale of the CPU
route. A mid-epoch resume on the card ends within 3e-4 × max(1, max|w|)
per tensor of the uninterrupted fit; the evaluation's digits on the card
equal the CPU path's outside near-ties of 1e-5. B=60 T=10 is one
evaluated word's rollout (6 intervals × 10 predictions, 10 frames). The
cross-modal GIF batch's reconstructions (7 episodes × 30 frames) equal the
CPU path's states and frames within 1e-4 before each row's first near-tie;
a mid-epoch resume under random modality dropout ends bit-identical.
K-step dispatch: each training route's fit at K=auto, its steps replays of
a captured CUDA graph, equals its eager K=1 fit bit for bit under
deterministic cuDNN, and so does a device-resident fit and a fit resumed
from a SIGTERM inside a graphed chunk.
"""

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu_torch.models.mmtrssm import MMTRSSMConfig, MoPoEMMTRSSM
from multimodal_mtrssm_tpu_torch.models.mrssm import MoPoEMRSSM, MRSSMConfig
from multimodal_mtrssm_tpu_torch.ops import kernels
from multimodal_mtrssm_tpu_torch.ops.kernels import (
    fused_conv,
    parity,
    recurrence,
    recurrence_mt,
    recurrence_stacked,
    rollout,
    rollout_mt,
)

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


def _cotangents(seed: int, outs) -> list[torch.Tensor]:
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(tuple(o.shape)).astype(np.float32), device=o.device)
            for o in outs]


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 7, 30])
@pytest.mark.parametrize("B", [1, 3, 8, 32, 128, 256, 512])
def test_recurrence_kernel_matches_plain(cuda_device, B, T):
    """The forward kernel against its plain version, two launches
    bit-identical; B=256 puts two batch rows in a block, B=512 four."""
    w = _model(cuda_device).representation_weights()
    ins = _inputs(B + T, B, T, cuda_device)
    with torch.no_grad():
        got = recurrence.recurrence_forward_cuda(w, *ins, C, K)
        again = recurrence.recurrence_forward_cuda(w, *ins, C, K)
        ref = recurrence.recurrence_forward_plain(w, *ins, C, K)
    parity.check_recurrence(got, ref, ins[5], ins[6], C, K)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("B,T", [(10, 10), (64, 30), (256, 180), (3, 1), (60, 10)])
def test_rollout_kernel_matches_plain(cuda_device, B, T):
    """The rollout kernel against the plain transition replaying its stochs,
    which must be the argmax of its logits plus the seed's noise; two
    launches bit-identical."""
    w = _model(cuda_device).transition.weights()
    ins = _inputs(B + T, B, T, cuda_device)
    actions = ins[0].transpose(0, 1).contiguous()
    with torch.no_grad():
        got = rollout.rollout_cuda(w, actions, ins[3], ins[4], 77, C, K)
        again = rollout.rollout_cuda(w, actions, ins[3], ins[4], 77, C, K)
    parity.check_rollout(w, actions, ins[3], ins[4], 77, got, C, K)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _straight_through(rng, B: int, classes: int, k: int, dev) -> torch.Tensor:
    """``(onehot + p) - p`` of random logits in float32: the straight-through
    stoch an observe hands to imagine, not exactly one-hot."""
    logits = torch.tensor(rng.standard_normal((B, classes, k)).astype(np.float32), device=dev)
    p = torch.softmax(logits, -1)
    onehot = torch.nn.functional.one_hot(logits.argmax(-1), k).float()
    return ((onehot + p) - p).reshape(B, classes * k)


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,T", [("model", 8, 30), ("odd", 8, 30), ("odd", 3, 7),
                                      ("odd", 256, 30), ("s40", 64, 30)])
def test_rollout_kernel_at_other_widths(cuda_device, name, B, T):
    """The rollout kernel at widths whose weights are no multiple of 4 floats
    (and off 16-byte alignment), 3 × 5 categories and a latent wider than a
    warp, from a straight-through initial stoch (not one-hot: the first step
    takes the dense product): against the replay, two launches
    bit-identical."""
    widths = FWD_WIDTHS.get(name, (6, 64, 32, 32, C, K))
    w, actions, *_, deter0, _, _, _, Cw, Kw = _forward_case(B + T, widths, B, T, cuda_device)
    stoch0 = _straight_through(np.random.default_rng(B), B, Cw, Kw, cuda_device)
    assert not bool(((stoch0 == 0) | (stoch0 == 1)).all())
    actions = actions.transpose(0, 1).contiguous()
    with torch.no_grad():
        got = rollout.rollout_cuda(w[:12], actions, deter0, stoch0, 91, Cw, Kw)
        again = rollout.rollout_cuda(w[:12], actions, deter0, stoch0, 91, Cw, Kw)
    parity.check_rollout(w[:12], actions, deter0, stoch0, 91, got, Cw, Kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,T", [("model", 8, 30), ("model", 256, 180), ("odd", 3, 7)])
def test_rollout_stages_match_their_plain_stages(cuda_device, name, B, T):
    """The prologue alone, on a workspace of NaN: its action sums within
    1e-5 of the plain prologue's and its Gumbel scores equal to
    ``philox_gumbel`` on the card bit for bit; the chain alone on that
    workspace gives the whole launch's outputs bit for bit; one, two and
    three batch rows a block each pass the replay."""
    widths = FWD_WIDTHS.get(name, (6, 64, 32, 32, C, K))
    w, actions, *_, deter0, stoch0, _, _, Cw, Kw = _forward_case(B + T, widths, B, T, cuda_device)
    w, actions = w[:12], actions.transpose(0, 1).contiguous()
    H, S = w[0].shape[0], Cw * Kw
    with torch.no_grad():
        whole, _ = rollout.rollout_launch(w, actions, deter0, stoch0, 13, Cw, Kw)
        ws = torch.full((T, B, H + S), float("nan"), device=cuda_device)
        outs, _ = rollout.rollout_launch(w, actions, deter0, stoch0, 13, Cw, Kw, stages=1,
                                         workspace=ws)
        ref = rollout.rollout_inputs_plain(w, actions, 13, Cw, Kw)
        assert float((ws[..., :H] - ref[..., :H]).abs().max()) <= 1e-5
        assert torch.equal(ws[..., H:], rollout.philox_gumbel(13, T, B, Cw, Kw, cuda_device))
        outs, _ = rollout.rollout_launch(w, actions, deter0, stoch0, 13, Cw, Kw, stages=2,
                                         workspace=ws)
        assert all(torch.equal(a, b) for a, b in zip(outs, whole))
        for R in (1, 2, 3):
            got, _ = rollout.rollout_launch(w, actions, deter0, stoch0, 13, Cw, Kw, rows=R)
            parity.check_rollout(w, actions, deter0, stoch0, 13, got, Cw, Kw)


@pytest.mark.gpu
def test_rollout_stays_in_its_workspace(cuda_device):
    """The kernel reads and writes its workspace ``[T, B, H + S]`` and no
    float past it: on a view of a larger buffer whose tail holds NaN, the
    tail stays NaN and the outputs are those of a call on its own workspace,
    bit for bit."""
    w, actions, *_, deter0, stoch0, _, _, Cw, Kw = _forward_case(7, FWD_WIDTHS["odd"], 3, 7,
                                                                 cuda_device)
    w, actions = w[:12], actions.transpose(0, 1).contiguous()
    n = 7 * 3 * (w[0].shape[0] + Cw * Kw)
    big = torch.full((n + 257,), float("nan"), device=cuda_device)
    with torch.no_grad():
        ref, _ = rollout.rollout_launch(w, actions, deter0, stoch0, 3, Cw, Kw)
        got, ws = rollout.rollout_launch(w, actions, deter0, stoch0, 3, Cw, Kw,
                                         workspace=big[:n].view(7, 3, -1))
    assert ws.data_ptr() == big.data_ptr()
    assert bool(big[n:].isnan().all()) and not bool(big[:n].isnan().any())
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("B,T", [(8, 30), (3, 7), (128, 30), (8, 1), (256, 30)])
def test_recurrence_backward_kernel_matches_plain(cuda_device, B, T):
    """The backward kernels against their plain version on one forward record
    and random cotangents on all five outputs; the kernels are reproducible.
    B=256 puts two batch rows in a chain block."""
    w = _model(cuda_device).representation_weights()
    ins = _inputs(B * T, B, T, cuda_device)
    with torch.no_grad():
        outs = recurrence.recurrence_forward_cuda(w, *ins, C, K)
        prev_deter = torch.cat([ins[3][None], outs[0][:-1]])
        prev_stoch = torch.cat([ins[4][None], outs[4][:-1]])
        args = (w, *ins[:3], prev_deter, prev_stoch, _cotangents(T, outs), C, K)
        got = recurrence.recurrence_backward_cuda(*args)
        again = recurrence.recurrence_backward_cuda(*args)
    ref = recurrence.recurrence_backward_plain(*args)
    parity.check_gradients(got, ref)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# Widths of the recurrence's cases beyond the model's: A, E, H, D, C, K
# (records and weights no multiple of 4 floats and 3 × 5 categories; 32
# categories a class; a latent of 5 × 8, wider than a warp).
BWD_WIDTHS = {"odd": (5, 63, 33, 17, 3, 5), "k32": (6, 64, 32, 32, 2, 32)}
FWD_WIDTHS = {"odd": BWD_WIDTHS["odd"], "s40": (6, 64, 32, 32, 5, 8)}


def _forward_case(seed: int, widths, B: int, T: int, dev):
    """Random weights (torch layout, odd ones one float off 16-byte
    alignment), inputs and noise at ``widths``, made by numpy: the forward's
    arguments."""
    A, E, H, D, Cw, Kw = widths
    S = Cw * Kw
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    w = []
    for i, s in enumerate(recurrence.weight_shapes(A, S, H, D, E)):
        x = rng.uniform(-1, 1, s) / np.sqrt(s[-1] if len(s) == 2 else H)
        flat = torch.zeros(int(np.prod(s)) + i % 2, device=dev)  # odd i: one float in
        flat[i % 2:] = t(x).reshape(-1)
        w.append(flat[i % 2:].view(s))
    stoch0 = np.zeros((B, Cw, Kw), np.float32)
    stoch0[np.arange(B)[:, None], np.arange(Cw), rng.integers(0, Kw, (B, Cw))] = 1.0
    ins = [t(a) for a in (rng.uniform(-1, 1, (T, B, A)), rng.standard_normal((T, B, E)),
                          rng.standard_normal((T, B, E)), np.tanh(rng.standard_normal((B, D))),
                          stoch0.reshape(B, S), rng.gumbel(size=(T, B, S)),
                          rng.gumbel(size=(T, B, S)))]
    return (w, *ins, Cw, Kw)


def _backward_case(seed: int, widths, B: int, T: int, dev):
    """:func:`_forward_case`'s weights and inputs, the plain forward's
    record and cotangents at ``widths``: the backward's arguments."""
    w, *ins, Cw, Kw = _forward_case(seed, widths, B, T, dev)
    with torch.no_grad():
        outs = recurrence.recurrence_forward_plain(w, *ins, Cw, Kw)
    prev_deter = torch.cat([ins[3][None], outs[0][:-1]])
    prev_stoch = torch.cat([ins[4][None], outs[4][:-1]])
    return (w, *ins[:3], prev_deter, prev_stoch, _cotangents(seed, outs), Cw, Kw)


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,T", [("odd", 8, 30), ("odd", 3, 7), ("odd", 256, 30),
                                      ("s40", 8, 30), ("s40", 128, 30), ("s40", 3, 1)])
def test_recurrence_kernel_at_other_widths(cuda_device, name, B, T):
    """The forward kernel at widths whose weights are no multiple of 4
    floats (and off 16-byte alignment), 3 × 5 categories, and at a latent
    wider than a warp (the fusion's and sampling's lanes loop): against its
    plain version, two launches bit-identical."""
    args = _forward_case(B + T, FWD_WIDTHS[name], B, T, cuda_device)
    with torch.no_grad():
        got = recurrence.recurrence_forward_cuda(*args)
        again = recurrence.recurrence_forward_cuda(*args)
        ref = recurrence.recurrence_forward_plain(*args)
    parity.check_recurrence(got, ref, args[6], args[7], *args[8:])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_recurrence_forward_stays_in_its_workspace(cuda_device):
    """The kernel reads and writes its workspace ``[T, B, 3H]`` and no float
    past it: on a view of a larger buffer whose tail holds NaN, the tail
    stays NaN and the outputs are those of a call on its own workspace, bit
    for bit."""
    args = _forward_case(7, FWD_WIDTHS["odd"], 3, 7, cuda_device)
    H = args[0][0].shape[0]
    n = 7 * 3 * 3 * H
    big = torch.full((n + 257,), float("nan"), device=cuda_device)
    with torch.no_grad():
        ref, _ = recurrence.forward_launch(*args)
        got, ws = recurrence.forward_launch(*args, workspace=big[:n].view(7, 3, 3 * H))
    assert ws.data_ptr() == big.data_ptr()
    assert bool(big[n:].isnan().all()) and not bool(big[:n].isnan().any())
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,T", [("model", 8, 30), ("model", 128, 30), ("odd", 3, 7),
                                      ("s40", 8, 30)])
def test_recurrence_forward_stages_match_their_plain_stages(cuda_device, name, B, T):
    """Each stage of the forward kernel alone against its plain stage on the
    same input: the prologue's workspace (within 1e-4); the chain on the
    plain prologue's sums (deter, mixed logits and the posterior sample, held
    with the plain stages' priors by ``check_recurrence``), leaving the
    prior's outputs as they were; the epilogue on the plain chain's deters."""
    if name == "model":
        args = (_model(cuda_device).representation_weights(),
                *_inputs(B + T, B, T, cuda_device), C, K)
    else:
        args = _forward_case(B + T, FWD_WIDTHS[name], B, T, cuda_device)
    w, actions, a_emb, v_emb, _, _, g_prior, g_post, Cw, Kw = args
    chain_i, prior_i = (0, 3, 4), (1, 2)
    with torch.no_grad():
        ref = recurrence.recurrence_forward_stages_plain(*args)
        inputs = recurrence.fwd_inputs_plain(w, actions, a_emb, v_emb)
        _, ws = recurrence.forward_launch(*args, stages=1)
        assert float((ws - inputs).abs().max()) <= 1e-4
        outs = [torch.full_like(r, float("nan")) for r in ref]
        chain, _ = recurrence.forward_launch(*args, stages=2, workspace=inputs.clone(), outs=outs)
        assert all(bool(chain[i].isnan().all()) for i in prior_i)
        parity.check_recurrence([chain[i] if i in chain_i else ref[i] for i in range(5)], ref,
                                g_prior, g_post, Cw, Kw)
        outs = [r.clone() if i == 0 else torch.full_like(r, float("nan"))
                for i, r in enumerate(ref)]
        priors, _ = recurrence.forward_launch(*args, stages=4, outs=outs)
        assert all(bool(priors[i].isnan().all()) for i in (3, 4))
        parity.check_recurrence([priors[i] if i in prior_i else ref[i] for i in range(5)], ref,
                                g_prior, g_post, Cw, Kw)


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,T", [("odd", 8, 30), ("odd", 3, 7), ("k32", 8, 30)])
def test_recurrence_backward_kernel_at_other_widths(cuda_device, name, B, T):
    """The backward kernels at widths whose records and weights are no
    multiple of 4 floats (weights off 16-byte alignment too), and at 32
    categories a class: within the limits above, reproducible."""
    args = _backward_case(B + T, BWD_WIDTHS[name], B, T, cuda_device)
    with torch.no_grad():
        got = recurrence.recurrence_backward_cuda(*args)
        again = recurrence.recurrence_backward_cuda(*args)
    parity.check_gradients(got, recurrence.recurrence_backward_plain(*args))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,T", [("model", 8, 30), ("model", 128, 30), ("odd", 3, 7)])
def test_recurrence_backward_passes_match_their_plain_passes(cuda_device, name, B, T):
    """Each of the backward's three kernels alone against its plain pass on
    the same input: the recompute's records, the chain's cotangents and
    initial-state gradients on the plain recompute's records, the deferred
    GEMMs (weight gradients, input cotangents) on the plain chain's records
    (every field and gradient within 2e-4 × max(1, max|plain|))."""
    if name == "model":
        w = _model(cuda_device).representation_weights()
        ins = _inputs(B + T, B, T, cuda_device)
        with torch.no_grad():
            outs = recurrence.recurrence_forward_cuda(w, *ins, C, K)
        args = (w, *ins[:3], torch.cat([ins[3][None], outs[0][:-1]]),
                torch.cat([ins[4][None], outs[4][:-1]]), _cotangents(T, outs), C, K)
        H, D, Cw, Kw = 32, 32, C, K
    else:
        args = _backward_case(B + T, BWD_WIDTHS[name], B, T, cuda_device)
        H, D, Cw, Kw = BWD_WIDTHS[name][2:]
    weights, actions, a_emb, v_emb, prev_deter, prev_stoch = args[:6]
    N, S = T * B, Cw * Kw
    lay = recurrence.bwd_record_layout(H, D, S)
    with torch.no_grad():
        crec, xrec, dyrec = recurrence.recurrence_bwd_recompute_plain(*args)
        _, ws = recurrence.backward_launch(*args, passes=1)
        k_c, k_x, k_y = recurrence.bwd_workspace_records(ws, N, H, D, S)
        parity.check_gradients([recurrence.record_field(k, lay[r][1], f)
                                for k, r in ((k_c, "chain"), (k_x, "x")) for f in lay[r][1]],
                               [recurrence.record_field(p, lay[r][1], f)
                                for p, r in ((crec, "chain"), (xrec, "x")) for f in lay[r][1]])
        prior = (slice(None), slice(0, S))
        parity.check_gradients([recurrence.record_field(k_y, lay["dy"][1], "dlg")[prior]],
                               [recurrence.record_field(dyrec, lay["dy"][1], "dlg")[prior]])
        k_c.copy_(crec)
        k_x.copy_(xrec)
        k_y.copy_(dyrec)
        chain, _ = recurrence.backward_launch(*args, passes=2, workspace=ws)
        p_y, *p_init = recurrence.recurrence_bwd_chain_plain(weights, crec, dyrec, T, B, Cw, Kw)
        parity.check_gradients([k_y, *chain[-2:]], [p_y, *p_init])
        k_y.copy_(p_y)
        dw, _ = recurrence.backward_launch(*args, passes=4, workspace=ws)
        parity.check_gradients(dw[:-2], recurrence.recurrence_bwd_dw_plain(
            weights, actions, a_emb, v_emb, prev_deter, prev_stoch, xrec, p_y))


def _digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def mrssm_backward_digest(dev) -> str:
    """The digest of the MRSSM backward's 25 outputs at B=8 T=30 on the
    model's weights, seeded inputs and cotangents, fed with the plain
    forward's record (so that it does not move with the forward kernel)."""
    w = _model(dev).representation_weights()
    ins = _inputs(240, 8, 30, dev)
    with torch.no_grad():
        outs = recurrence.recurrence_forward_plain(w, *ins, C, K)
        args = (w, *ins[:3], torch.cat([ins[3][None], outs[0][:-1]]),
                torch.cat([ins[4][None], outs[4][:-1]]), _cotangents(30, outs), C, K)
        return _digest(recurrence.recurrence_backward_cuda(*args))


def mrssm_rollout_digest(dev) -> str:
    """The digest of the MRSSM rollout's outputs at B=8 T=30 on the model's
    weights, seeded actions and initial state."""
    w = _model(dev).transition.weights()
    ins = _inputs(240, 8, 30, dev)
    with torch.no_grad():
        return _digest(rollout.rollout_cuda(w, ins[0].transpose(0, 1).contiguous(), ins[3],
                                            ins[4], 77, C, K))


# mrssm_backward_digest on an NVIDIA H100 80GB HBM3, taken with the MRSSM
# backward as it stood before the MRSSM forward's redesign (as it stood since
# its chain and staging helpers moved into csrc/chain_common.cuh).
MRSSM_BWD_DIGEST = "487a700ee7d1d98cd462729989b44db838c4cb1db0f93b74768d601ff58d45c4"
# mrssm_rollout_digest on an NVIDIA H100 80GB HBM3, taken on the rollout in
# stages (csrc/rollout.cu).
MRSSM_ROLLOUT_DIGEST = "cfed4385e15d6578e84ee547986f7cd3fc319a1741e04197cbf26ec1fc2c6ff8"


@pytest.mark.gpu
def test_recurrence_backward_bits_unchanged_by_the_shared_helpers(cuda_device):
    """The MRSSM backward's three kernels give the bits they gave before the
    forward's redesign: the helpers they share with the forwards and the
    rollouts did not change what they compute."""
    assert mrssm_backward_digest(cuda_device) == MRSSM_BWD_DIGEST


@pytest.mark.gpu
def test_rollout_bits_pinned(cuda_device):
    """The MRSSM rollout gives the bits pinned for it: a change of the
    helpers it shares with the other kernels shows here."""
    assert mrssm_rollout_digest(cuda_device) == MRSSM_ROLLOUT_DIGEST


def _train_step_card_vs_cpu(family, cfg, dev, tie_eps: float = 1e-5, rtol: float = 2e-5,
                            rel: float = 3e-4, shape: tuple[int, int] = (4, 10),
                            seeds: int = 10) -> None:
    """One ``shared_step`` and backward of ``family(cfg)`` on the card
    against the CPU (plain versions) with the same weights, batch and noise
    (``parity.check_train_step`` at ``rtol`` and ``rel``); noise with Gumbel
    near-ties of ``tie_eps`` is skipped for the next seed."""
    cpu = family(cfg).init(torch.Generator().manual_seed(1))
    gpu = family(cfg).to(dev)
    gpu.load_state_dict(cpu.state_dict())
    B, T = shape
    for seed in range(seeds):
        rng = np.random.default_rng(seed)
        act = rng.uniform(-1, 1, (B, T, 6)).astype(np.float32)
        frames = [rng.uniform(-1, 1, (B, T, 32, 32, 1)).astype(np.float32) for _ in range(2)]
        batch = tuple(torch.from_numpy(x) for x in (act, *frames, act, *frames))
        noise = {k: torch.from_numpy(rng.gumbel(size=s).astype(np.float32))
                 for k, s in cpu.noise_shapes(B, T).items()}
        noise["input"] = tuple(torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
                               for x in batch[:3])
        if parity.train_step_near_ties(cpu, batch, noise, tie_eps) == 0:
            break
    kernels.reset_launch_counts()
    on_card = (tuple(x.to(dev) for x in batch),
               {k: v.to(dev) if k != "input" else tuple(x.to(dev) for x in v)
                for k, v in noise.items()})
    parity.check_train_step(gpu, cpu, on_card, (batch, noise), rtol, rel)


@pytest.mark.gpu
def test_train_step_on_the_kernels_matches_the_cpu_route(cuda_device):
    _train_step_card_vs_cpu(MoPoEMRSSM, MRSSMConfig(), cuda_device)
    assert kernels.launch_counts() == {**dict.fromkeys(kernels.LAUNCH_COUNTERS, 0),
                                      "recurrence_fwd": 1, "recurrence_bwd": 1}


@pytest.mark.gpu
def test_kernels_refuse_tracked_inputs_and_count_launches(cuda_device):
    """The wrappers alone are not differentiable, so they refuse inputs
    autograd would track; each launch through the dispatch counts once; a
    non-ELU model raises."""
    model = _model(cuda_device)
    ins = _inputs(1, 2, 3, cuda_device)
    with pytest.raises(RuntimeError, match="not differentiable"):
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
    assert kernels.launch_counts() == {**dict.fromkeys(kernels.LAUNCH_COUNTERS, 0),
                                      "recurrence_fwd": 1, "rollout": 1}


# ---- MoPoE-MMTRSSM -----------------------------------------------------------------


def _mt_inputs(seed: int, B: int, T: int, dev):
    """Hierarchical-recurrence inputs ``[T, B, ·]``, ``init6`` and the four
    sites' Gumbel noise, made by numpy from ``seed``."""
    rng = np.random.default_rng(seed)

    def onehot(c, k):
        x = np.zeros((B, c, k), np.float32)
        x[np.arange(B)[:, None], np.arange(c), rng.integers(0, k, (B, c))] = 1.0
        return x.reshape(B, c * k)

    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    xs = [t(rng.uniform(-1, 1, (T, B, 6))), t(rng.standard_normal((T, B, 64))),
          t(rng.standard_normal((T, B, 64)))]
    hd, ld = np.tanh(rng.standard_normal((B, 32))), np.tanh(rng.standard_normal((B, 32)))
    init6 = [t(hd), t(ld), t(onehot(2, 8)), t(onehot(4, 4)), t(np.arctanh(0.9 * hd)),
             t(np.arctanh(0.9 * ld))]
    gumbels = [t(rng.gumbel(size=(T, B, 16))) for _ in range(4)]
    return xs, init6, gumbels


def _mt_model(dev) -> MoPoEMMTRSSM:
    return MoPoEMMTRSSM().init(torch.Generator().manual_seed(0)).to(dev).eval()


@pytest.mark.gpu
@pytest.mark.parametrize("B,T", [(8, 30), (32, 30), (3, 7), (128, 30), (256, 30), (512, 30)])
def test_mt_recurrence_kernel_matches_plain(cuda_device, B, T):
    """The forward kernel against its plain version, two launches
    bit-identical; B=256 puts two batch rows in a block, B=512 four (no warp
    left idle in phase (c): the next step comes in at the step's start)."""
    w = _mt_model(cuda_device).recurrence_weights()
    xs, init6, gumbels = _mt_inputs(B + T, B, T, cuda_device)
    with torch.no_grad():
        got = recurrence_mt.mt_recurrence_forward_cuda(w, *xs, init6, gumbels)
        again = recurrence_mt.mt_recurrence_forward_cuda(w, *xs, init6, gumbels)
        ref = recurrence_mt.mt_recurrence_forward_plain(w, *xs, init6, gumbels)
    parity.check_mt_recurrence(got, ref, gumbels)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("B,T", [(8, 30), (3, 7), (32, 30), (128, 30), (256, 30)])
def test_mt_recurrence_backward_kernel_matches_plain(cuda_device, B, T):
    """The backward kernels against their plain version on one forward record
    and random cotangents on all 12 outputs; the kernels are reproducible,
    and both MTRNN cells' two bias gradients are bit-equal. B=256 puts two
    batch rows in a chain block."""
    w = _mt_model(cuda_device).recurrence_weights()
    xs, init6, gumbels = _mt_inputs(B * T, B, T, cuda_device)
    with torch.no_grad():
        outs = recurrence_mt.mt_recurrence_forward_cuda(w, *xs, init6, gumbels)
        prev6 = recurrence_mt.shift_carries(init6, recurrence_mt.carries(outs))
        args = (w, *xs, prev6, _cotangents(T, outs))
        got = recurrence_mt.mt_recurrence_backward_cuda(*args)
        again = recurrence_mt.mt_recurrence_backward_cuda(*args)
    ref = recurrence_mt.mt_recurrence_backward_plain(*args)
    parity.check_gradients(got, ref)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[1], got[3]) and torch.equal(got[5], got[7])


# Widths of the MT kernels' cases beyond the model's: A, E, HD, LD, C, R
# and the latents' class × category (HD ≠ LD, records and weights no
# multiple of 4 floats; "ls40": a lower latent of 5 × 8, a higher of 3 × 12,
# both wider than a warp).
MT_BWD_WIDTHS = {"odd": (5, 63, 17, 33, 19, 13, recurrence_mt.MTSpec(2.0, 3.0, 3, 5, 2, 7))}
MT_FWD_WIDTHS = {**MT_BWD_WIDTHS,
                 "ls40": (6, 64, 32, 32, 32, 32, recurrence_mt.MTSpec(2.0, 4.0, 5, 8, 3, 12))}


def _mt_forward_case(seed: int, widths, B: int, T: int, dev):
    """Random weights (torch layout, odd ones one float off 16-byte
    alignment), inputs, ``init6`` and noise at ``widths``, made by numpy:
    the forward's arguments."""
    A, E, HD, LD, Cw, Rw, spec = widths
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    w = []
    for i, s in enumerate(recurrence_mt.mt_weight_shapes(A, E, HD, LD, Cw, Rw, spec)):
        x = rng.uniform(-1, 1, s) / np.sqrt(s[-1] if len(s) == 2 else Cw)
        flat = torch.zeros(int(np.prod(s)) + i % 2, device=dev)  # odd i: one float in
        flat[i % 2:] = t(x).reshape(-1)
        w.append(flat[i % 2:].view(s))

    def onehot(c, k):
        x = np.zeros((B, c, k), np.float32)
        x[np.arange(B)[:, None], np.arange(c), rng.integers(0, k, (B, c))] = 1.0
        return x.reshape(B, c * k)

    xs = [t(rng.uniform(-1, 1, (T, B, A))), t(rng.standard_normal((T, B, E))),
          t(rng.standard_normal((T, B, E)))]
    hd, ld = np.tanh(rng.standard_normal((B, HD))), np.tanh(rng.standard_normal((B, LD)))
    init6 = [t(hd), t(ld), t(onehot(spec.hs_class, spec.hs_category)),
             t(onehot(spec.ls_class, spec.ls_category)), t(np.arctanh(0.9 * hd)),
             t(np.arctanh(0.9 * ld))]
    gumbels = [t(rng.gumbel(size=(T, B, d))) for d in (spec.ls, spec.ls, spec.hs, spec.hs)]
    return (w, *xs, init6, gumbels, spec)


def _mt_backward_case(seed: int, widths, B: int, T: int, dev):
    """:func:`_mt_forward_case`'s weights and inputs, the plain forward's
    record and cotangents at ``widths``: the backward's arguments."""
    w, *xs, init6, gumbels, spec = _mt_forward_case(seed, widths, B, T, dev)
    with torch.no_grad():
        outs = recurrence_mt.mt_recurrence_forward_plain(w, *xs, init6, gumbels, spec)
    prev6 = recurrence_mt.shift_carries(init6, recurrence_mt.carries(outs))
    return (w, *xs, prev6, _cotangents(seed, outs), spec)


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,T", [("odd", 8, 30), ("odd", 3, 7), ("odd", 256, 30),
                                      ("ls40", 8, 30), ("ls40", 128, 30)])
def test_mt_recurrence_kernel_at_other_widths(cuda_device, name, B, T):
    """The forward kernel at widths whose weights are no multiple of 4
    floats (and off 16-byte alignment), HD ≠ LD, 3 × 5 and 2 × 7 categories,
    and at latents wider than a warp (the fusion's and sampling's lanes
    loop): against its plain version, two launches bit-identical."""
    args = _mt_forward_case(B + T, MT_FWD_WIDTHS[name], B, T, cuda_device)
    with torch.no_grad():
        got = recurrence_mt.mt_recurrence_forward_cuda(*args)
        again = recurrence_mt.mt_recurrence_forward_cuda(*args)
        ref = recurrence_mt.mt_recurrence_forward_plain(*args)
    parity.check_mt_recurrence(got, ref, args[5], args[6])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
def test_mt_recurrence_forward_stays_in_its_workspace(cuda_device):
    """The kernel reads and writes its workspace ``[T, B, LD + 2R]`` and no
    float past it: on a view of a larger buffer whose tail holds NaN, the
    tail stays NaN and the outputs are those of a call on its own
    workspace, bit for bit."""
    w, *xs, init6, gumbels, spec = _mt_forward_case(7, MT_FWD_WIDTHS["odd"], 3, 7, cuda_device)
    LD, R = w[0].shape[0], w[20].shape[0]
    n = 7 * 3 * (LD + 2 * R)
    big = torch.full((n + 257,), float("nan"), device=cuda_device)
    with torch.no_grad():
        ref, _ = recurrence_mt.mt_forward_launch(w, *xs, init6, gumbels, spec)
        got, ws = recurrence_mt.mt_forward_launch(w, *xs, init6, gumbels, spec,
                                                  workspace=big[:n].view(7, 3, LD + 2 * R))
    assert ws.data_ptr() == big.data_ptr()
    assert bool(big[n:].isnan().all()) and not bool(big[:n].isnan().any())
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,T", [("model", 8, 30), ("model", 128, 30), ("odd", 3, 7),
                                      ("ls40", 8, 30)])
def test_mt_recurrence_forward_stages_match_their_plain_stages(cuda_device, name, B, T):
    """Each stage of the forward kernel alone against its plain stage on the
    same input: the prologue's workspace (within 1e-4); the chain on the
    plain prologue's sums (its eight outputs, held with the plain stages'
    priors by ``check_mt_recurrence``), leaving the priors' outputs as they
    were; the epilogue on the plain chain's deters."""
    if name == "model":
        w = _mt_model(cuda_device).recurrence_weights()
        xs, init6, gumbels = _mt_inputs(B + T, B, T, cuda_device)
        args = (w, *xs, init6, gumbels, recurrence_mt.MT_SPEC)
    else:
        args = _mt_forward_case(B + T, MT_FWD_WIDTHS[name], B, T, cuda_device)
    w, actions, a_emb, v_emb, init6, gumbels, spec = args
    chain_i, prior_i = (0, 1, 2, 3, 6, 7, 10, 11), (4, 5, 8, 9)
    launch = recurrence_mt.mt_forward_launch
    with torch.no_grad():
        ref = recurrence_mt.mt_recurrence_forward_stages_plain(*args)
        inputs = recurrence_mt.mt_fwd_inputs_plain(w, actions, a_emb, v_emb, spec)
        _, ws = launch(*args, stages=1)
        assert float((ws - inputs).abs().max()) <= 1e-4
        outs = [torch.full_like(r, float("nan")) for r in ref]
        chain, _ = launch(*args, stages=2, workspace=inputs.clone(), outs=outs)
        assert all(bool(chain[i].isnan().all()) for i in prior_i)
        parity.check_mt_recurrence([chain[i] if i in chain_i else ref[i] for i in range(12)], ref,
                                   gumbels, spec)
        outs = [r.clone() if i in (0, 1) else torch.full_like(r, float("nan"))
                for i, r in enumerate(ref)]
        priors, _ = launch(*args, stages=4, outs=outs)
        parity.check_mt_recurrence([priors[i] if i in prior_i else ref[i] for i in range(12)],
                                   ref, gumbels, spec)


def mt_backward_digest(dev) -> str:
    """The digest of the MT backward's 37 outputs at B=8 T=30 on the model's
    weights, seeded inputs and cotangents, fed with the plain forward's
    carries (so that it does not move with the forward kernel)."""
    w = _mt_model(dev).recurrence_weights()
    xs, init6, gumbels = _mt_inputs(240, 8, 30, dev)
    with torch.no_grad():
        outs = recurrence_mt.mt_recurrence_forward_plain(w, *xs, init6, gumbels)
        prev6 = recurrence_mt.shift_carries(init6, recurrence_mt.carries(outs))
        return _digest(recurrence_mt.mt_recurrence_backward_cuda(w, *xs, prev6,
                                                                 _cotangents(30, outs)))


def mt_forward_digest(dev) -> str:
    """The digest of the MT forward's 12 outputs at B=8 T=30 on the model's
    weights, seeded inputs and noise."""
    w = _mt_model(dev).recurrence_weights()
    xs, init6, gumbels = _mt_inputs(240, 8, 30, dev)
    with torch.no_grad():
        return _digest(recurrence_mt.mt_recurrence_forward_cuda(w, *xs, init6, gumbels))


def mt_rollout_digest(dev) -> str:
    """The digest of the MT rollout's outputs at B=8 T=30 on the model's
    weights, seeded actions and initial state."""
    w = _mt_model(dev).rollout_weights()
    xs, init6, _ = _mt_inputs(240, 8, 30, dev)
    with torch.no_grad():
        return _digest(rollout_mt.rollout_mt_cuda(w, xs[0].transpose(0, 1).contiguous(), init6, 77))


# mt_backward_digest on an NVIDIA H100 80GB HBM3 with the backward as it
# stood before the MT forward's redesign added forward_chain.cuh and split
# chain_common.cuh's staging and split helpers.
MT_BWD_DIGEST = "6a2dc462f780a6b18696cf12e789aa41b45ba01162efb1dc03720734107fd0a7"
# mt_rollout_digest on an NVIDIA H100 80GB HBM3, taken on the rollout in
# stages (csrc/rollout_mt.cu).
MT_ROLLOUT_DIGEST = "2f10ba20f78dfce60cabe584491144ca182b3f7c0bb96ff946fcfa1b7f5314fd"


@pytest.mark.gpu
def test_mt_backward_and_rollout_bits_unchanged_by_the_forward(cuda_device):
    """The MT backward's three kernels give the bits they gave before the
    forward's redesign: the device functions they share with the forwards
    and the rollouts did not move (the rollout's own pin:
    ``test_mt_rollout_bits_pinned``)."""
    assert mt_backward_digest(cuda_device) == MT_BWD_DIGEST


@pytest.mark.gpu
def test_mt_rollout_bits_pinned(cuda_device):
    """The MT rollout gives the bits pinned for it: a change of the helpers
    it shares with the other kernels shows here."""
    assert mt_rollout_digest(cuda_device) == MT_ROLLOUT_DIGEST


# mt_forward_digest on an NVIDIA H100 80GB HBM3 with the MT forward as it
# stood before the MRSSM forward's redesign moved to forward_chain.cuh.
MT_FWD_DIGEST = "c38cb88fa85315c062e6d052d1f37fd79a245e1efeaa35b2cd0e67273d900576"


@pytest.mark.gpu
def test_mt_forward_bits_unchanged_by_the_mrssm_forward(cuda_device):
    """The MT forward gives the bits it gave before the MRSSM forward's
    redesign: the device functions they share did not change."""
    assert mt_forward_digest(cuda_device) == MT_FWD_DIGEST


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,T", [("odd", 8, 30), ("odd", 3, 7), ("odd", 128, 30)])
def test_mt_recurrence_backward_kernel_at_other_widths(cuda_device, name, B, T):
    """The MT backward kernels at widths whose records and weights are no
    multiple of 4 floats (weights off 16-byte alignment too), HD ≠ LD and
    3 × 5, 2 × 7 categories: within the limits above, reproducible, the
    bias gradients bit-equal."""
    args = _mt_backward_case(B + T, MT_BWD_WIDTHS[name], B, T, cuda_device)
    with torch.no_grad():
        got = recurrence_mt.mt_recurrence_backward_cuda(*args)
        again = recurrence_mt.mt_recurrence_backward_cuda(*args)
    parity.check_gradients(got, recurrence_mt.mt_recurrence_backward_plain(*args))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(got[1], got[3]) and torch.equal(got[5], got[7])


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,T", [("model", 8, 30), ("model", 128, 30), ("odd", 3, 7)])
def test_mt_recurrence_backward_passes_match_their_plain_passes(cuda_device, name, B, T):
    """Each of the MT backward's three kernels alone against its plain pass
    on the same input: the recompute's records, the chain's cotangents and
    initial-state gradients on the plain recompute's records, the deferred
    GEMMs (weight gradients, input cotangents) on the plain chain's records
    (every field and gradient within 2e-4 × max(1, max|plain|))."""
    if name == "model":
        w = _mt_model(cuda_device).recurrence_weights()
        xs, init6, gumbels = _mt_inputs(B + T, B, T, cuda_device)
        with torch.no_grad():
            outs = recurrence_mt.mt_recurrence_forward_cuda(w, *xs, init6, gumbels)
        args = (w, *xs, recurrence_mt.shift_carries(init6, recurrence_mt.carries(outs)),
                _cotangents(T, outs), recurrence_mt.MT_SPEC)
        widths = (6, 64, 32, 32, 32, 32, recurrence_mt.MT_SPEC)
    else:
        args = _mt_backward_case(B + T, MT_BWD_WIDTHS[name], B, T, cuda_device)
        widths = MT_BWD_WIDTHS[name]
    weights, actions, a_emb, v_emb, prev6, cots, spec = args
    lay = recurrence_mt.mt_bwd_record_layout(*widths)
    field = recurrence.record_field
    with torch.no_grad():
        crec, xrec, dyrec = recurrence_mt.mt_bwd_recompute_plain(*args)
        _, ws = recurrence_mt.mt_backward_launch(*args, passes=1)
        k_c, k_x, k_y = recurrence_mt.mt_bwd_workspace_records(ws, T * B, lay)
        parity.check_gradients([field(k, lay[r][1], f)
                                for k, r in ((k_c, "chain"), (k_x, "x")) for f in lay[r][1]],
                               [field(p, lay[r][1], f)
                                for p, r in ((crec, "chain"), (xrec, "x")) for f in lay[r][1]])
        C_, R_, LS, HS = widths[4], widths[5], spec.ls, spec.hs
        prior_y = [(slice(None), slice(0, C_)), (slice(None), slice(C_ + 2 * R_, 2 * C_ + 2 * R_))]
        prior_g = [(slice(None), slice(0, LS)), (slice(None), slice(3 * LS, 3 * LS + HS))]
        parity.check_gradients(
            [field(k_y, lay["dy"][1], "dhid")[i] for i in prior_y]
            + [field(k_y, lay["dy"][1], "dlg")[i] for i in prior_g],
            [field(dyrec, lay["dy"][1], "dhid")[i] for i in prior_y]
            + [field(dyrec, lay["dy"][1], "dlg")[i] for i in prior_g])
        k_c.copy_(crec)
        k_x.copy_(xrec)
        k_y.copy_(dyrec)
        chain, _ = recurrence_mt.mt_backward_launch(*args, passes=2, workspace=ws)
        p_y, *p_init = recurrence_mt.mt_bwd_chain_plain(weights, crec, dyrec, T, B, spec)
        parity.check_gradients([field(k_y, lay["dy"][1], f) for f in lay["dy"][1]]
                               + list(chain[-6:]),
                               [field(p_y, lay["dy"][1], f) for f in lay["dy"][1]] + p_init)
        k_y.copy_(p_y)
        dw, _ = recurrence_mt.mt_backward_launch(*args, passes=4, workspace=ws)
        parity.check_gradients(dw[:-6], recurrence_mt.mt_bwd_dw_plain(
            weights, actions, a_emb, v_emb, prev6, xrec, p_y, spec))


@pytest.mark.gpu
@pytest.mark.parametrize("B,T", [(10, 10), (64, 30), (256, 180), (3, 1), (60, 10)])
def test_mt_rollout_kernel_matches_plain(cuda_device, B, T):
    """The MT rollout kernel against the plain step replaying its stochs,
    which must be the argmax of its logits plus the seed's noise at both
    sites; two launches bit-identical."""
    w = _mt_model(cuda_device).rollout_weights()
    xs, init6, _ = _mt_inputs(B + T, B, T, cuda_device)
    actions = xs[0].transpose(0, 1).contiguous()
    with torch.no_grad():
        got = rollout_mt.rollout_mt_cuda(w, actions, init6, 77)
        again = rollout_mt.rollout_mt_cuda(w, actions, init6, 77)
    parity.check_mt_rollout(w, actions, init6, 77, got)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _mt_rollout_case(seed: int, name: str, B: int, T: int, dev, straight_through: bool):
    """The rollout's 16 weights (odd ones off 16-byte alignment), actions
    ``[B, T, A]``, ``init6`` (its stochs straight-through where asked) and
    spec at ``MT_FWD_WIDTHS[name]`` or the model's widths."""
    widths = MT_FWD_WIDTHS.get(name, (6, 64, 32, 32, 32, 32, recurrence_mt.MT_SPEC))
    w, actions, _, _, init6, _, spec = _mt_forward_case(seed, widths, B, T, dev)
    init6 = list(init6)
    if straight_through:
        rng = np.random.default_rng(seed)
        init6[2] = _straight_through(rng, B, spec.hs_class, spec.hs_category, dev)
        init6[3] = _straight_through(rng, B, spec.ls_class, spec.ls_category, dev)
    return w[:16], actions.transpose(0, 1).contiguous(), init6, spec


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,T", [("model", 8, 30), ("odd", 8, 30), ("odd", 3, 7),
                                      ("odd", 256, 30), ("ls40", 64, 30)])
def test_mt_rollout_kernel_at_other_widths(cuda_device, name, B, T):
    """The MT rollout kernel at HD ≠ LD and weights no multiple of 4 floats
    (and off 16-byte alignment), 3 × 5 and 2 × 7 categories, and latents
    wider than a warp, from straight-through initial stochs (not one-hot:
    the first step takes the dense product): against the replay, two
    launches bit-identical."""
    w, actions, init6, spec = _mt_rollout_case(B + T, name, B, T, cuda_device, True)
    with torch.no_grad():
        got = rollout_mt.rollout_mt_cuda(w, actions, init6, 91, spec)
        again = rollout_mt.rollout_mt_cuda(w, actions, init6, 91, spec)
    parity.check_mt_rollout(w, actions, init6, 91, got, spec)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,T", [("model", 8, 30), ("model", 256, 180), ("odd", 3, 7)])
def test_mt_rollout_stages_match_their_plain_stages(cuda_device, name, B, T):
    """The prologue alone, on a workspace of NaN: its action sums within
    1e-5 of the plain prologue's and both sites' Gumbel scores equal to
    ``philox_mt_gumbel`` on the card bit for bit; the chain alone on that
    workspace gives the whole launch's outputs bit for bit; one, two and
    three batch rows a block each pass the replay."""
    w, actions, init6, spec = _mt_rollout_case(B + T, name, B, T, cuda_device, False)
    LD = w[0].shape[0]
    with torch.no_grad():
        whole, _ = rollout_mt.rollout_mt_launch(w, actions, init6, 13, spec)
        ws = torch.full((T, B, LD + spec.ls + spec.hs), float("nan"), device=cuda_device)
        rollout_mt.rollout_mt_launch(w, actions, init6, 13, spec, stages=1, workspace=ws)
        ref = rollout_mt.rollout_mt_inputs_plain(w, actions, 13, spec)
        assert float((ws[..., :LD] - ref[..., :LD]).abs().max()) <= 1e-5
        g_l, g_h = rollout_mt.philox_mt_gumbel(13, T, B, (spec.ls_class, spec.ls_category),
                                               (spec.hs_class, spec.hs_category), cuda_device)
        assert torch.equal(ws[..., LD:], torch.cat([g_l, g_h], -1))
        outs, _ = rollout_mt.rollout_mt_launch(w, actions, init6, 13, spec, stages=2,
                                               workspace=ws)
        assert all(torch.equal(a, b) for a, b in zip(outs, whole))
        for R in (1, 2, 3):
            got, _ = rollout_mt.rollout_mt_launch(w, actions, init6, 13, spec, rows=R)
            parity.check_mt_rollout(w, actions, init6, 13, got, spec)


@pytest.mark.gpu
def test_mt_rollout_stays_in_its_workspace(cuda_device):
    """The kernel reads and writes its workspace ``[T, B, LD + LS + HS]``
    and no float past it: on a view of a larger buffer whose tail holds NaN,
    the tail stays NaN and the outputs are those of a call on its own
    workspace, bit for bit."""
    w, actions, init6, spec = _mt_rollout_case(7, "odd", 3, 7, cuda_device, False)
    n = 7 * 3 * (w[0].shape[0] + spec.ls + spec.hs)
    big = torch.full((n + 257,), float("nan"), device=cuda_device)
    with torch.no_grad():
        ref, _ = rollout_mt.rollout_mt_launch(w, actions, init6, 3, spec)
        got, ws = rollout_mt.rollout_mt_launch(w, actions, init6, 3, spec,
                                               workspace=big[:n].view(7, 3, -1))
    assert ws.data_ptr() == big.data_ptr()
    assert bool(big[n:].isnan().all()) and not bool(big[:n].isnan().any())
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.gpu
def test_mt_train_step_on_the_kernels_matches_the_cpu_route(cuda_device):
    _train_step_card_vs_cpu(MoPoEMMTRSSM, MMTRSSMConfig(), cuda_device)
    assert kernels.launch_counts() == {**dict.fromkeys(kernels.LAUNCH_COUNTERS, 0),
                                      "mt_recurrence_fwd": 1, "mt_recurrence_bwd": 1}


# ---- the stacked recurrence and the fused encoder ---------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("B,T", [(8, 30), (128, 30), (3, 7)])
def test_stacked_recurrence_kernels_match_plain(cuda_device, B, T):
    """The stacked forward kernel against its plain version, and the stacked
    backward kernel (unstacked gradients) against its plain version on the
    forward's record and random cotangents; the backward is reproducible."""
    st = recurrence_stacked.stack_train_params(_model(cuda_device).representation_weights())
    ins = _inputs(B * T + 1, B, T, cuda_device)
    with torch.no_grad():
        outs = recurrence_stacked.recurrence_stacked_forward_cuda(st, *ins, C, K)
        ref = recurrence_stacked.recurrence_stacked_forward_plain(st, *ins, C, K)
        parity.check_recurrence(outs, ref, ins[5], ins[6], C, K)
        prev_deter = torch.cat([ins[3][None], outs[0][:-1]])
        prev_stoch = torch.cat([ins[4][None], outs[4][:-1]])
        args = (st, *ins[:3], prev_deter, prev_stoch, _cotangents(T, outs), C, K)
        got = recurrence_stacked.recurrence_stacked_backward_cuda(*args)
        again = recurrence_stacked.recurrence_stacked_backward_cuda(*args)
    ref = recurrence_stacked.recurrence_stacked_backward_plain(*args)
    dims = (6, 32, 32, 64)
    unstack = lambda g: (*recurrence_stacked.unstack_train_grads(g[:10], dims), *g[10:])  # noqa: E731
    parity.check_gradients(unstack(got), unstack(ref))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,T", [("model", 8, 30), ("model", 128, 30), ("model", 3, 7),
                                      ("odd", 8, 30), ("s40", 3, 7)])
def test_stacked_recurrence_forward_is_the_unstacked_kernel(cuda_device, name, B, T):
    """The stacked forward runs the unstacked forward's kernel on its packed
    weights: its five outputs are ``recurrence_forward_cuda``'s on the 20
    weights it was stacked from, bit for bit (at the odd widths some of
    those weights lie off 16-byte alignment); two launches are
    bit-identical."""
    if name == "model":
        args = ([x.detach() for x in _model(cuda_device).representation_weights()],
                *_inputs(B * T + 3, B, T, cuda_device), C, K)
    else:
        args = _forward_case(B + T, FWD_WIDTHS[name], B, T, cuda_device)
    w, rest = args[0], args[1:]
    with torch.no_grad():
        st = recurrence_stacked.stack_train_params(w)
        got = recurrence_stacked.recurrence_stacked_forward_cuda(st, *rest)
        again = recurrence_stacked.recurrence_stacked_forward_cuda(st, *rest)
        ref = recurrence.recurrence_forward_cuda(*args)
    for i, (a, b) in enumerate(zip(got, ref)):
        assert torch.equal(a, b), f"output {i} differs from the unstacked kernel's"
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.gpu
@pytest.mark.parametrize("name,B,T", [("model", 8, 30), ("model", 128, 30), ("model", 3, 7),
                                      ("odd", 8, 30), ("k32", 8, 30)])
def test_stacked_recurrence_backward_is_the_unstacked_kernels(cuda_device, name, B, T):
    """The stacked backward runs the unstacked backward's kernels on its
    packed weights: its gradients, unstacked, and its five input cotangents
    are ``recurrence_backward_cuda``'s on the 20 weights it was stacked from,
    bit for bit (at the odd widths some of those weights lie off 16-byte
    alignment); its zero blocks are exactly 0; two launches are
    bit-identical; it is within 2e-4 × max(1, max|plain|) of its plain
    composition."""
    if name == "model":
        w = [x.detach() for x in _model(cuda_device).representation_weights()]
        ins = _inputs(B * T + 2, B, T, cuda_device)
        with torch.no_grad():
            outs = recurrence.recurrence_forward_cuda(w, *ins, C, K)
        args = (w, *ins[:3], torch.cat([ins[3][None], outs[0][:-1]]),
                torch.cat([ins[4][None], outs[4][:-1]]), _cotangents(T, outs), C, K)
        dims = (6, 32, 32, 64)
    else:
        args = _backward_case(B + T, BWD_WIDTHS[name], B, T, cuda_device)
        A, E, H, D = BWD_WIDTHS[name][:4]
        dims = (A, H, D, E)
    w, rest = args[0], args[1:]
    with torch.no_grad():
        st = recurrence_stacked.stack_train_params(w)
        got = recurrence_stacked.recurrence_stacked_backward_cuda(st, *rest)
        again = recurrence_stacked.recurrence_stacked_backward_cuda(st, *rest)
        ref = recurrence.recurrence_backward_cuda(*args)
        plain = recurrence_stacked.recurrence_stacked_backward_passes_plain(st, *rest)
        nonzero = recurrence_stacked.stack_train_params([torch.ones_like(x) for x in w])
    unstacked = (*recurrence_stacked.unstack_train_grads(got[:10], dims), *got[10:])
    assert len(unstacked) == len(ref) == 25
    for i, (a, b) in enumerate(zip(unstacked, ref)):
        assert torch.equal(a, b), f"gradient {i} differs from the unstacked kernels'"
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for i, (g, m) in enumerate(zip(got[:10], nonzero)):
        assert not g[m == 0].any(), f"stacked gradient {i}: a zero block is not 0"
    parity.check_gradients(got, plain)


def _scaled_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).abs().max()) / max(1.0, float(ref.abs().max()))


# Encoders besides the models': widths that are not multiples of 4 (a
# vector-free forward, an odd head), no residual blocks without the
# CoordConv channels (the head right on the last strided conv), and a wide
# residual stack (more weight slices than any model's).
ENCODER_VARIANTS = {
    "narrow": {"channels": (5, 7, 9), "residual_output_size": 12, "residual_intermediate_size": 10,
               "num_residual_blocks": 2, "linear_sizes": (33,)},
    "no_res": {"num_residual_blocks": 0, "coord_conv": False},
    "wide": {"residual_output_size": 128, "residual_intermediate_size": 128,
             "num_residual_blocks": 3},
    "not16": {"channels": (8, 24, 40), "residual_output_size": 48,
              "residual_intermediate_size": 56, "num_residual_blocks": 1, "linear_sizes": (40,)},
}


def _encoder(name: str, dev):
    """The MRSSM audio encoder, or an :data:`ENCODER_VARIANTS` encoder with
    seeded weights."""
    from multimodal_mtrssm_tpu_torch.nn.conv import Encoder, EncoderConfig

    if name == "model":
        return _model(dev).audio_encoder
    torch.manual_seed(5)
    return Encoder(EncoderConfig(**ENCODER_VARIANTS[name])).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("name,N", [("model", 240), ("model", 7), ("model", 3840), ("model", 1),
                                    ("model", 5), ("model", 241), ("narrow", 30), ("no_res", 30),
                                    ("wide", 30), ("narrow", 241)])
def test_fused_encoder_kernels_match_plain_and_cudnn(cuda_device, name, N):
    """The fused encoder's forward against its plain version and against the
    cuDNN ``Encoder`` (TF32 off), and its backward (every weight gradient and
    dx) against the plain backward on the inputs upcast to float64 (cuDNN's
    float32 backward strays ~7e-4 of scale from float64 at N=3840); the
    backward is reproducible, and without dx gives the same weight
    gradients' bits. N=1, 5 and 241 leave a ragged tile of 2 frames a
    block; N=241 also a ragged last chunk of the weight-gradient pass (16
    chunks of 16 frames, the last of 1)."""
    enc = _encoder(name, cuda_device)
    w = [t.detach() for t in fused_conv.encoder_weights(enc)]
    rng = np.random.default_rng(N)
    x = torch.tensor(rng.uniform(-1, 1, (N, 32, 32, 1)).astype(np.float32), device=cuda_device)
    g = torch.tensor(rng.standard_normal((N, enc.cfg.out_dim)).astype(np.float32),
                     device=cuda_device)
    with torch.no_grad():
        got = fused_conv.fused_encoder_forward_cuda(w, enc.cfg, x)
        plain = fused_conv.fused_encoder_plain(w, enc.cfg, x)
        cudnn = enc(x)
        dx, dw = fused_conv.fused_encoder_backward_cuda(w, enc.cfg, x, g, True)
        dx2, dw2 = fused_conv.fused_encoder_backward_cuda(w, enc.cfg, x, g, True)
        none, dw3 = fused_conv.fused_encoder_backward_cuda(w, enc.cfg, x, g, False)
    assert _scaled_err(got, plain) <= 1e-4 and _scaled_err(got, cudnn) <= 1e-4
    ref_dx, ref_dw = fused_conv.fused_encoder_backward_plain(
        [t.double() for t in w], enc.cfg, x.double(), g.double(), True)
    parity.check_gradients([*dw, dx], [t.float() for t in (*ref_dw, ref_dx)])
    assert all(torch.equal(a, b) for a, b in zip([*dw, dx], [*dw2, dx2]))
    assert none is None and all(torch.equal(a, b) for a, b in zip(dw, dw3))


@pytest.mark.gpu
@pytest.mark.parametrize("name,lead", [("model", (8, 30)), ("narrow", (241,))])
def test_fused_encoder_apply_gives_the_frames_cotangent(cuda_device, name, lead):
    """Frames that require grad through ``fused_encoder_apply``: autograd asks
    the backward kernel for their cotangent, which matches the plain
    backward in float64 like every weight gradient; each pass launches each
    kernel once each way, and two passes give the same bits."""
    enc = _encoder(name, cuda_device)
    rng = np.random.default_rng(len(lead))
    x = torch.tensor(rng.uniform(-1, 1, (*lead, 32, 32, 1)).astype(np.float32),
                     device=cuda_device, requires_grad=True)
    g = torch.tensor(rng.standard_normal((*lead, enc.cfg.out_dim)).astype(np.float32),
                     device=cuda_device)
    runs = []
    for _ in range(2):
        enc.zero_grad(set_to_none=True)
        x.grad = None
        fused_conv.launches = fused_conv.bwd_launches = 0
        fused_conv.fused_encoder_apply(enc, x).backward(g)
        assert (fused_conv.launches, fused_conv.bwd_launches) == (1, 1)
        runs.append([t.grad for t in fused_conv.encoder_weights(enc)] +
                    [x.grad.reshape(-1, 32, 32, 1)])
    w = [t.detach() for t in fused_conv.encoder_weights(enc)]
    ref_dx, ref_dw = fused_conv.fused_encoder_backward_plain(
        [t.double() for t in w], enc.cfg, x.detach().reshape(-1, 32, 32, 1).double(),
        g.reshape(-1, enc.cfg.out_dim).double(), True)
    parity.check_gradients(runs[0], [t.float() for t in (*ref_dw, ref_dx)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
def test_fused_encoder_refuses_what_it_does_not_take(cuda_device):
    enc = _model(cuda_device).audio_encoder
    w = [t.detach() for t in fused_conv.encoder_weights(enc)]
    with pytest.raises(ValueError, match="frames"):
        fused_conv.fused_encoder_forward_cuda(w, enc.cfg, torch.zeros(2, 16, 16, 1,
                                                                      device=cuda_device))
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv.fused_encoder_forward_cuda([t.cpu() for t in w], enc.cfg,
                                              torch.zeros(2, 32, 32, 1))


@pytest.mark.gpu
def test_stacked_fused_train_step_matches_the_cpu_route(cuda_device):
    """One train step at ``conv_layout="fused_enc"``, ``use_pallas_train=
    "stacked"``: both stacked kernels once, both encoders' kernels once each
    way, and nothing else."""
    _train_step_card_vs_cpu(MoPoEMRSSM, MRSSMConfig(conv_layout="fused_enc",
                                                    use_pallas_train="stacked"), cuda_device)
    assert kernels.launch_counts() == {**dict.fromkeys(kernels.LAUNCH_COUNTERS, 0),
                                      "stacked_recurrence_fwd": 1, "stacked_recurrence_bwd": 1,
                                      "fused_encoder_fwd": 2, "fused_encoder_bwd": 2}


# ---- the fused decoder -------------------------------------------------------------


def _decoder(family: str, dev, **cfg):
    """A decoder of ``family``'s model (48- or 96-wide features), or one
    built from ``cfg`` overrides of the MRSSM decoder's config."""
    from multimodal_mtrssm_tpu_torch.nn.conv import Decoder

    if cfg:
        torch.manual_seed(3)
        return Decoder(dataclasses.replace(MRSSMConfig().decoder_cfg("vision"), **cfg)).to(dev)
    return (_model if family == "mrssm" else _mt_model)(dev).vision_decoder


@pytest.mark.gpu
@pytest.mark.parametrize("family,N,cfg", [
    ("mrssm", 240, {}), ("mmtrssm", 240, {}), ("mrssm", 7, {}), ("mrssm", 3840, {}),
    ("mrssm", 1, {}), ("mrssm", 5, {}), ("mrssm", 241, {}), ("mmtrssm", 241, {}),
    ("res_proj", 30, {"residual_input_size": 32}), ("no_res", 30, {"num_residual_blocks": 0}),
    ("res4", 30, {"num_residual_blocks": 4}), ("feat42", 30, {"in_features": 42}),
    ("feat33", 30, {"in_features": 33}), ("lin63", 30, {"linear_sizes": (63, 1024)})])
def test_fused_decoder_kernels_match_plain_and_cudnn(cuda_device, family, N, cfg):
    """The fused decoder's forward against its plain version and the cuDNN
    ``Decoder`` (TF32 off) within 1e-5, two launches bit-identical, and its
    backward (every weight gradient and the features') against the plain
    backward in float64 within 2e-4 × scale; the backward is reproducible,
    and without the features' cotangent gives the same weight gradients'
    bits. N=1, 5 and 241 leave a ragged tile of 2 frames a block; N=241
    also a ragged last chunk of the weight-gradient pass (16 chunks of 16
    frames, the last of 1). Also decoders with a ``res_proj``, with no
    residual blocks and with 4, and with feature or first-linear widths
    that are not multiples of 4 (42 ≡ 2 mod 4, 33, 63), whose records the
    weight-gradient pass stages at a stride rounded to float4s."""
    dec = _decoder(family, cuda_device, **cfg)
    w = [t.detach() for t in fused_conv.decoder_weights(dec)]
    rng = np.random.default_rng(N)
    feats = torch.tensor(rng.standard_normal((N, dec.cfg.in_features)).astype(np.float32),
                         device=cuda_device)
    g = torch.tensor(rng.standard_normal((N, 32, 32, 1)).astype(np.float32), device=cuda_device)
    with torch.no_grad():
        got = fused_conv.fused_decoder_forward_cuda(w, dec.cfg, feats)
        assert torch.equal(got, fused_conv.fused_decoder_forward_cuda(w, dec.cfg, feats))
        plain = fused_conv.fused_decoder_plain(w, dec.cfg, feats)
        cudnn = dec(feats)
        dx, dw = fused_conv.fused_decoder_backward_cuda(w, dec.cfg, feats, g, True)
        dx2, dw2 = fused_conv.fused_decoder_backward_cuda(w, dec.cfg, feats, g, True)
        none, dw3 = fused_conv.fused_decoder_backward_cuda(w, dec.cfg, feats, g, False)
    assert float((got - plain).abs().max()) <= 1e-5 and float((got - cudnn).abs().max()) <= 1e-5
    ref_dx, ref_dw = fused_conv.fused_decoder_backward_plain(
        [t.double() for t in w], dec.cfg, feats.double(), g.double(), True)
    parity.check_gradients([*dw, dx], [t.float() for t in (*ref_dw, ref_dx)])
    assert all(torch.equal(a, b) for a, b in zip([*dw, dx], [*dw2, dx2]))
    assert none is None and all(torch.equal(a, b) for a, b in zip(dw, dw3))


@pytest.mark.gpu
@pytest.mark.parametrize("family,lead", [("mrssm", (8, 30)), ("mmtrssm", (241,))])
def test_fused_decoder_apply_gives_the_features_cotangent(cuda_device, family, lead):
    """Features that require grad through ``fused_decoder_apply``: autograd
    asks the backward kernels for their cotangent, which matches the plain
    backward in float64 like every weight gradient; each pass launches each
    kernel once each way, and two passes give the same bits."""
    dec = _decoder(family, cuda_device)
    rng = np.random.default_rng(len(lead))
    feats = torch.tensor(rng.standard_normal((*lead, dec.cfg.in_features)).astype(np.float32),
                         device=cuda_device, requires_grad=True)
    g = torch.tensor(rng.standard_normal((*lead, 32, 32, 1)).astype(np.float32),
                     device=cuda_device)
    runs = []
    for _ in range(2):
        dec.zero_grad(set_to_none=True)
        feats.grad = None
        fused_conv.dec_launches = fused_conv.dec_bwd_launches = 0
        fused_conv.fused_decoder_apply(dec, feats).backward(g)
        assert (fused_conv.dec_launches, fused_conv.dec_bwd_launches) == (1, 1)
        runs.append([t.grad for t in fused_conv.decoder_weights(dec)] +
                    [feats.grad.reshape(-1, dec.cfg.in_features)])
    w = [t.detach() for t in fused_conv.decoder_weights(dec)]
    ref_dx, ref_dw = fused_conv.fused_decoder_backward_plain(
        [t.double() for t in w], dec.cfg, feats.detach().reshape(-1, dec.cfg.in_features).double(),
        g.reshape(-1, 32, 32, 1).double(), True)
    parity.check_gradients(runs[0], [t.float() for t in (*ref_dw, ref_dx)])
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
def test_fused_decoder_apply_launches_the_kernels_or_raises(cuda_device):
    """Through ``fused_decoder_apply`` a forward and its backward launch each
    kernel once and nothing else; the kernels refuse features and decoders
    they do not take, and CPU tensors."""
    dec = _decoder("mrssm", cuda_device)
    feats = torch.randn(2, 3, 48, device=cuda_device, requires_grad=True)
    kernels.reset_launch_counts()
    frames = kernels.fused_decoder_apply(dec, feats)
    frames.square().sum().backward()
    assert frames.shape == (2, 3, 32, 32, 1) and feats.grad is not None
    assert kernels.launch_counts() == {**dict.fromkeys(kernels.LAUNCH_COUNTERS, 0),
                                      "fused_decoder_fwd": 1, "fused_decoder_bwd": 1}
    w = [t.detach() for t in fused_conv.decoder_weights(dec)]
    with pytest.raises(ValueError, match="features"):
        fused_conv.fused_decoder_forward_cuda(w, dec.cfg, torch.zeros(2, 96, device=cuda_device))
    with pytest.raises(ValueError, match="CUDA"):
        fused_conv.fused_decoder_forward_cuda([t.cpu() for t in w], dec.cfg, torch.zeros(2, 48))
    with pytest.raises(ValueError, match="do not take"):
        kernels.fused_decoder_apply(_decoder("mrssm", cuda_device, channels=(32, 16, 3)),
                                    torch.zeros(2, 48, device=cuda_device))


# ---- per-row Philox keys: coalesced requests ----------------------------------------

# (B, T, seed) of coalesced requests: B ∈ {1, 2, 3, 8}, T ∈ {5, 10, 30}; the
# server runs them at their total rows and longest steps.
COALESCED = ((1, 5, 3), (2, 30, 4), (3, 10, 2**63 + 5), (8, 30, 6))
COALESCED_B, COALESCED_T = sum(b for b, _, _ in COALESCED), max(t for _, t, _ in COALESCED)


def _coalesced_keys(dev) -> tuple[torch.Tensor, torch.Tensor]:
    """Each request's ``row_keys``, in order."""
    keys = [rollout.row_keys(s, b) for b, _, s in COALESCED]
    return tuple(torch.cat(k).to(dev) for k in zip(*keys))


def _rollout_case(family: str, dev, B: int, T: int):
    """The family's rollout weights on the model, and numpy-seeded actions
    ``[B, T, A]`` and initial carries."""
    if family == "mrssm":
        ins = _inputs(B + 7 * T, B, T, dev)
        return _model(dev).transition.weights(), ins[0].transpose(0, 1).contiguous(), ins[3:5]
    xs, init6, _ = _mt_inputs(B + 7 * T, B, T, dev)
    return _mt_model(dev).rollout_weights(), xs[0].transpose(0, 1).contiguous(), list(init6)


def _launch(family: str, w, actions, init, seed, **kw):
    if family == "mrssm":
        return rollout.rollout_launch(w, actions, *init, seed, C, K, **kw)
    return rollout_mt.rollout_mt_launch(w, actions, init, seed, **kw)


def _scores(family: str, out, seed) -> list:
    """The sampled sites' logits plus the seed's noise, ``[B, T, ·]``."""
    B, T = out[0].shape[:2]
    if family == "mrssm":
        noise = rollout.philox_gumbel(seed, T, B, C, K, out[0].device)
        return [(out[1] + noise.transpose(0, 1), C, K)]
    g_l, g_h = rollout_mt.philox_mt_gumbel(seed, T, B, device=out[0].device)
    return [(out[3] + g_l.transpose(0, 1), 4, 4), (out[2] + g_h.transpose(0, 1), 2, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["mrssm", "mt"])
def test_per_row_keys_draw_the_plain_noise_on_the_card(cuda_device, family):
    """With coalesced rows' keys, the prologue alone (on a NaN workspace)
    writes the plain per-row draw bit for bit, the whole launch passes the
    replay against that draw, and two launches are bit-identical."""
    B, T = COALESCED_B, COALESCED_T
    keys = _coalesced_keys(cuda_device)
    w, actions, init = _rollout_case(family, cuda_device, B, T)
    with torch.no_grad():
        whole, ws = _launch(family, w, actions, init, keys)
        again, _ = _launch(family, w, actions, init, keys)
        nan = torch.full_like(ws, float("nan"))
        _launch(family, w, actions, init, keys, stages=1, workspace=nan)
    if family == "mrssm":
        noise = rollout.philox_gumbel(keys, T, B, C, K, cuda_device)
        parity.check_rollout(w, actions, *init, keys, whole, C, K)
    else:
        noise = torch.cat(rollout_mt.philox_mt_gumbel(keys, T, B, device=cuda_device), -1)
        parity.check_mt_rollout(w, actions, init, keys, whole)
    assert torch.equal(nan[..., ws.shape[-1] - noise.shape[-1]:], noise)
    assert all(torch.equal(a, b) for a, b in zip(whole, again))


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["mrssm", "mt"])
def test_coalesced_rollout_equals_each_request_alone(cuda_device, family):
    """One launch over the coalesced requests' rows (at their total rows
    and longest steps) against each request's own launch on its rows and steps:
    stochs equal before each row's first near-tie of 1e-5, deters, logits
    and integrators within 1e-4 up to it."""
    B, T = COALESCED_B, COALESCED_T
    w, actions, init = _rollout_case(family, cuda_device, B, T)
    samples = (2,) if family == "mrssm" else (4, 5)
    with torch.no_grad():
        together, _ = _launch(family, w, actions, init, _coalesced_keys(cuda_device))
        off = 0
        for b, t, seed in COALESCED:
            rows = slice(off, off + b)
            alone, _ = _launch(family, w, actions[rows, :t].contiguous(),
                               [x[rows].contiguous() for x in init], seed)
            parity.check_same_trajectories(
                [x[rows, :t] for x in together], alone, samples,
                parity.first_near_tie(_scores(family, alone, seed)),
                name=f"{family} B={b} T={t}")
            off += b


# ---- resume on the card, the evaluation's digits card against CPU ----------------------


@pytest.mark.gpu
def test_mid_epoch_resume_on_the_card(cuda_device, tmp_path, monkeypatch):
    """SIGTERM after the 4th step (mid epoch 1 of 3-step epochs at B=8
    T=30) on the per-batch path (K=1; a graphed chunk's preemption is
    ``test_kstep_preemption_inside_a_graphed_chunk``'s): a fresh trainer's
    ``resume=True`` ends within the train step's bound of the uninterrupted
    fit."""
    import os
    import signal

    from multimodal_mtrssm_tpu_torch.data import (
        DataModuleConfig,
        EpisodeDataModule,
        generate_synthetic_audio_mnist,
    )
    from multimodal_mtrssm_tpu_torch.train import Trainer, TrainerConfig
    from multimodal_mtrssm_tpu_torch.train import trainer as trainer_mod

    generate_synthetic_audio_mnist(tmp_path / "episodes", n_episodes=24, seed=0)

    def trainer(name):
        dm = EpisodeDataModule(DataModuleConfig(data_dir=str(tmp_path / "episodes"), batch_size=8,
                                                sequence_length=30, noise_std=0.0))
        return Trainer(MoPoEMRSSM().to(cuda_device), dm,
                       TrainerConfig(max_epochs=2, seed=0, log_dir=str(tmp_path / name),
                                     steps_per_dispatch=1))

    ref = trainer("ref")
    ref.fit()
    real = trainer_mod.make_train_step

    def make(*args):
        step, calls = real(*args), [0]

        def wrapped(*a):
            out = step(*a)
            calls[0] += 1
            if calls[0] == 4:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return wrapped

    monkeypatch.setattr(trainer_mod, "make_train_step", make)
    assert trainer("cut").fit()["preempted"]
    monkeypatch.undo()
    resumed = trainer("cut")
    assert [r["epoch"] for r in resumed.fit(resume=True)["history"]] == [1]
    for (name, a), b in zip(resumed.model.state_dict().items(), ref.model.state_dict().values()):
        scale = max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) <= 3e-4 * scale, name


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["mrssm", "mt"])
def test_evaluation_digits_match_the_cpu(cuda_device, tmp_path, family):
    """One word's predictions (6 intervals × 10 predictions, 10 frames) on
    the card and on the CPU, on the same weights, classifier and seed: the
    rollout states up to each row's first near-tie (stochs equal, the rest
    within 1e-4) and the digits in every row clear of near-ties of 1e-5, at
    frames 0 and 1."""
    import copy

    from multimodal_mtrssm_tpu_torch.data import generate_synthetic_labeled_audio_mnist
    from multimodal_mtrssm_tpu_torch.evaluation import (
        MNISTClassifier,
        load_test_data_with_labels,
        predict_word,
        select_intervals_for_word,
    )

    model = _model(cuda_device) if family == "mrssm" else _mt_model(cuda_device)
    cpu_model = copy.deepcopy(model).cpu()
    torch.manual_seed(0)
    classifier = MNISTClassifier().eval()
    cpu_classifier = copy.deepcopy(classifier)
    classifier = classifier.to(cuda_device)
    generate_synthetic_labeled_audio_mnist(tmp_path / "train", tmp_path / "eval", n_episodes=12,
                                           seed=0)
    test_data = load_test_data_with_labels(tmp_path / "eval")
    intervals = select_intervals_for_word(3, test_data, 6, 30)
    for cf in (0, 1):
        got = predict_word(model, classifier, intervals, 1234, 10, 10, classify_frame=cf)
        ref = predict_word(cpu_model, cpu_classifier, intervals, 1234, 10, 10, classify_frame=cf)
        r = parity.check_predicted_digits(got, ref, model.cfg, cf)
        assert r["compared"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["mrssm", "mt"])
def test_reconstructions_match_the_cpu(cuda_device, family):
    """``viz.rollout.reconstruction_states`` and its decoded frames at 7
    episodes × 30 frames, q=10, audio inputs dropped (the cross-modal GIF
    batch), on the card and on the CPU with the same weights and seed: one
    recurrence-forward and one rollout launch, the states and frames
    within 1e-4 before each row's first Gumbel near-tie of 1e-5, the
    sampled categories equal (``parity.check_reconstructions``)."""
    import copy

    from multimodal_mtrssm_tpu_torch.viz.rollout import decode_reconstructions, reconstruction_states

    model = _model(cuda_device) if family == "mrssm" else _mt_model(cuda_device)
    rng = np.random.default_rng(5)
    batch = (rng.standard_normal((7, 30, 6)).astype(np.float32),
             np.full((7, 30, 32, 32, 1), -1.0, np.float32),
             rng.uniform(-1, 1, (7, 30, 32, 32, 1)).astype(np.float32))

    def run(m):
        out = reconstruction_states(m, batch, 10, 77)
        out["frames"] = decode_reconstructions(m, out)
        return out

    kernels.reset_launch_counts()
    got = run(model)
    torch.cuda.synchronize()
    names = ("recurrence_fwd", "rollout") if family == "mrssm" else ("mt_recurrence_fwd",
                                                                      "mt_rollout")
    assert {k: v for k, v in kernels.launch_counts().items() if v} == dict.fromkeys(names, 1)
    r = parity.check_reconstructions(got, run(copy.deepcopy(model).cpu()), model.cfg)
    assert r["compared"] > 0.5


@pytest.mark.gpu
def test_random_dropout_resume_on_the_card(cuda_device, tmp_path, monkeypatch):
    """Under ``drop_modality="random"`` (pipeline noise 0), with cuDNN held
    to deterministic algorithms: a fit SIGTERMed after its 4th step (mid
    epoch 1 of 3-step epochs at B=8 T=30, the per-batch path, K=1) and
    resumed ends bit-identical to the uninterrupted fit."""
    import os
    import signal

    from multimodal_mtrssm_tpu_torch.data import (
        DataModuleConfig,
        EpisodeDataModule,
        generate_synthetic_audio_mnist,
    )
    from multimodal_mtrssm_tpu_torch.train import Trainer, TrainerConfig
    from multimodal_mtrssm_tpu_torch.train import trainer as trainer_mod

    generate_synthetic_audio_mnist(tmp_path / "episodes", n_episodes=24, seed=0)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)

    def trainer(name):
        dm = EpisodeDataModule(DataModuleConfig(data_dir=str(tmp_path / "episodes"), batch_size=8,
                                                sequence_length=30, noise_std=0.0,
                                                drop_modality="random"))
        return Trainer(MoPoEMRSSM().to(cuda_device), dm,
                       TrainerConfig(max_epochs=2, seed=0, log_dir=str(tmp_path / name),
                                     steps_per_dispatch=1))

    ref = trainer("ref")
    ref.fit()
    real = trainer_mod.make_train_step

    def make(*args):
        step, calls = real(*args), [0]

        def wrapped(*a):
            out = step(*a)
            calls[0] += 1
            if calls[0] == 4:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return wrapped

    with monkeypatch.context() as m:
        m.setattr(trainer_mod, "make_train_step", make)
        assert trainer("cut").fit()["preempted"]
    resumed = trainer("cut")
    assert [r["epoch"] for r in resumed.fit(resume=True)["history"]] == [1]
    for a, b in zip(resumed.model.state_dict().values(), ref.model.state_dict().values()):
        assert torch.equal(a, b)


# ---- the bf16 fused encoder kernels (trainer.precision 16-mixed) -------------------------

# bf16 kernel against its plain version on the card: a different f32 summation
# order may flip one bf16 ulp (2^-8 relative) of a layer's output, which the
# later layers carry; × max(1, max|plain|).
BF16_FWD_TOL = 1e-2
BF16_BWD_TOL = 2e-2
# bf16 embeddings against the f32 kernels', absolute: JAX's own bound
# (tests/test_fused_conv.py::test_bf16_path).
BF16_VS_F32 = 0.1


def encoder_f32_digest(dev) -> str:
    """The digest of the f32 fused encoder's embedding, frames' cotangent
    and weight gradients on the MRSSM audio encoder at N=240 (seeded frames
    and cotangent)."""
    enc = _encoder("model", dev)
    w = [t.detach() for t in fused_conv.encoder_weights(enc)]
    rng = np.random.default_rng(240)
    x = torch.tensor(rng.uniform(-1, 1, (240, 32, 32, 1)).astype(np.float32), device=dev)
    g = torch.tensor(rng.standard_normal((240, enc.cfg.out_dim)).astype(np.float32), device=dev)
    with torch.no_grad():
        out = fused_conv.fused_encoder_forward_cuda(w, enc.cfg, x)
        dx, dw = fused_conv.fused_encoder_backward_cuda(w, enc.cfg, x, g, True)
    return _digest([out, dx, *dw])


# encoder_f32_digest on an NVIDIA H100 80GB HBM3, taken on the f32 encoder
# kernels as they stood before the bf16 kernels were added.
ENCODER_F32_DIGEST = "d295ed7df9675b46b11753184962bcfcb247566adc2e9384c2f983cbd79b598c"


@pytest.mark.gpu
def test_fused_encoder_f32_bits_unchanged_by_the_bf16_kernels(cuda_device):
    assert encoder_f32_digest(cuda_device) == ENCODER_F32_DIGEST


def _bf16_case(name: str, N: int, dev):
    enc = _encoder(name, dev)
    w32 = [t.detach() for t in fused_conv.encoder_weights(enc)]
    rng = np.random.default_rng(N)
    x32 = torch.tensor(rng.uniform(-1, 1, (N, 32, 32, 1)).astype(np.float32), device=dev)
    g = torch.tensor(rng.standard_normal((N, enc.cfg.out_dim)).astype(np.float32), device=dev)
    return enc, w32, x32, g.to(torch.bfloat16)


BF16_CASES = [("model", 240), ("model", 3840), ("model", 5), ("narrow", 241), ("no_res", 30),
              ("wide", 30), ("model", 1), ("model", 241), ("not16", 31)]


@pytest.mark.gpu
@pytest.mark.parametrize("name,N", BF16_CASES)
def test_fused_encoder_bf16_kernels_match_plain(cuda_device, name, N):
    """The bf16 forward against the plain bf16 version within 1e-2 × scale
    and the f32 kernels within 0.1; the bf16 backward (every weight gradient
    and dx, bf16) against the plain bf16 backward within 2e-2 × scale per
    tensor; two launches bit-identical, and the backward without dx gives
    the same weight-gradient bits. N=1, 5, 31 and 241 leave a ragged tile
    of the 2 frames a block (N=241 also a last weight-gradient chunk of one
    frame); "narrow" and "not16" have channel counts that are not multiples
    of 16 (padded with zeros in the tensor-core operands)."""
    enc, w32, x32, g = _bf16_case(name, N, cuda_device)
    w, x = [t.to(torch.bfloat16) for t in w32], x32.to(torch.bfloat16)
    with torch.no_grad():
        got = fused_conv.fused_encoder_bf16_forward_cuda(w, enc.cfg, x)
        again = fused_conv.fused_encoder_bf16_forward_cuda(w, enc.cfg, x)
        f32 = fused_conv.fused_encoder_forward_cuda(w32, enc.cfg, x32)
        dx, dw = fused_conv.fused_encoder_bf16_backward_cuda(w, enc.cfg, x, g, True)
        dx2, dw2 = fused_conv.fused_encoder_bf16_backward_cuda(w, enc.cfg, x, g, True)
        none, dw3 = fused_conv.fused_encoder_bf16_backward_cuda(w, enc.cfg, x, g, False)
        plain = fused_conv.fused_encoder_plain(w, enc.cfg, x)
    ref_dx, ref_dw = fused_conv.fused_encoder_backward_plain(w, enc.cfg, x, g, True)
    assert got.dtype == dx.dtype == torch.bfloat16 and all(t.dtype == torch.bfloat16 for t in dw)
    assert _scaled_err(got.float(), plain.float()) <= BF16_FWD_TOL
    assert float((got.float() - f32).abs().max()) <= BF16_VS_F32
    parity.check_gradients([t.float() for t in (*dw, dx)], [t.float() for t in (*ref_dw, ref_dx)],
                           BF16_BWD_TOL)
    assert torch.equal(got, again)
    assert all(torch.equal(a, b) for a, b in zip([*dw, dx], [*dw2, dx2]))
    assert none is None and all(torch.equal(a, b) for a, b in zip(dw, dw3))


# Widths at the edge of what the first bf16 kernels' plan took (one frame's
# f32 cotangent record in a block's shared memory): the widest first, second
# and last conv, and the widest residual block.
BF16_EDGE_CASES = {"ch0": {"channels": (176, 16, 32)}, "ch1": {"channels": (8, 704, 32)},
                   "ch2": {"channels": (8, 16, 3240), "num_residual_blocks": 0},
                   "res": {"residual_output_size": 1064, "residual_intermediate_size": 1064,
                           "num_residual_blocks": 1}}


@pytest.mark.gpu
def test_fused_encoder_bf16_plan_takes_every_case(cuda_device):
    """Every encoder of the bf16 cases, and the widths at the edge of what
    the first bf16 kernels' plan took, plans at N=1, 240 and 3840: frames a
    block of both passes, packed weights, tiles of the weight-gradient pass
    and the gradient layout of the encoder's tensors."""
    from multimodal_mtrssm_tpu_torch.nn.conv import EncoderConfig
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    lib = build.load_library()
    for cfg in BF16_EDGE_CASES.values():
        for N in (1, 240, 3840):
            sz = fused_conv.bf16_sizes(lib, fused_conv._dims(EncoderConfig(**cfg), N))
            assert sz["fwd_frames"] >= 1 and sz["bwd_frames"] >= 1
    for name in dict(BF16_CASES):
        enc = _encoder(name, cuda_device)
        for N in (1, 240, 3840):
            sz = fused_conv.bf16_sizes(lib, fused_conv._dims(enc.cfg, N))
            assert sz["fwd_frames"] >= 1 and sz["bwd_frames"] >= 1 and sz["dw_tiles"] >= 1
            assert sz["packed"] > 0 and sz["slots"] >= -(-N // fused_conv._dw_chunk(N))
            assert sz["grads"] == sum(t.numel() for t in fused_conv.encoder_weights(enc))


@pytest.mark.gpu
@pytest.mark.parametrize("edge", list(BF16_EDGE_CASES))
def test_fused_encoder_bf16_kernels_at_edge_widths(cuda_device, edge):
    """At the edge widths one frame a block, and the widest cotangent maps
    read from the record rather than shared memory: the bf16 forward and
    backward against the plain bf16 versions (BF16_FWD_TOL, BF16_BWD_TOL ×
    scale), two launches bit-identical, at N=3."""
    from multimodal_mtrssm_tpu_torch.nn.conv import Encoder, EncoderConfig

    torch.manual_seed(5)
    enc = Encoder(EncoderConfig(**BF16_EDGE_CASES[edge])).to(cuda_device)
    w = [t.detach().to(torch.bfloat16) for t in fused_conv.encoder_weights(enc)]
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.uniform(-1, 1, (3, 32, 32, 1)).astype(np.float32),
                     device=cuda_device).to(torch.bfloat16)
    g = torch.tensor(rng.standard_normal((3, enc.cfg.out_dim)).astype(np.float32),
                     device=cuda_device).to(torch.bfloat16)
    with torch.no_grad():
        got = fused_conv.fused_encoder_bf16_forward_cuda(w, enc.cfg, x)
        plain = fused_conv.fused_encoder_plain(w, enc.cfg, x)
        dx, dw = fused_conv.fused_encoder_bf16_backward_cuda(w, enc.cfg, x, g, True)
        dx2, dw2 = fused_conv.fused_encoder_bf16_backward_cuda(w, enc.cfg, x, g, True)
    ref_dx, ref_dw = fused_conv.fused_encoder_backward_plain(w, enc.cfg, x, g, True)
    assert _scaled_err(got.float(), plain.float()) <= BF16_FWD_TOL
    parity.check_gradients([t.float() for t in (*dw, dx)], [t.float() for t in (*ref_dw, ref_dx)],
                           BF16_BWD_TOL)
    assert all(torch.equal(a, b) for a, b in zip([*dw, dx], [*dw2, dx2]))


@pytest.mark.gpu
def test_fused_encoder_bf16_refused_width_names_the_plain_route(cuda_device):
    """A width whose maps do not fit a block's shared memory even one frame
    a block (an 8000-channel last conv: the head's input map alone is 256
    KB) is refused by the sizes query and by both wrappers, naming
    ``conv_layout='nhwc'``."""
    from multimodal_mtrssm_tpu_torch.nn.conv import Encoder, EncoderConfig
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    torch.manual_seed(5)
    enc = Encoder(EncoderConfig(channels=(8, 16, 8000), num_residual_blocks=0)).to(cuda_device)
    w = [t.detach().to(torch.bfloat16) for t in fused_conv.encoder_weights(enc)]
    x = torch.zeros(4, 32, 32, 1, dtype=torch.bfloat16, device=cuda_device)
    g = torch.zeros(4, enc.cfg.out_dim, dtype=torch.bfloat16, device=cuda_device)
    with pytest.raises(ValueError, match="conv_layout='nhwc'"):
        fused_conv.bf16_sizes(build.load_library(), fused_conv._dims(enc.cfg, 4))
    with pytest.raises(ValueError, match="conv_layout='nhwc'"):
        fused_conv.fused_encoder_bf16_forward_cuda(w, enc.cfg, x)
    with pytest.raises(ValueError, match="conv_layout='nhwc'"):
        fused_conv.fused_encoder_bf16_backward_cuda(w, enc.cfg, x, g, True)


@pytest.mark.gpu
def test_fused_encoder_apply_on_bf16_frames_launches_the_bf16_kernels(cuda_device):
    """bf16 frames through ``fused_encoder_apply``: the bf16 kernels once
    each way and no f32 encoder kernel; the float32 master parameters take
    float32 gradients equal to the bf16 kernel's, widened."""
    enc, w32, x32, g = _bf16_case("model", 240, cuda_device)
    x = x32.to(torch.bfloat16)
    enc.zero_grad(set_to_none=True)
    kernels.reset_launch_counts()
    out = fused_conv.fused_encoder_apply(enc, x)
    out.backward(g)
    assert kernels.launch_counts() == {**dict.fromkeys(kernels.LAUNCH_COUNTERS, 0),
                                      "fused_encoder_fwd_bf16": 1, "fused_encoder_bwd_bf16": 1}
    with torch.no_grad():
        _, dw = fused_conv.fused_encoder_bf16_backward_cuda(
            [t.to(torch.bfloat16) for t in w32], enc.cfg, x, g, False)
    for t, d in zip(fused_conv.encoder_weights(enc), dw):
        assert t.grad.dtype == torch.float32 and torch.equal(t.grad, d.float())


def _fit_16_mixed(family: str, layout: str, dev, tmp_path):
    """``configs/mopoe_<family>.yaml`` with ``precision: 16-mixed`` at
    ``conv_layout=layout`` fit 2 epochs × 3 steps at B=8 T=30 on 24
    synthetic episodes; returns the fit's history and the launch counts."""
    from multimodal_mtrssm_tpu_torch.data import generate_synthetic_audio_mnist
    from multimodal_mtrssm_tpu_torch.train.config import load_experiment
    from multimodal_mtrssm_tpu_torch.train.entry import default_config_path

    episodes = tmp_path / "episodes"
    if not episodes.exists():
        generate_synthetic_audio_mnist(episodes, n_episodes=24, seed=0)
    exp = load_experiment(default_config_path(f"mopoe_{family}.yaml"), {
        "trainer": {"precision": "16-mixed", "max_epochs": 2},
        "model": {"init_args": {"conv_layout": layout}}})
    assert exp.model.cfg.conv_dtype == torch.bfloat16
    exp.data.data_dir = episodes
    exp.trainer.log_dir = str(tmp_path / f"{family}_{layout}")
    kernels.reset_launch_counts()
    history = exp.build_trainer(device=dev).fit()["history"]
    return history, kernels.launch_counts()


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["mrssm", "mmtrssm"])
def test_16_mixed_fit_on_the_fused_encoder_launches_the_bf16_kernels(cuda_device, tmp_path,
                                                                     family):
    """A 16-mixed YAML at ``conv_layout: fused_enc`` trains on the card with
    finite losses, its encoders only on the bf16 kernels (two a step each
    way), its recurrence on the recurrence kernels."""
    history, counts = _fit_16_mixed(family, "fused_enc", cuda_device, tmp_path)
    assert all(np.isfinite(r["train/loss"]) and np.isfinite(r["val/loss"]) for r in history)
    steps = counts["fused_encoder_bwd_bf16"] // 2
    assert steps >= 2 and counts["fused_encoder_fwd"] == counts["fused_encoder_bwd"] == 0
    rec = "recurrence" if family == "mrssm" else "mt_recurrence"
    assert counts[f"{rec}_bwd"] == steps


# ---- the plain route (use_pallas_train=False) on the card --------------------------------


def _no_launches() -> bool:
    return kernels.launch_counts() == dict.fromkeys(kernels.LAUNCH_COUNTERS, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("family,cfg_cls", [(MoPoEMRSSM, MRSSMConfig),
                                            (MoPoEMMTRSSM, MMTRSSMConfig)])
def test_plain_route_tanh_train_step_on_the_card_matches_the_cpu(cuda_device, family, cfg_cls):
    """A Tanh model, which the kernels refuse, trains on the card by name
    (``use_pallas_train=False``): one train step against the CPU route,
    launching no kernel."""
    cfg = cfg_cls(activation_name="Tanh", use_pallas_train=False)
    _train_step_card_vs_cpu(family, cfg, cuda_device)
    assert _no_launches()
    with pytest.raises(ValueError, match="use_pallas_train=False"):
        family(cfg_cls(activation_name="Tanh")).to(cuda_device).shared_step(
            tuple(torch.zeros(1, 2, *s, device=cuda_device) for s in
                  ((6,), (32, 32, 1), (32, 32, 1), (6,), (32, 32, 1), (32, 32, 1))))


def _rollouts(model, dev, B: int = 8, T: int = 10, seed: int = 5):
    """``model``'s imagination from a seeded initial state on ``dev``, and
    the first near-tie of each row on its own logits."""
    rng = np.random.default_rng(seed)
    act = torch.tensor(rng.uniform(-1, 1, (B, 1, 6)).astype(np.float32), device=dev)
    frames = [torch.tensor(rng.uniform(-1, 1, (B, 32, 32, 1)).astype(np.float32), device=dev)
              for _ in range(2)]
    noise = {k: torch.tensor(rng.gumbel(size=s).astype(np.float32), device=dev)
             for k, s in model.noise_shapes(B, 1).items() if k.startswith("g_init")}
    with torch.no_grad():
        init = model.initial_state(*frames, *noise.values())
        return model.rollout_transition(act.expand(B, T, 6).contiguous(), init, seed)


@pytest.mark.gpu
@pytest.mark.parametrize("family,cfg_cls", [(MoPoEMRSSM, MRSSMConfig),
                                            (MoPoEMMTRSSM, MMTRSSMConfig)])
def test_plain_route_matches_the_kernel_route_on_the_card(cuda_device, family, cfg_cls):
    """An ELU model on the plain route against the same weights on the
    kernels: a train step (losses within 2e-5 of the loss, gradients 3e-4
    × scale) and imagination on the same Philox noise (1e-4 before each
    row's first near-tie), the plain route launching no kernel; a Tanh
    model imagines on the card as on the CPU."""
    kernel = family(cfg_cls()).init(torch.Generator().manual_seed(1)).to(cuda_device)
    plain = family(cfg_cls(use_pallas_train=False)).to(cuda_device)
    plain.load_state_dict(kernel.state_dict())
    B, T = 4, 10
    for seed in range(10):
        rng = np.random.default_rng(seed)
        act = rng.uniform(-1, 1, (B, T, 6)).astype(np.float32)
        frames = [rng.uniform(-1, 1, (B, T, 32, 32, 1)).astype(np.float32) for _ in range(2)]
        batch = tuple(torch.tensor(x, device=cuda_device) for x in (act, *frames, act, *frames))
        noise = {k: torch.tensor(rng.gumbel(size=s).astype(np.float32), device=cuda_device)
                 for k, s in kernel.noise_shapes(B, T).items()}
        noise["input"] = tuple(torch.tensor(rng.standard_normal(x.shape).astype(np.float32),
                                            device=cuda_device) for x in batch[:3])
        if parity.train_step_near_ties(kernel, batch, noise) == 0:
            break
    kernel_out = parity.train_step_grads(kernel, batch, noise)
    kernels.reset_launch_counts()
    plain_out = parity.train_step_grads(plain, batch, noise)
    ref_roll = _rollouts(kernel, cuda_device)
    kernels.reset_launch_counts()
    got_roll = _rollouts(plain, cuda_device)
    assert _no_launches()
    total = abs(kernel_out[0]["loss"])
    assert all(abs(plain_out[0][k] - v) <= 2e-5 * total for k, v in kernel_out[0].items())
    scale = max(1.0, max(float(g.abs().max()) for g in kernel_out[1].values()))
    assert max(float((plain_out[1][n] - g).abs().max()) for n, g in kernel_out[1].items()) \
        <= 3e-4 * scale
    parity.check_same_rollouts(got_roll, ref_roll, kernel.cfg, 5)
    tanh = cfg_cls(activation_name="Tanh", use_pallas_train=False)
    cpu = family(tanh).init(torch.Generator().manual_seed(1))
    card = family(tanh).to(cuda_device)
    card.load_state_dict(cpu.state_dict())
    kernels.reset_launch_counts()
    on_card = _rollouts(card, cuda_device)
    assert _no_launches()
    parity.check_same_rollouts(on_card.to(torch.device("cpu")), _rollouts(cpu, torch.device("cpu")),
                               cpu.cfg, 5)


@pytest.mark.gpu
@pytest.mark.parametrize("family,cfg_cls", [(MoPoEMRSSM, MRSSMConfig),
                                            (MoPoEMMTRSSM, MMTRSSMConfig)])
def test_16_mixed_train_step_on_the_card_matches_the_cpu(cuda_device, family, cfg_cls):
    """A train step at ``conv_dtype=torch.bfloat16`` (cuDNN's bf16 convs)
    against the CPU route's bf16 convs, as ``parity.check_train_step`` with
    bf16 bounds: loss terms within 1e-2 of the loss, gradients 5e-2 × scale
    (bf16 rounding flips, 2^-8 relative, carried through the stacks); Gumbel
    near-ties of 1e-2 are skipped for the next seed."""
    _train_step_card_vs_cpu(family, cfg_cls(conv_dtype=torch.bfloat16), cuda_device,
                            tie_eps=1e-2, rtol=1e-2, rel=5e-2, shape=(2, 5), seeds=30)


# ---- the weighted and unimodal families --------------------------------------------------


def _family_case(model, seed: int, B: int = 4, T: int = 10):
    """A batch of ``model``'s family (the unimodal RSSM's 4-tuple) and its
    noise, CPU tensors made by numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    act = rng.uniform(-1, 1, (B, T, 6)).astype(np.float32)
    frames = [rng.uniform(-1, 1, (B, T, 32, 32, 1)).astype(np.float32)
              for _ in range(2 if hasattr(model.cfg, "audio_encoder") else 1)]
    batch = tuple(torch.from_numpy(x) for x in (act, *frames, act, *frames))
    noise = {k: torch.from_numpy(rng.gumbel(size=s).astype(np.float32))
             for k, s in model.noise_shapes(B, T).items()}
    noise["input"] = tuple(torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
                           for x in batch[:len(batch) // 2])
    return batch, noise


def _family_step_card_vs_cpu(cpu, dev) -> None:
    """``parity.check_train_step`` of ``cpu``'s copy on the card against it,
    on the first seed without Gumbel near-ties; no recurrence kernel."""
    card = type(cpu)(cpu.cfg).to(dev)
    card.load_state_dict(cpu.state_dict())
    for seed in range(10):
        batch, noise = _family_case(cpu, seed)
        if parity.train_step_near_ties(cpu, batch, noise) == 0:
            break
    kernels.reset_launch_counts()
    on_card = (tuple(x.to(dev) for x in batch),
               {k: v.to(dev) if k != "input" else tuple(x.to(dev) for x in v)
                for k, v in noise.items()})
    parity.check_train_step(card, cpu, on_card, (batch, noise))
    assert _no_launches()


@pytest.mark.gpu
def test_weighted_observe_and_shared_step_on_the_card_match_the_cpu(cuda_device):
    """WeightedMoPoE-MRSSM on its step loop: ``WorldModel.observe`` on the
    card against the CPU (deters, logits and weights within 1e-4,
    categories equal, before each row's first near-tie), the weights
    summing to 1 within 1e-5; a train step within 2e-5 / 3e-4 × scale. No
    recurrence kernel runs."""
    from multimodal_mtrssm_tpu_torch.models import WeightedMoPoEMRSSM
    from multimodal_mtrssm_tpu_torch.serving import WorldModel

    cpu = WeightedMoPoEMRSSM().init(torch.Generator().manual_seed(3))
    card = WorldModel(WeightedMoPoEMRSSM(cpu.cfg), cuda_device)
    card.model.load_state_dict(cpu.state_dict())
    batch, noise = _family_case(cpu, 11, B=8, T=30)
    kernels.reset_launch_counts()
    outs = []
    for m, dev in ((card.model, cuda_device), (cpu, torch.device("cpu"))):
        with torch.no_grad():
            obs = [x.to(dev) for x in batch[1:3]]
            g = [noise[k].to(dev) for k in ("g_init", "g_prior", "g_post")]
            init = m.initial_state(obs[0][:, 0], obs[1][:, 0], g[0])
            post, prior, w = m.rollout_representation_with_weights(batch[0].to(dev), *obs, init,
                                                                   g[1], g[2])
        outs.append(([post.deter, post.logits, post.stoch.round(), prior.logits,
                      prior.stoch.round(), w], init, post, prior, g))
    assert _no_launches()
    (got, *_), (ref, init, post, prior, g) = outs
    assert float((got[5].sum(-1) - 1).abs().max()) <= 1e-5
    tm = lambda x: x.transpose(0, 1)  # noqa: E731
    first = parity.first_near_tie([(post.logits + tm(g[2]), C, K),
                                   (prior.logits + tm(g[1]), C, K)])
    first = torch.where(parity.first_near_tie([((init.logits + g[0])[:, None], C, K)]) == 0,
                        0, first)
    parity.check_same_trajectories([x.cpu() for x in got], ref, (2, 4), first, 1e-4)
    _family_step_card_vs_cpu(cpu, cuda_device)


@pytest.mark.gpu
def test_rssm_train_step_on_the_card_matches_the_cpu(cuda_device):
    """The unimodal RSSM's step loop on the card: a train step on a
    4-tuple batch against the CPU within 2e-5 / 3e-4 × scale."""
    from multimodal_mtrssm_tpu_torch.models import RSSM

    _family_step_card_vs_cpu(RSSM().init(torch.Generator().manual_seed(4)), cuda_device)


@pytest.mark.gpu
def test_rssm_imagination_runs_on_the_rollout_kernel(cuda_device):
    """RSSM imagination on a CUDA model launches ``rollout.cu`` once, held
    to the plain transition and its Philox noise (``parity.check_rollout``)
    and to the plain route's rollout on the same noise; the plain route by
    name launches nothing."""
    from multimodal_mtrssm_tpu_torch.models import RSSM, RSSMConfig

    model = RSSM().init(torch.Generator().manual_seed(5)).to(cuda_device)
    plain = RSSM(RSSMConfig(use_pallas_train=False)).to(cuda_device)
    plain.load_state_dict(model.state_dict())
    rng = np.random.default_rng(6)
    B, T, seed = 8, 10, 7
    act = torch.tensor(rng.uniform(-1, 1, (B, T, 6)).astype(np.float32), device=cuda_device)
    obs0 = torch.tensor(rng.uniform(-1, 1, (B, 32, 32, 1)).astype(np.float32), device=cuda_device)
    g = torch.tensor(rng.gumbel(size=(B, C * K)).astype(np.float32), device=cuda_device)
    with torch.no_grad():
        init = model.initial_state(obs0, g)
        kernels.reset_launch_counts()
        got = model.rollout_transition(act, init, seed)
        assert kernels.launch_counts()["rollout"] == 1
        parity.check_rollout(model.transition.weights(), act, init.deter, init.stoch, seed,
                             (got.deter, got.logits, got.stoch), C, K)
        kernels.reset_launch_counts()
        ref = plain.rollout_transition(act, init, seed)
        assert _no_launches()
    parity.check_same_rollouts(got, ref, model.cfg, seed)


@pytest.mark.gpu
def test_weighted_refuses_use_pallas_train_on_a_cuda_model(cuda_device):
    """``use_pallas_train=True`` and ``"stacked"`` are refused; at
    ``"auto"`` a CUDA model imagines on the rollout kernel."""
    from multimodal_mtrssm_tpu_torch.models import WeightedMoPoEMRSSM, WeightedMRSSMConfig

    for value in (True, "stacked"):
        with pytest.raises(ValueError, match="1/3"):
            WeightedMoPoEMRSSM(WeightedMRSSMConfig(use_pallas_train=value)).to(cuda_device)
    model = WeightedMoPoEMRSSM().init(torch.Generator().manual_seed(8)).to(cuda_device)
    kernels.reset_launch_counts()
    _rollouts(model, cuda_device)
    assert kernels.launch_counts()["rollout"] == 1


# ---- data parallel on torch.distributed --------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("zero1", [False, True])
def test_nccl_world_of_one_step_is_the_single_process_step(cuda_device, zero1, tmp_path,
                                                           monkeypatch):
    """A train step of ``MRSSMConfig()`` at B=8 T=30 on an NCCL process
    group of one rank (the production backend: its init, the gradient's
    all-reduce, the global noise draw), with and without ZeRO-1, equals the
    non-distributed step bit for bit under deterministic cuDNN."""
    import datetime

    import torch.distributed as dist

    import _port_dist as side

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    kw = dict(family="mrssm", B=8, full=True, frames_T=30, zero1=zero1)
    alone = side.step_task(cuda_device, **kw)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        assert dist.get_backend() == "nccl"
        grouped = side.step_task(cuda_device, **kw)
    finally:
        dist.destroy_process_group()
    assert grouped["loss"] == alone["loss"]
    assert grouped["launches"]["recurrence_fwd"] == grouped["launches"]["recurrence_bwd"] == 1
    for part in ("grads", "weights"):
        for k, v in alone[part].items():
            np.testing.assert_array_equal(grouped[part][k], v, err_msg=f"{part} {k}")


@pytest.mark.gpu
def test_two_gloo_ranks_on_one_card_match_one_process(cuda_device, tmp_path):
    """Two ranks sharing the card over gloo (NCCL refuses two ranks on one
    device): the data-parallel step of ``MRSSMConfig()`` at a global B=8
    T=30, each rank's 4 rows on the kernels, equals the one-process step
    within the phase-4 bounds (the loss within 2e-5, the gradient within
    3e-4 × scale); each rank launches the recurrence forward and backward
    once."""
    from pathlib import Path

    import _port_dist as side
    from multimodal_mtrssm_tpu_torch.ops.kernels import build
    from multimodal_mtrssm_tpu_torch.parallel.spawn import spawn

    build.load_library()  # built once, before the ranks load it
    kw = dict(family="mrssm", B=8, full=True, frames_T=30)
    ranks = spawn("_port_dist:run_tasks", 2, "cuda", backend="gloo",
                  kwargs={"tasks": [("step_task", kw)]}, timeout_s=600, workdir=tmp_path,
                  paths=(str(Path(__file__).resolve().parent),), group_timeout_s=300)
    ref = side.step_task(cuda_device, **kw)
    got = [r[0] for r in ranks]
    assert [r["rows"] for r in got] == [(0, 4), (4, 8)]
    for r in got:
        assert r["launches"]["recurrence_fwd"] == r["launches"]["recurrence_bwd"] == 1
        np.testing.assert_allclose(r["loss"], ref["loss"], rtol=2e-5)
        scale = max(1.0, max(float(np.abs(g).max()) for g in ref["grads"].values()))
        for k, g in ref["grads"].items():
            np.testing.assert_allclose(r["grads"][k], g, rtol=0, atol=3e-4 * scale, err_msg=k)


# ---- full-model bf16 and the bf16 fused decoder -------------------------------------------


def decoder_f32_digest(dev) -> str:
    """The digest of the f32 fused decoder's frames, features' cotangent and
    weight gradients on the MRSSM vision decoder at N=240 (seeded features
    and cotangent)."""
    dec = _decoder("mrssm", dev)
    w = [t.detach() for t in fused_conv.decoder_weights(dec)]
    rng = np.random.default_rng(240)
    feats = torch.tensor(rng.standard_normal((240, 48)).astype(np.float32), device=dev)
    g = torch.tensor(rng.standard_normal((240, 32, 32, 1)).astype(np.float32), device=dev)
    with torch.no_grad():
        out = fused_conv.fused_decoder_forward_cuda(w, dec.cfg, feats)
        dx, dw = fused_conv.fused_decoder_backward_cuda(w, dec.cfg, feats, g, True)
    return _digest([out, dx, *dw])


# decoder_f32_digest on an NVIDIA H100 80GB HBM3, taken on the f32 decoder
# kernels as they stood before they became templates on their element type
# (the same digest on both trees, in one call).
DECODER_F32_DIGEST = "4dfd3336f064fb4b83f68c02967d1bbca5e4a459a917f316840f62f113c08ec1"


@pytest.mark.gpu
def test_fused_decoder_f32_bits_unchanged_by_the_bf16_kernels(cuda_device):
    assert decoder_f32_digest(cuda_device) == DECODER_F32_DIGEST


# Decoders of the bf16 kernels beyond the two models' (48- and 96-wide
# features): channel widths that are no multiple of 16 (a 1×1 projection
# 64 → 40, residual convs 40 ↔ 72, transposed convs to 24 and 12, a first
# linear of 63), and a 1×1 projection to 32 channels.
DEC_BF16_VARIANTS = {"not16": {"residual_input_size": 40, "residual_intermediate_size": 72,
                               "channels": (24, 12, 1), "linear_sizes": (63, 1024)},
                     "res_proj": {"residual_input_size": 32}}


@pytest.mark.gpu
@pytest.mark.parametrize("family,N", [
    (family, N) for N in (240, 241, 7, 1, 3840, 3) for family in
    ("mrssm", "mmtrssm", *DEC_BF16_VARIANTS)])
def test_fused_decoder_bf16_kernels_match_plain(cuda_device, family, N):
    """The bf16 decoder's forward against the plain bf16 version within
    1e-2 × scale and the f32 kernels within 0.1; its backward (every weight
    gradient and the features', bf16) against the plain bf16 backward within
    2e-2 × scale per tensor; two launches bit-identical, and the backward
    without the features' cotangent gives the same weight-gradient bits.
    The MRSSM decoder (48-wide features), the MMTRSSM decoder (96-wide) and
    :data:`DEC_BF16_VARIANTS`; N=1, 3, 7 and 241 leave a ragged tile of 2
    frames a block (N=241 also a last weight-gradient chunk of one frame)."""
    dec = _decoder(family, cuda_device, **DEC_BF16_VARIANTS.get(family, {}))
    w32 = [t.detach() for t in fused_conv.decoder_weights(dec)]
    w = [t.to(torch.bfloat16) for t in w32]
    rng = np.random.default_rng(N)
    f32 = torch.tensor(rng.standard_normal((N, dec.cfg.in_features)).astype(np.float32),
                       device=cuda_device)
    feats = f32.to(torch.bfloat16)
    g = torch.tensor(rng.standard_normal((N, 32, 32, 1)).astype(np.float32),
                     device=cuda_device).to(torch.bfloat16)
    with torch.no_grad():
        got = fused_conv.fused_decoder_bf16_forward_cuda(w, dec.cfg, feats)
        again = fused_conv.fused_decoder_bf16_forward_cuda(w, dec.cfg, feats)
        ref32 = fused_conv.fused_decoder_forward_cuda(w32, dec.cfg, f32)
        dx, dw = fused_conv.fused_decoder_bf16_backward_cuda(w, dec.cfg, feats, g, True)
        dx2, dw2 = fused_conv.fused_decoder_bf16_backward_cuda(w, dec.cfg, feats, g, True)
        none, dw3 = fused_conv.fused_decoder_bf16_backward_cuda(w, dec.cfg, feats, g, False)
        plain = fused_conv.fused_decoder_plain(w, dec.cfg, feats)
    ref_dx, ref_dw = fused_conv.fused_decoder_backward_plain(w, dec.cfg, feats, g, True)
    assert got.dtype == dx.dtype == torch.bfloat16 and all(t.dtype == torch.bfloat16 for t in dw)
    assert _scaled_err(got.float(), plain.float()) <= BF16_FWD_TOL
    assert float((got.float() - ref32).abs().max()) <= BF16_VS_F32
    parity.check_gradients([t.float() for t in (*dw, dx)], [t.float() for t in (*ref_dw, ref_dx)],
                           BF16_BWD_TOL)
    assert torch.equal(got, again)
    assert all(torch.equal(a, b) for a, b in zip([*dw, dx], [*dw2, dx2]))
    assert none is None and all(torch.equal(a, b) for a, b in zip(dw, dw3))


@pytest.mark.gpu
def test_fused_decoder_bf16_plan_takes_every_case(cuda_device):
    """Every decoder of the bf16 cases plans at N=1, 240 and 3840: 2 frames
    a block of both passes, the packed weights, the tiles of the
    weight-gradient pass, its frame chunks, and the gradient layout of the
    decoder's tensors."""
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    lib = build.load_library()
    for family in ("mrssm", "mmtrssm", *DEC_BF16_VARIANTS):
        dec = _decoder(family, cuda_device, **DEC_BF16_VARIANTS.get(family, {}))
        for N in (1, 240, 3840):
            sz = fused_conv.bf16_sizes(lib, fused_conv._dec_dims(dec.cfg, N))
            assert sz["fwd_frames"] == sz["bwd_frames"] == 2 and sz["dw_tiles"] >= 1
            assert sz["packed"] > 0 and sz["slots"] == -(-N // fused_conv._dw_chunk(N))
            assert sz["grads"] == sum(t.numel() for t in fused_conv.decoder_weights(dec))


def encoder_bf16_digest(dev) -> str:
    """The digest of the bf16 fused encoder's embedding, frames' cotangent
    and weight gradients on the MRSSM audio encoder at N=240 (seeded frames
    and cotangent), their bf16 bits."""
    enc = _encoder("model", dev)
    w = [t.detach().to(torch.bfloat16) for t in fused_conv.encoder_weights(enc)]
    rng = np.random.default_rng(240)
    x = torch.tensor(rng.uniform(-1, 1, (240, 32, 32, 1)).astype(np.float32),
                     device=dev).to(torch.bfloat16)
    g = torch.tensor(rng.standard_normal((240, enc.cfg.out_dim)).astype(np.float32),
                     device=dev).to(torch.bfloat16)
    with torch.no_grad():
        out = fused_conv.fused_encoder_bf16_forward_cuda(w, enc.cfg, x)
        dx, dw = fused_conv.fused_encoder_bf16_backward_cuda(w, enc.cfg, x, g, True)
    return _digest([t.view(torch.int16) for t in (out, dx, *dw)])


# encoder_bf16_digest on an NVIDIA H100 80GB HBM3, taken on the bf16 encoder
# kernels as they stood before their tensor-core pieces moved into
# csrc/bf16_mma.cuh (the same digest on both trees, in one call).
ENCODER_BF16_DIGEST = "7a9649ad7c2907ed6894bf703c90c35dbe1ebe844d4aad5836e21fafb73de839"


@pytest.mark.gpu
def test_fused_encoder_bf16_bits_unchanged_by_the_shared_header(cuda_device):
    assert encoder_bf16_digest(cuda_device) == ENCODER_BF16_DIGEST


@pytest.mark.gpu
def test_fused_decoder_apply_on_bf16_features_launches_the_bf16_kernels(cuda_device):
    """bf16 features through ``fused_decoder_apply``: a forward and its
    backward launch each bf16 decoder kernel once and nothing else, bf16
    frames out, the float32 parameters' gradients in float32; the bf16
    wrappers refuse float32 features."""
    dec = _decoder("mmtrssm", cuda_device)
    feats = torch.randn(2, 3, 96, device=cuda_device).to(torch.bfloat16).requires_grad_()
    kernels.reset_launch_counts()
    frames = kernels.fused_decoder_apply(dec, feats)
    frames.float().square().sum().backward()
    assert frames.shape == (2, 3, 32, 32, 1) and frames.dtype == torch.bfloat16
    assert feats.grad is not None and feats.grad.dtype == torch.bfloat16
    assert all(p.grad.dtype == torch.float32 and bool(p.grad.isfinite().all())
               for p in dec.parameters())
    assert kernels.launch_counts() == {**dict.fromkeys(kernels.LAUNCH_COUNTERS, 0),
                                      "fused_decoder_fwd_bf16": 1, "fused_decoder_bwd_bf16": 1}
    w = [t.detach().to(torch.bfloat16) for t in fused_conv.decoder_weights(dec)]
    with pytest.raises(ValueError, match="dtype"):
        fused_conv.fused_decoder_bf16_forward_cuda(w, dec.cfg, torch.zeros(2, 96,
                                                                           device=cuda_device))


@pytest.mark.gpu
@pytest.mark.parametrize("family,cfg_cls,layout", [
    (MoPoEMRSSM, MRSSMConfig, "nhwc"), (MoPoEMRSSM, MRSSMConfig, "fused_enc"),
    (MoPoEMMTRSSM, MMTRSSMConfig, "nhwc"), (MoPoEMMTRSSM, MMTRSSMConfig, "fused_enc")])
def test_full_bf16_train_step_on_the_card_matches_the_cpu(cuda_device, family, cfg_cls, layout):
    """A train step at ``compute_dtype=torch.bfloat16`` on the plain route
    (the bf16 recurrence, cuDNN's or the bf16 fused encoder's convs in
    bf16) against the CPU route, as ``parity.check_train_step`` with the
    bf16 bounds: loss terms within 1e-2 of the loss, gradients 5e-2 × scale;
    Gumbel near-ties of 1e-2 skipped for the next seed. No recurrence or
    rollout kernel, and at fused_enc the bf16 encoder kernels alone; the
    default ``"auto"`` refused, naming the plain route."""
    cfg = cfg_cls(compute_dtype=torch.bfloat16, use_pallas_train=False, conv_layout=layout)
    _train_step_card_vs_cpu(family, cfg, cuda_device, tie_eps=1e-2, rtol=1e-2, rel=5e-2,
                            shape=(2, 5), seeds=30)
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    bf16_enc = {"fused_encoder_fwd_bf16", "fused_encoder_bwd_bf16"}
    assert set(counts) == (bf16_enc if layout == "fused_enc" else set()), counts
    with pytest.raises(ValueError, match="use_pallas_train=False"):
        family(cfg_cls(compute_dtype=torch.bfloat16))


# ---- K-step dispatch: the train step as a CUDA graph --------------------------------------

KSTEP_ROUTES = {"mrssm": (MoPoEMRSSM, {}),
                "mrssm_fused_stacked": (MoPoEMRSSM, {"conv_layout": "fused_enc",
                                                     "use_pallas_train": "stacked"}),
                "mmtrssm": (MoPoEMMTRSSM, {}),
                "mmtrssm_fused": (MoPoEMMTRSSM, {"conv_layout": "fused_enc"}),
                "mrssm_16_mixed": (MoPoEMRSSM, {"conv_layout": "fused_enc",
                                                "conv_dtype": torch.bfloat16}),
                "mrssm_plain": (MoPoEMRSSM, {"use_pallas_train": False}),
                "mrssm_full_bf16": (MoPoEMRSSM, {"use_pallas_train": False,
                                                 "compute_dtype": torch.bfloat16}),
                "weighted": ("weighted", {}),
                "rssm": ("rssm", {})}


def _kstep_trainer(route: str, dev, episodes, log_dir, data=None, **kw):
    """A 2-epoch trainer of a route at B=8 T=30 on ``episodes`` (pipeline
    noise 0; the model's input noise where its config has one)."""
    from multimodal_mtrssm_tpu_torch.data import DataModuleConfig, EpisodeDataModule
    from multimodal_mtrssm_tpu_torch.models import (
        RSSM,
        RSSMConfig,
        WeightedMoPoEMRSSM,
        WeightedMRSSMConfig,
    )
    from multimodal_mtrssm_tpu_torch.train import Trainer, TrainerConfig

    family, over = KSTEP_ROUTES[route]
    modality = "multimodal"
    if family == "weighted":
        model = WeightedMoPoEMRSSM(WeightedMRSSMConfig())
    elif family == "rssm":
        model, modality = RSSM(RSSMConfig()), "vision"
    else:
        cfg = (MMTRSSMConfig if family is MoPoEMMTRSSM else MRSSMConfig)(**over)
        model = family(cfg)
    dm = EpisodeDataModule(DataModuleConfig(data_dir=str(episodes), batch_size=8,
                                            sequence_length=30, noise_std=0.0, seed=0,
                                            modality=modality, **(data or {})))
    return Trainer(model.to(dev), dm, TrainerConfig(max_epochs=2, seed=0, log_dir=str(log_dir),
                                                    **kw))


@pytest.fixture(scope="module")
def kstep_episodes(tmp_path_factory):
    """43 episodes: 34 train (4 batches of 8 and a tail of 2), 9 val (a
    batch and a tail of 1)."""
    from multimodal_mtrssm_tpu_torch.data import generate_synthetic_audio_mnist

    d = tmp_path_factory.mktemp("kstep")
    generate_synthetic_audio_mnist(d, n_episodes=43, seed=0)
    return d


def _same_fits(a, out_a, b, out_b) -> bool:
    rows = lambda out: [{k: v for k, v in r.items() if k != "seq_per_sec"}  # noqa: E731
                        for r in out["history"]]
    return (all(torch.equal(x, y) for x, y in zip(a.model.state_dict().values(),
                                                  b.model.state_dict().values()))
            and rows(out_a) == rows(out_b) and out_a["global_step"] == out_b["global_step"])


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(KSTEP_ROUTES))
def test_kstep_graphed_fit_is_the_eager_fit(cuda_device, tmp_path, kstep_episodes, route,
                                            monkeypatch):
    """Each route's fit at K=auto (4: a graphed chunk of 4 and the ragged
    tail an epoch; validation a graphed step and its tail) equals its eager
    K=1 fit bit for bit under deterministic cuDNN: weights, epoch rows,
    global step; the graph was captured and replayed."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    a = _kstep_trainer(route, cuda_device, kstep_episodes, tmp_path / "k1",
                       steps_per_dispatch=1)
    out_a = a.fit()
    b = _kstep_trainer(route, cuda_device, kstep_episodes, tmp_path / "auto")
    out_b = b.fit()
    assert b._resolve_spd() == 4 and b.chunk_steps[0].graphs
    assert b.chunk_steps[1].graphs
    assert _same_fits(a, out_a, b, out_b) and out_b["global_step"] == 10


@pytest.mark.gpu
def test_kstep_device_resident_fit_is_the_host_fit(cuda_device, tmp_path, kstep_episodes,
                                                   monkeypatch):
    """A device-resident fit (the streams uploaded once, batches gathered on
    the card) at K=auto equals the host-streamed one bit for bit."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    a = _kstep_trainer("mrssm", cuda_device, kstep_episodes, tmp_path / "host")
    out_a = a.fit()
    b = _kstep_trainer("mrssm", cuda_device, kstep_episodes, tmp_path / "dev",
                       data={"device_resident": True})
    out_b = b.fit()
    assert b.dm._dev_data is not None and b.dm._dev_data[0].type == "cuda"
    assert _same_fits(a, out_a, b, out_b)


@pytest.mark.gpu
def test_kstep_launch_counts_under_replay(cuda_device, tmp_path, kstep_episodes):
    """A captured step's launches are counted once a replay, the capture's
    own launches not at all: a fit's counts are the warm-ups' and the eager
    tails' plus the replays' (one recurrence forward and backward each)."""
    from multimodal_mtrssm_tpu_torch.train.graph import WARMUP_STEPS

    trainer = _kstep_trainer("mrssm", cuda_device, kstep_episodes, tmp_path / "run")
    kernels.reset_launch_counts()
    trainer.fit()
    counts = kernels.launch_counts()
    train_graph = next(iter(trainer.chunk_steps[0].graphs.values()))
    val_graph = next(iter(trainer.chunk_steps[1].graphs.values()))
    assert train_graph.launches == {"recurrence_fwd": 1, "recurrence_bwd": 1}
    assert val_graph.launches == {"recurrence_fwd": 1}
    # 8 replays and the warm-up steps of the train graph, 2 eager tails; 2
    # replays and the warm-ups of the validation graph, 2 eager tails.
    assert counts["recurrence_bwd"] == 8 + WARMUP_STEPS + 2
    assert counts["recurrence_fwd"] == 8 + WARMUP_STEPS + 2 + 2 + WARMUP_STEPS + 2
    before = kernels.launch_counts()
    kind, chunk = next(trainer.dm.train_batches_chunked(0, 4, cuda_device))
    trainer.chunk_steps[0](chunk, 0, 0, {})
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {
        "recurrence_fwd": 4, "recurrence_bwd": 4}


@pytest.mark.gpu
def test_kstep_preemption_inside_a_graphed_chunk(cuda_device, tmp_path, kstep_episodes,
                                                 monkeypatch):
    """SIGTERM during epoch 1's graphed chunk (after its 2nd replay): the
    chunk completes, the mid-epoch ``last`` holds its 4 batches, and the
    resumed fit ends bit for bit on the uninterrupted one."""
    import os
    import signal

    from multimodal_mtrssm_tpu_torch.train import graph

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    ref = _kstep_trainer("mrssm", cuda_device, kstep_episodes, tmp_path / "ref")
    ref.fit()
    real, calls = graph.GraphedStep.replay, [0]

    def replay(self, batch, seed):
        real(self, batch, seed)
        if self.optimizer is not None:
            calls[0] += 1
            if calls[0] == 6:
                os.kill(os.getpid(), signal.SIGTERM)

    with monkeypatch.context() as m:
        m.setattr(graph.GraphedStep, "replay", replay)
        cut = _kstep_trainer("mrssm", cuda_device, kstep_episodes, tmp_path / "cut")
        assert cut.fit()["preempted"]
    aux = cut.ckpt.aux("last")
    assert (aux["epoch"], aux["items_done"], aux["global_step"], aux["spd"]) == (1, 4, 9, 4)
    resumed = _kstep_trainer("mrssm", cuda_device, kstep_episodes, tmp_path / "cut")
    assert [r["epoch"] for r in resumed.fit(resume=True)["history"]] == [1]
    for a, b in zip(resumed.model.state_dict().values(), ref.model.state_dict().values()):
        assert torch.equal(a, b)


# ---- the staged host input path ----------------------------------------------------------


def _staging_dm(episodes, **kw):
    """The phase-12 episodes at B=8 T=30, native noise 0.1."""
    from multimodal_mtrssm_tpu_torch.data import DataModuleConfig, EpisodeDataModule

    return EpisodeDataModule(DataModuleConfig(data_dir=str(episodes), batch_size=8,
                                              sequence_length=30, noise_std=0.1, seed=0, **kw))


def _same_items(got, want) -> None:
    assert [i[0] for i in got] == [i[0] for i in want] and got
    for g, w in zip(got, want):
        assert all(x.device.type == "cuda" for x in g[1])
        assert all(torch.equal(x.cpu(), y) for x, y in zip(g[1], w[1]))


@pytest.mark.gpu
def test_staged_items_survive_a_slow_copy_and_a_slow_consumer(cuda_device, kstep_episodes,
                                                             monkeypatch):
    """Every train and validation item staged to the card (K=3 and K=1)
    equals its host item bit for bit while each copy is held back on the
    copy stream (a 20 ms spin before it) and the consumer sleeps 30 ms an
    item; the worker is never handed a buffer whose copy's event has not
    completed, and every copy is a pinned ``non_blocking`` one."""
    import time

    from multimodal_mtrssm_tpu_torch.data import staging

    events: dict[int, torch.cuda.Event] = {}
    early: list[int] = []
    real_upload, real_take = staging.Staging.upload, staging.Staging.take

    def upload(self, bufs, rows, scan):
        with torch.cuda.stream(self.stream):
            torch.cuda._sleep(20_000_000)
        assert all(t.is_pinned() for t in bufs[0])
        out, event = real_upload(self, bufs, rows, scan)
        events[bufs[0][0].data_ptr()] = event
        return out, event

    def take(self, lead):
        bufs = real_take(self, lead)
        event = events.get(bufs[0][0].data_ptr())
        if event is not None and not event.query():
            early.append(bufs[0][0].data_ptr())
        return bufs

    monkeypatch.setattr(staging.Staging, "upload", upload)
    monkeypatch.setattr(staging.Staging, "take", take)
    dm = _staging_dm(kstep_episodes)
    for k in (3, 1):
        want = list(dm.train_batches_chunked(1, k))
        got = []
        for item in dm.train_batches_chunked(1, k, cuda_device):
            time.sleep(0.03)
            got.append((item[0], tuple(x.clone() for x in item[1])))
        _same_items(got, want)
        _same_items(list(dm.val_batches_chunked(k, cuda_device)), list(dm.val_batches_chunked(k)))
    assert events and not early


@pytest.mark.gpu
def test_staged_stream_early_close_frees_the_ring(cuda_device, kstep_episodes, monkeypatch):
    """Closing a staged stream after its first item joins the worker and
    drops every pinned buffer of its ring."""
    import gc
    import threading
    import weakref

    from multimodal_mtrssm_tpu_torch.data import staging

    rings = []
    real_init = staging.Staging.__init__

    def init(self, *args, **kw):
        real_init(self, *args, **kw)
        rings.append([weakref.ref(t) for q in self._free.values() for bufs in list(q.queue)
                      for t in bufs[0]])

    monkeypatch.setattr(staging.Staging, "__init__", init)
    dm = _staging_dm(kstep_episodes)
    dm.setup()
    before = threading.active_count()
    stream = dm.train_batches_chunked(0, 1, cuda_device)
    kind, batch = next(stream)
    assert threading.active_count() == before + 1 and rings and rings[0]
    stream.close()
    del stream
    gc.collect()
    assert threading.active_count() == before
    assert all(ref() is None for ref in rings[0])


@pytest.mark.gpu
def test_mesh_rows_take_the_staged_copy(cuda_device, kstep_episodes, tmp_path, monkeypatch):
    """A mesh rank's rows of each batch (the trainer's ``_rows`` on a mesh
    of 2, rank 1) are staged alone: each item holds those rows of the host
    item, bit for bit, and ``(lo, hi, n)``; a scan item's rows go a batch
    at a time, each copy contiguous and pinned."""
    from types import SimpleNamespace

    from multimodal_mtrssm_tpu_torch.data import staging
    from multimodal_mtrssm_tpu_torch.parallel.mesh import row_range

    copies = []
    real_h2d = staging.Staging._h2d

    def h2d(self, dev, host):
        copies.append((host.is_pinned(), host.is_contiguous()))
        return real_h2d(self, dev, host)

    monkeypatch.setattr(staging.Staging, "_h2d", h2d)
    trainer = _kstep_trainer("mrssm", cuda_device, kstep_episodes, tmp_path / "run")
    trainer.mesh = SimpleNamespace(world=2, rank=1)
    dm = trainer.dm
    want = list(dm.train_batches_chunked(0, 3))
    got = list(trainer._items(dm.train_batches_chunked(0, 3, cuda_device, rows=trainer._rows)))
    assert len(got) == len(want) == 3 and [w[0] for w in want] == ["scan", "step", "step"]
    for (chunk, rows, b), (kind, host) in zip(got, want):
        n = host[0].shape[1 if kind == "scan" else 0]
        lo, hi = row_range(n, 2, 1)
        assert rows == (lo, hi, n) and b == hi - lo and 0 < lo < hi == n
        lead = host if kind == "scan" else tuple(x[None] for x in host)
        for x, y in zip(chunk, lead):
            assert x.device.type == "cuda" and torch.equal(x.cpu(), y[:, lo:hi])
    assert copies and all(pinned and contiguous for pinned, contiguous in copies)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["memory", "pack"])
def test_native_noise_fit_at_k_is_the_k1_fit(cuda_device, tmp_path, kstep_episodes, layout,
                                             monkeypatch):
    """At ``noise_std=0.1`` (the native library's noise), in memory and
    from a pack, the K=auto fit on staged chunks equals the K=1 fit bit for
    bit under deterministic cuDNN."""
    from multimodal_mtrssm_tpu_torch.data.pack import pack_episodes

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    data_dir = kstep_episodes
    if layout == "pack":
        data_dir = tmp_path / "packed"
        pack_episodes(kstep_episodes, data_dir / "pack")
    fits = []
    for name, spd in (("k1", 1), ("auto", "auto")):
        t = _kstep_trainer("mrssm", cuda_device, data_dir, tmp_path / name,
                           steps_per_dispatch=spd)
        t.dm.cfg.noise_std = 0.1
        fits.append((t, t.fit()))
    assert fits[1][0].dm._raw == (layout == "pack") and fits[1][0].chunk_steps[0].graphs
    assert _same_fits(*fits[0], *fits[1])
