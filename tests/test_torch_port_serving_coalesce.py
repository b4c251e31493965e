"""Request coalescing in the port's server, held to the same requests served
alone, on the CPU (the plain versions of the kernels).

The rollouts' Philox noise is keyed row by row: a coalesced batch's plain
draw is, row for row and bit for bit, the concatenation of each request's
own draw. Coalesced ``/observe`` and ``/imagine`` replies through
``InferenceServer`` then equal the replies to the same requests served
alone: stochs equal, deters, logits, integrators and frames within 1e-6.
They are not bit-identical on the CPU: its GEMMs pick their blocking, and
so their summation order, by the row count (a product over 1-8 rows and
one over 16 rows of the same inputs differ in their last bits), and a
coalesced call has more rows than each request.
"""

import dataclasses
import io
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu_torch.models import (
    MMTRSSMConfig,
    MoPoEMMTRSSM,
    MoPoEMRSSM,
    MRSSMConfig,
)
from multimodal_mtrssm_tpu_torch.nn.conv import EncoderConfig
from multimodal_mtrssm_tpu_torch.ops import kernels
from multimodal_mtrssm_tpu_torch.ops.kernels import rollout
from multimodal_mtrssm_tpu_torch.ops.kernels.rollout import philox_gumbel, row_keys
from multimodal_mtrssm_tpu_torch.ops.kernels.rollout_mt import philox_mt_gumbel
from multimodal_mtrssm_tpu_torch.server import (
    InferenceServer,
    _ImagineBatcher,
    _Pending,
    _PendingImagine,
    _PendingObserve,
)
from multimodal_mtrssm_tpu_torch.serving import WorldModel

TOL = 1e-6
# (B, T, seed) of a mixed window: B ∈ {1, 2, 3, 8}, T ∈ {3, 5, 7, 10}.
MIX = ((1, 5, 3), (2, 10, 4), (3, 7, 2**63 + 5), (8, 3, 6))


def _enc() -> EncoderConfig:
    from conftest import small_encoder_config

    return EncoderConfig(**dataclasses.asdict(small_encoder_config()))


@pytest.fixture(scope="module", params=["mrssm", "mmtrssm"])
def wm(request):
    family, cfg = {"mrssm": (MoPoEMRSSM, MRSSMConfig),
                   "mmtrssm": (MoPoEMMTRSSM, MMTRSSMConfig)}[request.param]
    model = family(cfg(audio_encoder=_enc(), vision_encoder=_enc(), init_proj_cells=32))
    return WorldModel(model.init(torch.Generator().manual_seed(7)), "cpu")


def _obs(rng, b: int, t: int, width: int = 6):
    return (rng.uniform(-1, 1, (b, t, width)).astype(np.float32),
            rng.uniform(-1, 1, (b, t, 32, 32, 1)).astype(np.float32),
            rng.uniform(-1, 1, (b, t, 32, 32, 1)).astype(np.float32))


def _same_state(got, ref, name: str) -> float:
    """Stochs equal and every other field within ``TOL``; the largest error."""
    worst = 0.0
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        assert a.shape == b.shape, (name, f.name)
        if f.name.startswith("stoch"):  # one-hot (or straight-through) samples
            assert torch.equal(a > 0.5, b > 0.5), (name, f.name)
        worst = max(worst, float((a - b).abs().max()))
    assert worst <= TOL, (name, worst)
    return worst


def _same_frames(got: dict, ref: dict, name: str) -> None:
    assert set(got) == set(ref)
    for k in ref:
        a, b = np.asarray(got[k]), np.asarray(ref[k])
        assert a.shape == b.shape, (name, k)
        assert float(np.abs(a - b).max()) <= TOL, (name, k)


def _post_npz(port: int, path: str, payload: dict) -> dict:
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in payload.items()})
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=buf.getvalue(),
                                 headers={"Content-Type": "application/x-npz"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        body = resp.read()
        if "npz" not in resp.headers.get("Content-Type", ""):
            return json.loads(body)
        with np.load(io.BytesIO(body), allow_pickle=False) as z:
            return {k: z[k] for k in z.files}


# ---- per-row Philox keys ------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 77, 2**32 + 9, 2**63, 2**64 - 1])
def test_an_int_seed_is_its_row_keys(seed):
    """An ``int`` seed draws what its ``row_keys`` (the seed on every row,
    indices 0..B-1) draw, bit for bit, at both rollouts' sites."""
    keys = row_keys(seed, 5)
    assert keys[1].tolist() == list(range(5))
    assert torch.equal(philox_gumbel(seed, 6, 5, 3, 5), philox_gumbel(keys, 6, 5, 3, 5))
    for a, b in zip(philox_mt_gumbel(seed, 4, 5), philox_mt_gumbel(keys, 4, 5)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("site", ["mrssm", "mt"])
def test_a_coalesced_draw_is_each_requests_own(site):
    """The draw of concatenated rows, each with its request's seed and its
    index inside the request, is row for row and bit for bit each
    request's own draw."""
    draw = (lambda s, T, B: [philox_gumbel(s, T, B, 4, 4)]) if site == "mrssm" else \
        (lambda s, T, B: list(philox_mt_gumbel(s, T, B)))
    keys = [row_keys(s, b) for b, _, s in MIX]
    T = max(t for _, t, _ in MIX)
    rows = sum(b for b, _, _ in MIX)
    together = draw(tuple(torch.cat(k) for k in zip(*keys)), T, rows)
    off = 0
    for b, t, s in MIX:
        for g, own in zip(together, draw(s, t, b)):
            assert torch.equal(g[:t, off:off + b], own)
        off += b


def test_row_keys_refuse_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="64 unsigned bits"):
        row_keys(2**64, 3)
    with pytest.raises(ValueError, match="row_index"):
        row_keys((torch.zeros(3, dtype=torch.int64), torch.arange(2)), 3)
    with pytest.raises(ValueError, match="row_seed"):
        row_keys((torch.zeros(3, dtype=torch.int32), torch.arange(3)), 3)


# ---- coalesced requests against the same requests alone ---------------------------


def _observe_items(rng, decode=True):
    return [_PendingObserve(*_obs(rng, b, t), seed, decode, True) for b, t, seed in MIX]


def _alone(server, it, raw: bool) -> dict:
    """``it`` sent alone to a window-0 ``server``."""
    if isinstance(it, _PendingObserve):
        return server._observe({"actions": it.actions, "audio": it.audio, "vision": it.vision,
                                "seed": it.seed, "decode": it.decode}, raw)
    return server._imagine({"state_id": server.states.put(it.state), "actions": it.actions,
                            "seed": it.seed, "decode": it.decode}, raw)


def test_coalesced_observe_and_imagine_equal_each_request_alone(wm):
    """A window of mixed observes, then of imagines from their states, run
    as one call each at (sum B, max T): each reply's state and frames equal
    the same request's alone; one rollout call serves the four imagines;
    nothing is retried."""
    server = InferenceServer(wm, port=0, batch_window_ms=0.0)
    try:
        items = _observe_items(np.random.default_rng(1))
        server._run_observe_batch(items)
        rng = np.random.default_rng(2)
        plans = []
        for it, (b, t, seed) in zip(items, MIX):
            assert it.error is None
            alone = _alone(server, it, True)
            assert (it.result["batch"], it.result["t"]) == (b, t)
            _same_state(server.states.get(it.result["state_id"]),
                        server.states.get(alone["state_id"]), "observe state")
            _same_frames(it.result["recon"], alone["recon"], "observe frames")
            plans.append(_PendingImagine(server.states.get(it.result["state_id"]),
                                         rng.uniform(-1, 1, (b, 11 - t, 6)).astype(np.float32),
                                         seed + 1, True, False))
        calls = []
        real = wm.model.rollout_transition
        wm.model.rollout_transition = lambda *a, **k: calls.append(a[0].shape) or real(*a, **k)
        try:
            server._run_imagine_batch(plans)
        finally:
            del wm.model.rollout_transition
        assert calls == [(14, 8, 6)]
        for it in plans:
            assert it.error is None
            alone = _alone(server, it, False)
            assert it.result["t"] == it.actions.shape[1]
            _same_state(server.states.get(it.result["state_id"]),
                        server.states.get(alone["state_id"]), "imagine state")
            _same_frames(it.result["frames"], alone["frames"], "imagine frames")
        assert server.retries == 0
    finally:
        server.stop()


def test_concurrent_http_requests_coalesce_and_keep_their_results(wm):
    """Eight concurrent ``/imagine`` requests through HTTP with a window:
    fewer device calls than requests, each reply equal to its request
    served alone by a window-0 server on the same model."""
    rng = np.random.default_rng(3)
    alone = InferenceServer(wm, port=0)
    server = InferenceServer(wm, port=0, batch_window_ms=300.0, batch_max=8)
    server.start()
    try:
        starts = []
        for b, t, seed in MIX * 2:
            out = _alone(alone, _PendingObserve(*_obs(rng, b, t), seed, False, False), False)
            starts.append(alone.states.get(out["state_id"]))
        reqs = []
        for i, (state, (b, t, seed)) in enumerate(zip(starts, MIX * 2)):
            sid = server.states.put(state)
            reqs.append({"state_id": sid, "seed": seed + i,
                         "actions": rng.uniform(-1, 1, (b, t, 6)).astype(np.float32)})
        replies: list = [None] * len(reqs)

        def send(i):
            replies[i] = _post_npz(server.port, "/imagine", reqs[i])

        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert len(server.batcher.batch_sizes) < len(reqs)
        assert sum(server.batcher.batch_sizes) == len(reqs)
        for got, req, state in zip(replies, reqs, starts):
            ref = _alone(alone, _PendingImagine(state, req["actions"], req["seed"], True, True),
                         True)
            _same_frames({k[len("frames/"):]: v for k, v in got.items() if k.startswith("frames/")},
                         ref["frames"], "http imagine")
            _same_state(server.states.get(str(got["state_id"])),
                        alone.states.get(ref["state_id"]), "http imagine state")
        assert server.retries == 0
    finally:
        server.stop()
        alone.stop()


@pytest.mark.parametrize("route", ["observe", "imagine"])
def test_a_malformed_request_fails_alone(wm, route):
    """A request with the wrong action width among well-formed ones: the
    coalesced call fails, every request is re-run alone (the retry count
    shows the three), the neighbours succeed and the bad one fails."""
    server = InferenceServer(wm, port=0, batch_window_ms=0.0)
    try:
        rng = np.random.default_rng(4)
        items = _observe_items(rng)[:3]
        if route == "observe":
            items[1].actions = items[1].actions[..., :5]
            server._run_observe_batch(items)
        else:
            server._run_observe_batch(items)
            items = [_PendingImagine(server.states.get(it.result["state_id"]),
                                     rng.uniform(-1, 1, (it.actions.shape[0], 4, 6)).astype(
                                         np.float32), 9, True, True) for it in items]
            items[1].actions = items[1].actions[..., :5]
            server._run_imagine_batch(items)
        assert server.retries == 3
        assert isinstance(items[1].error, ValueError) and "width" in str(items[1].error)
        assert items[0].error is None and items[2].error is None
        assert items[0].result is not None and items[2].result is not None
        assert server._health()["retries"] == 3
    finally:
        server.stop()


@pytest.mark.parametrize("route", ["observe", "imagine"])
def test_a_failed_coalesced_call_stores_no_state(wm, route):
    """States are stored only after the whole coalesced call succeeded: a
    call that fails at its decode leaves nothing in the store, so no
    orphaned state takes the slot of a live one; the re-runs alone then
    store one state each."""
    server = InferenceServer(wm, port=0, batch_window_ms=0.0)
    try:
        rng = np.random.default_rng(5)
        items = _observe_items(rng)[:3]
        if route == "imagine":
            server._run_observe_batch(items)
            items = [_PendingImagine(server.states.get(it.result["state_id"]),
                                     rng.uniform(-1, 1, (it.actions.shape[0], 3, 6)).astype(
                                         np.float32), 9, True, True) for it in items]
        stored = len(server.states._d)
        real, calls = wm.decode, []

        def decode_fails_once(state):
            calls.append(state.batch_size)
            if len(calls) == 1:
                raise RuntimeError("decode failed")
            return real(state)

        wm.decode = decode_fails_once
        try:
            (server._run_observe_batch if route == "observe" else server._run_imagine_batch)(items)
        finally:
            del wm.decode
        assert calls[0] == 6 and server.retries == 3
        assert all(it.error is None for it in items)
        assert len(server.states._d) == stored + 3
    finally:
        server.stop()


def test_window_zero_runs_a_request_as_a_batch_of_one(wm, monkeypatch):
    """Without a window there is no batcher thread: each request runs at
    once, on the calling thread, through the batch function with a batch
    of one (``observe_many`` / ``imagine_many`` on one request)."""
    server = InferenceServer(wm, port=0)
    try:
        assert server.batcher is None and server.observe_batcher is None
        seen = []
        for name in ("observe_many", "imagine_many"):
            real = getattr(wm, name)
            monkeypatch.setattr(wm, name, lambda reqs, real=real, name=name: (
                seen.append((name, len(reqs), threading.current_thread())) or real(reqs)))
        obs = dict(zip(("actions", "audio", "vision"), _obs(np.random.default_rng(6), 2, 3)))
        out = server._observe({**obs, "seed": 1})
        server._imagine({"state_id": out["state_id"], "actions": obs["actions"], "seed": 2,
                         "decode": False})
        me = threading.current_thread()
        assert seen == [("observe_many", 1, me), ("imagine_many", 1, me)]
    finally:
        server.stop()


def test_a_stopped_batcher_refuses_new_requests():
    """``submit`` after ``stop`` raises instead of waiting for a thread
    that has ended."""
    batcher = _ImagineBatcher(lambda items: None, window_ms=1.0, max_batch=2)
    batcher.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        batcher.submit(_Pending(0, False, False))


def test_the_batcher_honours_its_window_and_max():
    """Items submitted together within the window run as one batch of at
    most ``max_batch``; a lone item waits out the window first."""
    seen = []

    def run(items):
        seen.append(len(items))
        for it in items:
            it.result = {"n": len(items)}

    batcher = _ImagineBatcher(run, window_ms=200.0, max_batch=3)
    try:
        t0 = time.monotonic()
        batcher.submit(_PendingImagine(None, None, 0, False, False))
        assert time.monotonic() - t0 >= 0.18 and seen == [1]
        out: list = []
        threads = [threading.Thread(target=lambda: out.append(batcher.submit(
            _PendingImagine(None, None, 0, False, False)))) for _ in range(5)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(10)
        assert len(out) == 5 and seen[1:] and max(seen[1:]) <= 3 and sum(seen[1:]) == 5
        assert seen[1] == 3  # the window filled to its max before it ran
    finally:
        batcher.stop()


# ---- the rollout route -------------------------------------------------------------


def test_imagine_launches_the_rollout_kernel_on_per_row_keys(wm, monkeypatch):
    """On a device whose route is the kernel (``_route`` giving None, as on
    the card), ``imagine`` and ``imagine_many`` of the same request launch
    the rollout kernel once each, on per-row keys equal to the seed's
    ``row_keys``, and give the same bits."""
    launched = []
    fam = "mt_rollout" if isinstance(wm.model, MoPoEMMTRSSM) else "rollout"
    mod = kernels.rollout_mt if fam == "mt_rollout" else rollout
    name = "rollout_mt_cuda" if fam == "mt_rollout" else "rollout_cuda"
    plain = getattr(mod, name.replace("cuda", "plain"))
    post, _ = wm.observe(*_obs(np.random.default_rng(6), 2, 3), seed=1)
    monkeypatch.setattr(kernels, "_route", lambda device, act: None)
    monkeypatch.setattr(mod, name, lambda *a, **k: launched.append(a) or plain(*a, **k))
    plan = np.zeros((2, 4, 6), np.float32)
    seed_at = 3 if fam == "mt_rollout" else 4
    one = wm.imagine(plan, post[:, -1], seed=3)
    many = wm.imagine_many([(plan, post[:, -1], 3)])
    assert len(launched) == 2
    for call in launched:
        for got, want in zip(call[seed_at], row_keys(3, 2)):
            assert torch.equal(got, want)
    for f in dataclasses.fields(one):
        assert torch.equal(getattr(one, f.name), getattr(many, f.name))


def test_world_model_refuses_a_unimodal_model():
    class Unimodal(torch.nn.Module):
        def initial_state(self, obs0, gumbel):
            return obs0

    with pytest.raises(TypeError, match="single observation"):
        WorldModel(Unimodal(), "cpu")


def test_uncoalesced_imagine_still_matches_jax():
    """Window 0: ``/imagine`` through the server is the JAX transition core
    on the bridged weights, sampled with the seed's Philox noise (the
    route ``test_torch_port_serving`` holds ``WorldModel.imagine`` to)."""
    import jax
    import jax.numpy as jnp

    from conftest import small_encoder_config
    from multimodal_mtrssm_tpu.models.mrssm import MoPoEMRSSM as JaxMoPoEMRSSM
    from multimodal_mtrssm_tpu.models.mrssm import MRSSMConfig as JaxMRSSMConfig
    from multimodal_mtrssm_tpu.ops.pallas import rollout as jax_rollout
    from multimodal_mtrssm_tpu.train.torch_export import export_reference_state_dict
    from multimodal_mtrssm_tpu_torch.train.weights import load_reference_state_dict

    enc = small_encoder_config()
    jmodel = JaxMoPoEMRSSM(JaxMRSSMConfig(audio_encoder=enc, vision_encoder=enc))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(21))
    port = MoPoEMRSSM(MRSSMConfig(audio_encoder=_enc(), vision_encoder=_enc()))
    load_reference_state_dict(port, export_reference_state_dict(params))
    server = InferenceServer(WorldModel(port, "cpu"), port=0)
    try:
        observed = _alone(server, _PendingObserve(*_obs(np.random.default_rng(8), 3, 4), 5,
                                                  False, True), True)
        start = server.states.get(observed["state_id"])
        plan = np.random.default_rng(9).uniform(-1, 1, (3, 6, 6)).astype(np.float32)
        out = server._imagine({"state_id": observed["state_id"], "actions": plan, "seed": 12})
        got = server.states.get(out["state_id"])
    finally:
        server.stop()
    noise = philox_gumbel(12, 6, 3, 4, 4).numpy()
    deter, stoch = jnp.asarray(start.deter.numpy()), jnp.asarray(start.stoch.numpy())
    for t in range(6):
        deter, logits = jmodel._transition_core(params, jnp.asarray(plan[:, t]), stoch, deter)
        stoch = jax_rollout.onehot_blocks(logits + noise[t], 4, 4)
    np.testing.assert_allclose(got.deter.numpy(), np.asarray(deter), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(logits), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.stoch.numpy(), np.asarray(stoch))
