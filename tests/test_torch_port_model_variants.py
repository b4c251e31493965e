"""The unimodal RSSM and WeightedMoPoE-MRSSM families of the port against
the JAX package, on the CPU.

Each small model (JAX's ``ENC`` widths: channels (4, 8); narrow decoders)
holds the same weights in both packages (``_port_models.variant_family``,
the port's seeded init exported into JAX params), and the port is given
the per-step Gumbel draws JAX's scan makes from its key
(``_port_models.jax_scan_gumbels``: JAX's RSSM splits its key as MRSSM
does, ``rssm.py:194-213``) and JAX's input normals. ``shared_step``'s
losses are held within rtol 2e-5 and every gradient within 3e-4 ×
max(1, max|JAX|), as the plain route's tests hold MRSSM
(``test_torch_port_plain_route.py``); the weighted model's subset weights
``[B, T, 3]`` and states within 1e-5. Then the unimodal batches bit for
bit, the weighted model's refusals, fits, checkpoints and serving, and the
weights chart. Each JAX function is jitted once.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.data import pipeline as jax_pipeline
from multimodal_mtrssm_tpu_torch import server as server_mod
from multimodal_mtrssm_tpu_torch.data import episodes, pipeline
from multimodal_mtrssm_tpu_torch.models import (
    RSSM,
    MoPoEMRSSM,
    MRSSMConfig,
    RSSMConfig,
    WeightedMoPoEMRSSM,
    WeightedMRSSMConfig,
)
from multimodal_mtrssm_tpu_torch.models.weighted_mopoe import plot_weights_timeseries
from multimodal_mtrssm_tpu_torch.ops import kernels
from multimodal_mtrssm_tpu_torch.serving import WorldModel
from multimodal_mtrssm_tpu_torch.train import CheckpointManager, Trainer, TrainerConfig
from multimodal_mtrssm_tpu_torch.train.config import load_experiment
from multimodal_mtrssm_tpu_torch.viz.callback import LogRSSMOutput
from _port_models import jax_scan_gumbels, to_jax_state, variant_family
from _port_native import jax_native as jax_native  # noqa: F401 (a fixture)
from _port_threads import _one_intra_op_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
B, T = 2, 4
RTOL, REL = 2e-5, 3e-4
NOISES = [0.0, (0.1, 0.2)]


def _batch(seed: int, streams: int):
    """A batch of ``streams`` input streams (action and frames) and their
    targets, numpy float32."""
    rng = np.random.default_rng(seed)
    act = rng.uniform(-1, 1, (B, T, 6)).astype(np.float32)
    frames = [rng.uniform(-1, 1, (B, T, 32, 32, 1)).astype(np.float32)
              for _ in range(streams - 1)]
    return (act, *frames, act, *frames)


def _input_normals(key, batch, n: int) -> tuple[np.ndarray, ...]:
    """The standard normals JAX's ``shared_step`` adds to its ``n`` input
    streams (``_add_input_noise`` on the key's third split)."""
    keys = jax.random.split(jax.random.split(key, 3)[2], n)
    return tuple(np.asarray(jax.random.normal(k, x.shape, jnp.float32))
                 for k, x in zip(keys, batch[:n]))


def _assert_step_matches(name: str, std) -> dict:
    """``shared_step``'s losses and gradients of the port against
    ``jax.value_and_grad`` of JAX's on the same weights, batch and noise.
    Returns the port's gradients."""
    jmodel, params, port, export = variant_family(name, std)
    n = 2 if name == "rssm" else 3
    batch = _batch(3, n)
    key = jax.random.PRNGKey(4)

    def loss(p):
        d = jmodel.shared_step(p, tuple(map(jnp.asarray, batch)), key)
        return d["loss"], d

    (_, ref), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    noise = {k: torch.tensor(v) for k, v in jax_scan_gumbels(key, port.cfg, B, T).items()}
    noise["input"] = tuple(map(torch.tensor, _input_normals(key, batch, n)))
    port.zero_grad(set_to_none=True)
    out = port.shared_step(tuple(map(torch.from_numpy, batch)), noise)
    out["loss"].backward()
    for k in ref:
        np.testing.assert_allclose(float(out[k].detach()), float(ref[k]), rtol=RTOL, err_msg=k)
    got = {n_: p.grad for n_, p in port.named_parameters()}
    want = export(grads)
    assert set(got) == set(want)
    for n_, g in want.items():
        scale = max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(got[n_].numpy(), g, rtol=0, atol=REL * scale, err_msg=n_)
    return got


# ---- the unimodal RSSM against JAX ---------------------------------------------------------


@pytest.mark.parametrize("std", NOISES)
def test_rssm_shared_step_matches_jax(std):
    """RSSM's ELBO and every gradient, without input noise and with
    ``(action, obs)`` stds fed JAX's normals."""
    kernels.reset_launch_counts()
    _assert_step_matches("rssm", std)
    assert kernels.launch_counts() == dict.fromkeys(kernels.LAUNCH_COUNTERS, 0)


def test_rssm_imagination_replays_through_jax():
    """The port's imagination (the rollout kernel's plain version on the
    CPU, its Philox noise): replayed through JAX's RSSM transition on the
    port's sampled stochs, the deters and logits agree, and each stoch is
    the one-hot argmax of its logits plus the kernel's noise."""
    jmodel, params, port, _ = variant_family("rssm")
    rng = np.random.default_rng(5)
    obs0 = torch.from_numpy(rng.uniform(-1, 1, (B, 32, 32, 1)).astype(np.float32))
    plan = torch.from_numpy(rng.uniform(-1, 1, (B, 6, 6)).astype(np.float32))
    with torch.no_grad():
        init = port.initial_state(obs0, torch.from_numpy(rng.gumbel(size=(B, 16))
                                                         .astype(np.float32)))
        imagined = port.rollout_transition(plan, init, 7)
    deter, stoch = jnp.asarray(init.deter.numpy()), jnp.asarray(init.stoch.numpy())
    noise = kernels.philox_gumbel(7, 6, B, 4, 4).numpy()
    for t in range(6):
        deter, logits = jmodel._transition_core(params, jnp.asarray(plan[:, t].numpy()), stoch,
                                                deter)
        np.testing.assert_allclose(imagined.deter[:, t].numpy(), deter, rtol=0, atol=1e-5)
        np.testing.assert_allclose(imagined.logits[:, t].numpy(), logits, rtol=0, atol=1e-5)
        scores = (imagined.logits[:, t].numpy() + noise[t]).reshape(B, 4, 4)
        want = np.eye(4, dtype=np.float32)[scores.argmax(-1)].reshape(B, 16)
        np.testing.assert_array_equal(imagined.stoch[:, t].numpy(), want)
        stoch = jnp.asarray(imagined.stoch[:, t].numpy())


def test_rssm_config_refusals_and_routes():
    assert RSSM(RSSMConfig(use_pallas_train=False)).plain
    assert not RSSM(RSSMConfig()).plain
    with pytest.raises(ValueError, match="MRSSM-only"):
        RSSMConfig(use_pallas_train="stacked")
    assert RSSMConfig(compute_dtype=torch.bfloat16).compute_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="compute_dtype"):
        RSSMConfig(compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="remat"):
        RSSMConfig(remat="yes")


def test_rssm_remat_trains_as_without():
    """``remat`` checkpoints each step of the loop and recomputes it in the
    backward: the same gradients, bit for bit."""
    _, _, port, _ = variant_family("rssm")
    other = RSSM(dataclasses.replace(port.cfg, remat=True))
    other.load_state_dict(port.state_dict())
    batch = tuple(map(torch.from_numpy, _batch(8, 2)))
    noise = port.draw_noise(B, T, torch.Generator().manual_seed(9))
    grads = []
    for m in (port, other):
        m.zero_grad(set_to_none=True)
        m.shared_step(batch, noise)["loss"].backward()
        grads.append([p.grad for p in m.parameters()])
    assert all(torch.equal(x, y) for x, y in zip(*grads))


# ---- the weighted model against JAX --------------------------------------------------------


def test_weighted_posterior_mix_matches_jax():
    jmodel, params, port, _ = variant_family("weighted")
    rng = np.random.default_rng(6)
    deter, a, v = (rng.standard_normal((3, d)).astype(np.float32) for d in (32, 16, 16))
    with torch.no_grad():
        mixed, w = port._posterior_mix(*map(torch.from_numpy, (deter, a, v)))
    jm, (jw,) = jmodel._posterior_mix(params, *map(jnp.asarray, (deter, a, v)))
    np.testing.assert_allclose(mixed.numpy(), jm, rtol=0, atol=1e-5)
    np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=1e-5)


def test_weighted_rollout_with_weights_matches_jax():
    """Posterior, prior and the subset weights ``[B, T, 3]`` over a rollout
    from the same initial state, on the per-step draws of JAX's key."""
    jmodel, params, port, _ = variant_family("weighted")
    act, audio, vision = _batch(7, 3)[:3]
    rng = np.random.default_rng(8)
    with torch.no_grad():
        init = port.initial_state(torch.from_numpy(audio[:, 0]), torch.from_numpy(vision[:, 0]),
                                  torch.from_numpy(rng.gumbel(size=(B, 16)).astype(np.float32)))
    key = jax.random.PRNGKey(11)
    gumbel = lambda k: np.asarray(jax.random.gumbel(k, (B, 4, 4), jnp.float32)).reshape(B, 16)  # noqa: E731
    sites = [tuple(map(gumbel, jax.random.split(k))) for k in jax.random.split(key, T)]
    g_prior, g_post = (torch.from_numpy(np.stack([s[i] for s in sites])) for i in (0, 1))
    with torch.no_grad():
        post, prior, w = port.rollout_representation_with_weights(
            *map(torch.from_numpy, (act, audio, vision)), init, g_prior, g_post)
    jpost, jprior, jw = jax.jit(jmodel.rollout_representation_with_weights)(
        params, *map(jnp.asarray, (act, audio, vision)), to_jax_state(init, port.cfg), key)
    assert w.shape == (B, T, 3)
    np.testing.assert_allclose(w.numpy(), jw, rtol=0, atol=1e-5)
    torch.testing.assert_close(w.sum(-1), torch.ones(B, T), rtol=0, atol=1e-6)
    for ours, theirs in ((post, jpost), (prior, jprior)):
        np.testing.assert_allclose(ours.deter.numpy(), theirs.deter, rtol=0, atol=1e-5)
        np.testing.assert_allclose(ours.logits.numpy(), theirs.distribution.logits, rtol=0,
                                   atol=1e-5)
        # Straight-through samples: the one-hot value plus probs - probs,
        # whose rounding may differ by an ulp between the packages.
        np.testing.assert_array_equal(ours.stoch.numpy().round(), np.asarray(theirs.stoch).round())
        np.testing.assert_allclose(ours.stoch.numpy(), theirs.stoch, rtol=0, atol=1e-6)


def test_weighted_shared_step_matches_jax():
    """The weighted model's ELBO and every gradient, ``moe_weight_head``'s
    among them (and not zero)."""
    got = _assert_step_matches("weighted", 0.0)
    assert all(float(got[f"moe_weight_head.{i}.weight"].abs().max()) > 0 for i in (0, 2))


def test_weighted_with_a_zero_head_is_mrssm():
    """A head whose last layer is zero gives the equal 1/3 weights: the
    weighted model's step loop is MoPoE-MRSSM's plain route on the same
    weights and noise."""
    _, _, weighted, _ = variant_family("weighted")
    zero = WeightedMoPoEMRSSM(weighted.cfg)
    sd = weighted.state_dict()
    sd["moe_weight_head.2.weight"] = torch.zeros_like(sd["moe_weight_head.2.weight"])
    sd["moe_weight_head.2.bias"] = torch.zeros_like(sd["moe_weight_head.2.bias"])
    zero.load_state_dict(sd)
    fields = {f.name: getattr(weighted.cfg, f.name) for f in dataclasses.fields(MRSSMConfig)}
    mrssm = MoPoEMRSSM(MRSSMConfig(**{**fields, "use_pallas_train": False}))
    mrssm.load_state_dict({k: v for k, v in sd.items() if not k.startswith("moe_weight_head")})
    batch = tuple(map(torch.from_numpy, _batch(9, 3)))
    noise = mrssm.draw_noise(B, T, torch.Generator().manual_seed(3))
    with torch.no_grad():
        (p1, q1), (p2, q2) = (m.observe(*batch[:3], noise) for m in (zero, mrssm))
        _, _, w = zero.rollout_representation_with_weights(
            *batch[:3], zero.initial_state(batch[1][:, 0], batch[2][:, 0], noise["g_init"]),
            noise["g_prior"], noise["g_post"])
    torch.testing.assert_close(w, torch.full((B, T, 3), 1 / 3), rtol=0, atol=1e-7)
    for a, b in ((p1, p2), (q1, q2)):
        torch.testing.assert_close(a.deter, b.deter, rtol=0, atol=1e-6)
        torch.testing.assert_close(a.logits, b.logits, rtol=0, atol=1e-6)
        assert torch.equal(a.stoch, b.stoch)


@pytest.mark.parametrize("value", [True, "stacked"])
def test_weighted_refuses_the_recurrence_kernels(value):
    with pytest.raises(ValueError, match="1/3"):
        WeightedMoPoEMRSSM(WeightedMRSSMConfig(use_pallas_train=value))


def test_weighted_accepts_auto_and_the_plain_route():
    """``"auto"`` keeps imagination on the rollout kernel, False and None
    name the plain route."""
    assert not WeightedMoPoEMRSSM(WeightedMRSSMConfig()).plain
    for value in (False, None):
        assert WeightedMoPoEMRSSM(WeightedMRSSMConfig(use_pallas_train=value)).plain


# ---- unimodal batches ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def episode_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("episodes")
    episodes.generate_synthetic_audio_mnist(d, n_episodes=9, episode_length=12, seed=3)
    return d


@pytest.mark.parametrize("noise_std", [0.0, 0.1])
@pytest.mark.parametrize("modality", ["audio", "vision"])
def test_unimodal_batches_match_jax(episode_dir, tmp_path, jax_native, modality, noise_std):
    """Two epochs of train batches, validation and host batches: 4-tuples
    bit-equal to JAX's (both noised by the native library), each stream
    noised from its own seed."""
    cfg = dict(data_dir=str(episode_dir), batch_size=2, sequence_length=6, seed=5,
               common_processed_dir=str(tmp_path / "none"), modality=modality,
               noise_std=noise_std)
    ours = pipeline.EpisodeDataModule(pipeline.DataModuleConfig(**cfg))
    theirs = jax_pipeline.EpisodeDataModule(jax_pipeline.DataModuleConfig(**cfg))
    pairs = [(ours.train_batches(e), theirs.train_batches(e)) for e in (0, 1)]
    pairs += [(ours.val_batches(), theirs.val_batches()),
              (ours.host_batches("train", 1), theirs.host_batches("train", 1))]
    for got, want in pairs:
        got, want = list(got), list(want)
        assert len(got) == len(want) and got
        for g, w in zip(got, want):
            assert len(g) == len(w) == 4
            for x, y in zip(g, w):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert ours.batch_nbytes(2) == theirs.batch_nbytes(2) == 2 * 2 * 6 * (6 + 32 * 32) * 4


def test_unimodal_modality_refusals_and_static_drops(episode_dir, tmp_path):
    with pytest.raises(ValueError, match="modality"):
        pipeline.DataModuleConfig(modality="video")
    with pytest.raises(ValueError, match="both streams"):
        pipeline.DataModuleConfig(modality="vision", drop_modality="random")
    cfg = dict(data_dir=str(episode_dir), batch_size=2, sequence_length=6, noise_std=0.0,
               common_processed_dir=str(tmp_path / "none"), modality="vision")
    clean = next(iter(pipeline.EpisodeDataModule(pipeline.DataModuleConfig(**cfg))
                      .train_batches(0)))
    other = next(iter(pipeline.EpisodeDataModule(pipeline.DataModuleConfig(
        drop_modality="audio", **cfg)).train_batches(0)))
    dropped = next(iter(pipeline.EpisodeDataModule(pipeline.DataModuleConfig(
        drop_modality="vision", **cfg)).train_batches(0)))
    assert all(torch.equal(a, b) for a, b in zip(clean, other))
    assert bool((dropped[1] == -1).all()) and torch.equal(dropped[3], clean[3])


# ---- training, checkpoints and serving --------------------------------------------------


def _small(name: str):
    _, _, port, _ = variant_family(name)
    return type(port)(port.cfg).init(torch.Generator().manual_seed(2))


def test_rssm_fit_with_the_gif_callback_renders_nothing(episode_dir, tmp_path):
    """A 2-epoch unimodal fit with the GIF callback due every epoch: finite
    history, no GIF (the callback skips 4-tuple batches)."""
    dm = pipeline.EpisodeDataModule(pipeline.DataModuleConfig(
        data_dir=str(episode_dir), batch_size=2, sequence_length=4, noise_std=0.0, seed=2,
        modality="audio", common_processed_dir=str(tmp_path / "none")))
    trainer = Trainer(_small("rssm"), dm, TrainerConfig(max_epochs=2, seed=3,
                                                        log_dir=str(tmp_path / "run")),
                      callbacks=[LogRSSMOutput(every_n_epochs=1, query_length=2)])
    out = trainer.fit()
    assert len(out["history"]) == 2 and out["global_step"] > 0
    assert all(np.isfinite(v) for row in out["history"] for v in row.values())
    assert not list((tmp_path / "run").rglob("*.gif"))


def test_weighted_fit_checkpoint_serves(episode_dir, tmp_path):
    """A weighted fit writes checkpoints with ``moe_weight_head``;
    ``WorldModel.from_checkpoint`` restores them strictly and observes and
    imagines on the CPU."""
    dm = pipeline.EpisodeDataModule(pipeline.DataModuleConfig(
        data_dir=str(episode_dir), batch_size=2, sequence_length=4, noise_std=0.0, seed=2,
        common_processed_dir=str(tmp_path / "none")))
    model = _small("weighted")
    Trainer(model, dm, TrainerConfig(max_epochs=1, seed=3, log_dir=str(tmp_path / "run"))).fit()
    ckpts = tmp_path / "run" / "checkpoints"
    wm = WorldModel.from_checkpoint(model.cfg, ckpts, device="cpu")
    assert isinstance(wm.model, WeightedMoPoEMRSSM)
    theirs = wm.model.state_dict()
    assert "moe_weight_head.2.bias" in theirs
    assert all(torch.equal(v, theirs[k]) for k, v in model.state_dict().items())
    act, audio, vision = _batch(10, 3)[:3]
    post, prior = wm.observe(act, audio, vision, seed=1)
    frames = wm.imagine_frames(np.zeros((B, 5, 6), np.float32), post[:, -1], seed=2)
    assert post.deter.shape == (B, T, 32) and frames["recon/vision"].shape == (B, 5, 32, 32, 1)
    assert all(bool(torch.isfinite(x).all()) for x in frames.values())


def test_serve_config_answers_observe_and_imagine_for_a_weighted_yaml(tmp_path, monkeypatch):
    """``serve --config <weighted yaml> --checkpoint <dir> --device cpu``
    answers ``/observe`` and ``/imagine`` over HTTP."""
    import json
    import urllib.request

    import yaml

    raw = yaml.safe_load((REPO / "configs" / "mopoe_mrssm.yaml").read_text())
    raw["model"]["class_path"] = "multimodal_mtrssm_tpu.models.WeightedMoPoEMRSSM"
    path = tmp_path / "weighted.yaml"
    path.write_text(yaml.safe_dump(raw))
    model = load_experiment(path).model.init(torch.Generator().manual_seed(4))
    CheckpointManager(tmp_path / "ckpts").save("best", model)
    started = {}

    class Started(server_mod.InferenceServer):
        def serve_forever(self):
            self.start()
            started["server"] = self

    monkeypatch.setattr(server_mod, "InferenceServer", Started)
    server_mod.main(["--config", str(path), "--checkpoint", str(tmp_path / "ckpts"),
                     "--device", "cpu", "--port", "0"])
    server = started["server"]

    def post(route, payload):
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}{route}",
                                     data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())

    try:
        assert isinstance(server.wm.model, WeightedMoPoEMRSSM)
        act, audio, vision = (x[:1, :3] for x in _batch(12, 3)[:3])
        code, out = post("/observe", {"actions": act.tolist(), "audio": audio.tolist(),
                                      "vision": vision.tolist(), "seed": 1})
        assert code == 200
        code, im = post("/imagine", {"state_id": out["state_id"], "seed": 2,
                                     "actions": np.zeros((1, 4, 6)).tolist()})
        assert code == 200 and np.asarray(im["frames"]["recon/audio"]).shape == (1, 4, 32, 32, 1)
    finally:
        server.stop()


def test_world_model_refuses_the_unimodal_rssm():
    with pytest.raises(TypeError, match="MoPoEMRSSM / MoPoEMMTRSSM / WeightedMoPoEMRSSM"):
        WorldModel(_small("rssm"), "cpu")


# ---- the weights chart -----------------------------------------------------------------------


def test_plot_weights_timeseries_writes_a_png(tmp_path):
    w = torch.softmax(torch.randn(2, 6, 3, generator=torch.Generator().manual_seed(0)), -1)
    out = plot_weights_timeseries(w, tmp_path / "charts" / "weights.png", episode=1)
    assert out.exists() and out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
