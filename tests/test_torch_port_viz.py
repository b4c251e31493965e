"""The port's rollout GIFs on the CPU against the JAX package:
``compute_reconstructions`` (its sampled states replayed through JAX's
``cat_states`` and ``decode_state`` on the same weights), the renderer, the
magma table and the trainer callback.

Tolerances: frames within 1e-5 of JAX's decode of the port's states
(float32 convs on two backends); the prior's first q steps equal the
posterior's bit for bit; the magma table, the uint8 frames and the decoded
GIF frames exactly.
"""

import json

import jax
import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from multimodal_mtrssm_tpu.models.state import cat_states as jax_cat_states
from multimodal_mtrssm_tpu.viz import rollout as jax_rollout
from multimodal_mtrssm_tpu_torch.data import episodes, pipeline
from multimodal_mtrssm_tpu_torch.train.trainer import Trainer, TrainerConfig
from multimodal_mtrssm_tpu_torch.viz import callback as viz_callback
from multimodal_mtrssm_tpu_torch.viz import rollout
from _port_models import family, to_jax_state
from _port_threads import _one_intra_op_thread  # noqa: F401 (autouse)

FRAME_TOL = 1e-5
KEYS = ("posterior/audio", "posterior/vision", "prior/audio", "prior/vision")


def _batch(B: int, T: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, 6)).astype(np.float32),
            rng.uniform(-1, 1, (B, T, 32, 32, 1)).astype(np.float32),
            rng.uniform(-1, 1, (B, T, 32, 32, 1)).astype(np.float32))


def _spy(monkeypatch, model, names):
    calls = {n: [] for n in names}
    for name in names:
        real = getattr(model, name)

        def spy(*a, _real=real, _name=name, **k):
            calls[_name].append(tuple(a[0].shape))
            return _real(*a, **k)

        monkeypatch.setattr(model, name, spy)
    return calls


# ---- compute_reconstructions ----------------------------------------------------------------


@pytest.mark.parametrize("name", ["mrssm", "mmtrssm"])
def test_reconstructions_match_jax_decode(name, monkeypatch):
    """The port's posterior and its imagined steps, concatenated by JAX's
    ``cat_states`` and decoded by JAX's ``decode_state`` on the same
    weights: the four frame sets within 1e-5 of the port's. One
    recurrence (``rollout_representation``) and one rollout
    (``rollout_transition``, over ``action[:, q:]``) a call."""
    jmodel, params, port = family(name)
    calls = _spy(monkeypatch, port, ("rollout_representation", "rollout_transition"))
    batch = _batch(3, 8)
    states = rollout.reconstruction_states(port, batch, 3, seed=4)
    frames = rollout.compute_reconstructions(port, batch, 3, seed=4)
    assert calls == {"rollout_representation": [(3, 8, 6)] * 2,
                     "rollout_transition": [(3, 5, 6)] * 2}
    assert states["q"] == 3 and list(frames) == list(KEYS)
    post = to_jax_state(states["posterior"], port.cfg)
    prior = jax_cat_states([post[:, :3], to_jax_state(states["imagined"], port.cfg)], axis=1)
    want = {f"{which}/{mod}": jmodel.decode_state(params, s)[f"recon/{mod}"]
            for which, s in (("posterior", post), ("prior", prior)) for mod in ("audio", "vision")}
    for k in KEYS:
        assert frames[k].shape == (3, 8, 32, 32, 1)
        np.testing.assert_allclose(frames[k].numpy(), np.asarray(want[k]), rtol=0, atol=FRAME_TOL)
    for a, b in zip(jax.tree.leaves(prior), jax.tree.leaves(to_jax_state(states["prior"],
                                                                         port.cfg))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(frames["prior/audio"][:, :3].numpy(),
                                  frames["posterior/audio"][:, :3].numpy())


@pytest.mark.parametrize("name", ["mrssm", "mmtrssm"])
def test_query_length_is_clamped(name, monkeypatch):
    """q < 1 is 1 (no imagination from the episode's end), q ≥ T is T - 1;
    at T=1 the prior is the posterior's one step and nothing is imagined
    (JAX's floor at T=1)."""
    _, _, port = family(name)
    calls = _spy(monkeypatch, port, ("rollout_transition",))
    batch = _batch(2, 5, seed=1)
    for q, want in ((0, 1), (-3, 1), (5, 4), (9, 4)):
        assert rollout.reconstruction_states(port, batch, q, seed=0)["q"] == want
    assert calls["rollout_transition"] == [(2, 4, 6), (2, 4, 6), (2, 1, 6), (2, 1, 6)]
    one = rollout.reconstruction_states(port, tuple(x[:, :1] for x in batch), 10, seed=0)
    assert one["q"] == 1 and one["imagined"] is None and len(calls["rollout_transition"]) == 4
    frames = rollout.decode_reconstructions(port, one)
    for mod in ("audio", "vision"):
        assert torch.equal(frames[f"prior/{mod}"], frames[f"posterior/{mod}"])
        assert frames[f"prior/{mod}"].shape[1] == 1


# ---- the renderer ------------------------------------------------------------------------


def test_magma_table_is_matplotlibs():
    """The carried table is matplotlib's magma after the uint8 cast, and the
    audio frames map like JAX's (matplotlib's) colormap call, at the range's
    edges, outside it and at NaN."""
    from matplotlib import colormaps

    lut = colormaps["magma"](np.arange(256))
    np.testing.assert_array_equal(rollout.MAGMA, (lut[:, :3] * 255).astype(np.uint8))
    x = np.random.default_rng(0).uniform(-1.2, 1.2, (4000, 1)).astype(np.float32)
    x[:6, 0] = [-1.0, 1.0, 0.0, np.nan, 127 / 128 - 1e-7, -1 + 2 / 256]
    np.testing.assert_array_equal(rollout._to_uint8_audio(x[None]),
                                  jax_rollout._to_uint8_audio(x[None]))
    x = x[~np.isnan(x[:, 0])]  # a NaN's uint8 cast is the platform's
    np.testing.assert_array_equal(rollout._to_uint8_vision(x[None]),
                                  jax_rollout._to_uint8_vision(x[None]))


def _gif_frames(path) -> list[np.ndarray]:
    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]


@pytest.mark.parametrize("missing", [None, "audio", "vision"])
def test_render_episode_gif_matches_jax(tmp_path, missing):
    """The same observations and reconstructions give JAX's GIF frame for
    frame; an all -1 stream's row is labelled "(missing)"."""
    rng = np.random.default_rng(3)
    T = 5
    obs = {m: rng.uniform(-1.1, 1.1, (T, 32, 32, 1)).astype(np.float32) for m in ("audio", "vision")}
    if missing:
        obs[missing] = np.full((T, 32, 32, 1), -1.0, np.float32)
    rec = {k: rng.uniform(-1, 1, (T, 32, 32, 1)).astype(np.float32) for k in KEYS}
    ours = rollout.render_episode_gif(tmp_path / "port.gif", obs, rec, query_length=2, fps=5.0)
    theirs = jax_rollout.render_episode_gif(tmp_path / "jax.gif", obs, rec, query_length=2,
                                            fps=5.0)
    got, want = _gif_frames(ours), _gif_frames(theirs)
    assert len(got) == len(want) == T
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert rollout.row_labels(obs) == [f"{m}{' (missing)' if m == missing else ''}"
                                       for m in ("vision", "audio")]


def test_log_rollout_gifs_renders_at_most_seven(tmp_path):
    _, _, port = family("mrssm")
    paths = rollout.log_rollout_gifs(port, _batch(9, 3), tmp_path, 1, 10.0, seed=2,
                                     indices=range(9))
    assert [p.name for p in paths] == [f"episode_{i}.gif" for i in range(7)]
    assert {len(_gif_frames(p)) for p in paths} == {3}


# ---- the callback ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """12 episodes: 9 train, 3 val."""
    d = tmp_path_factory.mktemp("episodes")
    episodes.generate_synthetic_audio_mnist(d, n_episodes=12, episode_length=6, seed=3)
    return d


@pytest.fixture(autouse=True)
def _no_charts(monkeypatch):
    import multimodal_mtrssm_tpu_torch.viz.charts as charts

    monkeypatch.setattr(charts, "render_combined_charts", lambda *a, **k: [])


def _fit(name, data_dir, log_dir, every: int):
    import copy

    dm = pipeline.EpisodeDataModule(pipeline.DataModuleConfig(
        data_dir=str(data_dir), batch_size=4, sequence_length=4, noise_std=0.0, seed=1,
        drop_modality="audio"))
    trainer = Trainer(copy.deepcopy(family(name)[2]), dm,
                      TrainerConfig(max_epochs=2, log_dir=str(log_dir), seed=2),
                      [viz_callback.LogRSSMOutput(every_n_epochs=every, query_length=2)])
    trainer.fit()
    return trainer


@pytest.mark.parametrize("name", ["mrssm", "mmtrssm"])
def test_callback_draws_each_stage_during_fit(name, data_dir, tmp_path):
    """Two epochs at ``every_n_epochs=1``: epoch 0 is skipped, epoch 1 and
    the best weights (``final_best``) are drawn, ≤ 7 episodes a stage
    (7 of 9 train, 3 val), each GIF's path logged to the metrics JSONL."""
    _fit(name, data_dir, tmp_path, every=1)
    viz = tmp_path / "viz"
    assert sorted(p.name for p in viz.iterdir()) == ["epoch_0001", "final_best"]
    for run in ("epoch_0001", "final_best"):
        for stage, n in (("train", 7), ("val", 3)):
            assert sorted(p.name for p in (viz / run / stage).iterdir()) == \
                [f"episode_{i}.gif" for i in range(n)]
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    videos = [r for r in rows if "video" in r]
    assert len(videos) == 20 and videos[0]["video"] == "train/rollout_epoch_0001_ep0"
    assert {r["fps"] for r in videos} == {10.0}
    assert sorted(r["path"] for r in videos) == sorted(str(p) for p in viz.rglob("*.gif"))


def test_callback_every_n_epochs_and_aliases(data_dir, tmp_path):
    """At ``every_n_epochs=2`` two epochs draw only ``final_best``; the
    reference-named aliases and ``make_viz_callback`` build the same
    callback."""
    _fit("mrssm", data_dir, tmp_path, every=2)
    assert sorted(p.name for p in (tmp_path / "viz").iterdir()) == ["final_best"]
    assert viz_callback.LogMoPoEMRSSMOutput is viz_callback.LogRSSMOutput
    assert viz_callback.LogMoPoEMMTRSSMOutput is viz_callback.LogRSSMOutput
    from multimodal_mtrssm_tpu_torch.train.config import VizConfig, make_experiment

    exp = make_experiment(family("mrssm")[2].cfg)
    exp.viz = VizConfig(3, (1,), 7, 5.0)
    cb = viz_callback.make_viz_callback(exp)
    assert (cb.every_n_epochs, cb.indices, cb.query_length, cb.fps) == (3, (1,), 7, 5.0)
