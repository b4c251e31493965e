"""The port's evaluation on the CPU against the JAX package on the same
inputs: the MNIST classifier (through the shared ``.npz`` in both
directions), the synthetic labeled episodes, the host-side word-transition
pipeline, and the rollout → decode → classify path of both families.

Tolerances: classifier logits within 1e-5 on the same weights (float32
convs and GEMMs on two backends); decoded frames within 1e-5 of JAX's
``decode_state`` on the same latent states; digits equal wherever both
packages' top two classifier logits lie more than 1e-5 apart; everything
host-side (episodes, resize, intervals, distributions, Matching Rate,
baselines, the written results) exactly.
"""

import dataclasses
import functools
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.data import episodes as jax_episodes
from multimodal_mtrssm_tpu.evaluation import classifier as jax_clf
from multimodal_mtrssm_tpu.evaluation import word_transitions as jax_wt
from multimodal_mtrssm_tpu_torch.data import episodes
from multimodal_mtrssm_tpu_torch.evaluation import classifier as clf
from multimodal_mtrssm_tpu_torch.evaluation import word_transitions as wt
from multimodal_mtrssm_tpu_torch.models import (
    MMTRSSMConfig,
    MoPoEMMTRSSM,
    MoPoEMRSSM,
    MRSSMConfig,
)
from multimodal_mtrssm_tpu_torch.nn.conv import EncoderConfig
from multimodal_mtrssm_tpu_torch.ops.kernels import parity
from multimodal_mtrssm_tpu_torch.train.weights import load_reference_state_dict
from _port_threads import _one_intra_op_thread  # noqa: F401 (autouse)

LOGIT_TOL = 1e-5
FRAME_TOL = 1e-5
TIE_EPS = 1e-5


def stripe_digits(n_per_class: int, seed: int = 0):
    """Separable 'digits' (``tests/test_evaluation.py``): digit d is a
    bright vertical stripe at column 3d."""
    rng = np.random.default_rng(seed)
    images, labels = [], []
    for d in range(10):
        for _ in range(n_per_class):
            img = rng.uniform(0, 0.15, (32, 32)).astype(np.float32)
            img[:, d * 3:d * 3 + 3] = 1.0
            images.append(img)
            labels.append(d)
    order = rng.permutation(len(images))
    return np.asarray(images)[order][..., None], np.asarray(labels, np.int32)[order]


@pytest.fixture(scope="module")
def trained():
    """A port classifier trained on the CPU on stripe digits, and the data."""
    images, labels = stripe_digits(30)
    return clf.train_classifier(images, labels, num_epochs=3, batch_size=50,
                                device="cpu"), (images, labels)


# ---- the classifier -----------------------------------------------------------------------


def test_classifier_learns_stripe_digits_with_shape_guards(trained):
    model, (images, labels) = trained
    preds = clf.recognize_digits(model, torch.from_numpy(images[:100])).numpy()
    assert (preds == labels[:100]).mean() > 0.9
    assert clf.recognize_digit(model, images[0]) == int(labels[0])  # HWC
    assert clf.recognize_digit(model, images[0].transpose(2, 0, 1)) == int(labels[0])  # CHW
    assert clf.recognize_digit(model, images[0][..., 0]) == int(labels[0])  # HW
    with pytest.raises(ValueError, match="32x32"):
        clf.recognize_digit(model, np.zeros((16, 16)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            clf.train_classifier(images[:4], labels[:4])


def _jax_logits(params, images):
    return np.asarray(jax_clf.classifier_apply(params, jnp.clip(jnp.asarray(images), 0.0, 1.0)))


def test_classifier_logits_match_jax_through_the_shared_npz(trained, tmp_path):
    """JAX's file → the port, and the port's file → JAX: the same logits
    within 1e-5 and the same digits."""
    images = stripe_digits(3, seed=4)[0]
    params = jax_clf.classifier_init(jax.random.PRNGKey(3))
    jax_clf.save_classifier(params, tmp_path / "jax")
    port = clf.load_classifier(tmp_path / "jax.npz", device="cpu")
    got = clf.classifier_logits(port, torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, _jax_logits(params, images), rtol=0, atol=LOGIT_TOL)
    model, _ = trained
    path = clf.save_classifier(model, tmp_path / "port")
    assert path.name == "port.npz"
    theirs = jax_clf.load_classifier(path)
    assert {k: v.shape for k, v in np.load(path).items()} == {
        "/".join(k): v.shape for k, v in jax_clf._flatten(params)}
    want = _jax_logits(theirs, images)
    got = clf.classifier_logits(model, torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
    np.testing.assert_array_equal(got.argmax(-1), np.asarray(
        jax_clf.recognize_digits(theirs, jnp.asarray(images))))
    again = clf.load_or_train_classifier(tmp_path / "port", device="cpu")  # suffix added
    assert all(torch.equal(a, b) for a, b in zip(again.parameters(), model.parameters()))
    with pytest.raises(FileNotFoundError, match="mnist-root"):
        clf.load_or_train_classifier(tmp_path / "missing.npz", device="cpu")


def test_mnist_arrays_and_resize_match_jax(tmp_path):
    """Random 28×28 digits as raw idx files (gzipped) and as an ``.npz``:
    the same resized arrays and labels as JAX's loader."""
    import gzip
    import struct

    rng = np.random.default_rng(2)
    images = rng.integers(0, 256, (5, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, 5, dtype=np.uint8)
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    with gzip.open(raw / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">HBBIII", 0, 8, 3, 5, 28, 28) + images.tobytes())
    with gzip.open(raw / "train-labels-idx1-ubyte.gz", "wb") as f:
        f.write(struct.pack(">HBBI", 0, 8, 1, 5) + labels.tobytes())
    np.savez(tmp_path / "mnist.npz", images=images, labels=labels)
    for root in (tmp_path, tmp_path / "mnist.npz"):
        got, want = clf.load_mnist_arrays(root), jax_clf.load_mnist_arrays(root)
        assert got[0].shape == (5, 32, 32, 1)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got[1], labels.astype(np.int32))


# ---- episodes and the host-side pipeline -------------------------------------------------


def test_labeled_episodes_and_to_nhwc_match_jax(tmp_path):
    ours = episodes.generate_synthetic_labeled_audio_mnist(
        tmp_path / "p_tr", tmp_path / "p_ev", n_episodes=3, episode_length=20,
        frames_per_word=3, seed=4)
    theirs = jax_episodes.generate_synthetic_labeled_audio_mnist(
        tmp_path / "j_tr", tmp_path / "j_ev", n_episodes=3, episode_length=20,
        frames_per_word=3, seed=4)
    for a, b in zip(ours[0] + ours[1], theirs[0] + theirs[1], strict=True):
        assert a.name == b.name
        with np.load(a) as x, np.load(b) as y:
            assert sorted(x) == sorted(y)
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    chw = np.zeros((4, 1, 8, 8))
    for x in (chw, np.zeros((4, 8, 8)), np.zeros((4, 8, 8, 1))):
        assert episodes._to_nhwc(x).shape == jax_episodes._to_nhwc(x).shape == (4, 8, 8, 1)
    with pytest.raises(ValueError, match="3-D or 4-D"):
        episodes._to_nhwc(np.zeros((4, 8)))
    ep = episodes.load_episode(ours[0][0])
    assert ep.vision.shape == (20, 32, 32, 1)


def _labeled(label_seq, speaker_idx, frames_per_word=20, seed=0):
    rng = np.random.default_rng(seed)
    T = len(label_seq) * frames_per_word
    speaker = np.zeros((T, 6), np.float32)
    speaker[:, speaker_idx] = 1.0
    return {"audio": rng.uniform(-80, 0, (T, 32, 32)).astype(np.float32),
            "image": rng.uniform(0, 255, (T, 1, 32, 32)).astype(np.float32),
            "label": np.repeat(np.asarray(label_seq), frames_per_word), "speaker": speaker,
            "file_path": "mem"}


def test_intervals_distributions_and_results_match_jax(tmp_path):
    """Golden cases of ``tests/test_evaluation.py:71`` and ``:86``, and every
    word of a larger set: intervals, q, p, MR, baselines and the written
    ``.md``/``.json``, all equal to JAX's."""
    data = [_labeled([1, 2, 3], 0), _labeled([1, 4, 5], 0), _labeled([0, 1, 2], 1),
            _labeled([7, 8, 9], 2), _labeled([1, 2, 1, 3], 3), _labeled([-1, 1, 2], 4)]
    for word in range(-1, 10):
        for n, q in ((6, 30), (2, 5), (1, 80)):
            got = wt.select_intervals_for_word(word, data, n, q)
            want = jax_wt.select_intervals_for_word(word, data, n, q)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert a.keys() == b.keys()
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
        p = wt.compute_true_distribution(word, data)
        assert p == jax_wt.compute_true_distribution(word, data)
        assert wt.compute_baselines(p, seed=word + 1) == jax_wt.compute_baselines(p, seed=word + 1)
    assert len(wt.select_intervals_for_word(1, data, 6, 30)) == 4
    preds = [1, 1, 2, 7, 99, 3, 3, 3]
    q = wt.compute_prediction_distribution(preds)
    assert q == jax_wt.compute_prediction_distribution(preds) and q["wf"] == 1 / 8
    assert wt.compute_prediction_distribution([]) == jax_wt.compute_prediction_distribution([])
    p = wt.compute_true_distribution(1, data)
    assert wt.compute_matching_rate(q, p) == jax_wt.compute_matching_rate(q, p)
    assert wt.compute_matching_rate(p, p) == pytest.approx(1.0)
    per_word = {str(w): {"matching_rate": 0.1 * w, "n_predictions": 4, "baselines":
                         {"uniform": 0.1, "peak_onehot": 0.5, "random_onehot": 0.3}}
                for w in (3, 0, 12)}
    results = {"per_word": per_word, "summary": {
        "condition": "both", "mean_matching_rate": 0.5, "mean_uniform": 0.1,
        "mean_peak_onehot": 0.5, "mean_random_onehot": 0.3}}
    for a, b in zip(wt.write_results(results, tmp_path / "p", "x"),
                    jax_wt.write_results(results, tmp_path / "j", "x")):
        assert a.name == b.name and a.read_text() == b.read_text()


def test_load_test_data_npz_and_pt_layouts_match_jax(tmp_path):
    """``.npz`` episodes, and the reference's ``.pt`` episodes with their
    label files in ``npz_dir_for_labels`` and its sibling ``train/`` (JAX
    ``tests/test_evaluation.py:210``)."""
    episodes.generate_synthetic_labeled_audio_mnist(tmp_path / "tr", tmp_path / "ev",
                                                    n_episodes=2, episode_length=12, seed=1)
    pt_dir, npz_dir = tmp_path / "processed", tmp_path / "npz" / "test"
    pt_dir.mkdir()
    npz_dir.mkdir(parents=True)
    (tmp_path / "npz" / "train").mkdir()
    rng = np.random.default_rng(0)
    T = 12
    for idx in (0, 1, 7):
        torch.save(torch.tensor(rng.uniform(-80, 0, (T, 1, 32, 32)).astype(np.float32)),
                   pt_dir / f"audio_obs_{idx:04d}.pt")
        torch.save(torch.tensor(rng.uniform(0, 255, (T, 1, 32, 32)).astype(np.float32)),
                   pt_dir / f"vision_obs_{idx:04d}.pt")
        speaker = np.zeros((T, 6), np.float32)
        speaker[:, idx % 6] = 1.0
        torch.save(torch.tensor(speaker), pt_dir / f"act_{idx:04d}.pt")
    np.savez(npz_dir / "sample_0000.npz", label=np.full((T,), 0, np.int64))
    np.savez(tmp_path / "npz" / "train" / "sample_0001.npz", label=np.full((T,), 1, np.int64))
    cases = [((tmp_path / "ev",), {}), ((pt_dir,), {"npz_dir_for_labels": npz_dir}),
             ((pt_dir,), {}), ((tmp_path / "nowhere",), {})]
    for args, kw in cases:
        got, want = wt.load_test_data_with_labels(*args, **kw), \
            jax_wt.load_test_data_with_labels(*args, **kw)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(wt.load_test_data_with_labels(pt_dir, npz_dir_for_labels=npz_dir)) == 2


def test_condition_zeroes_the_right_stream():
    a = np.full((2, 4, 4, 1), 0.5, np.float32)
    v = np.full((2, 4, 4, 1), 0.25, np.float32)
    assert wt.CONDITIONS == jax_wt.CONDITIONS == ("both", "vision", "audio")
    for cond in wt.CONDITIONS:
        for x, y in zip(wt._apply_condition(a, v, cond), jax_wt._apply_condition(a, v, cond)):
            np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="condition"):
        wt._apply_condition(a, v, "video")


def test_classify_frame_out_of_range_raises():
    with pytest.raises(ValueError, match="classify_frame"):
        wt.generate_predictions_batched(None, None, [], 0, n_predictions=2, n_frames=5,
                                        classify_frame=5)
    with pytest.raises(ValueError, match="classify_frame"):
        wt.evaluate_word_transitions(None, None, [], n_frames=5, classify_frame=-1)


# ---- rollout → decode → classify, against JAX ----------------------------------------------


@functools.lru_cache(maxsize=None)
def _family(name: str):
    """A small JAX model of ``name``, its params, and the port model on the
    same weights, made once (the tests only read the weights)."""
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


def _intervals(n: int, T: int = 8):
    return [{k: v for k, v in _labeled([i + 1, i + 2], i, T // 2, seed=i).items()
             if k != "file_path"} for i in range(n)]


@pytest.mark.parametrize("family", ["mrssm", "mmtrssm"])
def test_decode_and_classify_match_jax(family, trained, monkeypatch, tmp_path):
    """One word's rollout (3 intervals × 4 predictions, 3 frames) through
    the port; its states at ``classify_frame`` decoded by JAX's
    ``decode_state`` and classified by JAX's ``recognize_digits`` on the
    same weights: frames within 1e-5, digits equal outside logit
    near-ties. The initial state is sampled once per interval (JAX
    ``tests/test_evaluation.py:249``) and the rollout is one call."""
    jmodel, params, port = _family(family)
    model, _ = trained
    path = clf.save_classifier(model, tmp_path / "clf.npz")
    jclf = jax_clf.load_classifier(path)
    calls = {"initial_state": [], "rollout_transition": []}
    for name in calls:
        real = getattr(port, name)

        def spy(*a, _real=real, _name=name):
            calls[_name].append(a[0].shape[0])
            return _real(*a)

        monkeypatch.setattr(port, name, spy)
    for cf in (0, 2):
        out = wt.predict_word(port, model, _intervals(3), seed=11, n_predictions=4, n_frames=3,
                              classify_frame=cf)
        states = out["states"]
        assert states.batch_size == 12 and out["digits"].shape == (12,)
        # The initial state repeats over each interval's predictions.
        for f in dataclasses.fields(out["initial"]):
            x = getattr(out["initial"], f.name)
            assert torch.equal(x.repeat_interleave(4, 0), getattr(
                wt._repeat_rows(out["initial"], 4), f.name))
        feature = states[:, cf].feature
        recon = jmodel.decode_state(params, SimpleNamespace(feature=jnp.asarray(
            feature.numpy())))["recon/vision"]
        frame = port.vision_decoder(feature).detach()
        np.testing.assert_allclose(frame.numpy(), np.asarray(recon), rtol=0, atol=FRAME_TOL)
        images = jnp.clip((recon + 1.0) / 2.0, 0.0, 1.0)
        jlogits = np.asarray(jax_clf.classifier_apply(jclf, images))
        jdigits = np.asarray(jax_clf.recognize_digits(jclf, images))
        np.testing.assert_allclose(out["logits"].numpy(), jlogits, rtol=0, atol=LOGIT_TOL)
        top2 = np.sort(jlogits, -1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > TIE_EPS
        np.testing.assert_array_equal(out["digits"].numpy()[clear], jdigits[clear])
        assert clear.mean() > 0.5
    assert calls == {"initial_state": [3, 3], "rollout_transition": [12, 12]}


@pytest.mark.parametrize("family", ["mrssm", "mmtrssm"])
def test_predicted_digits_check_holds_the_rollout_states(family, trained):
    """``parity.check_predicted_digits`` (the card-vs-CPU check of
    evaluation) on two runs of one word: equal runs pass with the states'
    error 0 and the digits seen; a deter 1e-3 off at the first step, or a
    stoch moved to another category there, raises."""
    from conftest import small_encoder_config

    enc = EncoderConfig(**dataclasses.asdict(small_encoder_config()))
    cfg = (MMTRSSMConfig if family == "mmtrssm" else MRSSMConfig)(
        audio_encoder=enc, vision_encoder=enc, init_proj_cells=32)
    port = (MoPoEMMTRSSM if family == "mmtrssm" else MoPoEMRSSM)(cfg).init(
        torch.Generator().manual_seed(4)).eval()
    model, _ = trained
    run = lambda: wt.predict_word(port, model, _intervals(3), seed=11,  # noqa: E731
                                  n_predictions=4, n_frames=3)
    got, ref = run(), run()
    r = parity.check_predicted_digits(got, ref, cfg, 0, TIE_EPS)
    assert r["max_abs_err"] == 0 and r["compared"] + r["excluded"] == 12
    assert r["compared"] > 0 and r["digits"]
    deter, stoch = ("deter_h", "stoch_h") if family == "mmtrssm" else ("deter", "stoch")
    states = got["states"]
    moved = getattr(states, deter).clone()
    moved[:, 0] += 1e-3
    with pytest.raises(parity.ParityError, match="rollout states"):
        parity.check_predicted_digits({**got, "states": dataclasses.replace(states, **{
            deter: moved})}, ref, cfg, 0, TIE_EPS)
    flipped = getattr(states, stoch).clone()
    flipped[:, 0] = flipped[:, 0].roll(1, dims=-1)
    with pytest.raises(parity.ParityError, match=f"rollout {stoch} differs"):
        parity.check_predicted_digits({**got, "states": dataclasses.replace(states, **{
            stoch: flipped})}, ref, cfg, 0, TIE_EPS)


def test_a_word_is_one_rollout_and_the_seed_fixes_it(trained, monkeypatch):
    """``evaluate_word_transitions``: one rollout per evaluated word
    under each condition, every ``q_dist`` sums to 1, JAX's result keys,
    and the same seed gives the same result."""
    _, _, port = _family("mrssm")
    model, _ = trained
    data = [_labeled([0, 1, 2], 0, 12), _labeled([1, 2, 0], 1, 12)]
    launches = []
    real = port.rollout_transition

    def spy(actions, state, seed):
        launches.append(actions.shape[0])
        return real(actions, state, seed)

    monkeypatch.setattr(port, "rollout_transition", spy)
    kw = dict(n_intervals=2, query_length=10, n_predictions=4, n_frames=3, seed=5)
    res = wt.evaluate_word_transitions(port, model, data, **kw)
    assert sorted(res["per_word"]) == ["0", "1", "2"] and launches == [8, 8, 8]
    for r in res["per_word"].values():
        assert sum(r["q_dist"].values()) == pytest.approx(1.0)
        assert r["n_predictions"] == 8
        assert set(r) == {"n_intervals", "n_predictions", "q_dist", "p_dist", "matching_rate",
                          "baselines"}
    assert set(res["summary"]) == {"condition", "mean_matching_rate", "mean_uniform",
                                   "mean_peak_onehot", "mean_random_onehot"}
    assert wt.evaluate_word_transitions(port, model, data, **kw) == res
    launches.clear()
    wt.evaluate_word_transitions(port, model, data, condition="audio", **kw)
    assert launches == [8, 8, 8]


@pytest.mark.parametrize("family", ["mrssm", "mmtrssm"])
def test_per_interval_predictions_equal_batched_and_jax(family, trained, monkeypatch, tmp_path):
    """``generate_predictions_with_classifier`` (``batched=False``): one
    rollout an interval at B = ``n_predictions``, whose digits are those of
    the word's batched rollout, prediction for prediction (the same
    initial-state rows and per-row Philox keys); each interval's states
    decoded at ``classify_frame`` by JAX's ``decode_state`` and classified
    by its ``recognize_digits`` (the tail of JAX's
    ``generate_predictions_with_classifier``) give the port's digits
    outside logit near-ties."""
    jmodel, params, port = _family(family)
    model, _ = trained
    jclf = jax_clf.load_classifier(clf.save_classifier(model, tmp_path / "clf.npz"))
    intervals = _intervals(3)
    kw = dict(n_predictions=4, n_frames=3, classify_frame=1)
    batched = wt.generate_predictions_batched(port, model, intervals, 11, **kw)
    launches = []
    real = port.rollout_transition

    def spy(actions, state, seed):
        launches.append(real(actions, state, seed))
        return launches[-1]

    monkeypatch.setattr(port, "rollout_transition", spy)
    per = [wt.generate_predictions_with_classifier(port, model, iv, 11, interval_index=i,
                                                   n_intervals=3, **kw)
           for i, iv in enumerate(intervals)]
    assert [s.batch_size for s in launches] == [4, 4, 4]
    assert sum(per, []) == batched
    clear_share = []
    for states, digits in zip(launches, per):
        recon = jmodel.decode_state(params, SimpleNamespace(feature=jnp.asarray(
            states[:, 1].feature.numpy())))["recon/vision"]
        images = jnp.clip((recon + 1.0) / 2.0, 0.0, 1.0)
        jlogits = np.asarray(jax_clf.classifier_apply(jclf, images))
        top2 = np.sort(jlogits, -1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > TIE_EPS
        np.testing.assert_array_equal(np.asarray(digits)[clear],
                                      np.asarray(jax_clf.recognize_digits(jclf, images))[clear])
        clear_share.append(clear.mean())
    assert np.mean(clear_share) > 0.5
    with pytest.raises(ValueError, match="interval_index"):
        wt.generate_predictions_with_classifier(port, model, intervals[0], 11, interval_index=3,
                                                n_intervals=3, **kw)


def test_evaluation_per_interval_equals_batched(trained, monkeypatch):
    """``evaluate_word_transitions(batched=False)``: a rollout an interval,
    and the batched evaluation's results, word for word."""
    _, _, port = _family("mrssm")
    model, _ = trained
    data = [_labeled([0, 1, 2], 0, 12), _labeled([1, 2, 0], 1, 12)]
    kw = dict(n_intervals=2, query_length=10, n_predictions=4, n_frames=3, seed=5)
    batched = wt.evaluate_word_transitions(port, model, data, **kw)
    launches = []
    real = port.rollout_transition

    def spy(actions, state, seed):
        launches.append(actions.shape[0])
        return real(actions, state, seed)

    monkeypatch.setattr(port, "rollout_transition", spy)
    assert wt.evaluate_word_transitions(port, model, data, batched=False, **kw) == batched
    assert launches == [4] * 6


def test_eval_cli_end_to_end(trained, tmp_path, monkeypatch):
    """``python -m multimodal_mtrssm_tpu_torch evaluate-word-transitions``
    on a tiny config, a params-only ``best`` and labeled episodes: the
    ``.md`` and ``.json`` results with JAX's summary keys, the condition's
    suffix; no checkpoint raises; ``--device cuda`` without a card raises
    (JAX ``tests/test_evaluation.py:403``)."""
    from multimodal_mtrssm_tpu_torch import __main__ as entry
    from multimodal_mtrssm_tpu_torch.train.checkpoint import CheckpointManager
    from multimodal_mtrssm_tpu_torch.train.config import load_experiment

    model, _ = trained
    clf.save_classifier(model, tmp_path / "clf.npz")
    episodes.generate_synthetic_labeled_audio_mnist(tmp_path / "train", tmp_path / "eval",
                                                    n_episodes=4, episode_length=24,
                                                    frames_per_word=3, seed=0)
    cfg_path = _tiny_yaml(tmp_path)
    exp = load_experiment(cfg_path)
    exp.model.init(torch.Generator().manual_seed(0))
    CheckpointManager(tmp_path / "checkpoints").save("best", exp.model)
    args = ["evaluate-word-transitions", "--config", str(cfg_path), "--checkpoint",
            str(tmp_path / "checkpoints"), "--test-data", str(tmp_path / "eval"),
            "--classifier", str(tmp_path / "clf.npz"), "--out", str(tmp_path / "results"),
            "--n-intervals", "2", "--query-length", "2", "--n-predictions", "2",
            "--n-frames", "2", "--classify-frame", "1"]
    entry.main(args + ["--device", "cpu", "--condition", "vision"])
    results = json.loads((tmp_path / "results" / "word_transitions_vision.json").read_text())
    assert (tmp_path / "results" / "word_transitions_vision.md").is_file()
    assert set(results["summary"]) == {"condition", "mean_matching_rate", "mean_uniform",
                                       "mean_peak_onehot", "mean_random_onehot"}
    assert results["summary"]["condition"] == "vision" and results["per_word"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            entry.main(args)
    with pytest.raises(SystemExit, match="no 'best' or 'last'"):
        entry.main(args[:4] + [str(tmp_path / "eval")] + args[5:] + ["--device", "cpu"])


def _tiny_yaml(tmp_path):
    """``configs/mopoe_mrssm.yaml`` with the small test encoders."""
    import yaml

    repo = Path(__file__).resolve().parents[1]
    cfg = yaml.safe_load(open(repo / "configs" / "mopoe_mrssm.yaml"))
    enc = dict(channels=[4, 8], kernel_sizes=[3, 3], strides=[2, 2], paddings=[1, 1],
               num_residual_blocks=0, coord_conv=False, linear_sizes=[64])
    cfg["model"]["init_args"]["audio_encoder"] = {"config": enc}
    cfg["model"]["init_args"]["vision_encoder"] = {"config": dict(enc)}
    cfg["model"]["init_args"]["init_proj"] = {"num_cells": 32}
    path = tmp_path / "tiny.yaml"
    yaml.safe_dump(cfg, open(path, "w"))
    return path
