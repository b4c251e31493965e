"""Word-transition evaluation: the Matching Rate of imagined digit
transitions (port of ``evaluation/word_transitions.py``; reference
``evaluate_word_transitions_{mrssm,mtmrssm}.py``), one module for both
families.

- Intervals: for each word 0-9, at most ``n_intervals``, one per speaker, a
  window of ``query_length`` frames ending at the word's first occurrence.
- Predictions: the initial state from the interval's frame 0 (sampled once
  per interval), the last speaker action repeated for ``n_frames``, the
  prior-only ``rollout_transition`` (the rollout kernel on the card: MRSSM
  ``csrc/rollout.cu``, MMTRSSM ``csrc/rollout_mt.cu``), the vision decoder
  at ``classify_frame`` only, then the classifier; ``n_predictions``
  samples per interval. With ``batched=True`` a word's intervals × samples
  are one rollout launch; with ``batched=False`` (JAX's per-interval
  protocol, the reference's loop shape) each interval is one launch at
  ``B = n_predictions`` (``generate_predictions_with_classifier``).
- q(w|wa) with a failure bucket "wf"; p(w|wa) from the deduplicated label
  sequences, skipping -1 silence; MR = Σ_w min(q, p) + min(q_wf, p_wf); the
  uniform, peak-one-hot and random-one-hot baselines; markdown and JSON.

Noise differs from JAX's by design (no stream equals JAX's key splits): a
word's initial-state Gumbel noise comes from a CPU ``torch.Generator``
seeded with ``fold(seed, word)``, and its rollout's from the kernel's
Philox stream keyed by that same integer. The plain rollout on the CPU
draws the same Philox noise, so the card and the CPU sample alike. Both
protocols keep that one stream: an interval of the per-interval path takes
its row of the word's initial-state draw, and its rollout rows the keys
``(row_seed, row_index)`` they have in the word's batched rollout
(``ops.kernels.rollout.row_keys``), so ``batched=False`` predicts what
``batched=True`` does (JAX splits a new key an interval there).
"""

from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from pathlib import Path
from typing import Any

import numpy as np
import torch

from multimodal_mtrssm_tpu_torch.data.episodes import _to_nhwc
from multimodal_mtrssm_tpu_torch.data.transforms import (
    NormalizeAudioMelSpectrogram,
    NormalizeVisionImage,
)
from multimodal_mtrssm_tpu_torch.evaluation.classifier import MNISTClassifier, classifier_logits
from multimodal_mtrssm_tpu_torch.models import WorldModelNet
from multimodal_mtrssm_tpu_torch.models.mrssm import draw_gumbels
from multimodal_mtrssm_tpu_torch.nn.conv import cast_conv_in, cast_conv_out
from multimodal_mtrssm_tpu_torch.ops.kernels.rollout import Seed, row_keys
from multimodal_mtrssm_tpu_torch.train.steps import fold

WORD_SET = list(range(10))

# Which modality carries information when the initial state is inferred:
# "both" is the reference protocol; "vision"/"audio" replace the OTHER
# modality's frame with the ZeroOut fill -1 (the reference's missing-
# modality marker), so the MoPoE posterior infers the word from one alone.
CONDITIONS = ("both", "vision", "audio")


def _apply_condition(a0: np.ndarray, v0: np.ndarray,
                     condition: str) -> tuple[np.ndarray, np.ndarray]:
    """Fill (with -1) the modality that does NOT carry information."""
    if condition not in CONDITIONS:
        raise ValueError(f"condition={condition!r} not in {CONDITIONS}")
    if condition == "vision":
        a0 = np.full_like(a0, -1.0)
    elif condition == "audio":
        v0 = np.full_like(v0, -1.0)
    return a0, v0


def _check_frame(classify_frame: int, n_frames: int) -> None:
    if not 0 <= classify_frame < n_frames:
        raise ValueError(f"classify_frame={classify_frame} out of range for n_frames={n_frames}")


# ---- data loading (reference :22-148) -------------------------------------------------


def load_test_data_with_labels(test_data_dir: str | Path, use_pt_files: bool | None = None,
                               npz_dir_for_labels: str | Path | None = None) -> list[dict]:
    """Labeled test episodes, in either of the reference's layouts:

    - ``.npz`` episodes with ``audio`` (T, 32, 32), ``image`` (T, 1, 32,
      32) or NHWC, ``label`` (T,) and ``speaker`` (T, 6);
    - reference-processed ``.pt`` episodes (``act_*.pt``,
      ``audio_obs_*.pt``, ``vision_obs_*.pt``) with per-episode label files
      ``sample_%04d.npz`` in ``npz_dir_for_labels``, or first in its
      sibling ``train/`` directory (train and test numbered in one run).

    ``use_pt_files=None`` takes the ``.pt`` layout when the directory has
    ``act_*.pt`` files and no ``.npz`` ones. Unreadable files are skipped
    with a warning, as the reference does."""
    test_data_dir = Path(test_data_dir)
    if not test_data_dir.exists():
        print(f"Warning: test data directory does not exist: {test_data_dir}")
        return []
    if use_pt_files is None:
        use_pt_files = (any(test_data_dir.glob("act_*.pt"))
                        and not any(test_data_dir.glob("*.npz")))
    if use_pt_files:
        return _load_pt_episodes_with_labels(test_data_dir, npz_dir_for_labels)
    test_data = []
    for p in sorted(test_data_dir.glob("*.npz")):
        try:
            with np.load(p) as z:
                test_data.append({
                    "audio": np.asarray(z["audio"], dtype=np.float32),
                    "image": np.asarray(z["image"], dtype=np.float32),
                    "label": np.asarray(z["label"]),
                    "speaker": np.asarray(z["speaker"], dtype=np.float32),
                    "file_path": str(p),
                })
        except Exception as e:  # noqa: BLE001 — skip unreadable files like the reference
            print(f"Warning: failed to load {p}: {e}")
    return test_data


def _load_pt_episodes_with_labels(test_data_dir: Path,
                                  npz_dir_for_labels: str | Path | None) -> list[dict]:
    """The reference-processed ``.pt`` layout (reference ``:51-126``)."""
    act_files = sorted(test_data_dir.glob("act_*.pt"))
    if not act_files:
        print(f"Warning: no act_*.pt files found in {test_data_dir}")
        return []
    if npz_dir_for_labels is None:
        print("Warning: .pt episodes carry no labels; pass npz_dir_for_labels pointing at the "
              "original sample_*.npz directory.")
        return []
    npz_dir = Path(npz_dir_for_labels)
    test_data = []
    for act_path in act_files:
        try:
            file_idx = int(act_path.stem.split("_")[1])
            audio_path = test_data_dir / f"audio_obs_{file_idx:04d}.pt"
            vision_path = test_data_dir / f"vision_obs_{file_idx:04d}.pt"
            if not audio_path.exists() or not vision_path.exists():
                continue
            audio = torch.load(audio_path, weights_only=True).numpy()
            if audio.ndim == 4 and audio.shape[1] == 1:
                audio = audio[:, 0]  # (T, 1, 32, 32) → (T, 32, 32)
            image = torch.load(vision_path, weights_only=True).numpy()
            speaker = torch.load(act_path, weights_only=True).numpy()
            # Train episodes are numbered before test ones (reference
            # :100-104): the sibling train/ directory first, then here.
            candidates = []
            if (npz_dir.parent / "train").exists():
                candidates.append(npz_dir.parent / "train" / f"sample_{file_idx:04d}.npz")
            candidates.append(npz_dir / f"sample_{file_idx:04d}.npz")
            existing = [p for p in candidates if p.exists()]
            if len(existing) > 1:
                print(f"Warning: labels for index {file_idx} exist in BOTH "
                      f"{existing[0].parent.name}/ and {existing[1].parent.name}/; using "
                      f"{existing[0]} (reference preference order, which assumes train-then-"
                      "test continued numbering)")
            if not existing:
                continue
            with np.load(existing[0]) as z:
                label = np.asarray(z["label"])
            test_data.append({
                "audio": np.asarray(audio, dtype=np.float32),
                "image": np.asarray(image, dtype=np.float32),
                "label": label,
                "speaker": np.asarray(speaker, dtype=np.float32),
                "file_path": str(act_path),
            })
        except Exception as e:  # noqa: BLE001 — skip unreadable files like the reference
            print(f"Warning: failed to load {act_path}: {e}")
    return test_data


def _speaker_index(speaker: np.ndarray) -> int:
    """Speaker id from the episode's first one-hot row (reference :151-160)."""
    return int(np.argmax(speaker[0]))


def select_intervals_for_word(word: int, test_data: list[dict], n_intervals: int = 6,
                              query_length: int = 30) -> list[dict]:
    """At most ``n_intervals`` intervals containing ``word``, one per speaker
    (reference :163-233)."""
    selected, speakers_used = [], set()
    for file_idx, data in enumerate(test_data):
        labels = data["label"]
        positions = np.where(labels == word)[0]
        if len(positions) == 0:
            continue
        speaker_idx = _speaker_index(data["speaker"])
        if speaker_idx in speakers_used:
            continue
        word_pos = int(positions[0])
        start = max(0, word_pos - query_length + 1)
        end = start + query_length
        if end > len(labels):
            start, end = 0, query_length
        selected.append({
            "audio": data["audio"][start:end],
            "image": data["image"][start:end],
            "speaker": data["speaker"][start:end],
            "label": labels[start:end],
            "speaker_idx": speaker_idx,
            "file_idx": file_idx,
        })
        speakers_used.add(speaker_idx)
        if len(selected) >= n_intervals:
            break
    return selected


# ---- prediction (reference :286-372, one rollout a word) -----------------------------


def _repeat_rows(state: Any, n: int) -> Any:
    """Each row of a ``[B, ·]`` state ``n`` times in a row: ``[B · n, ·]``."""
    return type(state)(**{f.name: getattr(state, f.name).repeat_interleave(n, 0)
                          for f in dataclasses.fields(state)})


def _init_noise(model: WorldModelNet, n_intervals: int, seed: int) -> dict[str, torch.Tensor]:
    """A word's initial-state Gumbel noise, ``[n_intervals, ·]`` a site,
    from a CPU generator seeded with ``seed``."""
    shapes = {k: s for k, s in model.noise_shapes(n_intervals, 1).items()
              if k.startswith("g_init")}
    return draw_gumbels(shapes, torch.Generator().manual_seed(int(seed)), None)


@torch.no_grad()
def _predict(model: WorldModelNet, classifier: MNISTClassifier, intervals: list[dict],
             init_noise: dict[str, torch.Tensor], rollout_seed: Seed, n_predictions: int,
             n_frames: int, audio_transform: NormalizeAudioMelSpectrogram | None,
             vision_transform: NormalizeVisionImage | None, classify_frame: int,
             condition: str) -> dict[str, Any]:
    """One rollout over ``intervals`` × ``n_predictions`` rows on the
    model's device: the initial state from each interval's frame 0 on
    ``init_noise`` (``[I, ·]``), repeated over its predictions, the rollout
    on the Philox stream of ``rollout_seed``, the vision decoder at
    ``classify_frame`` alone, the classifier (:func:`predict_word`'s keys
    but the seed)."""
    device = next(model.parameters()).device
    audio_transform = audio_transform or NormalizeAudioMelSpectrogram(-80.0, 0.0)
    vision_transform = vision_transform or NormalizeVisionImage()
    a0 = np.stack([audio_transform(_to_nhwc(iv["audio"]))[0] for iv in intervals])
    v0 = np.stack([vision_transform(_to_nhwc(iv["image"]))[0] for iv in intervals])
    a0, v0 = _apply_condition(a0, v0, condition)
    last = np.stack([iv["speaker"][-1] for iv in intervals])  # [I, A]
    P = n_predictions
    actions = torch.as_tensor(np.repeat(last, P, axis=0), dtype=torch.float32, device=device)
    actions = actions[:, None, :].expand(len(intervals) * P, n_frames, -1).contiguous()
    init_noise = {k: v.to(device) for k, v in init_noise.items()}
    initial = model.initial_state(torch.as_tensor(a0, device=device),
                                  torch.as_tensor(v0, device=device), *init_noise.values())
    states = model.rollout_transition(actions, _repeat_rows(initial, P), rollout_seed)
    feature = cast_conv_in(model.cfg, states[:, classify_frame].feature)
    frame = cast_conv_out(model.cfg, model.vision_decoder(feature))  # [I·P, H, W, C]
    logits = classifier_logits(classifier, (frame + 1.0) / 2.0)
    return {"digits": logits.argmax(-1), "logits": logits, "initial": initial,
            "init_noise": init_noise, "states": states}


def predict_word(model: WorldModelNet, classifier: MNISTClassifier, intervals: list[dict],
                 seed: int, n_predictions: int = 10, n_frames: int = 10,
                 audio_transform: NormalizeAudioMelSpectrogram | None = None,
                 vision_transform: NormalizeVisionImage | None = None, classify_frame: int = 0,
                 condition: str = "both") -> dict[str, Any]:
    """One rollout over all ``intervals`` × ``n_predictions`` rows, on the
    model's device: the initial state sampled once per interval from its
    frame 0 (Gumbel noise from a CPU generator seeded with ``seed``) and
    repeated over its predictions, the rollout on the Philox stream of
    ``seed``, the vision decoder at ``classify_frame`` alone, the
    classifier. Returns ``digits`` and the classifier's ``logits`` (``[I ·
    P]``, ``[I · P, 10]``), the ``initial`` state (``[I]``), its Gumbel
    ``init_noise``, the rollout's ``states`` (``[I · P, n_frames]``) and the
    ``seed``."""
    _check_frame(classify_frame, n_frames)
    out = _predict(model, classifier, intervals, _init_noise(model, len(intervals), seed),
                   int(seed), n_predictions, n_frames, audio_transform, vision_transform,
                   classify_frame, condition)
    return {**out, "seed": int(seed)}


def generate_predictions_batched(model: WorldModelNet, classifier: MNISTClassifier,
                                 intervals: list[dict], seed: int, n_predictions: int = 10,
                                 n_frames: int = 10,
                                 audio_transform: NormalizeAudioMelSpectrogram | None = None,
                                 vision_transform: NormalizeVisionImage | None = None,
                                 classify_frame: int = 0, condition: str = "both") -> list[int]:
    """Predicted digits of all intervals × samples of one word, from one
    rollout launch (:func:`predict_word`); each interval contributes
    ``n_predictions`` digits, in interval order."""
    out = predict_word(model, classifier, intervals, seed, n_predictions, n_frames,
                       audio_transform, vision_transform, classify_frame, condition)
    return [int(d) for d in out["digits"].cpu()]


def generate_predictions_with_classifier(
        model: WorldModelNet, classifier: MNISTClassifier, interval: dict, seed: int,
        n_predictions: int = 10, n_frames: int = 10,
        audio_transform: NormalizeAudioMelSpectrogram | None = None,
        vision_transform: NormalizeVisionImage | None = None, classify_frame: int = 0,
        condition: str = "both", interval_index: int = 0, n_intervals: int = 1) -> list[int]:
    """Predicted digits of one interval, from one rollout launch at ``B =
    n_predictions`` (JAX's per-interval protocol): the interval as interval
    ``interval_index`` of a word of ``n_intervals``, keyed as it is in that
    word's batched rollout (the module docstring), so the digits are those
    :func:`generate_predictions_batched` gives it with ``seed``."""
    _check_frame(classify_frame, n_frames)
    if not 0 <= interval_index < n_intervals:
        raise ValueError(f"interval_index={interval_index} out of range for "
                         f"n_intervals={n_intervals}")
    i, P = interval_index, n_predictions
    noise = {k: v[i:i + 1] for k, v in _init_noise(model, n_intervals, seed).items()}
    row_seed, row_index = row_keys(int(seed), n_intervals * P)
    out = _predict(model, classifier, [interval], noise,
                   (row_seed[i * P:(i + 1) * P], row_index[i * P:(i + 1) * P]), P, n_frames,
                   audio_transform, vision_transform, classify_frame, condition)
    return [int(d) for d in out["digits"].cpu()]


# ---- distributions and the Matching Rate (reference :375-538) ------------------------


def compute_prediction_distribution(predicted_words: list[int],
                                    word_set: list[int] = WORD_SET) -> dict:
    """q(w|wa) over classified samples, failure mass in "wf" (reference :375-401)."""
    total = len(predicted_words)
    if total == 0:
        return {w: 0.0 for w in word_set} | {"wf": 0.0}
    counts = defaultdict(int)
    for w in predicted_words:
        if w in word_set:
            counts[w] += 1
    dist = {w: counts.get(w, 0) / total for w in word_set}
    dist["wf"] = (total - sum(counts.values())) / total
    return dist


def compute_true_distribution(word: int, test_data: list[dict],
                              word_set: list[int] = WORD_SET) -> dict:
    """p(w|wa) from deduplicated label sequences, skipping -1 silence
    (reference :404-458)."""
    next_counts: dict[int, int] = defaultdict(int)
    total = 0
    for data in test_data:
        seq, prev = [], None
        for label in data["label"]:
            d = int(label)
            if d == -1:
                continue
            if d != prev:
                seq.append(d)
                prev = d
        for i in range(len(seq) - 1):
            if seq[i] == word:
                if seq[i + 1] in word_set:
                    next_counts[seq[i + 1]] += 1
                total += 1
    if total == 0:
        return {w: 0.0 for w in word_set} | {"wf": 0.0}
    dist = {w: next_counts.get(w, 0) / total for w in word_set}
    dist["wf"] = 0.0
    return dist


def compute_matching_rate(q_dist: dict, p_dist: dict, word_set: list[int] = WORD_SET) -> float:
    """MR = sum_w min(q, p) + min(q_wf, p_wf) (reference :461-489)."""
    mr = sum(min(q_dist.get(w, 0.0), p_dist.get(w, 0.0)) for w in word_set)
    return mr + min(q_dist.get("wf", 0.0), p_dist.get("wf", 0.0))


def compute_baselines(p_dist: dict, word_set: list[int] = WORD_SET, n_random_trials: int = 100,
                      seed: int = 0) -> dict:
    """Uniform / peak-one-hot / random-one-hot MR baselines (reference :492-538)."""
    n = len(word_set)
    uniform = {w: 1.0 / n for w in word_set} | {"wf": 0.0}
    peak_word = max(word_set, key=lambda w: p_dist.get(w, 0.0))
    peak = {w: (1.0 if w == peak_word else 0.0) for w in word_set} | {"wf": 0.0}
    rng = np.random.default_rng(seed)
    random_mrs = []
    for _ in range(n_random_trials):
        rw = int(rng.choice(word_set))
        rdist = {w: (1.0 if w == rw else 0.0) for w in word_set} | {"wf": 0.0}
        random_mrs.append(compute_matching_rate(rdist, p_dist, word_set))
    return {
        "uniform": compute_matching_rate(uniform, p_dist, word_set),
        "peak_onehot": compute_matching_rate(peak, p_dist, word_set),
        "random_onehot": float(np.mean(random_mrs)),
    }


# ---- the whole evaluation (reference :808-1020) -----------------------------------------


def evaluate_word_transitions(model: WorldModelNet, classifier: MNISTClassifier,
                              test_data: list[dict], *, n_intervals: int = 6,
                              query_length: int = 30, n_predictions: int = 10,
                              n_frames: int = 10, audio_min: float = -80.0,
                              audio_max: float = 0.0, seed: int = 0,
                              word_set: list[int] = WORD_SET, classify_frame: int = 0,
                              condition: str = "both", batched: bool = True) -> dict:
    """The Matching-Rate evaluation on the model's device; returns the
    results dict (JSON-ready), JAX's keys.

    ``condition``: "both" (the reference protocol), "vision" or "audio"
    (the other modality's conditioning frame is the ZeroOut fill -1).
    Each word's noise comes from ``fold(seed, word)``; ``batched=True``
    runs its intervals × samples as one rollout, ``batched=False`` an
    interval a rollout, with the same predictions. ``classify_frame``
    picks the imagined frame the classifier scores: 0 is the reference's;
    under the reference's same-frame training alignment frame 1 carries
    the one-word-ahead prediction that p(w|wa) describes."""
    _check_frame(classify_frame, n_frames)
    audio_t = NormalizeAudioMelSpectrogram(audio_min, audio_max)
    vision_t = NormalizeVisionImage()
    results = {}
    for word in word_set:
        intervals = select_intervals_for_word(word, test_data, n_intervals, query_length)
        if not intervals:
            continue
        args = (fold(seed, word), n_predictions, n_frames, audio_t, vision_t, classify_frame,
                condition)
        if batched:
            predicted = generate_predictions_batched(model, classifier, intervals, *args)
        else:
            predicted = [d for i, iv in enumerate(intervals)
                         for d in generate_predictions_with_classifier(
                             model, classifier, iv, *args, i, len(intervals))]
        q_dist = compute_prediction_distribution(predicted, word_set)
        p_dist = compute_true_distribution(word, test_data, word_set)
        results[str(word)] = {
            "n_intervals": len(intervals),
            "n_predictions": len(predicted),
            "q_dist": {str(k): v for k, v in q_dist.items()},
            "p_dist": {str(k): v for k, v in p_dist.items()},
            "matching_rate": compute_matching_rate(q_dist, p_dist, word_set),
            "baselines": compute_baselines(p_dist, word_set),
        }
    valid = [r["matching_rate"] for r in results.values()]

    def mean_baseline(name: str) -> float:
        return float(np.mean([r["baselines"][name] for r in results.values()])) if valid else 0.0

    summary = {
        "condition": condition,
        "mean_matching_rate": float(np.mean(valid)) if valid else 0.0,
        "mean_uniform": mean_baseline("uniform"),
        "mean_peak_onehot": mean_baseline("peak_onehot"),
        "mean_random_onehot": mean_baseline("random_onehot"),
    }
    return {"per_word": results, "summary": summary}


def write_results(results: dict, out_dir: str | Path,
                  name: str = "word_transitions") -> tuple[Path, Path]:
    """Markdown and JSON output (reference :541-600)."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    json_path = out_dir / f"{name}.json"
    json_path.write_text(json.dumps(results, indent=2))
    s = results["summary"]
    lines = [
        "# Word-transition Matching Rate",
        "",
        "| word | MR | uniform | peak | random | n_pred |",
        "|---|---|---|---|---|---|",
    ]
    for word, r in sorted(results["per_word"].items(), key=lambda kv: int(kv[0])):
        b = r["baselines"]
        lines.append(
            f"| {word} | {r['matching_rate']:.3f} | {b['uniform']:.3f} | "
            f"{b['peak_onehot']:.3f} | {b['random_onehot']:.3f} | {r['n_predictions']} |")
    lines += [
        "",
        f"**mean MR = {s['mean_matching_rate']:.3f}** "
        f"(uniform {s['mean_uniform']:.3f}, peak {s['mean_peak_onehot']:.3f}, "
        f"random {s['mean_random_onehot']:.3f})",
    ]
    md_path = out_dir / f"{name}.md"
    md_path.write_text("\n".join(lines) + "\n")
    return md_path, json_path
