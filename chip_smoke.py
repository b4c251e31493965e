#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It refuses to run without a CUDA device and exits non-zero on any failure.
``python3 chip_smoke.py --decoder`` runs only the fused decoder's timings
(``decoder_phase``), ``--recurrence-bwd`` only the MRSSM recurrence
backward's (``recurrence_bwd_phase``), ``--mt-recurrence-bwd`` only the
MMTRSSM recurrence backward's (``mt_recurrence_bwd_phase``),
``--mt-recurrence-fwd`` only the MMTRSSM recurrence forward's
(``mt_recurrence_fwd_phase``), ``--recurrence-fwd`` only the MRSSM
recurrence forward's beside the stacked forward's
(``recurrence_fwd_phase``), ``--rollout`` only both imagination rollouts'
(``rollout_phase``: a call's CUDA-event time, its kernel's device time,
each stage's alone and one against two batch rows a block, at B=8 T=30,
B=64 T=30 and B=256 T=180), ``--stacked-recurrence-bwd`` only the stacked
recurrence backward's beside the unstacked one's
(``stacked_recurrence_bwd_phase``): for comparing two trees in one call.
``--bf16-encoder [PARENT]`` times only the bf16 fused encoder kernels
(call and device ms at N=240 and 3840, the backward's kernels) and the
16-mixed ``fused_enc`` train step of both families, beside ``ptxas``'s
report of their sources; given PARENT, an unpacked ``git archive`` of
another commit, it times PARENT's package too, in turns parent, this
tree, this tree, parent, each in a process of its own
(``bf16_encoder_phase``). ``--bf16-encoder-stamps`` runs stamped copies of
the bf16 encoder kernels (clock64 at each weight slice and each
weight-gradient block; the forward also without its tensor-core products,
and without its ldmatrix loads) and prints where a block's cycles go
(``bf16_stamps_phase``). ``--bf16-decoder [PARENT]`` does the same for the
bf16 fused decoder kernels (call and device ms of each pass at N=240 and
3840, 48- and 96-wide features, beside the cuDNN ``Decoder`` on the same
bf16 features, and each kernel's tensor-core instructions in the built
library; ``bf16_decoder_phase``), and ``--bf16-decoder-racecheck`` runs
compute-sanitizer's racecheck and synccheck over one launch of each
(``bf16_decoder_racecheck``).
Four configurations go through the serving and training phases, each with
seeded random weights (no trained checkpoint or dataset on the machine;
the shapes and the path are the real ones): MoPoE-MRSSM (``MRSSMConfig()``),
the hierarchical MoPoE-MMTRSSM (``MMTRSSMConfig()``), MoPoE-MRSSM on the
fused encoder and the stacked recurrence (``MRSSMConfig(conv_layout=
"fused_enc", use_pallas_train="stacked")``) and MoPoE-MMTRSSM on the fused
encoder (``MMTRSSMConfig(conv_layout="fused_enc")``). Then the fused conv
decoder (``fused_decoder_apply``), which no model config selects, on the
first two configurations' latent features.

0. Device: prints the card's name and power limit, turns TF32 off.
1. Build: compiles the sixteen kernels from ``multimodal_mtrssm_tpu_torch/csrc``
   (one ``nvcc`` per source, in parallel).
2. Kernel checks, each kernel against its plain PyTorch version on the card:
   the MRSSM recurrence forward at B=8 T=30, B=128 T=30 and B=3 T=7, the MT
   recurrence forward at those and B=32 T=30, and on fresh weights at odd
   widths and at a lower latent of 40 (B=8, 128 T=30, B=3 T=7; two launches
   bit-identical) (same noise; deters, integrators and logits within 1e-4,
   stochs equal outside near-ties of 1e-5); both backwards at the same shapes,
   on the forward's record and random cotangents on every output (every
   gradient within 2e-4 × max(1, max|plain|), two launches bit-identical);
   both rollouts at B=10
   T=10, the evaluation's B=60 T=10, B=64 T=30 and B=256 T=180 (replay of their stochs within 1e-4,
   stochs equal to the argmax of their logits plus the seed's Philox noise,
   two launches bit-identical, sampling frequencies against the softmax,
   both MT sites; and, on per-row Philox keys, the rows of four coalesced
   requests at 16 rows and 32 steps: the prologue's noise equal to the
   plain per-row draw bit for bit, the replay, and each request's rows
   against its own launch, stochs equal before a near-tie); the stacked
   recurrence forward and backward at B=8 T=30, B=128 T=30 and B=3 T=7
   (the same limits, on unstacked gradients; the forward's outputs
   bit-identical to the unstacked forward's on the same weights; the
   backward's zero blocks 0, its gradients unstacked and its input
   cotangents bit-identical to the unstacked backward's kernels on the same
   weights); the fused encoder forward at
   N=240, 7, 3840 and 241 frames against its plain version and the cuDNN
   ``Encoder`` (within 1e-4 × max(1, max|plain|)) and its backward against
   the plain backward in float64 (2e-4 × scale, two launches bit-identical);
   the fused decoder forward on both decoders of MRSSM (48-wide features)
   and MMTRSSM (96-wide) at N=240 and on MRSSM's at N=3840, against its
   plain version and the model's own cuDNN ``decode_state`` (within 1e-5),
   and its backward of ``gaussian_nll`` against the plain backward in
   float64 (2e-4 × scale, two launches bit-identical).
3. Serving end to end, per configuration, behind ``InferenceServer``:
   ``/healthz``, ``/observe`` (B=8, T=30, decode, JSON), two chained
   ``/imagine`` (T=30, decode, npz then JSON). Checks shapes, finiteness,
   that the configuration's serving kernels were launched by those
   requests, and that the card's observe posterior and frames equal the
   CPU path's on the same weights and seed.
3b. Serving a trained run, after phase 4, for ``MRSSMConfig()`` and
   ``MMTRSSMConfig()``: ``WorldModel.from_checkpoint`` on the model config
   and the fit's checkpoints directory, behind a server that coalesces
   (5 ms window, ``batch_max`` 8); 8 concurrent ``/observe`` (B ∈ {1, 2,
   3, 8}, T ∈ {5, 10, 30}, decode, npz, each its own seed), then 8
   concurrent ``/imagine`` from their states. Fails unless fewer rollout
   launches than requests served them, no well-formed batch was re-run
   alone, and each reply equals the same request alone (frames and
   latents within 1e-4, stochs equal, before each row's first Gumbel
   near-tie of 1e-5); prints whether the replies were bit-identical.
4. Training end to end, per configuration: 24 synthetic Audio-MNIST
   episodes, then ``Trainer(model, datamodule, config).fit()``, B=8, T=30,
   2 epochs of 3 optimizer steps. Checks finite losses, that every
   parameter moved, that each of the configuration's training kernels ran
   at least once a step, and that ``best`` loads into a fresh model; then
   one train step on the card against the CPU path with the same weights,
   batch and noise (each loss term within 2e-5 of the loss, gradients
   within 3e-4 × scale; noise with a Gumbel near-tie is reported and
   replaced by the next seed's).
4b. Resume and preemption on the card, after phase 3b, for
   ``MRSSMConfig()`` and ``MMTRSSMConfig()`` (``drive_resume``; B=8 T=30,
   24 synthetic episodes, 2 epochs of 3 steps, cuDNN held to deterministic
   algorithms): a fit SIGTERMed after its 4th optimizer step (mid epoch 1)
   must return ``preempted`` with a mid-epoch ``last``, and a fresh
   ``Trainer``'s ``fit(resume=True)`` must end within 3e-4 × max(1,
   max|w|) per tensor of the uninterrupted fit (printed: bit-identical or
   not); a fit with ``accumulate_grad_batches=2`` (launches of the
   training kernels per optimizer step printed), and one with
   ``profile_epoch=0``, whose trace must exist.
4c. The train command (``drive_train_command``): ``train.entry.
   run_training`` on a PyYAML-free ``Experiment`` (``make_experiment``),
   on the card, ``--synthetic 24 --max-epochs 1``, then ``--max-epochs 2
   --resume``, which must continue at epoch 1.
6. Evaluation (``evaluation_inputs``, ``fine_tune``, ``drive_evaluation``):
   a classifier trained on the card on stripe digits (accuracy above 0.9),
   24 labeled synthetic episodes, each family's phase-4 ``best``
   warm-started and trained on them for 100 epochs of 3 steps, then that
   run's ``best`` evaluated at ``classify_frame`` 0 and 1 (6 intervals ×
   10 predictions, 10 frames) and once through the
   ``evaluate-word-transitions`` entry. Fails unless each word took
   exactly one rollout launch, every ``q_dist`` sums to 1, the rollout
   states equal the CPU path's on the same weights and seed up to each
   row's first Gumbel near-tie (stochs equal, the rest within 1e-4), the
   digits equal the CPU path's outside Gumbel and classifier-logit
   near-ties of 1e-5, and the compared rows hold more than one digit.
   Prints the mean MR, rows compared and excluded, the digits seen, ms a
   word (CUDA events) and the rollout kernel's device time at B=60 T=10.
7. The cross-modal run (``drive_crossmodal``), after phase 5's decoder
   path: (a) ``configs/mopoe_mrssm_crossmodal.yaml``, loaded with this
   run's directories, seed, 2 epochs and the GIFs every epoch, fits 2
   epochs × 3 steps at B=8 T=30 on 24 synthetic episodes with the GIF
   callback every epoch: finite losses; every train and val sample's
   audio input at -1, no target dropped; the recurrence forward launched
   once a step, a validation batch and a stage's render, the backward
   once a step, the rollout once a render; GIFs of 30 frames in
   ``viz/epoch_0001`` and ``viz/final_best`` (7 train, 5 val), each logged,
   the audio row "(missing)"; (b) ``compute_reconstructions`` of the fit's
   best (``MRSSMConfig()``) and of seeded ``MMTRSSMConfig()`` weights at 7
   episodes × 30 frames, q=10: one recurrence-forward and one rollout
   launch, states and frames against the CPU path within 1e-4 before each
   row's first near-tie of 1e-5 (``parity.check_reconstructions``), on at
   least half the steps; (c)
   phase 4b's preempt-and-resume under ``drop_modality="random"``:
   bit-identical to the uninterrupted fit, validation clean, the train
   samples of each kind printed; (d) ``reconstruction_report`` of the best
   on phase 6's labeled episodes: JAX's structure, 3 forward and 3 rollout
   launches, ``drop_audio`` unlike ``both``, each condition against the
   CPU path; (e) ms a ``compute_reconstructions`` (CUDA events, median of
   20) and its kernels' device share (``torch.profiler``), ms a report, s
   a GIF render of each stage (host clock, median of 3); (f)
   ``crossmodal_e2e`` at 1 seed, the crossmodal variant, 2 epochs, 24
   episodes: ``summary.json`` with JAX's keys, MR and audio MSE printed.
5. Timings: median ms of each kernel against its plain version (the
   stacked kernels beside the unstacked ones, the fused encoder beside the
   cuDNN ``Encoder``, the fused decoder beside the cuDNN ``Decoder``), of
   a full train step on the kernels against the plain versions on the
   card, a device-time breakdown of the train step (``torch.profiler``),
   the median latency of ``/observe`` and ``/imagine`` through the server
   and the optimizer steps per second of ``Trainer.fit``; each kernel's
   bound at the main path's shape; the device time of each kernel of one
   MRSSM recurrence backward call (recompute, chain, the deferred GEMMs)
   beside the call's at B=8 and B=128 T=30, the same of the MMTRSSM
   recurrence backward at B=8, 32 and 128 T=30, and of the MMTRSSM and
   MRSSM recurrence forwards with the device time of each of their stages
   (the stacked forward beside the MRSSM one); the fused encoder forward's
   device time and the device time of each kernel of one fused encoder
   backward call (``torch.profiler``), the same of the fused decoder's
   forward and backward calls; and the registers, stack and spills
   ``ptxas`` gives the fused encoder's and decoder's kernels, forward and
   backward, the MRSSM and MMTRSSM recurrence backwards' three kernels, the
   stacked backward's pack and scatter, both recurrence forwards and both
   rollouts; and for the trained runs of phase 3b, the p50 latency of
   ``/observe`` and ``/imagine`` under 8 concurrent clients, coalesced and
   not, and the ``/observe`` split at B=8 T=30 (the route's direct call on
   the calling thread, in a fresh thread, on a long-lived batcher thread,
   and through HTTP).
8. After phase 7: (a) the bf16 fused encoder kernels (``trainer.precision:
   16-mixed`` at ``conv_layout="fused_enc"``) against their plain bf16
   versions at N=240 and 3840, forward within 1e-2 × scale and within 0.1
   of the f32 kernel, backward within 2e-2 × scale per tensor, two launches
   bit-identical; their times beside the f32 kernels and cuDNN's ``Encoder``
   on bf16 frames, and each backward kernel's device time; (b) the plain
   route by name (``use_pallas_train=False``), each family: a Tanh model's
   train step and imagination on the card against the CPU, an ELU model's
   plain route against its kernel route on the same weights and noise, no
   recurrence or rollout launch on the plain route, a train step's time on
   both routes; a category block of 33 refused with a message naming the
   route, then run on it; whether a train step at T=180 fits the kernels;
   (c) ``configs/mopoe_mrssm.yaml`` and ``mopoe_mmtrssm.yaml`` with
   ``precision: 16-mixed`` at nhwc and fused_enc, each fit 2 epochs × 3
   steps: no f32 encoder kernel, at fused_enc the bf16 kernels twice a
   step each way; a train step card vs CPU within 1e-2 of the loss and 5e-2
   × scale; the step's time and device breakdown; (d)
   ``demo_e2e`` and ``probe_transitions`` of each family at 1 seed, 2
   epochs and 24 episodes, as path checks.
9. After phase 8, the other families (``drive_other_families``), TF32
   off: (a) ``configs/mopoe_mrssm.yaml`` with ``class_path:
   WeightedMoPoEMRSSM`` (its step loop: no recurrence kernel computes
   learned weights) fits 2 epochs × 3 steps at B=8 T=30 with no recurrence
   launch (phase 12 times its step); one train step card vs CPU (a seed without near-ties, the phase 4 bounds)
   and the posterior, prior and subset weights card vs CPU within 1e-4
   before each row's first near-tie (``parity.first_near_tie``), the
   weights summing to 1 within 1e-5; ``/observe`` and two ``/imagine``
   through an ``InferenceServer`` on ``WorldModel.from_checkpoint`` of the
   weighted YAML and the fit's checkpoints (a rollout launch an
   ``/imagine``), and its imagination held to the plain rollout
   (``parity.check_rollout``); ``use_pallas_train=True`` refused; a step
   at ``conv_layout: fused_enc`` launching each fused encoder kernel twice,
   and its CUDA-event ms, device ms and busy share; (b) the same YAML with
   ``class_path: RSSM`` and ``modality: vision``: the fit, a train step
   card vs CPU, and its imagination
   on ``rollout.cu`` held to the plain rollout and to the plain route's on
   the CPU.

10. After phase 9, data-parallel training on ``torch.distributed``
    (``drive_distributed``), TF32 off: (a) on an NCCL process group of one
    rank, ``Trainer.fit`` of ``MRSSMConfig()`` with ``zero1``, 2 × 3 steps
    at B=8 T=30 on 24 synthetic episodes under deterministic cuDNN, its
    weights against phase 4b's uninterrupted fit within 3e-4 × scale
    (bit-identical or not printed); (b) ``dryrun_multichip(4)`` on the
    card with gloo ranks sharing it (NCCL refuses two ranks on one
    device): both families at the reference config, flat, ZeRO-1 and the
    hybrid ``(dcn, data)`` check, each rank's recurrence
    kernels launched every step; (c) a 2-rank gloo fit of
    ``MMTRSSMConfig(conv_layout="fused_enc")`` with ``zero1``: the fused
    encoder and recurrence kernels launched every step on each rank, the
    history within 1e-4 relative and the weights within 3e-4 × scale of
    the 1-process fit; (d) ms a step of ``MRSSMConfig()`` at a global B=8
    T=30 at 1 process and NCCL W=1 (in turns: 1 process, NCCL W=1, NCCL
    W=1, 1 process) and gloo W=2, the gradient all-reduce's and the
    ZeRO-1 all-gather's ms a step (CUDA events, and the host's time inside
    each call) and the busy share (``torch.profiler``). NCCL across two
    cards is not on this one-card machine.

11. After phase 10, full-model bf16 and the bf16 fused decoder, TF32 off:
    (a) ``fused_decoder_apply`` on phase 5's observed features cast to
    bf16 (both decoders of both families, B=8 T=30, forward and a
    ``gaussian_nll`` backward): each bf16 decoder kernel once a decoder
    and nothing else; the bf16 kernels at N=240 and 3840, 48- and 96-wide
    features, against the plain bf16 versions (forward 1e-2 × scale and
    within 0.1 of the f32 kernel, backward 2e-2 × scale per tensor, two
    launches bit-identical), their CUDA-event and device ms beside the
    plain versions, the f32 kernels and cuDNN's ``Decoder`` on bf16
    features, their bound at the bf16 peak (a profiler window that sees
    none of the forward's kernels prints what it saw); (b) ``MRSSMConfig`` and
    ``MMTRSSMConfig`` at ``compute_dtype=torch.bfloat16`` and
    ``use_pallas_train=False``, at nhwc and fused_enc: ``"auto"`` refused
    naming the plain route; a fit of 2 × 3 steps at B=8 T=30 on 24
    synthetic episodes launching no recurrence or rollout kernel (at
    fused_enc only the bf16 encoder kernels, twice a step each way); the
    carries bf16, the logits f32; a train step card vs CPU on the steps
    before the first Gumbel near-tie of 1e-2, at least half of them, within
    1e-2 of the loss and 5e-2 × scale, the gradients float32 and finite;
    the step's CUDA-event ms, device ms and busy share (phase 12 times
    the f32 plain route beside MRSSM's nhwc bf16 step); (c) the weighted model and ``RSSM`` (vision) from the
    YAML at bf16, a fit each; (d) the MRSSM nhwc and the weighted fits'
    checkpoints served (``WorldModel.from_checkpoint`` on their configs):
    float32 states and frames out of an observe, ``/observe`` and two
    ``/imagine`` through ``InferenceServer`` against the CPU path, the
    weighted model's imagination on ``rollout.cu`` held to the plain
    rollout (``parity.check_rollout``). After phase 11, every pass of
    both bf16 stacks (forward, cotangent, weight gradients) holds
    ``HMMA.16816.F32.BF16`` instructions in the built library
    (``cuobjdump -sass``).

12. After phase 11, K-step dispatch (``drive_kstep``), TF32 off, on 96
    synthetic episodes at B=8 T=30 (76 train: 9 full batches and a tail;
    K=auto is 9), for every route that trains on the card (MRSSM nhwc,
    ``fused_enc`` + ``stacked``, 16-mixed ``fused_enc``, the plain route,
    full bf16; MMTRSSM nhwc and ``fused_enc``; ``WeightedMoPoEMRSSM`` and
    ``RSSM`` from the YAML): under deterministic cuDNN, fits of 3 epochs
    at K=1, at K=auto (each step a replay of the captured step) and
    device-resident at K=auto, the last two bit for bit the first
    (weights, epoch rows, global step); the capture's and warm-up's ms,
    its pool's MB and launches a replay; each fit's steps/s over epochs 2
    and 3. Then, in a fresh process (``--kstep-probe``: late in a long
    process the profiler drops device records), for each route on a fresh
    model: ms a step at K=1 and K=auto, the median and range of 5
    interleaved turns (K steps a turn; 3 eager steps on the routes with no
    counted kernel); a profiler window of each, in which every training
    kernel of ``KSTEP_SIGNATURES`` must be seen exactly as often as the
    launch counters say, launched by ``cudaGraphLaunch`` in the graphed
    one, and the replays' counters must be the capture's times K; the
    device ms, busy share and host launch calls a step. A profiler that
    fails or keeps no device record fails the phase. Then a zero1 fit of
    ``MRSSMConfig()`` at K=auto on an NCCL group of one rank (all-reduce
    and all-gather inside the graph) bit for bit the one-process fit.
    ``--kstep`` runs this phase alone.

13. After phase 12, the host input path (``drive_host_input``), on phase
    12's episodes and their memory-mapped pack, at the pipeline's noise
    0.1: (a) ``libfastbatch`` (``csrc/fastbatch.cc``, ``g++``) built on
    this host; at std 0 both native gathers bit for bit their plain
    versions on a B=8 T=30 batch, in memory and from the raw pack; at std
    0.1 the same bits on 1, 3 and all threads; the host ms of one
    stream's noised gather at 1, 2, 4 and all threads and through its
    plain version, and of one batch's assembly through the native library
    (the pipeline's thread counts) and through the plain versions (medians
    of 15 interleaved turns); (b) under deterministic cuDNN,
    ``MRSSMConfig()`` fits of 3 epochs at K=1 and K=auto, in memory and
    from the pack, each pair bit for bit; (c) a K=auto fit whose second
    epoch the trainer profiles (``profile_epoch``): every batch upload in
    its trace a ``Memcpy HtoD (Pinned -> Device)`` on a stream that ran no
    replay's recurrence kernel, at least one overlapping a replay's
    kernels, none pageable; (d) ``Trainer.fit`` steps/s over epochs 2-3 at
    K=auto, the host path against device-resident, 3 interleaved fits
    each, for MRSSM nhwc and ``fused_enc`` + ``stacked``; (e) one word
    (6 intervals × 10 predictions, 10 frames) of a seeded ``MRSSMConfig()``
    evaluated batched (one rollout launch) and per interval (a launch an
    interval): equal digits, and ms a word each way. ``--host-input`` runs
    this phase alone.

``python3 chip_smoke.py --learning-demo`` runs only the learning
demonstration's long runs (``learning_demo_phase``: ``demo_e2e`` at the JAX
script's decisive flags, 5 seeds a family, ``crossmodal_e2e`` at 100 epochs
× 3 seeds, ``probe_transitions`` of each family at its defaults, as five
processes at once on the card), copying their summaries, per-seed results
and metrics under ``runs/learning_demo`` (or the directory given after the
flag), with no contract lines.

Each configuration's serving and training run, phase 3b's coalesced
requests, phases 4b, 4c, 6, each part of 7, 8, 9, 10 (each rank's own
counts, summed), 11, 12 and 13, and the decoder's path
(``fused_decoder_apply`` on both decoders of the first two configurations'
observed features at B=8 T=30, forward and a ``gaussian_nll`` backward), is
driven with every launch count set to 0 just before it and read just after.
Then one JSON line with the sixteen kernels, the card's name and power
limit, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np

TOL = 1e-4
# Phase 6: a word is n_intervals × n_predictions = 60 rollout rows of n_frames = 10.
EVAL_ARGS = {"n_intervals": 6, "query_length": 30, "n_predictions": 10, "n_frames": 10}
EVAL_SHAPE = (EVAL_ARGS["n_intervals"] * EVAL_ARGS["n_predictions"], EVAL_ARGS["n_frames"])
TIE_EPS = 1e-5
BWD_TOL = 2e-4  # × max(1, max|plain|), per gradient tensor
ENC_TOL = 1e-4  # × max(1, max|plain|): encoder embeddings, f32 sums over ≤ 1024 taps
STEP_RTOL, STEP_TOL = 2e-5, 3e-4  # train step: losses; gradients × scale
SEED = 0


def card_line() -> str:
    """``name, power limit`` of GPU 0 as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def _median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median device time of ``fn()`` over ``reps`` calls (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _http(port: int, path: str, payload: dict | None = None, npz: bool = False):
    """GET (payload None) or POST a request; returns the decoded response."""
    url = f"http://127.0.0.1:{port}{path}"
    if payload is None:
        req = urllib.request.Request(url)
    elif npz:
        buf = io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in payload.items()})
        req = urllib.request.Request(url, data=buf.getvalue(),
                                     headers={"Content-Type": "application/x-npz"})
    else:
        req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        body = resp.read()
        if "npz" in resp.headers.get("Content-Type", ""):
            with np.load(io.BytesIO(body), allow_pickle=False) as z:
                return {k: z[k] for k in z.files}
        return json.loads(body)


def _frames(resp: dict, key: str) -> dict[str, np.ndarray]:
    """The frames of a JSON (nested dict) or npz (flattened) response."""
    if key in resp:
        return {k: np.asarray(v, np.float32) for k, v in resp[key].items()}
    return {k[len(key) + 1:]: v for k, v in resp.items() if k.startswith(key + "/")}


def _recurrence_inputs(rng, B: int, T: int, cfg, dev):
    """Random observe-recurrence inputs (numpy-seeded), on ``dev``."""
    import torch

    S = cfg.stoch_size
    stoch0 = np.zeros((B, cfg.class_size, cfg.category_size), np.float32)
    stoch0[np.arange(B)[:, None], np.arange(cfg.class_size),
           rng.integers(0, cfg.category_size, (B, cfg.class_size))] = 1.0
    arrays = (
        rng.uniform(-1, 1, (T, B, cfg.action_size)),
        rng.standard_normal((T, B, cfg.obs_embed_size)),
        rng.standard_normal((T, B, cfg.obs_embed_size)),
        np.tanh(rng.standard_normal((B, cfg.deterministic_size))),
        stoch0.reshape(B, S),
        rng.gumbel(size=(T, B, S)),
        rng.gumbel(size=(T, B, S)),
    )
    return [torch.tensor(np.asarray(a, np.float32), device=dev) for a in arrays]


def check_kernels(model, cfg, dev) -> dict[str, dict]:
    """Phase 2: every kernel against its plain version at the path's shapes."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence, rollout
    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import (
        ParityError,
        check_recurrence,
        check_rollout,
    )

    C, K = cfg.class_size, cfg.category_size
    rng = np.random.default_rng(SEED)
    results: dict[str, dict] = {"recurrence_fwd": {"max_abs_err": 0.0},
                                "rollout": {"max_abs_err": 0.0}}
    rw = model.representation_weights()
    for B, T in ((8, 30), (128, 30), (3, 7)):
        args = _recurrence_inputs(rng, B, T, cfg, dev)
        got = recurrence.recurrence_forward_cuda(rw, *args, C, K)
        ref = recurrence.recurrence_forward_plain(rw, *args, C, K)
        r = check_recurrence(got, ref, args[5], args[6], C, K, TOL, TIE_EPS)
        print(f"check recurrence_fwd B={B} T={T}: max_abs_err={r['max_abs_err']:.3g} "
              f"steps_compared={r['compared']:.4f}")
        results["recurrence_fwd"]["max_abs_err"] = max(
            results["recurrence_fwd"]["max_abs_err"], r["max_abs_err"])
    tw = model.transition.weights()
    for B, T in ((10, 10), EVAL_SHAPE, (64, 30), (256, 180)):
        actions = torch.tensor(rng.uniform(-1, 1, (B, T, cfg.action_size)).astype(np.float32),
                               device=dev)
        deter0, stoch0 = _recurrence_inputs(rng, B, 1, cfg, dev)[3:5]
        seed = 1234 + B
        got = rollout.rollout_cuda(tw, actions, deter0, stoch0, seed, C, K)
        again = rollout.rollout_cuda(tw, actions, deter0, stoch0, seed, C, K)
        r = check_rollout(tw, actions, deter0, stoch0, seed, got, C, K, TOL, TIE_EPS)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise ParityError(f"rollout B={B} T={T}: two launches differ")
        print(f"check rollout B={B} T={T}: max_abs_err={r['max_abs_err']:.3g} "
              f"blocks_compared={r['compared']:.4f}, reproducible")
        results["rollout"]["max_abs_err"] = max(results["rollout"]["max_abs_err"],
                                                r["max_abs_err"])
    # Sampling frequencies: with the prior head's output weight zeroed, the
    # logits are its bias, so every draw follows one known softmax.
    probs = np.tile(np.array([0.1, 0.2, 0.3, 0.4], np.float32), C * K // 4)[:C * K]
    bias = torch.tensor(np.log(probs), device=dev)
    freq_w = (*tw[:10], torch.zeros_like(tw[10]), bias)
    B, T = 256, 180
    actions = torch.tensor(rng.uniform(-1, 1, (B, T, cfg.action_size)).astype(np.float32),
                           device=dev)
    deter0, stoch0 = _recurrence_inputs(rng, B, 1, cfg, dev)[3:5]
    _, _, stochs = rollout.rollout_cuda(freq_w, actions, deter0, stoch0, 99, C, K)
    blocks = stochs.reshape(B * T, C, K)
    freq = blocks.mean(0).cpu().numpy()
    p = (probs.reshape(C, K) / probs.reshape(C, K).sum(-1, keepdims=True))
    sigma = np.sqrt(p * (1 - p) / (B * T))
    z = float(np.abs(freq - p).max() / sigma.min())
    if not (np.abs(freq - p) <= 5 * sigma).all() or not torch.all(blocks.sum(-1) == 1):
        raise ParityError(f"rollout sampling frequencies {freq} vs softmax {p}")
    print(f"check rollout sampling: {B * T} draws per block, max |freq - p| = {z:.2f} sigma")
    return results


def _backward_args(weights, args, outs, cots, cfg):
    """The backward kernel's inputs for a forward record: carries into each step."""
    import torch

    prev_deter = torch.cat([args[3][None], outs[0][:-1]])
    prev_stoch = torch.cat([args[4][None], outs[4][:-1]])
    return (weights, *args[:3], prev_deter, prev_stoch, cots, cfg.class_size, cfg.category_size)


def check_backward(model, cfg, dev) -> dict:
    """Phase 2, backward: the BPTT kernel against its plain version on one
    forward record per shape and random cotangents on all five outputs."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence
    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import ParityError, check_gradients

    C, K = cfg.class_size, cfg.category_size
    rng = np.random.default_rng(SEED + 3)
    rw = model.representation_weights()
    worst = 0.0
    for B, T in ((8, 30), (128, 30), (3, 7)):
        args = _recurrence_inputs(rng, B, T, cfg, dev)
        outs = recurrence.recurrence_forward_cuda(rw, *args, C, K)
        cots = [torch.tensor(rng.standard_normal(tuple(o.shape)).astype(np.float32), device=dev)
                for o in outs]
        bwd = _backward_args(rw, args, outs, cots, cfg)
        got = recurrence.recurrence_backward_cuda(*bwd)
        again = recurrence.recurrence_backward_cuda(*bwd)
        ref = recurrence.recurrence_backward_plain(*bwd)
        scaled = check_gradients(got, ref, BWD_TOL)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise ParityError("recurrence_bwd: two launches on the same inputs differ")
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        print(f"check recurrence_bwd B={B} T={T}: max_abs_err={err:.3g} "
              f"max_err/scale={scaled:.3g} (limit {BWD_TOL}), reproducible")
        worst = max(worst, err)
    return {"max_abs_err": worst}


def _mt_inputs(rng, B: int, T: int, cfg, dev):
    """Random hierarchical-recurrence inputs (numpy-seeded), on ``dev``:
    ``(actions, a_emb, v_emb)`` ``[T, B, ·]``, ``init6`` and the four
    sites' Gumbel noise."""
    import torch

    def onehot(c, k):
        x = np.zeros((B, c, k), np.float32)
        x[np.arange(B)[:, None], np.arange(c), rng.integers(0, k, (B, c))] = 1.0
        return x.reshape(B, c * k)

    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)  # noqa: E731
    xs = [t(rng.uniform(-1, 1, (T, B, cfg.action_size))),
          t(rng.standard_normal((T, B, cfg.obs_embed_size))),
          t(rng.standard_normal((T, B, cfg.obs_embed_size)))]
    hd = np.tanh(rng.standard_normal((B, cfg.hd_dim)))
    ld = np.tanh(rng.standard_normal((B, cfg.ld_dim)))
    init6 = [t(hd), t(ld), t(onehot(cfg.hs_class, cfg.hs_category)),
             t(onehot(cfg.ls_class, cfg.ls_category)), t(np.arctanh(0.9 * hd)),
             t(np.arctanh(0.9 * ld))]
    gumbels = [t(rng.gumbel(size=(T, B, d)))
               for d in (cfg.ls_dim, cfg.ls_dim, cfg.hs_dim, cfg.hs_dim)]
    return xs, init6, gumbels


MT_SHAPES = ((8, 30), (32, 30), (128, 30), (3, 7))
# Widths of the MT forward's cases beyond the model's: A, E, HD, LD, C, R and
# the latents' (tau_l, tau_h, class, category, class, category): HD ≠ LD and
# no multiple of 4 floats, and a lower latent wider than a warp (LS = 40).
MT_WIDTHS = {"odd": (5, 63, 17, 33, 19, 13, (2.0, 3.0, 3, 5, 2, 7)),
             "ls40": (6, 64, 32, 32, 32, 32, (2.0, 4.0, 5, 8, 3, 12))}
MT_WIDTH_SHAPES = ((8, 30), (128, 30), (3, 7))


def _mt_width_case(rng, widths, B: int, T: int, dev):
    """Fresh random weights at ``widths`` (the odd-numbered ones one float
    off 16-byte alignment) and :func:`_mt_inputs` at those widths, made by
    numpy: ``(weights, xs, init6, gumbels, spec)``."""
    import types

    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence_mt

    A, E, HD, LD, C, R, sp = widths
    spec = recurrence_mt.MTSpec(*sp)
    w = []
    for i, s in enumerate(recurrence_mt.mt_weight_shapes(A, E, HD, LD, C, R, spec)):
        x = rng.uniform(-1, 1, s) / np.sqrt(s[-1] if len(s) == 2 else C)
        flat = torch.zeros(int(np.prod(s)) + i % 2, device=dev)
        flat[i % 2:] = torch.tensor(x.reshape(-1), dtype=torch.float32, device=dev)
        w.append(flat[i % 2:].view(s))
    cfg = types.SimpleNamespace(action_size=A, obs_embed_size=E, hd_dim=HD, ld_dim=LD,
                                ls_class=spec.ls_class, ls_category=spec.ls_category,
                                hs_class=spec.hs_class, hs_category=spec.hs_category,
                                ls_dim=spec.ls, hs_dim=spec.hs)
    return (w, *_mt_inputs(rng, B, T, cfg, dev), spec)


def check_mt_kernels(model, cfg, dev) -> dict[str, dict]:
    """Phase 2, MMTRSSM: the hierarchical recurrence and rollout kernels
    against their plain versions at the path's shapes (the forward also on
    fresh weights at the odd and LS > 32 widths of ``MT_WIDTHS``, two
    launches bit-identical), and the rollout's sampling frequencies at both
    sites."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence_mt, rollout_mt
    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import (
        ParityError,
        check_mt_recurrence,
        check_mt_rollout,
    )

    spec = cfg.spec
    rng = np.random.default_rng(SEED + 5)
    results: dict[str, dict] = {"mt_recurrence_fwd": {"max_abs_err": 0.0},
                                "mt_rollout": {"max_abs_err": 0.0}}
    rw = model.recurrence_weights()
    cases = [("model", B, T, rw, *_mt_inputs(rng, B, T, cfg, dev), spec) for B, T in MT_SHAPES]
    cases += [(name, B, T, *_mt_width_case(rng, widths, B, T, dev))
              for name, widths in MT_WIDTHS.items() for B, T in MT_WIDTH_SHAPES]
    for name, B, T, w, xs, init6, gumbels, sp in cases:
        got = recurrence_mt.mt_recurrence_forward_cuda(w, *xs, init6, gumbels, sp)
        again = recurrence_mt.mt_recurrence_forward_cuda(w, *xs, init6, gumbels, sp)
        ref = recurrence_mt.mt_recurrence_forward_plain(w, *xs, init6, gumbels, sp)
        r = check_mt_recurrence(got, ref, gumbels, sp, TOL, TIE_EPS)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise ParityError(f"mt_recurrence_fwd {name} B={B} T={T}: two launches differ")
        print(f"check mt_recurrence_fwd {name} widths B={B} T={T}: "
              f"max_abs_err={r['max_abs_err']:.3g} steps_compared={r['compared']:.4f}, "
              "reproducible")
        results["mt_recurrence_fwd"]["max_abs_err"] = max(
            results["mt_recurrence_fwd"]["max_abs_err"], r["max_abs_err"])
    tw = model.rollout_weights()
    for B, T in ((10, 10), EVAL_SHAPE, (64, 30), (256, 180)):
        xs, init6, _ = _mt_inputs(rng, B, T, cfg, dev)
        actions = xs[0].transpose(0, 1).contiguous()
        seed = 4321 + B
        got = rollout_mt.rollout_mt_cuda(tw, actions, init6, seed, spec)
        again = rollout_mt.rollout_mt_cuda(tw, actions, init6, seed, spec)
        r = check_mt_rollout(tw, actions, init6, seed, got, spec, TOL, TIE_EPS)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise ParityError(f"mt_rollout B={B} T={T}: two launches differ")
        print(f"check mt_rollout B={B} T={T}: max_abs_err={r['max_abs_err']:.3g} "
              f"blocks_compared={r['compared']:.4f}, reproducible")
        results["mt_rollout"]["max_abs_err"] = max(results["mt_rollout"]["max_abs_err"],
                                                   r["max_abs_err"])
    # Sampling frequencies at both sites: with both priors' output weights
    # zeroed, the logits are their biases, so every draw follows one known
    # softmax (4-category lower blocks, 8-category higher blocks).
    probs_l = np.tile(np.array([0.1, 0.2, 0.3, 0.4], np.float32), cfg.ls_dim // 4)
    probs_h = np.tile(np.array([0.05, 0.05, 0.1, 0.1, 0.15, 0.15, 0.2, 0.2], np.float32),
                      cfg.hs_dim // 8)
    freq_w = list(tw)
    freq_w[10], freq_w[11] = torch.zeros_like(tw[10]), torch.tensor(np.log(probs_l), device=dev)
    freq_w[14], freq_w[15] = torch.zeros_like(tw[14]), torch.tensor(np.log(probs_h), device=dev)
    B, T = 256, 180
    xs, init6, _ = _mt_inputs(rng, B, T, cfg, dev)
    out = rollout_mt.rollout_mt_cuda(freq_w, xs[0].transpose(0, 1).contiguous(), init6, 99, spec)
    for name, stochs, probs, c, k in (("lower", out[5], probs_l, cfg.ls_class, cfg.ls_category),
                                      ("higher", out[4], probs_h, cfg.hs_class, cfg.hs_category)):
        blocks = stochs.reshape(B * T, c, k)
        freq = blocks.mean(0).cpu().numpy()
        p = probs.reshape(c, k) / probs.reshape(c, k).sum(-1, keepdims=True)
        sigma = np.sqrt(p * (1 - p) / (B * T))
        if not (np.abs(freq - p) <= 5 * sigma).all() or not torch.all(blocks.sum(-1) == 1):
            raise ParityError(f"mt_rollout {name} sampling frequencies {freq} vs softmax {p}")
        print(f"check mt_rollout sampling, {name} {c}x{k}: {B * T} draws per block, "
              f"max |freq - p| = {float((np.abs(freq - p) / sigma).max()):.2f} sigma")
    return results


def check_mt_backward(model, cfg, dev) -> dict:
    """Phase 2, MMTRSSM backward: the BPTT kernel against its plain version
    on one forward record per shape and random cotangents on all 12 outputs."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence_mt
    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import ParityError, check_gradients

    rng = np.random.default_rng(SEED + 6)
    rw = model.recurrence_weights()
    worst = 0.0
    for B, T in MT_SHAPES:
        xs, init6, gumbels = _mt_inputs(rng, B, T, cfg, dev)
        outs = recurrence_mt.mt_recurrence_forward_cuda(rw, *xs, init6, gumbels, cfg.spec)
        cots = [torch.tensor(rng.standard_normal(tuple(o.shape)).astype(np.float32), device=dev)
                for o in outs]
        prev6 = recurrence_mt.shift_carries(init6, recurrence_mt.carries(outs))
        args = (rw, *xs, prev6, cots, cfg.spec)
        got = recurrence_mt.mt_recurrence_backward_cuda(*args)
        again = recurrence_mt.mt_recurrence_backward_cuda(*args)
        ref = recurrence_mt.mt_recurrence_backward_plain(*args)
        scaled = check_gradients(got, ref, BWD_TOL)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise ParityError("mt_recurrence_bwd: two launches on the same inputs differ")
        err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
        print(f"check mt_recurrence_bwd B={B} T={T}: max_abs_err={err:.3g} "
              f"max_err/scale={scaled:.3g} (limit {BWD_TOL}), reproducible")
        worst = max(worst, err)
    return {"max_abs_err": worst}


def _observe_vs_cpu(model, cfg, wm, obs: dict, recon: dict) -> None:
    """The card's observe posterior and frames against the CPU path's, on
    the same weights and seed (7), outside Gumbel near-ties."""
    import torch

    from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig
    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import check_mt_recurrence, check_recurrence
    from multimodal_mtrssm_tpu_torch.serving import WorldModel

    cpu_model = type(model)(cfg)
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    wm_cpu = WorldModel(cpu_model, "cpu")
    B, T = obs["actions"].shape[:2]
    post_g, prior_g = wm.observe(obs["actions"], obs["audio"], obs["vision"], seed=7)
    post_c, prior_c = wm_cpu.observe(obs["actions"], obs["audio"], obs["vision"], seed=7)
    noise = cpu_model.draw_noise(B, T, torch.Generator().manual_seed(7))
    if isinstance(cfg, MMTRSSMConfig):
        tm = lambda st: [x.transpose(0, 1).cpu() for x in (  # noqa: E731
            st[0].deter_h, st[0].deter_l, st[0].hidden_h, st[0].hidden_l, st[1].logits_l,
            st[1].stoch_l, st[0].logits_l, st[0].stoch_l, st[1].logits_h, st[1].stoch_h,
            st[0].logits_h, st[0].stoch_h)]
        r = check_mt_recurrence(tm((post_g, prior_g)), tm((post_c, prior_c)),
                                [noise[k] for k in ("g_lprior", "g_lpost", "g_hprior", "g_hpost")],
                                cfg.spec, TOL, TIE_EPS)
    else:
        tm = lambda st: [x.transpose(0, 1).cpu() for x in  # noqa: E731
                         (st[0].deter, st[1].logits, st[1].stoch, st[0].logits, st[0].stoch)]
        r = check_recurrence(tm((post_g, prior_g)), tm((post_c, prior_c)), noise["g_prior"],
                             noise["g_post"], cfg.class_size, cfg.category_size, TOL, TIE_EPS)
    # Frames are compared where the posterior state was held equal.
    agree = r["agree"].transpose(0, 1).numpy()  # [B, T]
    frames_c = wm_cpu.decode(post_c)
    ferr = max(float(np.abs(recon[k] - frames_c[k].numpy())[agree].max()) for k in frames_c)
    if not ferr <= TOL:
        raise RuntimeError(f"observe frames differ from the CPU path by {ferr:.3g}")
    print(f"observe card vs CPU: posterior max_abs_err={r['max_abs_err']:.3g}, "
          f"frames max_abs_err={ferr:.3g}, steps_compared={float(agree.mean()):.4f}")


def drive_server(model, cfg, dev, need: dict[str, int]) -> dict:
    """Phase 3: a configuration's serving path through the HTTP server;
    ``need`` holds the least launches of each of its kernels that
    ``/observe`` and two ``/imagine`` must show."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from multimodal_mtrssm_tpu_torch.server import InferenceServer
    from multimodal_mtrssm_tpu_torch.serving import WorldModel

    rng = np.random.default_rng(SEED + 1)
    B, T = 8, 30
    obs = {
        "actions": rng.uniform(-1, 1, (B, T, cfg.action_size)).astype(np.float32),
        "audio": rng.uniform(-1, 1, (B, T, 32, 32, 1)).astype(np.float32),
        "vision": rng.uniform(-1, 1, (B, T, 32, 32, 1)).astype(np.float32),
    }
    plan = rng.uniform(-1, 1, (B, T, cfg.action_size)).astype(np.float32)
    wm = WorldModel(model, dev)
    server = InferenceServer(wm, host="127.0.0.1", port=0)
    server.start()
    try:
        reset_launch_counts()
        health = _http(server.port, "/healthz")
        observed = _http(server.port, "/observe", {
            "actions": obs["actions"].tolist(), "audio": obs["audio"].tolist(),
            "vision": obs["vision"].tolist(), "seed": 7, "decode": True})
        im1 = _http(server.port, "/imagine", {"state_id": observed["state_id"], "actions": plan,
                                              "seed": 11, "decode": True}, npz=True)
        im2 = _http(server.port, "/imagine", {"state_id": str(im1["state_id"]),
                                              "actions": plan.tolist(), "seed": 12,
                                              "decode": True})
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"healthz: {health}")
        print(f"main-path kernel launches, {_label(cfg)} serving: {counts}")
        if health.get("platform") != "gpu" or health.get("model") != type(model).__name__:
            raise RuntimeError(f"/healthz reports {health}")
        if any(counts[k] < n for k, n in need.items()):
            raise RuntimeError(f"the serving path missed a kernel: {counts}, needs {need}")
        recon = _frames(observed, "recon")
        for name, frames in (("observe", recon), ("imagine 1", _frames(im1, "frames")),
                             ("imagine 2", _frames(im2, "frames"))):
            for k, v in frames.items():
                if v.shape != (B, T, 32, 32, 1) or not np.isfinite(v).all():
                    raise RuntimeError(f"{name} {k}: shape {v.shape}, finite {np.isfinite(v).all()}")
        print(f"served: recon {recon['recon/audio'].shape}, two chained imagines, all finite")
        _observe_vs_cpu(model, cfg, wm, obs, recon)
        return {"counts": counts, "server": server, "obs": obs, "plan": plan,
                "state_id": observed["state_id"]}
    except BaseException:
        server.stop()
        raise


def kernel_timings(model, cfg, dev, card: str) -> dict[str, tuple[float, float]]:
    """Phase 5, MRSSM: the forward and rollout kernels against their plain
    versions; returns the main-path shapes' times."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence, rollout

    C, K = cfg.class_size, cfg.category_size
    rng = np.random.default_rng(SEED + 2)
    rw, tw = model.representation_weights(), model.transition.weights()
    main: dict[str, tuple[float, float]] = {}
    for B, T in ((8, 30), (128, 30)):
        args = _recurrence_inputs(rng, B, T, cfg, dev)
        k_ms = _median_ms(lambda: recurrence.recurrence_forward_cuda(rw, *args, C, K), 30)
        p_ms = _median_ms(lambda: recurrence.recurrence_forward_plain(rw, *args, C, K), 5)
        print(f"time recurrence_fwd B={B} T={T}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"| {card}")
        main.setdefault("recurrence_fwd", (k_ms, p_ms))
    for B, T in ((8, 30), (10, 10), (64, 30), (256, 180)):
        actions = torch.tensor(rng.uniform(-1, 1, (B, T, cfg.action_size)).astype(np.float32),
                               device=dev)
        deter0, stoch0 = _recurrence_inputs(rng, B, 1, cfg, dev)[3:5]
        k_ms = _median_ms(lambda: rollout.rollout_cuda(tw, actions, deter0, stoch0, 5, C, K), 30)
        p_ms = _median_ms(lambda: rollout.rollout_plain(tw, actions, deter0, stoch0, 5, C, K), 3)
        print(f"time rollout B={B} T={T}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms | {card}")
        main.setdefault("rollout", (k_ms, p_ms))
    return main


def mt_kernel_timings(model, cfg, dev, card: str) -> dict[str, tuple[float, float]]:
    """Phase 5, MMTRSSM: the hierarchical recurrence forward and rollout
    kernels against their plain versions (the backward: ``mt_bwd_timings``);
    returns the main-path shapes' (B=8 T=30) times."""
    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence_mt, rollout_mt

    spec = cfg.spec
    rng = np.random.default_rng(SEED + 7)
    rw = [w.detach() for w in model.recurrence_weights()]
    main: dict[str, tuple[float, float]] = {}
    for B, T in MT_SHAPES[:3]:
        xs, init6, gumbels = _mt_inputs(rng, B, T, cfg, dev)
        k_ms = _median_ms(lambda: recurrence_mt.mt_recurrence_forward_cuda(
            rw, *xs, init6, gumbels, spec), 30)
        p_ms = _median_ms(lambda: recurrence_mt.mt_recurrence_forward_plain(
            rw, *xs, init6, gumbels, spec), 3, warmup=1)
        print(f"time mt_recurrence_fwd B={B} T={T}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"| {card}")
        main.setdefault("mt_recurrence_fwd", (k_ms, p_ms))
    tw = rw[:16]
    for B, T in ((8, 30), (10, 10), (64, 30), (256, 180)):
        xs, init6, _ = _mt_inputs(rng, B, T, cfg, dev)
        actions = xs[0].transpose(0, 1).contiguous()
        k_ms = _median_ms(lambda: rollout_mt.rollout_mt_cuda(tw, actions, init6, 5, spec), 30)
        p_ms = _median_ms(lambda: rollout_mt.rollout_mt_plain(tw, actions, init6, 5, spec), 3,
                          warmup=1)
        print(f"time mt_rollout B={B} T={T}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms | {card}")
        main.setdefault("mt_rollout", (k_ms, p_ms))
    return main


def server_latencies(ctx: dict, card: str, label: str) -> None:
    """Phase 5: median ``/observe`` and ``/imagine`` latency through the server."""
    port, obs = ctx["server"].port, ctx["obs"]
    obs_req = {**obs, "seed": 3, "decode": True}
    im_req = {"state_id": ctx["state_id"], "actions": ctx["plan"], "seed": 4, "decode": True}
    for route, req in (("/observe", obs_req), ("/imagine", im_req)):
        lat = []
        for _ in range(10):
            t0 = time.perf_counter()
            _http(port, route, req, npz=True)
            lat.append((time.perf_counter() - t0) * 1e3)
        print(f"time server {label} {route} B=8 T=30 decode npz: median {np.median(lat[2:]):.3f} "
              f"ms over {len(lat) - 2} requests | {card}")


# Coalesced requests of the per-row-key checks (B, T, seed), run as the
# server runs them: at their total rows and longest steps.
COALESCE_KEYS = ((1, 5, 3), (2, 30, 4), (3, 10, 2**63 + 5), (8, 30, 6))
COALESCE_ROWS = sum(b for b, _, _ in COALESCE_KEYS)
COALESCE_STEPS = max(t for _, t, _ in COALESCE_KEYS)


def check_per_row_keys(model, cfg, dev) -> dict:
    """Phase 2, the family's rollout kernel on per-row keys: the rows of
    ``COALESCE_KEYS`` (each request's seed and its index inside it) at
    their total rows and longest steps. The prologue alone (on a NaN
    workspace) writes the plain per-row draw bit for bit; the launch passes
    the replay against that draw (atol 1e-4, stochs the argmax of its logits
    plus the draw outside near-ties) and twice gives the same bits; and each
    request's rows and steps equal the request's own launch (stochs equal
    before each row's first near-tie of 1e-5, the rest within 1e-4 up to
    it)."""
    import torch

    from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig
    from multimodal_mtrssm_tpu_torch.ops.kernels import rollout, rollout_mt
    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import (
        ParityError,
        check_mt_rollout,
        check_rollout,
        check_same_trajectories,
        first_near_tie,
    )

    mt = isinstance(cfg, MMTRSSMConfig)
    name = "mt_rollout" if mt else "rollout"
    B, T = COALESCE_ROWS, COALESCE_STEPS
    rng = np.random.default_rng(SEED + 31)
    keys = [rollout.row_keys(s, b) for b, _, s in COALESCE_KEYS]
    keys = tuple(torch.cat(k).to(dev) for k in zip(*keys))
    if mt:
        w, spec = model.rollout_weights(), cfg.spec
        xs, init, _ = _mt_inputs(rng, B, T, cfg, dev)
        actions = xs[0].transpose(0, 1).contiguous()
        launch = lambda a, i, seed, **kw: rollout_mt.rollout_mt_launch(  # noqa: E731
            w, a, i, seed, spec, **kw)
        ls, hs = (spec.ls_class, spec.ls_category), (spec.hs_class, spec.hs_category)

        def sites(out, seed):
            g_l, g_h = rollout_mt.philox_mt_gumbel(seed, out[0].shape[1], out[0].shape[0], ls,
                                                   hs, dev)
            return [(out[3] + g_l.transpose(0, 1), *ls), (out[2] + g_h.transpose(0, 1), *hs)]

        draw = lambda k: torch.cat(rollout_mt.philox_mt_gumbel(k, T, B, ls, hs, dev), -1)  # noqa: E731
        replay = lambda out: check_mt_rollout(w, actions, init, keys, out, spec,  # noqa: E731
                                              TOL, TIE_EPS)
        samples = (4, 5)
    else:
        w, C, K = model.transition.weights(), cfg.class_size, cfg.category_size
        actions = torch.tensor(rng.uniform(-1, 1, (B, T, cfg.action_size)).astype(np.float32),
                               device=dev)
        init = list(_recurrence_inputs(rng, B, 1, cfg, dev)[3:5])
        launch = lambda a, i, seed, **kw: rollout.rollout_launch(  # noqa: E731
            w, a, *i, seed, C, K, **kw)

        def sites(out, seed):
            g = rollout.philox_gumbel(seed, out[0].shape[1], out[0].shape[0], C, K, dev)
            return [(out[1] + g.transpose(0, 1), C, K)]

        draw = lambda k: rollout.philox_gumbel(k, T, B, C, K, dev)  # noqa: E731
        replay = lambda out: check_rollout(w, actions, *init, keys, out, C, K,  # noqa: E731
                                           TOL, TIE_EPS)
        samples = (2,)
    whole, ws = launch(actions, init, keys)
    again, _ = launch(actions, init, keys)
    nan = torch.full_like(ws, float("nan"))
    launch(actions, init, keys, stages=1, workspace=nan)
    noise = draw(keys)
    if not torch.equal(nan[..., ws.shape[-1] - noise.shape[-1]:], noise):
        raise ParityError(f"{name}: the prologue's per-row noise differs from the plain draw")
    if not all(torch.equal(a, b) for a, b in zip(whole, again)):
        raise ParityError(f"{name}: two launches on per-row keys differ")
    err = replay(whole)["max_abs_err"]
    off, worst, same = 0, 0.0, True
    for b, t, seed in COALESCE_KEYS:
        rows = slice(off, off + b)
        alone, _ = launch(actions[rows, :t].contiguous(), [x[rows].contiguous() for x in init],
                          seed)
        r = check_same_trajectories([x[rows, :t] for x in whole], alone, samples,
                                    first_near_tie(sites(alone, seed), TIE_EPS), TOL,
                                    f"{name} coalesced B={b} T={t}")
        worst, same = max(worst, r["max_abs_err"]), same and r["bit_identical"]
        off += b
    print(f"check {name} per-row keys B={B} T={T}: prologue noise equal to the plain per-row "
          f"draw bit for bit, replay max_abs_err={err:.3g}, two launches alike; each of "
          f"{len(COALESCE_KEYS)} requests' rows against its own launch max_abs_err={worst:.3g}, "
          f"bit-identical: {'yes' if same else 'no'}")
    return {"max_abs_err": max(err, worst)}


# Phase 3b: a window of 8 concurrent requests, each (B, observe T, imagine T)
# with its own seed.
COALESCE_MIX = ((1, 5, 10), (2, 10, 30), (3, 30, 5), (8, 30, 10), (1, 30, 5), (2, 5, 30),
                (3, 10, 30), (8, 10, 5))
COALESCE_WINDOW_MS = 5.0


def _concurrently(fn, args: list) -> list:
    """``fn(*a)`` for each ``a`` in ``args``, each on a thread of its own,
    all started together; the results in order (the first failure raises)."""
    out: list = [None] * len(args)
    errors: list = []

    def run(i):
        try:
            out[i] = fn(*args[i])
        except BaseException as e:  # noqa: BLE001 — raised below on the calling thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(args))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    if errors:
        raise errors[0]
    return out


def _sampled_sites(cfg, seq, noise) -> list:
    """The sampled sites that feed a ``[B, T]`` trajectory's carry: each
    site's logits plus its ``[T, B, ·]`` noise, with its blocks."""
    from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig

    if isinstance(cfg, MMTRSSMConfig):
        pairs = ((seq.logits_l, noise[0], cfg.ls_class, cfg.ls_category),
                 (seq.logits_h, noise[1], cfg.hs_class, cfg.hs_category))
    else:
        pairs = ((seq.logits, noise[0], cfg.class_size, cfg.category_size),)
    return [(lg + n.to(lg.device).transpose(0, 1), c, k) for lg, n, c, k in pairs]


def _compare_reply(name: str, frames: dict, state, seq, ref_frames: dict, first,
                   worst: dict) -> None:
    """A coalesced reply against the same request alone (``seq``, its
    ``[B, T]`` trajectory, and ``ref_frames``): frames at the steps before
    each row's first near-tie within ``TOL``; the last state, in rows with
    none, stochs equal and the rest within ``TOL``."""
    import torch

    T = next(iter(ref_frames.values())).shape[1]
    agree = (torch.arange(T)[None, :] < first.cpu()[:, None]).numpy()
    for k, v in ref_frames.items():
        ref = v.cpu().numpy()
        d = np.abs(frames[k] - ref)[agree]
        err = float(d.max()) if d.size else 0.0
        if not err <= TOL:
            raise RuntimeError(f"{name} {k}: coalesced frames differ from alone by {err:.3g}")
        worst["frames"] = max(worst["frames"], err)
        worst["bit_identical"] &= bool(np.array_equal(frames[k], ref))
    whole = first == T
    last = seq[:, -1]
    for f in dataclasses.fields(last):
        a, b = getattr(state, f.name), getattr(last, f.name)
        if f.name.startswith("stoch") and not torch.equal(a[whole] > 0.5, b[whole] > 0.5):
            raise RuntimeError(f"{name}: the coalesced last {f.name} differs from alone")
        err = float((a[whole] - b[whole]).abs().max()) if bool(whole.any()) else 0.0
        if not err <= TOL:
            raise RuntimeError(f"{name}: the coalesced last {f.name} differs by {err:.3g}")
        worst["latents"] = max(worst["latents"], err)
        worst["bit_identical"] &= torch.equal(a, b)
    worst["compared"].append(float(agree.mean()))


def drive_coalesced(cfg, dev, checkpoints: Path) -> dict:
    """Phase 3b: a trained run served. ``WorldModel.from_checkpoint`` reads
    the model config and the fit phase's checkpoints directory; a server
    with a 5 ms window and ``batch_max`` 8 (``serve --batch-window-ms 5``)
    takes 8 concurrent ``/observe`` (``COALESCE_MIX``: B ∈ {1, 2, 3, 8}, T
    ∈ {5, 10, 30}, decode, npz, each its own seed), then 8 concurrent ``/imagine``
    from their states. Fails unless fewer rollout launches than requests
    served them, no well-formed batch was re-run alone, and every reply
    equals the same request alone (window 0's route: ``WorldModel.observe``
    / ``imagine``, then ``decode``): frames and latents within 1e-4, stochs
    equal, outside each row's first Gumbel near-tie of 1e-5."""
    import torch

    from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig
    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import first_near_tie
    from multimodal_mtrssm_tpu_torch.ops.kernels.rollout import philox_gumbel
    from multimodal_mtrssm_tpu_torch.ops.kernels.rollout_mt import philox_mt_gumbel
    from multimodal_mtrssm_tpu_torch.server import InferenceServer
    from multimodal_mtrssm_tpu_torch.serving import WorldModel

    wm = WorldModel.from_checkpoint(cfg, checkpoints, device=dev)
    mt = isinstance(cfg, MMTRSSMConfig)
    rollout_name = "mt_rollout" if mt else "rollout"
    rng = np.random.default_rng(SEED + 30)
    A, n = cfg.action_size, len(COALESCE_MIX)
    obs = [{"actions": rng.uniform(-1, 1, (b, t, A)).astype(np.float32),
            "audio": rng.uniform(-1, 1, (b, t, 32, 32, 1)).astype(np.float32),
            "vision": rng.uniform(-1, 1, (b, t, 32, 32, 1)).astype(np.float32),
            "seed": 100 + i, "decode": True} for i, (b, t, _) in enumerate(COALESCE_MIX)]
    plans = [rng.uniform(-1, 1, (b, t2, A)).astype(np.float32) for b, _, t2 in COALESCE_MIX]
    server = InferenceServer(wm, host="127.0.0.1", port=0, batch_window_ms=COALESCE_WINDOW_MS,
                             batch_max=8)
    server.start()
    try:
        reset_launch_counts()
        observed = _concurrently(lambda r: _http(server.port, "/observe", r, npz=True),
                                 [(r,) for r in obs])
        imagined = _concurrently(lambda r: _http(server.port, "/imagine", r, npz=True), [
            ({"state_id": str(o["state_id"]), "actions": p, "seed": 200 + i, "decode": True},)
            for i, (o, p) in enumerate(zip(observed, plans))])
        torch.cuda.synchronize()
        counts = launch_counts()
        sizes = (list(server.observe_batcher.batch_sizes), list(server.batcher.batch_sizes))
        print(f"main-path kernel launches, {_label(cfg)} coalesced serving from the fit's "
              f"checkpoints ({n} /observe in batches {sizes[0]}, {n} /imagine in batches "
              f"{sizes[1]}): {counts}")
        if server.retries:
            raise RuntimeError(f"{server.retries} requests of well-formed coalesced batches were "
                               "re-run alone")
        if not counts[rollout_name] < n:
            raise RuntimeError(f"{counts[rollout_name]} {rollout_name} launches served {n} "
                               "/imagine requests: nothing coalesced")
        worst = {route: {"frames": 0.0, "latents": 0.0, "compared": [], "bit_identical": True}
                 for route in ("/observe", "/imagine")}
        spec = ((cfg.ls_class, cfg.ls_category), (cfg.hs_class, cfg.hs_category)) if mt else None
        for i, ((b, t, t2), req, o, im) in enumerate(zip(COALESCE_MIX, obs, observed, imagined)):
            post, _ = wm.observe(req["actions"], req["audio"], req["vision"], req["seed"])
            noise = wm.model.draw_noise(b, t, torch.Generator().manual_seed(req["seed"]))
            sites = [noise["g_lpost"], noise["g_hpost"]] if mt else [noise["g_post"]]
            _compare_reply(f"observe {i} (B={b} T={t})", _frames(o, "recon"),
                           server.states.get(str(o["state_id"])), post, wm.decode(post),
                           first_near_tie(_sampled_sites(cfg, post, sites), TIE_EPS),
                           worst["/observe"])
            start = server.states.get(str(o["state_id"]))
            seq = wm.imagine(plans[i], start, 200 + i)
            g = (philox_mt_gumbel(200 + i, t2, b, *spec, dev) if mt
                 else (philox_gumbel(200 + i, t2, b, cfg.class_size, cfg.category_size, dev),))
            _compare_reply(f"imagine {i} (B={b} T={t2})", _frames(im, "frames"),
                           server.states.get(str(im["state_id"])), seq, wm.decode(seq),
                           first_near_tie(_sampled_sites(cfg, seq, g), TIE_EPS),
                           worst["/imagine"])
        for route, w in worst.items():
            print(f"coalesced vs alone, {_label(cfg)} {route}: {n} replies, frames max_abs_err="
                  f"{w['frames']:.3g}, latents max_abs_err={w['latents']:.3g} (limit {TOL}), "
                  f"steps compared {np.mean(w['compared']):.4f}; bit-identical to alone: "
                  f"{'yes' if w['bit_identical'] else 'no'}")
        print(f"coalesced {_label(cfg)}: {counts[rollout_name]} rollout launches for {n} "
              "/imagine, no retries")
        return {"counts": counts, "server": server, "wm": wm, "obs": obs, "plans": plans,
                "starts": [server.states.get(str(o["state_id"])) for o in observed]}
    except BaseException:
        server.stop()
        raise


def _wall_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median wall time of ``fn()`` in ms (each call returns with its
    result on the host)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def _fresh_thread_probe(dev, card: str) -> None:
    """What a fresh thread pays for its first device work: the wall time of
    one small op and a sync, each on a new thread (median of 10), for an
    elementwise op, a matmul (cuBLAS) and a conv (cuDNN), beside the same
    ops on the calling thread."""
    import torch

    x = torch.randn(64, 64, device=dev)
    img = torch.randn(8, 1, 32, 32, device=dev)
    w = torch.randn(8, 1, 3, 3, device=dev)
    ops = {"elementwise": lambda: x + 1, "matmul": lambda: x @ x,
           "conv2d": lambda: torch.nn.functional.conv2d(img, w, padding=1)}

    def synced(op):
        op()
        torch.cuda.synchronize(dev)

    def on_fresh_thread(op):
        th = threading.Thread(target=synced, args=(op,))
        th.start()
        th.join()

    print("time a fresh thread's first device work, wall ms, median of 10: " + ", ".join(
        f"{k} {_wall_ms(lambda op=op: synced(op)):.3f} on the calling thread, "
        f"{_wall_ms(lambda op=op: on_fresh_thread(op)):.3f} on a fresh thread"
        for k, op in ops.items()) + f" | {card}")


def coalesced_latencies(ctx: dict, cfg, card: str) -> None:
    """Phase 5 (measurements only, nothing claimed from them): p50 request
    latency of ``/observe`` and ``/imagine`` under 8 concurrent clients
    (``COALESCE_MIX``, decode, npz), coalesced (the 5 ms window) and not
    (window 0, the same model), over 3 rounds after a warm-up round; and
    the ``/observe`` split at B=8 T=30: the route's direct call on the
    calling thread, in a fresh thread each call, on a long-lived batcher
    thread, and through HTTP."""
    from multimodal_mtrssm_tpu_torch.server import InferenceServer, _ImagineBatcher, _Pending

    alone = InferenceServer(ctx["wm"], host="127.0.0.1", port=0)
    alone.start()
    try:
        def timed(port, route, req):
            t0 = time.perf_counter()
            _http(port, route, req, npz=True)
            return (time.perf_counter() - t0) * 1e3

        for label, srv in (("coalesced", ctx["server"]), ("uncoalesced", alone)):
            sids = [srv.states.put(s) for s in ctx["starts"]]
            for route in ("/observe", "/imagine"):
                reqs = ctx["obs"] if route == "/observe" else [
                    {"state_id": sid, "actions": p, "seed": 7, "decode": True}
                    for sid, p in zip(sids, ctx["plans"])]
                lat: list[float] = []
                for rnd in range(4):
                    got = _concurrently(lambda r, route=route, srv=srv: timed(srv.port, route, r),
                                        [(r,) for r in reqs])
                    lat += got if rnd else []
                print(f"time server {label} {_label(cfg)} {route}: 8 concurrent clients, B in "
                      f"{{1, 2, 3, 8}}, T in {{5, 10, 30}}, decode npz: p50 {np.median(lat):.3f} "
                      f"ms over {len(lat)} requests | {card}")
        req = next(r for r, (b, t, _) in zip(ctx["obs"], COALESCE_MIX) if (b, t) == (8, 30))

        def direct():
            alone._observe(dict(req), raw=True)

        def fresh_thread():
            th = threading.Thread(target=direct)
            th.start()
            th.join()

        def run_items(items):
            for it in items:
                direct()
                it.result = {}

        worker = _ImagineBatcher(run_items, 0.0, 1)
        try:
            split = {"direct call, calling thread": _wall_ms(direct),
                     "direct call, a fresh thread each call": _wall_ms(fresh_thread),
                     "direct call, a long-lived batcher thread":
                         _wall_ms(lambda: worker.submit(_Pending(0, False, True))),
                     "through HTTP": _wall_ms(lambda: _http(alone.port, "/observe", req,
                                                            npz=True))}
        finally:
            worker.stop()
        print(f"time /observe split {_label(cfg)} B=8 T=30 decode npz, median of 10: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in split.items()) + f" | {card}")
        _fresh_thread_probe(ctx["wm"].device, card)
    finally:
        alone.stop()


def _train_batch(rng, B: int, T: int, model):
    """A random batch (6-tuple, CPU) and its noise for ``shared_step``:
    Gumbel for the model's sample sites and standard normals for the inputs."""
    import torch

    act = rng.uniform(-1, 1, (B, T, model.cfg.action_size)).astype(np.float32)
    frames = [rng.uniform(-1, 1, (B, T, 32, 32, 1)).astype(np.float32) for _ in range(2)]
    noise = {k: torch.from_numpy(rng.gumbel(size=s).astype(np.float32))
             for k, s in model.noise_shapes(B, T).items()}
    noise["input"] = tuple(torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
                           for x in (act, *frames))
    return tuple(torch.from_numpy(x) for x in (act, *frames, act, *frames)), noise


def _noise_to(noise: dict, dev) -> dict:
    return {k: tuple(x.to(dev) for x in v) if isinstance(v, tuple) else v.to(dev)
            for k, v in noise.items()}


def drive_training(cfg, dev, per_step: dict[str, int], run_dir: Path) -> dict:
    """Phase 4: ``Trainer.fit`` of the family of ``cfg`` on synthetic
    episodes under ``run_dir``, then one train step on the card against the
    CPU path; ``per_step`` holds the least launches of each of its kernels a
    step. The run's checkpoints directory is returned under
    ``"checkpoints"``."""
    import torch

    from multimodal_mtrssm_tpu_torch.data import (
        DataModuleConfig,
        EpisodeDataModule,
        generate_synthetic_audio_mnist,
    )
    from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig, MoPoEMMTRSSM, MoPoEMRSSM
    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import (
        check_train_step,
        train_step_near_ties,
    )
    from multimodal_mtrssm_tpu_torch.train import Trainer, TrainerConfig, load_lightning_checkpoint

    family = MoPoEMMTRSSM if isinstance(cfg, MMTRSSMConfig) else MoPoEMRSSM
    t0 = time.perf_counter()
    generate_synthetic_audio_mnist(run_dir / "episodes", n_episodes=24, seed=SEED)
    # The reference YAML's input noise is the model's (input_noise_std
    # 0.1, on the device), so the pipeline adds none.
    dm = EpisodeDataModule(DataModuleConfig(data_dir=str(run_dir / "episodes"),
                                            batch_size=8, sequence_length=30, noise_std=0.0,
                                            seed=SEED))
    dm.setup()
    print(f"data: 24 episodes x 180 frames generated and loaded in "
          f"{time.perf_counter() - t0:.2f} s; {dm.n_train} train, {dm.n_val} val")
    model = family(cfg).to(dev)
    init = family(cfg).init(torch.Generator().manual_seed(SEED))  # fit's own init
    trainer = Trainer(model, dm, TrainerConfig(max_epochs=2, seed=SEED,
                                               log_dir=str(run_dir / "run")))
    reset_launch_counts()
    out = trainer.fit()
    torch.cuda.synchronize()
    counts = launch_counts()
    steps = out["global_step"]
    print(f"main-path kernel launches, {_label(cfg)} training, {steps} optimizer "
          f"steps: {counts}")
    for row in out["history"]:
        print("epoch " + " ".join(f"{k}={v:.6g}" for k, v in row.items()))
    if steps < 4 or len(out["history"]) != 2:
        raise RuntimeError(f"fit ran {steps} steps in {len(out['history'])} epochs")
    if not all(np.isfinite(v) for row in out["history"] for v in row.values()):
        raise RuntimeError("non-finite training metrics")
    if any(counts[k] < n * steps for k, n in per_step.items()):
        raise RuntimeError(f"the training path missed a kernel: {counts}, needs {per_step} "
                           "a step")
    still = [n for (n, p), q in zip(model.named_parameters(), init.parameters())
             if torch.equal(p.detach().cpu(), q.detach())]
    if still:
        raise RuntimeError(f"parameters did not move: {still}")
    best = load_lightning_checkpoint(family(cfg), run_dir / "run" / "checkpoints" / "best.ckpt")
    if not all(bool(torch.isfinite(p).all()) for p in best.parameters()):
        raise RuntimeError("the best checkpoint holds non-finite weights")
    print(f"fit: {steps} steps, best val/loss {out['best_val']:.6g}, every parameter moved, "
          "best checkpoint loads into a fresh model")

    cpu = family(cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    for seed in range(SEED + 10, SEED + 20):
        batch, noise = _train_batch(np.random.default_rng(seed), 8, 30, cpu)
        ties = train_step_near_ties(cpu, batch, noise, TIE_EPS)
        if ties == 0:
            break
        print(f"train step card vs CPU: seed {seed} has {ties} Gumbel near-tie blocks "
              f"(within {TIE_EPS}); taking the next seed")
    else:
        raise RuntimeError("no seed without near-ties for the train-step check")
    on_card = (tuple(x.to(dev) for x in batch), _noise_to(noise, dev))
    r = check_train_step(model, cpu, on_card, (batch, noise), STEP_RTOL, STEP_TOL)
    print(f"train step card vs CPU {_label(cfg)} B=8 T=30 (seed {seed}): " + ", ".join(
        f"{k} {v:.6g} (err/loss {r['loss_rel_errs'][k]:.3g})" for k, v in r["losses"].items())
        + f"; limit {STEP_RTOL}; grad max_abs_err {r['grad_max_abs_err']:.3g} "
        f"(limit {STEP_TOL} x {r['grad_scale']:.4g})")
    # The last epoch's rate: the first one also pays cuDNN's and the
    # allocator's first calls.
    last = out["history"][-1]
    steps_last = -(-dm.n_train // dm.train_batch_size)
    return {"counts": counts, "model": model, "checkpoints": run_dir / "run" / "checkpoints",
            "steps_per_s": steps / max(out["train_seconds"], 1e-9),
            "steps_per_s_last": steps_last * last["seq_per_sec"] / dm.n_train}


def _self_device_us(event) -> float:
    """A profiler row's own device time in µs (the attribute was renamed)."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, attr):
            return getattr(event, attr)
    return 0.0


@contextlib.contextmanager
def plain_route():
    """Timing only: route the recurrences and the fused encoder to their
    plain versions on CUDA tensors too (the dispatch itself never does)."""
    from multimodal_mtrssm_tpu_torch.nn.core import activation
    from multimodal_mtrssm_tpu_torch.ops import kernels
    from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv

    names = ("fused_encoder_forward_cuda", "fused_encoder_backward_cuda",
             "fused_encoder_bf16_forward_cuda", "fused_encoder_bf16_backward_cuda")
    saved = (kernels._route, *(getattr(fused_conv, n) for n in names))
    kernels._route = lambda device, name: activation(name)
    for n, plain in zip(names, (fused_conv.fused_encoder_plain,
                                fused_conv.fused_encoder_backward_plain) * 2):
        setattr(fused_conv, n, plain)
    try:
        yield
    finally:
        kernels._route = saved[0]
        for n, f in zip(names, saved[1:]):
            setattr(fused_conv, n, f)


# The device kernels of one recurrence_backward_cuda call, as the profiler
# names them (substrings), in launch order; the parent's one-kernel backward
# and its reduction are listed too, so that the same timing reads both.
RECURRENCE_BWD_KERNELS = {"recompute": "recurrence_bwd_recompute",
                          "chain": "recurrence_bwd_chain",
                          "tickets memset": "Memset",
                          "deferred GEMMs": "recurrence_bwd_dw",
                          "one-kernel backward (before the three passes)": "recurrence_bwd_kernel",
                          "reduce_weight_grads": "reduce_weight_grads"}


def bwd_timings(model, cfg, dev, card: str) -> dict[str, tuple[float, float]]:
    """Phase 5, MRSSM: the backward kernels against their plain version, a
    call's CUDA-event time beside each kernel's device time
    (``torch.profiler``), at B=8 and B=128 T=30."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence

    C, K = cfg.class_size, cfg.category_size
    rng = np.random.default_rng(SEED + 4)
    rw = [w.detach() for w in model.representation_weights()]
    main: dict[str, tuple[float, float]] = {}
    for B, T in ((8, 30), (128, 30)):
        args = _recurrence_inputs(rng, B, T, cfg, dev)
        with torch.no_grad():
            outs = recurrence.recurrence_forward_cuda(rw, *args, C, K)
        cots = [torch.randn(o.shape, device=dev) for o in outs]
        bwd = _backward_args(rw, args, outs, cots, cfg)
        k_ms = _median_ms(lambda: recurrence.recurrence_backward_cuda(*bwd), 20)
        p_ms = _median_ms(lambda: recurrence.recurrence_backward_plain(*bwd), 2, warmup=1)
        print(f"time recurrence_bwd B={B} T={T}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms | {card}")
        parts = _device_breakdown(lambda: recurrence.recurrence_backward_cuda(*bwd),
                                  RECURRENCE_BWD_KERNELS.values())
        _print_breakdown(f"recurrence_bwd B={B} T={T} (call {k_ms:.4f} ms by CUDA events)", parts,
                         RECURRENCE_BWD_KERNELS, card)
        main.setdefault("recurrence_bwd", (k_ms, p_ms))
    return main


# The device kernels of one mt_recurrence_forward_cuda call, as the profiler
# names them (substrings); the one-kernel forward it replaced is listed too,
# so that the same timing reads both. Both families' stage kernels run each
# stage alone on a call's workspace and outputs (``mt_forward_launch``,
# ``recurrence.forward_launch``): staging alone, then each stage with it
# (FWD_STAGES).
MT_FWD_KERNELS = {"three stages": "mt_recurrence_fwd_stages_kernel",
                  "one-kernel forward (before the three stages)": "mt_recurrence_fwd_kernel"}
FWD_STAGES = {"weight staging": 0, "+ prologue": 1, "+ chain": 2, "+ epilogue": 4}


def mt_fwd_timings(model, cfg, dev, card: str) -> None:
    """Phase 5, MMTRSSM: the forward's call by CUDA events (median of 30)
    beside its kernels' device time (``torch.profiler``) at B=8, 32 and 128
    T=30, and, where the kernel runs its stages one at a time, the device
    time of the weight staging alone and of each stage with it."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence_mt

    spec = cfg.spec
    rng = np.random.default_rng(SEED + 7)
    rw = [w.detach() for w in model.recurrence_weights()]
    launch = getattr(recurrence_mt, "mt_forward_launch", None)
    for B, T in MT_SHAPES[:3]:
        xs, init6, gumbels = _mt_inputs(rng, B, T, cfg, dev)
        with torch.no_grad():
            def call():
                return recurrence_mt.mt_recurrence_forward_cuda(rw, *xs, init6, gumbels, spec)

            k_ms = _median_ms(call, 30)
            parts = _device_breakdown(call, MT_FWD_KERNELS.values())
            _print_breakdown(f"mt_recurrence_fwd B={B} T={T} (call {k_ms:.4f} ms by CUDA events)",
                             parts, MT_FWD_KERNELS, card)
            if launch is None:
                continue
            outs, ws = launch(rw, *xs, init6, gumbels, spec)
            stages = {name: _device_ms(lambda m=m: launch(rw, *xs, init6, gumbels, spec, stages=m,
                                                          workspace=ws, outs=outs),
                                       MT_FWD_KERNELS["three stages"])
                      for name, m in FWD_STAGES.items()}
            print(f"time mt_recurrence_fwd B={B} T={T} stages alone, device ms a launch "
                  "(torch.profiler, 10 launches): " + ", ".join(
                      f"{k} " + ("not measured" if v is None else f"{v:.4f}")
                      for k, v in stages.items()) + f" | {card}")


# The device kernels of one recurrence_forward_cuda call and of one
# recurrence_stacked_forward_cuda call (the pack, then the same kernel on the
# packed weights), as the profiler names them (substrings); the one-kernel
# forwards they replaced are listed too, so that the same timing reads both.
RECURRENCE_FWD_KERNELS = {"three stages": "recurrence_fwd_stages_kernel",
                          "one-kernel forward (before the three stages)":
                              "recurrence_fwd_kernel"}
STACKED_FWD_KERNELS = {"pack": "stacked_pack_kernel",
                       "three stages": "recurrence_fwd_stages_kernel",
                       "one-kernel stacked forward (before the pack)": "stacked_fwd_kernel"}


def rec_fwd_timings(model, cfg, dev, card: str) -> None:
    """Phase 5, MRSSM: the forward's call by CUDA events (median of 30)
    beside its kernels' device time (``torch.profiler``) at B=8, 32 and 128
    T=30, the stacked forward's the same on the same inputs (with whether
    its outputs equal the unstacked forward's bit for bit), and, where the
    kernel runs its stages one at a time, the device time of the weight
    staging alone and of each stage with it (measurements: nothing here
    fails)."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence
    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence_stacked as rs

    C, K = cfg.class_size, cfg.category_size
    rng = np.random.default_rng(SEED + 16)
    rw = [w.detach() for w in model.representation_weights()]
    st = rs.stack_train_params(rw)
    launch = getattr(recurrence, "forward_launch", None)
    for B, T in ((8, 30), (32, 30), (128, 30)):
        args = _recurrence_inputs(rng, B, T, cfg, dev)
        with torch.no_grad():
            def call():
                return recurrence.recurrence_forward_cuda(rw, *args, C, K)

            def stacked():
                return rs.recurrence_stacked_forward_cuda(st, *args, C, K)

            for name, fn, kernels in (("recurrence_fwd", call, RECURRENCE_FWD_KERNELS),
                                      ("stacked_recurrence_fwd", stacked, STACKED_FWD_KERNELS)):
                ms = _median_ms(fn, 30)
                _print_breakdown(f"{name} B={B} T={T} (call {ms:.4f} ms by CUDA events)",
                                 _device_breakdown(fn, kernels.values()), kernels, card)
            same = all(torch.equal(a, b) for a, b in zip(call(), stacked()))
            print(f"stacked_recurrence_fwd B={B} T={T}: outputs "
                  + ("bit-identical to" if same else "differ from")
                  + f" the unstacked forward's | {card}")
            if launch is None:
                continue
            outs, ws = launch(rw, *args, C, K)
            stages = {name: _device_ms(lambda m=m: launch(rw, *args, C, K, stages=m, workspace=ws,
                                                          outs=outs),
                                       RECURRENCE_FWD_KERNELS["three stages"])
                      for name, m in FWD_STAGES.items()}
            print(f"time recurrence_fwd B={B} T={T} stages alone, device ms a launch "
                  "(torch.profiler, 10 launches): " + ", ".join(
                      f"{k} " + ("not measured" if v is None else f"{v:.4f}")
                      for k, v in stages.items()) + f" | {card}")


# The device kernel of one rollout_cuda and one rollout_mt_cuda call, as the
# profiler names it (a substring); the one-kernel rollouts they replaced are
# listed too, so that the same timing reads both trees. The stages a
# rollout's launch runs alone (its flags; staging always runs), and the
# shapes of the --rollout timings.
ROLLOUT_KERNELS = {"rollout": {"staged kernel": "rollout_stages_kernel",
                               "one-kernel rollout (before the stages)": "rollout_kernel"},
                   "mt_rollout": {"staged kernel": "mt_rollout_stages_kernel",
                                  "one-kernel rollout (before the stages)": "mt_rollout_kernel"}}
ROLLOUT_STAGES = {"weight staging": 0, "+ prologue": 1, "+ chain": 2}
ROLLOUT_SHAPES = ((8, 30), (64, 30), (256, 180))


def rollout_timings(dev, card: str) -> None:
    """Both rollouts on seeded weights of ``MRSSMConfig()`` and
    ``MMTRSSMConfig()``: a call by CUDA events (median of 30) beside its
    kernel's device time (``torch.profiler``) at ``ROLLOUT_SHAPES``; where
    the kernel runs its stages one at a time (``rollout_launch``,
    ``rollout_mt_launch``), the device time of the weight staging alone and
    of each stage with it, and at B=256 that of one and of two batch rows a
    block (measurements: nothing here fails)."""
    import torch

    from multimodal_mtrssm_tpu_torch.models import (
        MMTRSSMConfig,
        MoPoEMMTRSSM,
        MoPoEMRSSM,
        MRSSMConfig,
    )
    from multimodal_mtrssm_tpu_torch.ops.kernels import rollout, rollout_mt

    cfg, mt_cfg = MRSSMConfig(), MMTRSSMConfig()
    C, K, spec = cfg.class_size, cfg.category_size, mt_cfg.spec
    tw = [w.detach() for w in _seeded(MoPoEMRSSM, cfg, dev).transition.weights()]
    mw = [w.detach() for w in _seeded(MoPoEMMTRSSM, mt_cfg, dev).rollout_weights()]
    launch = getattr(rollout, "rollout_launch", None)
    mt_launch = getattr(rollout_mt, "rollout_mt_launch", None)
    rng = np.random.default_rng(SEED + 17)
    for B, T in ROLLOUT_SHAPES:
        actions = torch.tensor(rng.uniform(-1, 1, (B, T, cfg.action_size)).astype(np.float32),
                               device=dev)
        deter0, stoch0 = _recurrence_inputs(rng, B, 1, cfg, dev)[3:5]
        xs, init6, _ = _mt_inputs(rng, B, T, mt_cfg, dev)
        mt_actions = xs[0].transpose(0, 1).contiguous()
        cases = (
            ("rollout", lambda: rollout.rollout_cuda(tw, actions, deter0, stoch0, 5, C, K),
             launch and (lambda **kw: launch(tw, actions, deter0, stoch0, 5, C, K, **kw))),
            ("mt_rollout", lambda: rollout_mt.rollout_mt_cuda(mw, mt_actions, init6, 5, spec),
             mt_launch and (lambda **kw: mt_launch(mw, mt_actions, init6, 5, spec, **kw))))
        with torch.no_grad():
            for name, call, stage_launch in cases:
                kernels = ROLLOUT_KERNELS[name]
                ms = _median_ms(call, 30)
                _print_breakdown(f"{name} B={B} T={T} (call {ms:.4f} ms by CUDA events)",
                                 _device_breakdown(call, kernels.values()), kernels, card)
                if stage_launch is None:
                    continue
                key = kernels["staged kernel"]
                outs, ws = stage_launch()
                stages = {k: _device_ms(lambda m=m: stage_launch(stages=m, workspace=ws, outs=outs),
                                        key) for k, m in ROLLOUT_STAGES.items()}
                print(f"time {name} B={B} T={T} stages alone, device ms a launch "
                      "(torch.profiler, 10 launches): " + ", ".join(
                          f"{k} " + ("not measured" if v is None else f"{v:.4f}")
                          for k, v in stages.items()) + f" | {card}")
                if B >= 256:
                    rows = {R: _device_ms(lambda R=R: stage_launch(rows=R), key) for R in (1, 2)}
                    print(f"time {name} B={B} T={T} rows a block, device ms a call "
                          "(torch.profiler, 10 calls): " + ", ".join(
                              f"R={R} " + ("not measured" if v is None else f"{v:.4f}")
                              for R, v in rows.items()) + f" | {card}")


# The same of one mt_recurrence_backward_cuda call; the parent's one-kernel
# backward (mt_recurrence_bwd_kernel) and its reduction are listed too.
MT_BWD_KERNELS = {"recompute": "mt_recurrence_bwd_recompute",
                  "chain": "mt_recurrence_bwd_chain",
                  "tickets memset": "Memset",
                  "deferred GEMMs": "recurrence_bwd_dw",
                  "one-kernel backward (before the three passes)": "mt_recurrence_bwd_kernel",
                  "reduce_weight_grads": "reduce_weight_grads"}


def mt_bwd_timings(model, cfg, dev, card: str,
                   plain: bool = True) -> dict[str, tuple[float, float]]:
    """Phase 5, MMTRSSM: the backward kernels (against their plain version
    where ``plain``), a call's CUDA-event time beside each kernel's device
    time (``torch.profiler``), at B=8, 32 and 128 T=30; returns the B=8
    times (plain: NaN where not timed)."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence_mt

    spec = cfg.spec
    rng = np.random.default_rng(SEED + 7)
    rw = [w.detach() for w in model.recurrence_weights()]
    main: dict[str, tuple[float, float]] = {}
    for B, T in MT_SHAPES[:3]:
        xs, init6, gumbels = _mt_inputs(rng, B, T, cfg, dev)
        with torch.no_grad():
            outs = recurrence_mt.mt_recurrence_forward_cuda(rw, *xs, init6, gumbels, spec)
        cots = [o.new_tensor(rng.standard_normal(tuple(o.shape)).astype(np.float32))
                for o in outs]
        prev6 = recurrence_mt.shift_carries(init6, recurrence_mt.carries(outs))
        args = (rw, *xs, prev6, cots, spec)
        k_ms = _median_ms(lambda: recurrence_mt.mt_recurrence_backward_cuda(*args), 20)
        p_ms = (_median_ms(lambda: recurrence_mt.mt_recurrence_backward_plain(*args), 2, warmup=1)
                if plain else float("nan"))
        print(f"time mt_recurrence_bwd B={B} T={T}: kernel {k_ms:.4f} ms, plain "
              + (f"{p_ms:.4f} ms" if plain else "not timed") + f" | {card}")
        parts = _device_breakdown(lambda: recurrence_mt.mt_recurrence_backward_cuda(*args),
                                  MT_BWD_KERNELS.values())
        _print_breakdown(f"mt_recurrence_bwd B={B} T={T} (call {k_ms:.4f} ms by CUDA events)",
                         parts, MT_BWD_KERNELS, card)
        main.setdefault("mt_recurrence_bwd", (k_ms, p_ms))
    return main


# The same of one recurrence_stacked_backward_cuda call: the pack, the
# unstacked backward's three kernels on the packed weights, the scatter and
# the caller's zero fill of the stacked gradients; the parent's one-kernel
# stacked backward and its reduction are listed too.
STACKED_BWD_KERNELS = {"pack": "stacked_pack_kernel",
                       "recompute": "recurrence_bwd_recompute",
                       "chain": "recurrence_bwd_chain",
                       "tickets memset": "Memset",
                       "deferred GEMMs": "recurrence_bwd_dw",
                       "scatter": "stacked_scatter_kernel",
                       "caller's zero fills": "FillFunctor",
                       "one-kernel backward (before the three passes)": "stacked_bwd_kernel",
                       "reduce_stacked_grads": "reduce_stacked_grads"}


def stacked_bwd_timings(model, cfg, dev, card: str) -> None:
    """The stacked recurrence backward beside the unstacked one on the same
    weights and inputs, at B=8 and B=128 T=30: a call's CUDA-event time and
    each kernel's device time (``torch.profiler``) of both, the gap between
    their device times against max(10%, 15 µs) of the unstacked one's, and
    whether the stacked gradients, unstacked, and the input cotangents equal
    the unstacked kernels' bit for bit (measurements: nothing here fails)."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence
    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence_stacked as rs

    C, K = cfg.class_size, cfg.category_size
    dims = (cfg.action_size, cfg.hidden_size, cfg.deterministic_size, cfg.obs_embed_size)
    rng = np.random.default_rng(SEED + 15)
    rw = [w.detach() for w in model.representation_weights()]
    st = rs.stack_train_params(rw)
    for B, T in STACKED_SHAPES[:2]:
        args = _recurrence_inputs(rng, B, T, cfg, dev)
        with torch.no_grad():
            outs = rs.recurrence_stacked_forward_cuda(st, *args, C, K)
        cots = [torch.tensor(rng.standard_normal(tuple(o.shape)).astype(np.float32), device=dev)
                for o in outs]
        bwd, bwd_u = (_backward_args(w, args, outs, cots, cfg) for w in (st, rw))
        got = rs.recurrence_stacked_backward_cuda(*bwd)
        ref = recurrence.recurrence_backward_cuda(*bwd_u)
        got_u = (*rs.unstack_train_grads(got[:rs.N_STACKED], dims), *got[rs.N_STACKED:])
        diff = max(float((a - b).abs().max()) for a, b in zip(got_u, ref))
        same = all(torch.equal(a, b) for a, b in zip(got_u, ref))
        s_ms = _median_ms(lambda: rs.recurrence_stacked_backward_cuda(*bwd), 20)
        u_ms = _median_ms(lambda: recurrence.recurrence_backward_cuda(*bwd_u), 20)
        s_parts = _device_breakdown(lambda: rs.recurrence_stacked_backward_cuda(*bwd),
                                    STACKED_BWD_KERNELS.values())
        u_parts = _device_breakdown(lambda: recurrence.recurrence_backward_cuda(*bwd_u),
                                    RECURRENCE_BWD_KERNELS.values())
        _print_breakdown(f"stacked_recurrence_bwd B={B} T={T} (call {s_ms:.4f} ms by CUDA events)",
                         s_parts, STACKED_BWD_KERNELS, card)
        _print_breakdown(f"recurrence_bwd on the same weights and inputs B={B} T={T} (call "
                         f"{u_ms:.4f} ms by CUDA events)", u_parts, RECURRENCE_BWD_KERNELS, card)
        s_dev = sum(v for v in s_parts.values() if v is not None)
        u_dev = sum(v for v in u_parts.values() if v is not None)
        print(f"stacked_recurrence_bwd B={B} T={T}: device {s_dev:.4f} ms, the unstacked backward "
              f"{u_dev:.4f} ms, gap {s_dev - u_dev:.4f} ms (limit {max(0.1 * u_dev, 0.015):.4f}: "
              f"max(10%, 15 us)); gradients unstacked and input cotangents "
              + ("bit-identical to the unstacked kernels'" if same else
                 f"differ from the unstacked kernels' (max abs diff {diff:.3g})") + f" | {card}")


def step_timings(model, dev, card: str) -> None:
    """Phase 5, training: a full train step on the kernels against the plain
    route, and the train step's device-time breakdown."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multimodal_mtrssm_tpu_torch.train import AdamW, one_update

    name = _label(model.cfg)
    batch, _ = _train_batch(np.random.default_rng(SEED + 8), 8, 30, model)
    batch = tuple(x.to(dev) for x in batch)
    opt = AdamW(model.parameters())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step = lambda: one_update(model, opt, batch, gen)  # noqa: E731
    k_ms = _median_ms(step, 15, warmup=3)
    with plain_route():
        p_ms = _median_ms(step, 3, warmup=1)
    print(f"time {name} train step B=8 T=30 (forward, backward, AdamW): kernels {k_ms:.4f} ms, "
          f"plain recurrence {p_ms:.4f} ms | {card}")
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                step()
            torch.cuda.synchronize()
        events = prof.key_averages()
    except RuntimeError as e:  # a measurement, not a check: report and go on
        print(f"{name} train step device breakdown: not measured (torch.profiler failed: {e})")
        return
    rows = sorted(((e.key, _self_device_us(e), e.count) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA and _self_device_us(e) > 0),
                  key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    if total == 0:
        print(f"{name} train step device breakdown: not measured (no device time seen)")
        return
    groups = {"recurrence kernels": ("recurrence_", "stacked_"),
              "fused encoder kernels": ("encoder_",),
              "their gradient reductions": ("reduce_weight_grads",),
              "convolutions (cuDNN)": ("conv", "cudnn", "xmma", "implicit", "dgrad", "wgrad",
                                       "fprop", "sm90_")}
    def group(key: str) -> str | None:
        return next((g for g, keys in groups.items() if any(k in key.lower() for k in keys)), None)

    shares = {g: sum(r[1] for r in rows if group(r[0]) == g) for g in groups}
    shares["everything else"] = total - sum(shares.values())
    print(f"{name} train step device breakdown B=8 T=30, 5 steps under torch.profiler: "
          f"{total / 5e3:.4f} ms of device time a step, {total / 5e3 / k_ms:.1%} of the "
          f"{k_ms:.4f} ms step timed above; " + ", ".join(
              f"{g} {v / 5e3:.4f} ms ({v / total:.1%})" for g, v in shares.items()) + f" | {card}")
    for key, t_us, n in rows[:10]:
        print(f"  {t_us / 5e3:9.4f} ms/step  x{n // 5:<4d} {key[:110]}")


def _label(cfg) -> str:
    """A configuration's name in the log: the family, and its non-default
    kernel options."""
    name = ("MoPoEMMTRSSM" if hasattr(cfg, "hd_dim") else "WeightedMoPoEMRSSM"
            if hasattr(cfg, "weight_head_cells") else "RSSM" if hasattr(cfg, "encoder")
            else "MoPoEMRSSM")
    opts = [f"{k}={getattr(cfg, k)}" for k in ("conv_layout", "use_pallas_train")
            if getattr(cfg, k, "auto") != "auto"]
    if getattr(cfg, "conv_dtype", None) is not None:
        opts.append("conv_dtype=bfloat16")
    if str(getattr(cfg, "compute_dtype", "torch.float32")) != "torch.float32":
        opts.append("compute_dtype=bfloat16")
    return name + (f"({', '.join(opts)})" if opts else "")


# ---- bounds: the least time the card could take for a kernel's work ----------------

PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # its HBM3


def _nbytes(*tensors) -> int:
    """Bytes of the tensors in (nested) sequences: each input read once, each
    output written once."""
    import torch

    total = 0
    for t in tensors:
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
        elif isinstance(t, (list, tuple)):
            total += _nbytes(*t)
    return total


def _bound(flops: float, nbytes: int, peak: float = PEAK_F32_FLOPS) -> dict:
    """``bound_ms`` (the larger of operations over ``peak``, the f32 peak by
    default, and bytes over the memory rate) and which of the two bounds it."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "flops": flops, "bytes": nbytes, "peak": peak}


def _mrssm_step_macs(cfg, heads: bool = True) -> int:
    """Multiply-adds a recurrence step needs a batch row: the transition
    (and with ``heads`` the audio and vision posterior heads). The stacked
    layout's zero blocks are not counted: the work does not need them."""
    A, S, H, D, E = (cfg.action_size, cfg.stoch_size, cfg.hidden_size, cfg.deterministic_size,
                     cfg.obs_embed_size)
    trans = (A + S) * H + H * H + H * 3 * D + D * 3 * D + D * H + H * S
    return trans + (2 * ((D + E) * H + H * S) if heads else 0)


def _mt_step_macs(cfg, full: bool = True) -> int:
    """Multiply-adds a hierarchical step needs a batch row: both MTRNNs and
    priors (the rollout), with ``full`` also the h-posterior and both heads."""
    LD, HD, LS, HS = cfg.ld_dim, cfg.hd_dim, cfg.ls_dim, cfg.hs_dim
    C, R, E, A = cfg.prior_cells, cfg.rep_hidden_size, cfg.obs_embed_size, cfg.action_size
    prior = LD * LD + (A + LS + HS) * LD + HD * HD + HS * HD + LD * C + C * LS + HD * C + C * HS
    return prior + (((LD + HD) * C + C * HS + 2 * ((LD + E) * R + R * LS)) if full else 0)


def _encoder_macs(cfg) -> tuple[int, int]:
    """Multiply-adds the encoder needs a frame, counting only the taps that
    land inside the padded maps, and those of its first layer."""
    def conv(h, w, ci, co, k, s, p):
        ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
        ys = [sum(0 <= oy * s - p + d < h for d in range(k)) for oy in range(ho)]
        xs = [sum(0 <= ox * s - p + d < w for d in range(k)) for ox in range(wo)]
        return sum(ys) * sum(xs) * ci * co, ho, wo

    h, w = cfg.in_hw
    ci = cfg.in_channels + (2 if cfg.coord_conv else 0)
    total = first = 0
    for co, k, s, p in zip(cfg.channels, cfg.kernel_sizes, cfg.strides, cfg.paddings):
        m, h, w = conv(h, w, ci, co, k, s, p)
        first = first or m
        total, ci = total + m, co
    if cfg.num_residual_blocks > 0 and ci != cfg.residual_output_size:
        total, ci = total + conv(h, w, ci, cfg.residual_output_size, 1, 1, 0)[0], \
            cfg.residual_output_size
    for _ in range(cfg.num_residual_blocks):
        total += conv(h, w, ci, cfg.residual_intermediate_size, 3, 1, 1)[0]
        total += conv(h, w, cfg.residual_intermediate_size, ci, 3, 1, 1)[0]
    return total + h * w * ci * cfg.out_dim, first


# ---- the stacked recurrence and the fused encoder ----------------------------------


STACKED_SHAPES = ((8, 30), (128, 30), (3, 7))
# B·T per encoder at B=8 T=30, a ragged tile, B=128 T=30, and a ragged tile
# and last weight-gradient chunk (16 chunks of 16 frames, the last of 1).
ENCODER_FRAMES = (240, 7, 3840, 241)


def check_stacked(model, cfg, dev) -> dict[str, dict]:
    """Phase 2, stacked recurrence: the forward against its plain version
    and bit-identical to the unstacked forward on the 20 weights it was
    stacked from, and the backward (unstacked gradients) against its plain
    version on the forward's record and random cotangents, reproducible,
    its zero blocks 0, and bit-identical to the unstacked backward's
    kernels on the 20 weights it was stacked from."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence
    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence_stacked as rs
    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import (
        ParityError,
        check_gradients,
        check_recurrence,
    )

    C, K = cfg.class_size, cfg.category_size
    dims = (cfg.action_size, cfg.hidden_size, cfg.deterministic_size, cfg.obs_embed_size)
    rng = np.random.default_rng(SEED + 9)
    rw = [w.detach() for w in model.representation_weights()]
    st = rs.stack_train_params(rw)
    nonzero = rs.stack_train_params([torch.ones_like(w) for w in rw])
    fwd_err = bwd_err = 0.0
    for B, T in STACKED_SHAPES:
        args = _recurrence_inputs(rng, B, T, cfg, dev)
        outs = rs.recurrence_stacked_forward_cuda(st, *args, C, K)
        r = check_recurrence(outs, rs.recurrence_stacked_forward_plain(st, *args, C, K),
                             args[5], args[6], C, K, TOL, TIE_EPS)
        if not all(torch.equal(a, b) for a, b in
                   zip(outs, recurrence.recurrence_forward_cuda(rw, *args, C, K))):
            raise ParityError("stacked_recurrence_fwd: its outputs differ from the unstacked "
                              "forward's on the same weights")
        cots = [torch.tensor(rng.standard_normal(tuple(o.shape)).astype(np.float32), device=dev)
                for o in outs]
        bwd = _backward_args(st, args, outs, cots, cfg)
        got = rs.recurrence_stacked_backward_cuda(*bwd)
        again = rs.recurrence_stacked_backward_cuda(*bwd)
        ref = rs.recurrence_stacked_backward_plain(*bwd)
        unstack = lambda g: (*rs.unstack_train_grads(g[:rs.N_STACKED], dims),  # noqa: E731
                             *g[rs.N_STACKED:])
        got_u, ref_u = unstack(got), unstack(ref)
        scaled = check_gradients(got_u, ref_u, BWD_TOL)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise ParityError("stacked_recurrence_bwd: two launches on the same inputs differ")
        if any(g[m == 0].any() for g, m in zip(got, nonzero)):
            raise ParityError("stacked_recurrence_bwd: a zero block of its gradients is not 0")
        unstacked = recurrence.recurrence_backward_cuda(*_backward_args(rw, args, outs, cots, cfg))
        if not all(torch.equal(a, b) for a, b in zip(got_u, unstacked)):
            raise ParityError("stacked_recurrence_bwd: its gradients, unstacked, differ from the "
                              "unstacked backward's kernels' on the same weights")
        err = max(float((g - p).abs().max()) for g, p in zip(got_u, ref_u))
        print(f"check stacked_recurrence_fwd B={B} T={T}: max_abs_err={r['max_abs_err']:.3g} "
              f"steps_compared={r['compared']:.4f}, bit-identical to the unstacked forward; "
              "stacked_recurrence_bwd: max_abs_err="
              f"{err:.3g} max_err/scale={scaled:.3g} (limit {BWD_TOL}), reproducible, zero "
              "blocks 0, bit-identical to the unstacked kernels")
        fwd_err, bwd_err = max(fwd_err, r["max_abs_err"]), max(bwd_err, err)
    return {"stacked_recurrence_fwd": {"max_abs_err": fwd_err},
            "stacked_recurrence_bwd": {"max_abs_err": bwd_err}}


def _encoder_case(rng, enc, N: int, dev):
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv

    w = [t.detach() for t in fused_conv.encoder_weights(enc)]
    x = torch.tensor(rng.uniform(-1, 1, (N, 32, 32, 1)).astype(np.float32), device=dev)
    g = torch.tensor(rng.standard_normal((N, enc.cfg.out_dim)).astype(np.float32), device=dev)
    return w, x, g


def _backward_f64(backward_plain, w, cfg, x, g) -> list:
    """A fused stack's plain backward on the inputs upcast to float64, as
    f32 (the weight gradients, then the input's): the reference of its
    backward kernel. At N=3840 cuDNN's float32 backward strays from float64
    by ~7e-4 of scale in the encoder's first conv's gradients and 2.5e-3 in
    dx, while the kernel stays within 1e-6 (NVIDIA H100 80GB HBM3), so
    float32 cuDNN cannot referee it there."""
    dx, dw = backward_plain([t.double() for t in w], cfg, x.double(), g.double(), True)
    return [t.float() for t in (*dw, dx)]


def check_encoder(model, dev) -> dict[str, dict]:
    """Phase 2, fused encoder: the forward kernel against its plain version
    and the cuDNN ``Encoder`` (TF32 off), each within ENC_TOL × max(1,
    max|plain|); the backward (every weight gradient and dx) against the
    plain backward in float64 within BWD_TOL × scale, reproducible."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv
    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import ParityError, check_gradients

    enc = model.audio_encoder
    rng = np.random.default_rng(SEED + 10)
    fwd_err = bwd_err = 0.0
    for N in ENCODER_FRAMES:
        w, x, g = _encoder_case(rng, enc, N, dev)
        got = fused_conv.fused_encoder_forward_cuda(w, enc.cfg, x)
        plain = fused_conv.fused_encoder_plain(w, enc.cfg, x)
        scale = max(1.0, float(plain.abs().max()))
        err, err_cudnn = (float((got - ref).abs().max()) for ref in (plain, enc(x)))
        if not max(err, err_cudnn) <= ENC_TOL * scale:
            raise ParityError(f"fused_encoder_fwd N={N}: max |kernel - plain| {err:.3g}, "
                              f"|kernel - cuDNN| {err_cudnn:.3g} > {ENC_TOL} x {scale:.3g}")
        dx, dw = fused_conv.fused_encoder_backward_cuda(w, enc.cfg, x, g, True)
        dx2, dw2 = fused_conv.fused_encoder_backward_cuda(w, enc.cfg, x, g, True)
        ref = _backward_f64(fused_conv.fused_encoder_backward_plain, w, enc.cfg, x, g)
        scaled = check_gradients([*dw, dx], ref, BWD_TOL)
        if not all(torch.equal(a, b) for a, b in zip([*dw, dx], [*dw2, dx2])):
            raise ParityError("fused_encoder_bwd: two launches on the same inputs differ")
        berr = max(float((a - b).abs().max()) for a, b in zip([*dw, dx], ref))
        f32_dx, f32_dw = fused_conv.fused_encoder_backward_plain(w, enc.cfg, x, g, True)
        f32_err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                      for a, b in zip([*f32_dw, f32_dx], ref))
        print(f"check fused_encoder_fwd N={N}: max_abs_err={err:.3g} vs plain, "
              f"{err_cudnn:.3g} vs cuDNN (limit {ENC_TOL} x {scale:.3g}); fused_encoder_bwd: "
              f"max_abs_err={berr:.3g} max_err/scale={scaled:.3g} vs the plain backward in "
              f"float64 (limit {BWD_TOL}), reproducible; the plain backward in float32 (cuDNN) "
              f"is {f32_err:.3g} of scale from float64")
        fwd_err, bwd_err = max(fwd_err, err), max(bwd_err, berr)
    return {"fused_encoder_fwd": {"max_abs_err": fwd_err},
            "fused_encoder_bwd": {"max_abs_err": bwd_err}}


def stacked_timings(model, cfg, dev, card: str) -> tuple[dict, dict]:
    """Phase 5, stacked recurrence: both kernels against their plain
    versions and beside the unstacked kernels on the same inputs; returns the
    main-path (B=8 T=30) times and bounds."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence
    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence_stacked as rs

    C, K = cfg.class_size, cfg.category_size
    rng = np.random.default_rng(SEED + 11)
    rw = [w.detach() for w in model.representation_weights()]
    st = rs.stack_train_params(rw)
    main: dict[str, tuple[float, float]] = {}
    bounds: dict[str, dict] = {}
    for B, T in STACKED_SHAPES[:2]:
        args = _recurrence_inputs(rng, B, T, cfg, dev)
        with torch.no_grad():
            outs = rs.recurrence_stacked_forward_cuda(st, *args, C, K)
        cots = [torch.randn(o.shape, device=dev) for o in outs]
        bwd, bwd_u = _backward_args(st, args, outs, cots, cfg), _backward_args(rw, args, outs,
                                                                               cots, cfg)
        k_ms = _median_ms(lambda: rs.recurrence_stacked_forward_cuda(st, *args, C, K), 30)
        u_ms = _median_ms(lambda: recurrence.recurrence_forward_cuda(rw, *args, C, K), 30)
        p_ms = _median_ms(lambda: rs.recurrence_stacked_forward_plain(st, *args, C, K), 3, warmup=1)
        kb_ms = _median_ms(lambda: rs.recurrence_stacked_backward_cuda(*bwd), 20)
        ub_ms = _median_ms(lambda: recurrence.recurrence_backward_cuda(*bwd_u), 20)
        pb_ms = _median_ms(lambda: rs.recurrence_stacked_backward_plain(*bwd), 2, warmup=1)
        print(f"time stacked_recurrence_fwd B={B} T={T}: kernel {k_ms:.4f} ms (unstacked kernel "
              f"{u_ms:.4f}), plain {p_ms:.4f} ms; stacked_recurrence_bwd: kernel {kb_ms:.4f} ms "
              f"(unstacked kernel {ub_ms:.4f}), plain {pb_ms:.4f} ms | {card}")
        if "stacked_recurrence_fwd" not in main:
            main["stacked_recurrence_fwd"], main["stacked_recurrence_bwd"] = (k_ms, p_ms), (kb_ms,
                                                                                         pb_ms)
            macs = _mrssm_step_macs(cfg) * B * T
            bounds["stacked_recurrence_fwd"] = _bound(2 * macs, _nbytes(st, args, outs))
            d_out = rs.recurrence_stacked_backward_cuda(*bwd)
            bounds["stacked_recurrence_bwd"] = _bound(6 * macs, _nbytes(bwd[:6], cots, d_out))
    return main, bounds


def encoder_timings(model, dev, card: str) -> tuple[dict, dict, dict]:
    """Phase 5, fused encoder: both kernels against their plain versions and
    against the cuDNN ``Encoder`` (TF32 off; the library yardstick, never
    called by the port on this path): forward, and forward + backward of
    every parameter. Returns the main-path (N=240) times, library times and
    bounds."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv

    enc = model.audio_encoder
    cfg = enc.cfg
    rng = np.random.default_rng(SEED + 12)
    macs, first = _encoder_macs(cfg)
    params = list(enc.parameters())
    main: dict[str, tuple[float, float]] = {}
    library: dict[str, float] = {}
    bounds: dict[str, dict] = {}
    for N in ENCODER_FRAMES[:3:2]:
        w, x, g = _encoder_case(rng, enc, N, dev)
        k_ms = _median_ms(lambda: fused_conv.fused_encoder_forward_cuda(w, cfg, x), 20)
        p_ms = _median_ms(lambda: fused_conv.fused_encoder_plain(w, cfg, x), 10)
        l_ms = _median_ms(lambda: enc(x), 20)
        d_ms = _device_ms(lambda: fused_conv.fused_encoder_forward_cuda(w, cfg, x), "encoder_")
        kb_ms = _median_ms(lambda: fused_conv.fused_encoder_backward_cuda(w, cfg, x, g, False), 10)
        pb_ms = _median_ms(lambda: fused_conv.fused_encoder_backward_plain(w, cfg, x, g, False), 10)
        with torch.enable_grad():
            lb_ms = _median_ms(lambda: torch.autograd.grad(enc(x), params, g), 10)
        parts = _device_breakdown(
            lambda: fused_conv.fused_encoder_backward_cuda(w, cfg, x, g, False),
            tuple(ENCODER_BWD_KERNELS.values()))
        _print_breakdown(f"fused_encoder_bwd N={N}", parts, ENCODER_BWD_KERNELS, card)
        dev_ms = "not measured" if d_ms is None else f"{d_ms:.4f} ms"
        print(f"time fused_encoder_fwd N={N}: kernel {k_ms:.4f} ms (device {dev_ms}), plain "
              f"{p_ms:.4f} ms, cuDNN Encoder {l_ms:.4f} ms; fused_encoder_bwd (recompute + weight "
              f"gradients): kernel {kb_ms:.4f} ms, plain {pb_ms:.4f} ms, cuDNN Encoder forward + backward "
              f"{lb_ms:.4f} ms | {card}")
        if "fused_encoder_fwd" not in main:
            main["fused_encoder_fwd"], main["fused_encoder_bwd"] = (k_ms, p_ms), (kb_ms, pb_ms)
            library["fused_encoder_fwd"], library["fused_encoder_bwd"] = l_ms, lb_ms
            bounds["fused_encoder_fwd"] = _bound(2 * macs * N, _nbytes(w, x) + 4 * N * cfg.out_dim)
            # Recompute, input cotangents below the first layer, weight gradients.
            bounds["fused_encoder_bwd"] = _bound(2 * (3 * macs - first) * N, 2 * _nbytes(w) +
                                                 _nbytes(x, g))
    return main, library, bounds


def _device_ms(fn, key: str, reps: int = 10) -> float | None:
    """Device time a call of the kernels whose names hold ``key``, under
    ``torch.profiler``; None where the profiler does not start or stop, or
    sees none. Errors of ``fn`` itself propagate."""
    return _device_breakdown(fn, (key,), reps)[key]


def _device_breakdown(fn, keys, reps: int = 10, seen: list | None = None,
                      ) -> dict[str, float | None]:
    """Device ms a call of ``fn`` spends in the kernels whose names hold each
    of ``keys``, from one ``torch.profiler`` window of ``reps`` calls; None
    for a key the profiler did not see (or where it does not start or
    stop). A key seen fewer times than ``reps`` is printed: late in a long
    process the profiler loses device records (the launches are all there),
    so such a window reads low. ``seen``, where given, receives (name,
    count, device ms) of every event the window holds. Errors of ``fn``
    itself propagate."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CUDA])
    try:
        prof.start()
    except RuntimeError as e:
        print(f"torch.profiler did not start: {e}")
        return dict.fromkeys(keys)
    try:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    finally:
        try:
            prof.stop()
            events = prof.key_averages()
        except RuntimeError as e:
            print(f"torch.profiler did not stop: {e}")
            events = []
    if seen is not None:
        seen.extend((e.key[:60], e.count, round(_self_device_us(e) / 1e3, 4)) for e in events)
    out: dict[str, float | None] = {}
    for key in keys:
        hit = [e for e in events if key in e.key and _self_device_us(e) > 0]
        total, count = sum(_self_device_us(e) for e in hit), sum(e.count for e in hit)
        out[key] = total / reps / 1e3 if total > 0 else None
        if 0 < count < reps:
            print(f"torch.profiler: {key} seen {count} times in a window of {reps} calls")
    return out


# The device kernels of one fused_encoder_backward_cuda call, as the
# profiler names them (substrings), in launch order.
ENCODER_BWD_KERNELS = {"pack": "encoder_pack_kernel", "recompute forward": "encoder_fwd_kernel",
                       "transposed pack": "encoder_bwd_pack_kernel",
                       "cotangent pass": "encoder_bwd_dx", "weight-gradient pass": "encoder_bwd_dw",
                       "reduce_weight_grads": "reduce_weight_grads"}
# The same of one fused_decoder_forward_cuda call (DECODER_FWD_KERNELS) and
# of one fused_decoder_backward_cuda call, which recomputes through the
# forward's kernels.
DECODER_FWD_KERNELS = {"pack": "decoder_pack_kernel", "forward": "decoder_fwd_kernel"}
DECODER_BWD_KERNELS = {"pack": "decoder_pack_kernel", "recompute forward": "decoder_fwd_kernel",
                       "transposed pack": "decoder_bwd_pack_kernel",
                       "cotangent pass": "decoder_bwd_dx", "weight-gradient pass": "decoder_bwd_dw",
                       "reduce_weight_grads": "reduce_weight_grads"}


def _print_breakdown(what: str, parts: dict[str, float | None], kernels: dict[str, str],
                     card: str) -> None:
    """One line of a call's device ms per kernel (``_device_breakdown``'s
    ``parts`` under ``kernels``' names) and their total."""
    seen = [v for v in parts.values() if v is not None]
    print(f"time {what} device breakdown a call (torch.profiler, 10 calls): "
          + ", ".join(f"{k} " + ("not measured" if parts[v] is None else f"{parts[v]:.4f} ms")
                      for k, v in kernels.items())
          + (f"; total {sum(seen):.4f} ms" if seen else "") + f" | {card}")


_CHILDREN: list[subprocess.Popen] = []  # stopped on exit, whatever failed


PTXAS_SOURCES = ("fused_encoder_fwd.cu", "fused_encoder_bwd.cu", "fused_decoder_fwd.cu",
                 "fused_decoder_bwd.cu", "recurrence_bwd.cu", "recurrence_mt_bwd.cu",
                 "recurrence_stacked_bwd.cu", "recurrence_mt_fwd.cu", "recurrence_fwd.cu",
                 "rollout.cu", "rollout_mt.cu", "fused_encoder_bf16_fwd.cu",
                 "fused_encoder_bf16_bwd.cu", "fused_decoder_bf16_fwd.cu",
                 "fused_decoder_bf16_bwd.cu")


def start_ptxas_report(sources=PTXAS_SOURCES) -> list[subprocess.Popen]:
    """Compile the fused stacks' sources, the three recurrence backwards',
    both recurrence forwards' and both rollouts' once more with ``-Xptxas
    -v``, in the background (into the git-ignored build directory), one
    ``nvcc`` each."""
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources:
        obj = build.BUILD_DIR / f"ptxas_report_{Path(src).stem}.o"
        procs.append(subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
             str(build.CSRC / src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        _CHILDREN.append(procs[-1])
    return procs


def ptxas_report(procs: list[subprocess.Popen], sources=PTXAS_SOURCES) -> None:
    """Print ptxas's registers, stack and spills of each fused encoder and decoder
    kernel, forward and backward, of the three recurrence backwards' kernels and of
    both recurrence forwards' and rollouts' (a measurement: "not measured" where the
    compile fails). A backward's source also compiles the forward it recomputes
    through; those kernels are printed once, from the forward's source."""
    import re

    seen: set[str] = set()
    for src, proc in zip(sources, procs):
        out = proc.communicate(timeout=300)[0]
        if proc.returncode != 0:
            print(f"ptxas {src}: not measured (nvcc exited {proc.returncode})")
            continue
        name = None
        for line in out.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
                m = re.search(r"((?:en|de)coder_[a-z0-9_]*kernel|"
                              r"(?:mt_)?recurrence_(?:bwd|fwd)_[a-z_]*kernel|"
                              r"(?:mt_)?rollout_[a-z_]*kernel|"
                              r"stacked_[a-z_]*kernel|reduce_(?:weight|stacked)_grads)", entry)
                # Without the source's own prefix (an anonymous namespace's
                # mangled name).
                kernel = re.sub(r"^[a-z0-9_]*_cu_[0-9a-f]{8}\d*", "", m.group(1)) if m else ""
                name = kernel if m and kernel not in seen else None
                if name:
                    seen.add(name)
            elif name and ("stack frame" in line or "Used" in line):
                print(f"ptxas {name} ({src}): {line.replace('ptxas info    :', '').strip()}")


# ---- the fused decoder -------------------------------------------------------------------

DEC_TOL = 1e-5  # frames: the kernel against the plain version and against cuDNN's decode
DECODER_SHAPES = ((8, 30), (128, 30))  # the observes whose features are decoded: N = 240, 3840


def _decoder_macs(cfg) -> int:
    """Multiply-adds the decoder needs a frame, counting only the taps that
    land inside the maps (``_encoder_macs``' convention): the linears, the
    projection, the residual convs and the transposed convs."""
    def taps(n_from, n_to, k, s, p):  # pairs (i, t) with i·s − p + t inside [0, n_to)
        return sum(0 <= i * s - p + t < n_to for i in range(n_from) for t in range(k))

    (l0, l1), (c, h, w) = cfg.linear_sizes, cfg.conv_in_shape
    total = cfg.in_features * l0 + l0 * l1
    if cfg.num_residual_blocks > 0 and c != cfg.residual_input_size:
        total, c = total + h * w * c * cfg.residual_input_size, cfg.residual_input_size
    mid = cfg.residual_intermediate_size
    total += cfg.num_residual_blocks * 2 * taps(h, h, 3, 1, 1) * taps(w, w, 3, 1, 1) * c * mid
    for ch, k, s, p in zip(cfg.channels, cfg.kernel_sizes, cfg.strides, cfg.paddings):
        ho, wo = (h - 1) * s - 2 * p + k, (w - 1) * s - 2 * p + k
        total += taps(h, ho, k, s, p) * taps(w, wo, k, s, p) * c * ch
        h, w, c = ho, wo, ch
    return total


def _observed_features(model, cfg, dev, B: int, T: int):
    """An observe of random frames at ``B`` × ``T`` through ``WorldModel``:
    the posterior state and its latent features ``[B·T, F]``, the decoders'
    input (deter ⊕ stoch for MRSSM, hd ⊕ hs ⊕ ld ⊕ ls for MMTRSSM)."""
    from multimodal_mtrssm_tpu_torch.serving import WorldModel

    rng = np.random.default_rng(SEED + 15 + B)
    frames = [rng.uniform(-1, 1, (B, T, 32, 32, 1)).astype(np.float32) for _ in range(2)]
    post, _ = WorldModel(model, dev).observe(
        rng.uniform(-1, 1, (B, T, cfg.action_size)).astype(np.float32), *frames, seed=B)
    return post, post.feature.reshape(B * T, -1).contiguous()


def drive_decoder(cases, dev) -> dict:
    """The fused decoder's path: ``fused_decoder_apply`` on both decoders of
    each model over its observed features (``cases``: a label, a model, its
    observed state and features, at B=8 T=30), forward and the backward of
    ``gaussian_nll`` against random target frames, with every launch count
    set to 0 just before and read just after. No model config selects the
    decoder kernels (as in JAX), so this is their path. Returns the counts
    and, per decoder, what the checks hold it to."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import (
        fused_decoder_apply,
        launch_counts,
        reset_launch_counts,
    )
    from multimodal_mtrssm_tpu_torch.ops.kernels.fused_conv import decoder_weights
    from multimodal_mtrssm_tpu_torch.ops.likelihood import gaussian_nll

    rng = np.random.default_rng(SEED + 16)
    targets = [torch.tensor(rng.uniform(-1, 1, (feats.shape[0], 32, 32, 1)).astype(np.float32),
                            device=dev) for _, _, _, feats in cases for _ in range(2)]
    out = []
    reset_launch_counts()
    for label, model, state, feats in cases:
        for name in ("audio", "vision"):
            dec = getattr(model, f"{name}_decoder")
            x = feats.clone().requires_grad_()
            with torch.enable_grad():
                frames = fused_decoder_apply(dec, x)
                loss = gaussian_nll(frames, targets[len(out)], 3)
                g, dx, *dw = torch.autograd.grad(loss, [frames, x, *decoder_weights(dec)])
            out.append({"label": label, "model": model, "name": name, "state": state,
                        "feats": feats, "frames": frames.detach(), "g": g, "grads": [*dw, dx]})
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"main-path kernel launches, fused decoder path (both decoders of "
          f"{' and '.join(c[0] for c in cases)} on their observed features, B=8 T=30, forward "
          f"and gaussian_nll backward): {counts}")
    if min(counts["fused_decoder_fwd"], counts["fused_decoder_bwd"]) < len(out):
        raise RuntimeError(f"the decoder path missed a kernel: {counts}")
    return {"counts": counts, "cases": out}


def _big_decoder_case(big, dev) -> dict:
    """The audio decoder's kernels at N=3840 (``big``: a label, a model and
    its observed state and features at B=128 T=30), as the checks take a
    case; comparison launches, outside the path's counts."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv
    from multimodal_mtrssm_tpu_torch.ops.likelihood import gaussian_nll

    label, model, state, feats = big
    dec = model.audio_decoder
    w = [t.detach() for t in fused_conv.decoder_weights(dec)]
    frames = fused_conv.fused_decoder_forward_cuda(w, dec.cfg, feats)
    target = torch.tensor(np.random.default_rng(SEED + 17).uniform(
        -1, 1, tuple(frames.shape)).astype(np.float32), device=dev)
    with torch.enable_grad():
        y = frames.clone().requires_grad_()
        g, = torch.autograd.grad(gaussian_nll(y, target, 3), [y])
    dx, dw = fused_conv.fused_decoder_backward_cuda(w, dec.cfg, feats, g, True)
    return {"label": label, "model": model, "name": "audio", "state": state, "feats": feats,
            "frames": frames, "g": g, "grads": [*dw, dx]}


def check_decoder(cases: list[dict]) -> dict[str, dict]:
    """Phase 2, fused decoder: per case, the kernel's frames against the
    plain version and against the model's own ``decode_state`` (cuDNN, TF32
    off) within DEC_TOL, and the kernel's backward of ``gaussian_nll``
    (every weight gradient and the features') against the plain backward in
    float64 within BWD_TOL × scale; a second launch gives the same bits."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv
    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import ParityError, check_gradients

    fwd_err = bwd_err = 0.0
    for c in cases:
        dec, feats, g = getattr(c["model"], f"{c['name']}_decoder"), c["feats"], c["g"]
        w = [t.detach() for t in fused_conv.decoder_weights(dec)]
        where = f"{c['label']} {c['name']} N={feats.shape[0]} F={feats.shape[1]}"
        plain = fused_conv.fused_decoder_plain(w, dec.cfg, feats)
        cudnn = c["model"].decode_state(c["state"])[f"recon/{c['name']}"].reshape(plain.shape)
        err, err_cudnn = (float((c["frames"] - ref).abs().max()) for ref in (plain, cudnn))
        if not max(err, err_cudnn) <= DEC_TOL:
            raise ParityError(f"fused_decoder_fwd {where}: max |kernel - plain| {err:.3g}, "
                              f"|kernel - cuDNN| {err_cudnn:.3g} > {DEC_TOL}")
        ref = _backward_f64(fused_conv.fused_decoder_backward_plain, w, dec.cfg, feats, g)
        scaled = check_gradients(c["grads"], ref, BWD_TOL)
        dx2, dw2 = fused_conv.fused_decoder_backward_cuda(w, dec.cfg, feats, g, True)
        if not all(torch.equal(a, b) for a, b in zip(c["grads"], [*dw2, dx2])):
            raise ParityError(f"fused_decoder_bwd {where}: two launches on the same inputs differ")
        berr = max(float((a - b).abs().max()) for a, b in zip(c["grads"], ref))
        rel = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
                  for a, b in zip(c["grads"], ref))
        print(f"check fused_decoder_fwd {where}: max_abs_err={err:.3g} vs plain, {err_cudnn:.3g} "
              f"vs cuDNN decode_state (limit {DEC_TOL}); fused_decoder_bwd of gaussian_nll: "
              f"max_abs_err={berr:.3g} max_err/scale={scaled:.3g} vs the plain backward in float64 "
              f"(limit {BWD_TOL}), max_err/max|float64| per tensor {rel:.3g}, reproducible")
        fwd_err, bwd_err = max(fwd_err, err), max(bwd_err, berr)
    return {"fused_decoder_fwd": {"max_abs_err": fwd_err},
            "fused_decoder_bwd": {"max_abs_err": bwd_err}}


def decoder_timings(cases: list[dict], dev, card: str) -> tuple[dict, dict, dict]:
    """Phase 5, fused decoder: both kernels against their plain versions and
    against the cuDNN ``Decoder`` (TF32 off; the library yardstick, never
    called by the kernels' path): forward, and forward + backward to the
    features and every parameter, on each case's audio decoder and
    features, and the device time of each kernel of a forward and of a
    backward call. Returns the first case's (N=240, 48 wide) times, library
    times and bounds."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv

    rng = np.random.default_rng(SEED + 18)
    main: dict[str, tuple[float, float]] = {}
    library: dict[str, float] = {}
    bounds: dict[str, dict] = {}
    for c in cases:
        dec, feats = c["model"].audio_decoder, c["feats"]
        cfg, N = dec.cfg, feats.shape[0]
        w = [t.detach() for t in fused_conv.decoder_weights(dec)]
        g = torch.tensor(rng.standard_normal((N, 32, 32, 1)).astype(np.float32), device=dev)
        k_ms = _median_ms(lambda: fused_conv.fused_decoder_forward_cuda(w, cfg, feats), 20)
        p_ms = _median_ms(lambda: fused_conv.fused_decoder_plain(w, cfg, feats), 10)
        l_ms = _median_ms(lambda: dec(feats), 20)
        kb_ms = _median_ms(lambda: fused_conv.fused_decoder_backward_cuda(w, cfg, feats, g, True),
                           10)
        pb_ms = _median_ms(lambda: fused_conv.fused_decoder_backward_plain(w, cfg, feats, g, True),
                           10)
        x, params = feats.clone().requires_grad_(), list(dec.parameters())
        with torch.enable_grad():
            lb_ms = _median_ms(lambda: torch.autograd.grad(dec(x), [x, *params], g), 10)
        fwd_parts = _device_breakdown(lambda: fused_conv.fused_decoder_forward_cuda(w, cfg, feats),
                                      tuple(DECODER_FWD_KERNELS.values()))
        _print_breakdown(f"fused_decoder_fwd {c['label']} N={N}", fwd_parts, DECODER_FWD_KERNELS,
                         card)
        bwd_parts = _device_breakdown(
            lambda: fused_conv.fused_decoder_backward_cuda(w, cfg, feats, g, True),
            tuple(DECODER_BWD_KERNELS.values()))
        _print_breakdown(f"fused_decoder_bwd {c['label']} N={N}", bwd_parts, DECODER_BWD_KERNELS,
                         card)
        macs = _decoder_macs(cfg) * N
        b_fwd = _bound(2 * macs, _nbytes(w, feats) + 4 * g.numel())
        # Recompute, feature and input cotangents, weight gradients.
        b_bwd = _bound(6 * macs, 2 * _nbytes(w, feats) + _nbytes(g))
        print(f"time fused_decoder_fwd {c['label']} N={N} F={cfg.in_features}: kernel "
              f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, cuDNN Decoder {l_ms:.4f} ms, bound "
              f"{b_fwd['bound_ms']:.6f} ms ({b_fwd['bound_by']}); fused_decoder_bwd (recompute, "
              f"feature and weight gradients): kernel {kb_ms:.4f} ms, plain {pb_ms:.4f} ms, cuDNN "
              f"Decoder forward + backward {lb_ms:.4f} ms, bound {b_bwd['bound_ms']:.6f} ms "
              f"({b_bwd['bound_by']}) | {card}")
        if "fused_decoder_fwd" not in main:
            main["fused_decoder_fwd"], main["fused_decoder_bwd"] = (k_ms, p_ms), (kb_ms, pb_ms)
            library["fused_decoder_fwd"], library["fused_decoder_bwd"] = l_ms, lb_ms
            bounds["fused_decoder_fwd"], bounds["fused_decoder_bwd"] = b_fwd, b_bwd
    return main, library, bounds


def recurrence_bounds(model, cfg, dev, B: int = 8, T: int = 30,
                      roll: tuple[int, int] = (8, 30)) -> dict[str, dict]:
    """Bounds of the MRSSM recurrence kernels at ``B`` × ``T`` and of the
    rollout at ``roll`` (both the main path's B=8 T=30 by default), from one
    launch's inputs and outputs."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence, rollout

    C, K = cfg.class_size, cfg.category_size
    rng = np.random.default_rng(SEED + 13)
    rw = [w.detach() for w in model.representation_weights()]
    args = _recurrence_inputs(rng, B, T, cfg, dev)
    r_args = args if roll == (B, T) else _recurrence_inputs(rng, *roll, cfg, dev)
    with torch.no_grad():
        outs = recurrence.recurrence_forward_cuda(rw, *args, C, K)
        bwd = _backward_args(rw, args, outs, [torch.zeros_like(o) for o in outs], cfg)
        d_out = recurrence.recurrence_backward_cuda(*bwd)
        tw = rw[:12]
        actions = r_args[0].transpose(0, 1).contiguous()
        rolled = rollout.rollout_cuda(tw, actions, r_args[3], r_args[4], 5, C, K)
    macs = _mrssm_step_macs(cfg) * B * T
    return {"recurrence_fwd": _bound(2 * macs, _nbytes(rw, args, outs)),
            "recurrence_bwd": _bound(6 * macs, _nbytes(bwd[:7], d_out)),
            "rollout": _bound(2 * _mrssm_step_macs(cfg, heads=False) * roll[0] * roll[1],
                              _nbytes(tw, actions, r_args[3:5], rolled))}


def mt_bounds(model, cfg, dev, B: int = 8, T: int = 30,
              roll: tuple[int, int] = (8, 30)) -> dict[str, dict]:
    """Bounds of the MMTRSSM kernels, as :func:`recurrence_bounds`."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence_mt, rollout_mt

    rng = np.random.default_rng(SEED + 14)
    rw = [w.detach() for w in model.recurrence_weights()]
    xs, init6, gumbels = _mt_inputs(rng, B, T, cfg, dev)
    r_xs, r_init6, _ = (xs, init6, None) if roll == (B, T) else _mt_inputs(rng, *roll, cfg, dev)
    with torch.no_grad():
        outs = recurrence_mt.mt_recurrence_forward_cuda(rw, *xs, init6, gumbels, cfg.spec)
        prev6 = recurrence_mt.shift_carries(init6, recurrence_mt.carries(outs))
        cots = [torch.zeros_like(o) for o in outs]
        d_out = recurrence_mt.mt_recurrence_backward_cuda(rw, *xs, prev6, cots, cfg.spec)
        actions = r_xs[0].transpose(0, 1).contiguous()
        rolled = rollout_mt.rollout_mt_cuda(rw[:16], actions, r_init6, 5, cfg.spec)
    macs = _mt_step_macs(cfg) * B * T
    return {"mt_recurrence_fwd": _bound(2 * macs, _nbytes(rw, xs, init6, gumbels, outs)),
            "mt_recurrence_bwd": _bound(6 * macs, _nbytes(rw, xs, prev6, cots, d_out)),
            "mt_rollout": _bound(2 * _mt_step_macs(cfg, full=False) * roll[0] * roll[1],
                                 _nbytes(rw[:16], actions, r_init6, rolled))}


def other_bounds(name: str, shapes, bounds_fn) -> dict[str, dict]:
    """Bounds at shapes beyond the main path's, for the record only (not the
    kernels line): ``bounds_fn(B, T, roll)`` at each ``(B, T)`` of
    ``shapes``, the rollouts at B=256 T=180."""
    out = {}
    for B, T in shapes:
        for kernel, b in bounds_fn(B, T, (256, 180)).items():
            out[f"{kernel} " + ("B=256 T=180" if "rollout" in kernel else f"B={B} T={T}")] = b
    print(f"bounds of the {name} kernels beyond the main path's shapes: " + "; ".join(
        f"{k} {b['bound_ms']:.6f} ms ({b['bound_by']})" for k, b in out.items()))
    return out


def _timing_mode(run, sources=PTXAS_SOURCES) -> int:
    """A timing-only mode: ``run(dev, card)`` on the card with TF32 off,
    beside ``ptxas``'s report of ``sources``; no checks and no contract
    lines. For comparing kernels within one call, e.g. a parent archive and
    the change. Refuses to run without a card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ptxas = start_ptxas_report(sources)
    run(torch.device("cuda", 0), card)
    ptxas_report(ptxas, sources)
    return 0


BF16_SOURCES = ("fused_encoder_bf16_fwd.cu", "fused_encoder_bf16_bwd.cu")
BF16_RESULT = "bf16-encoder result "  # a --bf16-encoder-at turn's last line: its JSON


def mixed_step_times(model, dev, card: str) -> dict:
    """A train step of ``model`` (16-mixed) at B=8 T=30: its CUDA-event
    median, and under ``torch.profiler`` over 5 steps its device time a step
    and the bf16 encoder kernels' part of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from multimodal_mtrssm_tpu_torch.train import AdamW, one_update

    model.train()
    batch, _ = _train_batch(np.random.default_rng(SEED + 8), 8, 30, model)
    batch = tuple(x.to(dev) for x in batch)
    opt = AdamW(model.parameters())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step = lambda: one_update(model, opt, batch, gen)  # noqa: E731
    k_ms = _median_ms(step, 15, warmup=3)
    out = {"step_ms": k_ms, "device_ms": None, "bf16_encoder_ms": None}
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                step()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    except RuntimeError as e:
        print(f"16-mixed train step device time: not measured (torch.profiler failed: {e})")
        return out
    total = sum(_self_device_us(e) for e in events)
    enc = sum(_self_device_us(e) for e in events if "encoder_bf16" in e.key)
    if total > 0:
        out.update(device_ms=total / 5e3, bf16_encoder_ms=enc / 5e3)
    print(f"time {_label(model.cfg)} 16-mixed train step B=8 T=30: {k_ms:.4f} ms (CUDA events, "
          "median of 15); device "
          + ("not measured" if total == 0 else
             f"{total / 5e3:.4f} ms a step, the bf16 encoder kernels {enc / 5e3:.4f} ms") +
          f" (torch.profiler, 5 steps) | {card}")
    return out


def bf16_encoder_at(root: Path) -> int:
    """``--bf16-encoder-at ROOT``: one turn of ``--bf16-encoder`` on the
    package under ROOT, imported ahead of this tree's: ``bf16_encoder_timings``
    on MRSSM's audio encoder, then the 16-mixed ``fused_enc`` train step of
    ``configs/mopoe_mrssm.yaml`` and ``mopoe_mmtrssm.yaml`` (seeded weights),
    then the result as one JSON line."""
    sys.path.insert(0, str(root.resolve()))
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    if root.resolve() not in Path(build.__file__).resolve().parents:
        raise RuntimeError(f"--bf16-encoder-at {root}: imported {build.__file__} instead")

    def run(dev, card):
        import torch

        from multimodal_mtrssm_tpu_torch.models import MoPoEMRSSM, MRSSMConfig
        from multimodal_mtrssm_tpu_torch.train.config import load_experiment
        from multimodal_mtrssm_tpu_torch.train.entry import default_config_path

        build.load_library()
        print(f"build: {build.build_seconds:.2f} s ({build.library_path()})", flush=True)
        model = _seeded(MoPoEMRSSM, MRSSMConfig(), dev)
        with torch.no_grad():
            record = bf16_encoder_timings(model, dev, card)[3]
        steps = {}
        for family in ("mrssm", "mmtrssm"):
            torch.manual_seed(SEED)
            exp = load_experiment(default_config_path(f"mopoe_{family}.yaml"), {
                "trainer": {"precision": "16-mixed"},
                "model": {"init_args": {"conv_layout": "fused_enc"}}})
            steps[family] = mixed_step_times(exp.model.to(dev), dev, card)
        print(BF16_RESULT + json.dumps({"kernels": record, "steps": steps}), flush=True)

    return _timing_mode(run, ())


def bf16_encoder_phase(parent: Path | None = None) -> int:
    """``--bf16-encoder [PARENT]``: ``bf16_encoder_at`` on this tree, in a
    process of its own, beside ``ptxas``'s report of the bf16 sources; with
    PARENT (an unpacked ``git archive`` of another commit) in turns parent,
    this tree, this tree, parent, then each kernel's device time a call and
    each family's 16-mixed step against the parent's (means of the turns)."""
    here = Path(__file__).resolve().parent

    def run(dev, card):
        roots = [parent, here, here, parent] if parent is not None else [here]
        turns: dict[str, list[dict]] = {"parent": [], "change": []}
        for root in roots:
            label = "parent" if root == parent else "change"
            print(f"---- --bf16-encoder turn: {label} ({root})", flush=True)
            proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                     "--bf16-encoder-at", str(root)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            _CHILDREN.append(proc)
            result = None
            for line in proc.stdout:
                print(line, end="", flush=True)
                if line.startswith(BF16_RESULT):
                    result = json.loads(line[len(BF16_RESULT):])
            if proc.wait() != 0 or result is None:
                raise RuntimeError(f"--bf16-encoder-at {root} exited {proc.returncode}")
            turns[label].append(result)
        if parent is None:
            return

        def mean(label, get):
            vals = [get(r) for r in turns[label]]
            return None if None in vals else float(np.mean(vals))

        for N in turns["change"][0]["kernels"]:
            for kernel, key in (("fused_encoder_fwd_bf16", "fwd_device_ms"),
                                ("fused_encoder_bwd_bf16", "bwd_device_ms")):
                new = mean("change", lambda r: r["kernels"][N][key])
                old = mean("parent", lambda r: r["kernels"][N][key])
                ratio = "not measured" if None in (new, old) else f"{new / old:.4f}"
                print(f"{kernel} N={N}: device {new} ms a call (mean of 2 turns), parent {old} "
                      f"ms; change / parent {ratio} (limit 0.5) | {card}")
        for family in turns["change"][0]["steps"]:
            row = {label: {k: mean(label, lambda r: r["steps"][family][k])
                           for k in ("step_ms", "device_ms", "bf16_encoder_ms")}
                   for label in turns}
            print(f"{family} 16-mixed fused_enc train step B=8 T=30 (means of 2 turns): change "
                  f"{row['change']}, parent {row['parent']} | {card}")

    return _timing_mode(run, BF16_SOURCES)


# --bf16-encoder-stamps: clock64 stamps in a copy of the bf16 encoder
# kernels. Each edit is (source, anchor, replacement); a missing anchor
# fails the mode. Thread 0 of each block stamps the forward's and the
# cotangent pass's slices (when a slice's weights have arrived, when its
# products and epilogue are done) and each weight-gradient block's start
# and end, into __device__ arrays that dbg_* entry points copy out.
_STAMP_EDITS = [
    ("fused_encoder_bf16.cuh", "namespace fbf {\n\ntypedef",
     "namespace fbf {\n__device__ long long g_ft[4096][72];\n__device__ long long g_xt[4096][72];\n"
     "__device__ long long g_wt[16384][4];\ntypedef"),
    ("fused_encoder_bf16.cuh", "  Slice sl = make_slice(P, 0, 0, 0, 0, 0);\n",
     "  if (tid == 0 && blockIdx.x < 4096) g_ft[blockIdx.x][0] = clock64();\n"
     "  Slice sl = make_slice(P, 0, 0, 0, 0, 0);\n"),
    ("fused_encoder_bf16.cuh",
     "  __syncthreads();  // the mbarriers and the input map are in place\n",
     "  __syncthreads();  // the mbarriers and the input map are in place\n"
     "  if (tid == 0 && blockIdx.x < 4096) g_ft[blockIdx.x][1] = clock64();\n"),
    ("fused_encoder_bf16.cuh", "    fconv::mbar_wait(&bar[i & 1], (i >> 1) & 1);\n",
     "    fconv::mbar_wait(&bar[i & 1], (i >> 1) & 1);\n"
     "    if (tid == 0 && blockIdx.x < 4096 && i < 34) g_ft[blockIdx.x][2 + 2 * i] = clock64();\n"),
    ("fused_encoder_bf16.cuh", "slice i's buffer is free\n",
     "slice i's buffer is free\n"
     "    if (tid == 0 && blockIdx.x < 4096 && i < 34) g_ft[blockIdx.x][3 + 2 * i] = clock64();\n"),
    ("fused_encoder_bf16_bwd.cu", "    fconv::mbar_wait(&bar[i & 1], (i >> 1) & 1);\n",
     "    fconv::mbar_wait(&bar[i & 1], (i >> 1) & 1);\n"
     "    if (tid == 0 && blockIdx.x < 4096 && i < 34) g_xt[blockIdx.x][2 + 2 * i] = clock64();\n"),
    ("fused_encoder_bf16_bwd.cu", "slice i's buffer is free\n",
     "slice i's buffer is free\n"
     "    if (tid == 0 && blockIdx.x < 4096 && i < 34) g_xt[blockIdx.x][3 + 2 * i] = clock64();\n"),
    ("fused_encoder_bf16_bwd.cu",
     "  __syncthreads();  // the mbarriers and the head's cotangent are in place\n",
     "  __syncthreads();  // the mbarriers and the head's cotangent are in place\n"
     "  if (tid == 0 && blockIdx.x < 4096) g_xt[blockIdx.x][1] = clock64();\n"),
    ("fused_encoder_bf16_bwd.cu", "  const int z = blockIdx.z;\n",
     "  const long long t_start = clock64();\n  const int z = blockIdx.z;\n"),
    ("fused_encoder_bf16_bwd.cu",
     "  // Splits 1.. S-1 hand their sums to split 0 through the staging buffers.",
     "  const int wb = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;\n"
     "  if (tid == 0 && wb < 16384) {\n    g_wt[wb][0] = t_start;\n    g_wt[wb][1] = clock64();\n"
     "    g_wt[wb][2] = l;\n    g_wt[wb][3] = stages;\n  }\n"
     "  // Splits 1.. S-1 hand their sums to split 0 through the staging buffers."),
]
_STAMP_COPY = "  return (int)cudaMemcpyFromSymbol(out, fbf::{0}, sizeof(fbf::{0}));\n"
_STAMP_ENTRIES = {
    "fused_encoder_bf16_fwd.cu": 'extern "C" int dbg_fwd_stamps(void* out) {\n'
                                 + _STAMP_COPY.format("g_ft") + "}\n",
    "fused_encoder_bf16_bwd.cu": 'extern "C" int dbg_bwd_stamps(void* out, int which) {\n'
                                 "  if (which == 1)\n" + _STAMP_COPY.format("g_xt")
                                 + _STAMP_COPY.format("g_wt") + "}\n"}
# The forward's variants: its HMMAs, or its ldmatrix loads, left out (its
# outputs then mean nothing; its time does).
_STAMP_VARIANTS = {
    "kernels": [],
    "forward without its HMMAs": [
        ("fused_encoder_bf16.cuh", f"        mma({a}, {f}, {b}[0], {b}[1]);\n"
         f"        mma({a} + 4, {f}, {b}[2], {b}[3]);\n", "")
        for a, f, b in (("a8", "af", "bfr"), ("b8", "an", "bn"))],
    "forward without its ldmatrix loads": [
        ("fused_encoder_bf16.cuh",
         f"          ldsm4({f}, ap + cs * astep);\n          ldsm4({b}, bp);\n",
         f"          for (int e = 0; e < 4; ++e) {{ {f}[e] = ap + cs * astep + e; "
         f"{b}[e] = bp + e; }}\n")
        for f, b in (("an", "bn"), ("af", "bfr"))],
}


def _stamped_copy(dst: Path, variant: str) -> None:
    """This tree's port package and configs copied under ``dst``, its bf16
    encoder kernels stamped (``_STAMP_EDITS``) with ``variant``'s edits."""
    import shutil

    here = Path(__file__).resolve().parent
    shutil.copytree(here / "multimodal_mtrssm_tpu_torch", dst / "multimodal_mtrssm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(here / "configs", dst / "configs")
    csrc = dst / "multimodal_mtrssm_tpu_torch" / "csrc"
    for name, old, new in _STAMP_EDITS + _STAMP_VARIANTS[variant]:
        text = (csrc / name).read_text()
        if old not in text:
            raise RuntimeError(f"--bf16-encoder-stamps: {name} lacks {old[:60]!r}")
        (csrc / name).write_text(text.replace(old, new, 1))
    for name, entry in _STAMP_ENTRIES.items():
        (csrc / name).write_text((csrc / name).read_text() + entry)


def bf16_stamps_at(root: Path) -> int:
    """``--bf16-encoder-stamps-at ROOT``: the stamped kernels under ROOT at
    N=240 and 3840 on MRSSM's audio encoder: CUDA-event ms of 10 calls in a
    row, each slice's mean cycles (weights' arrival, then products and
    epilogue) over the blocks of a forward and of a cotangent pass, each
    layer's weight-gradient blocks' cycles."""
    import ctypes

    sys.path.insert(0, str(root.resolve()))
    from multimodal_mtrssm_tpu_torch.ops.kernels import build, fused_conv

    if root.resolve() not in Path(build.__file__).resolve().parents:
        raise RuntimeError(f"--bf16-encoder-stamps-at {root}: imported {build.__file__} instead")

    def run(dev, card):
        import torch

        from multimodal_mtrssm_tpu_torch.models import MoPoEMRSSM, MRSSMConfig

        lib = build.load_library()
        lib.dbg_fwd_stamps.argtypes = [ctypes.c_void_p]
        lib.dbg_bwd_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        enc = _seeded(MoPoEMRSSM, MRSSMConfig(), dev).audio_encoder
        w = [t.detach().to(torch.bfloat16) for t in fused_conv.encoder_weights(enc)]

        def slices(buf, nb, what):
            t = buf[:nb].astype(np.float64)
            n = 0
            while n < 34 and np.all(t[:, 2 + 2 * n] > 0):
                n += 1
            wait = [np.mean(t[:, 2 + 2 * i] - t[:, 1 + 2 * i]) for i in range(n)]
            comp = [np.mean(t[:, 3 + 2 * i] - t[:, 2 + 2 * i]) for i in range(n)]
            print(f"  {what}, cycles a slice (mean over {nb} blocks), weights' wait: "
                  + " ".join(f"{v:.0f}" for v in wait))
            print(f"  {what}, cycles a slice, products and epilogue: "
                  + " ".join(f"{v:.0f}" for v in comp))

        for N in (240, 3840):
            rng = np.random.default_rng(N)
            x = torch.tensor(rng.uniform(-1, 1, (N, 32, 32, 1)).astype(np.float32),
                             device=dev).to(torch.bfloat16)
            g = torch.tensor(rng.standard_normal((N, enc.cfg.out_dim)).astype(np.float32),
                             device=dev).to(torch.bfloat16)
            fwd = lambda: fused_conv.fused_encoder_bf16_forward_cuda(w, enc.cfg, x)  # noqa: E731
            bwd = lambda: fused_conv.fused_encoder_bf16_backward_cuda(  # noqa: E731
                w, enc.cfg, x, g, False)
            with torch.no_grad():
                ms = [_median_ms(f, 10) for f in (fwd, bwd)]
                print(f"stamped N={N}: forward call {ms[0]:.4f} ms, backward call {ms[1]:.4f} ms "
                      f"(CUDA events) | {card}")
                nb = min(4096, -(-N // fused_conv.bf16_sizes(
                    lib, fused_conv._dims(enc.cfg, N))["fwd_frames"]))
                fwd()
                torch.cuda.synchronize()
                buf = np.zeros((4096, 72), np.int64)
                build.check(lib.dbg_fwd_stamps(buf.ctypes.data))
                slices(buf, nb, "forward")
                bwd()
                torch.cuda.synchronize()
                build.check(lib.dbg_bwd_stamps(buf.ctypes.data, 1))
                slices(buf, nb, "cotangent pass")
                wt = np.zeros((16384, 4), np.int64)
                build.check(lib.dbg_bwd_stamps(wt.ctypes.data, 2))
                wt = wt[wt[:, 1] > 0]
                for layer in sorted(set(wt[:, 2])):
                    r = wt[wt[:, 2] == layer]
                    d = (r[:, 1] - r[:, 0]).astype(np.float64)
                    print(f"  weight-gradient pass layer {layer}: {len(r)} blocks, cycles mean "
                          f"{d.mean():.0f} max {d.max():.0f}, {r[0, 3]} stages a block")

    return _timing_mode(run, ())


def bf16_stamps_phase() -> int:
    """``--bf16-encoder-stamps``: ``bf16_stamps_at`` on each variant of
    ``_STAMP_VARIANTS``, a stamped copy of this tree's kernels each (under a
    temporary directory), each in a process of its own."""

    def run(dev, card):
        for variant in _STAMP_VARIANTS:
            with tempfile.TemporaryDirectory() as tmp:
                _stamped_copy(Path(tmp), variant)
                print(f"---- --bf16-encoder-stamps: {variant}", flush=True)
                proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                                       "--bf16-encoder-stamps-at", tmp], check=False)
                if proc.returncode != 0:
                    raise RuntimeError(f"--bf16-encoder-stamps-at ({variant}) exited "
                                       f"{proc.returncode}")

    return _timing_mode(run, ())


# --bf16-decoder: the bf16 fused decoder kernels, this tree's and a parent's.
DEC_BF16_SOURCES = ("fused_decoder_bf16_fwd.cu", "fused_decoder_bf16_bwd.cu")
DEC_BF16_RESULT = "bf16-decoder result "  # a --bf16-decoder-at turn's last line: its JSON
DEC_BF16_FRAMES = (240, 3840)


def _dec_bf16_kernel_names() -> tuple[dict[str, str], dict[str, str]]:
    """The bf16 decoder's forward and backward kernels as the imported
    package names them: this tree's, or those of the first bf16 decoder
    (the f32 decoder's kernels at bf16, in an archive timed by
    ``--bf16-decoder``)."""
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    src = (build.CSRC / "fused_decoder_bf16_bwd.cu").read_text()
    if DECODER_BF16_BWD_KERNELS["cotangent pass"] in src:
        return DECODER_BF16_FWD_KERNELS, DECODER_BF16_BWD_KERNELS
    return DECODER_FWD_KERNELS, DECODER_BF16_BWD_KERNELS_FIRST


def bf16_decoder_at(root: Path) -> int:
    """``--bf16-decoder-at ROOT``: one turn of ``--bf16-decoder`` on the
    package under ROOT, imported ahead of this tree's: the bf16 decoder
    kernels on the MRSSM and MMTRSSM vision decoders (48- and 96-wide
    features, seeded weights, numpy features and cotangent) at N=240 and
    3840: CUDA-event ms a forward and a backward call, each kernel's device
    ms a call (``torch.profiler``), and the cuDNN ``Decoder`` on the same
    bf16 features (forward, and forward + backward to the features and
    every parameter; CUDA-event and device ms); then the result as one JSON
    line."""
    sys.path.insert(0, str(root.resolve()))
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    if root.resolve() not in Path(build.__file__).resolve().parents:
        raise RuntimeError(f"--bf16-decoder-at {root}: imported {build.__file__} instead")

    def run(dev, card):
        import torch

        from multimodal_mtrssm_tpu_torch.models import (
            MMTRSSMConfig,
            MoPoEMMTRSSM,
            MoPoEMRSSM,
            MRSSMConfig,
        )
        from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv

        build.load_library()
        print(f"build: {build.build_seconds:.2f} s ({build.library_path()})", flush=True)
        fwd_names, bwd_names = _dec_bf16_kernel_names()
        record: dict[str, dict] = {}
        for family, cfg in ((MoPoEMRSSM, MRSSMConfig()), (MoPoEMMTRSSM, MMTRSSMConfig())):
            dec = _seeded(family, cfg, dev).vision_decoder
            w = [t.detach().to(torch.bfloat16) for t in fused_conv.decoder_weights(dec)]
            params = list(dec.parameters())
            for N in DEC_BF16_FRAMES:
                rng = np.random.default_rng(N)
                x = torch.tensor(rng.standard_normal((N, dec.cfg.in_features)).astype(np.float32),
                                 device=dev).to(torch.bfloat16)
                g = torch.tensor(rng.standard_normal((N, 32, 32, 1)).astype(np.float32),
                                 device=dev).to(torch.bfloat16)
                fwd = lambda: fused_conv.fused_decoder_bf16_forward_cuda(  # noqa: E731
                    w, dec.cfg, x)
                bwd = lambda: fused_conv.fused_decoder_bf16_backward_cuda(  # noqa: E731
                    w, dec.cfg, x, g, True)
                xg = x.clone().requires_grad_()
                lib_fb = lambda: torch.autograd.grad(dec(xg), [xg, *params], g)  # noqa: E731
                with torch.no_grad():
                    k_ms, kb_ms = _median_ms(fwd, 20), _median_ms(bwd, 10)
                    l_ms = _median_ms(lambda: dec(x), 20)
                    fparts = _device_breakdown(fwd, tuple(fwd_names.values()))
                    bparts = _device_breakdown(bwd, tuple(bwd_names.values()))
                    l_dev = _device_breakdown(lambda: dec(x), ("",))[""]
                with torch.enable_grad():
                    lb_ms = _median_ms(lib_fb, 10)
                    lb_dev = _device_breakdown(lib_fb, ("",))[""]
                what = f"{_label(cfg)} N={N} F={dec.cfg.in_features}"
                _print_breakdown(f"fused_decoder_fwd_bf16 {what}", fparts, fwd_names, card)
                _print_breakdown(f"fused_decoder_bwd_bf16 {what}", bparts, bwd_names, card)
                fseen = [v for v in fparts.values() if v is not None]
                bseen = [v for v in bparts.values() if v is not None]
                record[what] = {
                    "fwd_ms": k_ms, "bwd_ms": kb_ms,
                    "fwd_device_ms": sum(fseen) if fseen else None,
                    "bwd_device_ms": sum(bseen) if bseen else None,
                    "fwd_parts": {k: fparts[v] for k, v in fwd_names.items()},
                    "bwd_parts": {k: bparts[v] for k, v in bwd_names.items()},
                    "cudnn_fwd_ms": l_ms, "cudnn_fwd_device_ms": l_dev,
                    "cudnn_fwd_bwd_ms": lb_ms, "cudnn_fwd_bwd_device_ms": lb_dev}
                print(f"time bf16 decoder {what}: forward call {k_ms:.4f} ms, backward call "
                      f"{kb_ms:.4f} ms (CUDA events); cuDNN Decoder on bf16 features forward "
                      f"{l_ms:.4f} ms (device {l_dev}), forward + backward {lb_ms:.4f} ms "
                      f"(device {lb_dev}) | {card}", flush=True)
        print(DEC_BF16_RESULT + json.dumps(record), flush=True)

    return _timing_mode(run, ())


def bf16_decoder_phase(parent: Path | None = None) -> int:
    """``--bf16-decoder [PARENT]``: ``bf16_decoder_at`` on this tree, in a
    process of its own, beside ``ptxas``'s report of the bf16 decoder's
    sources and the tensor-core instructions of its kernels
    (``hmma_report``); with PARENT (an unpacked ``git archive`` of another
    commit) in turns parent, this tree, this tree, parent, then each pass's
    device ms a call against the parent's and cuDNN's (means of the
    turns)."""
    here = Path(__file__).resolve().parent

    def run(dev, card):
        from multimodal_mtrssm_tpu_torch.ops.kernels import build

        roots = [parent, here, here, parent] if parent is not None else [here]
        turns: dict[str, list[dict]] = {"parent": [], "change": []}
        for root in roots:
            label = "parent" if root == parent else "change"
            print(f"---- --bf16-decoder turn: {label} ({root})", flush=True)
            proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()),
                                     "--bf16-decoder-at", str(root)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            _CHILDREN.append(proc)
            result = None
            for line in proc.stdout:
                print(line, end="", flush=True)
                if line.startswith(DEC_BF16_RESULT):
                    result = json.loads(line[len(DEC_BF16_RESULT):])
            if proc.wait() != 0 or result is None:
                raise RuntimeError(f"--bf16-decoder-at {root} exited {proc.returncode}")
            turns[label].append(result)
        build.load_library()
        hmma_report(DECODER_BF16_HMMA)

        def mean(label, get):
            vals = [get(r) for r in turns[label]]
            return None if not vals or None in vals else float(np.mean(vals))

        for what in turns["change"][0]:
            for key in ("fwd", "bwd"):
                row = {label: mean(label, lambda r: r[what][f"{key}_device_ms"])
                       for label in turns}
                calls = {label: mean(label, lambda r: r[what][f"{key}_ms"]) for label in turns}
                lib = "cudnn_fwd" if key == "fwd" else "cudnn_fwd_bwd"
                cudnn = {label: mean(label, lambda r: r[what][f"{lib}_ms"]) for label in turns}
                ratio = ("not measured" if None in row.values() else
                         f"{row['change'] / row['parent']:.4f}")
                print(f"fused_decoder_{key}_bf16 {what}: device {row['change']} ms a call, call "
                      f"{calls['change']} ms (means of the turns); parent device {row['parent']}, "
                      f"call {calls['parent']}; change / parent {ratio}; cuDNN Decoder "
                      f"{'forward' if key == 'fwd' else 'forward + backward'} {cudnn} ms | "
                      f"{card}")

    return _timing_mode(run, DEC_BF16_SOURCES)


def bf16_decoder_once() -> int:
    """``--bf16-decoder-once``: each bf16 decoder kernel once at N=3 on the
    MRSSM vision decoder (seeded weights, numpy features and cotangent),
    synchronised: the program ``--bf16-decoder-racecheck`` hands
    compute-sanitizer. Refuses to run without a card."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    from multimodal_mtrssm_tpu_torch.models import MoPoEMRSSM, MRSSMConfig
    from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv

    dev = torch.device("cuda", 0)
    dec = _seeded(MoPoEMRSSM, MRSSMConfig(), dev).vision_decoder
    w = [t.detach().to(torch.bfloat16) for t in fused_conv.decoder_weights(dec)]
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((3, dec.cfg.in_features)).astype(np.float32),
                     device=dev).to(torch.bfloat16)
    g = torch.tensor(rng.standard_normal((3, 32, 32, 1)).astype(np.float32),
                     device=dev).to(torch.bfloat16)
    with torch.no_grad():
        fused_conv.fused_decoder_bf16_forward_cuda(w, dec.cfg, x)
        fused_conv.fused_decoder_bf16_backward_cuda(w, dec.cfg, x, g, True)
    torch.cuda.synchronize()
    print("bf16 decoder kernels launched once each at N=3")
    return 0


def bf16_decoder_racecheck() -> int:
    """``--bf16-decoder-racecheck``: compute-sanitizer's racecheck and
    synccheck over ``--bf16-decoder-once`` (the bf16 decoder kernels'
    shared-memory double buffers and barriers), each tool's report lines
    printed; non-zero where the toolkit lacks the tool or a tool exits
    non-zero (a hazard, or a device the tool refuses)."""
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    tool = Path(build.nvcc()).parent / "compute-sanitizer"
    if not tool.is_file():
        print(f"compute-sanitizer: not shipped ({tool})")
        return 1
    code = 0
    for name, extra in (("racecheck", ["--racecheck-report", "all"]), ("synccheck", [])):
        proc = subprocess.run([str(tool), "--tool", name, *extra, sys.executable,
                               str(Path(__file__).resolve()), "--bf16-decoder-once"],
                              capture_output=True, text=True, timeout=900, check=False)
        lines = [ln.strip("= ") for ln in (proc.stdout + proc.stderr).splitlines()
                 if ln.startswith("=========") and ln.strip("= ")]
        print(f"compute-sanitizer --tool {name} over --bf16-decoder-once: exit "
              f"{proc.returncode}; " + " | ".join(lines[-6:]))
        code = code or proc.returncode
    return code


# The kernels hmma_report looks for: the bf16 decoder's forward, cotangent
# and weight-gradient passes, and the bf16 encoder's.
DECODER_BF16_HMMA = ("decoder_bf16_tc_fwd_kernel", "decoder_bf16_tc_dx_kernel",
                     "decoder_bf16_tc_dw_kernel")
ENCODER_BF16_HMMA = ("encoder_bf16_tc_fwd_kernel", "encoder_bf16_tc_dx_kernel",
                     "encoder_bf16_tc_dw_kernel")


def hmma_report(kernels) -> dict[str, int | None]:
    """The bf16 tensor-core instructions (``HMMA.16816.F32.BF16``) in each
    of ``kernels`` (substrings of their mangled names) in the built
    library's SASS (``cuobjdump -sass``), printed; None for each where
    ``cuobjdump`` is missing or fails (a measurement: "not measured")."""
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    counts: dict[str, int | None] = dict.fromkeys(kernels)
    tool = Path(build.nvcc()).parent / "cuobjdump"
    try:
        sass = subprocess.run([str(tool), "-sass", str(build.library_path())],
                              capture_output=True, text=True, timeout=300, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        print(f"cuobjdump -sass: not measured ({e})")
        return counts
    counts = dict.fromkeys(kernels, 0)
    current = None
    for line in sass.splitlines():
        if "Function : " in line:
            current = next((k for k in kernels if k in line), None)
        elif current is not None and "HMMA.16816.F32.BF16" in line:
            counts[current] += 1
    print("cuobjdump -sass, HMMA.16816.F32.BF16 instructions (every instantiation): "
          + ", ".join(f"{k} {v}" for k, v in counts.items()))
    return counts


# --bf16-decoder-stamps: global-timer stamps (ns, comparable across SMs) in a
# copy of the bf16 decoder kernels. Each edit is (source, anchor,
# replacement); a missing anchor fails the mode. Thread 0 stamps: in blocks
# 100-107 of the forward, each slice's wait for its weights and its products
# and epilogue; in the first 4096 blocks of the cotangent pass, each slice's
# start; in every weight-gradient block its start, end, layer, class and
# stages, and in chunk 0's blocks each stage's load issue, wait and
# products.
_DEC_STAMP_GTIME = ("__device__ __forceinline__ long long gtime() { long long t; "
                    "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); return t; }\n")
_DEC_STAMP_EDITS = [
    ("fused_decoder_bf16.cuh", "namespace fdbf {\n\nusing namespace bmma;\n",
     "namespace fdbf {\n\nusing namespace bmma;\n__device__ long long g_fw[8][128][3];\n"
     "__device__ int g_fwl[128];\n__device__ long long g_dw[65536][5];\n"
     "__device__ long long g_st[128][192];\n__device__ long long g_dx[4096][128];\n"
     "__device__ int g_dxl[128];\n" + _DEC_STAMP_GTIME),
    ("fused_decoder_bf16.cuh", "    fconv::mbar_wait(&bar[i & 1], (i >> 1) & 1);\n\n    int cls;\n",
     "    long long* fw = tid == 0 && blockIdx.x >= 100 && blockIdx.x < 108 && i < 128\n"
     "                        ? g_fw[blockIdx.x - 100][i] : nullptr;\n"
     "    if (fw) fw[0] = gtime();\n    fconv::mbar_wait(&bar[i & 1], (i >> 1) & 1);\n"
     "    if (fw) { fw[1] = gtime(); g_fwl[i] = sl.layer; }\n\n    int cls;\n"),
    ("fused_decoder_bf16.cuh", "    schedule(sl, tasks, acc, red, run, emit);\n    __syncthreads();  "
     "// the GEMM's outputs",
     "    schedule(sl, tasks, acc, red, run, emit);\n    if (fw) fw[2] = gtime();\n"
     "    __syncthreads();  // the GEMM's outputs"),
    ("fused_decoder_bf16_bwd.cu",
     "    fconv::mbar_wait(&bar[i & 1], (i >> 1) & 1);\n\n    const int l = sl.layer;\n",
     "    fconv::mbar_wait(&bar[i & 1], (i >> 1) & 1);\n"
     "    if (tid == 0 && blockIdx.x < 4096 && i < 127) {\n      g_dx[blockIdx.x][i] = gtime();\n"
     "      if (blockIdx.x == 0) g_dxl[i] = sl.layer;\n    }\n\n    const int l = sl.layer;\n"),
    ("fused_decoder_bf16_bwd.cu", "    sl = next_slice(P, 1, sl, stop);\n  }\n}\n",
     "    sl = next_slice(P, 1, sl, stop);\n  }\n"
     "  if (tid == 0 && blockIdx.x < 4096) g_dx[blockIdx.x][127] = gtime();\n}\n"),
    ("fused_decoder_bf16_bwd.cu",
     "  const Plan& P = shared_plan(Pp, sP);\n  bf16* zero = reinterpret_cast<bf16*>(smem);\n",
     "  const Plan& P = shared_plan(Pp, sP);\n  const long long t_start = gtime();\n"
     "  bf16* zero = reinterpret_cast<bf16*>(smem);\n"),
    ("fused_decoder_bf16_bwd.cu", "  load(0);\n  for (int st = 0; st < stages; ++st) {\n"
     "    if (st + 1 < stages) {\n      load(st + 1);\n",
     "  long long* stp = chunk_i == 0 && tid == 0 && tile < 128 ? g_st[tile] : nullptr;\n"
     "  load(0);\n  for (int st = 0; st < stages; ++st) {\n    const long long ta = gtime();\n"
     "    if (st + 1 < stages) {\n      load(st + 1);\n"
     "      if (stp && st < 64) stp[3 * st] = gtime() - ta;\n"),
    ("fused_decoder_bf16_bwd.cu", "    __syncthreads();  // stage st is in place\n",
     "    __syncthreads();  // stage st is in place\n"
     "    if (stp && st < 64) stp[3 * st + 1] = gtime() - ta;\n"),
    ("fused_decoder_bf16_bwd.cu", "    __syncthreads();  // stage st's buffer is free for stage st + 2\n",
     "    if (stp && st < 64) stp[3 * st + 2] = gtime() - ta;\n"
     "    __syncthreads();  // stage st's buffer is free for stage st + 2\n"),
    ("fused_decoder_bf16_bwd.cu", "  if (split != 0) return;\n  // Gradient elements",
     "  if (tid == 0 && blockIdx.y * gridDim.x + blockIdx.x < 65536) {\n"
     "    long long* r = g_dw[blockIdx.y * gridDim.x + blockIdx.x];\n"
     "    r[0] = t_start;\n    r[1] = gtime();\n    r[2] = l;\n    r[3] = rows ? cls : 4;\n"
     "    r[4] = stages;\n  }\n  if (split != 0) return;\n  // Gradient elements"),
]
# Each source's own copy of the arrays (a __device__ array in a header is one
# a translation unit): the forward's from fused_decoder_bf16_fwd.cu, the
# backward passes' from fused_decoder_bf16_bwd.cu. Array `which` of
# _DEC_STAMP_ARRAYS into `out`.
_DEC_STAMP_ARRAYS = ("g_fw", "g_fwl", "g_dw", "g_st", "g_dx", "g_dxl")
_DEC_STAMP_ENTRIES = {
    src: (f'extern "C" int dbg_dec_stamps_{tag}(int which, void* out) {{\n'
          + "".join(f"  if (which == {i}) return (int)cudaMemcpyFromSymbol(out, fdbf::{v}, "
                    f"sizeof(fdbf::{v}));\n" for i, v in enumerate(_DEC_STAMP_ARRAYS))
          + "  return -1;\n}\n")
    for src, tag in (("fused_decoder_bf16_fwd.cu", "fwd"), ("fused_decoder_bf16_bwd.cu", "bwd"))}


def _dec_stamped_copy(dst: Path) -> None:
    """This tree's port package and configs copied under ``dst``, its bf16
    decoder kernels stamped (``_DEC_STAMP_EDITS``)."""
    import shutil

    here = Path(__file__).resolve().parent
    shutil.copytree(here / "multimodal_mtrssm_tpu_torch", dst / "multimodal_mtrssm_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(here / "configs", dst / "configs")
    csrc = dst / "multimodal_mtrssm_tpu_torch" / "csrc"
    for name, old, new in _DEC_STAMP_EDITS:
        text = (csrc / name).read_text()
        if old not in text:
            raise RuntimeError(f"--bf16-decoder-stamps: {name} lacks {old[:60]!r}")
        (csrc / name).write_text(text.replace(old, new, 1))
    for name, entry in _DEC_STAMP_ENTRIES.items():
        (csrc / name).write_text((csrc / name).read_text() + entry)


def bf16_decoder_stamps_at(root: Path) -> int:
    """``--bf16-decoder-stamps-at ROOT``: the stamped kernels under ROOT on
    the MRSSM vision decoder at N=3840 (and the forward's at N=240): a
    forward's slices (weights' wait, products and epilogue, by GEMM), the
    cotangent pass's µs a block by layer, the weight-gradient blocks by
    layer and class (count, µs mean and max, stages, the span), and chunk
    0's stages (load issue, wait, products) by layer."""
    import ctypes
    from collections import defaultdict

    sys.path.insert(0, str(root.resolve()))
    from multimodal_mtrssm_tpu_torch.ops.kernels import build, fused_conv

    if root.resolve() not in Path(build.__file__).resolve().parents:
        raise RuntimeError(f"--bf16-decoder-stamps-at {root}: imported {build.__file__} instead")

    def run(dev, card):
        import torch

        from multimodal_mtrssm_tpu_torch.models import MoPoEMRSSM, MRSSMConfig

        lib = build.load_library()
        for tag in ("fwd", "bwd"):
            getattr(lib, f"dbg_dec_stamps_{tag}").argtypes = [ctypes.c_int, ctypes.c_void_p]

        def read(name, shape, dtype=np.int64):
            buf = np.zeros(shape, dtype)
            tag = "fwd" if name.startswith("g_fw") else "bwd"
            build.check(getattr(lib, f"dbg_dec_stamps_{tag}")(_DEC_STAMP_ARRAYS.index(name),
                                                                buf.ctypes.data))
            return buf

        dec = _seeded(MoPoEMRSSM, MRSSMConfig(), dev).vision_decoder
        w = [t.detach().to(torch.bfloat16) for t in fused_conv.decoder_weights(dec)]
        dims = fused_conv._dec_dims(dec.cfg, 3840)
        for N in (240, 3840):
            rng = np.random.default_rng(N)
            x = torch.tensor(rng.standard_normal((N, dec.cfg.in_features)).astype(np.float32),
                             device=dev).to(torch.bfloat16)
            g = torch.tensor(rng.standard_normal((N, 32, 32, 1)).astype(np.float32),
                             device=dev).to(torch.bfloat16)
            with torch.no_grad():
                for _ in range(3):
                    fused_conv.fused_decoder_bf16_forward_cuda(w, dec.cfg, x)
                torch.cuda.synchronize()
                fw, fwl = read("g_fw", (8, 128, 3)), read("g_fwl", 128, np.int32)
                n = int((fw[0, :, 2] > 0).sum())
                wait, work = (fw[:, :n, 1] - fw[:, :n, 0]) / 1e3, (fw[:, :n, 2] - fw[:, :n, 1]) / 1e3
                per: dict = defaultdict(lambda: [0, 0.0, 0.0])
                for i in range(n):
                    v = per[int(fwl[i])]
                    v[0] += 1
                    v[1] += float(wait[:, i].mean())
                    v[2] += float(work[:, i].mean())
                print(f"stamped forward N={N}, blocks 100-107: {n} slices, a block "
                      f"{float(((fw[:, n - 1, 2] - fw[:, 0, 0]) / 1e3).mean()):.1f} us: weights' "
                      f"wait {float(wait.mean(0).sum()):.1f}, products and epilogue "
                      f"{float(work.mean(0).sum()):.1f}; by GEMM (slices, wait, work us): "
                      + ", ".join(f"{k}: {v[0]}, {v[1]:.1f}, {v[2]:.1f}"
                                  for k, v in sorted(per.items())) + f" | {card}")
                if N != 3840:
                    continue
                for _ in range(3):
                    fused_conv.fused_decoder_bf16_backward_cuda(w, dec.cfg, x, g, True)
                torch.cuda.synchronize()
            dx, dxl = read("g_dx", (4096, 128)), read("g_dxl", 128, np.int32)
            nb = min(4096, -(-N // 2))
            ns = int(np.argmax(dx[0, :127] == 0)) if (dx[0, :127] == 0).any() else 127
            by: dict = defaultdict(float)
            for i in range(ns):
                nxt = dx[:nb, i + 1] if i + 1 < ns else dx[:nb, 127]
                by[int(dxl[i])] += float(np.mean(nxt - dx[:nb, i])) / 1e3
            print(f"stamped cotangent pass N={N}: {ns} slices, a block "
                  f"{float(np.mean(dx[:nb, 127] - dx[:nb, 0])) / 1e3:.1f} us, span "
                  f"{(dx[:nb, 127].max() - dx[:nb, 0].min()) / 1e3:.1f} us; us a block by layer: "
                  + ", ".join(f"{k} {v:.1f}" for k, v in sorted(by.items())) + f" | {card}")
            dw = read("g_dw", (65536, 5))
            dw = dw[dw[:, 1] > 0]
            t0 = dw[:, 0].min()
            print(f"stamped weight-gradient pass N={N}: {len(dw)} blocks, span "
                  f"{(dw[:, 1].max() - t0) / 1e3:.1f} us | {card}")
            for (layer, cls) in sorted({(int(r[2]), int(r[3])) for r in dw}):
                rs = dw[(dw[:, 2] == layer) & (dw[:, 3] == cls)]
                d = (rs[:, 1] - rs[:, 0]) / 1e3
                print(f"  layer {layer} {'bias' if cls == 4 else f'class {cls}'}: {len(rs)} "
                      f"blocks, us mean {d.mean():.1f} max {d.max():.1f}, {rs[0, 4]} stages")
            st = read("g_st", (128, 192)).reshape(128, 64, 3)
            print("  chunk 0's stages by tile, ns mean: load issue, + wait, + products")
            for t in range(fused_conv.bf16_sizes(lib, dims)["dw_tiles"]):
                k = int((st[t, :, 2] > 0).sum())
                if k:
                    print(f"    tile {t}: {k} stages, {st[t, :k, 0].mean():.0f}, "
                          f"{st[t, :k, 1].mean():.0f}, {st[t, :k, 2].mean():.0f}")

    return _timing_mode(run, ())


def bf16_decoder_stamps_phase() -> int:
    """``--bf16-decoder-stamps``: ``bf16_decoder_stamps_at`` on a stamped copy
    of this tree's kernels (under a temporary directory), in a process of
    its own."""

    def run(dev, card):
        with tempfile.TemporaryDirectory() as tmp:
            _dec_stamped_copy(Path(tmp))
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                                   "--bf16-decoder-stamps-at", tmp], check=False)
            if proc.returncode != 0:
                raise RuntimeError(f"--bf16-decoder-stamps-at exited {proc.returncode}")

    return _timing_mode(run, ())


def _seeded(family, cfg, dev):
    """``family(cfg)`` with seeded random weights on ``dev``, in eval mode."""
    import torch

    return family(cfg).init(torch.Generator().manual_seed(0)).to(dev).eval()


def decoder_phase() -> int:
    """``--decoder``: only the fused decoder's timings and device breakdowns
    (``decoder_timings``) on MRSSM's audio decoder over observed features
    at N=240 and 3840."""
    import torch

    from multimodal_mtrssm_tpu_torch.models import MoPoEMRSSM, MRSSMConfig

    def run(dev, card):
        cfg = MRSSMConfig()
        model = _seeded(MoPoEMRSSM, cfg, dev)
        with torch.no_grad():
            cases = [{"model": model, "label": _label(cfg),
                      "feats": _observed_features(model, cfg, dev, B, T)[1]}
                     for B, T in DECODER_SHAPES]
            decoder_timings(cases, dev, card)

    return _timing_mode(run)


def recurrence_bwd_phase() -> int:
    """``--recurrence-bwd``: only the MRSSM recurrence backward's timings and
    per-kernel device times (``bwd_timings``) and ``ptxas``'s report of its
    source."""
    from multimodal_mtrssm_tpu_torch.models import MoPoEMRSSM, MRSSMConfig

    cfg = MRSSMConfig()
    return _timing_mode(lambda dev, card: bwd_timings(_seeded(MoPoEMRSSM, cfg, dev), cfg, dev,
                                                      card), ("recurrence_bwd.cu",))


def mt_recurrence_bwd_phase() -> int:
    """``--mt-recurrence-bwd``: only the MMTRSSM recurrence backward's call
    times and per-kernel device times (``mt_bwd_timings``, no plain timing)
    and ``ptxas``'s report of its source."""
    from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig, MoPoEMMTRSSM

    cfg = MMTRSSMConfig()
    return _timing_mode(lambda dev, card: mt_bwd_timings(_seeded(MoPoEMMTRSSM, cfg, dev), cfg,
                                                         dev, card, plain=False),
                        ("recurrence_mt_bwd.cu",))


def mt_recurrence_fwd_phase() -> int:
    """``--mt-recurrence-fwd``: only the MMTRSSM recurrence forward's call
    times, device times and stages (``mt_fwd_timings``) and ``ptxas``'s
    report of its source."""
    from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig, MoPoEMMTRSSM

    cfg = MMTRSSMConfig()
    return _timing_mode(lambda dev, card: mt_fwd_timings(_seeded(MoPoEMMTRSSM, cfg, dev), cfg,
                                                         dev, card), ("recurrence_mt_fwd.cu",))


def recurrence_fwd_phase() -> int:
    """``--recurrence-fwd``: only the MRSSM recurrence forward's and the
    stacked forward's call times, device times and stages
    (``rec_fwd_timings``) and ``ptxas``'s report of the forward's source."""
    from multimodal_mtrssm_tpu_torch.models import MoPoEMRSSM, MRSSMConfig

    cfg = MRSSMConfig()
    return _timing_mode(lambda dev, card: rec_fwd_timings(_seeded(MoPoEMRSSM, cfg, dev), cfg,
                                                          dev, card), ("recurrence_fwd.cu",))


def rollout_phase() -> int:
    """``--rollout``: only both rollouts' call times, device times, stages
    and rows a block (``rollout_timings``) and ``ptxas``'s report of their
    sources."""
    return _timing_mode(rollout_timings, ("rollout.cu", "rollout_mt.cu"))


def stacked_recurrence_bwd_phase() -> int:
    """``--stacked-recurrence-bwd``: only the stacked recurrence backward's
    call times and per-kernel device times beside the unstacked backward's
    on the same weights and inputs (``stacked_bwd_timings``) and ``ptxas``'s
    report of its source."""
    from multimodal_mtrssm_tpu_torch.models import MoPoEMRSSM, MRSSMConfig

    cfg = MRSSMConfig(conv_layout="fused_enc", use_pallas_train="stacked")
    return _timing_mode(lambda dev, card: stacked_bwd_timings(_seeded(MoPoEMRSSM, cfg, dev), cfg,
                                                              dev, card),
                        ("recurrence_stacked_bwd.cu",))


# ---- phases 4b, 4c and 6: resume and preemption, the train command, evaluation ----

RESUME_STEP = 4  # SIGTERM after this optimizer step: the first of epoch 1 (3 steps an epoch)
WEIGHT_TOL = STEP_TOL  # × max(1, max|w|) per tensor: the train step's gradient bound
TRAINING_KERNELS = {False: ("recurrence_fwd", "recurrence_bwd"),
                    True: ("mt_recurrence_fwd", "mt_recurrence_bwd")}
# Phase 6's model: phase 4's ``best`` trained on the labeled episodes for this
# many epochs of 3 optimizer steps (19 training episodes at B=8).
FINE_TUNE_EPOCHS = 100


@contextlib.contextmanager
def _sigterm_after(n: int):
    """SIGTERM this process right after the n-th train step of a fit, an
    eager step or a graphed one's replay (the trainer's preemption guard
    turns it into a mid-epoch checkpoint once the chunk in flight ends)."""
    import os
    import signal

    from multimodal_mtrssm_tpu_torch.train import graph
    from multimodal_mtrssm_tpu_torch.train import trainer as trainer_mod

    real, real_replay, calls = trainer_mod.make_train_step, graph.GraphedStep.replay, [0]

    def count() -> None:
        calls[0] += 1
        if calls[0] == n:
            os.kill(os.getpid(), signal.SIGTERM)

    def make(*args):
        step = real(*args)

        def wrapped(*a):
            out = step(*a)
            count()
            return out

        return wrapped

    def replay(self, *a):
        real_replay(self, *a)
        if self.optimizer is not None:  # a train step's graph
            count()

    trainer_mod.make_train_step, graph.GraphedStep.replay = make, replay
    try:
        yield
    finally:
        trainer_mod.make_train_step, graph.GraphedStep.replay = real, real_replay


def _warmup_launches(trainer) -> dict[str, int]:
    """The launches a fit's graph warm-ups made (each captured step runs
    ``WARMUP_STEPS`` times eagerly before its capture): a fit's counts are
    these, its eager steps' and its replays'."""
    from multimodal_mtrssm_tpu_torch.train.graph import WARMUP_STEPS

    out: dict[str, int] = {}
    for chunk in trainer.chunk_steps or ():
        for step in (chunk.graphs.values() if chunk is not None and chunk.graphs else ()):
            for k, n in step.launches.items():
                out[k] = out.get(k, 0) + WARMUP_STEPS * n
    return out


def _weights_close(model, ref) -> tuple[float, bool]:
    """The largest |a - b| / max(1, max|b|) over the tensors of two models'
    state dicts, and whether they are bit-identical."""
    import torch

    worst, same = 0.0, True
    for a, b in zip(model.state_dict().values(), ref.state_dict().values(), strict=True):
        worst = max(worst, float((a - b).abs().max()) / max(1.0, float(b.abs().max())))
        same &= torch.equal(a, b)
    return worst, same


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN held to deterministic algorithms (a resumed fit can then equal
    the uninterrupted one bit for bit)."""
    import torch

    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def _fit_maker(cfg, dev, episodes: Path, run_dir: Path, dm_class=None, **data_kw):
    """``make(name, **trainer_kw)``: a fresh 2-epoch ``Trainer`` of ``cfg`` at
    B=8 T=30 on ``episodes`` (pipeline noise 0, ``data_kw`` beside), logging
    into ``run_dir / name``; its datamodule of ``dm_class``."""
    from multimodal_mtrssm_tpu_torch.data import DataModuleConfig, EpisodeDataModule
    from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig, MoPoEMMTRSSM, MoPoEMRSSM
    from multimodal_mtrssm_tpu_torch.train import Trainer, TrainerConfig

    family = MoPoEMMTRSSM if isinstance(cfg, MMTRSSMConfig) else MoPoEMRSSM

    def make(name: str, **kw) -> Trainer:
        dm = (dm_class or EpisodeDataModule)(DataModuleConfig(
            data_dir=str(episodes), batch_size=8, sequence_length=30, noise_std=0.0, seed=SEED,
            **data_kw))
        return Trainer(family(cfg).to(dev), dm,
                       TrainerConfig(max_epochs=2, seed=SEED, log_dir=str(run_dir / name), **kw))

    return make


def preempt_and_resume(make, what: str) -> dict:
    """A fit of ``make("ref")`` and the same fit SIGTERMed after its 4th
    optimizer step (mid epoch 1), which must return ``preempted`` with a
    mid-epoch ``last``; a fresh ``make("cut")``'s ``fit(resume=True)``
    finishes it. Returns the resumed weights' largest error against the
    uninterrupted fit's (× max(1, max|w|) per tensor), whether they are
    bit-identical, the mid-epoch aux and the uninterrupted trainer."""
    ref = make("ref")
    ref.fit()
    with _sigterm_after(RESUME_STEP):
        cut = make("cut")
        cut_out = cut.fit()
    aux = cut.ckpt.aux("last")
    # A graphed chunk (K > 1; epoch 1's first holds steps 3 … 2+K) completes first.
    spd = cut._resolve_spd()
    if not (cut_out["preempted"] and aux.get("mid_epoch") and aux["epoch"] == 1
            and aux["global_step"] == (RESUME_STEP if spd == 1 else 3 + spd)):
        raise RuntimeError(f"{what}: SIGTERM after step {RESUME_STEP} left preempted="
                           f"{cut_out['preempted']} and 'last' {aux}")
    resumed = make("cut")
    res_out = resumed.fit(resume=True)
    if res_out["preempted"] or [r["epoch"] for r in res_out["history"]] != [1] \
            or res_out["global_step"] != 6:
        raise RuntimeError(f"{what}: the resumed fit ran epochs "
                           f"{[r['epoch'] for r in res_out['history']]} to step "
                           f"{res_out['global_step']}")
    err, same = _weights_close(resumed.model, ref.model)
    return {"err": err, "same": same, "aux": aux, "ref": ref}


def drive_resume(cfg, dev, run_dir: Path) -> dict:
    """Phase 4b: on 24 synthetic episodes at B=8 T=30 (3 steps an epoch), 2
    epochs of ``Trainer.fit``, with cuDNN held to deterministic algorithms:
    a fit preempted by SIGTERM after its 4th optimizer step (mid epoch 1)
    must return ``preempted`` and leave a mid-epoch ``last``; a fresh
    ``Trainer``'s ``fit(resume=True)`` finishes it, and its weights must
    equal the uninterrupted fit's within 3e-4 × max(1, max|w|) per tensor
    (:func:`preempt_and_resume`). Then a fit with
    ``accumulate_grad_batches=2`` (19 train episodes make 2 full batches
    and a tail: 2 windows an epoch) and one with ``profile_epoch=0``, whose
    trace must exist."""
    import torch

    from multimodal_mtrssm_tpu_torch.data import generate_synthetic_audio_mnist
    from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig
    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    mt = isinstance(cfg, MMTRSSMConfig)
    episodes = run_dir / "episodes"
    generate_synthetic_audio_mnist(episodes, n_episodes=24, seed=SEED)
    trainer = _fit_maker(cfg, dev, episodes, run_dir)
    label = _label(cfg)
    with _deterministic_cudnn():
        reset_launch_counts()
        r = preempt_and_resume(trainer, label)
        err, same, aux = r["err"], r["same"], r["aux"]
        if not err <= WEIGHT_TOL:
            raise RuntimeError(f"{label}: resumed weights differ from the uninterrupted fit's "
                               f"by {err:.3g} x scale")
        print(f"resume {label}: SIGTERM after step {RESUME_STEP} (mid epoch 1) -> preempted, "
              f"mid-epoch 'last' with {aux['items_done']} of epoch 1's batches applied; "
              "resume=True finished epoch 1; "
              f"weights vs the uninterrupted fit: max err {err:.3g} x scale (limit {WEIGHT_TOL}), "
              f"bit-identical: {'yes' if same else 'no'} (cuDNN deterministic algorithms held)")
        kernels = TRAINING_KERNELS[mt]
        torch.cuda.synchronize()
        before = launch_counts()
        out = trainer("accumulate", accumulate_grad_batches=2).fit()
        torch.cuda.synchronize()
        after = launch_counts()
        steps = int(out["opt_state"]["count"])
        if steps != 4:
            raise RuntimeError(f"{label} accumulate_grad_batches=2: {steps} optimizer steps, "
                               "expected 4")
        per = ", ".join(f"{k} {(after[k] - before[k]) / steps:.2f}" for k in kernels)
        print(f"fit {label} accumulate_grad_batches=2: {steps} optimizer steps over "
              f"{out['global_step']} batches; launches per optimizer step: {per}")
        prof = trainer("profile", profile_epoch=0)
        prof.fit()
        trace = run_dir / "profile" / "profile" / "epoch_0.trace.json"
        if not trace.is_file():
            raise RuntimeError(f"profile_epoch=0 wrote no trace at {trace}")
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"profile {label}: epoch 0 traced ({trace.stat().st_size} bytes); main-path kernel "
              f"launches of the resume phase: {counts}")
    return {"counts": counts, "ref": r["ref"].model}


def drive_train_command(cfg, dev, run_dir: Path) -> dict:
    """Phase 4c: ``train.entry.run_training``, the ``train-*`` commands'
    body, on an ``Experiment`` built without PyYAML (``make_experiment``),
    on the card (the default device): ``--synthetic 24 --max-epochs 1``,
    then ``--max-epochs 2 --resume``, which must continue at epoch 1."""
    import torch

    from multimodal_mtrssm_tpu_torch.data import DataModuleConfig
    from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig
    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from multimodal_mtrssm_tpu_torch.train import TrainerConfig
    from multimodal_mtrssm_tpu_torch.train.config import make_experiment
    from multimodal_mtrssm_tpu_torch.train.entry import default_config_path, run_training

    name = "mopoe_mmtrssm.yaml" if isinstance(cfg, MMTRSSMConfig) else "mopoe_mrssm.yaml"
    exp = make_experiment(cfg, TrainerConfig(seed=SEED, log_dir=str(run_dir / "run")),
                          DataModuleConfig(data_dir=str(run_dir / "episodes"), batch_size=8,
                                           sequence_length=30, noise_std=0.0, seed=SEED))
    reset_launch_counts()
    first = run_training(default_config_path(name), ["--synthetic", "24", "--max-epochs", "1"],
                         experiment=exp)
    second = run_training(default_config_path(name), ["--max-epochs", "2", "--resume"],
                          experiment=exp)
    torch.cuda.synchronize()
    counts = launch_counts()
    epochs = ([r["epoch"] for r in first["history"]], [r["epoch"] for r in second["history"]])
    if epochs != ([0], [1]) or next(exp.model.parameters()).device.type != dev.type:
        raise RuntimeError(f"train command {_label(cfg)}: epochs {epochs} on "
                           f"{next(exp.model.parameters()).device}")
    print(f"train command {_label(cfg)}: run_training on a PyYAML-free Experiment trained epoch "
          f"0 on the card, --resume continued at epoch 1; main-path kernel launches: {counts}")
    return {"counts": counts}


def _stripe_digits(n_per_class: int, seed: int = 0):
    """Separable 'digits' for the classifier: digit d is a bright vertical
    stripe at column 3d (as the labeled synthetic episodes draw them)."""
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


def evaluation_inputs(dev, work: Path) -> dict:
    """Phase 6's classifier, trained on the card on stripe digits (accuracy
    above 0.9 on them), saved as ``.npz``, and 24 labeled synthetic
    episodes with the evaluation's ``sample_*.npz`` files."""
    import torch

    from multimodal_mtrssm_tpu_torch.data import generate_synthetic_labeled_audio_mnist
    from multimodal_mtrssm_tpu_torch.evaluation import (
        load_test_data_with_labels,
        recognize_digits,
        save_classifier,
        train_classifier,
    )

    images, labels = _stripe_digits(30)
    t0 = time.perf_counter()
    classifier = train_classifier(images, labels, num_epochs=3, batch_size=50, device=dev)
    acc = float((recognize_digits(classifier, torch.as_tensor(images, device=dev)).cpu().numpy()
                 == labels).mean())
    if not acc > 0.9:
        raise RuntimeError(f"the classifier reached accuracy {acc} on the stripe digits")
    path = save_classifier(classifier, work / "classifier.npz")
    generate_synthetic_labeled_audio_mnist(work / "labeled", work / "labeled_eval",
                                           n_episodes=24, seed=SEED)
    test_data = load_test_data_with_labels(work / "labeled_eval")
    print(f"evaluation inputs: classifier trained on the card in {time.perf_counter() - t0:.2f} s, "
          f"accuracy {acc:.4f} on {len(labels)} stripe digits; {len(test_data)} labeled episodes")
    return {"classifier": classifier, "path": path, "test_data": test_data,
            "train_dir": work / "labeled", "eval_dir": work / "labeled_eval"}


def fine_tune(cfg, dev, checkpoints: Path, train_dir: Path, run_dir: Path, card: str) -> dict:
    """Phase 6's model: phase 4's ``best`` (trained on unlabeled episodes,
    whose imagined frames the classifier scores as one digit everywhere)
    warm-started by ``Trainer.fit(resume_from=...)`` and trained on the
    card on the labeled synthetic episodes for ``FINE_TUNE_EPOCHS`` at B=8
    T=30, so its imagined frames draw the stripes the classifier tells
    apart. Returns its checkpoints directory and launch counts."""
    import torch

    from multimodal_mtrssm_tpu_torch.data import DataModuleConfig, EpisodeDataModule
    from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig, MoPoEMMTRSSM, MoPoEMRSSM
    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from multimodal_mtrssm_tpu_torch.train import Trainer, TrainerConfig

    family = MoPoEMMTRSSM if isinstance(cfg, MMTRSSMConfig) else MoPoEMRSSM
    dm = EpisodeDataModule(DataModuleConfig(data_dir=str(train_dir), batch_size=8,
                                            sequence_length=30, noise_std=0.0, seed=SEED))
    trainer = Trainer(family(cfg).to(dev), dm, TrainerConfig(
        max_epochs=FINE_TUNE_EPOCHS, seed=SEED, log_dir=str(run_dir),
        checkpoint_every_n_epochs=FINE_TUNE_EPOCHS))
    reset_launch_counts()
    t0 = time.perf_counter()
    out = trainer.fit(resume_from=checkpoints / "best.ckpt")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    hist = out["history"]
    if len(hist) != FINE_TUNE_EPOCHS or not trainer.ckpt.exists("best"):
        raise RuntimeError(f"fine-tune {_label(cfg)}: {len(hist)} epochs of "
                           f"{FINE_TUNE_EPOCHS}, best saved: {trainer.ckpt.exists('best')}")
    print(f"fine-tune {_label(cfg)}: phase 4's best warm-started on the labeled episodes, "
          f"{out['global_step']} optimizer steps in {seconds:.2f} s; val/loss "
          f"{hist[0]['val/loss']:.6g} -> {hist[-1]['val/loss']:.6g} (best {out['best_val']:.6g}) "
          f"| {card}")
    return {"checkpoints": run_dir / "checkpoints", "counts": launch_counts()}


def drive_evaluation(cfg, dev, checkpoints: Path, inputs: dict, work: Path, card: str) -> dict:
    """Phase 6: phase 4's ``best`` fine-tuned on the labeled episodes
    (:func:`fine_tune`), then the word-transition evaluation of that
    run's ``best`` on the card, at ``classify_frame`` 0 and 1, then once
    through the ``evaluate-word-transitions`` entry (``evaluation.cli.
    main`` on a PyYAML-free ``Experiment``). Fails unless each evaluated
    word took exactly one rollout launch, every ``q_dist`` sums to 1, each
    word's rollout states equal the CPU path's on the same weights and
    seed up to each row's first Gumbel near-tie of 1e-5 (stochs equal,
    the rest within ``TOL``), its predicted digits equal the CPU path's in
    every row clear of Gumbel near-ties (the initial sample and the
    rollout up to the scored frame) and of classifier logit near-ties of
    1e-5, and the compared rows hold more than one digit. Prints the mean
    MR, the rows compared and excluded, the digits seen, the ms a word
    takes (CUDA events) and the rollout kernel's device time at B=60
    T=10."""
    import copy

    import torch

    from multimodal_mtrssm_tpu_torch.evaluation import (
        evaluate_word_transitions,
        predict_word,
        select_intervals_for_word,
    )
    from multimodal_mtrssm_tpu_torch.evaluation.cli import main as evaluate_main
    from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig, MoPoEMMTRSSM, MoPoEMRSSM
    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import check_predicted_digits
    from multimodal_mtrssm_tpu_torch.train.checkpoint import CheckpointManager
    from multimodal_mtrssm_tpu_torch.train.config import make_experiment
    from multimodal_mtrssm_tpu_torch.train.steps import fold

    mt = isinstance(cfg, MMTRSSMConfig)
    family = MoPoEMMTRSSM if mt else MoPoEMRSSM
    rollout_name = "mt_rollout" if mt else "rollout"
    label = _label(cfg)
    tuned = fine_tune(cfg, dev, checkpoints, inputs["train_dir"], work / "fine_tune", card)
    checkpoints = tuned["checkpoints"]
    model = family(cfg)
    CheckpointManager(checkpoints).restore_params("best", model)
    cpu_model = copy.deepcopy(model).eval()
    model = model.to(dev).eval()
    classifier, test_data = inputs["classifier"], inputs["test_data"]
    cpu_classifier = copy.deepcopy(classifier).cpu()
    total: dict[str, int] = dict(tuned["counts"])
    for cf in (0, 1):
        reset_launch_counts()
        results = evaluate_word_transitions(model, classifier, test_data, seed=SEED,
                                            classify_frame=cf, **EVAL_ARGS)
        torch.cuda.synchronize()
        counts = launch_counts()
        total = {k: total.get(k, 0) + v for k, v in counts.items()}
        words = results["per_word"]
        if not words or counts[rollout_name] != len(words):
            raise RuntimeError(f"{label}: {counts[rollout_name]} {rollout_name} launches for "
                               f"{len(words)} evaluated words")
        sums = [sum(r["q_dist"].values()) for r in words.values()]
        if not all(abs(s - 1.0) <= 1e-9 for s in sums):
            raise RuntimeError(f"{label}: q_dist sums {sums}")
        compared = excluded = 0
        state_err, digits = 0.0, set()
        for w in words:
            intervals = select_intervals_for_word(int(w), test_data, EVAL_ARGS["n_intervals"],
                                                  EVAL_ARGS["query_length"])
            args = (intervals, fold(SEED, int(w)), EVAL_ARGS["n_predictions"],
                    EVAL_ARGS["n_frames"])
            r = check_predicted_digits(
                predict_word(model, classifier, *args, classify_frame=cf),
                predict_word(cpu_model, cpu_classifier, *args, classify_frame=cf), cfg, cf,
                TIE_EPS, TOL)
            compared, excluded = compared + r["compared"], excluded + r["excluded"]
            state_err, digits = max(state_err, r["max_abs_err"]), digits | set(r["digits"])
        if len(digits) < 2:
            raise RuntimeError(f"{label} classify_frame={cf}: every compared row predicts "
                               f"{sorted(digits)}; the comparison cannot tell a wrong rollout")
        s = results["summary"]
        print(f"evaluation {label} classify_frame={cf}: {len(words)} words, "
              f"{counts[rollout_name]} {rollout_name} launches; mean MR {s['mean_matching_rate']:.6g} "
              f"(uniform {s['mean_uniform']:.6g}, peak {s['mean_peak_onehot']:.6g}, random "
              f"{s['mean_random_onehot']:.6g}); rollout states card vs CPU within {state_err:.3g} "
              f"up to the first near-tie (limit {TOL}); digits card vs CPU equal in {compared} "
              f"rows holding digits {sorted(digits)}, {excluded} rows excluded for near-ties of "
              f"{TIE_EPS}")
    reset_launch_counts()
    out = evaluate_main(["--checkpoint", str(checkpoints), "--test-data", str(inputs["eval_dir"]),
                         "--classifier", str(inputs["path"]), "--out", str(work / "results"),
                         "--classify-frame", "1", "--seed", str(SEED)],
                        experiment=make_experiment(cfg))
    torch.cuda.synchronize()
    counts = launch_counts()
    total = {k: total.get(k, 0) + v for k, v in counts.items()}
    if counts[rollout_name] != len(out["per_word"]) or not (work / "results" /
                                                            "word_transitions.json").is_file():
        raise RuntimeError(f"{label}: the evaluate-word-transitions entry took "
                           f"{counts[rollout_name]} rollouts for {len(out['per_word'])} words")
    print(f"evaluate-word-transitions entry {label}: mean MR "
          f"{out['summary']['mean_matching_rate']:.6g}, {counts[rollout_name]} {rollout_name} "
          "launches, results written")
    word = next(iter(out["per_word"]))
    intervals = select_intervals_for_word(int(word), test_data, EVAL_ARGS["n_intervals"],
                                          EVAL_ARGS["query_length"])
    one_word = lambda: predict_word(model, classifier, intervals, fold(SEED, int(word)),  # noqa: E731
                                    EVAL_ARGS["n_predictions"], EVAL_ARGS["n_frames"],
                                    classify_frame=1)
    with torch.no_grad():
        ms = _median_ms(one_word, 20)
        kernel = _device_ms(one_word, "rollout_stages_kernel")
    B = len(intervals) * EVAL_ARGS["n_predictions"]
    share = f"{kernel / ms:.4f}" if kernel is not None else "not measured"
    kernel_ms = f"{kernel:.6f} ms" if kernel is not None else "not measured"
    print(f"time evaluation {label}: one word (B={B} rows, T={EVAL_ARGS['n_frames']}: initial "
          f"state, rollout, vision decode at one frame, classifier) {ms:.6f} ms (CUDA events, "
          f"median of 20); the rollout kernel's device time {kernel_ms}, share {share} | {card}")
    return {"counts": total}


# ---- phase 7: the cross-modal run ------------------------------------------------------

# 7(b) and (e): compute_reconstructions at 7 episodes × 30 frames (the GIF
# callback's batch), q = 10; the report's q is its default, 15.
RECON_Q = 10
# Least share of reconstruction steps that must come before a row's first
# near-tie, so that a card-against-CPU check compares something.
MIN_COMPARED = 0.5
RECON_KERNELS = {False: ("recurrence_fwd", "rollout"), True: ("mt_recurrence_fwd", "mt_rollout")}
RECON_DEVICE_KERNELS = {False: ("recurrence_fwd_stages_kernel", "rollout_stages_kernel"),
                        True: ("mt_recurrence_fwd_stages_kernel", "mt_rollout_stages_kernel")}
KINDS = ("both", "audio dropped", "vision dropped")
REPORT_KEYS = {"conditions": {"both", "drop_audio", "drop_vision"},
               "cells": {"posterior/audio", "posterior/vision", "prior/audio", "prior/vision"},
               "baselines": {"constant_-1/audio", "mean_frame/audio", "constant_-1/vision",
                             "mean_frame/vision"},
               "config": {"n_episodes", "T", "query_length", "seed"}}
SUMMARY_KEYS = {"mr_both", "mr_vision", "mr_audio",
                *(f"recon_{c}_{m}" for c in ("both", "drop_audio", "drop_vision")
                  for m in ("audio", "vision"))}


def _counting_datamodule():
    """An ``EpisodeDataModule`` that counts, of the batches it serves, the
    train and the validation samples of each kind (both inputs, audio
    dropped, vision dropped: an input all -1), the validation batches, and
    the samples with a target all -1."""
    import torch

    from multimodal_mtrssm_tpu_torch.data import EpisodeDataModule

    class CountingDataModule(EpisodeDataModule):
        def __init__(self, config):
            super().__init__(config)
            self.kinds = {"train": dict.fromkeys(KINDS, 0), "val": dict.fromkeys(KINDS, 0)}
            self.val_batches_served = 0
            self.dropped_targets = 0

        def _count(self, batch, stage: str) -> None:
            dropped = [(x == -1).flatten(1).all(1) for x in batch[1:3]]
            kinds = self.kinds[stage]
            kinds["audio dropped"] += int(dropped[0].sum())
            kinds["vision dropped"] += int(dropped[1].sum())
            kinds["both"] += int((~(dropped[0] | dropped[1])).sum())
            self.dropped_targets += int(torch.stack(
                [(x == -1).flatten(1).all(1) for x in batch[4:6]]).any(0).sum())

        def _items(self, items, stage: str):
            """The served items (the flat streams are K=1 items), each batch
            of them counted."""
            for item in items:
                kind, b = item[:2]
                for batch in ([tuple(x[i] for x in b) for i in range(b[0].shape[0])]
                              if kind == "scan" else [b]):
                    self._count(batch, stage)
                    self.val_batches_served += stage == "val"
                yield item

        def train_batches_chunked(self, epoch, k, device="cpu", skip=0, rows=None):
            return self._items(super().train_batches_chunked(epoch, k, device, skip, rows),
                               "train")

        def val_batches_chunked(self, k, device="cpu", rows=None):
            return self._items(super().val_batches_chunked(k, device, rows), "val")

    return CountingDataModule


def _reconstructions_vs_cpu(cfg, model, batch, q: int) -> dict:
    """``viz.rollout.reconstruction_states`` and its frames on the card,
    which must take exactly one recurrence-forward and one rollout launch,
    against the CPU path on the same weights, batch and seed
    (``parity.check_reconstructions``: states and frames within ``TOL``
    before each row's first Gumbel near-tie of ``TIE_EPS``, stochs equal),
    on at least ``MIN_COMPARED`` of the steps."""
    import copy

    import torch

    from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig
    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import check_reconstructions
    from multimodal_mtrssm_tpu_torch.viz.rollout import decode_reconstructions, reconstruction_states

    def run(m):
        out = reconstruction_states(m, batch, q, SEED)
        out["frames"] = decode_reconstructions(m, out)
        return out

    reset_launch_counts()
    card = run(model)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    want = dict.fromkeys(RECON_KERNELS[isinstance(cfg, MMTRSSMConfig)], 1)
    if counts != want:
        raise RuntimeError(f"reconstructions {_label(cfg)}: launches {counts}, expected {want}")
    r = check_reconstructions(card, run(copy.deepcopy(model).cpu()), cfg, TIE_EPS, TOL)
    if r["compared"] < MIN_COMPARED:
        raise RuntimeError(f"reconstructions {_label(cfg)}: only {r['compared']:.4f} of the steps "
                           f"compared before a near-tie (at least {MIN_COMPARED} needed)")
    return {**r, "counts": counts}


def drive_crossmodal(dev, work: Path, test_data: list[dict], card: str) -> dict:
    """Phase 7, the cross-modal run on the card. (a) The crossmodal config
    (``configs/mopoe_mrssm_crossmodal.yaml``) fits 2 epochs × 3 steps on 24 synthetic
    episodes with the GIF callback: losses finite, every train and val
    sample's audio input at -1 and no target dropped, the recurrence
    forward launched once a step, a validation batch and a stage's render,
    its backward once a step, the rollout once a render, and GIFs of 30
    frames in ``viz/epoch_0001`` and ``viz/final_best`` (train and val)
    with the audio row "(missing)", each logged. (b) ``compute_
    reconstructions`` on the card against the CPU path for ``MRSSMConfig()``
    (the fit's best) and ``MMTRSSMConfig()`` (seeded weights), 7 episodes,
    T=30, q=10. (c) Phase 4b's preempt-and-resume under
    ``drop_modality="random"``: bit-identical to the uninterrupted fit,
    validation clean. (d) ``reconstruction_report`` of the best on the
    labeled episodes: JAX's structure, 3 forward and 3 rollout launches,
    ``drop_audio`` unlike ``both``, each condition against the CPU path.
    (e) Timings. (f) The crossmodal experiment's entry at smoke scale."""
    import json as _json

    import torch
    from PIL import Image

    from multimodal_mtrssm_tpu_torch import crossmodal_e2e
    from multimodal_mtrssm_tpu_torch.data import generate_synthetic_audio_mnist
    from multimodal_mtrssm_tpu_torch.evaluation import build_normalized_batch, reconstruction_report
    from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig, MoPoEMMTRSSM, MRSSMConfig
    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from multimodal_mtrssm_tpu_torch.train.config import load_experiment
    from multimodal_mtrssm_tpu_torch.train.entry import default_config_path
    from multimodal_mtrssm_tpu_torch.viz.callback import make_viz_callback
    from multimodal_mtrssm_tpu_torch.viz.rollout import (
        compute_reconstructions,
        log_rollout_gifs,
        row_labels,
    )

    total: dict[str, int] = {}

    def add(counts: dict) -> None:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    episodes = work / "episodes"
    generate_synthetic_audio_mnist(episodes, n_episodes=24, seed=SEED)
    counting = _counting_datamodule()

    # (a) The fit, with the GIF callback.
    exp = load_experiment(default_config_path("mopoe_mrssm_crossmodal.yaml"))
    if exp.pending or exp.data.drop_modality != "audio":
        raise RuntimeError(f"crossmodal config: pending {exp.pending}, drop_modality "
                           f"{exp.data.drop_modality!r}")
    exp.trainer.max_epochs, exp.trainer.seed, exp.trainer.log_dir = 2, SEED, str(work / "run")
    exp.data.data_dir, exp.data.seed = str(episodes), SEED
    exp.viz.every_n_epochs = 1
    dm = counting(exp.data)
    trainer = exp.build_trainer(datamodule=dm, device=dev)
    callback = make_viz_callback(exp)
    trainer.callbacks.append(callback)
    reset_launch_counts()
    t0 = time.perf_counter()
    out = trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    counts = launch_counts()
    add(counts)
    steps, renders = out["global_step"], 4  # epoch_0001 and final_best, train and val
    warm = _warmup_launches(trainer)
    expect = {"recurrence_fwd": steps + dm.val_batches_served + renders
              + warm.get("recurrence_fwd", 0),
              "recurrence_bwd": steps + warm.get("recurrence_bwd", 0), "rollout": renders}
    losses = [r[k] for r in out["history"] for k in ("train/loss", "val/loss")]
    if steps != 6 or not all(np.isfinite(losses)) or \
            {k: counts[k] for k in expect} != expect:
        raise RuntimeError(f"crossmodal fit: {steps} steps, losses {losses}, launches "
                           f"{ {k: counts[k] for k in expect} } against {expect}")
    n_train, n_val = 2 * dm.n_train, 2 * dm.n_val
    want_kinds = {"train": {"both": 0, "audio dropped": n_train, "vision dropped": 0},
                  "val": {"both": 0, "audio dropped": n_val, "vision dropped": 0}}
    if dm.kinds != want_kinds or dm.dropped_targets:
        raise RuntimeError(f"crossmodal fit: samples {dm.kinds}, {dm.dropped_targets} dropped "
                           "targets; every input audio at -1 expected, targets clean")
    viz = work / "run" / "viz"
    gifs = {}
    for name in ("epoch_0001", "final_best"):
        for stage, n in (("train", min(7, dm.n_train)), ("val", min(7, dm.n_val))):
            found = sorted((viz / name / stage).glob("episode_*.gif"))
            frames = {Image.open(g).n_frames for g in found}
            if len(found) != n or frames != {30}:
                raise RuntimeError(f"crossmodal GIFs {name}/{stage}: {len(found)} of {n}, "
                                   f"frames {frames}")
            gifs[f"{name}/{stage}"] = len(found)
    logged = [line for line in (work / "run" / "metrics.jsonl").read_text().splitlines()
              if '"video"' in line]
    batch = callback._collect_stage_batch(trainer, "train")
    labels = row_labels({"audio": batch[1][0], "vision": batch[2][0]})
    if (viz / "epoch_0000").exists() or len(logged) != sum(gifs.values()) or \
            labels != ["vision", "audio (missing)"]:
        raise RuntimeError(f"crossmodal GIFs: epoch 0 drawn {(viz / 'epoch_0000').exists()}, "
                           f"{len(logged)} logged of {sum(gifs.values())}, row labels {labels}")
    print(f"crossmodal fit (mopoe_mrssm_crossmodal, B=8 T=30): {steps} steps in {fit_s:.2f} s with "
          f"the GIF callback; val/loss {out['history'][0]['val/loss']:.6g} -> "
          f"{out['history'][-1]['val/loss']:.6g}; train samples {dm.kinds['train']}, val "
          f"{dm.kinds['val']}, targets clean; launches {expect}; GIFs of 30 frames {gifs}, "
          f"each logged; row labels {labels} | {card}")

    # (b) compute_reconstructions, card against the CPU path.
    best = trainer.load_best_params(trainer.model).eval()
    mt_cfg = MMTRSSMConfig()
    mt_model = MoPoEMMTRSSM(mt_cfg).init(torch.Generator().manual_seed(SEED)).to(dev).eval()
    models = ((MRSSMConfig(), best), (mt_cfg, mt_model))
    B, T = batch[0].shape[:2]
    for cfg, model in models:
        r = _reconstructions_vs_cpu(cfg, model, batch, RECON_Q)
        add(r["counts"])
        print(f"reconstructions {_label(cfg)} B={B} T={T} q={RECON_Q}: launches {r['counts']}; "
              f"card vs CPU: states within {r['max_abs_err']:.3g}, frames within "
              f"{r['frame_err']:.3g} before each row's first near-tie (limit {TOL}), "
              f"{r['compared']:.4f} of the steps compared")

    # (c) A mid-epoch resume under random dropout.
    make = _fit_maker(MRSSMConfig(), dev, episodes, work / "random", counting,
                      drop_modality="random")
    reset_launch_counts()
    with _deterministic_cudnn():
        r = preempt_and_resume(make, "random dropout")
    torch.cuda.synchronize()
    add(launch_counts())
    seen = r["ref"].dm
    if not r["same"] or seen.kinds["val"]["both"] != 2 * seen.n_val or seen.dropped_targets \
            or sum(seen.kinds["train"].values()) != 2 * seen.n_train:
        raise RuntimeError(f"random dropout: resume bit-identical {r['same']} (err "
                           f"{r['err']:.3g}), samples {seen.kinds}, {seen.dropped_targets} "
                           "dropped targets")
    print(f"resume under drop_modality='random': SIGTERM after step {RESUME_STEP}, resume=True "
          f"bit-identical to the uninterrupted fit (cuDNN deterministic); its 2 epochs' train "
          f"samples {seen.kinds['train']}, validation {seen.kinds['val']} (clean), targets clean")

    # (d) The report on the card.
    reset_launch_counts()
    report = reconstruction_report(best, test_data, seed=SEED)
    torch.cuda.synchronize()
    counts = {k: v for k, v in launch_counts().items() if v}
    add(counts)
    conds = report["conditions"]
    shape_ok = (set(report) == {"conditions", "baselines", "config"}
                and set(conds) == REPORT_KEYS["conditions"]
                and all(set(c) == REPORT_KEYS["cells"] for c in conds.values())
                and set(report["baselines"]) == REPORT_KEYS["baselines"]
                and set(report["config"]) == REPORT_KEYS["config"])
    if not shape_ok or counts != {"recurrence_fwd": 3, "rollout": 3} or \
            conds["drop_audio"]["posterior/audio"] == conds["both"]["posterior/audio"]:
        raise RuntimeError(f"reconstruction report: {report}, launches {counts}")
    print(f"reconstruction report (best, 8 labeled episodes, T=30, q=15): launches {counts}; "
          f"{_json.dumps(report)}")
    for drop in (None, "audio", "vision"):
        r = _reconstructions_vs_cpu(MRSSMConfig(), best, build_normalized_batch(test_data, drop=drop),
                                    15)
        add(r["counts"])
        print(f"report condition drop={drop}: card vs CPU states within {r['max_abs_err']:.3g}, "
              f"frames within {r['frame_err']:.3g} (limit {TOL}), {r['compared']:.4f} compared")

    # (e) Timings.
    with torch.no_grad():
        for cfg, model in models:
            call = lambda m=model: compute_reconstructions(m, batch, RECON_Q, SEED)  # noqa: E731
            ms = _median_ms(call, 20)
            keys = RECON_DEVICE_KERNELS[isinstance(cfg, MMTRSSMConfig)]
            parts = _device_breakdown(call, keys)
            said = ", ".join(f"{k} {v:.6f} ms ({v / ms:.4f})" if v is not None
                             else f"{k} not measured" for k, v in parts.items())
            print(f"time compute_reconstructions {_label(cfg)} B={B} T={T} q={RECON_Q}: "
                  f"{ms:.6f} ms (CUDA events, median of 20); device time (share): {said} | {card}")
        ms = _median_ms(lambda: reconstruction_report(best, test_data, seed=SEED), 20)
        print(f"time reconstruction_report {_label(MRSSMConfig())} (3 conditions, B=8 T=30 q=15, "
              f"MSEs read on the host): {ms:.6f} ms (CUDA events, median of 20) | {card}")
        for stage in ("train", "val"):
            b = callback._collect_stage_batch(trainer, stage)
            times = []
            for i in range(3):
                t0 = time.perf_counter()
                log_rollout_gifs(best, b, work / "gif_timing" / f"{stage}{i}", RECON_Q, 10.0, 0,
                                 range(b[0].shape[0]))
                times.append(time.perf_counter() - t0)
            print(f"time GIF render {stage} ({b[0].shape[0]} episodes x {T} frames: "
                  f"reconstructions, frames, GIF files): {float(np.median(times)):.4f} s "
                  f"(host clock, median of 3) | {card}")

    # (f) The experiment's entry at smoke scale.
    reset_launch_counts()
    t0 = time.perf_counter()
    summary = crossmodal_e2e.main(["--workdir", str(work / "e2e"), "--seeds", "1", "--variants",
                                   "crossmodal", "--epochs", "2", "--episodes", "24"])
    torch.cuda.synchronize()
    e2e_s = time.perf_counter() - t0
    add(launch_counts())
    saved = _json.loads((work / "e2e" / "summary.json").read_text())
    agg = saved["aggregate"].get("crossmodal", {})
    if set(saved) != {"protocol", "per_seed", "aggregate"} or set(agg) != SUMMARY_KEYS or \
            saved != _json.loads(_json.dumps(summary)):
        raise RuntimeError(f"crossmodal_e2e summary.json: {sorted(saved)}, {sorted(agg)}")
    mr = ", ".join(f"{c} {agg[f'mr_{c}']['mean']:.6g}" for c in ("both", "vision", "audio"))
    print(f"crossmodal_e2e (crossmodal variant, 1 seed, 2 epochs, 24 episodes) on the card in "
          f"{e2e_s:.2f} s: MR {mr}; audio recon MSE both {agg['recon_both_audio']:.6g}, "
          f"vision-only {agg['recon_drop_audio_audio']:.6g}; summary.json has JAX's keys | {card}")
    return {"counts": total}


def serve_trained(cfg, dev, training: dict, card: str) -> dict[str, int]:
    """Phases 3b and its timings: the fit run of ``cfg`` served from its
    checkpoints directory, coalesced (``drive_coalesced``), then the
    serving latencies (``coalesced_latencies``). Returns the launch counts
    of the coalesced requests."""
    import torch

    with torch.no_grad():
        ctx = drive_coalesced(cfg, dev, training["checkpoints"])
        try:
            coalesced_latencies(ctx, cfg, card)
        finally:
            ctx["server"].stop()
    return ctx["counts"]


# ---- phase 8: the plain route, 16-mixed and the bf16 encoder kernels ----------------------

# The bf16 encoder kernels against their plain versions, × max(1, max|plain|):
# a different f32 summation order may flip one bf16 ulp (2^-8 relative) of a
# layer's output, which the later layers carry; against the f32 kernels,
# absolute, JAX's own bound (tests/test_fused_conv.py::test_bf16_path).
BF16_FWD_TOL, BF16_BWD_TOL, BF16_VS_F32 = 1e-2, 2e-2, 0.1
# A 16-mixed train step on the card against the CPU route: loss terms within
# 1e-2 of the loss, gradients within 5e-2 × scale; noise with Gumbel
# near-ties of 1e-2 (bf16 convs move the logits by ~1e-3) is skipped.
MIXED_RTOL, MIXED_REL, MIXED_TIE = 1e-2, 5e-2, 1e-2
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense bf16 (NVIDIA data sheet)
# The device kernels of one fused_encoder_bf16_backward_cuda call, and as
# PR 21's first form named them (``--bf16-encoder`` times its archive).
ENCODER_BF16_BWD_KERNELS = {"pack": "encoder_bf16_tc_pack_kernel",
                            "recompute forward": "encoder_bf16_tc_fwd_kernel",
                            "cotangent pass": "encoder_bf16_tc_dx_kernel",
                            "weight-gradient pass": "encoder_bf16_tc_dw_kernel",
                            "reduce": "encoder_bf16_tc_reduce_kernel"}
ENCODER_BF16_BWD_KERNELS_PR21 = {"pack": "encoder_bf16_pack_kernel",
                                 "recompute forward": "encoder_bf16_fwd_kernel",
                                 "cotangent pass": "encoder_bf16_bwd_dx",
                                 "weight-gradient pass": "encoder_bf16_bwd_dw",
                                 "reduce": "encoder_bf16_reduce"}
ROUTE_KERNELS = ("recurrence_fwd", "recurrence_bwd", "rollout", "mt_recurrence_fwd",
                 "mt_recurrence_bwd", "mt_rollout", "stacked_recurrence_fwd",
                 "stacked_recurrence_bwd")


def _bf16_case(rng, enc, N: int, dev):
    """``_encoder_case``'s f32 weights, frames and cotangent, and their bf16
    casts."""
    import torch

    w, x, g = _encoder_case(rng, enc, N, dev)
    return (w, x), ([t.to(torch.bfloat16) for t in w], x.to(torch.bfloat16), g.to(torch.bfloat16))


def check_bf16_encoder(model, dev) -> dict[str, dict]:
    """Phase 8(a), bf16 fused encoder at N=240 and 3840: the forward kernel
    against the plain bf16 version (BF16_FWD_TOL × scale) and the f32
    kernel (BF16_VS_F32), the backward (every weight gradient and dx)
    against the plain bf16 backward (BF16_BWD_TOL × scale per tensor); two
    launches of each bit-identical."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv
    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import ParityError, check_gradients

    enc = model.audio_encoder
    cfg = enc.cfg
    rng = np.random.default_rng(SEED + 12)
    fwd_err = bwd_err = 0.0
    for N in ENCODER_FRAMES[::2]:
        (w32, x32), (w, x, g) = _bf16_case(rng, enc, N, dev)
        got = fused_conv.fused_encoder_bf16_forward_cuda(w, cfg, x)
        again = fused_conv.fused_encoder_bf16_forward_cuda(w, cfg, x)
        plain = fused_conv.fused_encoder_plain(w, cfg, x).float()
        f32 = fused_conv.fused_encoder_forward_cuda(w32, cfg, x32)
        scale = max(1.0, float(plain.abs().max()))
        err, err32 = (float((got.float() - ref).abs().max()) for ref in (plain, f32))
        if not (err <= BF16_FWD_TOL * scale and err32 <= BF16_VS_F32 and torch.equal(got, again)):
            raise ParityError(f"fused_encoder_fwd_bf16 N={N}: {err:.3g} vs plain (limit "
                              f"{BF16_FWD_TOL} x {scale:.3g}), {err32:.3g} vs f32, or two "
                              "launches differ")
        dx, dw = fused_conv.fused_encoder_bf16_backward_cuda(w, cfg, x, g, True)
        dx2, dw2 = fused_conv.fused_encoder_bf16_backward_cuda(w, cfg, x, g, True)
        ref_dx, ref_dw = fused_conv.fused_encoder_backward_plain(w, cfg, x, g, True)
        got_b = [t.float() for t in (*dw, dx)]
        ref_b = [t.float() for t in (*ref_dw, ref_dx)]
        scaled = check_gradients(got_b, ref_b, BF16_BWD_TOL)
        if not all(torch.equal(a, b) for a, b in zip([*dw, dx], [*dw2, dx2])):
            raise ParityError("fused_encoder_bwd_bf16: two launches on the same inputs differ")
        berr = max(float((a - b).abs().max()) for a, b in zip(got_b, ref_b))
        print(f"check fused_encoder_fwd_bf16 N={N}: max_abs_err={err:.3g} vs plain bf16 (limit "
              f"{BF16_FWD_TOL} x {scale:.3g}), {err32:.3g} vs the f32 kernel (limit "
              f"{BF16_VS_F32}); fused_encoder_bwd_bf16: max_abs_err={berr:.3g} max_err/scale="
              f"{scaled:.3g} vs the plain bf16 backward (limit {BF16_BWD_TOL}); two launches of "
              "each bit-identical")
        fwd_err, bwd_err = max(fwd_err, err), max(bwd_err, berr)
    return {"fused_encoder_fwd_bf16": {"max_abs_err": fwd_err},
            "fused_encoder_bwd_bf16": {"max_abs_err": bwd_err}}


def _bf16_kernel_names() -> dict[str, str]:
    """The bf16 backward's kernels as the imported package names them: this
    tree's, or PR 21's first form (an archive timed by ``--bf16-encoder``)."""
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    src = (build.CSRC / "fused_encoder_bf16_bwd.cu").read_text()
    return (ENCODER_BF16_BWD_KERNELS if ENCODER_BF16_BWD_KERNELS["weight-gradient pass"] in src
            else ENCODER_BF16_BWD_KERNELS_PR21)


def bf16_encoder_timings(model, dev, card: str) -> tuple[dict, dict, dict, dict]:
    """Phase 8(a) timings at N=240 and 3840: the bf16 encoder kernels against
    their plain versions, beside the f32 kernels and the cuDNN ``Encoder``
    on bf16 frames (its forward, and forward + backward), with the device
    time of every kernel of a forward call and of each kernel of a backward
    call; the bounds at N=240 (bf16 bytes, and the multiply-adds over the
    bf16 peak). Returns the kernels line's times, library times and bounds,
    and a record of each N's call and device ms."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv

    names = _bf16_kernel_names()
    record: dict[int, dict] = {}
    enc = model.audio_encoder
    cfg = enc.cfg
    macs, first = _encoder_macs(cfg)
    rng = np.random.default_rng(SEED + 13)
    params = list(enc.parameters())
    main: dict[str, tuple[float, float]] = {}
    library: dict[str, float] = {}
    bounds: dict[str, dict] = {}
    fwd = fused_conv.fused_encoder_bf16_forward_cuda
    bwd = fused_conv.fused_encoder_bf16_backward_cuda
    for N in ENCODER_FRAMES[::2]:
        (w32, x32), (w, x, g) = _bf16_case(rng, enc, N, dev)
        k_ms = _median_ms(lambda: fwd(w, cfg, x), 20)
        p_ms = _median_ms(lambda: fused_conv.fused_encoder_plain(w, cfg, x), 10)
        f_ms = _median_ms(lambda: fused_conv.fused_encoder_forward_cuda(w32, cfg, x32), 20)
        l_ms = _median_ms(lambda: enc(x), 20)
        d_ms = _device_ms(lambda: fwd(w, cfg, x), "encoder_bf16")
        kb_ms = _median_ms(lambda: bwd(w, cfg, x, g, False), 10)
        pb_ms = _median_ms(lambda: fused_conv.fused_encoder_backward_plain(w, cfg, x, g, False), 5)
        fb_ms = _median_ms(lambda: fused_conv.fused_encoder_backward_cuda(
            w32, cfg, x32, g.float(), False), 10)
        with torch.enable_grad():
            lb_ms = _median_ms(lambda: torch.autograd.grad(enc(x), params, g), 10)
        parts = _device_breakdown(lambda: bwd(w, cfg, x, g, False), tuple(names.values()))
        _print_breakdown(f"fused_encoder_bwd_bf16 N={N}", parts, names, card)
        seen = [v for v in parts.values() if v is not None]
        record[N] = {"fwd_ms": k_ms, "fwd_device_ms": d_ms, "bwd_ms": kb_ms,
                     "bwd_device_ms": sum(seen) if seen else None,
                     "bwd_parts": {k: parts[v] for k, v in names.items()},
                     "cudnn_fwd_ms": l_ms, "cudnn_fwd_bwd_ms": lb_ms,
                     "f32_fwd_ms": f_ms, "f32_bwd_ms": fb_ms}
        dev_ms = "not measured" if d_ms is None else f"{d_ms:.4f} ms"
        print(f"time fused_encoder_fwd_bf16 N={N}: kernel {k_ms:.4f} ms (device, all its kernels, "
              f"{dev_ms}), plain "
              f"bf16 {p_ms:.4f} ms, the f32 kernel {f_ms:.4f} ms, cuDNN Encoder on bf16 frames "
              f"{l_ms:.4f} ms; fused_encoder_bwd_bf16 (recompute + weight gradients): kernel "
              f"{kb_ms:.4f} ms, plain bf16 {pb_ms:.4f} ms, the f32 kernels {fb_ms:.4f} ms, cuDNN "
              f"Encoder bf16 forward + backward {lb_ms:.4f} ms | {card}")
        if "fused_encoder_fwd_bf16" not in main:
            main["fused_encoder_fwd_bf16"] = (k_ms, p_ms)
            main["fused_encoder_bwd_bf16"] = (kb_ms, pb_ms)
            library["fused_encoder_fwd_bf16"], library["fused_encoder_bwd_bf16"] = l_ms, lb_ms
            bounds["fused_encoder_fwd_bf16"] = _bound(2 * macs * N, _nbytes(w, x) +
                                                      2 * N * cfg.out_dim, PEAK_BF16_FLOPS)
            bounds["fused_encoder_bwd_bf16"] = _bound(2 * (3 * macs - first) * N,
                                                      2 * _nbytes(w) + _nbytes(x, g),
                                                      PEAK_BF16_FLOPS)
    return main, library, bounds, record


def _zero_route_launches(counts: dict[str, int], what: str) -> None:
    bad = {k: counts[k] for k in ROUTE_KERNELS if counts[k]}
    if bad:
        raise RuntimeError(f"{what}: the plain route launched {bad}")


def _rollouts(model, dev, B: int = 8, T: int = 10, seed: int = 5):
    """``model``'s imagination on ``dev`` from a seeded initial state."""
    import torch

    rng = np.random.default_rng(seed)
    act = torch.tensor(rng.uniform(-1, 1, (B, 1, 6)).astype(np.float32), device=dev)
    frames = [torch.tensor(rng.uniform(-1, 1, (B, 32, 32, 1)).astype(np.float32), device=dev)
              for _ in range(2)]
    noise = {k: torch.tensor(rng.gumbel(size=s).astype(np.float32), device=dev)
             for k, s in model.noise_shapes(B, 1).items() if k.startswith("g_init")}
    with torch.no_grad():
        init = model.initial_state(*frames, *noise.values())
        return model.rollout_transition(act.expand(B, T, 6).contiguous(), init, seed)


def _step_vs(model, other, dev, other_dev, rtol: float, rel: float, tie_eps: float,
             shape: tuple[int, int] = (4, 10), seeds: int = 30) -> dict:
    """One train step of ``model`` on ``dev`` against ``other`` on
    ``other_dev`` (the same weights), on the first seed whose batch and
    noise have no Gumbel near-tie of ``tie_eps`` (``parity.check_train_step``
    at ``rtol`` and ``rel``)."""
    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import (
        check_train_step,
        train_step_near_ties,
    )

    B, T = shape
    for seed in range(SEED + 40, SEED + 40 + seeds):
        batch, noise = _train_batch(np.random.default_rng(seed), B, T, other)
        if train_step_near_ties(other, tuple(x.to(other_dev) for x in batch),
                                _noise_to(noise, other_dev), tie_eps) == 0:
            break
    else:
        raise RuntimeError(f"no seed without near-ties of {tie_eps} for the train-step check")
    inputs = (tuple(x.to(dev) for x in batch), _noise_to(noise, dev))
    out = check_train_step(model, other, inputs,
                           (tuple(x.to(other_dev) for x in batch), _noise_to(noise, other_dev)),
                           rtol, rel)
    return {**out, "seed": seed, "inputs": inputs}


def drive_plain_route(dev, card: str) -> dict:
    """Phase 8(b), the plain route by name (``use_pallas_train=False``) on
    the card, each family: a Tanh model (which the kernels refuse) trains
    one step and imagines as on the CPU; an ELU model on the plain route
    against the same weights on the kernels (a train step at the phase 4
    bounds; imagination on the same Philox noise within 1e-4 before each
    row's first near-tie), launching no recurrence or rollout kernel; a
    shape the kernels refuse (a category block of 33) raises a message
    naming the route, which then runs it; whether T=180 fits the kernels,
    on each family's train step (``demo_e2e --seq-len 180``). Returns the
    plain route's launch counts."""
    import torch

    from multimodal_mtrssm_tpu_torch.models import (
        MMTRSSMConfig,
        MoPoEMMTRSSM,
        MoPoEMRSSM,
        MRSSMConfig,
    )
    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import (
        check_same_rollouts,
        train_step_grads,
    )
    from multimodal_mtrssm_tpu_torch.train import AdamW, one_update

    counts = dict.fromkeys(launch_counts(), 0)
    cpu = torch.device("cpu")
    for family, cfg_cls in ((MoPoEMRSSM, MRSSMConfig), (MoPoEMMTRSSM, MMTRSSMConfig)):
        name = family.__name__
        tanh = cfg_cls(activation_name="Tanh", use_pallas_train=False)
        on_cpu = family(tanh).init(torch.Generator().manual_seed(SEED + 1))
        card_model = family(tanh).to(dev)
        card_model.load_state_dict(on_cpu.state_dict())
        reset_launch_counts()
        r = _step_vs(card_model, on_cpu, dev, cpu, STEP_RTOL, STEP_TOL, TIE_EPS)
        imagined = _rollouts(card_model, dev)
        run = launch_counts()
        _zero_route_launches(run, f"{name} Tanh")
        roll = check_same_rollouts(imagined, _rollouts(on_cpu, cpu).to(dev), tanh, 5, TOL,
                                   TIE_EPS)
        print(f"plain route {name} Tanh on the card vs the CPU: train step (seed {r['seed']}) "
              f"loss err/loss {max(r['loss_rel_errs'].values()):.3g} (limit {STEP_RTOL}), grad "
              f"max_abs_err {r['grad_max_abs_err']:.3g} (limit {STEP_TOL} x "
              f"{r['grad_scale']:.4g}); imagination B=8 T=10 max_abs_err "
              f"{roll['max_abs_err']:.3g}, {roll['compared']:.0%} of steps before a near-tie; "
              "no recurrence or rollout launch")
        counts = {k: counts[k] + v for k, v in run.items()}

        kernel = family(cfg_cls()).init(torch.Generator().manual_seed(SEED + 2)).to(dev)
        plain = family(cfg_cls(use_pallas_train=False)).to(dev)
        plain.load_state_dict(kernel.state_dict())
        r = _step_vs(plain, kernel, dev, dev, STEP_RTOL, STEP_TOL, TIE_EPS)
        reset_launch_counts()
        train_step_grads(plain, *r["inputs"])
        got = _rollouts(plain, dev)
        run = launch_counts()
        _zero_route_launches(run, f"{name} ELU")
        counts = {k: counts[k] + v for k, v in run.items()}
        ref = _rollouts(kernel, dev)
        roll = check_same_rollouts(got, ref, kernel.cfg, 5, TOL, TIE_EPS)
        print(f"plain route {name} ELU vs its kernel route on the card: train step (seed "
              f"{r['seed']}) loss err/loss {max(r['loss_rel_errs'].values()):.3g}, grad "
              f"max_abs_err {r['grad_max_abs_err']:.3g} (limit {STEP_TOL} x "
              f"{r['grad_scale']:.4g}); imagination max_abs_err {roll['max_abs_err']:.3g} (limit "
              f"{TOL}), {roll['compared']:.0%} of steps before a near-tie")
        step = _plain_step_ms(kernel, plain, dev)
        print(f"time {name} train step B=8 T=30: kernel route {step[0]:.4f} ms, plain route "
              f"(use_pallas_train=False) {step[1]:.4f} ms | {card}")

    wide = dict(class_size=1, category_size=33)
    refused = MoPoEMRSSM(MRSSMConfig(**wide)).to(dev)
    batch, noise = _train_batch(np.random.default_rng(SEED + 3), 2, 5, refused)
    batch, noise = tuple(x.to(dev) for x in batch), _noise_to(noise, dev)
    try:
        refused.shared_step(batch, noise)
    except ValueError as e:
        if "use_pallas_train=False" not in str(e):
            raise
        print(f"refused shape (a category block of 33): {e}")
    else:
        raise RuntimeError("the kernels took a category block of 33")
    plain = MoPoEMRSSM(MRSSMConfig(use_pallas_train=False, **wide)).to(dev)
    plain.load_state_dict(refused.state_dict())
    reset_launch_counts()
    loss = float(plain.shared_step(batch, noise)["loss"].detach())
    _zero_route_launches(launch_counts(), "the refused shape")
    if not np.isfinite(loss):
        raise RuntimeError("the plain route's loss on the refused shape is not finite")
    print(f"the same shape on the plain route: loss {loss:.6g}, no recurrence launch")

    for family, cfg_cls in ((MoPoEMRSSM, MRSSMConfig), (MoPoEMMTRSSM, MMTRSSMConfig)):
        model = family(cfg_cls()).init(torch.Generator().manual_seed(SEED)).to(dev)
        batch, _ = _train_batch(np.random.default_rng(SEED + 4), 8, 180, model)
        try:
            one_update(model, AdamW(model.parameters()), tuple(x.to(dev) for x in batch),
                       torch.Generator(device=dev).manual_seed(SEED))
            torch.cuda.synchronize()
            print(f"T=180: a {family.__name__} train step at B=8 T=180 runs on the kernels "
                  "(demo_e2e --seq-len 180 takes the kernel route)")
        except ValueError as e:
            print(f"T=180: the {family.__name__} kernels refuse B=8 T=180: {e}")
    return counts


def _plain_step_ms(kernel, plain, dev) -> tuple[float, float]:
    """Median ms of a train step (forward, backward, AdamW) at B=8 T=30 on
    the kernel route and on the plain route, the same weights and batch."""
    import torch

    from multimodal_mtrssm_tpu_torch.train import AdamW, one_update

    batch, _ = _train_batch(np.random.default_rng(SEED + 8), 8, 30, kernel)
    batch = tuple(x.to(dev) for x in batch)
    out = []
    for model in (kernel, plain):
        opt = AdamW(model.parameters())
        gen = torch.Generator(device=dev).manual_seed(SEED)
        out.append(_median_ms(lambda: one_update(model, opt, batch, gen), 5, warmup=2))
    return out[0], out[1]


def drive_precision(dev, work: Path, card: str) -> dict:
    """Phase 8(c), ``trainer.precision: 16-mixed``: ``configs/mopoe_mrssm.yaml``
    and ``mopoe_mmtrssm.yaml`` with ``precision: 16-mixed`` at ``conv_layout``
    nhwc (cuDNN in bf16) and fused_enc (the bf16 encoder kernels) fit 2
    epochs × 3 steps at B=8 T=30 on 24 synthetic episodes: finite losses, no
    f32 encoder kernel, at fused_enc the bf16 encoder kernels twice a step
    each way (and at nhwc none); an observe's launches; then one train step
    of the fit's model on the card against the CPU route at the bf16 bounds
    (MIXED_*), and the train step's time and device breakdown. Returns the
    fits' and observes' launch counts."""
    import torch

    from multimodal_mtrssm_tpu_torch.data import generate_synthetic_audio_mnist
    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from multimodal_mtrssm_tpu_torch.train.config import load_experiment
    from multimodal_mtrssm_tpu_torch.train.entry import default_config_path

    episodes = work / "episodes"
    generate_synthetic_audio_mnist(episodes, n_episodes=24, seed=SEED)
    total: dict[str, int] = {}
    for family in ("mrssm", "mmtrssm"):
        rec = "recurrence" if family == "mrssm" else "mt_recurrence"
        for layout in ("nhwc", "fused_enc"):
            exp = load_experiment(default_config_path(f"mopoe_{family}.yaml"), {
                "trainer": {"precision": "16-mixed", "max_epochs": 2},
                "model": {"init_args": {"conv_layout": layout}}})
            if exp.model.cfg.conv_dtype != torch.bfloat16:
                raise RuntimeError("16-mixed did not set the bf16 conv dtype")
            exp.data.data_dir = episodes
            exp.trainer.seed = SEED
            exp.trainer.log_dir = str(work / f"{family}_{layout}")
            trainer = exp.build_trainer(device=dev)
            reset_launch_counts()
            out = trainer.fit()
            torch.cuda.synchronize()
            counts = launch_counts()
            steps = out["global_step"]
            label = f"{family} 16-mixed {layout}"
            if not all(np.isfinite(v) for row in out["history"] for v in row.values()):
                raise RuntimeError(f"{label}: non-finite training metrics")
            enc = (counts["fused_encoder_fwd_bf16"], counts["fused_encoder_bwd_bf16"])
            warm = _warmup_launches(trainer)
            want = (2 * steps, 2 * steps + warm.get("fused_encoder_bwd_bf16", 0)) \
                if layout == "fused_enc" else (0, 0)
            if (counts["fused_encoder_fwd"] or counts["fused_encoder_bwd"] or
                    enc[1] != want[1] or enc[0] < want[0]
                    or counts[f"{rec}_bwd"] != steps + warm.get(f"{rec}_bwd", 0)):
                raise RuntimeError(f"{label}: launches {counts} over {steps} steps")
            print(f"main-path kernel launches, {label} fit, {steps} optimizer steps: {counts}; "
                  f"{out['history'][-1]['train/loss']:.6g} train/loss last epoch; "
                  f"{steps / max(out['train_seconds'], 1e-9):.3f} steps/s | {card}")
            total = {k: total.get(k, 0) + v for k, v in counts.items()}
            model = trainer.model
            batch, noise = _train_batch(np.random.default_rng(SEED + 5), 8, 30, model)
            reset_launch_counts()
            with torch.no_grad():
                model.observe(*(x.to(dev) for x in batch[:3]), _noise_to(noise, dev))
            torch.cuda.synchronize()
            seen = launch_counts()
            if seen["fused_encoder_fwd"] or (layout == "fused_enc") != bool(
                    seen["fused_encoder_fwd_bf16"]):
                raise RuntimeError(f"{label}: an observe launched {seen}")
            print(f"main-path kernel launches, {label} observe B=8 T=30: {seen}")
            total = {k: total[k] + v for k, v in seen.items()}
            cpu_model = type(model)(model.cfg)
            cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
            r = _step_vs(model, cpu_model, dev, torch.device("cpu"), MIXED_RTOL, MIXED_REL,
                         MIXED_TIE, (2, 5))
            print(f"train step card vs CPU, {label} B=2 T=5 (seed {r['seed']}): loss err/loss "
                  f"{max(r['loss_rel_errs'].values()):.3g} (limit {MIXED_RTOL}), grad "
                  f"max_abs_err {r['grad_max_abs_err']:.3g} (limit {MIXED_REL} x "
                  f"{r['grad_scale']:.4g})")
            step_timings(model, dev, card)
    return total


def drive_learning_path(dev, work: Path) -> dict:
    """Phase 8(d): ``demo_e2e`` and ``probe_transitions`` of each family at
    one seed, 2 epochs and 24 episodes on the card (the decisive flags), as
    path checks: the results' and the probe's keys. Returns the launch
    counts."""
    from multimodal_mtrssm_tpu_torch import demo_e2e, probe_transitions
    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    for family in ("mrssm", "mmtrssm"):
        t0 = time.perf_counter()
        demo_e2e.main(["--workdir", str(work / f"demo_{family}"), "--model", family, "--epochs",
                       "2", "--episodes", "24", "--frames-per-word", "1", "--query-length", "1",
                       "--classify-frame", "1"])
        results = json.loads((work / f"demo_{family}" / "results" /
                              "word_transitions.json").read_text())
        if set(results) != {"per_word", "summary"}:
            raise RuntimeError(f"demo_e2e {family}: results keys {set(results)}")
        payload = probe_transitions.main(["--workdir", str(work / f"probe_{family}"), "--model",
                                          family, "--epochs", "2", "--episodes", "24"])
        if set(payload) != {"means", "per_digit"} or set(payload["means"]) != {
                "frame1", "frame2", "frame3"}:
            raise RuntimeError(f"probe_transitions {family}: keys {set(payload)}")
        print(f"demo_e2e + probe_transitions {family} (1 seed, 2 epochs, 24 episodes): MR "
              f"{results['summary']['mean_matching_rate']:.3f}, probe means {payload['means']}, "
              f"{time.perf_counter() - t0:.1f} s")
    return launch_counts()


# ---- phase 9: the weighted and unimodal families --------------------------------------------

FAMILY_PATHS = {"WeightedMoPoEMRSSM": {},
                "RSSM": {"data": {"init_args": {"config": {"modality": "vision"}}}}}


def _family_experiment(family: str, work: Path, episodes: Path, **model_args):
    """``configs/mopoe_mrssm.yaml`` with ``class_path`` swapped to ``family``
    (and :data:`FAMILY_PATHS`' data), 2 epochs on ``episodes``, its run
    under ``work``; the merged YAML is written there for serving. Returns
    ``(experiment, yaml path)``."""
    import yaml

    from multimodal_mtrssm_tpu_torch.train.config import _deep_merge, load_experiment
    from multimodal_mtrssm_tpu_torch.train.entry import default_config_path

    over = _deep_merge(FAMILY_PATHS[family], {
        "model": {"class_path": f"multimodal_mtrssm_tpu.models.{family}",
                  "init_args": model_args},
        "trainer": {"max_epochs": 2}, "seed_everything": SEED, "log_dir": str(work / family),
        "data": {"init_args": {"config": {"data_dir": str(episodes)}}}})
    exp = load_experiment(default_config_path("mopoe_mrssm.yaml"), over)
    work.mkdir(parents=True, exist_ok=True)
    if type(exp.model).__name__ != family or exp.pending:
        raise RuntimeError(f"{family}: the YAML built {type(exp.model).__name__}, pending "
                           f"{exp.pending}")
    path = work / f"{family}.yaml"
    path.write_text(yaml.safe_dump(exp.raw))
    return exp, path


def _family_batch(rng, model, B: int = 8, T: int = 30):
    """``_train_batch``'s batch and noise, as the family takes them: the
    unimodal RSSM's 4-tuple of the action and the vision streams."""
    batch, noise = _train_batch(rng, B, T, model)
    if hasattr(model.cfg, "audio_encoder"):
        return batch, noise
    noise["input"] = (noise["input"][0], noise["input"][2])
    return (batch[0], batch[2], batch[3], batch[5]), noise


def _family_step_times(model, dev, card: str, label: str) -> dict:
    """A train step (forward, backward, AdamW) at B=8 T=30: its CUDA-event
    median ms, its device ms under ``torch.profiler`` and the busy share."""
    import torch

    from multimodal_mtrssm_tpu_torch.train import AdamW, one_update

    batch, _ = _family_batch(np.random.default_rng(SEED + 8), model)
    batch = tuple(x.to(dev) for x in batch)
    opt = AdamW(model.parameters())
    gen = torch.Generator(device=dev).manual_seed(SEED)
    step = lambda: one_update(model, opt, batch, gen)  # noqa: E731
    ms = _median_ms(step, 5, warmup=1)
    device = _device_ms(step, "", reps=3)
    busy = "not measured" if device is None else f"{device:.4f} ms ({device / ms:.1%} busy)"
    print(f"time {label} train step B=8 T=30 (forward, backward, AdamW): {ms:.4f} ms, device "
          f"{busy} | {card}")
    return {"ms": ms, "device_ms": device}


def _family_vs_cpu(model, dev, label: str) -> None:
    """One train step of ``model`` on the card against its CPU copy on a
    seed without Gumbel near-ties (the phase 4 bounds), then the posterior
    and prior of another seed (and the weighted model's subset weights)
    within ``TOL`` before each row's first near-tie."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import (
        check_same_trajectories,
        check_train_step,
        first_near_tie,
        train_step_near_ties,
    )

    cpu_dev = torch.device("cpu")
    cpu = type(model)(model.cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    for seed in range(SEED + 10, SEED + 30):
        batch, noise = _family_batch(np.random.default_rng(seed), cpu)
        if train_step_near_ties(cpu, batch, noise, TIE_EPS) == 0:
            break
    else:
        raise RuntimeError(f"{label}: no seed without near-ties for the train-step check")
    r = check_train_step(model, cpu, (tuple(x.to(dev) for x in batch), _noise_to(noise, dev)),
                         (batch, noise), STEP_RTOL, STEP_TOL)
    print(f"train step card vs CPU {label} B=8 T=30 (seed {seed}): loss err/loss "
          f"{max(r['loss_rel_errs'].values()):.3g} (limit {STEP_RTOL}), grad max_abs_err "
          f"{r['grad_max_abs_err']:.3g} (limit {STEP_TOL} x {r['grad_scale']:.4g})")
    batch, noise = _family_batch(np.random.default_rng(SEED + 31), cpu)
    cfg = model.cfg
    n = len(batch) // 2
    outs = []
    with torch.no_grad():
        for m, d in ((model, dev), (cpu, cpu_dev)):
            obs = [x.to(d) for x in batch[1:n]]
            g = [noise[k].to(d) for k in ("g_init", "g_prior", "g_post")]
            init = m.initial_state(*(x[:, 0] for x in obs), g[0])
            if hasattr(m, "rollout_representation_with_weights"):
                post, prior, weights = m.rollout_representation_with_weights(
                    batch[0].to(d), *obs, init, g[1], g[2])
            else:
                (post, prior), weights = m.rollout_representation(
                    batch[0].to(d), *obs, init, g[1], g[2]), None
            # Straight-through stochs are (onehot + p) - p: their categories
            # are compared (rounded), their ulps follow p's.
            fields = [post.deter, post.logits, post.stoch.round(), prior.logits,
                      prior.stoch.round()]
            outs.append((fields + ([] if weights is None else [weights]), init, post, prior, g))
    (got, *_), (ref, init, post, prior, g) = outs
    C, K = cfg.class_size, cfg.category_size
    tm = lambda x: x.transpose(0, 1)  # noqa: E731
    first = first_near_tie([(post.logits + tm(g[2]), C, K), (prior.logits + tm(g[1]), C, K)],
                           TIE_EPS)
    # A near-tie of the initial sample moves every step of its row.
    first = torch.where(first_near_tie([((init.logits + g[0])[:, None], C, K)], TIE_EPS) == 0,
                        0, first)
    out = check_same_trajectories([x.cpu() for x in got], ref, (2, 4), first, TOL)
    msg = (f"states card vs CPU {label} B=8 T=30: max_abs_err {out['max_abs_err']:.3g} (limit "
           f"{TOL}), {float(first.float().mean()) / batch[0].shape[1]:.0%} of steps before a "
           "near-tie")
    if len(got) > 5:
        err = float((got[5].sum(-1) - 1).abs().max())
        if not err <= 1e-5:
            raise RuntimeError(f"{label}: subset weights sum to 1 within {err:.3g} > 1e-5")
        msg += f"; subset weights [8, 30, 3] sum to 1 within {err:.3g} (limit 1e-5)"
    print(msg)


def _family_rollout(model, dev, label: str) -> dict[str, int]:
    """The model's imagination at B=8 T=10 on the card: its rollout launches
    and the rollout held to the plain transition and its Philox noise
    (``parity.check_rollout``, phase 3's check), then to the plain route's
    imagination on the CPU before each row's first near-tie."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import check_rollout, check_same_rollouts

    cfg = model.cfg
    B, T, seed = 8, 10, 5
    rng = np.random.default_rng(SEED + 12)
    act = torch.tensor(rng.uniform(-1, 1, (B, T, cfg.action_size)).astype(np.float32),
                       device=dev)
    frames = [torch.tensor(rng.uniform(-1, 1, (B, 32, 32, 1)).astype(np.float32), device=dev)
              for _ in range(2 if hasattr(cfg, "audio_encoder") else 1)]
    g_init = torch.tensor(rng.gumbel(size=(B, cfg.stoch_size)).astype(np.float32), device=dev)
    with torch.no_grad():
        init = model.initial_state(*frames, g_init)
        reset_launch_counts()
        got = model.rollout_transition(act, init, seed)
        torch.cuda.synchronize()
        counts = launch_counts()
        if counts["rollout"] != 1 or sum(counts.values()) != 1:
            raise RuntimeError(f"{label} imagination launched {counts}")
        r = check_rollout(model.transition.weights(), act, init.deter, init.stoch, seed,
                          (got.deter, got.logits, got.stoch), cfg.class_size, cfg.category_size,
                          TOL, TIE_EPS)
        plain = type(model)(dataclasses.replace(cfg, use_pallas_train=False))
        plain.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        ref = plain.rollout_transition(act.cpu(), init.to("cpu"), seed).to(dev)
        same = check_same_rollouts(got, ref, cfg, seed, TOL, TIE_EPS)
    print(f"imagination {label} B={B} T={T} on rollout.cu: 1 launch; vs the plain transition "
          f"max_abs_err {r['max_abs_err']:.3g} (limit {TOL}), {r['compared']:.0%} of blocks "
          f"resampled; vs the plain route on the CPU max_abs_err {same['max_abs_err']:.3g}, "
          f"{same['compared']:.0%} of steps before a near-tie")
    return counts


def _fit_family(exp, dev, card: str, label: str) -> tuple[object, dict[str, int]]:
    """``exp``'s fit (2 epochs × 3 steps at B=8 T=30) on the card: finite
    metrics, no recurrence kernel of any kind launched. Returns the trained
    model and the fit's launch counts."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    trainer = exp.build_trainer(device=dev)
    reset_launch_counts()
    out = trainer.fit()
    torch.cuda.synchronize()
    counts = launch_counts()
    steps = out["global_step"]
    if steps < 4 or not all(np.isfinite(v) for row in out["history"] for v in row.values()):
        raise RuntimeError(f"{label} fit: {steps} steps, history {out['history']}")
    if any(counts[k] for k in ROUTE_KERNELS):
        raise RuntimeError(f"{label} fit launched a recurrence or rollout kernel: {counts}")
    print(f"main-path kernel launches, {label} fit, {steps} optimizer steps: {counts}; "
          f"{out['history'][-1]['train/loss']:.6g} train/loss last epoch; "
          f"{steps / max(out['train_seconds'], 1e-9):.3f} steps/s | {card}")
    return trainer.model, counts


def drive_other_families(dev, work: Path, card: str) -> dict:
    """Phase 9: the weighted model and the unimodal RSSM from the YAML
    (module docstring, 9). Returns the launch counts of their main paths:
    the fits, the served requests, the imaginations, the fused_enc step."""
    import torch

    from multimodal_mtrssm_tpu_torch.data import generate_synthetic_audio_mnist
    from multimodal_mtrssm_tpu_torch.models import WeightedMoPoEMRSSM
    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from multimodal_mtrssm_tpu_torch.serving import WorldModel
    from multimodal_mtrssm_tpu_torch.train import AdamW, one_update

    t0 = time.perf_counter()
    episodes = work / "episodes"
    generate_synthetic_audio_mnist(episodes, n_episodes=24, seed=SEED)
    runs: list[dict[str, int]] = []

    # (a) WeightedMoPoE-MRSSM.
    label = "WeightedMoPoEMRSSM"
    exp, path = _family_experiment(label, work, episodes)
    model, counts = _fit_family(exp, dev, card, label)
    runs.append(counts)
    _family_vs_cpu(model, dev, label)  # phase 12 times its step, eager and graphed
    served = WorldModel.from_checkpoint(path, Path(exp.trainer.log_dir) / "checkpoints", dev)
    with torch.no_grad():
        ctx = drive_server(served.model, served.model.cfg, dev, {"rollout": 2})
    ctx["server"].stop()
    if any(ctx["counts"][k] for k in ROUTE_KERNELS if k != "rollout"):
        raise RuntimeError(f"{label} serving launched a recurrence kernel: {ctx['counts']}")
    runs += [ctx["counts"], _family_rollout(served.model, dev, label)]
    try:
        WeightedMoPoEMRSSM(dataclasses.replace(model.cfg, use_pallas_train=True))
    except ValueError as e:
        print(f"{label} use_pallas_train=True refused: {e}")
    else:
        raise RuntimeError(f"{label} took use_pallas_train=True")
    fused, _ = _family_experiment(label, work / "fused", episodes, conv_layout="fused_enc")
    fmodel = fused.model.to(dev)
    fmodel.load_state_dict(model.state_dict())
    batch, _ = _family_batch(np.random.default_rng(SEED + 9), fmodel)
    reset_launch_counts()
    one_update(fmodel, AdamW(fmodel.parameters()), tuple(x.to(dev) for x in batch),
               torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts["fused_encoder_fwd"] < 2 or counts["fused_encoder_bwd"] != 2 or any(
            counts[k] for k in ROUTE_KERNELS):
        raise RuntimeError(f"{label} fused_enc step launched {counts}")
    print(f"main-path kernel launches, {label}(conv_layout=fused_enc) train step B=8 T=30: "
          f"{counts}")
    runs.append(counts)
    _family_step_times(fmodel, dev, card, f"{label}(conv_layout=fused_enc)")

    # (b) the unimodal RSSM on the vision stream.
    label = "RSSM(modality=vision)"
    exp, _ = _family_experiment("RSSM", work, episodes)
    model, counts = _fit_family(exp, dev, card, label)
    runs.append(counts)
    _family_vs_cpu(model, dev, label)  # phase 12 times its step, eager and graphed
    runs.append(_family_rollout(model, dev, label))
    print(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return {k: sum(r[k] for r in runs) for k in runs[0]}


# ---- phase 10: data-parallel training on torch.distributed -------------------------------------

# Gloo ranks sharing the one card (NCCL refuses two ranks on one device): the
# dry run at 4 (flat, ZeRO-1 and hybrid), step times at 2.
DP_DRYRUN_WORLDS, DP_STEP_WORLDS = (4,), (2,)
DP_HISTORY_RTOL = 1e-4  # a 2-rank fit's epoch means against the 1-process fit's


class _CollectiveTimer:
    """Phase 10 (d)'s timer of ``torch.distributed.all_reduce`` and
    ``all_gather``: inside ``with``, both are patched to record CUDA events
    around each call on a CUDA device (its device time) and the host clock
    (how long it held the host); the patch is undone on exit. :meth:`ms`
    and :meth:`host_ms` read each name's mean ms a call."""

    NAMES = ("all_reduce", "all_gather")

    def __init__(self, device):
        self.device = device
        self._events: dict[str, list] = {}
        self._host: dict[str, list[float]] = {}
        self._real: dict = {}

    def _timed(self, name: str, fn):
        import torch

        def timed(*args, **kwargs):
            events = None
            if self.device.type == "cuda":
                events = tuple(torch.cuda.Event(enable_timing=True) for _ in range(2))
                events[0].record()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self._host.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            if events is not None:
                events[1].record()
                self._events.setdefault(name, []).append(events)
            return out

        return timed

    def __enter__(self) -> "_CollectiveTimer":
        import torch.distributed as dist

        for name in self.NAMES:
            self._real[name] = getattr(dist, name)
            setattr(dist, name, self._timed(name, self._real[name]))
        return self

    def __exit__(self, *exc) -> None:
        import torch.distributed as dist

        for name, fn in self._real.items():
            setattr(dist, name, fn)

    def host_ms(self) -> dict[str, float]:
        return {name: sum(t) / len(t) for name, t in self._host.items()}

    def ms(self) -> dict[str, float]:
        """Device ms between the CUDA events, or the host clock's without them."""
        import torch

        out = self.host_ms()
        if self._events:
            torch.cuda.synchronize()
        for name, calls in self._events.items():
            out[name] = sum(a.elapsed_time(b) for a, b in calls) / len(calls)
        return out


def _dp_step_rank(device, reps: int = 10, use_mesh: bool = True) -> dict:
    """Phase 10 (d), a rank's side (the 1-process and NCCL W=1 cases run it
    in this process): ``MRSSMConfig()`` train steps at a global B=8 T=30,
    each rank on its rows with ZeRO-1 on a mesh (none without a process
    group or ``use_mesh``): the CUDA-event median ms a step, the
    optimizer's all-reduce and all-gather ms a step (:class:`_CollectiveTimer`),
    the device ms a step (``torch.profiler``) and the rank's kernel
    launches a step."""
    import itertools

    import torch
    import torch.distributed as dist

    from multimodal_mtrssm_tpu_torch.models import MoPoEMRSSM, MRSSMConfig
    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from multimodal_mtrssm_tpu_torch.parallel.mesh import make_mesh, mesh_rows, replicate
    from multimodal_mtrssm_tpu_torch.train import AdamW, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh() if use_mesh and dist.is_initialized() else None
    model = replicate(MoPoEMRSSM(MRSSMConfig()).init(torch.Generator().manual_seed(0))
                      .to(device), mesh)
    batch, _ = _train_batch(np.random.default_rng(SEED + 8), 8, 30, model)
    lo, hi = mesh_rows(8, mesh)
    local = tuple(x[lo:hi].to(device) for x in batch)
    opt = AdamW(model.parameters(), mesh=mesh, zero1=mesh is not None)
    train_step = make_train_step(model, opt)
    steps = itertools.count()
    rows = (lo, hi, 8) if mesh is not None else None
    step = lambda: train_step(local, SEED, next(steps), rows)  # noqa: E731
    ms = _median_ms(step, reps, warmup=3)
    with _CollectiveTimer(torch.device(device)) as timer:
        for _ in range(reps):
            step()
    collectives, host = timer.ms(), timer.host_ms()
    torch.cuda.synchronize()
    reset_launch_counts()
    step()
    torch.cuda.synchronize()
    launches = launch_counts()
    device_ms = _device_ms(step, "", reps=5)
    return {"ms": ms, "collectives": collectives, "host_collectives": host,
            "device_ms": device_ms, "rows": hi - lo, "launches": launches}


def _print_dp_time(name: str, t: dict, card: str) -> None:
    """One line of :func:`_dp_step_rank`'s numbers (rank 0's)."""
    dev_ms = t["device_ms"]
    busy = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms ({dev_ms / t['ms']:.1%} busy)"
    coll = ", ".join(f"{k} {v:.4f} ms (host {t['host_collectives'][k]:.4f})"
                     for k, v in t["collectives"].items()) or "none"
    zero1 = "" if not t["collectives"] else ", ZeRO-1"
    print(f"time distributed MRSSMConfig() train step, global B=8 T=30, {name} (rank 0: "
          f"{t['rows']} rows{zero1}): {t['ms']:.4f} ms a step; collectives a step: {coll}; "
          f"device {busy}; launches a step {t['launches']['recurrence_fwd']} fwd, "
          f"{t['launches']['recurrence_bwd']} bwd | {card}")


def _dp_fit_rank(device, episodes: str, run_dir: str) -> dict:
    """Phase 10 (c), a rank's side: ``Trainer.fit`` of
    ``MMTRSSMConfig(conv_layout="fused_enc")`` with ``zero1``, 2 × 3 steps
    at a global B=8 T=30 under deterministic cuDNN: the history, the
    weights (on the CPU), the optimizer steps and the rank's launches."""
    import torch

    from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig
    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with _deterministic_cudnn():
        trainer = _fit_maker(MMTRSSMConfig(conv_layout="fused_enc"), device, Path(episodes),
                             Path(run_dir))("dp", zero1=True)
        reset_launch_counts()
        out = trainer.fit()
        torch.cuda.synchronize()
    return {"history": out["history"], "steps": out["opt_state"]["count"],
            "weights": {k: v.cpu() for k, v in trainer.model.state_dict().items()},
            "launches": launch_counts()}


def _history_err(rows, ref) -> float:
    """The largest relative difference of two fits' ``train/`` and ``val/``
    epoch means."""
    return max(abs(r[k] - w[k]) / max(abs(w[k]), 1e-12) for r, w in zip(rows, ref, strict=True)
               for k in w if k.startswith(("train/", "val/")))


def _state_err(state: dict, ref) -> float:
    """``_weights_close``'s error of a state dict (on the CPU) against a model."""
    return max(float((state[k] - v.cpu()).abs().max()) / max(1.0, float(v.abs().max()))
               for k, v in ref.state_dict().items())


def drive_distributed(dev, work: Path, card: str, ref_model) -> dict:
    """Phase 10 (module docstring, 10): (a) ``Trainer.fit`` of
    ``MRSSMConfig()`` with ``zero1`` on an NCCL process group of one rank
    against phase 4b's uninterrupted fit (``ref_model``); (b) the dry run
    at 4 gloo ranks on the card; (c) a 2-rank gloo fit of
    ``MMTRSSMConfig(conv_layout="fused_enc")`` with ``zero1`` against the
    1-process fit; (d) ms a step at 1 process, NCCL W=1 and gloo W=2,
    the collectives' ms and the busy share. Returns the launch counts of
    every rank's main path, summed."""
    import datetime

    import torch
    import torch.distributed as dist

    from multimodal_mtrssm_tpu_torch.data import generate_synthetic_audio_mnist
    from multimodal_mtrssm_tpu_torch.dryrun import dryrun_multichip
    from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig, MRSSMConfig
    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from multimodal_mtrssm_tpu_torch.parallel.spawn import spawn

    t0 = time.perf_counter()
    episodes = work / "episodes"
    generate_synthetic_audio_mnist(episodes, n_episodes=24, seed=SEED)
    runs: list[dict[str, int]] = []

    # (a) NCCL at world size 1: the production backend's init and collectives.
    dist.init_process_group("nccl", init_method=f"file://{work / 'nccl-store'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=300))
    try:
        with _deterministic_cudnn():
            trainer = _fit_maker(MRSSMConfig(), dev, episodes, work)("nccl1", zero1=True)
            reset_launch_counts()
            out = trainer.fit()
            torch.cuda.synchronize()
            counts = launch_counts()
        if trainer.mesh is None or trainer.mesh.world != 1 or dist.get_backend() != "nccl":
            raise RuntimeError(f"NCCL W=1 fit trained on {trainer.mesh}")
        if counts["recurrence_bwd"] != 6 + _warmup_launches(trainer).get("recurrence_bwd", 0) \
                or out["opt_state"]["count"] != 6:
            raise RuntimeError(f"NCCL W=1 fit: {out['opt_state']['count']} steps, {counts}")
        err, same = _weights_close(trainer.model, ref_model)
        if not err <= WEIGHT_TOL:
            raise RuntimeError(f"NCCL W=1 fit differs from phase 4b's by {err:.3g} x scale")
        runs.append(counts)
        print(f"distributed (a) NCCL world 1, MRSSMConfig() zero1 fit 2 x 3 steps: weights vs "
              f"phase 4b's uninterrupted fit: max err {err:.3g} x scale (limit {WEIGHT_TOL}), "
              f"bit-identical: {'yes' if same else 'no'}; launches {counts}")
        # (d), in turns: the mesh off and on, on the same process group.
        times = [(name, _dp_step_rank(dev, use_mesh=name != "1 process"))
                 for name in ("1 process", "NCCL W=1", "NCCL W=1", "1 process")]
    finally:
        dist.destroy_process_group()

    # (b) the dry run: both families at the reference config on gloo ranks.
    for n in DP_DRYRUN_WORLDS:
        results = dryrun_multichip(n, device="cuda", backend="gloo")
        for rank, r in enumerate(results):
            c = r["launches"]
            if min(c["recurrence_bwd"], c["mt_recurrence_bwd"]) != (3 if n >= 4 else 2):
                raise RuntimeError(f"dryrun_multichip({n}) rank {rank} launched {c}")
            runs.append(c)
        print(f"distributed (b) dryrun_multichip({n}, cuda, gloo): per-rank launches "
              f"{[r['launches'] for r in results]}")

    # (c) 2 gloo ranks: the MMTRSSM fit at fused_enc, against 1 process.
    cfg = MMTRSSMConfig(conv_layout="fused_enc")
    with _deterministic_cudnn():
        one = _fit_maker(cfg, dev, episodes, work)("fe1", zero1=True)
        reset_launch_counts()
        one_out = one.fit()
        torch.cuda.synchronize()
        runs.append(launch_counts())
    ranks = spawn("chip_smoke:_dp_fit_rank", 2, "cuda", backend="gloo",
                  kwargs={"episodes": str(episodes), "run_dir": str(work / "dp2")},
                  timeout_s=900, group_timeout_s=600)
    for rank, r in enumerate(ranks):
        c = r["launches"]
        if r["steps"] != 6 or c["mt_recurrence_bwd"] != 6 or c["fused_encoder_bwd"] != 12 \
                or c["mt_recurrence_fwd"] < 6 or c["fused_encoder_fwd"] < 12:
            raise RuntimeError(f"2-rank fit rank {rank}: {r['steps']} steps, launches {c}")
        runs.append(c)
    h_err = _history_err(ranks[0]["history"], one_out["history"])
    w_err = _state_err(ranks[0]["weights"], one.model)
    same = all(torch.equal(ranks[0]["weights"][k], ranks[1]["weights"][k])
               for k in ranks[0]["weights"])
    if not (h_err <= DP_HISTORY_RTOL and w_err <= WEIGHT_TOL and same):
        raise RuntimeError(f"2-rank fit vs 1 process: history {h_err:.3g}, weights "
                           f"{w_err:.3g} x scale, ranks alike {same}")
    print(f"distributed (c) 2 gloo ranks on cuda:0, {_label(cfg)} zero1 fit 2 x 3 steps: "
          f"history vs the 1-process fit max rel err {h_err:.3g} (limit {DP_HISTORY_RTOL}), "
          f"weights {w_err:.3g} x scale (limit {WEIGHT_TOL}), both ranks' weights "
          f"bit-identical; per-rank launches {[r['launches'] for r in ranks]}")

    # (d) ms a step.
    for n in DP_STEP_WORLDS:
        times.append((f"gloo W={n}", spawn("chip_smoke:_dp_step_rank", n, "cuda",
                                           backend="gloo", timeout_s=600,
                                           group_timeout_s=300)[0]))
    for name, t in times:
        _print_dp_time(name, t, card)
    print(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return {k: sum(r.get(k, 0) for r in runs) for k in runs[0]}


# The learning demonstration's long runs (--learning-demo): each is one
# process of `python -m <argv>` with its own --workdir, started together on
# the one card. The demo at the JAX script's decisive flags, 5 seeds of each
# family; the cross-modal experiment at 100 epochs x 3 seeds; the probe at its
# defaults, for each family.
DECISIVE = ("--frames-per-word", "1", "--query-length", "1", "--classify-frame", "1",
            "--epochs", "100", "--episodes", "96", "--seeds", "5")
LEARNING_RUNS = {
    "mrssm": ("multimodal_mtrssm_tpu_torch.demo_e2e", "--model", "mrssm", *DECISIVE),
    "mmtrssm": ("multimodal_mtrssm_tpu_torch.demo_e2e", "--model", "mmtrssm", *DECISIVE),
    "crossmodal": ("multimodal_mtrssm_tpu_torch.crossmodal_e2e", "--epochs", "100", "--seeds", "3"),
    "probe_mrssm": ("multimodal_mtrssm_tpu_torch.probe_transitions", "--model", "mrssm"),
    "probe_mmtrssm": ("multimodal_mtrssm_tpu_torch.probe_transitions", "--model", "mmtrssm"),
}
# What of a run's work directory is kept (the episodes, checkpoints and GIFs
# are not): summaries, per-seed results and reports, each run's metrics.
LEARNING_KEEP = ("summary*.json", "probe.json", "**/word_transitions*.json",
                 "**/crossmodal_recon.json", "**/metrics.jsonl")


LEARNING_OUT = Path("runs") / "learning_demo"


def learning_demo_phase(out: Path = LEARNING_OUT) -> int:
    """``--learning-demo``: the long runs of :data:`LEARNING_RUNS` on the
    card, all at once (each process's log and what :data:`LEARNING_KEEP`
    names are copied under ``out``); prints each run's last lines and no
    contract lines. Fails if a run fails."""
    import os
    import shutil

    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    build.load_library()  # built once here, then loaded by every run
    out.mkdir(parents=True, exist_ok=True)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        procs = {}
        for name, argv in LEARNING_RUNS.items():
            log = open(out / f"{name}.log", "w")  # noqa: SIM115 (closed below)
            procs[name] = (subprocess.Popen([sys.executable, "-m", *argv, "--workdir",
                                             str(Path(tmp) / name)], stdout=log,
                                            stderr=subprocess.STDOUT, env=env,
                                            cwd=Path(__file__).resolve().parent), log)
            _CHILDREN.append(procs[name][0])
        failed = []
        for name, (proc, log) in procs.items():
            code = proc.wait()
            log.close()
            print(f"learning demo {name}: exit {code} after {time.perf_counter() - t0:.1f} s | "
                  f"{card}")
            print("\n".join((out / f"{name}.log").read_text().splitlines()[-12:]))
            if code != 0:
                failed.append(name)
            for pattern in LEARNING_KEEP:
                for src in (Path(tmp) / name).glob(pattern):
                    dst = out / name / src.relative_to(Path(tmp) / name)
                    dst.parent.mkdir(parents=True, exist_ok=True)
                    shutil.copy2(src, dst)
    if failed:
        print(f"learning demo: failed runs {failed}", file=sys.stderr)
        return 1
    return 0


# ---- phase 11: full-model bf16 and the bf16 fused decoder ------------------------------------

# The device kernels of one fused_decoder_bf16_forward_cuda call and of one
# fused_decoder_bf16_backward_cuda call, which recomputes through the
# forward's; and the first bf16 decoder's (the f32 decoder's kernels at
# bf16, then the rounding of the gradients), which --bf16-decoder times in a
# parent archive.
DECODER_BF16_FWD_KERNELS = {"pack": "decoder_bf16_tc_pack_kernel",
                            "forward": "decoder_bf16_tc_fwd_kernel"}
DECODER_BF16_BWD_KERNELS = {**DECODER_BF16_FWD_KERNELS,
                            "cotangent pass": "decoder_bf16_tc_dx_kernel",
                            "weight-gradient pass": "decoder_bf16_tc_dw_kernel",
                            "reduce": "decoder_bf16_tc_reduce_kernel"}
DECODER_BF16_BWD_KERNELS_FIRST = {**DECODER_BWD_KERNELS,
                                  "rounding to bf16": "decoder_bf16_round_kernel"}
# Full-model bf16 against the CPU: the steps of a row before the first Gumbel
# near-tie of MIXED_TIE are compared (bf16 moves the logits by ~1e-3), at
# least MIN_COMPARED of them.
FULL_BF16_SHAPE = (2, 10)


def _bf16_decoder_case(label: str, model, feats, name: str = "audio") -> dict:
    """The model's ``name`` decoder at bf16: its f32 and bf16 weights, the
    observed f32 features and their bf16 cast, and a bf16 cotangent of the
    frames made by numpy."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv

    dec = getattr(model, f"{name}_decoder")
    w32 = [t.detach() for t in fused_conv.decoder_weights(dec)]
    N = feats.shape[0]
    rng = np.random.default_rng(SEED + 19 + N + feats.shape[1])
    g = torch.tensor(rng.standard_normal((N, 32, 32, 1)).astype(np.float32), device=feats.device)
    return {"label": label, "dec": dec, "w32": w32, "w": [t.to(torch.bfloat16) for t in w32],
            "f32": feats, "feats": feats.to(torch.bfloat16), "g": g.to(torch.bfloat16)}


def drive_decoder_bf16(cases, dev) -> dict:
    """Phase 11(a)'s path: ``fused_decoder_apply`` on both decoders of each
    model over its observed features cast to bf16 (``cases``: phase 5's, at
    B=8 T=30), forward and a ``gaussian_nll`` backward to the features and
    every parameter, with every launch count set to 0 just before and read
    just after: each bf16 decoder kernel once a decoder and nothing else,
    bf16 frames and features' cotangent, float32 parameter gradients."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import (
        fused_decoder_apply,
        launch_counts,
        reset_launch_counts,
    )
    from multimodal_mtrssm_tpu_torch.ops.likelihood import gaussian_nll

    rng = np.random.default_rng(SEED + 20)
    targets = [torch.tensor(rng.uniform(-1, 1, (feats.shape[0], 32, 32, 1)).astype(np.float32),
                            device=dev) for *_, feats in cases for _ in range(2)]
    n = 0
    reset_launch_counts()
    for label, model, _, feats in cases:
        for name in ("audio", "vision"):
            dec = getattr(model, f"{name}_decoder")
            x = feats.to(torch.bfloat16).requires_grad_()
            with torch.enable_grad():
                frames = fused_decoder_apply(dec, x)
                dx, *dw = torch.autograd.grad(gaussian_nll(frames, targets[n], 3),
                                              [x, *dec.parameters()])
            n += 1
            if frames.dtype != torch.bfloat16 or dx.dtype != torch.bfloat16 or not all(
                    g.dtype == torch.float32 and bool(g.isfinite().all()) for g in dw):
                raise RuntimeError(f"bf16 decoder path {label} {name}: frames {frames.dtype}, "
                                   f"features' cotangent {dx.dtype}, parameter gradients "
                                   f"{sorted({str(g.dtype) for g in dw})}")
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {"fused_decoder_fwd_bf16": n, "fused_decoder_bwd_bf16": n}
    print(f"main-path kernel launches, bf16 fused decoder path (both decoders of "
          f"{' and '.join(c[0] for c in cases)} on their observed features cast to bf16, B=8 "
          f"T=30, forward and gaussian_nll backward): {counts}")
    if {k: v for k, v in counts.items() if v} != want:
        raise RuntimeError(f"the bf16 decoder path launched {counts}, expected {want}")
    return counts


def check_decoder_bf16(cases: list[dict]) -> dict[str, dict]:
    """Phase 11(a), bf16 fused decoder per case (N=240 and 3840, 48- and
    96-wide features): the forward kernel against the plain bf16 version
    (BF16_FWD_TOL × scale) and the f32 kernel on the f32 features and
    weights (BF16_VS_F32), the backward (every weight gradient and the
    features') against the plain bf16 backward (BF16_BWD_TOL × scale per
    tensor); two launches of each bit-identical."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv
    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import ParityError, check_gradients

    fwd, bwd = fused_conv.fused_decoder_bf16_forward_cuda, fused_conv.fused_decoder_bf16_backward_cuda
    fwd_err = bwd_err = 0.0
    for c in cases:
        cfg, w, x, g = c["dec"].cfg, c["w"], c["feats"], c["g"]
        where = f"{c['label']} audio N={x.shape[0]} F={x.shape[1]}"
        got, again = fwd(w, cfg, x), fwd(w, cfg, x)
        plain = fused_conv.fused_decoder_plain(w, cfg, x).float()
        f32 = fused_conv.fused_decoder_forward_cuda(c["w32"], cfg, c["f32"])
        scale = max(1.0, float(plain.abs().max()))
        err, err32 = (float((got.float() - ref).abs().max()) for ref in (plain, f32))
        if not (err <= BF16_FWD_TOL * scale and err32 <= BF16_VS_F32 and torch.equal(got, again)):
            raise ParityError(f"fused_decoder_fwd_bf16 {where}: {err:.3g} vs plain (limit "
                              f"{BF16_FWD_TOL} x {scale:.3g}), {err32:.3g} vs f32 (limit "
                              f"{BF16_VS_F32}), or two launches differ")
        dx, dw = bwd(w, cfg, x, g, True)
        dx2, dw2 = bwd(w, cfg, x, g, True)
        ref_dx, ref_dw = fused_conv.fused_decoder_backward_plain(w, cfg, x, g, True)
        got_b = [t.float() for t in (*dw, dx)]
        ref_b = [t.float() for t in (*ref_dw, ref_dx)]
        scaled = check_gradients(got_b, ref_b, BF16_BWD_TOL)
        if not all(torch.equal(a, b) for a, b in zip([*dw, dx], [*dw2, dx2])):
            raise ParityError(f"fused_decoder_bwd_bf16 {where}: two launches differ")
        berr = max(float((a - b).abs().max()) for a, b in zip(got_b, ref_b))
        print(f"check fused_decoder_fwd_bf16 {where}: max_abs_err={err:.3g} vs plain bf16 (limit "
              f"{BF16_FWD_TOL} x {scale:.3g}), {err32:.3g} vs the f32 kernel (limit "
              f"{BF16_VS_F32}); fused_decoder_bwd_bf16: max_abs_err={berr:.3g} max_err/scale="
              f"{scaled:.3g} vs the plain bf16 backward (limit {BF16_BWD_TOL}); two launches of "
              "each bit-identical")
        fwd_err, bwd_err = max(fwd_err, err), max(bwd_err, berr)
    return {"fused_decoder_fwd_bf16": {"max_abs_err": fwd_err},
            "fused_decoder_bwd_bf16": {"max_abs_err": bwd_err}}


def decoder_bf16_timings(cases: list[dict], dev, card: str) -> tuple[dict, dict, dict]:
    """Phase 11(a) timings per case: the bf16 decoder kernels against their
    plain bf16 versions, beside the f32 kernels (on the f32 features and
    weights) and the cuDNN ``Decoder`` on the bf16 features (forward, and
    forward + backward to the features and every parameter), CUDA-event ms
    a call and the device ms of each kernel of a forward and of a backward
    call (``torch.profiler``); the bound at the bf16 peak. Returns the first
    case's times, library times and bounds, for the kernels line."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import fused_conv

    fwd, bwd = fused_conv.fused_decoder_bf16_forward_cuda, fused_conv.fused_decoder_bf16_backward_cuda
    main_t: dict[str, tuple[float, float]] = {}
    library: dict[str, float] = {}
    bounds: dict[str, dict] = {}
    for c in cases:
        dec, w, x, g, w32, f32 = c["dec"], c["w"], c["feats"], c["g"], c["w32"], c["f32"]
        cfg, N = dec.cfg, x.shape[0]
        k_ms = _median_ms(lambda: fwd(w, cfg, x), 20)
        p_ms = _median_ms(lambda: fused_conv.fused_decoder_plain(w, cfg, x), 10)
        f_ms = _median_ms(lambda: fused_conv.fused_decoder_forward_cuda(w32, cfg, f32), 20)
        l_ms = _median_ms(lambda: dec(x), 20)
        kb_ms = _median_ms(lambda: bwd(w, cfg, x, g, True), 10)
        pb_ms = _median_ms(lambda: fused_conv.fused_decoder_backward_plain(w, cfg, x, g, True), 5)
        fb_ms = _median_ms(lambda: fused_conv.fused_decoder_backward_cuda(
            w32, cfg, f32, g.float(), True), 10)
        xg, params = x.clone().requires_grad_(), list(dec.parameters())
        with torch.enable_grad():
            lb_ms = _median_ms(lambda: torch.autograd.grad(dec(xg), [xg, *params], g), 10)
        what = f"{c['label']} N={N} F={cfg.in_features}"
        seen: list = []
        fwd_parts = _device_breakdown(lambda: fwd(w, cfg, x),
                                      tuple(DECODER_BF16_FWD_KERNELS.values()), seen=seen)
        if not any(fwd_parts.values()):
            # Full runs' windows can lose every device record (the launches
            # are there, _device_breakdown): once more, 50 calls.
            print(f"fused_decoder_fwd_bf16 {what}: the profiler saw none of its kernels in 10 "
                  f"calls; it saw {seen or 'no event'}; taking 50")
            fwd_parts = _device_breakdown(lambda: fwd(w, cfg, x),
                                          tuple(DECODER_BF16_FWD_KERNELS.values()), 50)
        _print_breakdown(f"fused_decoder_fwd_bf16 {what}", fwd_parts, DECODER_BF16_FWD_KERNELS,
                         card)
        bwd_parts = _device_breakdown(lambda: bwd(w, cfg, x, g, True),
                                      tuple(DECODER_BF16_BWD_KERNELS.values()))
        _print_breakdown(f"fused_decoder_bwd_bf16 {what}", bwd_parts, DECODER_BF16_BWD_KERNELS,
                         card)
        macs = _decoder_macs(cfg) * N
        b_fwd = _bound(2 * macs, _nbytes(w, x) + 2 * g.numel(), PEAK_BF16_FLOPS)
        # Recompute, feature and input cotangents, weight gradients.
        b_bwd = _bound(6 * macs, 2 * _nbytes(w, x) + _nbytes(g), PEAK_BF16_FLOPS)
        print(f"time fused_decoder_fwd_bf16 {what}: kernel {k_ms:.4f} ms, plain bf16 {p_ms:.4f} "
              f"ms, the f32 kernel {f_ms:.4f} ms, cuDNN Decoder on bf16 features {l_ms:.4f} ms, "
              f"bound {b_fwd['bound_ms']:.6f} ms ({b_fwd['bound_by']}); fused_decoder_bwd_bf16 "
              f"(recompute, feature and weight gradients): kernel {kb_ms:.4f} ms, plain bf16 "
              f"{pb_ms:.4f} ms, the f32 kernels {fb_ms:.4f} ms, cuDNN Decoder bf16 forward + "
              f"backward {lb_ms:.4f} ms, bound {b_bwd['bound_ms']:.6f} ms ({b_bwd['bound_by']}) | "
              f"{card}")
        if "fused_decoder_fwd_bf16" not in main_t:
            main_t["fused_decoder_fwd_bf16"] = (k_ms, p_ms)
            main_t["fused_decoder_bwd_bf16"] = (kb_ms, pb_ms)
            library["fused_decoder_fwd_bf16"], library["fused_decoder_bwd_bf16"] = l_ms, lb_ms
            bounds["fused_decoder_fwd_bf16"], bounds["fused_decoder_bwd_bf16"] = b_fwd, b_bwd
    return main_t, library, bounds


def _cut_steps(batch: tuple, noise: dict, steps: int) -> tuple[tuple, dict]:
    """A batch and its noise cut to their first ``steps`` steps: the
    initial samples' noise whole, the sites' ``[T, B, ·]`` and the input
    normals' ``[B, T, ·]`` cut on their time axis."""
    def cut(k, v):
        if k == "input":
            return tuple(x[:, :steps].contiguous() for x in v)
        return v if k.startswith("g_init") else v[:steps].contiguous()

    return (tuple(x[:, :steps].contiguous() for x in batch),
            {k: cut(k, v) for k, v in noise.items()})


def _first_tied_step(model, batch: tuple, noise: dict, tie_eps: float) -> int:
    """The first step at which any row of ``model``'s ``shared_step`` on
    ``batch`` and ``noise`` samples a block whose top two Gumbel scores lie
    within ``tie_eps`` (``parity.first_near_tie`` over every sample site
    that feeds the loss; 0 where an initial sample has one; T where none
    has)."""
    import torch

    from multimodal_mtrssm_tpu_torch.models.state import MTState
    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import first_near_tie, near_ties

    with torch.no_grad():
        init, post, prior, g = model._observe_batch(batch, noise, None)
    cfg = model.cfg
    tm = lambda x: x.transpose(0, 1)  # noqa: E731
    if isinstance(init, MTState):
        ls, hs = (cfg.ls_class, cfg.ls_category), (cfg.hs_class, cfg.hs_category)
        sites = [(post.logits_l + tm(g["g_lpost"]), *ls), (prior.logits_l + tm(g["g_lprior"]), *ls),
                 (post.logits_h + tm(g["g_hpost"]), *hs), (prior.logits_h + tm(g["g_hprior"]), *hs)]
        init_sites = [(init.logits_h + g["g_init_h"], *hs), (init.logits_l + g["g_init_l"], *ls)]
    else:
        C, K = cfg.class_size, cfg.category_size
        sites = [(post.logits + tm(g[2]), C, K), (prior.logits + tm(g[1]), C, K)]
        init_sites = [(init.logits + g[0], C, K)]
    if any(bool(near_ties(s, c, k, tie_eps).any()) for s, c, k in init_sites):
        return 0
    return int(first_near_tie(sites, tie_eps).min())


def _full_bf16_vs_cpu(model, dev, label: str) -> None:
    """One train step of the bf16 ``model`` on the card against its CPU copy
    (``parity.check_train_step`` at the bf16 bounds MIXED_RTOL, MIXED_REL)
    at FULL_BF16_SHAPE, on the steps before the first Gumbel near-tie of
    MIXED_TIE of the first seed where those are at least MIN_COMPARED of
    them; the card's gradients float32 and finite."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels.parity import check_train_step, train_step_grads

    cpu = type(model)(model.cfg)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    B, T = FULL_BF16_SHAPE
    for seed in range(SEED + 50, SEED + 80):
        batch, noise = _train_batch(np.random.default_rng(seed), B, T, cpu)
        steps = _first_tied_step(cpu, batch, noise, MIXED_TIE)
        if steps >= MIN_COMPARED * T:
            break
    else:
        raise RuntimeError(f"{label}: no seed with {MIN_COMPARED} of the steps before a near-tie")
    batch, noise = _cut_steps(batch, noise, steps)
    on_card = (tuple(x.to(dev) for x in batch), _noise_to(noise, dev))
    _, grads = train_step_grads(model, *on_card)
    if not all(g.dtype == torch.float32 and bool(g.isfinite().all()) for g in grads.values()):
        raise RuntimeError(f"{label}: gradients not all float32 and finite")
    r = check_train_step(model, cpu, on_card, (batch, noise), MIXED_RTOL, MIXED_REL)
    print(f"train step card vs CPU {label} B={B} T={steps} (seed {seed}: {steps} of {T} steps "
          f"before the first near-tie of {MIXED_TIE}): loss err/loss "
          f"{max(r['loss_rel_errs'].values()):.3g} (limit {MIXED_RTOL}), grad max_abs_err "
          f"{r['grad_max_abs_err']:.3g} (limit {MIXED_REL} x {r['grad_scale']:.4g}); gradients "
          "float32 and finite")


def _state_dtypes(model, dev, label: str) -> None:
    """The carries of a bf16 ``shared_step``'s filtering in bf16, its logits
    and samples in float32."""
    import torch

    from multimodal_mtrssm_tpu_torch.models.state import MTState

    batch, noise = _train_batch(np.random.default_rng(SEED + 5), 8, 30, model)
    with torch.no_grad():
        _, post, prior, _ = model._observe_batch(tuple(x.to(dev) for x in batch),
                                                 _noise_to(noise, dev), None)
    if isinstance(post, MTState):
        carries = (post.deter_h, post.deter_l, post.hidden_h, post.hidden_l)
        floats = (post.logits_h, post.logits_l, prior.logits_h, prior.logits_l, post.stoch_l)
    else:
        carries, floats = (post.deter,), (post.logits, prior.logits, post.stoch, prior.stoch)
    if not (all(x.dtype == torch.bfloat16 for x in carries) and
            all(x.dtype == torch.float32 for x in floats)):
        raise RuntimeError(f"{label}: carries {[x.dtype for x in carries]}, logits and samples "
                           f"{[x.dtype for x in floats]}")
    print(f"{label}: the carries bf16, the logits and samples float32")


def drive_full_bf16(dev, work: Path, card: str) -> dict:
    """Phase 11(b)-(d): full-model bf16 (module docstring, 11). Returns the
    launch counts of the fits, the served requests and the imagination."""
    import torch

    from multimodal_mtrssm_tpu_torch.data import (
        DataModuleConfig,
        EpisodeDataModule,
        generate_synthetic_audio_mnist,
    )
    from multimodal_mtrssm_tpu_torch.models import (
        MMTRSSMConfig,
        MoPoEMMTRSSM,
        MoPoEMRSSM,
        MRSSMConfig,
    )
    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from multimodal_mtrssm_tpu_torch.serving import WorldModel
    from multimodal_mtrssm_tpu_torch.train import Trainer, TrainerConfig

    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    episodes = work / "episodes"
    generate_synthetic_audio_mnist(episodes, n_episodes=24, seed=SEED)
    dm = EpisodeDataModule(DataModuleConfig(data_dir=str(episodes), batch_size=8,
                                            sequence_length=30, noise_std=0.0, seed=SEED))
    dm.setup()
    runs: list[dict[str, int]] = []
    fits: dict[str, tuple] = {}
    # (b) both families at nhwc and fused_enc, on the plain route.
    for family, cfg_cls in ((MoPoEMRSSM, MRSSMConfig), (MoPoEMMTRSSM, MMTRSSMConfig)):
        for layout in ("nhwc", "fused_enc"):
            cfg = cfg_cls(compute_dtype=bf16, use_pallas_train=False, conv_layout=layout)
            label = _label(cfg)
            try:
                family(dataclasses.replace(cfg, use_pallas_train="auto"))
            except ValueError as e:
                if "use_pallas_train=False" not in str(e):
                    raise
                print(f"{label}: use_pallas_train='auto' refused: {e}")
            else:
                raise RuntimeError(f"{label}: use_pallas_train='auto' taken at bf16")
            model = family(cfg).init(torch.Generator().manual_seed(SEED)).to(dev)
            log_dir = work / f"{family.__name__}_{layout}"
            trainer = Trainer(model, dm, TrainerConfig(max_epochs=2, seed=SEED,
                                                       log_dir=str(log_dir)))
            reset_launch_counts()
            out = trainer.fit()
            torch.cuda.synchronize()
            counts = launch_counts()
            steps = out["global_step"]
            if steps < 4 or not all(np.isfinite(v) for row in out["history"] for v in row.values()):
                raise RuntimeError(f"{label} fit: {steps} steps, history {out['history']}")
            enc = (counts["fused_encoder_fwd_bf16"], counts["fused_encoder_bwd_bf16"])
            others = {k: v for k, v in counts.items() if v and k not in (
                "fused_encoder_fwd_bf16", "fused_encoder_bwd_bf16")}
            want = 2 * steps if layout == "fused_enc" else 0
            warm = _warmup_launches(trainer).get("fused_encoder_bwd_bf16", 0)
            if others or enc[1] != want + warm or enc[0] < want or (want == 0 and enc[0]):
                raise RuntimeError(f"{label} fit: launches {counts} over {steps} steps")
            print(f"main-path kernel launches, {label} fit, {steps} optimizer steps: {counts}; "
                  f"{out['history'][-1]['train/loss']:.6g} train/loss last epoch; "
                  f"{steps / max(out['train_seconds'], 1e-9):.3f} steps/s | {card}")
            runs.append(counts)
            _state_dtypes(model, dev, label)
            _full_bf16_vs_cpu(model, dev, label)
            _family_step_times(model, dev, card, label)  # phase 12 times the f32 plain route
            fits[label] = (cfg, log_dir / "checkpoints")
    # (c) the weighted and unimodal families at bf16, from the YAML.
    for name in ("WeightedMoPoEMRSSM", "RSSM"):
        exp, _ = _family_experiment(name, work / "families", episodes)
        exp.model = type(exp.model)(dataclasses.replace(exp.model.cfg, compute_dtype=bf16))
        label = _label(exp.model.cfg)
        model, counts = _fit_family(exp, dev, card, label)
        runs.append(counts)
        fits[name] = (model.cfg, Path(exp.trainer.log_dir) / "checkpoints")
    # (d) bf16-config checkpoints served: MRSSM on the plain route, the
    # weighted model with imagination on rollout.cu.
    for key, need in ((_label(MRSSMConfig(compute_dtype=bf16, use_pallas_train=False,
                                          conv_layout="nhwc")), {}),
                      ("WeightedMoPoEMRSSM", {"rollout": 2})):
        cfg, ckpt = fits[key]
        served = WorldModel.from_checkpoint(cfg, ckpt, dev)
        label = _label(served.model.cfg)
        rng = np.random.default_rng(SEED + 21)
        obs = [rng.uniform(-1, 1, (2, 5, *s)).astype(np.float32) for s in
               ((cfg.action_size,), (32, 32, 1), (32, 32, 1))]
        with torch.no_grad():
            post, _ = served.observe(*obs, seed=3)
            frames = served.decode(post)
            if post.deter.dtype != torch.float32 or any(
                    v.dtype != torch.float32 for v in frames.values()):
                raise RuntimeError(f"{label} served: deter {post.deter.dtype}, frames "
                                   f"{[v.dtype for v in frames.values()]}")
            ctx = drive_server(served.model, served.model.cfg, dev, need)
            ctx["server"].stop()
            bad = {k: v for k, v in ctx["counts"].items() if v and k not in need}
            if bad:
                raise RuntimeError(f"{label} serving launched {bad}")
            runs.append(ctx["counts"])
            if need:
                runs.append(_family_rollout(served.model, dev, label))
        print(f"{label} served from its checkpoint: float32 frames in, float32 states and "
              "frames out")
    print(f"phase 11 (b)-(d): {time.perf_counter() - t0:.1f} s")
    return {k: sum(r.get(k, 0) for r in runs) for k in runs[0]}


# ---- phase 12: K-step dispatch -------------------------------------------------------

KSTEP_EPISODES = 96  # 76 train (9 full batches of 8 and a tail of 4), 20 val (2 and 4)
KSTEP_EPOCHS = 3  # a fit's steps/s is read over its epochs 2 and 3: 20 optimizer steps
KSTEP_TURNS = 5  # interleaved timing turns of each dispatch
KSTEP_PLAIN_STEPS = 3  # eager steps a turn on the routes with no counted kernel (~0.2-0.3 s each)
# The training kernels the profiler names one for one with the launch
# counters: a device kernel (its exact name) and the counters whose every
# wrapper call launches it once (a backward recomputes through its forward;
# the stacked entries run the unstacked recurrence's kernels on packed weights).
KSTEP_SIGNATURES = {
    "recurrence_fwd_stages_kernel": ("recurrence_fwd", "stacked_recurrence_fwd"),
    "recurrence_bwd_chain_kernel": ("recurrence_bwd", "stacked_recurrence_bwd"),
    "stacked_pack_kernel": ("stacked_recurrence_fwd", "stacked_recurrence_bwd"),
    "stacked_scatter_kernel": ("stacked_recurrence_bwd",),
    "mt_recurrence_fwd_stages_kernel": ("mt_recurrence_fwd",),
    "mt_recurrence_bwd_chain_kernel": ("mt_recurrence_bwd",),
    "encoder_fwd_kernel": ("fused_encoder_fwd", "fused_encoder_bwd"),
    "encoder_bwd_dx_kernel": ("fused_encoder_bwd",),
    "encoder_bf16_tc_fwd_kernel": ("fused_encoder_fwd_bf16", "fused_encoder_bwd_bf16"),
    "encoder_bf16_tc_dx_kernel": ("fused_encoder_bwd_bf16",),
}
# Host-side launch calls, as the profiler names them.
KSTEP_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                      "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                      "cudaMemsetAsync")


def _kstep_routes(work: Path) -> list[tuple[str, object, str]]:
    """Phase 12's routes: (label, model config, modality) for every family
    and route that trains on the card."""
    import torch

    from multimodal_mtrssm_tpu_torch.models import MMTRSSMConfig, MRSSMConfig

    episodes = work / "yaml-episodes"
    weighted = _family_experiment("WeightedMoPoEMRSSM", work / "yaml", episodes)[0].model.cfg
    rssm = _family_experiment("RSSM", work / "yaml", episodes)[0].model.cfg
    routes = [MRSSMConfig(), MRSSMConfig(conv_layout="fused_enc", use_pallas_train="stacked"),
              MMTRSSMConfig(), MMTRSSMConfig(conv_layout="fused_enc"),
              MRSSMConfig(conv_layout="fused_enc", conv_dtype=torch.bfloat16),
              MRSSMConfig(use_pallas_train=False),
              MRSSMConfig(use_pallas_train=False, compute_dtype=torch.bfloat16),
              weighted, rssm]
    return [(_label(c), c, "vision" if hasattr(c, "encoder") else "multimodal") for c in routes]


def _kstep_trainer(cfg, modality: str, dev, episodes: Path, run_dir: Path, **kw):
    """A fresh ``KSTEP_EPOCHS``-epoch ``Trainer`` of ``cfg`` at B=8 T=30 on
    ``episodes`` (pipeline noise 0); ``noise_std``, ``device_resident`` and
    the trainer's fields in ``kw``."""
    from multimodal_mtrssm_tpu_torch.data import DataModuleConfig, EpisodeDataModule
    from multimodal_mtrssm_tpu_torch.models import (
        RSSM,
        MMTRSSMConfig,
        MoPoEMMTRSSM,
        MoPoEMRSSM,
        WeightedMoPoEMRSSM,
        WeightedMRSSMConfig,
    )
    from multimodal_mtrssm_tpu_torch.train import Trainer, TrainerConfig

    family = (MoPoEMMTRSSM if isinstance(cfg, MMTRSSMConfig) else WeightedMoPoEMRSSM
              if isinstance(cfg, WeightedMRSSMConfig) else RSSM if modality == "vision"
              else MoPoEMRSSM)
    dm = EpisodeDataModule(DataModuleConfig(
        data_dir=str(episodes), batch_size=8, sequence_length=30,
        noise_std=kw.pop("noise_std", 0.0), seed=SEED, modality=modality,
        device_resident=kw.pop("device_resident", False)))
    return Trainer(family(cfg).to(dev), dm, TrainerConfig(
        **{"max_epochs": KSTEP_EPOCHS, "seed": SEED, "log_dir": str(run_dir), **kw}))


def _kstep_fit(make, name: str) -> tuple[object, dict, dict[str, int], list[float]]:
    """``make(name)``'s fit: the trainer, its result, its launch counts and
    the optimizer steps/s of each epoch after the first."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    trainer = make(name)
    reset_launch_counts()
    out = trainer.fit()
    torch.cuda.synchronize()
    dm = trainer.dm
    steps = -(-dm.n_train // dm.train_batch_size)
    return trainer, out, launch_counts(), [steps * row["seq_per_sec"] / dm.n_train
                                           for row in out["history"][1:]]


def _over_epochs(rates: list[float]) -> float:
    """Steps/s over equal-step epochs: steps over their summed seconds."""
    return len(rates) / sum(1 / r for r in rates)


def _same_fit(a: tuple, b: tuple) -> bool:
    """Two fits' weights, epoch rows (but their rates) and steps bit for bit."""
    rows = lambda out: [{k: v for k, v in r.items() if k != "seq_per_sec"}  # noqa: E731
                        for r in out["history"]]
    return (_weights_close(a[0].model, b[0].model)[1] and rows(a[1]) == rows(b[1])
            and a[1]["global_step"] == b[1]["global_step"])


def _graph_pool_bytes(step) -> int | None:
    """The bytes of the allocator's segments in ``step``'s graph's private
    pool (None where the allocator's snapshot names no such segment)."""
    import torch

    pool = tuple(step.graph.pool())
    sizes = [seg["total_size"] for seg in torch.cuda.memory_snapshot()
             if tuple(seg.get("segment_pool_id", ())) == pool]
    return sum(sizes) if sizes else None


def _is_kernel(key: str, name: str) -> bool:
    """Whether a device record's ``key`` names the kernel ``name``: whole,
    after a namespace or ``void`` and before its template or argument list."""
    import re

    return re.search(rf"(?:^|[\s:]){name}\s*[<(]", key) is not None


def _kstep_window(fn, k: int, what: str) -> dict:
    """One profiler window (CPU and CUDA) over ``fn``, ``k`` steps, read from
    its raw records: device ms a step, the host's launch calls a step by
    name, each signature kernel's count and the host calls that launched it
    (by correlation id), the launch counters' counts, and the device
    kernels. The window first runs ``fn`` once unread: the profiler can drop
    the device records of a window's first milliseconds. The read call is
    marked; its records are those whose correlation id lies between the
    first and last CUDA API call made inside the mark. Raises where the
    profiler fails or keeps no device record of the read call."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
        reset_launch_counts()
        with record_function("kstep window"):
            fn()
            torch.cuda.synchronize()
        counted = {c: n for c, n in launch_counts().items() if n}
        time.sleep(0.05)
    raw = prof.profiler.kineto_results.events()
    mark = next(e for e in raw if e.name() == "kstep window")
    lo, hi = mark.start_ns(), mark.start_ns() + mark.duration_ns()
    api = [e for e in raw if e.device_type() == DeviceType.CPU and e.name().startswith("cu")
           and lo <= e.start_ns() <= hi]
    if not api:
        raise RuntimeError(f"{what}: the profiler kept no CUDA API call of the window")
    c_lo, c_hi = min(e.correlation_id() for e in api), max(e.correlation_id() for e in api)
    device = [e for e in raw if e.device_type() == DeviceType.CUDA
              and c_lo <= e.correlation_id() <= c_hi]
    kernels = [e for e in device if not e.name().startswith(("Memset", "Memcpy"))]
    if not kernels:
        raise RuntimeError(f"{what}: the profiler kept no device record")
    host = [e for e in api if e.name() in KSTEP_LAUNCH_CALLS]
    calls = {e.correlation_id(): e.name() for e in host}
    names = collections.Counter(e.name() for e in kernels)
    sig_of = {n: next((s for s in KSTEP_SIGNATURES if _is_kernel(n, s)), None) for n in names}
    launchers = {sig: collections.Counter() for sig in KSTEP_SIGNATURES}
    for e in kernels:
        if sig_of[e.name()] is not None:
            launchers[sig_of[e.name()]][calls.get(e.correlation_id(), "no host call")] += 1
    return {"device_ms": sum(e.duration_ns() for e in device) / k / 1e6,
            "launches": {n: c / k for n, c in collections.Counter(e.name() for e in host).items()},
            "signatures": {sig: sum(c for n, c in names.items() if sig_of[n] == sig)
                           for sig in KSTEP_SIGNATURES},
            "launchers": launchers, "counted": counted, "kernels": names}


def _check_window(w: dict, what: str, graphed: bool) -> str:
    """The window's launch counters against the profiler: each signature
    kernel seen exactly as often as its counters' launches, each counted
    launch named by some signature, and in a graphed window every one of
    them launched by ``cudaGraphLaunch``. Raises on any difference."""
    counted = w["counted"]
    unnamed = [c for c in counted if not any(c in via for via in KSTEP_SIGNATURES.values())]
    if unnamed:
        raise RuntimeError(f"{what}: counted launches {unnamed} have no signature kernel")
    out = []
    for sig, via in KSTEP_SIGNATURES.items():
        want, seen = sum(counted.get(c, 0) for c in via), w["signatures"][sig]
        if seen != want:
            raise RuntimeError(f"{what}: the profiler saw {sig} {seen} times, the counters "
                               f"say {want} ({counted})")
        if graphed and dict(w["launchers"][sig]) not in ({}, {"cudaGraphLaunch": want}):
            raise RuntimeError(f"{what}: {sig} launched by {dict(w['launchers'][sig])}, not "
                               f"by cudaGraphLaunch alone")
        if want:
            out.append(f"{sig} {seen} (counters {want})")
    return ", ".join(out)


def _kstep_probe_route(label: str, cfg, modality: str, dev, episodes: Path, run_dir: Path,
                       card: str) -> None:
    """One route's graphed chunk against its eager steps on the same batches
    of a fresh model: ms a step over ``KSTEP_TURNS`` interleaved turns of
    each (CUDA events; K steps a turn, ``KSTEP_PLAIN_STEPS`` eagerly where
    the step launches no counted kernel), then a profiler window of each,
    held to the counters (:func:`_check_window`), for the device ms, busy
    share and host launch calls a step."""
    import torch

    from multimodal_mtrssm_tpu_torch.train import AdamW, make_train_chunk, make_train_step

    trainer = _kstep_trainer(cfg, modality, dev, episodes, run_dir)
    trainer.dm.setup()
    k = trainer._resolve_spd()
    model = trainer.model
    model.init(torch.Generator().manual_seed(SEED))
    kind, chunk = next(trainer.dm.train_batches_chunked(0, k, dev))
    if kind != "scan":
        raise RuntimeError(f"{label}: the first item at K={k} is a {kind!r}")
    train_chunk = make_train_chunk(model, AdamW(model.parameters()))
    eager_step = make_train_step(model, AdamW(model.parameters()))

    def graphed():
        train_chunk(chunk, SEED, 0, {})

    with _deterministic_cudnn():  # as the fits that were compared bit for bit
        graphed()  # the capture
        per_replay = next(iter(train_chunk.graphs.values())).launches
        n_eager = k if per_replay else KSTEP_PLAIN_STEPS

        def eager():
            for i in range(n_eager):
                eager_step(tuple(x[i] for x in chunk), SEED, i)

        eager()
        runs = {"K=1": (eager, n_eager), f"K={k}": (graphed, k)}
        turns: dict[str, list[float]] = {name: [] for name in runs}
        for t in range(KSTEP_TURNS):
            for name in (runs if t % 2 == 0 else reversed(runs)):
                fn, n = runs[name]
                turns[name].append(_median_ms(fn, 1, warmup=0) / n)
        windows = {name: _kstep_window(fn, n, f"{label} {name}") for name, (fn, n) in runs.items()}
    g = windows[f"K={k}"]
    want = {c: n * k for c, n in per_replay.items()}
    if g["counted"] != want:
        raise RuntimeError(f"{label}: {k} replays counted {g['counted']}, the capture {want}")
    agree = _check_window(g, f"{label} K={k}", graphed=True)
    agree_eager = _check_window(windows["K=1"], f"{label} K=1", graphed=False)
    if agree:
        print(f"kstep {label}: counted kernels inside {k} replays (each launched by "
              f"cudaGraphLaunch), the profiler's count beside the counters': {agree}; eager "
              f"{n_eager} steps: {agree_eager}")
    top = sorted(g["kernels"].items(), key=lambda kv: -kv[1])[:12]
    print(f"kstep {label}: device kernels of {k} replays: {sum(g['kernels'].values()) / k:.0f} "
          "a replay; " + ", ".join(f"{key[:48]} x{c / k:g}" for key, c in top))
    for name, ms in turns.items():
        w, med = windows[name], float(np.median(ms))
        print(f"kstep {label} {name}: {med:.4f} ms a step, median of {len(ms)} interleaved turns "
              f"of {runs[name][1]} steps (range {min(ms):.4f}-{max(ms):.4f}); device "
              f"{w['device_ms']:.4f} ms (busy {w['device_ms'] / med:.1%}); launch calls a step "
              f"{ {c: round(v, 2) for c, v in w['launches'].items()} } | {card}")


def kstep_probe(work: Path) -> int:
    """``--kstep-probe WORK``: phase 12's timing turns and profiler windows
    for every route, in a process of their own (late in a long process the
    profiler drops device records), on the episodes phase 12 made under
    ``WORK``. Exits non-zero when a check fails."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load_library()
    dev = torch.device("cuda", 0)
    failed = []
    for label, cfg, modality in _kstep_routes(work):
        t0 = time.perf_counter()
        try:
            _kstep_probe_route(label, cfg, modality, dev, work / "episodes",
                               work / "probe" / label, card)
            print(f"kstep probe {label}: {time.perf_counter() - t0:.1f} s")
        except Exception as exc:  # noqa: BLE001 — every route runs; the probe fails after
            import traceback

            traceback.print_exc()
            failed.append(f"{label}: {type(exc).__name__}: {exc}")
    if failed:
        print("kstep probe failed on: " + "; ".join(failed))
        return 1
    return 0


def drive_kstep(dev, work: Path, card: str) -> dict:
    """Phase 12 (module docstring, 12): K-step dispatch on every route.
    Returns the launch counts of the graphed fits."""
    import datetime

    import torch
    import torch.distributed as dist

    from multimodal_mtrssm_tpu_torch.data import generate_synthetic_audio_mnist

    t0 = time.perf_counter()
    episodes = work / "episodes"
    generate_synthetic_audio_mnist(episodes, n_episodes=KSTEP_EPISODES, seed=SEED)
    generate_synthetic_audio_mnist(work / "yaml-episodes", n_episodes=24, seed=SEED)
    runs: list[dict[str, int]] = []
    failed: list[str] = []
    for label, cfg, modality in _kstep_routes(work):
        t_route = time.perf_counter()
        try:
            def make(name, cfg=cfg, modality=modality, **kw):
                return _kstep_trainer(cfg, modality, dev, episodes, work / label / name, **kw)

            with _deterministic_cudnn():
                eager = _kstep_fit(lambda n: make(n, steps_per_dispatch=1), "k1")
                auto_fit = _kstep_fit(make, "auto")
                resident = _kstep_fit(lambda n: make(n, device_resident=True), "auto-resident")
            trainer = auto_fit[0]
            spd = trainer._resolve_spd()
            for other, what in ((auto_fit, f"K=auto ({spd})"), (resident, "device-resident")):
                if not _same_fit(eager, other):
                    raise RuntimeError(f"{label}: the {what} fit is not the K=1 fit bit for bit")
            graphs = trainer.chunk_steps[0].graphs
            if not graphs:
                raise RuntimeError(f"{label}: the K={spd} fit captured no graph")
            step = next(iter(graphs.values()))
            counts, per_replay = auto_fit[2], step.launches
            if any(counts[k] < n for k, n in eager[2].items()):
                raise RuntimeError(f"{label}: launches K=1 {eager[2]}, K={spd} {counts}")
            runs.append(counts)
            pool = _graph_pool_bytes(step)
            print(f"kstep {label}: K={spd} fit ({KSTEP_EPOCHS} epochs x 10 steps, 96 episodes "
                  f"B=8 T=30) bit for bit the K=1 fit (weights, epoch rows, global_step "
                  f"{auto_fit[1]['global_step']}), as is the device-resident K={spd} fit; "
                  f"graph capture {step.capture_s * 1e3:.1f} ms after a "
                  f"{step.warmup_s * 1e3:.1f} ms warm-up, pool "
                  + ("not measured" if pool is None else f"{pool / 2**20:.1f} MB")
                  + f"; launches a replay {per_replay}; fit launches {counts} | {card}")
            print(f"kstep {label}: fit steps/s over epochs 2-{KSTEP_EPOCHS} (each epoch's), "
                  f"K=1, K={spd}, device-resident K={spd}: "
                  + ", ".join(f"{_over_epochs(f[3]):.3f} ({', '.join(f'{r:.3f}' for r in f[3])})"
                              for f in (eager, auto_fit, resident))
                  + f"; the three fits {time.perf_counter() - t_route:.1f} s | {card}")
        except Exception as exc:  # noqa: BLE001 — every route runs; the phase fails after
            import traceback

            traceback.print_exc()
            failed.append(f"{label}: {type(exc).__name__}: {exc}")

    # The timing turns and the profiler's kernels against the counters, in a
    # fresh process: late in a long one the profiler drops device records.
    probe = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--kstep-probe",
                            str(work)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True, timeout=600, cwd=Path(__file__).resolve().parent)
    print(probe.stdout, end="")
    if probe.returncode != 0:
        failed.append(f"the probe process exited {probe.returncode}")

    # The NCCL W=1 graphed fit against one process.
    from multimodal_mtrssm_tpu_torch.models import MRSSMConfig

    cfg = MRSSMConfig()
    make = lambda name, **kw: _kstep_trainer(cfg, "multimodal", dev, episodes,  # noqa: E731
                                             work / "nccl" / name, **kw)
    try:
        with _deterministic_cudnn():
            one = _kstep_fit(lambda n: make(n, zero1=True), "one")
            dist.init_process_group("nccl", init_method=f"file://{work / 'nccl-store'}", rank=0,
                                    world_size=1, timeout=datetime.timedelta(seconds=300))
            try:
                nccl = _kstep_fit(lambda n: make(n, zero1=True), "nccl")
                graphed = nccl[0].chunk_steps[0].graphs
            finally:
                dist.destroy_process_group()
        if nccl[0].mesh is None or not graphed:
            raise RuntimeError(f"the NCCL W=1 fit ran on {nccl[0].mesh}, graphs {graphed}")
        if not _same_fit(one, nccl):
            raise RuntimeError("the NCCL W=1 graphed fit is not the one-process fit bit for bit")
        runs.append(nccl[2])
        print(f"kstep NCCL world 1, MRSSMConfig() zero1, K={nccl[0]._resolve_spd()}: graphed fit "
              f"(all-reduce and all-gather captured) bit for bit the one-process fit; steps/s "
              f"over epochs 2-{KSTEP_EPOCHS} {_over_epochs(nccl[3]):.3f} against "
              f"{_over_epochs(one[3]):.3f} | {card}")
    except Exception as exc:  # noqa: BLE001
        import traceback

        traceback.print_exc()
        failed.append(f"NCCL W=1: {type(exc).__name__}: {exc}")
    print(f"phase 12 took {time.perf_counter() - t0:.1f} s")
    if failed:
        raise RuntimeError("K-step dispatch failed on: " + "; ".join(failed))
    return {k: sum(r.get(k, 0) for r in runs) for k in runs[0]} if runs else {}


def kstep_phase() -> int:
    """``--kstep``: only phase 12, K-step dispatch, with its checks."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load_library()
    with tempfile.TemporaryDirectory() as work:
        drive_kstep(torch.device("cuda", 0), Path(work), card)
    return 0


# ---- phase 13: the host input path --------------------------------------------------------

HOST_FITS = 3  # interleaved fits of each input path and route for the steps/s readings
HOST_TURNS = 15  # interleaved turns of the batch-assembly and word timings
HOST_NOISE = 0.1  # the pipeline's input noise: the native library draws it


@contextlib.contextmanager
def _plain_gathers():
    """The pipeline's native gathers swapped for their plain versions (JAX's
    numpy path) writing into the same buffers: the numpy side of the
    batch-assembly timing."""
    from multimodal_mtrssm_tpu_torch.data import native

    real = native.gather_noise, native.gather_affine_noise

    def gather_noise(src, idx, seq_len, std, seed, n_threads=0, out=None):
        out[...] = native.gather_noise_plain(src, idx, seq_len, std, seed)
        return out

    def gather_affine_noise(src, idx, seq_len, scale, shift, std, seed, n_threads=0, out=None):
        out[...] = native.gather_affine_noise_plain(src, idx, seq_len, scale, shift, std, seed)
        return out

    native.gather_noise, native.gather_affine_noise = gather_noise, gather_affine_noise
    try:
        yield
    finally:
        native.gather_noise, native.gather_affine_noise = real


@contextlib.contextmanager
def _recorded_copies():
    """Yields the byte counts of the staged host-to-device copies made
    inside it (``Staging._h2d``)."""
    from multimodal_mtrssm_tpu_torch.data import staging

    sizes: list[int] = []
    real = staging.Staging._h2d

    def h2d(self, dev, host):
        sizes.append(host.numel() * host.element_size())
        return real(self, dev, host)

    staging.Staging._h2d = h2d
    try:
        yield sizes
    finally:
        staging.Staging._h2d = real


def check_native(dm, packed, card: str) -> None:
    """13(a): the native library built on this host; at std 0 both entry
    points equal their plain versions bit for bit on a B=8 T=30 batch of
    the vision stream (in memory, and the raw pack affinely); at std 0.1
    the bits do not depend on the thread count; the ms to assemble one
    batch through the native library and through the plain versions
    (host clock, medians of interleaved turns), in memory and from the
    pack, at ``HOST_NOISE``."""
    import os

    from multimodal_mtrssm_tpu_torch.data import native

    t0 = time.perf_counter()
    native.load_library()
    built = time.perf_counter() - t0
    idx = np.arange(8)
    src, raw = dm._arrays["vision"], packed._arrays["vision"]
    pairs = [(native.gather_noise(src, idx, 30, 0.0, 0),
              native.gather_noise_plain(src, idx, 30, 0.0, 0)),
             (native.gather_affine_noise(raw, idx, 30, 2 / 255, -1.0, 0.0, 0),
              native.gather_affine_noise_plain(raw, idx, 30, 2 / 255, -1.0, 0.0, 0))]
    if not all(np.array_equal(a, b) for a, b in pairs):
        raise RuntimeError("the native gathers at std 0 differ from their plain versions")
    threads = [native.gather_noise(src, idx, 30, HOST_NOISE, 5, n_threads=n) for n in (1, 3, 0)]
    threads += [native.gather_affine_noise(raw, idx, 30, 2 / 255, -1.0, HOST_NOISE, 5,
                                           n_threads=n) for n in (1, 3, 0)]
    if not (all(np.array_equal(threads[0], t) for t in threads[1:3])
            and all(np.array_equal(threads[3], t) for t in threads[4:])):
        raise RuntimeError("the native gathers' bits depend on the thread count")
    print(f"host input: libfastbatch built with g++ {' '.join(native.GXX_FLAGS)} in {built:.2f} s "
          f"({native.library_path().name}) on {os.cpu_count()} host cores; at std 0 both entry "
          "points bit for bit their plain versions (B=8 T=30 vision, in memory and the raw "
          "pack); at std 0.1 the same bits on 1, 3 and all threads")
    out = np.empty((8, 30, *src.shape[2:]), np.float32)
    calls = {f"{n} threads" if n else "all threads": (
        lambda n=n: native.gather_noise(src, idx, 30, HOST_NOISE, 5, n_threads=n, out=out))
        for n in (1, 2, 4, 0)}
    calls["numpy"] = lambda: native.gather_noise_plain(src, idx, 30, HOST_NOISE, 5)
    times: dict[str, list[float]] = {name: [] for name in calls}
    for t in range(HOST_TURNS):
        for name in (list(calls) if t % 2 == 0 else list(reversed(calls))):
            t1 = time.perf_counter()
            calls[name]()
            times[name].append((time.perf_counter() - t1) * 1e3)
    print("time host gather_noise, one 32x32x1 stream at B=8 T=30, noise "
          f"{HOST_NOISE}: " + ", ".join(f"{name} {np.median(v):.4f} ms" for name, v in
                                        times.items())
          + f" (host clock, medians of {HOST_TURNS} interleaved turns) | {card}")
    for name, module in (("in memory", dm), ("from the pack", packed)):
        rng = np.random.default_rng(0)
        turns: dict[str, list[float]] = {"native": [], "numpy": []}
        for t in range(HOST_TURNS):
            for path in (("native", "numpy") if t % 2 == 0 else ("numpy", "native")):
                with (_plain_gathers() if path == "numpy" else contextlib.nullcontext()):
                    t1 = time.perf_counter()
                    module._make_batch(idx, rng, train=True)
                    turns[path].append((time.perf_counter() - t1) * 1e3)
        print(f"time host batch assembly {name} (B=8 T=30, 3 streams, noise {HOST_NOISE}): "
              f"native {np.median(turns['native']):.4f} ms, numpy {np.median(turns['numpy']):.4f}"
              f" ms (host clock, medians of {HOST_TURNS} interleaved turns; ranges "
              f"{min(turns['native']):.4f}-{max(turns['native']):.4f}, "
              f"{min(turns['numpy']):.4f}-{max(turns['numpy']):.4f}) | {card}")


def _upload_window(trace: Path, sizes: set[int], label: str) -> str:
    """13(c): a trainer's profile of one K=auto epoch (chrome trace) read
    for the batch uploads (host-to-device copies of a staged tensor's
    bytes): fails on any pageable one, on none pinned, on one on a stream
    that ran the replays' recurrence kernels, and unless one overlaps a
    kernel of those streams. Returns what it saw."""
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    htod = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    if not kernels or not htod:
        raise RuntimeError(f"{label}: the trace holds {len(kernels)} kernels, {len(htod)} "
                           "host-to-device copies")
    sized = all("bytes" in e.get("args", {}) for e in htod)
    batch = [e for e in htod if not sized or e["args"]["bytes"] in sizes]
    pageable = [e for e in batch if "Pageable" in e["name"]]
    pinned = [e for e in batch if "Pinned" in e["name"]]
    replay_streams = {e["args"].get("stream") for e in kernels
                      if "recurrence_fwd_stages_kernel" in e["name"]}
    copy_streams = {e["args"].get("stream") for e in pinned}
    if pageable or not pinned:
        raise RuntimeError(f"{label}: {len(pageable)} pageable and {len(pinned)} pinned batch "
                           f"uploads ({_count_names(e['name'] for e in htod)})")
    if not replay_streams or copy_streams & replay_streams:
        raise RuntimeError(f"{label}: uploads on streams {copy_streams}, replays on "
                           f"{replay_streams}")
    replays = [e for e in kernels if e["args"].get("stream") in replay_streams]
    overlapping = sum(any(k["ts"] < u["ts"] + u["dur"] and u["ts"] < k["ts"] + k["dur"]
                          for k in replays) for u in pinned)
    if not overlapping:
        raise RuntimeError(f"{label}: no batch upload overlaps a replay's kernels")
    return (f"{len(pinned)} batch uploads, each `Memcpy HtoD (Pinned -> Device)` on stream(s) "
            f"{sorted(copy_streams)}, the replays on {sorted(replay_streams)}; {overlapping} "
            f"overlap a replay's kernels; 0 pageable (host-to-device copies in the window: "
            f"{_count_names(e['name'] for e in htod)}"
            + ("" if sized else "; the trace gives no bytes, so every one counted") + ")")


def _count_names(names) -> dict[str, int]:
    """How many times each name occurs."""
    import collections

    return dict(collections.Counter(names))


def _word_timings(model, classifier, test_data, card: str) -> dict[str, int]:
    """13(e): one word evaluated both ways on the card: the per-interval
    path (a rollout launch an interval) predicts the batched path's digits;
    ms a word each way (synchronised host clock, medians of interleaved
    turns). Returns the launch counts of the two evaluations."""
    import torch

    from multimodal_mtrssm_tpu_torch.evaluation import (
        generate_predictions_batched,
        generate_predictions_with_classifier,
        select_intervals_for_word,
    )
    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from multimodal_mtrssm_tpu_torch.train.steps import fold

    word = next(w for w in range(10) if select_intervals_for_word(
        w, test_data, EVAL_ARGS["n_intervals"], EVAL_ARGS["query_length"]))
    intervals = select_intervals_for_word(word, test_data, EVAL_ARGS["n_intervals"],
                                          EVAL_ARGS["query_length"])
    P, F = EVAL_ARGS["n_predictions"], EVAL_ARGS["n_frames"]
    seed = fold(SEED, word)

    def batched():
        return generate_predictions_batched(model, classifier, intervals, seed, P, F,
                                            classify_frame=1)

    def per_interval():
        return [d for i, iv in enumerate(intervals) for d in generate_predictions_with_classifier(
            model, classifier, iv, seed, P, F, classify_frame=1, interval_index=i,
            n_intervals=len(intervals))]

    reset_launch_counts()
    a = batched()
    counts_a = launch_counts()
    reset_launch_counts()
    b = per_interval()
    counts_b = launch_counts()
    if counts_a["rollout"] != 1 or counts_b["rollout"] != len(intervals):
        raise RuntimeError(f"rollout launches: batched {counts_a['rollout']}, per interval "
                           f"{counts_b['rollout']} for {len(intervals)} intervals")
    if a != b:
        diff = sum(x != y for x, y in zip(a, b))
        raise RuntimeError(f"word {word}: the per-interval digits differ from the batched ones "
                           f"in {diff} of {len(a)} predictions")
    turns: dict[str, list[float]] = {"batched": [], "per interval": []}
    for t in range(HOST_TURNS):
        for name in (("batched", "per interval") if t % 2 == 0 else ("per interval", "batched")):
            fn = batched if name == "batched" else per_interval
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            turns[name].append((time.perf_counter() - t1) * 1e3)
    print(f"host input: word {word} evaluated both ways on the card, {len(a)} predictions equal "
          f"(digits {sorted(set(a))}); rollout launches batched 1, per interval {len(intervals)}")
    print(f"time evaluation word (MRSSMConfig(), {len(intervals)} intervals x {P} predictions, "
          f"{F} frames): batched {np.median(turns['batched']):.4f} ms, per interval "
          f"{np.median(turns['per interval']):.4f} ms (synchronised host clock, medians of "
          f"{HOST_TURNS} interleaved turns) | {card}")
    return {k: counts_a.get(k, 0) + counts_b.get(k, 0) for k in counts_a}


def drive_host_input(dev, work: Path, card: str, eval_inputs: dict | None = None) -> dict:
    """Phase 13 (module docstring, 13): the host input path. Returns the
    launch counts of its fits and evaluations."""
    import torch

    from multimodal_mtrssm_tpu_torch.data import (
        DataModuleConfig,
        EpisodeDataModule,
        generate_synthetic_audio_mnist,
    )
    from multimodal_mtrssm_tpu_torch.data.pack import pack_episodes
    from multimodal_mtrssm_tpu_torch.models import MoPoEMRSSM, MRSSMConfig

    t0 = time.perf_counter()
    episodes = work / "episodes"
    if not episodes.is_dir():
        generate_synthetic_audio_mnist(episodes, n_episodes=KSTEP_EPISODES, seed=SEED)
    packed_dir = work / "packed"
    pack_episodes(episodes, packed_dir / "pack")
    data = lambda d: EpisodeDataModule(DataModuleConfig(  # noqa: E731
        data_dir=str(d), batch_size=8, sequence_length=30, noise_std=HOST_NOISE, seed=SEED))
    dm, packed = data(episodes), data(packed_dir)
    dm.setup()
    packed.setup()
    check_native(dm, packed, card)
    runs: list[dict[str, int]] = []
    failed: list[str] = []

    def make(cfg, name, data_dir=episodes, **kw):
        return _kstep_trainer(cfg, "multimodal", dev, data_dir, work / "fits" / name,
                              noise_std=HOST_NOISE, **kw)

    # (b) native noise and the pack: K=auto bit for bit K=1, and (c) the uploads.
    cfg = MRSSMConfig()
    with _deterministic_cudnn():
        for what, data_dir in (("in memory", episodes), ("from the pack", packed_dir)):
            try:
                k1 = _kstep_fit(lambda n: make(cfg, n, data_dir, steps_per_dispatch=1),
                                f"{what}-k1")
                auto = _kstep_fit(lambda n: make(cfg, n, data_dir), f"{what}-auto")
                if auto[0].dm._raw != (data_dir == packed_dir) or not _same_fit(k1, auto):
                    raise RuntimeError(f"the K=auto fit {what} at noise {HOST_NOISE} is not the "
                                       "K=1 fit bit for bit")
                runs += [k1[2], auto[2]]
                print(f"host input {what}, noise {HOST_NOISE} (native): the K="
                      f"{auto[0]._resolve_spd()} fit on staged chunks bit for bit the K=1 fit "
                      f"(weights, epoch rows, global step {auto[1]['global_step']}) | {card}")
            except Exception as exc:  # noqa: BLE001 — every part runs; the phase fails after
                import traceback

                traceback.print_exc()
                failed.append(f"{what}: {type(exc).__name__}: {exc}")
        try:
            with _recorded_copies() as sizes:
                prof = make(cfg, "profile", max_epochs=2, profile_epoch=1)
                prof.fit()
            torch.cuda.synchronize()
            trace = work / "fits" / "profile" / "profile" / "epoch_1.trace.json"
            print(f"host input uploads, one K={prof._resolve_spd()} epoch of MRSSMConfig() "
                  f"(trainer profile_epoch=1; {len(sizes)} staged copies in the fit): "
                  f"{_upload_window(trace, set(sizes), 'uploads')} | {card}")
        except Exception as exc:  # noqa: BLE001
            import traceback

            traceback.print_exc()
            failed.append(f"uploads: {type(exc).__name__}: {exc}")

    # (d) steps/s, host path against device-resident, interleaved fits.
    for cfg in (MRSSMConfig(), MRSSMConfig(conv_layout="fused_enc", use_pallas_train="stacked")):
        label = _label(cfg)
        rates: dict[str, list[float]] = {"host": [], "resident": []}
        try:
            for t in range(HOST_FITS):
                for path in (("host", "resident") if t % 2 == 0 else ("resident", "host")):
                    fit = _kstep_fit(lambda n: make(cfg, n, device_resident=path == "resident"),
                                     f"{label}-{path}-{t}")
                    rates[path].append(_over_epochs(fit[3]))
                    runs.append(fit[2])
            print(f"time Trainer.fit {label} K=auto, noise {HOST_NOISE}, steps/s over epochs "
                  f"2-{KSTEP_EPOCHS} of {HOST_FITS} interleaved fits each: host (prefetched, "
                  f"staged, native) {np.median(rates['host']):.3f} "
                  f"({', '.join(f'{r:.3f}' for r in rates['host'])}), device-resident "
                  f"{np.median(rates['resident']):.3f} "
                  f"({', '.join(f'{r:.3f}' for r in rates['resident'])}) | {card}")
        except Exception as exc:  # noqa: BLE001
            import traceback

            traceback.print_exc()
            failed.append(f"{label} timing: {type(exc).__name__}: {exc}")

    # (e) one word both ways.
    try:
        if eval_inputs is None:
            eval_inputs = evaluation_inputs(dev, work / "evaluation")
        model = MoPoEMRSSM(MRSSMConfig()).init(torch.Generator().manual_seed(SEED)).to(dev).eval()
        runs.append(_word_timings(model, eval_inputs["classifier"], eval_inputs["test_data"],
                                  card))
    except Exception as exc:  # noqa: BLE001
        import traceback

        traceback.print_exc()
        failed.append(f"evaluation: {type(exc).__name__}: {exc}")
    print(f"phase 13 took {time.perf_counter() - t0:.1f} s")
    if failed:
        raise RuntimeError("the host input path failed on: " + "; ".join(failed))
    return {k: sum(r.get(k, 0) for r in runs) for k in runs[0]}


def host_input_phase() -> int:
    """``--host-input``: only phase 13, the host input path, with its checks."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.load_library()
    with tempfile.TemporaryDirectory() as work:
        drive_host_input(torch.device("cuda", 0), Path(work), card)
    return 0


def main() -> int:
    """Every phase; the fit runs' episodes and checkpoints live in a
    temporary directory removed at the end."""
    with tempfile.TemporaryDirectory() as work:
        return _main(Path(work))


def _main(work: Path) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def stamp(what: str) -> None:
        print(f"chip_smoke: {what} done at {time.perf_counter() - t_start:.1f} s")

    from multimodal_mtrssm_tpu_torch.models import (
        MMTRSSMConfig,
        MoPoEMMTRSSM,
        MoPoEMRSSM,
        MRSSMConfig,
    )
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    ptxas = start_ptxas_report()
    build.load_library()
    print(f"build: {build.build_seconds:.2f} s ({build.library_path().name})")
    runs: list[dict[str, int]] = []
    library: dict[str, float] = {}

    def fit_rate(training: dict, cfg) -> None:
        print(f"time Trainer.fit {_label(cfg)} B=8 T=30: {training['steps_per_s']:.3f} optimizer "
              f"steps/s over 2 epochs, {training['steps_per_s_last']:.3f} in the second (host "
              f"data pipeline included) | {card}")

    # MoPoE-MRSSM.
    cfg = MRSSMConfig()
    model = MoPoEMRSSM(cfg).init(torch.Generator().manual_seed(0)).to(dev).eval()
    with torch.no_grad():
        checks = check_kernels(model, cfg, dev)
        checks["rollout"]["max_abs_err"] = max(checks["rollout"]["max_abs_err"],
                                               check_per_row_keys(model, cfg, dev)["max_abs_err"])
        checks["recurrence_bwd"] = check_backward(model, cfg, dev)
        ctx = drive_server(model, cfg, dev, {"recurrence_fwd": 1, "rollout": 2})
        try:
            times = kernel_timings(model, cfg, dev, card)
            rec_fwd_timings(model, cfg, dev, card)
            server_latencies(ctx, card, _label(cfg))
        finally:
            ctx["server"].stop()
        bounds = recurrence_bounds(model, cfg, dev)
        other_bounds("MRSSM", ((128, 30),),
                     lambda B, T, roll: recurrence_bounds(model, cfg, dev, B, T, roll))
    stamp("MRSSM checks, serving and kernel timings")
    training = drive_training(cfg, dev, {"recurrence_fwd": 1, "recurrence_bwd": 1},
                              work / "mrssm")
    times.update(bwd_timings(training["model"], cfg, dev, card))
    step_timings(training["model"], dev, card)
    fit_rate(training, cfg)
    co = serve_trained(cfg, dev, training, card)
    stamp("MRSSM fit, step timings and coalesced serving")
    resume = drive_resume(cfg, dev, work / "mrssm_resume")
    command = drive_train_command(cfg, dev, work / "mrssm_command")
    stamp("MRSSM resume and train command")
    eval_inputs = evaluation_inputs(dev, work / "evaluation")
    evaluation = drive_evaluation(cfg, dev, training["checkpoints"], eval_inputs,
                                  work / "mrssm_evaluation", card)
    runs += [ctx["counts"], training["counts"], co, resume["counts"], command["counts"],
             evaluation["counts"]]
    stamp("MRSSM phases")

    # MoPoE-MMTRSSM.
    mt_cfg = MMTRSSMConfig()
    mt_model = MoPoEMMTRSSM(mt_cfg).init(torch.Generator().manual_seed(0)).to(dev).eval()
    mt_run = {"mt_recurrence_fwd": 1, "mt_recurrence_bwd": 1}
    with torch.no_grad():
        checks.update(check_mt_kernels(mt_model, mt_cfg, dev))
        checks["mt_rollout"]["max_abs_err"] = max(
            checks["mt_rollout"]["max_abs_err"],
            check_per_row_keys(mt_model, mt_cfg, dev)["max_abs_err"])
        checks["mt_recurrence_bwd"] = check_mt_backward(mt_model, mt_cfg, dev)
        mt_ctx = drive_server(mt_model, mt_cfg, dev, {"mt_recurrence_fwd": 1, "mt_rollout": 2})
        try:
            times.update(mt_kernel_timings(mt_model, mt_cfg, dev, card))
            mt_fwd_timings(mt_model, mt_cfg, dev, card)
            times.update(mt_bwd_timings(mt_model, mt_cfg, dev, card))
            server_latencies(mt_ctx, card, _label(mt_cfg))
        finally:
            mt_ctx["server"].stop()
        bounds.update(mt_bounds(mt_model, mt_cfg, dev))
        other_bounds("MMTRSSM", ((32, 30), (128, 30)),
                     lambda B, T, roll: mt_bounds(mt_model, mt_cfg, dev, B, T, roll))
    mt_training = drive_training(mt_cfg, dev, mt_run, work / "mmtrssm")
    step_timings(mt_training["model"], dev, card)
    fit_rate(mt_training, mt_cfg)
    mt_co = serve_trained(mt_cfg, dev, mt_training, card)
    mt_resume = drive_resume(mt_cfg, dev, work / "mmtrssm_resume")
    mt_command = drive_train_command(mt_cfg, dev, work / "mmtrssm_command")
    mt_evaluation = drive_evaluation(mt_cfg, dev, mt_training["checkpoints"], eval_inputs,
                                     work / "mmtrssm_evaluation", card)
    runs += [mt_ctx["counts"], mt_training["counts"], mt_co, mt_resume["counts"],
             mt_command["counts"], mt_evaluation["counts"]]
    stamp("MMTRSSM phases")

    # MoPoE-MRSSM on the fused encoder and the stacked recurrence.
    enc_run = {"fused_encoder_fwd": 2, "fused_encoder_bwd": 2}
    fs_cfg = MRSSMConfig(conv_layout="fused_enc", use_pallas_train="stacked")
    fs_model = MoPoEMRSSM(fs_cfg).init(torch.Generator().manual_seed(0)).to(dev).eval()
    with torch.no_grad():
        checks.update(check_stacked(fs_model, fs_cfg, dev))
        checks.update(check_encoder(fs_model, dev))
        fs_ctx = drive_server(fs_model, fs_cfg, dev, {"stacked_recurrence_fwd": 1, "rollout": 2,
                                                      "fused_encoder_fwd": 2})
        try:
            st_times, st_bounds = stacked_timings(fs_model, fs_cfg, dev, card)
            enc_times, enc_library, enc_bounds = encoder_timings(fs_model, dev, card)
            server_latencies(fs_ctx, card, _label(fs_cfg))
        finally:
            fs_ctx["server"].stop()
    times.update({**st_times, **enc_times})
    bounds.update({**st_bounds, **enc_bounds})
    library.update(enc_library)
    fs_training = drive_training(fs_cfg, dev, {"stacked_recurrence_fwd": 1,
                                               "stacked_recurrence_bwd": 1, **enc_run},
                                 work / "mrssm_fused")
    step_timings(fs_training["model"], dev, card)
    fit_rate(fs_training, fs_cfg)
    runs += [fs_ctx["counts"], fs_training["counts"]]
    stamp("fused_enc+stacked phases")

    # MoPoE-MMTRSSM on the fused encoder.
    fe_cfg = MMTRSSMConfig(conv_layout="fused_enc")
    fe_model = MoPoEMMTRSSM(fe_cfg).init(torch.Generator().manual_seed(0)).to(dev).eval()
    with torch.no_grad():
        fe_ctx = drive_server(fe_model, fe_cfg, dev, {"mt_recurrence_fwd": 1, "mt_rollout": 2,
                                                      "fused_encoder_fwd": 2})
        fe_ctx["server"].stop()
    fe_training = drive_training(fe_cfg, dev, {**mt_run, **enc_run}, work / "mmtrssm_fused")
    step_timings(fe_training["model"], dev, card)
    fit_rate(fe_training, fe_cfg)
    runs += [fe_ctx["counts"], fe_training["counts"]]
    stamp("MMTRSSM fused_enc phases")

    # The fused decoder (fused_decoder_apply), on the latent features of the
    # first two configurations' observes.
    with torch.no_grad():
        cases = [(_label(c), m, *_observed_features(m, c, dev, *DECODER_SHAPES[0]))
                 for c, m in ((cfg, model), (mt_cfg, mt_model))]
        dec_path = drive_decoder(cases, dev)
        big = _big_decoder_case((_label(cfg), model,
                                 *_observed_features(model, cfg, dev, *DECODER_SHAPES[1])), dev)
        checks.update(check_decoder([*dec_path["cases"], big]))
        dec_times, dec_library, dec_bounds = decoder_timings(
            [*(c for c in dec_path["cases"] if c["name"] == "audio"), big], dev, card)
    times.update(dec_times)
    bounds.update(dec_bounds)
    library.update(dec_library)
    runs.append(dec_path["counts"])
    stamp("decoder phase")

    # The cross-modal run: the crossmodal config's fit with the GIF callback,
    # reconstructions of both families, the report, the experiment's entry.
    runs.append(drive_crossmodal(dev, work / "crossmodal", eval_inputs["test_data"],
                                 card)["counts"])
    stamp("phase 7")

    # Phase 8: the bf16 encoder kernels, the plain route by name, 16-mixed
    # from the YAMLs, the learning demonstration's path.
    with torch.no_grad():
        checks.update(check_bf16_encoder(fs_model, dev))
        bf_times, bf_library, bf_bounds, _ = bf16_encoder_timings(fs_model, dev, card)
    times.update(bf_times)
    bounds.update(bf_bounds)
    library.update(bf_library)
    stamp("phase 8 bf16 encoder kernels")
    runs.append(drive_plain_route(dev, card))
    stamp("phase 8 plain route")
    runs.append(drive_precision(dev, work / "precision", card))
    stamp("phase 8 16-mixed")
    runs.append(drive_learning_path(dev, work / "learning"))
    stamp("phase 8")
    # Phase 9: the weighted and unimodal families from the YAML.
    runs.append(drive_other_families(dev, work / "families", card))
    stamp("phase 9")
    # Phase 10: data-parallel training on torch.distributed.
    runs.append(drive_distributed(dev, work / "distributed", card, resume["ref"]))
    stamp("phase 10")
    # Phase 11: the bf16 fused decoder on its own path (phase 5's observed
    # features cast to bf16), then full-model bf16 in every family.
    runs.append(drive_decoder_bf16(cases, dev))
    with torch.no_grad():
        big_mt = _observed_features(mt_model, mt_cfg, dev, *DECODER_SHAPES[1])[1]
        bf_cases = [_bf16_decoder_case(cases[0][0], model, cases[0][3]),
                    _bf16_decoder_case(cases[1][0], mt_model, cases[1][3]),
                    _bf16_decoder_case(big["label"], model, big["feats"]),
                    _bf16_decoder_case(cases[1][0], mt_model, big_mt)]
        checks.update(check_decoder_bf16(bf_cases))
        dbf_times, dbf_library, dbf_bounds = decoder_bf16_timings(bf_cases, dev, card)
    times.update(dbf_times)
    bounds.update(dbf_bounds)
    library.update(dbf_library)
    stamp("phase 11 bf16 decoder")
    runs.append(drive_full_bf16(dev, work / "full_bf16", card))
    stamp("phase 11")
    # Phase 12: K-step dispatch, the train step as a CUDA graph, on every route.
    runs.append(drive_kstep(dev, work / "kstep", card))
    stamp("phase 12")
    # Phase 13: the host input path (native gathers, staged uploads, per-interval evaluation).
    runs.append(drive_host_input(dev, work / "kstep", card, eval_inputs))
    stamp("phase 13")
    # Every pass of both bf16 stacks on the tensor cores.
    hmma = hmma_report(DECODER_BF16_HMMA + ENCODER_BF16_HMMA)
    if any(v == 0 for v in hmma.values()):
        raise RuntimeError(f"a bf16 kernel has no HMMA.16816.F32.BF16 instruction: {hmma}")

    ptxas_report(ptxas)
    launches = {k: sum(run.get(k, 0) for run in runs) for k in runs[0]}
    print("main-path launches, serving + training of the four configurations, resume, the "
          "train command and evaluation of the first two, the fused decoder path, the "
          f"cross-modal run and phases 8 to 13: {launches}")
    pkg = "multimodal_mtrssm_tpu_torch"
    pallas = "multimodal_mtrssm_tpu/ops/pallas"
    meta = {
        "recurrence_fwd": (f"{pkg}/csrc/recurrence_fwd.cu", f"{pallas}/train_step.py:244"),
        "recurrence_bwd": (f"{pkg}/csrc/recurrence_bwd.cu", f"{pallas}/train_step.py:366"),
        "rollout": (f"{pkg}/csrc/rollout.cu", f"{pallas}/rollout.py:105"),
        "mt_recurrence_fwd": (f"{pkg}/csrc/recurrence_mt_fwd.cu",
                              f"{pallas}/train_step_mt.py:142"),
        "mt_recurrence_bwd": (f"{pkg}/csrc/recurrence_mt_bwd.cu",
                              f"{pallas}/train_step_mt.py:280"),
        "mt_rollout": (f"{pkg}/csrc/rollout_mt.cu", f"{pallas}/rollout_mt.py:51"),
        "stacked_recurrence_fwd": (f"{pkg}/csrc/recurrence_stacked_fwd.cu",
                                   f"{pallas}/train_step_stacked.py:164"),
        # The pack, recurrence_bwd.cu's recompute, chain and deferred GEMMs on
        # the packed weights, the scatter.
        "stacked_recurrence_bwd": (f"{pkg}/csrc/recurrence_stacked_bwd.cu",
                                   f"{pallas}/train_step_stacked.py:190"),
        "fused_encoder_fwd": (f"{pkg}/csrc/fused_encoder_fwd.cu", f"{pallas}/fused_conv.py:455"),
        "fused_encoder_bwd": (f"{pkg}/csrc/fused_encoder_bwd.cu", f"{pallas}/fused_conv.py:461"),
        # The same TPU kernels as fused_decoder_apply (fused_conv.py:766) reaches them.
        "fused_decoder_fwd": (f"{pkg}/csrc/fused_decoder_fwd.cu", f"{pallas}/fused_conv.py:455"),
        "fused_decoder_bwd": (f"{pkg}/csrc/fused_decoder_bwd.cu", f"{pallas}/fused_conv.py:461"),
        # The encoder's TPU kernels at dtype=bfloat16 (fused_conv.py:561 on bf16 frames).
        "fused_encoder_fwd_bf16": (f"{pkg}/csrc/fused_encoder_bf16_fwd.cu",
                                   f"{pallas}/fused_conv.py:455"),
        "fused_encoder_bwd_bf16": (f"{pkg}/csrc/fused_encoder_bf16_bwd.cu",
                                   f"{pallas}/fused_conv.py:461"),
        # The decoder's TPU kernels at dtype=bfloat16 (fused_conv.py:766 on bf16 features).
        "fused_decoder_fwd_bf16": (f"{pkg}/csrc/fused_decoder_bf16_fwd.cu",
                                   f"{pallas}/fused_conv.py:455"),
        "fused_decoder_bwd_bf16": (f"{pkg}/csrc/fused_decoder_bf16_bwd.cu",
                                   f"{pallas}/fused_conv.py:461"),
    }
    missing = [name for name in meta if launches[name] < 1]
    if missing:
        raise RuntimeError(f"the main paths never launched {missing}")
    for name, b in bounds.items():
        print(f"bound {name}: {b['flops']:.4g} FLOP, {b['bytes']:.4g} bytes -> {b['bound_ms']:.6f} "
              f"ms, bound by {b['bound_by']} ({b['peak'] / 1e12:g} TFLOP/s, 3.35 TB/s)")
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": checks[name]["max_abs_err"],
                "ms": times[name][0], "plain_ms": times[name][1],
                "bound_ms": bounds[name]["bound_ms"], "bound_by": bounds[name]["bound_by"],
                "library_ms": library.get(name)}
               for name, (src, rep) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0

if __name__ == "__main__":
    try:
        modes = {"--decoder": decoder_phase, "--recurrence-bwd": recurrence_bwd_phase,
                 "--mt-recurrence-bwd": mt_recurrence_bwd_phase,
                 "--mt-recurrence-fwd": mt_recurrence_fwd_phase,
                 "--recurrence-fwd": recurrence_fwd_phase, "--rollout": rollout_phase,
                 "--stacked-recurrence-bwd": stacked_recurrence_bwd_phase,
                 "--learning-demo": learning_demo_phase, "--bf16-encoder": bf16_encoder_phase,
                 "--bf16-encoder-stamps": bf16_stamps_phase, "--bf16-decoder": bf16_decoder_phase,
                 "--bf16-decoder-once": bf16_decoder_once,
                 "--bf16-decoder-racecheck": bf16_decoder_racecheck,
                 "--bf16-decoder-stamps": bf16_decoder_stamps_phase, "--kstep": kstep_phase,
                 "--host-input": host_input_phase}
        if sys.argv[1:2] == ["--learning-demo"] and len(sys.argv) > 2:
            code = learning_demo_phase(Path(sys.argv[2]))
        elif sys.argv[1:2] == ["--bf16-encoder"] and len(sys.argv) > 2:
            code = bf16_encoder_phase(Path(sys.argv[2]).resolve())
        elif sys.argv[1:2] == ["--bf16-encoder-at"] and len(sys.argv) > 2:
            code = bf16_encoder_at(Path(sys.argv[2]))
        elif sys.argv[1:2] == ["--bf16-encoder-stamps-at"] and len(sys.argv) > 2:
            code = bf16_stamps_at(Path(sys.argv[2]))
        elif sys.argv[1:2] == ["--bf16-decoder"] and len(sys.argv) > 2:
            code = bf16_decoder_phase(Path(sys.argv[2]).resolve())
        elif sys.argv[1:2] == ["--bf16-decoder-at"] and len(sys.argv) > 2:
            code = bf16_decoder_at(Path(sys.argv[2]))
        elif sys.argv[1:2] == ["--bf16-decoder-stamps-at"] and len(sys.argv) > 2:
            code = bf16_decoder_stamps_at(Path(sys.argv[2]))
        elif sys.argv[1:2] == ["--kstep-probe"] and len(sys.argv) > 2:
            code = kstep_probe(Path(sys.argv[2]))
        else:
            code = modes[sys.argv[1]]() if sys.argv[1:2] and sys.argv[1] in modes else main()
    finally:
        for child in _CHILDREN:
            if child.poll() is None:
                child.kill()
                child.wait()
    sys.exit(code)
