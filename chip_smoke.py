#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It refuses to run without a CUDA device and exits non-zero on any failure.

0. Device: prints the card's name and power limit, turns TF32 off.
1. Build: compiles the kernels from ``multimodal_mtrssm_tpu_torch/csrc``.
2. Kernel checks, each kernel against its plain PyTorch version on the card:
   the observe recurrence at B=8 T=30, B=128 T=30 and B=3 T=7 (same noise;
   deter, prior and mixed logits within 1e-4, stochs equal outside
   near-ties of 1e-5), and the imagination rollout at B=10 T=10, B=64 T=30
   and B=256 T=180 (replay of its stochs within 1e-4, stochs equal to the
   argmax of its logits plus the seed's Philox noise, sampling frequencies
   against the softmax).
3. The slice end to end: ``MoPoEMRSSM(MRSSMConfig())`` with seeded random
   weights behind ``InferenceServer``: ``/healthz``, ``/observe`` (B=8,
   T=30, decode, JSON), two chained ``/imagine`` (T=30, decode, npz then
   JSON). Checks shapes, finiteness, that both kernels were launched by
   those requests, and that the card's observe posterior and frames equal
   the CPU path's on the same weights and seed.
4. Timings: median ms of each kernel against its plain version, and the
   median latency of ``/observe`` and ``/imagine`` through the server.

Then one JSON line with the kernels, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time
import urllib.request

import numpy as np

TOL = 1e-4
TIE_EPS = 1e-5
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
    for B, T in ((10, 10), (64, 30), (256, 180)):
        actions = torch.tensor(rng.uniform(-1, 1, (B, T, cfg.action_size)).astype(np.float32),
                               device=dev)
        deter0, stoch0 = _recurrence_inputs(rng, B, 1, cfg, dev)[3:5]
        seed = 1234 + B
        got = rollout.rollout_cuda(tw, actions, deter0, stoch0, seed, C, K)
        r = check_rollout(tw, actions, deter0, stoch0, seed, got, C, K, TOL, TIE_EPS)
        print(f"check rollout B={B} T={T}: max_abs_err={r['max_abs_err']:.3g} "
              f"blocks_compared={r['compared']:.4f}")
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


def drive_server(model, cfg, dev) -> dict:
    """Phase 3: the serving path through the HTTP server."""
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
        print(f"main-path kernel launches: {counts}")
        if health.get("platform") != "gpu":
            raise RuntimeError(f"/healthz reports {health}")
        if counts["recurrence_fwd"] < 1 or counts["rollout"] < 2:
            raise RuntimeError(f"the serving path missed a kernel: {counts}")
        recon = _frames(observed, "recon")
        for name, frames in (("observe", recon), ("imagine 1", _frames(im1, "frames")),
                             ("imagine 2", _frames(im2, "frames"))):
            for k, v in frames.items():
                if v.shape != (B, T, 32, 32, 1) or not np.isfinite(v).all():
                    raise RuntimeError(f"{name} {k}: shape {v.shape}, finite {np.isfinite(v).all()}")
        print(f"served: recon {recon['recon/audio'].shape}, two chained imagines, all finite")

        # The card's observe posterior against the CPU path, same weights and seed.
        from multimodal_mtrssm_tpu_torch.ops.kernels.parity import check_recurrence
        from multimodal_mtrssm_tpu_torch.ops.distributions import gumbel_noise

        cpu_model = type(model)(cfg)
        cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
        wm_cpu = WorldModel(cpu_model, "cpu")
        post_g, prior_g = wm.observe(obs["actions"], obs["audio"], obs["vision"], seed=7)
        post_c, prior_c = wm_cpu.observe(obs["actions"], obs["audio"], obs["vision"], seed=7)
        gen = torch.Generator().manual_seed(7)
        S = cfg.stoch_size
        _, g_prior, g_post = (gumbel_noise(s, gen) for s in ((B, S), (T, B, S), (T, B, S)))
        tm = lambda st: [x.transpose(0, 1).cpu() for x in  # noqa: E731
                         (st[0].deter, st[1].logits, st[1].stoch, st[0].logits, st[0].stoch)]
        r = check_recurrence(tm((post_g, prior_g)), tm((post_c, prior_c)), g_prior, g_post,
                             cfg.class_size, cfg.category_size, TOL, TIE_EPS)
        # Frames are compared where the posterior state was held equal.
        agree = r["agree"].transpose(0, 1).numpy()  # [B, T]
        frames_c = wm_cpu.decode(post_c)
        ferr = max(float(np.abs(recon[k] - frames_c[k].numpy())[agree].max()) for k in frames_c)
        if not ferr <= TOL:
            raise RuntimeError(f"observe frames differ from the CPU path by {ferr:.3g}")
        print(f"observe card vs CPU: posterior max_abs_err={r['max_abs_err']:.3g}, "
              f"frames max_abs_err={ferr:.3g}, steps_compared={float(agree.mean()):.4f}")
        return {"counts": counts, "server": server, "obs": obs, "plan": plan,
                "state_id": observed["state_id"]}
    except BaseException:
        server.stop()
        raise


def timings(model, cfg, dev, card: str, ctx: dict) -> dict[str, tuple[float, float]]:
    """Phase 4: medians on the card; returns the main-path shapes' times."""
    import torch

    from multimodal_mtrssm_tpu_torch.ops.kernels import recurrence, rollout

    C, K = cfg.class_size, cfg.category_size
    rng = np.random.default_rng(SEED + 2)
    rw, tw = model.representation_weights(), model.transition.weights()
    main: dict[str, tuple[float, float]] = {}
    for B, T in ((8, 30), (128, 30)):
        args = _recurrence_inputs(rng, B, T, cfg, dev)
        k_ms = _median_ms(lambda: recurrence.recurrence_forward_cuda(rw, *args, C, K), 50)
        p_ms = _median_ms(lambda: recurrence.recurrence_forward_plain(rw, *args, C, K), 10)
        print(f"time recurrence_fwd B={B} T={T}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"| {card}")
        main.setdefault("recurrence_fwd", (k_ms, p_ms))
    for B, T in ((8, 30), (10, 10), (64, 30), (256, 180)):
        actions = torch.tensor(rng.uniform(-1, 1, (B, T, cfg.action_size)).astype(np.float32),
                               device=dev)
        deter0, stoch0 = _recurrence_inputs(rng, B, 1, cfg, dev)[3:5]
        k_ms = _median_ms(lambda: rollout.rollout_cuda(tw, actions, deter0, stoch0, 5, C, K), 50)
        p_ms = _median_ms(lambda: rollout.rollout_plain(tw, actions, deter0, stoch0, 5, C, K), 5)
        print(f"time rollout B={B} T={T}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms | {card}")
        main.setdefault("rollout", (k_ms, p_ms))
    port, obs = ctx["server"].port, ctx["obs"]
    obs_req = {**obs, "seed": 3, "decode": True}
    im_req = {"state_id": ctx["state_id"], "actions": ctx["plan"], "seed": 4, "decode": True}
    for route, req in (("/observe", obs_req), ("/imagine", im_req)):
        lat = []
        for _ in range(12):
            t0 = time.perf_counter()
            _http(port, route, req, npz=True)
            lat.append((time.perf_counter() - t0) * 1e3)
        print(f"time server {route} B=8 T=30 decode npz: median {np.median(lat[2:]):.3f} ms "
              f"over {len(lat) - 2} requests | {card}")
    return main


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from multimodal_mtrssm_tpu_torch.models import MoPoEMRSSM, MRSSMConfig
    from multimodal_mtrssm_tpu_torch.ops.kernels import build

    build.load_library()
    print(f"build: {build.build_seconds:.2f} s ({build.library_path().name})")

    cfg = MRSSMConfig()
    model = MoPoEMRSSM(cfg).init(torch.Generator().manual_seed(0)).to(dev).eval()
    with torch.no_grad():
        checks = check_kernels(model, cfg, dev)
        ctx = drive_server(model, cfg, dev)
        try:
            times = timings(model, cfg, dev, card, ctx)
        finally:
            ctx["server"].stop()
    pkg = "multimodal_mtrssm_tpu_torch"
    meta = {
        "recurrence_fwd": (f"{pkg}/csrc/recurrence_fwd.cu",
                           "multimodal_mtrssm_tpu/ops/pallas/train_step.py:244"),
        "rollout": (f"{pkg}/csrc/rollout.cu", "multimodal_mtrssm_tpu/ops/pallas/rollout.py:105"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": ctx["counts"][name], "max_abs_err": checks[name]["max_abs_err"],
                "ms": times[name][0], "plain_ms": times[name][1]}
               for name, (src, rep) in meta.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
