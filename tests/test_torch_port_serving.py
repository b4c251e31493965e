"""The port's serving slice: weight bridge, ``WorldModel`` and the HTTP server.

``WorldModel`` is held to the JAX package with the same weights (through
``export_reference_state_dict``) and the same numpy noise: JAX's observe
path is ``initial_state_from_embed`` + ``reference_train_recurrence`` (the
kernel path's pure-JAX twin), because JAX ``WorldModel.observe`` splits its
keys per step. Tolerances: 1e-5 for deters and logits, 1e-4 for frames.
"""

import dataclasses
import io
import json
import subprocess
import sys
import urllib.request
from pathlib import Path
from urllib.error import HTTPError

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.models.mrssm import MoPoEMRSSM as JaxMoPoEMRSSM
from multimodal_mtrssm_tpu.models.mrssm import MRSSMConfig as JaxMRSSMConfig
from multimodal_mtrssm_tpu.models.state import State as JaxState
from multimodal_mtrssm_tpu.nn.core import mlp_apply
from multimodal_mtrssm_tpu.ops.pallas import rollout as jax_rollout
from multimodal_mtrssm_tpu.ops.pallas.train_step import (
    _st_sample,
    pack_train_params,
    reference_train_recurrence,
)
from multimodal_mtrssm_tpu.train.torch_export import (
    export_reference_state_dict,
    save_lightning_checkpoint,
)
from multimodal_mtrssm_tpu.utils import count_params as jax_count_params
from multimodal_mtrssm_tpu_torch.models.mrssm import MoPoEMRSSM, MRSSMConfig
from multimodal_mtrssm_tpu_torch.nn.conv import EncoderConfig
from multimodal_mtrssm_tpu_torch.ops import kernels
from multimodal_mtrssm_tpu_torch.ops.distributions import gumbel_noise
from multimodal_mtrssm_tpu_torch.ops.kernels.rollout import philox_gumbel
from multimodal_mtrssm_tpu_torch.server import InferenceServer
from multimodal_mtrssm_tpu_torch.serving import WorldModel
from multimodal_mtrssm_tpu_torch.train.weights import (
    load_lightning_checkpoint,
    load_reference_state_dict,
)
from multimodal_mtrssm_tpu_torch.utils import count_params

REPO = Path(__file__).resolve().parents[1]
C, K, S = 4, 4, 16
B, T = 3, 5


@pytest.fixture(scope="module")
def models():
    from conftest import small_encoder_config

    enc = small_encoder_config()
    jmodel = JaxMoPoEMRSSM(JaxMRSSMConfig(audio_encoder=enc, vision_encoder=enc))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(21))
    port_enc = EncoderConfig(**dataclasses.asdict(enc))
    port = MoPoEMRSSM(MRSSMConfig(audio_encoder=port_enc, vision_encoder=port_enc))
    load_reference_state_dict(port, export_reference_state_dict(params))
    return jmodel, params, port.eval()


def _obs(seed: int, b: int = B, t: int = T):
    rng = np.random.default_rng(seed)
    return {
        "actions": rng.uniform(-1, 1, (b, t, 6)).astype(np.float32),
        "audio": rng.uniform(-1, 1, (b, t, 32, 32, 1)).astype(np.float32),
        "vision": rng.uniform(-1, 1, (b, t, 32, 32, 1)).astype(np.float32),
    }


def _observe(wm: WorldModel, obs: dict, seed: int = 0):
    return wm.observe(obs["actions"], obs["audio"], obs["vision"], seed=seed)


def _close(port: torch.Tensor, ref, atol: float) -> None:
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=0, atol=atol)


# ---- weight bridge ---------------------------------------------------------------


def test_reference_state_dict_round_trip(models, tmp_path):
    """JAX params → export → port (strict) reproduces every tensor, and so
    does a Lightning ``.ckpt`` written by ``save_lightning_checkpoint``."""
    jmodel, params, port = models
    sd = export_reference_state_dict(params)
    got = port.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    path = tmp_path / "model.ckpt"
    save_lightning_checkpoint(params, str(path))
    fresh = MoPoEMRSSM(port.cfg).init(torch.Generator().manual_seed(1))
    load_lightning_checkpoint(fresh, path)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, got[k]), k
    assert count_params(port) == jax_count_params(params)


def test_reference_state_dict_is_strict(models):
    _, params, port = models
    sd = dict(export_reference_state_dict(params))
    sd.pop("init_proj.0.bias")
    with pytest.raises(RuntimeError, match="init_proj.0.bias"):
        load_reference_state_dict(MoPoEMRSSM(port.cfg), sd)


def test_default_config_is_the_reference_yaml():
    """``MRSSMConfig()`` equals what JAX ``load_experiment`` builds from
    ``configs/mopoe_mrssm.yaml``, field by shared field."""
    from multimodal_mtrssm_tpu.train.config import load_experiment

    jcfg = load_experiment(str(REPO / "configs" / "mopoe_mrssm.yaml")).model.cfg
    cfg = MRSSMConfig()
    for f in dataclasses.fields(cfg):
        if f.name in ("audio_decoder", "vision_decoder"):
            ours, theirs = cfg.decoder_cfg(f.name.split("_")[0]), getattr(jcfg, f.name)
        else:
            ours, theirs = getattr(cfg, f.name), getattr(jcfg, f.name)
        if dataclasses.is_dataclass(ours):
            ours, theirs = dataclasses.asdict(ours), dataclasses.asdict(theirs)
        if f.name == "compute_dtype":  # torch's and JAX's dtypes, by name
            ours, theirs = str(ours).removeprefix("torch."), jnp.dtype(theirs).name
        assert ours == theirs, f.name
    port, jmodel = MoPoEMRSSM(cfg), JaxMoPoEMRSSM(jcfg)
    assert count_params(port) == jax_count_params(jax.eval_shape(jmodel.init,
                                                                 jax.random.PRNGKey(0)))


# ---- WorldModel against JAX -----------------------------------------------------------


def _jax_observe(jmodel, params, obs, g_init, g_prior, g_post):
    """JAX's observe on given noise: the kernel path's pure-JAX twin."""
    cfg = jmodel.cfg
    a_raw, v_raw = jmodel._encode_embeds(params, jnp.asarray(obs["audio"]),
                                         jnp.asarray(obs["vision"]))
    embed0 = (a_raw[:, 0] + v_raw[:, 0]) / 2.0
    deter0 = mlp_apply(params["init_proj"], embed0, cfg.init_proj_activation)
    logits0 = mlp_apply(params["transition"]["rnn_to_prior_projector"], deter0, "ELU")
    stoch0, _ = _st_sample(logits0, jnp.asarray(g_init), C, K)
    tm = lambda x: jnp.swapaxes(x, 0, 1)  # noqa: E731
    outs = reference_train_recurrence(
        pack_train_params(params), tm(jnp.asarray(obs["actions"])), tm(a_raw), tm(v_raw),
        deter0, stoch0, jnp.asarray(g_prior), jnp.asarray(g_post), class_size=C, category_size=K)
    return [np.asarray(tm(o)) for o in outs]


def test_observe_and_decode_match_jax(models):
    jmodel, params, port = models
    obs = _obs(1)
    gen = torch.Generator().manual_seed(9)
    noise = [gumbel_noise(s, gen) for s in ((B, S), (T, B, S), (T, B, S))]
    ref = _jax_observe(jmodel, params, obs, *(n.numpy() for n in noise))
    wm = WorldModel(port, "cpu")
    post, prior = _observe(wm, obs, seed=9)
    for got, want in ((post.deter, ref[0]), (prior.logits, ref[1]), (post.logits, ref[3])):
        _close(got, want, 1e-5)
    for got, want in ((prior.stoch, ref[2]), (post.stoch, ref[4])):
        np.testing.assert_array_equal(got.numpy().round(), want.round())
        _close(got, want, 1e-6)
    dist = jmodel._dist(jnp.asarray(ref[3]))
    frames_ref = jmodel.decode_state(params, JaxState(deter=jnp.asarray(ref[0]),
                                                      stoch=jnp.asarray(ref[4]),
                                                      distribution=dist))
    frames = wm.decode(post)
    for k in ("recon/audio", "recon/vision"):
        assert frames[k].shape == (B, T, 32, 32, 1)
        _close(frames[k], frames_ref[k], 1e-4)


def test_imagine_matches_jax_replay_with_the_philox_noise(models):
    """``imagine`` is the JAX transition core sampled with the seed's Philox
    noise, and ``imagine_frames`` decodes it."""
    jmodel, params, port = models
    wm = WorldModel(port, "cpu")
    post, _ = _observe(wm, _obs(2), seed=3)
    start = post[:, -1]
    plan = np.random.default_rng(4).uniform(-1, 1, (B, 7, 6)).astype(np.float32)
    got = wm.imagine(plan, start, seed=12)
    noise = philox_gumbel(12, 7, B, C, K).numpy()
    deter, stoch = jnp.asarray(start.deter.numpy()), jnp.asarray(start.stoch.numpy())
    for t in range(7):
        deter, logits = jmodel._transition_core(params, jnp.asarray(plan[:, t]), stoch, deter)
        stoch = jax_rollout.onehot_blocks(logits + noise[t], C, K)
        _close(got.deter[:, t], deter, 1e-5)
        _close(got.logits[:, t], logits, 1e-5)
        np.testing.assert_array_equal(got.stoch[:, t].numpy(), np.asarray(stoch))
    frames = wm.imagine_frames(plan, start, seed=12)
    for k, v in wm.decode(got).items():
        assert torch.equal(frames[k], v)


def test_cpu_tensors_leave_the_launch_counts_at_zero(models):
    _, _, port = models
    kernels.reset_launch_counts()
    wm = WorldModel(port, "cpu")
    post, _ = _observe(wm, _obs(3), seed=0)
    wm.imagine_frames(np.zeros((B, 4, 6), np.float32), post[:, -1], seed=1)
    assert kernels.launch_counts() == dict.fromkeys(kernels.LAUNCH_COUNTERS, 0)


def test_world_model_rejects_malformed_inputs(models):
    _, _, port = models
    wm = WorldModel(port, "cpu")
    obs = _obs(4)
    with pytest.raises(ValueError, match="actions"):
        wm.observe(obs["actions"][..., :5], obs["audio"], obs["vision"])
    with pytest.raises(ValueError, match="vision"):
        wm.observe(obs["actions"], obs["audio"], obs["vision"][:, :, :16])
    post, _ = _observe(wm, obs)
    with pytest.raises(ValueError, match="batch"):
        wm.imagine(np.zeros((B + 1, 2, 6), np.float32), post[:, -1])


# ---- HTTP ------------------------------------------------------------------------------


def _request(port: int, path: str, payload=None, npz: bool = False):
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
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            body, ctype, code = resp.read(), resp.headers.get("Content-Type", ""), resp.status
    except HTTPError as e:
        return e.code, json.loads(e.read())
    if "npz" in ctype:
        with np.load(io.BytesIO(body), allow_pickle=False) as z:
            return code, {k: z[k] for k in z.files}
    return code, json.loads(body)


def test_http_round_trip(models):
    _, _, port = models
    server = InferenceServer(WorldModel(port, "cpu"), port=0)
    server.start()
    try:
        code, health = _request(server.port, "/healthz")
        assert code == 200 and health["platform"] == "cpu" and health["model"] == "MoPoEMRSSM"
        assert health["n_params"] == count_params(port)
        obs = _obs(5)
        code, out = _request(server.port, "/observe", {
            **{k: v.tolist() for k, v in obs.items()}, "seed": 2, "decode": True})
        assert code == 200 and (out["batch"], out["t"]) == (B, T)
        assert np.asarray(out["recon"]["recon/audio"]).shape == (B, T, 32, 32, 1)
        code, out_npz = _request(server.port, "/observe", {**obs, "seed": 2, "decode": True},
                                 npz=True)
        assert code == 200
        np.testing.assert_allclose(out_npz["recon/recon/vision"],
                                   np.asarray(out["recon"]["recon/vision"], np.float32),
                                   rtol=0, atol=0)  # same seed, same frames
        plan = np.zeros((B, 4, 6), np.float32)
        code, im = _request(server.port, "/imagine",
                            {"state_id": out["state_id"], "actions": plan.tolist(), "seed": 1})
        assert code == 200 and np.asarray(im["frames"]["recon/audio"]).shape == (B, 4, 32, 32, 1)
        code, im2 = _request(server.port, "/imagine", {"state_id": im["state_id"],
                                                       "actions": plan, "decode": False}, npz=True)
        assert code == 200 and "frames/recon/audio" not in im2 and str(im2["t"]) == "4"
        assert _request(server.port, "/imagine", {"state_id": "nope", "actions": plan.tolist()})[0] == 404
        assert _request(server.port, "/observe", {"actions": plan.tolist()})[0] == 400
        assert _request(server.port, "/imagine", {"state_id": im["state_id"],
                                                  "actions": np.zeros((B, 4, 5)).tolist()})[0] == 400
        assert _request(server.port, "/nowhere", {})[0] == 404
    finally:
        server.stop()


# ---- package hygiene ---------------------------------------------------------------------


def test_port_imports_no_jax():
    """Every module of the port imports with JAX unavailable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import multimodal_mtrssm_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.startswith('multimodal_mtrssm_tpu.')"
        " or m == 'multimodal_mtrssm_tpu']\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120, check=False)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 15


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result off the card,
    and alone, without the package beside it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for cwd, script in ((REPO, REPO / "chip_smoke.py"), (tmp_path, alone)):
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True,
                              text=True, timeout=120, check=False)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
