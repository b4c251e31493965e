"""The port's MoPoE-MMTRSSM model, serving and training against the JAX package.

The port's ``MoPoEMMTRSSM`` is held to JAX ``MoPoEMMTRSSM`` with the same
weights (through ``export_reference_mmtrssm_state_dict`` → strict load) and
the same numpy noise. JAX's observe path with injected noise is composed
from its building blocks: ``init_proj`` and both priors with the
straight-through initial samples, then ``reference_mt_train_recurrence``
(the kernel path's pure-JAX twin), because JAX ``WorldModel.observe`` splits
its keys per step.

Tolerances, those of the MRSSM tests (``test_torch_port_serving.py``,
``test_torch_port_train.py``): 1e-5 for deters and logits, 1e-4 for frames;
``shared_step``'s losses within rtol 2e-5 and its gradient tree within
3e-4 × scale (and per tensor within 3e-4 of its own scale).
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.models.mmtrssm import MMTRSSMConfig as JaxMMTRSSMConfig
from multimodal_mtrssm_tpu.models.mmtrssm import MoPoEMMTRSSM as JaxMoPoEMMTRSSM
from multimodal_mtrssm_tpu.models.state import MTState as JaxMTState
from multimodal_mtrssm_tpu.nn.core import mlp_apply, mtrnn_apply
from multimodal_mtrssm_tpu.ops import distributions as jdist
from multimodal_mtrssm_tpu.ops.pallas import rollout as jax_rollout
from multimodal_mtrssm_tpu.ops.pallas import train_step_mt as jax_mt
from multimodal_mtrssm_tpu.ops.pallas.train_step import _st_sample
from multimodal_mtrssm_tpu.train.torch_export import (
    export_reference_mmtrssm_state_dict,
    save_lightning_checkpoint,
)
from multimodal_mtrssm_tpu.utils import count_params as jax_count_params
from multimodal_mtrssm_tpu_torch.data import episodes, pipeline
from multimodal_mtrssm_tpu_torch.models import MTState, State, cat_states, stack_states
from multimodal_mtrssm_tpu_torch.models.mmtrssm import MMTRSSMConfig, MoPoEMMTRSSM
from multimodal_mtrssm_tpu_torch.nn.conv import EncoderConfig
from multimodal_mtrssm_tpu_torch.ops import kernels
from multimodal_mtrssm_tpu_torch.ops.kernels import parity
from multimodal_mtrssm_tpu_torch.ops.kernels.rollout_mt import philox_mt_gumbel
from multimodal_mtrssm_tpu_torch.server import InferenceServer
from multimodal_mtrssm_tpu_torch.serving import WorldModel
from multimodal_mtrssm_tpu_torch.train.trainer import Trainer, TrainerConfig
from multimodal_mtrssm_tpu_torch.train.weights import (
    load_lightning_checkpoint,
    load_reference_state_dict,
)
from multimodal_mtrssm_tpu_torch.utils import count_params

REPO = Path(__file__).resolve().parents[1]
B, T = 3, 5
HP = dict(l_tau=2.0, h_tau=4.0, ls_class=4, ls_category=4, hs_class=2, hs_category=8)


def _port_enc(jax_enc) -> EncoderConfig:
    return EncoderConfig(**dataclasses.asdict(jax_enc))


@pytest.fixture(scope="module")
def models():
    """A small JAX MMTRSSM (reference recurrence path), its params, and the
    port model with the same weights (no input noise)."""
    from conftest import small_encoder_config

    enc = small_encoder_config()
    jmodel = JaxMoPoEMMTRSSM(JaxMMTRSSMConfig(audio_encoder=enc, vision_encoder=enc,
                                              init_proj_cells=32, use_pallas_train="reference"))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(11))
    port = MoPoEMMTRSSM(MMTRSSMConfig(audio_encoder=_port_enc(enc), vision_encoder=_port_enc(enc),
                                      init_proj_cells=32, input_noise_std=0.0))
    load_reference_state_dict(port, export_reference_mmtrssm_state_dict(params))
    return jmodel, params, port


def _obs(seed: int, b: int = B, t: int = T) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    return {"actions": rng.uniform(-1, 1, (b, t, 6)).astype(np.float32),
            "audio": rng.uniform(-1, 1, (b, t, 32, 32, 1)).astype(np.float32),
            "vision": rng.uniform(-1, 1, (b, t, 32, 32, 1)).astype(np.float32)}


def _jax_observe(jmodel, params, actions, audio, vision, noise):
    """JAX's observe on given noise (a dict of :meth:`noise_shapes`' keys):
    the straight-through initial samples, as ``reference_mt_train_recurrence``
    re-injects the estimator, then the recurrence. Returns ``(posterior,
    prior)`` JAX ``MTState``s with time on axis 1."""
    cfg = jmodel.cfg
    a_raw, v_raw = jmodel._encode_embeds(params, audio, vision)
    h = mlp_apply(params["init_proj"], (a_raw[:, 0] + v_raw[:, 0]) / 2.0, cfg.init_proj_activation)
    hd0, ld0 = h[:, :cfg.hd_dim], h[:, cfg.hd_dim:]

    def st(logits, g, c, k):
        s, p = _st_sample(logits, g, c, k)
        return jax.lax.stop_gradient(s - p) + p

    hs0 = st(mlp_apply(params["h_prior"], hd0, "ELU"), noise["g_init_h"], 2, 8)
    ls0 = st(mlp_apply(params["l_prior"], ld0, "ELU"), noise["g_init_l"], 4, 4)
    tm = lambda x: jnp.swapaxes(x, 0, 1)  # noqa: E731
    outs = jax_mt.reference_mt_train_recurrence(
        jax_mt.pack_mt_train_params(params), tm(actions), tm(a_raw), tm(v_raw),
        (hd0, ld0, hs0, ls0, hd0, ld0),
        tuple(noise[k] for k in ("g_lprior", "g_lpost", "g_hprior", "g_hpost")), **HP)
    (h_deter, l_deter, hid_h, hid_l, lpl, lps, mixed, ls, hpl, hps, hql, hs) = map(tm, outs)
    prior = JaxMTState(deter_h=h_deter, deter_l=l_deter, stoch_h=hps, stoch_l=lps,
                       distribution_h=jmodel._h_dist(hpl), distribution_l=jmodel._l_dist(lpl),
                       hidden_h=hid_h, hidden_l=hid_l)
    post = JaxMTState(deter_h=h_deter, deter_l=l_deter, stoch_h=hs, stoch_l=ls,
                      distribution_h=jmodel._h_dist(hql), distribution_l=jmodel._l_dist(mixed),
                      hidden_h=hid_h, hidden_l=hid_l)
    return post, prior


def _close(port: torch.Tensor, ref, atol: float, name: str = "") -> None:
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), rtol=0, atol=atol,
                               err_msg=name)


# ---- state, config, weights --------------------------------------------------------


def test_mtstate_feature_slicing_device_and_clone():
    rng = np.random.default_rng(0)
    widths = (32, 32, 16, 16, 16, 16, 32, 32)
    st = MTState(*(torch.from_numpy(rng.standard_normal((2, 3, w)).astype(np.float32))
                   for w in widths))
    # The decoders' feature order is hd, hs, ld, ls (reference state.py:51).
    assert torch.equal(st.feature, torch.cat([st.deter_h, st.stoch_h, st.deter_l, st.stoch_l], -1))
    assert st.feature.shape == (2, 3, 96) and st.batch_size == 2
    last = st[:, -1]
    for f in dataclasses.fields(st):
        assert torch.equal(getattr(last, f.name), getattr(st, f.name)[:, -1])
    copy = last.clone()
    for f in dataclasses.fields(st):  # every field from itself, no shared storage
        a, b = getattr(copy, f.name), getattr(last, f.name)
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    moved = st.to("cpu")
    assert isinstance(moved, MTState) and torch.equal(moved.hidden_l, st.hidden_l)
    both = stack_states([last, last], 1)
    assert both.deter_h.shape == (2, 2, 32)
    assert torch.equal(cat_states([st, st], 1).logits_h, torch.cat([st.logits_h] * 2, 1))
    mrssm = State(torch.zeros(4, 32), torch.zeros(4, 16), torch.zeros(4, 16))
    assert mrssm.batch_size == 4 and stack_states([mrssm] * 3, 0).deter.shape == (3, 4, 32)


def test_default_config_is_the_reference_yaml():
    """``MMTRSSMConfig()`` equals what JAX ``load_experiment`` builds from
    ``configs/mopoe_mmtrssm.yaml``, field by shared field, including the
    YAML's input noise (0.1, moved onto the device)."""
    from multimodal_mtrssm_tpu.train.config import load_experiment

    jcfg = load_experiment(str(REPO / "configs" / "mopoe_mmtrssm.yaml")).model.cfg
    cfg = MMTRSSMConfig()
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
    assert cfg.input_noise_std == 0.1 and cfg.feature_size == 96
    port, jmodel = MoPoEMMTRSSM(cfg), JaxMoPoEMMTRSSM(jcfg)
    assert count_params(port) == jax_count_params(jax.eval_shape(jmodel.init,
                                                                 jax.random.PRNGKey(0)))


def test_reference_state_dict_round_trip(tmp_path):
    """At the reference config: 120 reference-named tensors, 1,747,386
    parameters, strict both ways, through a Lightning ``.ckpt`` too."""
    jmodel = JaxMoPoEMMTRSSM(JaxMMTRSSMConfig())
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(2))
    sd = export_reference_mmtrssm_state_dict(params)
    port = MoPoEMMTRSSM()
    assert set(port.state_dict()) == set(sd) and len(sd) == 120
    assert count_params(port) == sum(v.size for v in sd.values()) == 1_747_386
    assert not any(k.startswith(("transition.", "l_posterior.")) for k in sd)
    load_reference_state_dict(port, sd)
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    save_lightning_checkpoint(params, str(tmp_path / "m.ckpt"), model_type="mmtrssm")
    fresh = load_lightning_checkpoint(MoPoEMMTRSSM().init(torch.Generator().manual_seed(1)),
                                      tmp_path / "m.ckpt")
    assert all(torch.equal(v, port.state_dict()[k]) for k, v in fresh.state_dict().items())
    del sd["h_posterior.0.weight"]
    with pytest.raises(RuntimeError, match="h_posterior.0.weight"):
        load_reference_state_dict(MoPoEMMTRSSM(), sd)


# ---- WorldModel against JAX --------------------------------------------------------


def test_observe_and_decode_match_jax(models):
    jmodel, params, port = models
    obs = _obs(1)
    noise = port.draw_noise(B, T, torch.Generator().manual_seed(9))
    post_ref, prior_ref = _jax_observe(jmodel, params, *(jnp.asarray(obs[k]) for k in obs),
                                       {k: jnp.asarray(v.numpy()) for k, v in noise.items()})
    wm = WorldModel(port, "cpu")
    post, prior = wm.observe(obs["actions"], obs["audio"], obs["vision"], seed=9)
    for name in ("deter_h", "deter_l", "hidden_h", "hidden_l"):
        _close(getattr(post, name), getattr(post_ref, name), 1e-5, name)
    for got, ref in ((post.logits_l, post_ref.distribution_l.logits),
                     (post.logits_h, post_ref.distribution_h.logits),
                     (prior.logits_l, prior_ref.distribution_l.logits),
                     (prior.logits_h, prior_ref.distribution_h.logits)):
        _close(got, ref, 1e-5)
    for got, ref in ((post.stoch_l, post_ref.stoch_l), (post.stoch_h, post_ref.stoch_h),
                     (prior.stoch_l, prior_ref.stoch_l), (prior.stoch_h, prior_ref.stoch_h)):
        np.testing.assert_array_equal(got.numpy().round(), np.asarray(ref).round())
        _close(got, ref, 1e-6)
    frames_ref = jmodel.decode_state(params, post_ref)
    frames = wm.decode(post)
    for k in ("recon/audio", "recon/vision"):
        assert frames[k].shape == (B, T, 32, 32, 1)
        _close(frames[k], frames_ref[k], 1e-4, k)


def test_imagine_matches_jax_replay_and_chains_exactly(models):
    """``imagine`` is the JAX per-step math sampled with the seed's Philox
    noise, integrators included; a continuation from its ``[:, -1]`` starts
    from all six carries (``test_torch_port_mt_kernels.py`` holds a chained
    rollout to one long one)."""
    jmodel, params, port = models
    wm = WorldModel(port, "cpu")
    post, _ = wm.observe(*_obs(2).values(), seed=3)
    start = post[:, -1]
    plan = np.random.default_rng(4).uniform(-1, 1, (B, 7, 6)).astype(np.float32)
    got = wm.imagine(plan, start, seed=12)
    g_l, g_h = (g.numpy() for g in philox_mt_gumbel(12, 7, B))
    hd, ld, hs, ls, hidh, hidl = (jnp.asarray(getattr(start, f).numpy()) for f in (
        "deter_h", "deter_l", "stoch_h", "stoch_l", "hidden_h", "hidden_l"))
    for t in range(7):
        l_deter, l_logits, hidl = jmodel._lower_prior(params, jnp.asarray(plan[:, t]), ls, hs, ld,
                                                      hidl)
        h_deter, hidh = mtrnn_apply(params["h_rnn"], hs, hd, hidh, 4.0)
        h_logits = mlp_apply(params["h_prior"], h_deter, "ELU")
        ls = jax_rollout.onehot_blocks(l_logits + g_l[t], 4, 4)
        hs = jax_rollout.onehot_blocks(h_logits + g_h[t], 2, 8)
        hd, ld = h_deter, l_deter
        for name, ref in (("deter_h", hd), ("deter_l", ld), ("logits_h", h_logits),
                          ("logits_l", l_logits), ("hidden_h", hidh), ("hidden_l", hidl)):
            _close(getattr(got, name)[:, t], ref, 1e-5, f"{name}[{t}]")
        np.testing.assert_array_equal(got.stoch_l[:, t].numpy(), np.asarray(ls))
        np.testing.assert_array_equal(got.stoch_h[:, t].numpy(), np.asarray(hs))
    again = wm.imagine(plan[:, :3], got[:, -1], seed=5)
    direct = port.rollout_transition(torch.from_numpy(plan[:, :3]), got[:, -1].clone(), 5)
    for f in dataclasses.fields(again):
        assert torch.equal(getattr(again, f.name), getattr(direct, f.name))
    frames = wm.imagine_frames(plan, start, seed=12)
    for k, v in wm.decode(got).items():
        assert torch.equal(frames[k], v)


def test_observe_draws_its_noise_from_the_seed(models):
    _, _, port = models
    wm = WorldModel(port, "cpu")
    obs = _obs(3)
    a = wm.observe(*obs.values(), seed=4)[0]
    b = wm.observe(*obs.values(), seed=4)[0]
    c = wm.observe(*obs.values(), seed=5)[0]
    assert torch.equal(a.stoch_l, b.stoch_l) and torch.equal(a.logits_h, b.logits_h)
    assert not (torch.equal(a.stoch_l, c.stoch_l) and torch.equal(a.stoch_h, c.stoch_h))
    noise = port.draw_noise(B, T, torch.Generator().manual_seed(4))
    assert list(noise) == ["g_init_h", "g_init_l", "g_lprior", "g_lpost", "g_hprior", "g_hpost"]
    assert [tuple(v.shape) for v in noise.values()] == [(B, 16), (B, 16)] + [(T, B, 16)] * 4


# ---- shared_step against a JAX composition ------------------------------------------


def _batch(seed: int, b: int = 2, t: int = 5):
    rng = np.random.default_rng(seed)
    act = rng.uniform(-1, 1, (b, t, 6)).astype(np.float32)
    audio, vision = (rng.uniform(-1, 1, (b, t, 32, 32, 1)).astype(np.float32) for _ in range(2))
    shapes = {"g_init_h": (b, 16), "g_init_l": (b, 16), "g_lprior": (t, b, 16),
              "g_lpost": (t, b, 16), "g_hprior": (t, b, 16), "g_hpost": (t, b, 16)}
    noise = {k: rng.gumbel(size=s).astype(np.float32) for k, s in shapes.items()}
    return (act, audio, vision, act, audio, vision), noise


def _jax_elbo(jmodel, params, batch, noise):
    """encoders → straight-through initial state → ``reference_mt_train_
    recurrence`` → decoders → Gaussian NLL + both layers' balanced KL."""
    cfg = jmodel.cfg
    post, prior = _jax_observe(jmodel, params, batch[0], batch[1], batch[2], noise)
    losses = jmodel.compute_reconstruction_loss(
        jmodel.decode_state(params, post), {"recon/audio": batch[4], "recon/vision": batch[5]})
    kl_l = jdist.kl_balanced(post.distribution_l, prior.distribution_l, use_balancing=True)
    kl_h = jdist.kl_balanced(post.distribution_h, prior.distribution_h, use_balancing=True)
    losses["kl"] = jnp.mean(jnp.sum(kl_l, axis=-1)) * cfg.kl_coeff
    losses["kl_h"] = jnp.mean(jnp.sum(kl_h, axis=-1)) * (cfg.kl_coeff * cfg.w_kl_h)
    losses["loss"] = losses["recon"] + losses["kl"] + losses["kl_h"]
    return losses


def test_shared_step_loss_and_gradients_match_jax(models):
    jmodel, params, port = models
    batch, noise = _batch(11)
    jb = tuple(map(jnp.asarray, batch))
    jn = {k: jnp.asarray(v) for k, v in noise.items()}

    def loss(p):
        d = _jax_elbo(jmodel, p, jb, jn)
        return d["loss"], d

    grads, ref = jax.jit(jax.grad(loss, has_aux=True))(params)
    ref_grads = export_reference_mmtrssm_state_dict(grads)
    port.zero_grad(set_to_none=True)
    out = port.shared_step(tuple(map(torch.from_numpy, batch)),
                           {k: torch.from_numpy(v) for k, v in noise.items()})
    assert sorted(out) == ["kl", "kl_h", "loss", "recon", "recon/audio", "recon/vision"]
    for key in out:
        np.testing.assert_allclose(float(out[key].detach()), float(ref[key]), rtol=2e-5,
                                   err_msg=key)
    out["loss"].backward()
    got = {n: p.grad for n, p in port.named_parameters()}
    assert set(got) == set(ref_grads)
    scale = max(1.0, max(float(np.abs(g).max()) for g in ref_grads.values()))
    for name, g in ref_grads.items():
        np.testing.assert_allclose(got[name].numpy(), g, rtol=0, atol=3e-4 * scale, err_msg=name)
        g_scale = max(1.0, float(np.abs(g).max()))
        np.testing.assert_allclose(got[name].numpy(), g, rtol=0, atol=3e-4 * g_scale,
                                   err_msg=name)
    # Every part of the model receives gradient, through both initial samples too.
    for prefix in ("init_proj", "audio_encoder", "l_rnn", "h_rnn", "h_posterior", "h_prior",
                   "l_prior", "vision_representation", "audio_decoder"):
        assert any(float(got[n].abs().max()) > 0 for n in got if n.startswith(prefix)), prefix


def test_shared_step_input_noise_and_generator(models):
    """With ``input_noise_std`` the given normals are added to the inputs
    only; missing noise is drawn from the generator, a function of its seed;
    the CPU route launches no kernel."""
    _, _, port = models
    batch, noise = _batch(12)
    rng = np.random.default_rng(3)
    normals = tuple(rng.standard_normal(x.shape).astype(np.float32) for x in batch[:3])
    stds = (0.1, 0.2, 0.0)
    noisy = MoPoEMMTRSSM(dataclasses.replace(port.cfg, input_noise_std=stds))
    noisy.load_state_dict(port.state_dict())
    t = lambda xs: tuple(map(torch.from_numpy, xs))  # noqa: E731
    tn = {k: torch.from_numpy(v) for k, v in noise.items()}
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = noisy.shared_step(t(batch), {**tn, "input": t(normals)})
        pre = tuple(x + s * n for x, s, n in zip(batch[:3], stds, normals))
        want = port.shared_step(t(pre) + t(batch[3:]), tn)
        for key in ("loss", "recon", "kl", "kl_h"):
            assert float(got[key]) == pytest.approx(float(want[key]), rel=1e-6), key
        a, b, c = (port.shared_step(t(batch), generator=torch.Generator().manual_seed(s))
                   for s in (4, 4, 5))
    assert all(torch.isfinite(v) for v in a.values())
    assert float(a["loss"]) == float(b["loss"]) != float(c["loss"])
    assert parity.train_step_near_ties(port, t(batch), tn, 1e-5) >= 0
    assert kernels.launch_counts() == dict.fromkeys(kernels.LAUNCH_COUNTERS, 0)


# ---- HTTP and Trainer.fit ---------------------------------------------------------------


def test_http_round_trip(models):
    from test_torch_port_serving import _request

    _, _, port = models
    server = InferenceServer(WorldModel(port, "cpu"), port=0)
    server.start()
    try:
        code, health = _request(server.port, "/healthz")
        assert code == 200 and health["model"] == "MoPoEMMTRSSM" and health["platform"] == "cpu"
        assert health["n_params"] == count_params(port)
        obs = _obs(5)
        code, out = _request(server.port, "/observe", {
            **{k: v.tolist() for k, v in obs.items()}, "seed": 2, "decode": True})
        assert code == 200 and (out["batch"], out["t"]) == (B, T)
        assert np.asarray(out["recon"]["recon/audio"]).shape == (B, T, 32, 32, 1)
        plan = np.zeros((B, 4, 6), np.float32)
        code, im = _request(server.port, "/imagine", {"state_id": out["state_id"], "actions": plan,
                                                      "seed": 1}, npz=True)
        assert code == 200 and im["frames/recon/vision"].shape == (B, 4, 32, 32, 1)
        code, im2 = _request(server.port, "/imagine", {"state_id": str(im["state_id"]),
                                                       "actions": plan.tolist(), "seed": 2})
        assert code == 200 and np.isfinite(np.asarray(im2["frames"]["recon/audio"])).all()
        assert _request(server.port, "/imagine", {"state_id": im2["state_id"],
                                                  "actions": np.zeros((B + 1, 2, 6)).tolist()})[0] == 400
    finally:
        server.stop()


def test_trainer_fit_on_the_cpu(tmp_path):
    from conftest import small_encoder_config

    data = tmp_path / "episodes"
    episodes.generate_synthetic_audio_mnist(data, n_episodes=7, episode_length=12, seed=3)
    dm = pipeline.EpisodeDataModule(pipeline.DataModuleConfig(
        data_dir=str(data), batch_size=2, sequence_length=6, seed=5, noise_std=0.0))
    enc = _port_enc(small_encoder_config())
    cfg = MMTRSSMConfig(audio_encoder=enc, vision_encoder=enc, init_proj_cells=32)
    model = MoPoEMMTRSSM(cfg)
    kernels.reset_launch_counts()
    out = Trainer(model, dm, TrainerConfig(max_epochs=2, log_dir=str(tmp_path / "run"),
                                           seed=3)).fit()
    init = MoPoEMMTRSSM(cfg).init(torch.Generator().manual_seed(3))
    assert out["global_step"] == 6 and len(out["history"]) == 2
    for row in out["history"]:
        assert all(np.isfinite(v) for v in row.values())
        assert {"train/loss", "train/kl", "train/kl_h", "val/kl_h", "val/loss"} <= set(row)
    rows = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()]
    rows = [r for r in rows if "image" not in r]  # the charts' paths follow the epoch rows
    assert out["best_val"] == min(r["val/loss"] for r in rows)
    assert all(not torch.equal(p, q) for p, q in zip(model.parameters(), init.parameters()))
    best = load_lightning_checkpoint(MoPoEMMTRSSM(cfg), tmp_path / "run" / "checkpoints" / "best.ckpt")
    assert all(torch.isfinite(p).all() for p in best.parameters())
    assert kernels.launch_counts() == dict.fromkeys(kernels.LAUNCH_COUNTERS, 0)


def test_server_main_builds_either_family(monkeypatch):
    """``--model mmtrssm`` serves the hierarchical model at its reference config."""
    from multimodal_mtrssm_tpu_torch import server as server_mod

    built = {}

    class Fake:
        def __init__(self, wm, host, port):
            built["model"], self.port = wm.model, 0

        def serve_forever(self):
            pass

    monkeypatch.setattr(server_mod, "InferenceServer", Fake)
    server_mod.main(["--model", "mmtrssm", "--device", "cpu"])
    assert isinstance(built["model"], MoPoEMMTRSSM) and built["model"].cfg == MMTRSSMConfig()
    with pytest.raises(SystemExit):
        server_mod.main(["--model", "nope"])
