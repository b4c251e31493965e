"""The port's trainer completion on the CPU: optimizer, scheduler and
early-stop state restored from the JAX package's state dicts, SIGTERM
preemption and exact resume, gradient accumulation, an integer
``steps_per_dispatch``, ``resume_from`` warm starts, ``diverged`` resuming, ``profile_epoch``,
callbacks and the charts.

Tolerances: a resumed fit, and a fit at K=4, equal the uninterrupted K=1
fit bit for bit (weights, and the epoch rows' metrics); the epoch row of a
mid-epoch resume within rtol 1e-6 of the uninterrupted one (JAX holds its
own to that). The AdamW steps after a state restored from JAX within rtol
1e-6, atol 1e-9 of ``FusedAdamW``'s (the optimizer's bound). Restored
counters, learning rates and chart pixels exactly. The accumulated
gradient against ``jax.grad`` is held in ``test_torch_port_train.py``,
beside JAX's ELBO.
"""

import contextlib
import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.train import optim as jax_optim
from multimodal_mtrssm_tpu_torch.data import episodes, pipeline
from multimodal_mtrssm_tpu_torch.models import (
    MMTRSSMConfig,
    MoPoEMMTRSSM,
    MoPoEMRSSM,
    MRSSMConfig,
)
from multimodal_mtrssm_tpu_torch.nn.conv import EncoderConfig
from multimodal_mtrssm_tpu_torch.train import optim
from multimodal_mtrssm_tpu_torch.train import trainer as trainer_mod
from multimodal_mtrssm_tpu_torch.train.checkpoint import CheckpointManager
from multimodal_mtrssm_tpu_torch.train.steps import fold
from multimodal_mtrssm_tpu_torch.train.trainer import Trainer, TrainerConfig
from _port_threads import _one_intra_op_thread  # noqa: F401 (autouse)

@pytest.fixture(autouse=True)
def _no_charts(request, monkeypatch):
    """Fits draw no charts here (0.6 s a fit) but in the tests of the charts."""
    if "chart" not in request.node.name:
        import multimodal_mtrssm_tpu_torch.viz.charts as charts

        monkeypatch.setattr(charts, "render_combined_charts", lambda *a, **k: [])


SPECS = [None, {"kind": "plateau", "patience": 1, "factor": 0.3}, {"kind": "cosine", "t_max": 4},
         {"kind": "step", "step_size": 2}, {"kind": "exponential", "gamma": 0.7}]


def _cfg(family: str = "mrssm", **kw):
    from conftest import small_encoder_config

    enc = EncoderConfig(**dataclasses.asdict(small_encoder_config()))
    cls = MMTRSSMConfig if family == "mmtrssm" else MRSSMConfig
    return cls(audio_encoder=enc, vision_encoder=enc, init_proj_cells=32, **kw)


def _model(family: str = "mrssm", **kw):
    cfg = _cfg(family, **kw)
    return (MoPoEMMTRSSM if family == "mmtrssm" else MoPoEMRSSM)(cfg)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """13 episodes: 10 train (5 batches of 2 an epoch), 3 val."""
    d = tmp_path_factory.mktemp("episodes")
    episodes.generate_synthetic_audio_mnist(d, n_episodes=13, episode_length=6, seed=3)
    return d


def _dm(data_dir, noise_std: float = 0.1, batch_size: int = 2):
    return pipeline.EpisodeDataModule(pipeline.DataModuleConfig(
        data_dir=str(data_dir), batch_size=batch_size, sequence_length=3, noise_std=noise_std,
        seed=5))


def _trainer(data_dir, log_dir, family="mrssm", callbacks=None, noise_std=0.1, **kw):
    kw = {"max_epochs": 2, "learning_rate": 3e-4, "seed": 7, **kw}
    return Trainer(_model(family), _dm(data_dir, noise_std),
                   TrainerConfig(log_dir=str(log_dir), **kw), callbacks)


@pytest.fixture(scope="module")
def reference(tmp_path_factory, data_dir):
    """``reference(family, **options)``: the uninterrupted fit with those
    options, ``(trainer, fit result)``, made once for the tests that hold
    a run to it. They only read it."""
    done = {}

    def fit(family="mrssm", **kw):
        key = (family, tuple(sorted(kw.items())))
        if key not in done:
            trainer = _trainer(data_dir, tmp_path_factory.mktemp("ref"), family, **kw)
            done[key] = (trainer, trainer.fit())
        return done[key]

    return fit


@contextlib.contextmanager
def _sigterm_after(n: int, builder: str = "make_train_step"):
    """SIGTERM this process right after the n-th train (or grad) step."""
    real = getattr(trainer_mod, builder)

    def make(*args):
        step, calls = real(*args), [0]

        def wrapped(*a):
            out = step(*a)
            calls[0] += 1
            if calls[0] == n:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return wrapped

    setattr(trainer_mod, builder, make)
    try:
        yield
    finally:
        setattr(trainer_mod, builder, real)


def _same_weights(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))


def _rows(out):
    return [{k: v for k, v in r.items() if k != "seq_per_sec"} for r in out["history"]]


# ---- state restored from the JAX package ------------------------------------------


@pytest.mark.parametrize("spec", SPECS)
def test_scheduler_and_early_stop_restore_from_jax_state_dicts(spec):
    """A JAX scheduler's and EarlyStopping's state dicts, mid-run, restore
    to the same counters in the port, which then step alike."""
    values = [5.0, 4.0, 4.0, 4.5, 3.0, 3.0, 3.0, 2.9, 3.5]
    theirs = jax_optim.make_scheduler(spec, 1e-3, plateau_patience=2)
    jes = jax_optim.EarlyStopping(patience=3)
    for v in values[:4]:
        theirs.step(v)
        jes.step(v)
    state = json.loads(json.dumps(theirs.state_dict()))  # through the JSON sidecar
    ours = optim.scheduler_from_state_dict(state)
    assert type(ours).__name__ == type(theirs).__name__
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    es = optim.EarlyStopping.from_state_dict(json.loads(json.dumps(jes.state_dict())))
    assert dataclasses.asdict(es) == dataclasses.asdict(jes)
    assert [ours.step(v) for v in values[4:]] == [theirs.step(v) for v in values[4:]]
    assert [es.step(v) for v in values[4:]] == [jes.step(v) for v in values[4:]]


def test_adamw_restores_a_jax_optimizer_state():
    """``FusedAdamW``'s state after 3 steps (moments, count, learning rate)
    loads into the port's AdamW, whose next steps then match JAX's."""
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": (3,), "c": (2, 2, 2)}  # ravel_pytree's order is the port's
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    jopt = jax_optim.make_optimizer(1e-2, grad_clip=10.0, weight_decay=0.1)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    for i, g in enumerate(grads):
        if i == 3:
            params = [torch.tensor(np.asarray(jparams[k])) for k in shapes]
            opt = optim.AdamW(params, 1.0, grad_clip=10.0, weight_decay=0.1)
            opt.load_state_dict({k: np.asarray(getattr(jstate, k)) for k in ("m", "v")}
                                | {"count": int(jstate.count), "lr": float(jstate.lr)})
            assert (opt.count, opt.lr) == (3, pytest.approx(1e-2))
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, updates)
        if i >= 3:
            for p, k in zip(params, shapes):
                p.grad = torch.from_numpy(g[k])
            opt.step()
            for p, k in zip(params, shapes):
                np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                           atol=1e-9, err_msg=f"step {i} {k}")
    with pytest.raises(ValueError, match="entries"):
        opt.load_state_dict({"m": np.zeros(3), "v": np.zeros(3), "count": 1, "lr": 1e-3})


# ---- preemption and resume ----------------------------------------------------------


def test_sigterm_after_an_epoch_resumes_at_the_next(tmp_path, data_dir):
    """SIGTERM from a callback after epoch 1: the fit returns ``preempted``
    after that epoch with a ``last`` checkpoint, SIGTERM's disposition is
    restored, and ``resume=True`` continues at epochs [2, 3] (JAX
    ``tests/test_trainer.py:233``)."""

    def preempt_after_epoch_1(trainer, epoch, model, row):
        if epoch == 1:
            os.kill(os.getpid(), signal.SIGTERM)

    trainer = _trainer(data_dir, tmp_path / "run", callbacks=[preempt_after_epoch_1],
                       max_epochs=50, checkpoint_every_n_epochs=1000)
    out = trainer.fit()
    assert out["preempted"] and len(out["history"]) == 2
    assert trainer.ckpt.exists("last") and not trainer.ckpt.aux("last").get("mid_epoch")
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL
    out2 = _trainer(data_dir, tmp_path / "run", max_epochs=4).fit(resume=True)
    assert [r["epoch"] for r in out2["history"]] == [2, 3] and not out2["preempted"]
    assert out2["global_step"] == 4 * 5


@pytest.mark.parametrize("family,noise_std", [("mrssm", 0.1), ("mrssm", 0.0),
                                             ("mmtrssm", 0.1)])
def test_mid_epoch_resume_is_bit_identical(tmp_path, data_dir, reference, family, noise_std):
    """SIGTERM after the 7th step (mid epoch 1) of a fit on the per-batch
    path (K=1: SIGTERM is polled after every step; a preemption inside a
    K-step chunk is ``test_torch_port_kstep.py``'s): a fresh trainer's
    ``resume=True`` finishes the run with the weights of the uninterrupted
    fit bit for bit, and its epoch row's ``train/loss`` within rtol 1e-6
    (JAX ``tests/test_trainer.py:487``). With noise the skipped batches
    still draw theirs; without, they are dropped at the index level."""
    ref_trainer, ref = reference(family, noise_std=noise_std)
    trainer = _trainer(data_dir, tmp_path / "int", family, noise_std=noise_std,
                       steps_per_dispatch=1)
    with _sigterm_after(7):
        out = trainer.fit()
    assert out["preempted"] and [r["epoch"] for r in out["history"]] == [0]
    aux = trainer.ckpt.aux("last")
    assert aux["mid_epoch"] and aux["epoch"] == 1
    assert aux["items_done"] == 2 and aux["global_step"] == 7
    resumed_trainer = _trainer(data_dir, tmp_path / "int", family, noise_std=noise_std,
                               steps_per_dispatch=1)
    res = resumed_trainer.fit(resume=True)
    assert [r["epoch"] for r in res["history"]] == [1] and not res["preempted"]
    assert _same_weights(resumed_trainer.model, ref_trainer.model)
    assert res["global_step"] == ref["global_step"] == 10
    np.testing.assert_allclose(res["history"][0]["train/loss"], ref["history"][1]["train/loss"],
                               rtol=1e-6)
    assert _rows(res)[0] == _rows(ref)[1]


def test_fit_at_k4_is_bit_identical_to_k1(tmp_path, data_dir, reference):
    """An integer ``steps_per_dispatch`` trains batch by batch: the fit at
    K=4 is the K=1 fit, weights and epoch rows bit for bit (JAX
    ``tests/test_trainer.py:391`` within rtol 1e-4)."""
    a, out_a = reference("mrssm", noise_std=0.1)
    b = _trainer(data_dir, tmp_path / "k4", steps_per_dispatch=4)
    out_b = b.fit()
    assert _same_weights(a.model, b.model)
    assert _rows(out_a) == _rows(out_b) and out_a["global_step"] == out_b["global_step"] == 10


@pytest.mark.parametrize("noise_std", [0.1, 0.0])
def test_skip_serves_the_rest_of_the_epoch(data_dir, noise_std):
    """``train_batches(skip=3)`` serves the epoch's batches after the
    third with their noise, whether the skipped batches draw noise (0.1)
    or are dropped at the index level (0.0)."""
    dm = _dm(data_dir, noise_std=noise_std)
    whole, got = list(dm.train_batches(2)), list(dm.train_batches(2, skip=3))
    assert len(whole) == 5 and len(got) == 2
    assert all(torch.equal(x, y) for a, b in zip(got, whole[3:]) for x, y in zip(a, b))


# ---- gradient accumulation ----------------------------------------------------------


def test_accumulation_steps_on_the_mean_gradient(data_dir, reference):
    """``accumulate_grad_batches=2`` over 5 batches an epoch: two windows
    of 2 and the leftover window of 1, each one AdamW step on the mean of
    its batches' gradients, replayed here with ``torch.autograd.grad``
    batch by batch over both epochs (the trainer's noise: ``fold(fold(seed,
    epoch), step)``): the same weights bit for bit; ``global_step`` counts
    batches."""
    trainer, out = reference("mrssm", accumulate_grad_batches=2)
    assert out["global_step"] == 10 and trainer.ckpt.aux("last")["global_step"] == 10
    assert out["opt_state"]["count"] == 6
    model = _model().init(torch.Generator().manual_seed(7))
    opt = optim.AdamW(model.parameters(), 3e-4)
    params = list(model.parameters())
    gen, step = torch.Generator(), 0
    for epoch in (0, 1):
        seed, batches = fold(7, epoch), list(_dm(data_dir).train_batches(epoch))
        for window in (batches[:2], batches[2:4], batches[4:]):
            total = None
            for batch in window:
                gen.manual_seed(fold(seed, step))
                grads = torch.autograd.grad(model.shared_step(batch, generator=gen)["loss"],
                                            params)
                total = list(grads) if total is None else [t + g for t, g in zip(total, grads)]
                step += 1
            for p, g in zip(params, total):
                p.grad = g / float(len(window))
            opt.step()
    assert _same_weights(model, trainer.model)


def test_mid_window_preemption_replays_the_window(tmp_path, data_dir, reference):
    """SIGTERM after the 3rd batch of accumulation windows of 2 (mid
    window): the checkpoint holds the state after the 1st window, the
    resumed fit replays the 2nd window's batches, and the weights equal the
    uninterrupted fit's bit for bit."""
    ref_trainer, _ = reference("mrssm", accumulate_grad_batches=2)
    trainer = _trainer(data_dir, tmp_path / "int", accumulate_grad_batches=2)
    with _sigterm_after(3, "make_grad_step"):
        assert trainer.fit()["preempted"]
    aux = trainer.ckpt.aux("last")
    assert aux["mid_epoch"] and aux["items_done"] == 2 and aux["global_step"] == 2
    resumed = _trainer(data_dir, tmp_path / "int", accumulate_grad_batches=2)
    resumed.fit(resume=True)
    assert _same_weights(resumed.model, ref_trainer.model)


def test_changed_accumulation_refuses_a_mid_epoch_resume(tmp_path, data_dir):
    with _sigterm_after(2, "make_grad_step"):
        assert _trainer(data_dir, tmp_path / "run", accumulate_grad_batches=2).fit()["preempted"]
    with pytest.raises(ValueError, match="accumulate_grad_batches=2"):
        _trainer(data_dir, tmp_path / "run").fit(resume=True)


# ---- resume_from, diverged -----------------------------------------------------------


def test_resume_from_best_warm_starts_at_epoch_0(tmp_path, data_dir, reference, capsys):
    """``resume_from`` a run's weights-only ``best`` starts this run at
    epoch 0 from those weights with a fresh optimizer (JAX
    ``tests/test_trainer.py:537``); a checkpoints directory resumes its
    full ``last`` exactly."""
    a, ref = reference("mrssm", noise_std=0.1)
    best = a.ckpt.dir / "best.ckpt"
    b = _trainer(data_dir, tmp_path / "b", max_epochs=1)
    out = b.fit(resume_from=best)
    assert out["history"][0]["epoch"] == 0 and out["opt_state"]["count"] == 5
    assert "warm start: weights from" in capsys.readouterr().out
    assert out["history"][0]["train/loss"] != ref["history"][0]["train/loss"]  # not fresh
    c = _trainer(data_dir, tmp_path / "d", max_epochs=3)
    out = c.fit(resume_from=a.ckpt.dir)
    assert [r["epoch"] for r in out["history"]] == [2] and out["opt_state"]["count"] == 15
    with pytest.raises(FileNotFoundError):
        c.fit(resume_from=tmp_path / "nowhere")


def test_resume_from_an_incompatible_full_checkpoint_warm_starts(tmp_path, data_dir, capsys):
    """A full checkpoint whose optimizer state does not fit this model
    warm-starts from its weights, printing why (JAX
    ``tests/test_trainer.py:370``); ``resume=True`` alone raises instead."""
    model = _model().init(torch.Generator().manual_seed(1))
    mgr = CheckpointManager(tmp_path / "foreign")
    mgr.save("last", model, optim.AdamW([torch.zeros(3)]),
             {"epoch": 3, "scheduler": {"kind": "plateau", "base_lr": 1e-3}})
    trainer = _trainer(data_dir, tmp_path / "run", max_epochs=1)
    out = trainer.fit(resume_from=tmp_path / "foreign")
    said = capsys.readouterr().out
    assert out["history"][0]["epoch"] == 0
    assert "full-state restore failed (ValueError:" in said and "warm start" in said
    (tmp_path / "run" / "checkpoints").mkdir(exist_ok=True)
    for f in ("last.ckpt", "last.json"):
        (tmp_path / "run" / "checkpoints" / f).write_bytes((tmp_path / "foreign" / f).read_bytes())
    with pytest.raises(ValueError, match="entries"):
        trainer.fit(resume=True)


def test_diverged_resumes(tmp_path, data_dir):
    """A diverging run (LR 1e18) halts with ``diverged``, whose aux is
    ``last``'s shape, and ``resume_from`` it resumes at the next epoch."""
    trainer = _trainer(data_dir, tmp_path / "run", max_epochs=5, learning_rate=1e18)
    out = trainer.fit()
    assert len(out["history"]) < 5 and trainer.ckpt.exists("diverged")
    aux = trainer.ckpt.aux("diverged")
    assert aux["non_finite"] and aux["global_step"] > 0
    assert {"seed_base", "scheduler", "early_stop", "best_val"} <= set(aux)
    out2 = _trainer(data_dir, tmp_path / "run2", max_epochs=aux["epoch"] + 2).fit(
        resume_from=tmp_path / "run" / "checkpoints" / "diverged")
    assert out2["history"][0]["epoch"] == aux["epoch"] + 1
    assert out2["global_step"] == aux["global_step"] + 5


# ---- profiling, callbacks, charts ----------------------------------------------------


def test_profile_epoch_writes_a_trace(tmp_path, data_dir):
    _trainer(data_dir, tmp_path / "run", max_epochs=1, profile_epoch=0).fit()
    trace = tmp_path / "run" / "profile" / "epoch_0.trace.json"
    with open(trace) as f:
        assert f.read(4096).lstrip().startswith("{") and trace.stat().st_size > 1000


def test_callbacks_see_each_epoch_and_the_best_weights(tmp_path, data_dir):
    """``cb(trainer, epoch, model, row)`` after each epoch and
    ``on_train_end(trainer, best_model)`` with the ``best`` weights, after
    an early stop too; ``load_best_params`` falls back to the model."""
    seen = {}

    class Recorder:
        def __call__(self, trainer, epoch, model, row):
            seen.setdefault("epochs", []).append((epoch, row["epoch"], model is trainer.model))
            if row["val/loss"] <= trainer.ckpt.aux("best")["val_loss"]:
                seen["best"] = {k: v.clone() for k, v in model.state_dict().items()}

        def on_train_end(self, trainer, best_model):
            seen["end"] = best_model

    trainer = _trainer(data_dir, tmp_path / "run", max_epochs=6, early_stop_patience=1,
                       learning_rate=0.5, callbacks=[Recorder()])
    out = trainer.fit()
    assert [e for e, _, _ in seen["epochs"]] == [r["epoch"] for r in out["history"]]
    assert all(a == b and same for a, b, same in seen["epochs"])
    assert len(out["history"]) < 6  # stopped early
    end = seen["end"]
    assert end is not trainer.model
    assert all(torch.equal(v, seen["best"][k]) for k, v in end.state_dict().items())
    empty = Trainer(trainer.model, trainer.dm, TrainerConfig(log_dir=str(tmp_path / "none")))
    assert empty.load_best_params(trainer.model) is trainer.model


def test_charts_match_jax(tmp_path, data_dir):
    """The charts the port draws from a fit's metrics JSONL, pixel for
    pixel the JAX package's ``render_combined_charts`` on the same file;
    each chart's path is recorded in the JSONL."""
    import matplotlib.image as mpimg

    from multimodal_mtrssm_tpu.viz.charts import render_combined_charts as jax_render
    from multimodal_mtrssm_tpu_torch.viz.charts import render_combined_charts

    _trainer(data_dir, tmp_path / "run", family="mmtrssm").fit()
    metrics = tmp_path / "run" / "metrics.jsonl"
    rows = [json.loads(line) for line in metrics.read_text().splitlines()]
    logged = sorted(r["path"] for r in rows if "image" in r)
    ours = render_combined_charts(metrics, tmp_path / "ours")
    theirs = jax_render(metrics, tmp_path / "theirs")
    assert [p.name for p in ours] == [p.name for p in theirs]
    assert {"loss.png", "kl.png", "kl_h.png"} <= {p.name for p in ours}
    assert logged == sorted(str(tmp_path / "run" / "charts" / p.name) for p in ours)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(mpimg.imread(a), mpimg.imread(b), err_msg=a.name)


def test_a_chart_that_cannot_be_drawn_never_fails_a_run(tmp_path, data_dir, monkeypatch, capsys):
    import multimodal_mtrssm_tpu_torch.viz.charts as charts

    def no_matplotlib(*a, **k):
        raise ModuleNotFoundError("No module named 'matplotlib'")

    monkeypatch.setattr(charts, "render_combined_charts", no_matplotlib)
    out = _trainer(data_dir, tmp_path / "run", max_epochs=1).fit()
    assert len(out["history"]) == 1
    assert "charts: none drawn (ModuleNotFoundError" in capsys.readouterr().out
