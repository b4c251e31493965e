"""K-step dispatch on the CPU: the chunked streams, the chunk steps, the
trainer at K > 1, the graph-safe AdamW, the device-resident dataset and the
prefetch thread, each held to the JAX package where it has a counterpart
(no JAX fit runs here: JAX's pipeline, ``_resolve_spd`` and optimizer only).

Tolerances: none. Chunked items equal JAX's chunked items exactly (both
pipelines' noise from the native library); every fit at K > 1, and a device-resident fit at noise
0, equals the K=1 host fit bit for bit (weights, epoch rows, global step);
the AdamW equals its former out-of-place form bit for bit. On the CPU the
chunk steps are eager loops: the CUDA graph's side is ``gpu``-marked in
``tests/test_torch_port_gpu.py``.
"""

import contextlib
import dataclasses
import os
import signal
import threading
import types
import warnings

import numpy as np
import pytest
import torch

from multimodal_mtrssm_tpu.data import pipeline as jax_pipeline
from multimodal_mtrssm_tpu.data.pack import pack_episodes
from multimodal_mtrssm_tpu.train import trainer as jax_trainer
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
from multimodal_mtrssm_tpu_torch.train.steps import (
    VAL,
    accumulate_metrics,
    make_train_chunk,
    make_train_step,
    make_val_chunk,
)
from multimodal_mtrssm_tpu_torch.train.trainer import Trainer, TrainerConfig
from _port_native import jax_native as jax_native  # noqa: F401 (a fixture)
from _port_threads import _one_intra_op_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _no_charts(monkeypatch):
    """Fits draw no charts here (0.6 s a fit)."""
    import multimodal_mtrssm_tpu_torch.viz.charts as charts

    monkeypatch.setattr(charts, "render_combined_charts", lambda *a, **k: [])


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """12 episodes: at train_ratio 0.6, 7 train (3 batches of 2 and a tail
    of 1) and 5 val (2 batches of 2 and a tail of 1)."""
    d = tmp_path_factory.mktemp("episodes")
    episodes.generate_synthetic_audio_mnist(d, n_episodes=12, episode_length=6, seed=3)
    return d


def _kw(data_dir, **kw):
    return {"data_dir": str(data_dir), "batch_size": 2, "sequence_length": 3, "seed": 5,
            "train_ratio": 0.6, **kw}


def _dm(data_dir, **kw):
    return pipeline.EpisodeDataModule(pipeline.DataModuleConfig(**_kw(data_dir, **kw)))


def _jax_dm(data_dir, tmp_path, **kw):
    return jax_pipeline.EpisodeDataModule(jax_pipeline.DataModuleConfig(
        common_processed_dir=str(tmp_path / "none"), **_kw(data_dir, **kw)))


def _same_items(ours, theirs) -> None:
    assert [k for k, _ in ours] == [k for k, _ in theirs]
    for (_, a), (_, b) in zip(ours, theirs):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def _unchunk(items) -> list[tuple[torch.Tensor, ...]]:
    """The batches of chunked items, in order."""
    return [b2 for kind, b in items
            for b2 in ([tuple(x[i] for x in b) for i in range(b[0].shape[0])]
                       if kind == "scan" else [b])]


def _cfg(family: str = "mrssm", **kw):
    from conftest import small_encoder_config

    enc = EncoderConfig(**dataclasses.asdict(small_encoder_config()))
    cls = MMTRSSMConfig if family == "mmtrssm" else MRSSMConfig
    return cls(audio_encoder=enc, vision_encoder=enc, init_proj_cells=32, **kw)


def _model(family: str = "mrssm"):
    return (MoPoEMMTRSSM if family == "mmtrssm" else MoPoEMRSSM)(_cfg(family))


def _trainer(data_dir, log_dir, family="mrssm", data=None, **kw):
    kw = {"max_epochs": 2, "learning_rate": 3e-4, "seed": 7, **kw}
    return Trainer(_model(family), _dm(data_dir, **(data or {})),
                   TrainerConfig(log_dir=str(log_dir), **kw))


def _rows(out):
    return [{k: v for k, v in r.items() if k != "seq_per_sec"} for r in out["history"]]


def _same_fit(a, out_a, b, out_b) -> bool:
    return (all(torch.equal(x, y) for x, y in zip(a.model.state_dict().values(),
                                                  b.model.state_dict().values()))
            and _rows(out_a) == _rows(out_b) and out_a["global_step"] == out_b["global_step"])


@pytest.fixture(scope="module")
def k1_fit(tmp_path_factory, data_dir):
    """``k1_fit(family, **data)``: the K=1 host fit, made once a key."""
    done = {}

    def fit(family="mrssm", **data):
        key = (family, tuple(sorted(data.items())))
        if key not in done:
            t = _trainer(data_dir, tmp_path_factory.mktemp("k1"), family, data,
                         steps_per_dispatch=1)
            done[key] = (t, t.fit())
        return done[key]

    return fit


# ---- the chunked streams --------------------------------------------------------------


@pytest.mark.parametrize("k,skip_items", [(2, 0), (2, 1), (3, 1), (5, 0)])
def test_chunked_train_items_equal_jax(data_dir, tmp_path, jax_native, k, skip_items):
    """Kinds, shapes and values of ``train_batches_chunked`` equal JAX's on
    the same data and noise (0.1, both from the native library), ragged
    tails included; ``skip`` counts batches here and items in JAX, so the
    port skips the batches of JAX's first items."""
    ours, theirs = _dm(data_dir, noise_std=0.1), _jax_dm(data_dir, tmp_path, noise_std=0.1)
    full = list(theirs.train_batches_chunked(1, k))
    skip = sum(np.asarray(b[0]).shape[0] if kind == "scan" else 1
               for kind, b in full[:skip_items])
    got = list(ours.train_batches_chunked(1, k, skip=skip))
    _same_items(got, list(theirs.train_batches_chunked(1, k, skip=skip_items)))
    if not skip_items:
        assert got[0][1][0].shape[:2] == ((k, 2) if k <= 3 else (2, 3))
    assert got[-1][0] == "step" and got[-1][1][0].shape[0] == 1  # the ragged tail


@pytest.mark.parametrize("noise_std", [0.1, 0.0])
def test_chunked_items_regroup_the_flat_stream(data_dir, noise_std):
    """The flat stream's batches, bit for bit, in every item; a ``skip`` that
    ends inside JAX's first chunk regroups the rest from there."""
    dm = _dm(data_dir, noise_std=noise_std)
    flat = list(dm.train_batches(0))
    for k, skip in ((3, 0), (2, 1), (3, 2)):
        items = list(dm.train_batches_chunked(0, k, skip=skip))
        batches = _unchunk(items)
        assert len(batches) == len(flat) - skip
        for got, want in zip(batches, flat[skip:]):
            assert all(torch.equal(x, y) for x, y in zip(got, want))
        assert items[0][0] == ("scan" if len(flat) - skip - 1 >= k else "step")


def test_val_chunked_clamps_k_to_full_batches(data_dir, tmp_path, jax_native):
    """k is clamped to the validation split's full batches, and the items
    equal JAX's (JAX ``tests/test_data_pipeline.py:198``)."""
    ours, theirs = _dm(data_dir, noise_std=0.1), _jax_dm(data_dir, tmp_path, noise_std=0.1)
    got = list(ours.val_batches_chunked(256))
    assert [k for k, _ in got] == ["scan", "step"] and got[0][1][0].shape[:2] == (2, 2)
    _same_items(got, list(theirs.val_batches_chunked(256)))
    flat = list(ours.val_batches())
    assert all(torch.equal(x[1], y) for x, y in zip(got[0][1], flat[1]))


@pytest.mark.parametrize("spd,nbytes", [("auto", None), ("auto", 2**28), ("auto", 2**31),
                                        (3, None), (1, None)])
def test_resolve_spd_equals_jax(data_dir, tmp_path, monkeypatch, spd, nbytes):
    """``_resolve_spd`` equals JAX's: the epoch's full batches, the 1 GB
    budget (a batch of 256 MB: 4; of 2 GB: 1), an integer as given."""
    ours = Trainer(_model(), _dm(data_dir), TrainerConfig(steps_per_dispatch=spd,
                                                          log_dir=str(tmp_path / "run")))
    theirs = _jax_dm(data_dir, tmp_path)
    if nbytes is not None:
        monkeypatch.setattr(ours.dm, "batch_nbytes", lambda bs: nbytes)
        monkeypatch.setattr(theirs, "batch_nbytes", lambda bs: nbytes)
    jcfg = jax_trainer.TrainerConfig(steps_per_dispatch=spd)
    want = jax_trainer.Trainer._resolve_spd(types.SimpleNamespace(cfg=jcfg, dm=theirs))
    assert ours._resolve_spd() == want == {None: 3 if spd == "auto" else spd, 2**28: 3,
                                           2**31: 1}[nbytes]
    assert (trainer_mod.SPD_CHUNK_BUDGET_BYTES, trainer_mod.SPD_MAX_STEPS) == (
        jax_trainer.SPD_CHUNK_BUDGET_BYTES, jax_trainer.SPD_MAX_STEPS)


# ---- the chunk steps ------------------------------------------------------------------


def test_train_chunk_is_k_train_steps(data_dir):
    """``make_train_chunk`` on a [3, B] chunk equals 3 ``make_train_step``
    calls at steps step0 … step0+2: weights, moments and the weighted
    metric sums bit for bit; ``make_val_chunk`` likewise the validation
    steps' sums."""
    kind, chunk = next(_dm(data_dir, noise_std=0.1).train_batches_chunked(0, 3))
    assert kind == "scan"
    a, b = _model().init(torch.Generator().manual_seed(1)), _model()
    b.load_state_dict(a.state_dict())
    opt_a, opt_b = optim.AdamW(a.parameters()), optim.AdamW(b.parameters())
    step = make_train_step(a, opt_a)
    sums_a, sums_b = {}, {}
    for i in range(3):
        accumulate_metrics(sums_a, step(tuple(x[i] for x in chunk), 11, 4 + i), 2)
    make_train_chunk(b, opt_b)(chunk, 11, 4, sums_b)
    assert sums_a.keys() == sums_b.keys() and all(torch.equal(sums_a[k], sums_b[k])
                                                  for k in sums_a)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    assert torch.equal(opt_a.m, opt_b.m) and opt_a.count == opt_b.count == 3
    gen, val_a, val_b = torch.Generator(), {}, {}
    with torch.no_grad():
        for i in range(3):
            gen.manual_seed(trainer_mod.fold(11, VAL, 2 + i))
            accumulate_metrics(val_a, a.shared_step(tuple(x[i] for x in chunk),
                                                    generator=gen), 2)
    make_val_chunk(b)(chunk, 11, 2, val_b)
    assert all(torch.equal(val_a[k], val_b[k]) for k in val_a)


@pytest.mark.parametrize("family", ["mrssm", "mmtrssm"])
@pytest.mark.parametrize("spd", [2, "auto"])
def test_fit_at_k_is_the_k1_fit(tmp_path, data_dir, k1_fit, family, spd):
    """A fit at K=2 (train: a chunk, a leftover batch and the ragged tail;
    validation: a chunk of 2 and its tail) and at K=auto (3: one chunk and
    the tail) equals the K=1 fit bit for bit: weights, epoch rows, global
    step (JAX ``tests/test_trainer.py:391`` holds its own within rtol
    1e-4)."""
    a, out_a = k1_fit(family, noise_std=0.1)
    b = _trainer(data_dir, tmp_path / "k", family, {"noise_std": 0.1}, steps_per_dispatch=spd)
    out_b = b.fit()
    assert b.chunk_steps is not None and b._resolve_spd() == (2 if spd == 2 else 3)
    assert _same_fit(a, out_a, b, out_b) and out_b["global_step"] == 8
    assert out_b["opt_state"]["count"] == 8


@contextlib.contextmanager
def _sigterm_after(n: int):
    """SIGTERM this process right after the n-th train step (the CPU's
    chunk steps call the trainer's train step for each batch)."""
    real = trainer_mod.make_train_step

    def make(*args):
        step, calls = real(*args), [0]

        def wrapped(*a):
            out = step(*a)
            calls[0] += 1
            if calls[0] == n:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return wrapped

    trainer_mod.make_train_step = make
    try:
        yield
    finally:
        trainer_mod.make_train_step = real


def test_preemption_inside_a_chunk_resumes_bit_for_bit(tmp_path, data_dir, k1_fit):
    """SIGTERM after step 5, the second of epoch 1's chunk of 3 (K=auto): the
    chunk completes, the mid-epoch ``last`` records 3 batches and K; a fresh
    trainer's ``resume=True`` ends equal to the uninterrupted fit bit for
    bit (JAX ``tests/test_trainer.py:597``)."""
    ref, out_ref = k1_fit("mrssm", noise_std=0.1)
    trainer = _trainer(data_dir, tmp_path / "run", data={"noise_std": 0.1})
    with _sigterm_after(6):
        out = trainer.fit()
    aux = trainer.ckpt.aux("last")
    assert out["preempted"] and aux["mid_epoch"] and aux["epoch"] == 1
    assert (aux["items_done"], aux["global_step"], aux["spd"]) == (3, 7, 3)
    resumed = _trainer(data_dir, tmp_path / "run", data={"noise_std": 0.1})
    res = resumed.fit(resume=True)
    assert [r["epoch"] for r in res["history"]] == [1] and res["global_step"] == 8
    assert all(torch.equal(x, y) for x, y in zip(resumed.model.state_dict().values(),
                                                 ref.model.state_dict().values()))
    assert _rows(res)[0]["val/loss"] == _rows(out_ref)[1]["val/loss"]


# ---- the graph-safe AdamW ----------------------------------------------------------------


class _OutOfPlaceAdamW:
    """The AdamW step as the port wrote it before it was made graph-safe:
    scalars made from host numbers each step, the moments rebound."""

    def __init__(self, params, lr, grad_clip=10.0, weight_decay=0.01, b1=0.9, b2=0.999,
                 eps=1e-8):
        self.params, self.lr, self.grad_clip, self.weight_decay = list(params), lr, grad_clip, \
            weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        n = sum(p.numel() for p in self.params)
        self.m, self.v, self.count = torch.zeros(n), torch.zeros(n), 0

    @torch.no_grad()
    def step(self):
        g = torch.cat([p.grad.reshape(-1).float() for p in self.params])
        p = torch.cat([p.reshape(-1) for p in self.params])
        f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
        norm = torch.sqrt(torch.sum(g * g))
        g = g * torch.clamp(f32(self.grad_clip) / (norm + 1e-12), max=1.0)
        self.count += 1
        b1, b2, t = f32(self.b1), f32(self.b2), f32(self.count)
        self.m = b1 * self.m + f32(1.0 - self.b1) * g
        self.v = b2 * self.v + f32(1.0 - self.b2) * g * g
        mh, vh = self.m / (1.0 - b1 ** t), self.v / (1.0 - b2 ** t)
        step = -f32(self.lr) * (mh / (torch.sqrt(vh) + self.eps) + self.weight_decay * p)
        torch._foreach_add_(self.params, [s.view_as(q) for s, q in zip(
            step.split([q.numel() for q in self.params]), self.params)])


def test_graph_safe_adamw_equals_its_former_form():
    """8 steps with the clip biting, the learning rate changed twice and a
    ``load_state_dict`` of the former form's state after step 4: parameters,
    moments, count and learning rate bit for bit; the moments are updated in
    place (a graph reads them where it captured them) and the device mirrors
    follow ``lr`` and ``count``. The match with JAX's ``FusedAdamW`` is
    ``test_torch_port_trainer.py::test_adamw_matches_jax_fused_adamw``."""
    rng = np.random.default_rng(2)
    shapes = [(4, 3), (3,), (2, 2, 2)]
    init = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    ours = [torch.tensor(x) for x in init]
    theirs = [torch.tensor(x) for x in init]
    opt = optim.AdamW(ours, 1e-2, weight_decay=0.1)
    old = _OutOfPlaceAdamW(theirs, 1e-2, weight_decay=0.1)
    m_ptr = opt.m.data_ptr()
    for i in range(8):
        grads = [rng.standard_normal(s).astype(np.float32) * (40.0 if i == 1 else 0.7)
                 for s in shapes]
        if i in (3, 6):
            optim.set_learning_rate(opt, old.lr * 0.37)
            old.lr *= 0.37
        if i == 4:
            opt = optim.AdamW(ours, 5.0, weight_decay=0.1).load_state_dict(
                {"m": old.m.clone(), "v": old.v.clone(), "count": old.count, "lr": old.lr})
            m_ptr = opt.m.data_ptr()
        for p, q, g in zip(ours, theirs, grads):
            p.grad, q.grad = torch.from_numpy(g), torch.from_numpy(g.copy())
        opt.step()
        old.step()
        assert all(torch.equal(p, q) for p, q in zip(ours, theirs)), f"step {i}"
        assert torch.equal(opt.m, old.m) and torch.equal(opt.v, old.v)
        assert opt.m.data_ptr() == m_ptr
        assert (opt.count, int(opt._n), opt.lr, float(opt._lr)) == (
            old.count, old.count, old.lr, float(torch.tensor(old.lr, dtype=torch.float32)))
    state = opt.state_dict()
    assert state["count"] == 8 and state["m"].data_ptr() != opt.m.data_ptr()


# ---- the device-resident dataset ----------------------------------------------------------


@pytest.mark.parametrize("drop", [None, "audio"])
def test_device_resident_items_equal_jax(data_dir, tmp_path, drop):
    """At noise 0 the device-resident items (here on the CPU) equal JAX's
    device-resident chunks, train (with a skip) and validation, and the
    host stream's."""
    ours = _dm(data_dir, noise_std=0.0, device_resident=True, drop_modality=drop)
    theirs = _jax_dm(data_dir, tmp_path, noise_std=0.0, device_resident=True, drop_modality=drop)
    host = _dm(data_dir, noise_std=0.0, drop_modality=drop)
    assert ours.device_resident_active()
    _same_items(list(ours.train_batches_chunked(0, 2)), list(theirs.train_batches_chunked(0, 2)))
    _same_items(list(ours.train_batches_chunked(1, 2, skip=2)),
                list(theirs.train_batches_chunked(1, 2, skip=1)))
    _same_items(list(ours.val_batches_chunked(4)), list(theirs.val_batches_chunked(4)))
    _same_items(list(ours.train_batches_chunked(1, 3)),
                [(k, tuple(x.numpy() for x in b)) for k, b in host.train_batches_chunked(1, 3)])
    assert ours._dev_data is not None and host._dev_data is None


def test_device_resident_fit_is_the_host_fit(tmp_path, data_dir, k1_fit):
    """At noise 0 a device-resident fit at K=auto (and at K=1, whose flat
    streams are gathered from the resident streams too) equals the
    host-streamed K=1 fit bit for bit (JAX ``tests/test_trainer.py:575``)."""
    a, out_a = k1_fit("mrssm", noise_std=0.0)
    for spd in ("auto", 1):
        b = _trainer(data_dir, tmp_path / f"dr{spd}", data={"noise_std": 0.0,
                                                            "device_resident": True},
                     steps_per_dispatch=spd)
        out_b = b.fit()
        assert b.dm._dev_data is not None and _same_fit(a, out_a, b, out_b)


def test_device_resident_noise_and_drops(data_dir, tmp_path):
    """Noise 0.1 and ``drop_modality="random"``: the targets stay clean,
    each batch's noise and drops are a function of its index alone (any K,
    any skip), dropped inputs are -1, and validation is noised but never
    dropped. JAX's device path drops validation inputs too (its ROADMAP
    queue-3 fault), which the port does not copy."""
    dm = _dm(data_dir, noise_std=0.1, drop_modality="random", device_resident=True)
    flat = list(dm.train_batches(0))
    for k, skip in ((3, 0), (2, 1)):
        got = _unchunk(dm.train_batches_chunked(0, k, skip=skip))
        assert len(got) == len(flat) - skip
        for g, f in zip(got, flat[skip:]):
            assert all(torch.equal(x, y) for x, y in zip(g, f))
    host = list(_dm(data_dir, noise_std=0.0).train_batches(0))
    dropped = 0
    for b, h in zip(flat, host):
        assert all(torch.equal(x, y) for x, y in zip(b[3:], h[3:]))  # clean targets
        assert not torch.equal(b[0], h[0])  # noised action
        for s in (1, 2):
            dropped += int((b[s] == -1).flatten(1).all(1).sum())
    assert dropped > 0
    val = list(dm.val_batches())
    for b in val:
        assert not torch.equal(b[1], b[4]) and not (b[1] == -1).flatten(1).all(1).any()
        assert not (b[2] == -1).flatten(1).all(1).any()
    theirs = _jax_dm(data_dir, tmp_path, noise_std=0.1, drop_modality="random",
                     device_resident=True)
    jax_val = [np.asarray(x) for _, b in theirs.val_batches_chunked(1) for x in b[1:3]]
    assert any((x == -1).reshape(x.shape[0], -1).all(1).any() for x in jax_val)


def test_device_resident_pack_and_budget_warn(data_dir, tmp_path):
    """A pack, or streams over ``device_resident_max_bytes``, warn once and
    stream from the host (JAX ``tests/test_data_pipeline.py:329``, ``:349``)."""
    packed = tmp_path / "packed"
    pack_episodes(data_dir, packed / "pack")
    for dm, why in ((_dm(packed, device_resident=True), "pack mode"),
                    (_dm(data_dir, device_resident=True, device_resident_max_bytes=1024),
                     "budget")):
        with warnings.catch_warnings(record=True) as said:
            warnings.simplefilter("always")
            items = list(dm.train_batches_chunked(0, 2))
            list(dm.val_batches())
        assert [why in str(w.message) for w in said] == [True] and dm._dev_data is None
        assert items[0][0] == "scan" and not dm.device_resident_active()


# ---- the prefetch thread ------------------------------------------------------------------


def test_prefetch_propagates_errors_and_stops_on_close():
    """A worker's exception reaches the consumer after the items before
    it; closing the consumer early ends the worker thread."""

    def failing():
        yield 1
        yield 2
        raise ValueError("assembly failed")

    got = []
    with pytest.raises(ValueError, match="assembly failed"):
        for item in pipeline._prefetch_iter(failing()):
            got.append(item)
    assert got == [1, 2]
    before = set(threading.enumerate())
    it = pipeline._prefetch_iter(iter(range(10**9)))
    assert next(it) == 0
    workers = set(threading.enumerate()) - before
    it.close()
    for t in workers:
        t.join(timeout=5)
    assert workers and not any(t.is_alive() for t in workers)
