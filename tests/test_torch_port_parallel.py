"""Data-parallel training on ``torch.distributed`` (``parallel/``, ZeRO-1 in
``train/optim.py``, the data-parallel step, ``Trainer`` across ranks, a
``torchrun`` launch and ``dryrun.py``) against one process and against the
JAX package's mesh, ZeRO-1 and hybrid ``(dcn, data)`` layout.

Ranks are gloo processes on the CPU (``parallel.spawn``: a ``file://``
rendezvous in a temporary directory, no port to collide on, every spawn and
collective under a timeout). Their side is ``tests/_port_dist.py``, which
imports no JAX; the JAX side runs here, on the 8-device CPU mesh that
``conftest.py`` sets up. The 2-, 3- and 4-rank runs are made once, by the
module fixture ``ranks``, three spawns at once; each test reads its part.
"""

import datetime
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import yaml

import _port_dist as side
from multimodal_mtrssm_tpu.models.mrssm import MoPoEMRSSM as JaxMoPoEMRSSM
from multimodal_mtrssm_tpu.models.mrssm import MRSSMConfig as JaxMRSSMConfig
from multimodal_mtrssm_tpu.nn.conv import EncoderConfig as JaxEncoderConfig
from multimodal_mtrssm_tpu.parallel import make_mesh as jax_make_mesh
from multimodal_mtrssm_tpu.parallel import shard_batch
from multimodal_mtrssm_tpu.train import optim as jax_optim
from multimodal_mtrssm_tpu.train.torch_export import export_reference_state_dict
from multimodal_mtrssm_tpu_torch.data import generate_synthetic_audio_mnist
from multimodal_mtrssm_tpu_torch.parallel import mesh as pmesh
from multimodal_mtrssm_tpu_torch.parallel.spawn import spawn
from test_torch_port_train import _batch as elbo_batch
from test_torch_port_train import _jax_elbo_grad
from _port_threads import _one_intra_op_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
LR = side.LR
# (family, world, global batch): even batches, a ragged 5 at W=2 (3 + 2
# rows) and a ragged 3 at W=4 (rank 3 holds no rows).
STEP_CASES = [("mrssm", 2, 4), ("mmtrssm", 2, 4), ("weighted", 2, 4), ("mrssm", 2, 5),
              ("mrssm", 4, 3)]
SPAWN_TIMEOUT_S, GROUP_TIMEOUT_S = 240, 120
# Where a SIGTERM lands late in an epoch, on rank 0 alone (_port_dist.late_sigterm_task).
LATE_SIGTERM = ("blocked_poll", "after_last_poll")


def _flat(named: dict, order: list[str]) -> np.ndarray:
    return np.concatenate([named[k].reshape(-1) for k in order])


@pytest.fixture(scope="module")
def inputs():
    """The small MRSSM of ``test_torch_port_train.py`` in both packages on
    the port's seed-0 weights (no JAX init compile: ``export``'s relayout
    is inverted once, as ``_port_models.params_from_port`` does), a 4-row
    batch with numpy Gumbel noise, and ``tests/test_zero1.py``'s fixed
    gradient and moment patterns (by position in JAX's flat vector)."""
    enc = JaxEncoderConfig(**side.ENC)
    jmodel = JaxMoPoEMRSSM(JaxMRSSMConfig(audio_encoder=enc, vision_encoder=enc,
                                          init_proj_cells=32, use_pallas_train="reference"))
    port = side.small_model("mrssm", 0.0)
    leaves, tree = jax.tree_util.tree_flatten(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0)))
    sizes = [int(np.prod(x.shape)) for x in leaves]
    cuts = np.cumsum(sizes)[:-1]
    ids = np.arange(sum(sizes), dtype=np.float64)
    tagged = jax.tree_util.tree_unflatten(tree, [
        part.reshape(x.shape) for part, x in zip(np.split(ids, cuts), leaves)])
    where = {k: np.asarray(v, np.float64).astype(np.int64)
             for k, v in export_reference_state_dict(tagged).items()}
    to_port = lambda flat: {k: flat[i] for k, i in where.items()}  # noqa: E731
    flat = np.zeros(ids.shape, np.float32)
    for name, t in port.state_dict().items():
        flat[where[name].ravel()] = t.numpy().ravel()
    pos = np.arange(ids.size, dtype=np.float32)
    patterns = {"g": (np.sin(0.1 * pos) * 0.01).astype(np.float32),
                "m": (np.sin(0.01 * pos) * 1e-3).astype(np.float32),
                "v": (1e-6 + 1e-4 * np.cos(0.02 * pos) ** 2).astype(np.float32)}
    batch, noise = elbo_batch(31, B=4)
    order = [n for n, _ in port.named_parameters()]
    return {"jmodel": jmodel,
            "tree": lambda f: jax.tree_util.tree_unflatten(tree, [
                jnp.asarray(part.reshape(x.shape)) for part, x in zip(np.split(f, cuts), leaves)]),
            "to_port": to_port, "order": order, "flat": flat, "patterns": patterns,
            "weights": to_port(flat), "batch": batch, "noise": noise,
            "exact": {"weights": to_port(flat), "grad": to_port(patterns["g"]),
                      "m": _flat(to_port(patterns["m"]), order),
                      "v": _flat(to_port(patterns["v"]), order), "count": 3}}


def _np_flat(tree) -> np.ndarray:
    """A JAX tree as one numpy vector in ``ravel_pytree``'s order."""
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


def _jax_references(inputs) -> dict:
    """JAX's side: the ELBO gradient on the 4-row batch sharded over 2
    devices, ``make_optimizer(shard_pad=2)``'s update of it, and the
    fixed-input ZeRO-1 updates at W = 2, 3 and 4 on W-device meshes."""
    params = inputs["tree"](inputs["flat"])
    mesh = jax_make_mesh(jax.devices()[:2])
    grads, ref = _jax_elbo_grad(inputs["jmodel"])(
        params, shard_batch(tuple(map(jnp.asarray, inputs["batch"])), mesh),
        {k: jnp.asarray(v) for k, v in inputs["noise"].items()})
    opt = jax_optim.make_optimizer(LR, shard_pad=2)
    updates, _ = jax.jit(opt.update)(grads, jax_optim.shard_opt_state(opt.init(params), mesh),
                                     params)
    to_port = inputs["to_port"]
    out = {"loss": float(ref["loss"]), "grads": to_port(_np_flat(grads)),
           "after": to_port(inputs["flat"] + _np_flat(updates))}
    pat = inputs["patterns"]
    n = pat["m"].size
    for W in (2, 3, 4):
        opt = jax_optim.make_optimizer(LR, shard_pad=W)
        state = opt.init(params)
        pad = state.m.shape[0]
        state = state._replace(m=jnp.asarray(np.pad(pat["m"], (0, pad - n))),
                               v=jnp.asarray(np.pad(pat["v"], (0, pad - n))),
                               count=jnp.asarray(3, jnp.int32))
        state = jax_optim.shard_opt_state(state, jax_make_mesh(jax.devices()[:W]))
        updates, new = jax.jit(opt.update)(inputs["tree"](pat["g"]), state, params)
        out[W] = {"after": to_port(inputs["flat"] + _np_flat(updates)),
                  "m": to_port(np.asarray(new.m)[:n]), "v": to_port(np.asarray(new.v)[:n])}
    return out


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    path = tmp_path_factory.mktemp("parallel")
    generate_synthetic_audio_mnist(path / "episodes", n_episodes=7, episode_length=12, seed=3)
    return path


@pytest.fixture(scope="module")
def ranks(work, inputs):
    """The 2-, 3- and 4-rank runs, spawned at once, and JAX's references,
    computed meanwhile: ``{W: {"names": task names, "results": [rank 0's
    results, rank 1's, ...]}, "jax": _jax_references(inputs)}``."""
    data = str(work / "episodes")
    exact = ("zero1_exact_task", inputs["exact"])
    tasks = {
        2: [("step_task", dict(family=f, B=B)) for f, W, B in STEP_CASES if W == 2] + [
            ("jax_step_task", dict(weights=inputs["weights"], batch=inputs["batch"],
                                   noise=inputs["noise"])),
            exact,
            ("fit_task", dict(data_dir=data, log_dir=str(work / "fit2"))),
            ("preempt_task", dict(data_dir=data, log_dir=str(work / "cut2"), after=4,
                                  copy_to=str(work / "cut1"))),
            ("resume_task", dict(data_dir=data, log_dir=str(work / "cut2"))),
            ("refusal_task", dict(data_dir=data, log_dir=str(work / "refused"), batch_size=3)),
        ] + [("late_sigterm_task", dict(data_dir=data, log_dir=str(work / when), when=when))
             for when in LATE_SIGTERM],
        3: [exact],
        4: [("step_task", dict(family=f, B=B)) for f, W, B in STEP_CASES if W == 4]
        + [exact, ("hybrid_task", {})],
    }
    out, errors = {}, []

    def run(W):
        try:
            out[W] = spawn("_port_dist:run_tasks", W, "cpu", kwargs={"tasks": tasks[W]},
                           timeout_s=SPAWN_TIMEOUT_S, workdir=work / f"w{W}", paths=(str(TESTS),),
                           group_timeout_s=GROUP_TIMEOUT_S)
        except Exception as exc:  # noqa: BLE001 — re-raised in the test thread
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(W,)) for W in tasks]
    for t in threads:
        t.start()
    try:
        references = _jax_references(inputs)
    finally:
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    runs = {W: {"names": [name for name, _ in t], "results": out[W]} for W, t in tasks.items()}
    return {**runs, "jax": references}


def _task(ranks, W: int, name: str, nth: int = 0) -> list:
    """Every rank's result of the ``nth`` task ``name`` of the W-rank run."""
    idx = [i for i, n in enumerate(ranks[W]["names"]) if n == name][nth]
    return [r[idx] for r in ranks[W]["results"]]


def _scale(x) -> float:
    return max(1.0, float(np.abs(x).max()))


def _assert_weights_close(got: dict, want: dict) -> None:
    """JAX's own bounds for a sharded step against a replicated one
    (``tests/test_zero1.py``): mean |Δ| < 0.1·lr, max |Δ| < 10·lr."""
    diffs = np.concatenate([(got[k] - want[k]).ravel() for k in want])
    assert np.abs(diffs).mean() < 0.1 * LR, np.abs(diffs).mean()
    assert np.abs(diffs).max() < 10 * LR, np.abs(diffs).max()


# ---- the mesh helpers, in one process ---------------------------------------------------------


@pytest.mark.parametrize("W", [1, 2, 4])
@pytest.mark.parametrize("B", [8, 5, 3])
def test_shard_rows_splits_every_row_once(W, B):
    """Each rank's rows of a batch, tensors and arrays alike:
    ``numpy.array_split``'s sizes, in rank order, every row once; at B=3
    W=4 the last rank holds none."""
    x = np.arange(B * 6).reshape(B, 6)
    meshes = [pmesh.Mesh(("data",), (W,), r, tuple(range(W)), None, None) for r in range(W)]
    parts = [pmesh.shard_rows((torch.from_numpy(x), x), m) for m in meshes]
    assert [len(p[0]) for p in parts] == [len(s) for s in np.array_split(x, W)]
    np.testing.assert_array_equal(np.concatenate([p[1] for p in parts]), x)
    assert all(torch.equal(p[0], torch.from_numpy(p[1])) for p in parts)
    if (W, B) == (4, 3):
        assert pmesh.row_range(3, 4, 3) == (3, 3) and parts[3][1].shape == (0, 6)
    np.testing.assert_array_equal(pmesh.shard_rows(x, None), x)


@pytest.mark.parametrize("world,dcn,hosts,groups", [
    (4, 2, None, [[0, 1], [2, 3]]),
    (8, 2, None, [[0, 1, 2, 3], [4, 5, 6, 7]]),
    (8, 4, None, [[0, 1], [2, 3], [4, 5], [6, 7]]),
    (4, None, ["a", "a", "b", "b"], [[0, 1], [2, 3]]),
    (4, None, ["a"] * 4, [[0, 1, 2, 3]]),
    (4, None, ["a", "b", "a", "b"], [[0, 2], [1, 3]]),
])
def test_hybrid_layout_groups(world, dcn, hosts, groups):
    """The ``data`` groups of a ``(dcn, data)`` mesh: ``dcn_size`` rows of
    consecutive ranks as JAX reshapes its devices, or one group a node
    (whichever ranks it holds); one node is a flat mesh
    (``tests/test_parallel.py::test_hybrid_mesh_single_slice_is_flat``)."""
    assert pmesh.hybrid_layout(world, dcn, hosts) == groups


@pytest.mark.parametrize("world,dcn,hosts,match", [
    (4, 3, None, "not divisible by dcn_size=3"),
    (5, None, ["a", "a", "a", "b", "b"], "unequal node sizes"),
    (4, 0, None, "not divisible by dcn_size=0"),
])
def test_hybrid_layout_refusals(world, dcn, hosts, match):
    """JAX's refusals (``parallel/mesh.py:70-80``): unequal slices, and a
    device count that ``dcn_size`` does not divide (0 included)."""
    with pytest.raises(ValueError, match=match):
        pmesh.hybrid_layout(world, dcn, hosts)
    if hosts is not None:
        assert pmesh.node_groups(hosts) == [[r for r, h in enumerate(hosts) if h == name]
                                            for name in dict.fromkeys(hosts)]


@pytest.mark.parametrize("family", ["mrssm", "mmtrssm", "weighted", "rssm"])
def test_world_of_one_is_the_single_process_step(family, tmp_path):
    """On a process group of one rank (gloo here; NCCL on the card), the
    data-parallel step with ZeRO-1 (noise drawn by ``shared_step``'s ``rows``,
    an all-reduce of one) equals the single-process step bit for bit: the
    global draws are ``shared_step``'s own, in its order."""
    alone = side.step_task("cpu", family, B=3)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        grouped = side.step_task("cpu", family, B=3)
    finally:
        dist.destroy_process_group()
    assert grouped["loss"] == alone["loss"]
    for part in ("grads", "weights"):
        for k, v in alone[part].items():
            np.testing.assert_array_equal(grouped[part][k], v, err_msg=f"{part} {k}")


# ---- several ranks against one process and against JAX -----------------------------------------


@pytest.mark.parametrize("family,W,B", STEP_CASES)
def test_step_matches_one_process(ranks, family, W, B):
    """W ranks' train step at the same global batch, weights and ``(seed,
    step)`` as one process's: the loss within 1e-6 relative, the summed
    gradient within 1e-5 × max(1, max|g|), the weights after within JAX's
    bounds; every rank ends with the same weights."""
    nth = [c for c in STEP_CASES if c[1] == W].index((family, W, B))
    got = _task(ranks, W, "step_task", nth)
    ref = side.step_task("cpu", family, B)
    rows = [r["rows"] for r in got]
    assert [hi - lo for lo, hi in rows] == [len(s) for s in np.array_split(np.arange(B), W)]
    np.testing.assert_allclose(got[0]["loss"], ref["loss"], rtol=1e-6)
    scale = max(_scale(g) for g in ref["grads"].values())
    for k, g in ref["grads"].items():
        np.testing.assert_allclose(got[0]["grads"][k], g, rtol=0, atol=1e-5 * scale, err_msg=k)
    _assert_weights_close(got[0]["weights"], ref["weights"])
    for other in got[1:]:
        assert other["loss"] == got[0]["loss"]
        assert all(np.array_equal(other["weights"][k], v) for k, v in got[0]["weights"].items())


def test_two_ranks_match_jax(ranks):
    """2 ranks' ZeRO-1 step against JAX's ELBO gradient on a 2-device mesh
    and ``make_optimizer(shard_pad=2)``'s update, on the same weights
    (``train/weights.py``), batch and numpy noise: the loss within 2e-5, the
    gradient within 3e-4 × scale (``test_torch_port_train.py``'s bounds),
    the weights after within JAX's zero1 bounds."""
    got = _task(ranks, 2, "jax_step_task")[0]
    ref = ranks["jax"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=2e-5)
    want = ref["grads"]
    assert set(got["grads"]) == set(want)
    scale = max(_scale(g) for g in want.values())
    for k, g in want.items():
        np.testing.assert_allclose(got["grads"][k], g, rtol=0, atol=3e-4 * scale, err_msg=k)
    _assert_weights_close(got["weights"], ref["after"])


@pytest.mark.parametrize("W", [2, 3, 4])
def test_zero1_update_vector_exact(ranks, inputs, W):
    """One ZeRO-1 update on a fixed gradient and distinct moment patterns
    (count 3), W ranks each holding a slice of the padded moments (the
    small model's 1,194,258 parameters leave a pad of 2 at W=4), against
    the replicated ``AdamW`` and JAX's sharded update, rtol 1e-6
    (``tests/test_zero1.py:78-126``; the moments against JAX's also within
    1e-6 of their scale)."""
    got = _task(ranks, W, "zero1_exact_task")
    replicated = side.zero1_exact_task("cpu", **inputs["exact"])
    want, order = ranks["jax"][W], inputs["order"]
    n = inputs["flat"].size
    shard = -(-n // W)
    assert [r["shard"] for r in got] == [(i * shard, shard) for i in range(W)]
    assert (shard * W - n > 0) == (W == 4)
    for r in got:
        for k, v in replicated["weights"].items():
            np.testing.assert_allclose(r["weights"][k], v, rtol=1e-6, atol=1e-10, err_msg=k)
            np.testing.assert_allclose(r["weights"][k], want["after"][k], rtol=1e-6, atol=1e-10,
                                       err_msg=k)
        np.testing.assert_allclose(r["m"], replicated["m"], rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(r["v"], replicated["v"], rtol=1e-6, atol=1e-15)
        # Against JAX, whose XLA fuses b·m + (1 - b)·g into one multiply-add:
        # where the two terms cancel the roundings differ by under one ulp of
        # the terms, so the bound is 1e-6 of the vector's scale.
        for k in ("m", "v"):
            ref = _flat(want[k], order)
            np.testing.assert_allclose(r[k], ref, rtol=1e-6, atol=1e-6 * float(np.abs(ref).max()),
                                       err_msg=k)


def test_hybrid_mesh_matches_flat(ranks):
    """4 ranks at ``dcn_size=2``: ``data`` groups {0, 1} and {2, 3}, the
    moments sharded over the group (half the vector a rank, against a
    quarter on the flat mesh), the loss equal to the flat ZeRO-1 step's
    within rtol 1e-4 (``__graft_entry__.py:220-227``) and the weights
    within JAX's hybrid bound (``tests/test_parallel.py``: 5e-5)."""
    got = _task(ranks, 4, "hybrid_task")
    for rank, r in enumerate(got):
        assert r["layout"] == ({"dcn": 2, "data": 2}, (0, 1) if rank < 2 else (2, 3))
        lo, shard, n = r["hybrid_shard"]
        assert shard == -(-n // 2) and lo == (rank % 2) * shard
        assert r["flat_shard"] == (rank * -(-n // 4), -(-n // 4), n)
        np.testing.assert_allclose(r["hybrid"], r["flat"], rtol=1e-4)
        for k, v in r["flat_weights"].items():
            np.testing.assert_allclose(r["hybrid_weights"][k], v, rtol=0, atol=5e-5, err_msg=k)


# ---- Trainer.fit across ranks -----------------------------------------------------------------


def test_fit_matches_one_process(ranks, work):
    """``Trainer.fit`` at 2 ranks with ``zero1``, 2 epochs × 3 steps (the
    epoch's tail of 1 row leaves rank 1 none): its history equals the
    one-process fit's within 1e-5 relative, every rank holds the same
    history and weights, and only rank 0 writes under its ``log_dir``."""
    got = _task(ranks, 2, "fit_task")
    ref = side.fit_task("cpu", str(work / "episodes"), str(work / "fit1"))
    assert [r["global_step"] for r in got] == [6, 6] and got[0]["count"] == 6
    for row, want in zip(got[0]["history"], ref["history"], strict=True):
        for k, v in want.items():
            if k.startswith(("train/", "val/")) or k in ("epoch", "lr"):
                np.testing.assert_allclose(row[k], v, rtol=1e-5, err_msg=k)
    for k, v in got[0]["weights"].items():
        assert np.array_equal(got[1]["weights"][k], v), k
    _assert_weights_close(got[0]["weights"], ref["weights"])
    assert not (work / "fit2-rank1").exists()
    run = work / "fit2"
    assert (run / "metrics.jsonl").is_file()
    assert {p.name for p in (run / "checkpoints").iterdir()} >= {"best.ckpt", "last.ckpt"}


def test_preemption_on_one_rank_stops_every_rank(ranks):
    """A SIGTERM to rank 1 after its 4th step (epoch 1's first) stops both
    ranks after that same step, with a mid-epoch ``last``."""
    got = _task(ranks, 2, "preempt_task")
    assert [r["preempted"] for r in got] == [True, True]
    assert [r["global_step"] for r in got] == [4, 4]
    aux = got[0]["aux"]
    assert aux["mid_epoch"] and aux["epoch"] == 1 and aux["global_step"] == 4
    assert aux["items_done"] == 1 and aux["n_train_eps"] == 2


@pytest.mark.parametrize("when", LATE_SIGTERM)
def test_late_sigterm_on_one_rank_stops_every_rank_after_the_epoch(ranks, when):
    """A SIGTERM that reaches rank 0 alone while it waits in epoch 0's last
    preemption poll (its flag already read as clear), or after that poll,
    is kept and acted on by both ranks alike: no rank takes the mid-epoch
    branch on its own flag; the poll after epoch 0's validation agrees on
    the stop, so both end after step 3 with epoch 0 whole and an
    epoch-boundary ``last``."""
    got = _task(ranks, 2, "late_sigterm_task", LATE_SIGTERM.index(when))
    assert [r["preempted"] for r in got] == [True, True]
    assert [r["global_step"] for r in got] == [3, 3]
    assert [r["epochs"] for r in got] == [[0], [0]]
    aux = got[0]["aux"]
    assert not aux.get("mid_epoch") and aux["epoch"] == 0 and aux["global_step"] == 3


@pytest.mark.parametrize("world", [2, 1])
def test_resume_across_world_sizes(ranks, work, world):
    """The preempted 2-rank run resumed at 2 ranks, and (its checkpoints
    copied before) at 1 process: both finish epoch 1 at step 6 within 3e-4
    × scale of the uninterrupted 2-rank fit, the moments having been saved
    whole."""
    if world == 2:
        out = _task(ranks, 2, "resume_task")[0]
    else:
        out = side.resume_task("cpu", str(work / "episodes"), str(work / "cut1"))
    assert not out["preempted"] and out["global_step"] == 6
    assert [r["epoch"] for r in out["history"]] == [1]
    ref = _task(ranks, 2, "fit_task")[0]["weights"]
    for k, v in ref.items():
        np.testing.assert_allclose(out["weights"][k], v, rtol=0, atol=3e-4 * _scale(v), err_msg=k)


def test_batch_size_the_world_does_not_divide_raises(ranks):
    """JAX trims its mesh to the devices that divide the batch; a process
    group cannot shrink, so the trainer raises, naming the sizes and the
    largest world that divides the batch (the fits above split tails of 1
    row and the 2-episode validation batch unevenly, exactly)."""
    said = _task(ranks, 2, "refusal_task")
    assert all(s == "batch size 3 is not divisible by the world size 2; the largest world "
               "that divides it is 1" for s in said), said


# ---- the launch and the dry run -------------------------------------------------------------------


def _clean_env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_torchrun_launch_trains_data_parallel(tmp_path):
    """``python -m torch.distributed.run --standalone --nproc_per_node=2 -m
    multimodal_mtrssm_tpu_torch train-mopoe-mrssm`` on a small config: the
    ranks generate the episodes once, train one epoch and write one
    ``metrics.jsonl`` (rank 0's)."""
    from test_torch_port_cli import _tiny_yaml

    cfg = _tiny_yaml(tmp_path, "mopoe_mrssm.yaml")
    raw = yaml.safe_load(open(cfg))
    raw["trainer"].pop("callbacks", None)  # no rollout GIFs: the launch is what is tested
    yaml.safe_dump(raw, open(cfg, "w"))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", "multimodal_mtrssm_tpu_torch", "train-mopoe-mrssm", "-c", str(cfg), "--device",
         "cpu", "--synthetic", "16", "--max-epochs", "1", "--data-dir", str(tmp_path / "data"),
         "--log-dir", str(tmp_path / "run")],
        cwd=REPO, env=_clean_env(), capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, f"stdout={proc.stdout[-3000:]}\nstderr={proc.stderr[-3000:]}"
    assert proc.stdout.count("done: best val/loss") == 1
    assert "trainer mesh: 2 data" in proc.stdout
    logs = list(tmp_path.rglob("metrics.jsonl"))
    assert logs == [tmp_path / "run" / "metrics.jsonl"]
    rows = [r for r in map(yaml.safe_load, logs[0].read_text().splitlines()) if "epoch" in r]
    assert [r["epoch"] for r in rows] == [0] and np.isfinite(rows[0]["train/loss"])
    assert len(list((tmp_path / "data").glob("*.npz"))) == 16


def test_dryrun_multichip_clean_env():
    """``dryrun_multichip(4)`` from a fresh interpreter with no platform or
    rank variables (the counterpart of ``tests/test_graft_entry.py``):
    both families at the reference config, B=8 T=30, the flat, ZeRO-1 and
    hybrid steps on 4 gloo ranks."""
    proc = subprocess.run(
        [sys.executable, "-c",
         "from multimodal_mtrssm_tpu_torch.dryrun import dryrun_multichip; dryrun_multichip(4)"],
        env=_clean_env(), cwd=REPO, capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 0, f"stdout={proc.stdout}\nstderr={proc.stderr[-3000:]}"
    said = proc.stdout
    assert "dryrun_multichip(4): ok" in said
    assert "mrssm[B=8,T=30]" in said and "mmtrssm[B=8,T=30]" in said
    assert "moments 433711 of 1734842 a rank" in said  # MRSSMConfig(): 1,734,842 parameters
    assert said.count("hybrid dcn×data={'dcn': 2, 'data': 2}") == 2
