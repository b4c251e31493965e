"""The learning demonstration (``demo_e2e``) and its diagnostic
(``probe_transitions``) against the JAX package's scripts.

Each port script takes the JAX script's flags with the same defaults
(``--device`` standing in for ``--platform``), read from the parser each
script builds; ``demo_e2e`` writes the JAX script's ``summary.json`` (and
``summary_seeds<a>-<b>.json`` for an extension run) from the same per-seed
results, and ``probe_transitions`` writes ``probe.json`` with the JAX
script's keys. Both run end to end on the CPU at small encoders, one epoch
and a handful of episodes (a path check: the long runs are on the card,
``chip_smoke.py --learning-demo``).
"""

import argparse
import ast
import importlib.util
import json
import sys
from pathlib import Path

import pytest

from multimodal_mtrssm_tpu_torch import demo_e2e, probe_transitions
from multimodal_mtrssm_tpu_torch.train import config as config_mod
from _port_threads import _one_intra_op_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
ENC = dict(channels=[4, 8], kernel_sizes=[3, 3], strides=[2, 2], paddings=[1, 1],
           num_residual_blocks=0, coord_conv=False, linear_sizes=[64])
TINY = {"model": {"init_args": {"audio_encoder": {"config": ENC}, "vision_encoder": {"config": ENC},
                                "init_proj": {"num_cells": 32}}}}


def _jax_script(name: str):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Parsed(Exception):
    def __init__(self, parser):
        self.parser = parser


def _jax_parser(name: str, monkeypatch) -> argparse.ArgumentParser:
    """The parser the JAX script's ``main`` builds, caught at its
    ``parse_args``."""
    def catch(self, *a, **k):
        raise _Parsed(self)

    script = _jax_script(name)
    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Parsed) as caught:
            script.main()
    return caught.value.parser


def _flags(parser: argparse.ArgumentParser) -> dict:
    return {a.option_strings[0]: (a.dest, a.default, a.type, a.choices, a.required,
                                  type(a).__name__)
            for a in parser._actions if a.option_strings and a.dest != "help"}


@pytest.mark.parametrize("name,port,theirs,ours", [
    ("demo_e2e", demo_e2e, "--platform", "--device"),
    ("probe_transitions", probe_transitions, None, "--device")])
def test_flags_and_defaults_are_jax(name, port, theirs, ours, monkeypatch):
    jax_flags = _flags(_jax_parser(name, monkeypatch))
    port_flags = _flags(port.build_parser())
    jax_flags.pop(theirs, None)
    assert port_flags.pop(ours)[1] == "cuda"
    assert port_flags == jax_flags


@pytest.mark.parametrize("start", [0, 3])
def test_summary_is_the_jax_scripts(start, tmp_path, monkeypatch):
    """The sweep's summary from the same per-seed results: the JAX script's
    file name (``summary_seeds3-4.json`` for an extension run) and JSON."""
    def fake(args, work, seed):
        return {"summary": {"mean_matching_rate": 0.5 + seed / 10, "mean_uniform": 0.2}}

    flags = ["--seeds", "2", "--seed-start", str(start), "--epochs", "7", "--model", "mmtrssm"]
    monkeypatch.setattr(demo_e2e, "run_once", fake)
    ours = demo_e2e.main(["--workdir", str(tmp_path / "port"), *flags])
    script = _jax_script("demo_e2e")
    monkeypatch.setattr(script, "run_once", fake)
    monkeypatch.setattr(sys, "argv", ["demo_e2e.py", "--workdir", str(tmp_path / "jax"), *flags])
    (tmp_path / "jax").mkdir()
    script.main()
    name = "summary.json" if start == 0 else f"summary_seeds{start}-{start + 1}.json"
    theirs = json.loads((tmp_path / "jax" / name).read_text())
    assert json.loads((tmp_path / "port" / name).read_text()) == theirs == ours


def _dict_keys(path: Path) -> set[str]:
    """The string keys of the dict displays in a script's source, an
    f-string key as its literal head (``frame``)."""
    keys = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.Dict, ast.DictComp)):
            for k in (node.keys if isinstance(node, ast.Dict) else [node.key]):
                if isinstance(k, ast.Constant) and isinstance(k.value, str):
                    keys.add(k.value)
                elif isinstance(k, ast.JoinedStr):
                    keys.add(k.values[0].value)
    return keys


def _json_keys(obj) -> set[str]:
    if isinstance(obj, dict):
        return {k.rstrip("0123456789") or "<digit>" for k in obj} | {
            k for v in obj.values() for k in _json_keys(v)}
    return set()


@pytest.fixture
def tiny(monkeypatch):
    real = config_mod.load_experiment
    monkeypatch.setattr(config_mod, "load_experiment", lambda path: real(path, TINY))


def test_demo_runs_on_the_cpu(tiny, tmp_path):
    """Two seeds of one epoch on 6 episodes at small encoders: each seed's
    run, classifier, best-weights GIFs and results, and the summary."""
    summary = demo_e2e.main(["--workdir", str(tmp_path), "--epochs", "1", "--episodes", "6",
                             "--seeds", "2", "--frames-per-word", "1", "--query-length", "1",
                             "--classify-frame", "1", "--n-predictions", "2", "--device", "cpu"])
    assert summary["seeds"] == 2 and len(summary["per_seed_mr"]) == 2
    for seed in (0, 1):
        work = tmp_path / f"seed{seed}"
        results = json.loads((work / "results" / "word_transitions.json").read_text())
        assert results["summary"]["mean_matching_rate"] == summary["per_seed_mr"][seed]
        assert (work / "classifier.npz").is_file() and (work / "run" / "metrics.jsonl").is_file()
        assert list((work / "run" / "viz" / "final_best").glob("*/*.gif"))


def test_probe_runs_on_the_cpu_and_writes_the_jax_keys(tiny, tmp_path):
    """One epoch on 6 episodes: each digit's three imagined frames, their
    masses in [0, 1], and ``probe.json`` with the JAX script's keys."""
    payload = probe_transitions.main(["--workdir", str(tmp_path), "--epochs", "1", "--episodes",
                                      "6", "--device", "cpu", "--model", "mmtrssm"])
    written = json.loads((tmp_path / "probe.json").read_text())
    assert written == json.loads(json.dumps(payload))
    assert set(written["means"]) == {"frame1", "frame2", "frame3"}
    for row in written["per_digit"].values():
        for frame in row.values():
            assert 0.0 <= frame["self"] + frame["successors"] <= 1.0
            assert sum(n for _, n in frame["top"]) <= probe_transitions.SAMPLES
    keys = {"means", "per_digit", "frame", "self", "successors", "top"}
    assert _json_keys(written) - {"<digit>"} == keys <= _dict_keys(
        REPO / "scripts" / "probe_transitions.py")
