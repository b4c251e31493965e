"""Run one function on ``n`` local ranks, each its own process.

``spawn("pkg.module:function", n, device)`` starts ``n`` interpreters
(``python -m multimodal_mtrssm_tpu_torch.parallel.spawn``), which
rendezvous through a file in a work directory (``file://``: no port to
collide on), join the process group with ``parallel.mesh.init_from_env``
and call ``function(device=<the rank's device>, **kwargs)``. Each rank's
return value comes back through the work directory, in rank order. A rank
that fails, or a run that outlasts ``timeout_s``, stops every rank and
raises with the end of the failing rank's output.

``device="cuda"`` puts rank ``r`` on card ``r % device_count``; with more
ranks than cards name ``backend="gloo"`` (NCCL refuses two ranks on one
card, and nothing falls back to another backend on its own).
"""

from __future__ import annotations

import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import time
import uuid
from pathlib import Path
from typing import Any

import torch

# The repository's root: the children import this checkout's package.
_ROOT = Path(__file__).resolve().parents[2]


def spawn(target: str, n: int, device: str = "cpu", backend: str | None = None,
          kwargs: dict | None = None, timeout_s: float = 600.0, workdir: str | Path | None = None,
          paths: tuple[str, ...] = (), group_timeout_s: float = 300.0) -> list[Any]:
    """``target`` (``"module:function"``) on ``n`` ranks, each on one
    intra-op thread; returns each rank's return value. ``paths`` are put on
    the children's ``sys.path``; ``group_timeout_s`` bounds each
    collective. ``workdir`` (a fresh temporary directory, removed after,
    when None) holds the rendezvous file, the ranks' logs and results."""
    own = workdir is None
    work = Path(tempfile.mkdtemp(prefix="ranks-")) if own else Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    tag = uuid.uuid4().hex[:8]
    spec = work / f"spec-{tag}.pt"
    torch.save({"target": target, "kwargs": kwargs or {}, "device": device, "backend": backend,
                "init": f"file://{work / f'store-{tag}'}", "group_timeout_s": group_timeout_s,
                "out": str(work / f"out-{tag}")}, spec)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(_ROOT), *map(str, paths),
                                         *filter(None, [env.get("PYTHONPATH")])])
    env["OMP_NUM_THREADS"] = "1"
    logs = [work / f"rank{r}-{tag}.log" for r in range(n)]
    procs = []
    try:
        for r in range(n):
            env_r = dict(env, RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                         LOCAL_WORLD_SIZE=str(n))
            with open(logs[r], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "multimodal_mtrssm_tpu_torch.parallel.spawn", str(spec)],
                    env=env_r, cwd=str(_ROOT), stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                r = failed[0] if failed else 0
                why = f"rank {r} exited with {procs[r].returncode}" if failed else \
                    f"the ranks ran past {timeout_s:.0f} s"
                raise RuntimeError(f"spawn({target}, {n}): {why}:\n{_tail(logs[r])}")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"spawn({target}, {n}): rank {failed[0]} exited with "
                               f"{procs[failed[0]].returncode}:\n{_tail(logs[failed[0]])}")
        return [torch.load(f"{work / f'out-{tag}'}-{r}.pt", weights_only=False)
                for r in range(n)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if own:
            shutil.rmtree(work, ignore_errors=True)


def _tail(log: Path, n: int = 6000) -> str:
    text = log.read_text() if log.is_file() else ""
    return text[-n:]


def _child(spec_path: str) -> None:
    """One rank: join the group, run the target, save its return value."""
    import torch.distributed as dist

    from multimodal_mtrssm_tpu_torch.parallel.mesh import init_from_env

    spec = torch.load(spec_path, weights_only=False)
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    device = spec["device"]
    if device == "cuda":
        device = f"cuda:{int(os.environ['LOCAL_RANK']) % torch.cuda.device_count()}"
    device = init_from_env(device, spec["backend"], spec["init"], spec["group_timeout_s"])
    module, name = spec["target"].split(":")
    fn = getattr(importlib.import_module(module), name)
    try:
        out = fn(device=device, **spec["kwargs"])
        torch.save(out, f"{spec['out']}-{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1])
