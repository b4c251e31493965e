"""The port's multi-rank dry run (counterpart of the JAX package's
``dryrun_multichip``): the full training step of both families over ``n``
ranks, on the CPU or on the card.

``dryrun_multichip(n, device)`` spawns ``n`` ranks (``parallel.spawn``)
and, in each, for ``MRSSMConfig()`` and ``MMTRSSMConfig()`` (the reference
config) at B=8 T=30 (B=2n where n does not divide 8):
one data-parallel train step on a flat ``data`` mesh with the replicated
optimizer, one with ZeRO-1 moments, and, where ``n`` is even and at least
4, the same ZeRO-1 step on a hybrid ``(dcn, data)`` mesh of ``dcn_size=2``,
whose loss must equal the flat ZeRO-1 step's within ``rtol 1e-4``. It
prints ``dryrun_multichip(n): ok — ...`` and returns each rank's summary.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

HYBRID_RTOL = 1e-4


def dryrun_multichip(n: int, device: str = "cpu", backend: str | None = None) -> list[dict]:
    """Run the dry run on ``n`` ranks (module docstring); ``backend`` as
    ``parallel.spawn.spawn`` takes it (``gloo`` for ranks that share a
    card). Raises when a rank fails or a check does not hold."""
    from multimodal_mtrssm_tpu_torch.parallel.spawn import spawn

    results = spawn("multimodal_mtrssm_tpu_torch.dryrun:dryrun_rank", n, device, backend,
                    timeout_s=900)
    print(f"dryrun_multichip({n}): ok — " + "; ".join(results[0]["lines"]))
    return results


def _families() -> tuple:
    from multimodal_mtrssm_tpu_torch.models import (
        MMTRSSMConfig,
        MoPoEMMTRSSM,
        MoPoEMRSSM,
        MRSSMConfig,
    )

    return (("mrssm", MoPoEMRSSM(MRSSMConfig())), ("mmtrssm", MoPoEMMTRSSM(MMTRSSMConfig())))


def dryrun_rank(device: torch.device) -> dict:
    """One rank of the dry run (the spawned function): both families'
    three steps; returns the summary lines, each step's global loss and the
    rank's kernel launches (``ops.kernels.launch_counts``)."""
    from multimodal_mtrssm_tpu_torch.ops.kernels import launch_counts
    from multimodal_mtrssm_tpu_torch.parallel.mesh import make_hybrid_mesh, make_mesh

    n = dist.get_world_size()
    mesh = make_mesh()
    hybrid = make_hybrid_mesh(dcn_size=2) if n % 2 == 0 and n >= 4 else None
    B = 8 if 8 % n == 0 else 2 * n
    T = 30
    out: dict = {"lines": [], "losses": {}}
    for name, model in _families():
        line, losses = _dryrun_family(name, model.to(device), mesh, hybrid, B, T)
        out["lines"].append(line)
        out["losses"][name] = losses
    out["launches"] = launch_counts()
    return out


def _global_loss(metrics: dict, rows: tuple[int, int, int], device: torch.device) -> float:
    """The global batch's loss from each rank's loss over its rows."""
    lo, hi, B = rows
    t = torch.zeros(1, dtype=torch.float64, device=device)
    if metrics:
        t += metrics["loss"].double() * (hi - lo) / B
    dist.all_reduce(t)
    return float(t)


def _dryrun_family(name: str, model, mesh, hybrid, B: int, T: int) -> tuple[str, dict]:
    """One family: flat step, ZeRO-1 step, hybrid step (module docstring)."""
    from multimodal_mtrssm_tpu_torch.parallel.mesh import mesh_rows, replicate, shard_rows
    from multimodal_mtrssm_tpu_torch.train.optim import AdamW
    from multimodal_mtrssm_tpu_torch.train.steps import make_train_step

    device = next(model.parameters()).device
    replicate(model.init(torch.Generator().manual_seed(0)), mesh)
    rng = np.random.default_rng(1)
    act = rng.standard_normal((B, T, 6), dtype=np.float32)
    aud, vis = (rng.uniform(-1, 1, (B, T, 32, 32, 1)).astype(np.float32) for _ in range(2))
    lo, hi = mesh_rows(B, mesh)
    rows = (lo, hi, B)
    local = tuple(torch.from_numpy(x).to(device)
                  for x in shard_rows((act, aud, vis, act, aud, vis), mesh))

    def step(m, zero1: bool, seed: int) -> tuple[float, AdamW]:
        opt = AdamW(model.parameters(), mesh=m, zero1=zero1)
        loss = _global_loss(make_train_step(model, opt)(local, seed, 0, rows), rows, device)
        if not math.isfinite(loss):
            raise RuntimeError(f"[{name}] non-finite loss {loss} (zero1={zero1}, mesh {m.shape})")
        return loss, opt

    loss, _ = step(mesh, False, 2)
    after = {k: v.clone() for k, v in model.state_dict().items()}
    loss_z, opt_z = step(mesh, True, 3)
    losses = {"flat": loss, "zero1": loss_z}
    hybrid_spec = None
    if hybrid is not None:
        # The hybrid mesh splits the batch over (dcn, data) in rank order:
        # the same rows as the flat one, so the same step from the same weights.
        model.load_state_dict(after)
        loss_h, opt_h = step(hybrid, True, 3)
        if not math.isclose(loss_h, loss_z, rel_tol=HYBRID_RTOL):
            raise RuntimeError(f"[{name}] the hybrid mesh changed the math: {loss_h} vs {loss_z}")
        losses["hybrid"] = loss_h
        hybrid_spec = f"{hybrid.shape}, moments {opt_h.shard} of {opt_h.n} a rank"
    line = (f"{name}[B={B},T={T}]: loss={loss:.4f}, rows {hi - lo} of {B} a rank, "
            f"zero1 moments {opt_z.shard} of {opt_z.n} a rank, hybrid dcn×data={hybrid_spec}")
    return line, losses
