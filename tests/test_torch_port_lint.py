"""The repo's AST lint (``multimodal_mtrssm_tpu.utils.lint``) over the port
and ``chip_smoke.py``, which the static gates' roots do not cover."""

from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_port_and_chip_smoke_lint_clean():
    from multimodal_mtrssm_tpu.utils.lint import check_paths

    findings = check_paths([REPO / "multimodal_mtrssm_tpu_torch", REPO / "chip_smoke.py"])
    assert not findings, "\n".join(findings)
