"""``python -m multimodal_mtrssm_tpu_torch <command>``: the port's console
entry points (JAX ``__main__.py``).

Commands: ``train-mopoe-mrssm``, ``train-mopoe-mmtrssm`` (``cli``: train a
shipped config, or ``-c``), ``evaluate-word-transitions`` (the
Matching-Rate evaluation) and ``serve`` (``server.main``: the HTTP
inference server). The remaining arguments go to the command.
"""

from __future__ import annotations

import sys


def _serve(argv: list[str]) -> None:
    from multimodal_mtrssm_tpu_torch.server import main as serve_main

    serve_main(argv)


def _command(name: str):
    def run(argv: list[str]) -> None:
        from multimodal_mtrssm_tpu_torch import cli

        getattr(cli, name)(argv)

    return run


_COMMANDS = {"train-mopoe-mrssm": _command("train_mopoe_mrssm"),
             "train-mopoe-mmtrssm": _command("train_mopoe_mmtrssm"),
             "evaluate-word-transitions": _command("evaluate_word_transitions"),
             "serve": _serve}


def main(argv: list[str] | None = None) -> None:
    """Dispatch ``python -m multimodal_mtrssm_tpu_torch <command> [args]``."""
    argv = sys.argv[1:] if argv is None else argv
    names = ", ".join(_COMMANDS)
    if not argv or argv[0] in ("-h", "--help"):
        print(f"usage: python -m multimodal_mtrssm_tpu_torch <command> [args]\ncommands: {names}")
        raise SystemExit(0 if argv else 2)
    command = _COMMANDS.get(argv[0])
    if command is None:
        print(f"unknown command {argv[0]!r}; have: {names}")
        raise SystemExit(2)
    command(argv[1:])


if __name__ == "__main__":
    main()
