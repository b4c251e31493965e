"""The JAX package's native batch library, loaded for the port's parity
tests: ``from _port_native import jax_native as jax_native`` and ask for
the ``jax_native`` fixture. JAX's ``data/native.py`` builds its library in
place on first use and, where a build or load fails, falls back to numpy
for the rest of the process; parallel test workers can race there (one
loads the file while another writes it). The fixture loads it under a lock
that the workers share, retries a load that a racing build spoiled, and
fails where it cannot load, so a parity test never meets JAX's numpy path
unawares."""

import fcntl
import time

import pytest

LOAD_TRIES = 20


@pytest.fixture
def jax_native(tmp_path_factory, monkeypatch):
    """JAX's ``data.native`` module with its library loaded."""
    from multimodal_mtrssm_tpu.data import native

    lock = tmp_path_factory.getbasetemp().parent / "jax_native.lock"
    with open(lock, "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        for _ in range(LOAD_TRIES):
            if native._load() is not None:
                break
            monkeypatch.setattr(native, "_build_failed", False)
            time.sleep(0.5)
    if native._lib is None:
        raise RuntimeError("the JAX package's native fastbatch library did not build or load")
    return native
