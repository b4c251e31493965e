"""A module-scoped autouse fixture for the port's CPU tests of tiny fits:
``from _port_threads import _one_intra_op_thread  # noqa: F401`` runs the
importing module's tests on one intra-op thread. With a thread per core
in each of the suite's parallel workers, a tiny model's many small ops
wait on oversubscribed cores many times over (a trainer test file ran
25× slower so than alone)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
