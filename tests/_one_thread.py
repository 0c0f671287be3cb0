"""A module-scoped fixture that runs a test file's torch ops on one CPU
thread, restoring the count after the file.

The parity files that import it run many small tensor ops (tiny models,
sampling loops). The tier-1 run gives each of several worker processes all
of the machine's cores; their default thread pools then oversubscribe the
cores, and small ops slow down many times over. One thread a worker keeps
these files, and the workers that share the machine with them, at speed.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
