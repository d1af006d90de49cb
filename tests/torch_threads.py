"""A fixture the port's slower CPU test files use: two intra-op threads
for PyTorch while the file runs. The suite runs several pytest workers on
one machine, and PyTorch's default of one thread per core in each of them
oversubscribes the cores many times over (a 2 s test took 128 s in a
six-worker run)."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
