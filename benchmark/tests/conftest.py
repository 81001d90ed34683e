"""Toy runs on the CPU take two threads each, so that several test workers
do not oversubscribe the host."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="session")
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)
