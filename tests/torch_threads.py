"""One intra-op thread for the port's CPU tests.

Their tensors are tiny, so extra threads buy nothing, and when pytest-xdist
runs several workers on a few cores, each worker's idle OpenMP threads
spin and starve the others (a test of the speculative scheduler took 38 s
beside other workers' tests, 2 s alone). Test modules import this fixture;
it applies while their tests run and restores the count after.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
