"""One intra-op thread for the port's CPU tests.

Under xdist every worker's torch starts a thread per core: six workers on
eight cores run dozens of spinning OpenMP threads, which slows the port's
tests many times over and starves the other workers'.  A port test file
that runs torch work on the CPU imports ``one_torch_thread``: an autouse
fixture of module scope, it holds the file's tests, and the module-scoped
fixtures they use, at one thread.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
