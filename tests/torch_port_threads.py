"""One PyTorch thread per pytest-xdist worker, for the port's test files.

Under ``pytest -n N`` each of the N worker processes would run PyTorch's
CPU operators on as many threads as the machine has cores, N times over,
and the toy shapes of these tests gain nothing from the threads they
oversubscribe: on an 8-core machine with five other processes busy,
``tests/test_torch_port_config_keys.py`` took 176 s on PyTorch's default
threads and 38 s on one.  A port test file imports the fixture below
(``from torch_port_threads import one_torch_thread_per_worker``), which
then applies to each of its tests: inside an xdist worker (the
``PYTEST_XDIST_WORKER`` variable set) PyTorch runs on one thread for the
file's tests and gets its thread count back after them; a run in one
process is left as it is.

``test_torch_port_bgnn.py`` and ``test_torch_port_legacy_attention.py``
do not import it: their float64 train-step comparisons hold the union
features' first convolution's bias gradient, an f32 sum over every pixel
of the batch, within 1e-4 of its largest value, and PyTorch's one-thread
order of that sum falls outside it (1.65e-4 and 1.55e-4 with
``OMP_NUM_THREADS=1``), where its default threads' order falls inside
(ROADMAP.md queue C keeps the readings and the repair).
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread_per_worker():
    if "PYTEST_XDIST_WORKER" not in os.environ:
        yield
        return
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
