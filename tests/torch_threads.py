"""A module fixture for the port's CPU test files whose cases are many
small torch ops: it shares the host's cores among pytest-xdist's workers
(``PYTEST_XDIST_WORKER_COUNT``), one torch thread each when there are
more workers than cores, for as long as the file runs. Each worker's own
threads, all spinning at every op's barrier on cores the other workers
hold, made such a file a hundred times slower under ``-n 6`` than alone.
In one process nothing changes."""
import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_threads_shared():
    threads = torch.get_num_threads()
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, threads // workers))
    yield
    torch.set_num_threads(threads)
