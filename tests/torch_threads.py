"""Caps torch's CPU threads while a port test module runs under pytest-xdist.

Each xdist worker is a process whose torch would otherwise start one
intra-op thread per core, so six workers on eight cores run dozens of
threads that wait on each other at every parallel region: under such load a
GMFSS node run took about 7x longer with 8 threads than with 2. A module
imports the fixture (``from torch_threads import few_torch_threads``); it
applies to that module's tests alone and restores the count after them.
"""

import os

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    if workers > 1:
        torch.set_num_threads(max(2, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
