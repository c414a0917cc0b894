"""Caps torch's CPU threads while a port test module runs under pytest-xdist.

Each xdist worker is a process whose torch would otherwise start one
intra-op thread per core, so six workers on eight cores run dozens of
threads that wait on each other at every parallel region: under such load a
GMFSS node run took about 7x longer with 8 threads than with 2. A module
imports the fixture (``from torch_threads import few_torch_threads``); it
applies to that module's tests alone and restores the count after them.

Importing this module also makes torch's first ``exp`` and ``tanh`` on the
CPU, on one thread: in torch 2.13.0+cpu the first call of either in a
process, when it runs on several threads, now and then gives part of the
tensor about 1.5e-4 from the right value (5 of 12 fresh processes for
``exp`` of 400,000 floats, 1 of 12 for ``tanh``; none after one call on a
tensor of 8), which a comparison against such a value as a reference then
reads as the code's error.
"""

import os

import pytest
import torch

torch.exp(torch.zeros(8))
torch.tanh(torch.zeros(8))


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    if workers > 1:
        torch.set_num_threads(max(2, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
