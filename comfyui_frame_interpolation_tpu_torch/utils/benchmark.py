"""Timing on the card (port of the JAX package's ``utils/benchmark.py``).

PyTorch returns before the device finishes, so a host clock measures the
enqueue; :func:`measure` times rounds of calls between CUDA events and reports
the median round's seconds per call, which is robust to a straggler round.
There is no CPU path: a measurement that finds no card fails.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch

__all__ = ["measure"]


def measure(fn: Callable, *args, iters: int = 10, rounds: int = 3) -> float:
    """Median-round average seconds per call of ``fn(*args)`` on the current
    CUDA device, after one warm-up call."""
    if not torch.cuda.is_available():
        raise RuntimeError("measure times CUDA work and needs a CUDA device")
    fn(*args)  # warm-up: kernel builds, cuDNN algorithm selection, allocator
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3 / iters)
    return statistics.median(times)
