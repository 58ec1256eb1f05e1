"""Kernel timing on the card.

The counterpart of ``triton_dist_tpu/utils/perf.py::perf_func``: each
iteration is bracketed by ``torch.cuda.Event``s on the current stream, after
a warm-up, and the median is returned. A host clock would time only the
enqueue, since PyTorch returns before the device finishes.
"""

from __future__ import annotations

import statistics

import torch


def perf_func(func, iters: int = 20, warmup_iters: int = 3):
    """Return ``(result, median_ms)`` of ``func()`` on the card; ``result``
    is the last iteration's output. Raises without CUDA: a time taken on the
    CPU is not a device time."""
    if not torch.cuda.is_available():
        raise RuntimeError("perf_func times the card; CUDA is not available")
    result = None
    for _ in range(warmup_iters):
        result = func()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        result = func()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return result, statistics.median(s.elapsed_time(e) for s, e in pairs)
