# -*- coding: utf-8 -*-
"""Tracing / profiling hooks.

  * :func:`trace` — context manager around ``torch.profiler`` writing a
    TensorBoard-loadable trace (CPU and, on the card, CUDA activity) of
    everything inside into ``log_dir``;
  * :func:`timeit` — synchronized best-of-K wall clock for a callable (a
    device synchronize on every tensor output before the clock stops);
  * :func:`annotate` — named ``record_function`` spans for custom regions.
"""

import contextlib
import os
import time

import torch

__all__ = ["trace", "timeit", "annotate"]


@contextlib.contextmanager
def trace(log_dir):
    """Profile everything inside the block into a Chrome trace file in
    ``log_dir`` (one a block, named by process and time); yields the
    ``torch.profiler.profile`` (its ``key_averages()`` after the block)."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace_{0}_{1}.json".format(
        os.getpid(), time.time_ns())))


@contextlib.contextmanager
def annotate(name):
    """Label a region in the profiler timeline."""
    with torch.profiler.record_function(name):
        yield


def _leaves(out):
    if torch.is_tensor(out):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _leaves(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _leaves(v)


def _block(out):
    """Synchronize the device of every tensor output."""
    for dev in {leaf.device for leaf in _leaves(out)}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return out


def timeit(fn, *args, repeats=5, warmup=1, vary=None, **kwargs):
    """Best-of-``repeats`` synchronized wall-clock seconds for ``fn``.

    ``vary`` (an int -> extra-kwargs dict) perturbs each call; warmup calls
    get -1, -2, ...
    """
    extra = (lambda i: {}) if vary is None else vary
    for i in range(warmup):
        _block(fn(*args, **dict(kwargs, **extra(-1 - i))))
    best = float("inf")
    for i in range(repeats):
        t0 = time.perf_counter()
        _block(fn(*args, **dict(kwargs, **extra(i))))
        best = min(best, time.perf_counter() - t0)
    return best
