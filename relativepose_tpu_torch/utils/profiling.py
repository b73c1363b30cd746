"""Tracing, stage timing and NaN debugging.

Counterpart of `relativepose_tpu/utils/profiling.py`:

  * `trace(logdir)`: a `torch.profiler` context (CPU, and CUDA where
    there is a card) that writes a Chrome trace, `trace.json`, into
    `logdir` when it closes (the JAX package writes an XLA trace);
  * `StageTimer`: per-stage wall-clock averages; `block_on` tensors are
    waited for before a stage's clock stops, by synchronising their CUDA
    devices (torch has no `jax.block_until_ready`);
  * `debug_nans(enable)`: raise `FloatingPointError` at the first
    operation whose output holds a NaN, forward or backward, as
    `jax_debug_nans` does (`torch.autograd.set_detect_anomaly` checks the
    backward only).  It is a `TorchDispatchMode` on this thread, so every
    operation then pays a check.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from relativepose_tpu_torch.utils.log import AverageMeter


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; yields the profiler, writes logdir/trace.json."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def block_until_ready(tree):
    """Wait for the CUDA work that produces the tensors in `tree`."""
    devices = {x.device for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor)}
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return tree


class StageTimer:
    def __init__(self):
        self.meters = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                block_until_ready(block_on)
            self.meters.setdefault(name, AverageMeter()).update(
                time.perf_counter() - start)

    def report(self):
        return {k: m.avg for k, m in self.meters.items()}


class NanCheckMode(TorchDispatchMode):
    """Raise at the first operation whose floating-point output holds a
    NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and (
                    t.is_floating_point() or t.is_complex()) and \
                    bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"debug_nans: NaN in the output of {func}")
        return out


_NAN_MODE = None


def debug_nans(enable: bool = True):
    """Turn the NaN check on or off for this thread."""
    global _NAN_MODE
    if enable and _NAN_MODE is None:
        _NAN_MODE = NanCheckMode()
        _NAN_MODE.__enter__()
    elif not enable and _NAN_MODE is not None:
        mode, _NAN_MODE = _NAN_MODE, None
        mode.__exit__(None, None, None)
