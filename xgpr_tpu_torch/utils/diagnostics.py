"""Per-phase timing, tracing and blocking (port of
xgpr_tpu/utils/diagnostics.py).

``phase_timer`` wraps a fit phase and adds its wall-clock seconds to a
``PhaseTimes`` dict.  PyTorch returns before the card finishes, so the
timer synchronises the CUDA device (when one is in use) before reading the
clock at both ends: a phase's time is the time its work took, not the time
it took to enqueue.  ``trace`` records a region with ``torch.profiler``
(host ops, and the card's kernels when a card is visible) into a Chrome
trace file; ``block`` waits for the devices of the tensors in a nested
structure.
"""
import contextlib
import os
import time

import torch


class PhaseTimes(dict):
    """Accumulated wall-clock seconds per named phase."""

    def report(self):
        width = max((len(k) for k in self), default=0)
        return "\n".join(f"{k.ljust(width)}  {v:.4f}s"
                         for k, v in self.items())


def synchronize(device):
    """Wait for the CUDA device's queued work; a no-op on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def phase_timer(times: PhaseTimes, name: str, device="cpu"):
    synchronize(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        synchronize(device)
        times[name] = times.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region with torch.profiler (CPU activity, and
    CUDA activity when a card is visible) and write it as a Chrome trace,
    ``trace.json`` in ``log_dir`` (created if missing), on exit.  Yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def block(tree):
    """Wait for the device of every tensor in a nested dict, list or
    tuple (for honest phase timing); returns ``tree``."""
    if torch.is_tensor(tree):
        synchronize(tree.device)
    elif isinstance(tree, dict):
        for leaf in tree.values():
            block(leaf)
    elif isinstance(tree, (list, tuple)):
        for leaf in tree:
            block(leaf)
    return tree
