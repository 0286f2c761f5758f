"""Per-phase timing.

``phase_timer`` wraps a fit phase and adds its wall-clock seconds to a
``PhaseTimes`` dict.  PyTorch returns before the card finishes, so the
timer synchronises the CUDA device (when one is in use) before reading the
clock at both ends: a phase's time is the time its work took, not the time
it took to enqueue.
"""
import contextlib
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
