"""Per-phase timing, tracing and the port's named spans (port of
xgpr_tpu/utils/diagnostics.py).

``phase_timer`` wraps a fit phase and adds its wall-clock seconds to a
``PhaseTimes`` dict.  PyTorch returns before the card finishes, so the
timer synchronises the CUDA device (when one is in use) before reading the
clock at both ends: a phase's time is the time its work took, not the time
it took to enqueue.  ``trace(log_dir)`` records a region with
``torch.profiler`` (host ops, and the card's kernels when a card is
visible) into a Chrome trace file: the operator's way to see the spans
below beside the kernels they launch.

``span(name)`` names a region of the port's own layers.  While a profiler
runs it is a ``torch.profiler.record_function`` range, in the same trace
and on the same clock as the kernels; otherwise it is one shared no-op
context, after a single read of the profiler's flag, so a span on a hot
path costs well under a microsecond with tracing off.  A ``xgpr/wait.*``
span wraps a host read that blocks on the device.  The spans:

- ``xgpr/k1``: one ``ops/cuda/ztzv.ztzv_parts`` call (checks, operands,
  allocations, the launch's enqueue; K1 never synchronises);
- ``xgpr/cg.iter``: one iteration of ``fitting/fused_cg._cg_while``, with
  ``xgpr/wait.cg_flag``, its read of the loop's flag, nested;
- ``xgpr/slq.probes``, ``xgpr/slq.pcg``, ``xgpr/slq.lanczos``: SLQ's probe
  draw and shaping, its batched PCG, its tridiagonal eigensolves on the
  host (``scoring/slq.py``);
- ``xgpr/precond.build``: one ``NystromPreconditioner``;
  ``xgpr/precond.sketch`` and ``xgpr/precond.power``: one sketch pass and
  one Z^T Z Q pass of the engine; ``xgpr/precond.factor``: the float64
  SVD, QR and eigh after them; ``xgpr/precond.ratio_check``: one trial
  rank of the fit's autoselect (``models/baseclass.py``);
- ``xgpr/twolayer.l1``, ``xgpr/twolayer.l2``: Conv1dTwoLayer's two
  layers in one call of its feature or gradient fn
  (``kernels/l2_conv1d.py``): layer 1's tile layout and K4, then layer
  2's sigma scale and K2 (the plain SORF map in the gradient fn);
- ``xgpr/predict``: one ``GPRegression.predict``, with
  ``xgpr/predict.var`` (a chunk's variance), ``xgpr/wait.lengths`` (a
  chunk's lengths copied to the device) and ``xgpr/wait.to_host`` (the
  mean's and the variance's copies to the host) nested.
"""
import contextlib
import os
import time

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

# The context a span returns while no profiler runs.
_OFF = contextlib.nullcontext()


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


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler runs,
    else a shared no-op context (the flag is read at each call)."""
    if _autograd_profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF
