"""What the metric readers of ``gpbench/metrics/`` share.

A reader module has ``read(run)``, which returns the metric or None
where it finds nothing to read.  It may also have ``observe(notes)``, a
context manager that the harness opens around the traced operations
(``notes`` is the reader's own dict; ``run.notes`` hands it back).  A
roofline reader is ``Roofline("<kernel>")``: it counts the kernel's
launches while the traced operations run and reads the work from
``gpbench/kernels/<kernel>.py``, so this file holds no table of
kernels."""
import contextlib
from pathlib import Path

from . import peaks, spec, trace


def completed(records):
    return [r for r in records if not r.get("failed")]


def mean_of(records, key):
    values = [r[key] for r in completed(records) if r.get(key) is not None]
    return sum(values) / len(values) if values else None


def idle_share(run):
    """The device's idle share in % of the traced window."""
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])


class Launches:
    """``observe`` counts the launches of ``gpbench/kernels/<kernel>.py``
    while the traced operations run (into ``notes["launches"]``), with
    the kernel's host range open around its entry where it needs one.
    ``reader_file`` (a reader's ``__file__``) names the checkout whose
    kernel file is read."""

    def __init__(self, kernel, reader_file):
        self.kernel = spec.load_module(
            "kernels", kernel, Path(reader_file).resolve().parents[2])

    @contextlib.contextmanager
    def observe(self, notes):
        before = self.kernel.launches()
        ranged = getattr(self.kernel, "ranged", contextlib.nullcontext)
        with ranged():
            yield
        notes["launches"] = self.kernel.launches() - before


class Roofline(Launches):
    """The kernel's roofline share in % in the traced operations: the
    least time of the work its launches needed over the device time
    charged to its range, or None where it did not run."""

    def read(self, run):
        counts = run.notes.get("launches")
        if run.trace is None or not counts:
            return None
        flops, nbytes = self.kernel.work(counts, run.basis, run.config)
        seconds = trace.range_seconds(run.trace, self.kernel.RANGE)
        return peaks.share(flops, nbytes, seconds,
                           run.config["model"]["feature_dtype"])
