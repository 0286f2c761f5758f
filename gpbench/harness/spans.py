"""The program's own spans in a traced run's summary: the ``xgpr/...``
ranges that the port opens while a profiler runs
(``xgpr_tpu_torch/utils/diagnostics.py``), found by name among the host
ranges of ``trace.summarize`` (``host``: (start, end, name) in us).

- ``intervals``: the union of a name's host intervals (nested or repeated
  ranges counted once);
- ``count``: how many ranges of the name the trace holds;
- ``seconds``: the length of that union;
- ``outside_waits``: the seconds of that union that no ``xgpr/wait.*``
  range covers (the host's own time in a span that blocks on the card
  only inside its waits);
- ``per_span`` and ``per_operation``: a total over a name's ranges, or
  over the traced operations completed; None where the trace holds none
  of the names (a program without the spans, or a cell that does not run
  them).

Device seconds launched inside a span are ``trace.range_seconds``.
"""
from .readers import completed
from .trace import _union

WAIT = "xgpr/wait."


def intervals(summary, name):
    return _union(sorted((s, e) for s, e, n in summary["host"] if n == name))


def count(summary, name):
    return sum(1 for _, _, n in summary["host"] if n == name)


def seconds(summary, name):
    return sum(e - s for s, e in intervals(summary, name)) / 1e6


def _overlap_us(a, b):
    """The length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def outside_waits(summary, name):
    spans = intervals(summary, name)
    waits = _union(sorted((s, e) for s, e, n in summary["host"]
                          if n.startswith(WAIT)))
    return (sum(e - s for s, e in spans) - _overlap_us(spans, waits)) / 1e6


def per_span(summary, name, total):
    """``total(summary)`` over the count of ``name``'s ranges, or None
    where there is no trace or it holds none."""
    n = 0 if summary is None else count(summary, name)
    return total(summary) / n if n else None


def per_operation(run, total, names):
    """``total`` over the traced operations completed, or None where the
    run was not traced, completed none, or its trace holds none of
    ``names``."""
    done = completed(run.traced or [])
    if run.trace is None or not done or \
            not any(count(run.trace, n) for n in names):
        return None
    return total(run.trace) / len(done)
