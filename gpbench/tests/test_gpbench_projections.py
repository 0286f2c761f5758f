"""CPU tests of ``k1_projections.nmll``: the projections of K1's calls at
SLQ's right-hand sides over those calls, counted while the traced
operations run, and no value from a program without the counter."""
from collections import Counter
from types import SimpleNamespace

import pytest

from gpbench.harness import cell
from xgpr_tpu_torch.ops.cuda import ztzv

NAME = "k1_projections.nmll"
CONFIG = {"nmll": {"settings": {"nsamples": 25}}}


def observed(calls, monkeypatch, counters=True):
    """The reader's notes over ``calls`` (key, projections) made while it
    observes, on fresh counters (none for a program without them)."""
    monkeypatch.setattr(ztzv, "LAUNCHES", Counter())
    if counters:
        monkeypatch.setattr(ztzv, "PROJECTIONS", Counter(), raising=False)
    else:
        monkeypatch.delattr(ztzv, "PROJECTIONS")
    module = cell.reader(NAME)
    notes = {}
    ztzv.LAUNCHES[(8192, 84, 4096, 26, "hi", "high")] += 3  # before: left out
    with module.observe(notes):
        for key, made in calls:
            ztzv.LAUNCHES[key] += 1
            if counters:
                ztzv.PROJECTIONS[key] += made
    return module, SimpleNamespace(notes=notes, config=CONFIG,
                                   traced=[{}, {"failed": True}])


def test_projections_a_call_at_slqs_width(monkeypatch):
    k26 = (8192, 84, 4096, 26, "hi", "high")
    k1 = (8192, 84, 4096, 1, "hi", "high")
    module, run = observed([(k26, 1), (k26, 1), (k1, 2), (k26, 1)],
                           monkeypatch)
    assert module.read(run) == pytest.approx(1.0)
    module, run = observed([(k26, 4), (k26, 4)], monkeypatch)
    assert module.read(run) == pytest.approx(4.0)


def test_no_value_without_the_counter_or_the_calls(monkeypatch):
    k26 = (8192, 84, 4096, 26, "hi", "high")
    module, run = observed([(k26, 1)], monkeypatch, counters=False)
    assert run.notes == {} and module.read(run) is None
    k1 = (8192, 84, 4096, 1, "hi", "high")
    module, run = observed([(k1, 2)], monkeypatch)
    assert module.read(run) is None
    module, run = observed([(k26, 1)], monkeypatch)
    run.traced = [{"failed": True}]
    assert module.read(run) is None
