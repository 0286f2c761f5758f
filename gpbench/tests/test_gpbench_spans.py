"""CPU tests of the readers of the program's own spans
(``gpbench/harness/spans.py`` and the eight metrics that read ``xgpr/``
ranges): each value on a synthetic trace, with ``xgpr/wait.*`` ranges
nested in the span they wait in, repeated and nested ranges counted
once, and no value where the trace holds no such span (a program without
them)."""
from types import SimpleNamespace

import pytest

from gpbench.harness import cell, spans, trace

from .test_gpbench_harness import ev


def read(name, run):
    return cell.reader(name).read(run)


def traced_run(events, ops=1, failed=0):
    """A run whose traced operations are ``ops`` completed and ``failed``
    failed ones, over a window of 0-100,000 us."""
    events = [ev(trace.WINDOW, "user_annotation", 0, 100_000)] + events
    return SimpleNamespace(trace=trace.summarize(events),
                           traced=[{}] * ops + [{"failed": True}] * failed)


def span(name, ts, dur):
    return ev(name, "user_annotation", ts, dur)


def test_union_count_and_wall_take_nested_and_repeated_spans_once():
    run = traced_run([span("xgpr/k1", 100, 50), span("xgpr/k1", 120, 10),
                      span("xgpr/k1", 400, 30), span("xgpr/k1", 400, 30)])
    assert spans.intervals(run.trace, "xgpr/k1") == [[100, 150], [400, 430]]
    assert spans.count(run.trace, "xgpr/k1") == 4
    assert spans.seconds(run.trace, "xgpr/k1") == pytest.approx(80e-6)
    assert spans.seconds(run.trace, "xgpr/cg.iter") == 0.0


def test_outside_waits_leaves_out_only_the_waits_inside():
    run = traced_run([
        span("xgpr/predict", 0, 1000),
        span("xgpr/wait.lengths", 100, 50),
        span("xgpr/wait.lengths", 110, 20),       # nested in a wait
        span("xgpr/wait.to_host", 900, 200),      # runs past the span
        span("xgpr/wait.to_host", 2000, 500),     # outside it
        span("xgpr/predict", 3000, 100)])
    assert spans.outside_waits(run.trace, "xgpr/predict") == \
        pytest.approx((1100 - 50 - 100) * 1e-6)


def test_k1_dispatch_is_the_wall_over_the_calls():
    run = traced_run([span("xgpr/cg.iter", 0, 1000),
                      span("xgpr/k1", 10, 150), span("xgpr/k1", 200, 250),
                      span("xgpr/k1", 500, 200)])
    for name in ("k1_dispatch_us.fit", "k1_dispatch_us.nmll"):
        assert read(name, run) == pytest.approx(200.0)


def test_cg_host_time_leaves_out_each_iterations_flag_wait():
    # Two iterations of 3 and 5 ms, each closing with a flag read of 1 and
    # 4 ms; the read before the loop lies outside every iteration.
    run = traced_run([span("xgpr/wait.cg_flag", 0, 500),
                      span("xgpr/cg.iter", 1000, 3000),
                      span("xgpr/k1", 1100, 200),
                      span("xgpr/wait.cg_flag", 3000, 1000),
                      span("xgpr/cg.iter", 4000, 5000),
                      span("xgpr/wait.cg_flag", 5000, 4000)])
    assert read("cg_host_ms.fit", run) == pytest.approx((2 + 1) / 2)


def test_slq_host_time_is_the_probes_and_lanczos_per_evaluation():
    run = traced_run([
        span("xgpr/slq.probes", 0, 2000), span("xgpr/slq.pcg", 2000, 50000),
        span("xgpr/slq.lanczos", 52000, 3000),
        span("xgpr/slq.probes", 60000, 1000),
        span("xgpr/slq.lanczos", 70000, 2000)], ops=2, failed=1)
    assert read("slq_host_ms.nmll", run) == pytest.approx(8.0 / 2)


def test_the_autoselects_trial_ranks_per_fit():
    run = traced_run([span("xgpr/precond.ratio_check", 0, 20000),
                      span("xgpr/precond.sketch", 0, 15000),
                      span("xgpr/precond.ratio_check", 30000, 40000)])
    assert read("precond_check_s.fit", run) == pytest.approx(0.06)


def test_device_time_launched_inside_a_span_per_operation():
    events = [span("xgpr/precond.build", 0, 10000),
              span("xgpr/precond.factor", 100, 500),
              span("xgpr/precond.factor", 150, 100),     # nested
              ev("cudaLaunchKernel", "cuda_runtime", 200, 5, corr=1),
              ev("cudaLaunchKernel", "cuda_runtime", 700, 5, corr=2),
              span("xgpr/predict", 20000, 10000),
              span("xgpr/predict.var", 21000, 100),
              ev("cudaLaunchKernel", "cuda_runtime", 21050, 5, corr=3),
              span("xgpr/predict.var", 22000, 100),
              ev("cudaLaunchKernel", "cuda_runtime", 22050, 5, corr=4),
              ev("eigh", "kernel", 300, 400, tid=7, corr=1),
              ev("sgemm", "kernel", 800, 900, tid=7, corr=2),
              ev("var", "kernel", 21100, 300, tid=7, corr=3),
              ev("var", "kernel", 22100, 500, tid=7, corr=4)]
    run = traced_run(events, ops=2)
    assert read("precond_factor_s.fit", run) == pytest.approx(400e-6 / 2)
    assert read("predict_var_ms.predict", run) == pytest.approx(0.8 / 2)


def test_predict_host_time_leaves_out_its_waits():
    run = traced_run([span("xgpr/predict", 0, 10000),
                      span("xgpr/wait.lengths", 1000, 1000),
                      span("xgpr/predict.var", 3000, 500),
                      span("xgpr/wait.to_host", 6000, 3000),
                      span("xgpr/predict", 20000, 4000),
                      span("xgpr/wait.to_host", 21000, 2000)], ops=2)
    assert read("predict_host_ms.predict", run) == \
        pytest.approx((6.0 + 2.0) / 2)


PER_SPAN = ("k1_dispatch_us.fit", "k1_dispatch_us.nmll", "cg_host_ms.fit")
PER_OPERATION = ("slq_host_ms.nmll", "precond_check_s.fit",
                 "precond_factor_s.fit", "predict_var_ms.predict",
                 "predict_host_ms.predict")


@pytest.mark.parametrize("name", PER_SPAN + PER_OPERATION)
def test_no_value_without_the_programs_spans(name):
    # A program without spans: the harness's own ranges only.
    run = traced_run([span("gpbench/fit", 0, 5000),
                      span("gpbench/k1", 10, 100)])
    assert read(name, run) is None
    run.trace = None
    assert read(name, run) is None


@pytest.mark.parametrize("name", PER_OPERATION)
def test_no_value_per_operation_without_a_completed_operation(name):
    run = traced_run([span(f"xgpr/{p}", 0, 100) for p in (
        "slq.probes", "slq.lanczos", "precond.ratio_check",
        "precond.factor", "predict.var", "predict")], ops=0, failed=1)
    assert read(name, run) is None
