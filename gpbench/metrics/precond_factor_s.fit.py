"""precond_factor_s.fit: device seconds per traced fit launched inside
the program's ``xgpr/precond.factor`` spans: the Nystrom preconditioner's
float64 SVD, QR and eigh after its passes, in the build and in the
autoselect's trial ranks."""
from gpbench.harness import spans, trace

FACTOR = "xgpr/precond.factor"


def read(run):
    return spans.per_operation(run,
                               lambda t: trace.range_seconds(t, FACTOR),
                               (FACTOR,))
