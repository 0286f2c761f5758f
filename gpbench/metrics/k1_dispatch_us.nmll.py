"""k1_dispatch_us.nmll: host microseconds per K1 call in the traced NMLL
evaluations (SLQ's PCG at 26 right-hand sides): the wall of the
program's ``xgpr/k1`` spans over their count."""
from gpbench.harness import spans

K1 = "xgpr/k1"


def read(run):
    return spans.per_span(run.trace, K1,
                          lambda t: 1e6 * spans.seconds(t, K1))
