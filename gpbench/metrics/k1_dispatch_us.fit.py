"""k1_dispatch_us.fit: host microseconds per K1 call in the traced fits:
the wall of the program's ``xgpr/k1`` spans (the whole of
``ops/cuda/ztzv.ztzv_parts``: checks, operands, allocations, the
launch's enqueue; K1 never waits on the card) over their count."""
from gpbench.harness import spans

K1 = "xgpr/k1"


def read(run):
    return spans.per_span(run.trace, K1,
                          lambda t: 1e6 * spans.seconds(t, K1))
