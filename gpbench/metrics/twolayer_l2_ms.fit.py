"""twolayer_l2_ms.fit: device milliseconds a call launched inside the
program's ``xgpr/twolayer.l2`` spans in the traced fits: Conv1dTwoLayer's
layer 2 on one chunk (sigma's scale and K2)."""
from gpbench.harness import spans, trace

L2 = "xgpr/twolayer.l2"


def read(run):
    return spans.per_span(run.trace, L2,
                          lambda t: 1e3 * trace.range_seconds(t, L2))
