"""twolayer_l1_ms.fit: device milliseconds a call launched inside the
program's ``xgpr/twolayer.l1`` spans in the traced fits: Conv1dTwoLayer's
layer 1 on one chunk (the tile layout and K4)."""
from gpbench.harness import spans, trace

L1 = "xgpr/twolayer.l1"


def read(run):
    return spans.per_span(run.trace, L1,
                          lambda t: 1e3 * trace.range_seconds(t, L1))
