"""predict_host_ms.predict: host milliseconds per traced predict batch in
the program's ``xgpr/predict`` span outside its ``xgpr/wait.*`` spans
(each chunk's lengths copied over, the mean's and the variance's copies
to the host): the host's own work in a batch."""
from gpbench.harness import spans

PREDICT = "xgpr/predict"


def read(run):
    return spans.per_operation(
        run, lambda t: 1e3 * spans.outside_waits(t, PREDICT), (PREDICT,))
