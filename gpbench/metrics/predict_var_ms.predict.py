"""predict_var_ms.predict: device milliseconds per traced predict batch
launched inside the program's ``xgpr/predict.var`` spans (each chunk's
variance from its float64 features)."""
from gpbench.harness import spans, trace

VAR = "xgpr/predict.var"


def read(run):
    return spans.per_operation(
        run, lambda t: 1e3 * trace.range_seconds(t, VAR), (VAR,))
