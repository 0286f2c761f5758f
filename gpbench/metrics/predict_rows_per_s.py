"""predict_rows_per_s: rows scored with mean and variance over the
window's seconds."""
from gpbench.harness.readers import completed


def read(run):
    rows = sum(r["rows"] for r in completed(run.records))
    return rows / run.window_s if rows else None
