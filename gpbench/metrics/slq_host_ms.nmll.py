"""slq_host_ms.nmll: host milliseconds per traced NMLL evaluation in SLQ's
host work: the program's ``xgpr/slq.probes`` (the probes drawn with
numpy and shaped by the preconditioner) and ``xgpr/slq.lanczos`` (the
coefficients' copy to the host and the tridiagonal eigensolves)."""
from gpbench.harness import spans

PARTS = ("xgpr/slq.probes", "xgpr/slq.lanczos")


def read(run):
    return spans.per_operation(
        run, lambda t: 1e3 * sum(spans.seconds(t, n) for n in PARTS), PARTS)
