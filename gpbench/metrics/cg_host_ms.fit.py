"""cg_host_ms.fit: host milliseconds per CG iteration of the traced fits
outside the iteration's wait on the card: the program's ``xgpr/cg.iter``
spans less the ``xgpr/wait.cg_flag`` read nested in each, over the
iterations.  Beside ``cg_iter_ms.fit`` it says whether the host or the
card sets the iterations' pace."""
from gpbench.harness import spans

ITER = "xgpr/cg.iter"


def read(run):
    return spans.per_span(run.trace, ITER,
                          lambda t: 1e3 * spans.outside_waits(t, ITER))
