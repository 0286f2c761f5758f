"""cg_iters.fit: CG iterations of a traced fit (``fit(...,
run_diagnostics=True)``)."""
from gpbench.harness.readers import mean_of


def read(run):
    return mean_of(run.traced, "cg_iters")
