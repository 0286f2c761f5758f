"""precond_s.fit: seconds a traced fit spends building its Nystrom
preconditioner (the harness's span around ``build_preconditioner``, or
the fit's own ``fit_phase_times["preconditioner"]`` when the fit
autoselects it)."""
from gpbench.harness.readers import mean_of


def read(run):
    return mean_of(run.traced, "precond_s")
