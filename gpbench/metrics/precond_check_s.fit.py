"""precond_check_s.fit: seconds per traced fit in the autoselect's trial
ranks: the program's ``xgpr/precond.ratio_check`` spans, each closing
after the trial's eigenvalue reaches the host, so their wall is the
trials' time."""
from gpbench.harness import spans

CHECK = "xgpr/precond.ratio_check"


def read(run):
    return spans.per_operation(run, lambda t: spans.seconds(t, CHECK),
                               (CHECK,))
