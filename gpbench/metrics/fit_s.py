"""fit_s: the window's seconds over the fits completed in it."""
from gpbench.harness.readers import completed


def read(run):
    done = completed(run.records)
    return run.window_s / len(done) if done else None
