"""The device's idle share in % of the traced window: 1 - the union of
its kernel, copy and set intervals over the window."""
from gpbench.harness.readers import idle_share


def read(run):
    return idle_share(run)
