"""Host-clock arithmetic: the process's age and the spread of a set of
runs."""
import os
import statistics


def process_age():
    """Seconds since this process started, from /proc (10 ms ticks), so
    that set-up counts the interpreter's start and the imports; None
    where /proc is not there."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
    except (OSError, IndexError, ValueError):
        return None
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def spread(values):
    """Interquartile distance over the median, with the quartiles of
    ``statistics.quantiles(values, n=4)``."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
