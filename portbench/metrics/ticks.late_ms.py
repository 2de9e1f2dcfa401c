"""Mean lateness of the caller past each tick's due time, traced window."""
from portbench.readers import mean_ms


def read(run):
    return mean_ms(run.window.late_s)
