"""95th percentile of tick latency (due time to detections on the host)
over every tick due in the window; a failed tick counts as later than any
that completed."""
from portbench.readers import latency_ms


def read(run):
    return latency_ms(run, 95)
