"""Median tick latency of the traced window (due time to detections)."""
from portbench.readers import latency_ms


def read(run):
    return latency_ms(run, 50)
