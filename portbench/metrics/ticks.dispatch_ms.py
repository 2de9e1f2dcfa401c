"""Host milliseconds in `submit` a batch (upload, rig lookup, enqueue of
the forward and decode), traced window."""
from portbench.readers import traced


def read(run):
    return traced(run, "dispatch_ms")
