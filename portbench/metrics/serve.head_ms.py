"""Device milliseconds a batch in the BEV head (`heads.bev_head`)."""
from portbench.readers import traced


def read(run):
    return traced(run, "head_ms")
