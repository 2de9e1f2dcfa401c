"""The lift's least time (its bytes at 3.35 TB/s) over its device time,
a share (%): the backbone's range less its image-side children (softmax,
the cull's gather, K1, K2)."""
from portbench.readers import lift_roofline


def read(run):
    return lift_roofline(run)
