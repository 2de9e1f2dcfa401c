"""Device milliseconds a batch in the image side: the ResNet, the neck(s)
and HeightNet or MSCThead (kernels launched inside their forward ranges)."""
from portbench.readers import traced


def read(run):
    return traced(run, "image_ms")
