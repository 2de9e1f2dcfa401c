"""Device milliseconds a batch launched by `submit` outside the model's
forward (decode: sort, gathers, the circle-NMS loop), copies left out."""
from portbench.readers import traced


def read(run):
    return traced(run, "decode_ms")
