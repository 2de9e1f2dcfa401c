"""The model's FLOPs an image times the traced window's images a second,
as a share (%) of the H100's 989 TFLOP/s dense bf16 peak."""
from portbench.readers import mfu


def read(run):
    return mfu(run)
