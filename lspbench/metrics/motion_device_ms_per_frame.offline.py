"""motion half: the device time of each window request's span ``motion``
(CUDA events before G1's replay and after G3's), summed, over the frames
the requests returned."""

from lspbench.metrics import _requests


def read(ctx):
    return _requests.device_ms_per(ctx, "motion", "frames_returned")
