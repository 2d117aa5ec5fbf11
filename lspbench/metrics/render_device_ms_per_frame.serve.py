"""renderer: the device time of each window request's span ``render`` (a
CUDA event before the first batch's K1 launch to one after the last
batch's send), summed, over the frames rendered (counter
``frames_rendered``: the U-Net's rows, padding included)."""

from lspbench.metrics import _requests


def read(ctx):
    return _requests.device_ms_per(ctx, "render", "frames_rendered")
