"""renderer: the frames the window's requests returned over the frames they
rendered (counter ``frames_rendered``: the U-Net's rows, padded to whole
render batches), in %."""

from lspbench.metrics import _requests


def read(ctx):
    return _requests.share(ctx, "frames_returned", "frames_rendered")
