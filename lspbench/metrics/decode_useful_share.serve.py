"""motion half: the frames the window's requests returned over the head-pose
decode steps they ran (counter ``decode_steps``: G2's replays a frame of
the bucket-padded length), in %."""

from lspbench.metrics import _requests


def read(ctx):
    return _requests.share(ctx, "frames_returned", "decode_steps")
