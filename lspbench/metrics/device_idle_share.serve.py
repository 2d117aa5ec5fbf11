"""device: the share of the traced requests' CUDA-event wall in which no
device record of the trace ran (100 less the union of the records'
intervals over the wall, in %)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device_records or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
