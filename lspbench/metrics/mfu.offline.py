"""device (whole request): the generator's model FLOPs of the frames the
window returned (lspbench/counts.py, from the configuration's widths), over
the window's wall, over the card's dense peak in the precision the convs
run in (int8 or bf16), in %."""

from lspbench import counts


def read(ctx):
    if ctx.rates is None:
        return None
    frames = sum(r.nframe for r in ctx.records if r.error is None)
    peak = ctx.rates["int8" if ctx.config["precision"] == "int8" else "bf16"]
    return 100.0 * counts.frame_flops(ctx.config) * frames / ctx.window_s / peak
