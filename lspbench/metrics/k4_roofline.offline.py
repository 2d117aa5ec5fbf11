"""kernels: K4's share of its roofline in the traced requests: the sum over
their render batches of each int8 conv's bound (lspbench/counts.py: the
larger of its MACs over the int8 peak and its compulsory bytes over the
memory rate) over the device time of the trace's K4 records (every kernel
of csrc/q8conv.cu, named q8conv_*), in %.  Nothing to read where the
renderer has no int8 convs, or where the trace holds fewer K4 records than
the batches' int8 convs (dropped records)."""

from lspbench import counts

K4 = "q8conv_"


def read(ctx):
    tr, c = ctx.trace, ctx.config
    if tr is None or ctx.rates is None or c["precision"] != "int8":
        return None
    batch = ctx.mix["render_batch"]
    batches = sum(-(-r.nframe // batch) for r in ctx.traced if r.error is None)
    convs = sum(cv.int8 for cv in counts.generator_convs(c))
    records = sum(n for name, n in tr.kernel_count.items() if K4 in name)
    seconds = tr.seconds_matching(K4)
    if records < batches * convs or seconds <= 0:
        return None
    return 100.0 * batches * counts.int8_bound_s(c, batch, ctx.rates) / seconds
